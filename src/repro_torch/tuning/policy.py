"""Declarative bucket-edge policies for the serving engines (port of
``repro/tuning/policy.py``).

Per octave ``[2**k, 2**(k+1))`` a ladder carries ``multipliers`` edges:

  * ``p2``          — multipliers ``(1,)``: power-of-two rounding, the
    default;
  * ``half-octave`` — ``(1, 1.5)``: less padding, twice the bucket shapes.

The reference's third ladder, ``cost-balanced``, derives its density from
the roofline cost model, which waits for the tuning slice of the port; its
name is refused here rather than quietly mapped to another ladder.

Policies change *padding only* — decoded samples never depend on the
bucket edge.  ``policy=None`` means ``p2``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple, Union

__all__ = ["BucketPolicy", "P2", "HALF_OCTAVE", "POLICY_NAMES", "PolicyArg"]

PolicyArg = Union[None, str, "BucketPolicy"]


@dataclasses.dataclass(frozen=True)
class BucketPolicy:
    """One bucket-edge ladder: ``multipliers`` edges per octave.

    ``round(x)`` returns the smallest ladder edge >= x; edges are
    ``ceil(m * 2**k)`` for each multiplier ``m in [1, 2)`` and octave
    ``k`` (plus the next octave's base), so rounding is monotonic,
    idempotent on edges, and never below the input.
    """

    name: str
    multipliers: Tuple[float, ...] = (1.0,)

    def __post_init__(self):
        if not self.multipliers:
            raise ValueError("a BucketPolicy needs at least one multiplier")
        for m in self.multipliers:
            if not 1.0 <= m < 2.0:
                raise ValueError(
                    f"multipliers must lie in [1, 2), got {m} "
                    f"(policy {self.name!r})"
                )

    def round(self, x: int) -> int:
        """Smallest ladder edge >= max(x, 1)."""
        x = max(int(x), 1)
        if x <= 1:
            return 1
        k = (x - 1).bit_length() - 1  # 2**k < x <= 2**(k+1)
        best = 1 << (k + 1)
        base = 1 << k
        for m in self.multipliers:
            edge = int(math.ceil(m * base))
            if x <= edge < best:
                best = edge
        return best

    def edges(self, lo: int, hi: int) -> List[int]:
        """Every distinct ladder edge covering sizes in ``[lo, hi]`` — the
        bound on bucket-shape variants."""
        lo, hi = max(int(lo), 1), max(int(hi), 1)
        out, seen = [], set()
        x = lo
        while True:
            e = self.round(x)
            if e not in seen:
                seen.add(e)
                out.append(e)
            if e >= hi:
                break
            x = e + 1
        return out

    def max_variants(self, lo: int, hi: int) -> int:
        """Upper bound on distinct bucket edges for sizes in ``[lo, hi]``."""
        return len(self.edges(lo, hi))

    @staticmethod
    def of(policy: PolicyArg) -> "BucketPolicy":
        """Resolve an engine's ``policy`` argument: a :class:`BucketPolicy`
        passes through, a name looks up the registry, ``None`` is ``p2``."""
        if isinstance(policy, BucketPolicy):
            return policy
        return _named("p2" if policy is None else policy)


P2 = BucketPolicy("p2", (1.0,))
HALF_OCTAVE = BucketPolicy("half-octave", (1.0, 1.5))

POLICY_NAMES = ("p2", "half-octave")


def _named(name: str) -> BucketPolicy:
    key = name.strip().lower().replace("_", "-")
    if key == "p2":
        return P2
    if key in ("half-octave", "halfoctave"):
        return HALF_OCTAVE
    if key in ("cost-balanced", "costbalanced"):
        raise ValueError(
            "the cost-balanced bucket policy needs the tuning cost model, "
            "which this package does not have yet — use 'p2' or "
            "'half-octave'"
        )
    raise ValueError(
        f"unknown bucket policy {name!r} — expected one of {POLICY_NAMES} "
        "or a BucketPolicy instance"
    )

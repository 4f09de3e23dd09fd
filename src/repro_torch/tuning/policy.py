"""Declarative bucket-edge policies for the serving engines (port of
``repro/tuning/policy.py``).

Per octave ``[2**k, 2**(k+1))`` a ladder carries ``multipliers`` edges:

  * ``p2``            — multipliers ``(1,)``: power-of-two rounding;
  * ``half-octave``   — ``(1, 1.5)``: less padding, twice the bucket shapes;
  * ``cost-balanced`` — a geometric ladder whose density the
    :class:`~repro_torch.tuning.cost_model.CostModel` picks: where one more
    edge per octave stops saving more padded work than a new bucket shape's
    first call costs.  The named ladder (:data:`COST_BALANCED`) is the
    ``cpu`` profile's on every device, 4 edges an octave as in the
    reference: the density that trade gives on the card rests on
    reference traffic that no run of the port's serving stream has
    measured yet, so the card takes the reference's ladder until one
    does.

Every policy keeps the count of bucket shapes bounded: at most
``len(multipliers)`` edges per octave.  Policies change *padding only* —
decoded samples never depend on the bucket edge.

Engines resolve ``policy=None`` through :meth:`BucketPolicy.of`, which
reads ``FPTC_BUCKET_POLICY`` (default ``p2``), as the reference does.
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import List, Tuple, Union

__all__ = [
    "BucketPolicy",
    "P2",
    "HALF_OCTAVE",
    "COST_BALANCED",
    "cost_balanced_policy",
    "POLICY_NAMES",
    "PolicyArg",
]

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
        passes through, a name looks up the registry, ``None`` reads
        ``FPTC_BUCKET_POLICY`` (default ``p2``)."""
        if isinstance(policy, BucketPolicy):
            return policy
        if policy is None:
            policy = os.environ.get("FPTC_BUCKET_POLICY", "").strip() or "p2"
        return _named(policy)


P2 = BucketPolicy("p2", (1.0,))
HALF_OCTAVE = BucketPolicy("half-octave", (1.0, 1.5))


def cost_balanced_policy(cost_model=None) -> BucketPolicy:
    """Build the ``cost-balanced`` ladder from a cost model: a geometric
    ladder of ``d = cost_model.edges_per_octave()`` edges per octave
    (``2**(j/d)`` multipliers).  ``None`` takes the ``cpu`` profile's
    default model, on every device (the module's docstring says why)."""
    if cost_model is None:
        from repro_torch.tuning.cost_model import default_cost_model

        cost_model = default_cost_model("cpu")
    d = max(int(cost_model.edges_per_octave()), 1)
    return BucketPolicy(
        "cost-balanced",
        tuple(2.0 ** (j / d) for j in range(d)),
    )


# the named cost-balanced ladder, the reference's on every device; engines
# wanting a freshly seeded or calibrated model's call
# cost_balanced_policy(model)
COST_BALANCED = cost_balanced_policy()

POLICY_NAMES = ("p2", "half-octave", "cost-balanced")


def _named(name: str) -> BucketPolicy:
    key = name.strip().lower().replace("_", "-")
    if key == "p2":
        return P2
    if key in ("half-octave", "halfoctave"):
        return HALF_OCTAVE
    if key in ("cost-balanced", "costbalanced"):
        # the import-time ladder, not a fresh build: re-deriving it from a
        # since-calibrated model would shift bucket edges under live engines
        return COST_BALANCED
    raise ValueError(
        f"unknown bucket policy {name!r} — expected one of {POLICY_NAMES} "
        "or a BucketPolicy instance"
    )

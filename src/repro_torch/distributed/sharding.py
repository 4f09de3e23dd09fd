"""Sharding policy: logical dim names -> mesh axes, with divisibility checks.
Port of ``repro/distributed/sharding.py``.

Parameters and activations are annotated with *logical* dim names
("hidden", "ffn", "heads", "batch", "seq", ...).  A :class:`ShardingPolicy`
resolves those names against a mesh:

  * params:     FSDP over the ("pod","data") axes on the first shardable dim
                + tensor parallelism over "model" on ffn/head/expert/vocab dims
  * activations: batch over ("pod","data"), sequence over "model"
                (sequence parallelism for the residual stream), and head/ffn
                dims over "model" inside blocks.

A name only maps to a mesh axis if the dim size is divisible by the axis
size — otherwise the dim is replicated (e.g. qwen's 20 heads on a 16-way
model axis).

A spec is the reference's ``PartitionSpec`` as a tuple: per dim ``None``, an
axis name, or a tuple of axis names, trailing ``None``s dropped.  On a
``torch.distributed`` ``DeviceMesh`` it becomes ``torch.distributed.tensor``
placements (:meth:`ShardingPolicy.placements_for`, the counterpart of the
reference's ``sharding_for``) and a block of each tensor per mesh
coordinate (:meth:`ShardingPolicy.local_slices`); a dim sharded over two
axes is split over the first, then the second (major to minor, as in JAX
and in DTensor).  Sizes are read from a ``DeviceMesh`` or from any object
with ``axis_names`` and a ``devices`` array, so a 256-chip mesh resolves
without 256 ranks.
"""
from __future__ import annotations

import contextlib
import itertools
import math
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.models.common import ParamSpec

__all__ = [
    "DEFAULT_RULES",
    "ShardingPolicy",
    "activate",
    "current_policy",
    "constrain",
    "resolve_param_specs",
]

Spec = Tuple[Any, ...]

# logical name -> candidate mesh axes, tried in order (first divisible wins)
DEFAULT_RULES: Dict[str, Tuple[Tuple[str, ...], ...]] = {
    # activation dims
    "batch": (("pod", "data"), ("data",)),
    "seq": (("model",),),
    # param dims — TP
    "ffn": (("model",),),
    "heads": (("model",),),
    "kv_heads": (("model",),),
    "qk_dim": (("model",),),
    # prefer whole-expert sharding over (data, model) — full EP, no weight
    # gathers; fall back to model-axis EP for small E
    "experts": (("data", "model"), ("model",)),
    "vocab": (("model",),),
    # param dims — FSDP (weight-sharded data parallelism)
    "hidden": (("pod", "data"), ("data",)),
    "embed_fsdp": (("pod", "data"), ("data",)),
    # pod-replica axis (compressed-DP grads / residuals / batches)
    "replicas": (("pod",),),
    # never sharded
    "window": (),
    "state": (),
    "conv": (),
    "layers": (),
    "rank": (),
}


def _axis_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` or of an object with
    ``axis_names`` and a ``devices`` array."""
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    return dict(zip(mesh.axis_names, mesh.devices.shape))


class ShardingPolicy:
    """Resolves logical dim names to mesh axes.

    ``exclude`` removes axes from consideration — used for the
    pod-replicated parameter mode (FPTC-compressed pod gradient mean),
    where params must not be sharded over "pod".  ``allow_shard_map`` is
    False under the pod-compressed train step, where the reference's MoE
    falls back to its dense dispatch.
    """

    def __init__(self, mesh, rules: Optional[Dict] = None,
                 exclude: Tuple[str, ...] = (),
                 allow_shard_map: bool = True):
        self.mesh = mesh
        self.rules = dict(DEFAULT_RULES)
        if rules:
            self.rules.update(rules)
        self.exclude = frozenset(exclude)
        self.allow_shard_map = allow_shard_map
        self.axis_sizes = _axis_sizes(mesh)

    def without(self, *axes: str) -> "ShardingPolicy":
        return ShardingPolicy(
            self.mesh, rules=self.rules,
            exclude=tuple(self.exclude | set(axes)),
            allow_shard_map=self.allow_shard_map,
        )

    @property
    def fsdp_axes(self) -> Tuple[str, ...]:
        return tuple(
            a for a in ("pod", "data")
            if a in self.axis_sizes and a not in self.exclude
        )

    def _axes_size(self, axes: Tuple[str, ...]) -> Optional[int]:
        total = 1
        for a in axes:
            if a not in self.axis_sizes or a in self.exclude:
                return None
            total *= self.axis_sizes[a]
        return total

    def spec_for(self, names: Sequence[Optional[str]],
                 shape: Sequence[int]) -> Spec:
        """Resolve logical names + concrete shape to a spec."""
        used_axes: set = set()
        out: List[Any] = []
        for name, dim in zip(names, shape):
            entry: Any = None
            if name is not None:
                for cand in self.rules.get(name, ()):
                    size = self._axes_size(cand)
                    if size is None or dim % size != 0:
                        continue
                    if any(a in used_axes for a in cand):
                        continue
                    entry = cand if len(cand) > 1 else cand[0]
                    used_axes.update(cand)
                    break
            out.append(entry)
        while out and out[-1] is None:
            out.pop()
        return tuple(out)

    def placements_for(self, names: Sequence[Optional[str]],
                       shape: Sequence[int]) -> list:
        """The spec as ``torch.distributed.tensor`` placements, one per
        mesh dim: ``Shard(d)`` on each mesh dim in tensor dim ``d``'s
        entry, ``Replicate()`` elsewhere."""
        from torch.distributed.tensor import Replicate, Shard

        dim_of = {}
        for d, entry in enumerate(self.spec_for(names, shape)):
            for a in _axes(entry):
                dim_of[a] = d
        return [Shard(dim_of[a]) if a in dim_of else Replicate()
                for a in self.axis_sizes]

    def local_slices(self, names: Sequence[Optional[str]],
                     shape: Sequence[int], coordinate: Sequence[int]
                     ) -> Tuple[slice, ...]:
        """The block of a ``shape`` tensor that the mesh position
        ``coordinate`` (one index per mesh axis, in the mesh's order)
        holds under the spec."""
        coord = dict(zip(self.axis_sizes, coordinate))
        out = [slice(None)] * len(shape)
        for d, entry in enumerate(self.spec_for(names, shape)):
            axes = _axes(entry)
            if not axes:
                continue
            count, index = 1, 0
            for a in axes:  # major to minor
                count *= self.axis_sizes[a]
                index = index * self.axis_sizes[a] + coord[a]
            step = shape[d] // count
            out[d] = slice(index * step, (index + 1) * step)
        return tuple(out)

    def coordinates(self) -> Dict[int, Tuple[int, ...]]:
        """``{rank: mesh coordinate}`` of every rank of a ``DeviceMesh``."""
        ranks = self.mesh.mesh
        return {int(ranks[c]): c for c in itertools.product(
            *(range(n) for n in ranks.shape))}

    def sharded_count(self, names: Sequence[Optional[str]],
                      shape: Sequence[int]) -> int:
        """Into how many distinct blocks the spec splits the tensor."""
        return math.prod(self.axis_sizes[a] for e in self.spec_for(
            names, shape) for a in _axes(e))


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


_state = threading.local()


@contextlib.contextmanager
def activate(policy: Optional[ShardingPolicy]):
    prev = getattr(_state, "policy", None)
    _state.policy = policy
    try:
        yield policy
    finally:
        _state.policy = prev


def current_policy() -> Optional[ShardingPolicy]:
    return getattr(_state, "policy", None)


def constrain(x, names: Sequence[Optional[str]]):
    """Redistribute a DTensor to the placements of its logical dim names
    under the active policy; a plain tensor, or no active policy, leaves
    ``x`` as it is (keeps the model library mesh-agnostic)."""
    from torch.distributed.tensor import DTensor

    policy = current_policy()
    if policy is None or not isinstance(x, DTensor):
        return x
    return x.redistribute(policy.mesh, policy.placements_for(names, x.shape))


def resolve_param_specs(policy: ShardingPolicy, specs: Any) -> Any:
    """ParamSpec tree -> placements tree (one list a leaf)."""
    if isinstance(specs, ParamSpec):
        return policy.placements_for(specs.names, specs.shape)
    return {k: resolve_param_specs(policy, s) for k, s in specs.items()}

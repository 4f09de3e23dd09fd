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

import torch
import torch.distributed as dist

__all__ = [
    "DEFAULT_RULES",
    "ShardingPolicy",
    "activate",
    "current_policy",
    "constrain",
    "resolve_param_specs",
    "axis_group",
    "all_gather",
    "reduce_scatter",
    "all_reduce",
    "all_to_all",
    "ModelAxis",
    "model_axis",
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
                     shape: Sequence[int], coordinate: Sequence[int],
                     axis: Optional[str] = None) -> Tuple[slice, ...]:
        """The block of a ``shape`` tensor that the mesh position
        ``coordinate`` (one index per mesh axis, in the mesh's order)
        holds under the spec.  ``axis``: only the dims whose spec entry
        names that axis are split (``"model"``: the block the layers
        compute with, gathered over the data-parallel axes; a dim split
        over ``("data", "model")`` jointly, full EP's experts, stays
        split over both)."""
        coord = dict(zip(self.axis_sizes, coordinate))
        out = [slice(None)] * len(shape)
        for d, entry in enumerate(self.spec_for(names, shape)):
            axes = _axes(entry)
            if not axes or (axis is not None and axis not in axes):
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
    from repro_torch.models.common import ParamSpec

    if isinstance(specs, ParamSpec):
        return policy.placements_for(specs.names, specs.shape)
    return {k: resolve_param_specs(policy, s) for k, s in specs.items()}


# ---------------------------------------------------------------------------
# The model axis: process groups, collectives with their backward, the
# rank's place in the layers
# ---------------------------------------------------------------------------
def axis_group(mesh, axes: Sequence[str]):
    """The process group of the ranks that share this rank's coordinates
    on every axis of ``mesh`` not in ``axes`` (its group rank: the index
    over ``axes``, major to minor); None when that is this rank alone.
    Every rank must ask for the same groups in the same order (a new group
    is made by all ranks).  The groups are kept on the mesh object, so
    they live and die with it."""
    names = tuple(mesh.mesh_dim_names)
    axes = tuple(a for a in names if a in axes)
    groups = mesh.__dict__.setdefault("_axis_groups", {})
    if axes in groups:
        return groups[axes]
    sizes = dict(zip(names, mesh.mesh.shape))
    count = math.prod(sizes[a] for a in axes)
    if count == 1:
        group = None
    elif count == dist.get_world_size():
        group = dist.group.WORLD
    elif len(axes) == 1:
        group = mesh.get_group(axes[0])
    else:
        ranks = mesh.mesh.permute(
            *[names.index(a) for a in names if a not in axes],
            *[names.index(a) for a in axes])
        ranks = ranks.reshape(-1, math.prod(sizes[a] for a in axes))
        me, group = dist.get_rank(), None
        for row in ranks.tolist():  # every rank makes every group
            g = dist.new_group(row)
            if me in row:
                group = g
    groups[axes] = group
    return group


def _size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _gather(x, dim: int, group):
    xt = x.movedim(dim, 0).contiguous()
    out = xt.new_empty((_size(group) * xt.shape[0],) + xt.shape[1:])
    dist.all_gather_into_tensor(out, xt, group=group)
    return out.movedim(0, dim)


def _scatter(x, dim: int, group):
    xt = x.movedim(dim, 0).contiguous()
    out = xt.new_empty((xt.shape[0] // _size(group),) + xt.shape[1:])
    dist.reduce_scatter_tensor(out, xt, group=group)
    return out.movedim(0, dim)


def _summed(x, group):
    out = x.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


def _exchanged(x, group):
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _scatter(g, ctx.dim, ctx.group), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _scatter(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.dim, ctx.group), None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _summed(x, group)

    @staticmethod
    def backward(ctx, g):
        return _summed(g, ctx.group), None


class _AllToAll(torch.autograd.Function):
    # block i of the output came from rank i's block (this rank's index):
    # the exchange is its own transpose
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchanged(x, group)

    @staticmethod
    def backward(ctx, g):
        return _exchanged(g, ctx.group), None


def all_gather(x, dim: int, group):
    """The ranks' blocks of ``x`` concatenated along ``dim`` in group-rank
    order; backward: the reduce-scatter of the cotangent."""
    return x if group is None else _AllGather.apply(x, dim, group)


def reduce_scatter(x, dim: int, group):
    """The ranks' ``x`` summed, this rank's block of ``dim`` kept;
    backward: the all-gather of the cotangent."""
    return x if group is None else _ReduceScatter.apply(x, dim, group)


def all_reduce(x, group):
    """The ranks' ``x`` summed; backward: the same sum of the
    cotangents (each rank's is partial)."""
    return x if group is None else _AllReduce.apply(x, group)


def all_to_all(x, group):
    """``x`` ``[n * k, ...]`` in n blocks along dim 0: block i goes to
    group rank i, and block i of the result came from rank i."""
    return x if group is None else _AllToAll.apply(x, group)


def all_max(x, group):
    """The ranks' elementwise maximum, outside autograd."""
    if group is None:
        return x
    out = x.detach().contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out


class ModelAxis:
    """A rank's place on a mesh with a ``model`` axis, as the layers use
    it (``model_axis()``).

    ``size``/``index``: the ``model`` axis and this rank's index on it;
    ``dp``/``dp_index``: the data-parallel ranks (``pod`` x ``data``) and
    this rank's index among them.  Groups: ``group`` (``model``),
    ``dp_group`` (``pod`` and ``data``) and ``world`` (every rank).
    ``seq``: whether the residual stream is split over the sequence
    across ``model`` (sequence parallelism: the loss and prefill when the
    sequence divides the axis); otherwise every rank of ``model`` holds
    it whole (decode, and a sequence that does not divide).  A weight
    dim named ``heads``, ``kv_heads``, ``ffn`` or ``vocab`` is split
    over ``model`` when the axis divides it, else replicated (the
    reference's rule)."""

    def __init__(self, policy: ShardingPolicy):
        mesh = policy.mesh
        self.policy, self.mesh = policy, mesh
        sizes = policy.axis_sizes
        coord = dict(zip(sizes, mesh.get_coordinate()))
        self.size, self.index = sizes.get("model", 1), coord.get("model", 0)
        self.dp_axes = tuple(a for a in ("pod", "data") if a in sizes)
        self.dp, self.dp_index = 1, 0
        for a in self.dp_axes:
            self.dp *= sizes[a]
            self.dp_index = self.dp_index * sizes[a] + coord[a]
        self.group = axis_group(mesh, ("model",))
        self.dp_group = axis_group(mesh, self.dp_axes)
        self.world = dist.group.WORLD if dist.get_world_size() > 1 else None
        self.seq = False

    def splits(self, n: int) -> bool:
        """Whether a weight dim of ``n`` is split over ``model``."""
        return n % self.size == 0

    def block(self, n: int) -> Tuple[int, int]:
        """``(start, length)`` of this rank's block of a split dim."""
        k = n // self.size
        return self.index * k, k

    def set_sequence(self, length: Optional[int]) -> None:
        """The residual layout of the passes that follow: split over the
        sequence when a full-sequence pass of ``length`` divides the
        axis, else (and for a decode step, None) whole on every rank.
        It stays set until the next call, so that the backward's
        recomputations take the forward's layout."""
        self.seq = length is not None and length % self.size == 0

    def enter(self, h):
        """A block's input ``[B, S/m, d]`` gathered to the whole sequence
        (the reference's "bf16 gather point"); whole already: as is."""
        return all_gather(h, 1, self.group) if self.seq else h

    def leave(self, y, partial: bool):
        """A block's output back onto the residual stream: a partial sum
        over ``model`` (row-parallel) reduce-scattered over the sequence
        or all-reduced; a whole value this rank's sequence block, or as
        is."""
        if self.seq:
            if partial:
                return reduce_scatter(y, 1, self.group)
            start, k = self.block(y.shape[1])
            return y.narrow(1, start, k)
        return all_reduce(y, self.group) if partial else y

    def last_token(self, x):
        """``x[:, -1:]`` of the residual stream, whole on every rank."""
        if not self.seq:
            return x[:, -1:]
        last = x[:, -1:]
        if self.index != self.size - 1:
            last = torch.zeros_like(last)
        return all_reduce(last, self.group)


def model_axis() -> Optional[ModelAxis]:
    """The active policy's :class:`ModelAxis`, or None (no policy, or a
    ``model`` axis of 1)."""
    policy = current_policy()
    return getattr(policy, "model_axis", None) if policy is not None \
        else None

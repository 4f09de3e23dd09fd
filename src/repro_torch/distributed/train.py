"""Train and serve step factories.  Port of ``repro/distributed/train.py``.

The train step's modes follow the reference's, chosen by the mesh (a
``DeviceMesh`` from ``launch.mesh``, every rank of the process group in
it) and ``compression``:

  * **no mesh, or a mesh of one rank** — the step on one device, the
    reference's uncompressed ``step_inner``: the loss and its gradients
    (``Model.loss`` under autograd, each layer rematerialized), then
    ``AdamW.update``, which writes the model's weights and the optimizer's
    m and v in place (the reference's step donates them).  It returns the
    loss and the gradients' global norm as 0-d tensors on the device;
    nothing in it syncs the host.
  * **pod-compressed** — ``pod`` > 1 and ``compression.mode != "none"``,
    one rank per pod replica (``data`` 1): the parameters are replicated
    over ``pod`` (``policy.without("pod")``); each rank takes the loss and
    its gradients on its replica's batch (``batch_size // replicas``
    rows); the gradients' mean crosses the ranks through
    ``GradCompressor.replica_sum_ranks`` (the int8 or ``wire_dtype``
    spectra all-gathered) on the reference's leaves, a stack's layers in
    one leaf (``convert.stack_layers``: its int8 scale, its windows and
    ``min_size`` span the stack, as the reference's do); each rank keeps
    its own replica's residual in ``OptState.residual`` (``[1, ...]`` a
    parameter, its slice of the reference's ``[P, ...]``); the loss
    reported is the mean over the replicas.
  * **FSDP** — any other mesh of more than one rank (``data`` > 1, or
    ``pod`` > 1 uncompressed: the reference's ``fsdp_all``; with
    ``model`` > 1 tensor, sequence and expert parallelism besides): each
    rank holds only its policy block of every parameter and of its m and
    v.  A layer's weights are gathered by a forward pre-hook on the layer
    and dropped by its forward hook, so under activation checkpointing
    the recompute gathers them again; the top-level weights (embeddings,
    the final norm) are gathered around the loss.  A gather crosses the
    data-parallel ranks only: it gives the rank its ``model`` block (the
    layers' TP weights; a full-EP expert stack is never gathered).  The
    gradients come back to the blocks averaged over the global batch:
    each is summed over the ranks that compute with the same block (the
    data-parallel ranks; every rank for a weight whole on ``model``,
    whose ranks each saw a part of the sequence or of the heads), divided
    by the data-parallel count, and this rank's block kept.  The gather
    and its gradient are one ``autograd.Function`` (``_Gather``) over
    ``dist.all_gather`` and ``dist.all_reduce``, not DTensor: with gloo,
    which runs the ranks that share one card, a DTensor's collectives on
    CUDA tensors hung (``mesh_wire_probe.py``).  The step is the
    one-device step on the global batch, up to reduction order (the
    dense MoE routes the global batch under one capacity, gathered over
    the data-parallel ranks), except where ``model`` > 1 takes the
    sharded MoE with its own capacity rule, as the reference's does.
  * The hybrid, RWKV and encoder-decoder families on ``model`` > 1, and
    a pod-compressed mesh with ``data`` > 1 or ``model`` > 1, raise
    :data:`MULTI_DEVICE`.

Each rank passes its own rows of the global batch
(``TrainStep.local_batch``: the data-parallel ranks split them; the
``model`` ranks of one data rank take the same rows).

``make_serve_fns`` gives the serving functions, run in inference mode,
on one device or on a mesh (each rank its ``model`` block of the
weights, its rows of the batch).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.distributed import sharding as shlib
from repro_torch.distributed.compression import (
    CompressionConfig,
    GradCompressor,
)
from repro_torch.distributed.optimizer import AdamW, OptState
from repro_torch.serving.engine import resolve_device

__all__ = ["TrainStep", "make_train_step", "make_serve_fns",
           "build_compute_blocks", "MULTI_DEVICE"]

MULTI_DEVICE = ("ROADMAP queue 1, item 6c-iii (M10d, the rest of the model "
                "axis: the hybrid, RWKV and encoder-decoder families on it, "
                "and the pod-compressed step with data or model above 1)")
# the families whose layers the model axis does not split yet
UNSPLIT_FAMILIES = ("hybrid", "ssm", "audio")


@dataclasses.dataclass
class TrainStep:
    # (opt_state, batch) -> (opt_state, {"loss", "grad_norm"}); the model's
    # weights are updated in place
    step_fn: Callable[[OptState, Dict[str, torch.Tensor]],
                      Tuple[OptState, Dict[str, torch.Tensor]]]
    model: Any
    optimizer: AdamW
    compressor: Optional[GradCompressor] = None  # pod-compressed mode
    policy: Optional[shlib.ShardingPolicy] = None  # None: one device
    replicas: int = 1  # > 1: one pod replica a rank
    # FSDP: each parameter's gather (None: every rank holds it whole)
    layouts: Optional[Dict[str, "_Layout"]] = None

    def init(self) -> OptState:
        """The optimizer's zero state for the model's weights (this rank's
        blocks under FSDP), keyed by their ``named_parameters`` names; the
        pod-compressed mode adds this replica's zero residual."""
        return self.optimizer.init(dict(self.model.named_parameters()),
                                   with_residual=self.compressor is not None)

    def local_batch(self, batch: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
        """This rank's rows of a global batch: the data-parallel ranks
        (``pod`` major, then ``data``) split its rows evenly, in order;
        the ``model`` ranks of one data rank take the same rows."""
        return batch if self.policy is None else local_rows(self.policy,
                                                            batch)

    @torch.no_grad()
    def full_state(self, opt_state: OptState
                   ) -> Tuple[Dict[str, torch.Tensor], OptState]:
        """``({name: weight}, OptState)`` with every leaf whole: under
        FSDP gathered from the ranks (every rank calls it and gets them),
        else the model's own weights and ``opt_state``.  The residual is
        left out (a checkpoint saves none)."""
        params = {n: p.detach() for n, p in self.model.named_parameters()}
        if self.layouts is None:
            return params, opt_state._replace(residual=None)
        whole = lambda tree: {n: self.layouts[n].gather(t)  # noqa: E731
                              for n, t in tree.items()}
        return whole(params), opt_state._replace(
            m=whole(opt_state.m), v=whole(opt_state.v), residual=None)


def local_rows(policy: shlib.ShardingPolicy, batch: Dict[str, torch.Tensor]
               ) -> Dict[str, torch.Tensor]:
    """This rank's rows of a global batch on ``policy``'s mesh (see
    ``TrainStep.local_batch``)."""
    sizes = policy.axis_sizes
    coord = dict(zip(sizes, policy.mesh.get_coordinate()))
    n, i = 1, 0
    for a in ("pod", "data"):
        if a in sizes:
            n *= sizes[a]
            i = i * sizes[a] + coord[a]
    rows = next(iter(batch.values())).shape[0]
    if rows % n:
        raise ValueError(f"a batch of {rows} rows over {n} ranks")
    k = rows // n
    return {key: v[i * k:(i + 1) * k] for key, v in batch.items()}


def _within(block: Tuple[slice, ...], outer: Tuple[slice, ...], shape
            ) -> Tuple[slice, ...]:
    """``block`` (absolute slices of ``shape``) relative to ``outer``."""
    out = []
    for b, o, n in zip(block, outer, shape):
        b0, b1, _ = b.indices(n)
        o0, _, _ = o.indices(n)
        out.append(slice(b0 - o0, b1 - o0))
    return tuple(out)


class _Layout:
    """One parameter's blocks on the ranks: ``slices[r]`` is rank ``r``'s
    block of the whole ``shape``; ``compute`` this rank's block that the
    layers compute with (its ``model`` block, whole over the
    data-parallel axes; ``slices[rank]`` for a full-EP expert stack).
    The compute block is gathered over ``gather_group``, and its
    gradient summed over ``reduce_group`` (the ranks computing with the
    same block) and divided by ``dp``, the data-parallel count."""

    def __init__(self, shape, slices: List[Tuple[slice, ...]], rank: int,
                 compute: Tuple[slice, ...], gather_group=None,
                 reduce_group=None, dp: int = 1):
        self.shape = tuple(shape)
        self.slices = slices
        self.sharded = any(sl != slices[0] for sl in slices)
        self.compute_shape = tuple(len(range(*c.indices(n)))
                                   for c, n in zip(compute, shape))
        self.own = _within(slices[rank], compute, shape)
        self.gather_group, self.reduce_group = gather_group, reduce_group
        self.members = ([] if gather_group is None else [
            _within(slices[r], compute, shape)
            for r in dist.get_process_group_ranks(gather_group)])
        self.dp = dp

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        """The whole tensor from every rank's block (a collective)."""
        if not self.sharded:
            return local
        parts = [torch.empty_like(local) for _ in self.slices]
        dist.all_gather(parts, local.contiguous())
        full = local.new_empty(self.shape)
        for sl, part in zip(self.slices, parts):
            full[sl] = part
        return full

    def compute(self, local: torch.Tensor) -> torch.Tensor:
        """This rank's compute block from the data-parallel ranks' blocks
        (a collective over ``gather_group``)."""
        if self.gather_group is None:
            return local
        parts = [torch.empty_like(local) for _ in self.members]
        dist.all_gather(parts, local.contiguous(), group=self.gather_group)
        full = local.new_empty(self.compute_shape)
        for sl, part in zip(self.members, parts):
            full[sl] = part
        return full

    def reduce(self, grad: torch.Tensor) -> torch.Tensor:
        """This rank's block of the ranks' mean gradient (a collective)."""
        total = grad.contiguous().clone()
        if self.reduce_group is not None:
            dist.all_reduce(total, group=self.reduce_group)
        return (total[self.own] / self.dp).contiguous()


def _layouts(model, policy: shlib.ShardingPolicy) -> Dict[str, _Layout]:
    """Each parameter's ``_Layout`` on ``policy``'s mesh."""
    from repro_torch.models.convert import param_specs_by_name

    mesh = policy.mesh
    names = list(policy.axis_sizes)
    coords = policy.coordinates()
    rank = dist.get_rank()
    me = coords[rank]
    dp_axes = tuple(a for a in ("pod", "data") if a in names)
    dp = math.prod(policy.axis_sizes[a] for a in dp_axes)

    def moved(axis: str):
        """The ranks that differ from this one on ``axis`` alone."""
        i = names.index(axis)
        return [r for r, c in coords.items() if r != rank and all(
            c[k] == me[k] for k in range(len(names)) if k != i)]

    out = {}
    for name, s in param_specs_by_name(model).items():
        slices = {r: policy.local_slices(s.names, s.shape, c)
                  for r, c in coords.items()}
        comp = {r: policy.local_slices(s.names, s.shape, c, axis="model")
                for r, c in coords.items()}
        gather_axes = [a for a in names if any(
            slices[r] != slices[rank] and comp[r] == comp[rank]
            for r in moved(a))]
        reduce_axes = [a for a in names if all(
            comp[r] == comp[rank] for r in moved(a))]
        out[name] = _Layout(
            s.shape, [slices[r] for r in range(len(coords))], rank,
            comp[rank], shlib.axis_group(mesh, gather_axes),
            shlib.axis_group(mesh, reduce_axes), dp)
    return out


class _Gather(torch.autograd.Function):
    """A block in, the rank's compute block out; the gradient back to the
    block is the ranks' mean (``_Layout.reduce``)."""

    @staticmethod
    def forward(ctx, local, layout: _Layout):
        ctx.layout = layout
        full = layout.compute(local)
        return local.view_as(local) if full is local else full

    @staticmethod
    def backward(ctx, grad):
        return ctx.layout.reduce(grad), None


def _owner(model, name: str):
    """``(module, attribute)`` holding the parameter ``name``."""
    *path, leaf = name.split(".")
    mod = model
    for k in path:
        mod = mod._modules[k]
    return mod, leaf


class _FSDP:
    """Shards a model's parameters into this rank's blocks in place and
    gathers them where the forward needs them."""

    def __init__(self, model, policy: shlib.ShardingPolicy):
        from repro_torch.models.convert import param_specs_by_name

        specs = param_specs_by_name(model)
        rank, world = dist.get_rank(), dist.get_world_size()
        self.layouts: Dict[str, _Layout] = _layouts(model, policy)
        self.shares: Dict[str, float] = {}
        self.owners: Dict[str, Tuple[torch.nn.Module, str]] = {}
        for name, p in list(model.named_parameters()):
            s = specs[name]
            layout = self.layouts[name]
            mod, leaf = _owner(model, name)
            # a whole weight, or this rank's compute block already
            # (``build_compute_blocks``)
            block = (layout.own if tuple(p.shape) == layout.compute_shape
                     else layout.slices[rank])
            mod._parameters[leaf] = torch.nn.Parameter(
                p.detach()[block].clone(), requires_grad=True)
            self.shares[name] = policy.sharded_count(s.names,
                                                     s.shape) / world
            self.owners[name] = (mod, leaf)
        self.blocks = dict(model.named_parameters())
        self.top = [n for n, _ in model.named_parameters(recurse=False)]
        for stack, li, layer in model.layers():
            names = [n for n in self.layouts
                     if n.startswith(f"{stack}.{li}.")]
            layer.register_forward_pre_hook(
                lambda mod, args, names=names: self.gather(names))
            layer.register_forward_hook(
                lambda mod, args, out, names=names: self.release(names))

    def gather(self, names) -> None:
        for n in names:
            mod, leaf = self.owners[n]
            mod._parameters[leaf] = _Gather.apply(self.blocks[n],
                                                  self.layouts[n])

    def release(self, names) -> None:
        for n in names:
            mod, leaf = self.owners[n]
            mod._parameters[leaf] = self.blocks[n]


def make_train_step(model, optimizer: AdamW, mesh_or_device=None, *,
                    compression: Optional[CompressionConfig] = None
                    ) -> TrainStep:
    """A train step for ``model``.  ``mesh_or_device``: None (where the
    model lives), a device (the model moves there), or a ``DeviceMesh``
    (its ranks on the model's device; see the module docstring).  The
    model's weights are made to take gradients.  Batches are dicts of
    tensors (moved to the device): tokens and labels ``int[B, S]``, a
    VLM's ``patch_embeds``, the audio family's ``frames``."""
    mesh = mesh_or_device if hasattr(mesh_or_device, "mesh_dim_names") \
        else None
    if mesh is None or mesh.size() == 1:
        dev = (model.device if mesh_or_device is None or mesh is not None
               else resolve_device(mesh_or_device))
        return _one_device(model, optimizer, dev)
    policy = mesh_policy(model.cfg, mesh)
    sizes = policy.axis_sizes
    if mesh.size() != dist.get_world_size():
        raise ValueError(f"the mesh's {mesh.size()} ranks are not the "
                         f"process group's {dist.get_world_size()}")
    pods = sizes.get("pod", 1)
    compressed = (pods > 1 and compression is not None
                  and compression.mode != "none")
    if compressed and (sizes["data"] > 1 or sizes.get("model", 1) > 1):
        raise NotImplementedError(
            f"a pod-compressed mesh with data {sizes['data']}, model "
            f"{sizes.get('model', 1)}: one rank a pod replica; see "
            f"{MULTI_DEVICE}")
    model.requires_grad_(True)
    if compressed:
        return _pod_compressed(model, optimizer, mesh, compression, pods)
    return _fsdp(model, optimizer, policy)


def mesh_policy(cfg, mesh) -> shlib.ShardingPolicy:
    """The sharding policy of ``mesh`` for a model of ``cfg``, with its
    ``ModelAxis`` when the mesh has more than one rank (on ``model`` 1
    its collectives over ``model`` are no-ops, and the dense MoE routes
    the global batch, as the reference's does); raises
    :data:`MULTI_DEVICE` for a family the ``model`` axis does not split
    yet."""
    policy = shlib.ShardingPolicy(mesh)
    m = policy.axis_sizes.get("model", 1)
    if m > 1 and cfg.family in UNSPLIT_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family}) on a mesh with model {m}; see "
            f"{MULTI_DEVICE}")
    if mesh.size() > 1:
        policy.model_axis = shlib.ModelAxis(policy)
    return policy


def _one_device(model, optimizer: AdamW, dev) -> TrainStep:
    model.to(dev)
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    leaves = list(params.values())

    def step_fn(opt_state: OptState, batch):
        batch = {k: v.to(dev) for k, v in batch.items()}
        loss = model.loss(batch)
        grads = torch.autograd.grad(loss, leaves)
        _, new_state, gnorm = optimizer.update(
            params, opt_state, dict(zip(params, grads)), opt_state.residual)
        return new_state, {"loss": loss.detach(), "grad_norm": gnorm}

    return TrainStep(step_fn=step_fn, model=model, optimizer=optimizer)


def _pod_compressed(model, optimizer: AdamW, mesh, compression, pods
                    ) -> TrainStep:
    from repro_torch.models.convert import stack_layers, unstack_layers

    policy = shlib.ShardingPolicy(mesh, allow_shard_map=False).without("pod")
    compressor = GradCompressor(compression)
    group = mesh.get_group("pod")
    dev = model.device
    params = dict(model.named_parameters())
    leaves = list(params.values())

    def step_fn(opt_state: OptState, batch):
        batch = {k: v.to(dev) for k, v in batch.items()}
        loss = model.loss(batch)
        grads = stack_layers(model, dict(zip(params, torch.autograd.grad(
            loss, leaves))))
        # the residual's layers sit under its replica axis
        grads, residual = compressor.replica_sum_ranks(
            grads, stack_layers(model, opt_state.residual, layer_axis=1),
            group=group)
        _, new_state, gnorm = optimizer.update(
            params, opt_state, unstack_layers(grads, model),
            unstack_layers(residual, model, layer_axis=1))
        losses = [torch.empty_like(loss) for _ in range(pods)]
        dist.all_gather(losses, loss.detach(), group=group)
        return new_state, {"loss": torch.stack(losses).mean(),
                           "grad_norm": gnorm}

    return TrainStep(step_fn=step_fn, model=model, optimizer=optimizer,
                     compressor=compressor, policy=policy, replicas=pods)


def _fsdp(model, optimizer: AdamW, policy: shlib.ShardingPolicy
          ) -> TrainStep:
    from torch.utils.checkpoint import set_checkpoint_early_stop

    fsdp = _FSDP(model, policy)
    dev = model.device
    params = fsdp.blocks
    leaves = list(params.values())
    shares = [fsdp.shares[n] for n in sorted(params)]  # the leaves' order
    world = dist.get_world_size()

    def step_fn(opt_state: OptState, batch):
        batch = {k: v.to(dev) for k, v in batch.items()}
        # early stop off: a recompute runs to the layer's forward hook,
        # which drops the gathered weights (and every rank runs the same
        # collectives)
        with set_checkpoint_early_stop(False), shlib.activate(policy):
            fsdp.gather(fsdp.top)
            try:
                loss = model.loss(batch)
            finally:
                fsdp.release(fsdp.top)
            grads = torch.autograd.grad(loss, leaves)
        _, new_state, gnorm = optimizer.update(
            params, opt_state, dict(zip(params, grads)), opt_state.residual,
            shares=shares)
        loss = loss.detach().clone()
        dist.all_reduce(loss)
        return new_state, {"loss": loss / world, "grad_norm": gnorm}

    return TrainStep(step_fn=step_fn, model=model, optimizer=optimizer,
                     policy=policy, layouts=fsdp.layouts)


def make_serve_fns(model, device=None):
    """``(prefill_fn, decode_fn)`` for ``model`` on ``device`` (None: where
    the model lives; another device moves the model there) or on a
    ``DeviceMesh`` of every rank of the process group.

    ``prefill_fn(batch, max_len)`` returns (last-token logits, cache) and
    ``decode_fn(cache, tokens, pos)`` (logits, cache), the cache written in
    place.  Inputs are moved to the device.  The cache is made in
    inference mode, so code that writes into it outside these functions
    runs under ``torch.inference_mode()`` too.

    On a mesh the model's weights become this rank's compute blocks in
    place (``to_compute_blocks``: its ``model`` block of each, whole over
    the data-parallel axes; weights drawn as blocks already,
    ``build_compute_blocks``, stay); ``prefill_fn`` takes a global batch
    and serves this rank's rows (``local_rows``), ``decode_fn`` this
    rank's rows' tokens; the logits are those rows', whole over the
    vocab; the cache holds this rank's KV heads.  Every rank calls them
    together."""
    mesh = device if hasattr(device, "mesh_dim_names") else None
    if mesh is None:
        dev = model.device if device is None else resolve_device(device)
        model.to(dev)
        policy = None
    else:
        dev = model.device
        policy = mesh_policy(model.cfg, mesh)
        to_compute_blocks(model, policy)

    @torch.inference_mode()
    def prefill_fn(batch, max_len: int):
        if policy is not None:
            batch = local_rows(policy, batch)
        with shlib.activate(policy):
            return model.prefill({k: v.to(dev) for k, v in batch.items()},
                                 max_len)

    @torch.inference_mode()
    def decode_fn(cache, tokens, pos):
        with shlib.activate(policy):
            return model.decode_step(cache, tokens.to(dev), pos)

    return prefill_fn, decode_fn


def _compute_slices(model, policy: shlib.ShardingPolicy):
    """``{name: (spec, this rank's compute-block slices)}``."""
    from repro_torch.models.convert import param_specs_by_name

    coord = policy.mesh.get_coordinate()
    return {n: (s, policy.local_slices(s.names, s.shape, coord,
                                       axis="model"))
            for n, s in param_specs_by_name(model).items()}


@torch.no_grad()
def to_compute_blocks(model, policy: shlib.ShardingPolicy) -> None:
    """Each of ``model``'s whole weights replaced, in place, by this
    rank's compute block (its ``model`` block; a full-EP expert stack's
    own experts); a weight already of the block's shape is kept."""
    for name, (s, sl) in _compute_slices(model, policy).items():
        mod, leaf = _owner(model, name)
        p = mod._parameters[leaf]
        block = tuple(len(range(*c.indices(n))) for c, n in zip(sl, s.shape))
        if tuple(p.shape) == block:
            continue
        if tuple(p.shape) != tuple(s.shape):
            raise ValueError(f"{name}: {tuple(p.shape)} is neither the "
                             f"whole {tuple(s.shape)} nor the block {block}")
        mod._parameters[leaf] = torch.nn.Parameter(
            p[sl].clone(), requires_grad=p.requires_grad)


def build_compute_blocks(cfg, mesh, device=None,
                         generator: Optional[torch.Generator] = None):
    """``build_model(cfg, device, generator)`` as this rank of ``mesh``
    computes with it: only its compute block of each weight is drawn on
    the device (its ``model`` block, whole over the data-parallel axes;
    a full-EP expert stack's own experts), equal to that block of the
    whole model's weight drawn from ``generator`` (on the device; seed 0
    when None) by ``Model.init_weights``, so that a configuration too
    large for one device can be served or trained.  Every rank calls it
    together."""
    from repro_torch.models import build_model

    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    model = build_model(cfg, device="meta")
    blocks = {n: sl for n, (_, sl) in _compute_slices(
        model, mesh_policy(cfg, mesh)).items()}
    model.init_weights(generator, blocks=blocks, device=dev)
    if dev.type == "cuda":  # the whole leaves' draws
        torch.cuda.empty_cache()
    return model

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
    ``pod`` > 1 uncompressed: the reference's ``fsdp_all``): each rank
    holds only its policy block of every parameter and of its m and v.  A
    layer's weights are gathered by a forward pre-hook on the layer and
    dropped by its forward hook, so under activation checkpointing the
    recompute gathers them again; the top-level weights (embeddings, the
    final norm) are gathered around the loss.  The gradients come back to
    the blocks averaged over the global batch.  The gather and its
    gradient are one ``autograd.Function`` (``_Gather``) over
    ``dist.all_gather`` and ``dist.all_reduce`` (the all-reduced full
    gradient, then this rank's block), not DTensor: with gloo, which runs
    the ranks that share one card, a DTensor's collectives on CUDA
    tensors hung (``mesh_wire_probe.py``).  The step is the one-device
    step on the global batch, up to reduction order.
  * ``model`` > 1 raises :data:`MULTI_DEVICE`; so does a pod-compressed
    mesh with ``data`` > 1.

The mesh's data-parallel ranks are the whole process group (the ``model``
axis is 1).  Each rank passes its own rows of the global batch
(``TrainStep.local_batch``).

``make_serve_fns`` gives the serving functions, run in inference mode.
"""
from __future__ import annotations

import dataclasses
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

__all__ = ["TrainStep", "make_train_step", "make_serve_fns", "MULTI_DEVICE"]

MULTI_DEVICE = ("ROADMAP queue 1, item 6c-ii (M10d, second half: the model "
                "axis — tensor parallelism, the distributed MoE, serving on "
                "a mesh)")


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
        (``pod`` major, then ``data``) split its rows evenly, in order."""
        if self.policy is None:
            return batch
        n, i = dist.get_world_size(), dist.get_rank()
        rows = next(iter(batch.values())).shape[0]
        if rows % n:
            raise ValueError(f"a batch of {rows} rows over {n} ranks")
        k = rows // n
        return {key: v[i * k:(i + 1) * k] for key, v in batch.items()}

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


class _Layout:
    """One parameter's blocks on the data-parallel ranks: ``slices[r]`` is
    rank ``r``'s block of the whole ``shape``."""

    def __init__(self, shape, slices: List[Tuple[slice, ...]]):
        self.shape = tuple(shape)
        self.slices = slices
        self.sharded = any(sl != slices[0] for sl in slices)

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

    def reduce(self, grad: torch.Tensor) -> torch.Tensor:
        """This rank's block of the ranks' mean gradient (a collective)."""
        total = grad.contiguous().clone()
        dist.all_reduce(total)
        return (total[self.slices[dist.get_rank()]] / len(self.slices)
                ).contiguous()


class _Gather(torch.autograd.Function):
    """A block in, the whole weight out; the gradient back to the block is
    the ranks' mean (``_Layout.reduce``)."""

    @staticmethod
    def forward(ctx, local, layout: _Layout):
        ctx.layout = layout
        full = layout.gather(local)
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
        coords = policy.coordinates()
        rank, world = dist.get_rank(), dist.get_world_size()
        self.layouts: Dict[str, _Layout] = {}
        self.shares: Dict[str, float] = {}
        self.owners: Dict[str, Tuple[torch.nn.Module, str]] = {}
        for name, p in list(model.named_parameters()):
            s = specs[name]
            layout = _Layout(s.shape, [policy.local_slices(
                s.names, s.shape, coords[r]) for r in range(world)])
            mod, leaf = _owner(model, name)
            mod._parameters[leaf] = torch.nn.Parameter(
                p.detach()[layout.slices[rank]].clone(), requires_grad=True)
            self.layouts[name] = layout
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
    policy = shlib.ShardingPolicy(mesh)
    sizes = policy.axis_sizes
    if sizes.get("model", 1) > 1:
        raise NotImplementedError(
            f"a mesh with model {sizes['model']}: tensor parallelism; see "
            f"{MULTI_DEVICE}")
    if mesh.size() != dist.get_world_size():
        raise ValueError(f"the mesh's {mesh.size()} ranks are not the "
                         f"process group's {dist.get_world_size()}")
    model.requires_grad_(True)
    pods = sizes.get("pod", 1)
    if pods > 1 and compression is not None and compression.mode != "none":
        if sizes["data"] > 1:
            raise NotImplementedError(
                f"a pod-compressed mesh with data {sizes['data']}: one rank "
                f"a pod replica; see {MULTI_DEVICE}")
        return _pod_compressed(model, optimizer, mesh, compression, pods)
    return _fsdp(model, optimizer, policy)


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
        # which drops the gathered weights
        with set_checkpoint_early_stop(False):
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
    the model lives; another device moves the model there).

    ``prefill_fn(batch, max_len)`` returns (last-token logits, cache) and
    ``decode_fn(cache, tokens, pos)`` (logits, cache), the cache written in
    place.  Inputs are moved to the device.  The cache is made in
    inference mode, so code that writes into it outside these functions
    runs under ``torch.inference_mode()`` too."""
    dev = model.device if device is None else resolve_device(device)
    model.to(dev)

    @torch.inference_mode()
    def prefill_fn(batch, max_len: int):
        return model.prefill({k: v.to(dev) for k, v in batch.items()},
                             max_len)

    @torch.inference_mode()
    def decode_fn(cache, tokens, pos):
        return model.decode_step(cache, tokens.to(dev), pos)

    return prefill_fn, decode_fn

"""AdamW on tensors, with a configurable accumulator dtype and an LR schedule.
Port of ``repro/distributed/optimizer.py``.

Plain functions on trees of tensors (nested dicts and lists, as
:mod:`repro_torch.core.tree` walks them), not ``torch.optim``: the update is
the reference's, leaf by leaf.  m and v are stored in ``acc_dtype`` (fp32;
bf16 for the largest configurations) and the update is computed in fp32
whatever the storage dtype.  The step counter is an int32 tensor on the
parameters' device, and the schedule, the bias corrections and the
global-norm clip are fp32 tensors there: an update never syncs the host.

``AdamW.update`` writes the new parameters, m and v into the given tensors
(the reference's jitted step donates those buffers, ``donate_argnums``) and
returns them with a new :class:`OptState` and the gradients' global norm.
Under FSDP each rank holds blocks of the leaves (``shares=``): the update is
elementwise on the blocks, and the global norm's sum of squares takes one
``all_reduce`` across the ranks before the ``sqrt``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Optional

import torch
import torch.distributed as dist

from repro_torch.core.tree import tree_leaves, tree_unflatten
from repro_torch.models.common import ParamSpec

__all__ = ["AdamWConfig", "AdamW", "OptState", "cosine_schedule"]

PyTree = Any

# elements of a leaf updated at a time: the update's fp32 temporaries of a
# 1 G-element leaf (llama4-scout's embedding) came to 23 GB beside its
# state; slices of 2**26 keep each at 256 MB, and elementwise math gives
# the same bits in slices as whole
UPDATE_SLICE = 1 << 26


def _map(fn, tree: PyTree, *rest: PyTree) -> PyTree:
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``), in ``tree``'s structure."""
    others = [tree_leaves(t) for t in rest]
    return tree_unflatten(tree, [fn(*xs) for xs in zip(tree_leaves(tree),
                                                      *others)])


def cosine_schedule(step: torch.Tensor, *, base_lr: float, warmup: int,
                    total: int, min_ratio: float = 0.1) -> torch.Tensor:
    """Linear warm-up to ``base_lr``, then a cosine decay to ``min_ratio *
    base_lr`` at ``total``; fp32 on ``step``'s device."""
    step = step.float()
    warm = base_lr * step / max(warmup, 1)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = base_lr * (min_ratio + (1 - min_ratio) * 0.5 * (
        1 + torch.cos(math.pi * prog)
    ))
    return torch.where(step < warmup, warm, cos)


class OptState(NamedTuple):
    step: torch.Tensor  # int32 0-d
    m: PyTree
    v: PyTree
    residual: Optional[PyTree] = None  # error feedback (grad compression)


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    base_lr: float = 3e-4
    warmup: int = 100
    total_steps: int = 10000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    acc_dtype: torch.dtype = torch.float32  # bf16 for the largest configs


@dataclasses.dataclass(frozen=True)
class AdamW:
    config: AdamWConfig = AdamWConfig()

    def init(self, params: PyTree, with_residual: bool = False,
             replicas: int = 1) -> OptState:
        """Zero m and v in ``acc_dtype`` beside each parameter, and a zero
        int32 step on the first parameter's device.  ``replicas > 1``: the
        error-feedback residuals carry a leading per-replica dim (bf16)."""
        acc = self.config.acc_dtype
        res = (_map(lambda p: torch.zeros((replicas,) + tuple(p.shape),
                                          dtype=torch.bfloat16,
                                          device=p.device), params)
               if with_residual else None)
        dev = tree_leaves(params)[0].device
        return OptState(
            step=torch.zeros((), dtype=torch.int32, device=dev),
            m=_map(lambda p: torch.zeros_like(p, dtype=acc), params),
            v=_map(lambda p: torch.zeros_like(p, dtype=acc), params),
            residual=res,
        )

    def state_specs(self, param_specs: PyTree, with_residual: bool = False,
                    replicas: int = 1) -> OptState:
        """ParamSpec tree of the optimizer state."""
        c = self.config

        def acc(s: ParamSpec) -> ParamSpec:
            return ParamSpec(s.shape, s.names, dtype=c.acc_dtype,
                             init="zeros")

        def res(s: ParamSpec) -> ParamSpec:
            return ParamSpec((replicas,) + s.shape, ("replicas",) + s.names,
                             dtype=torch.bfloat16, init="zeros")

        return OptState(
            step=ParamSpec((), (), dtype=torch.int32, init="zeros"),
            m=_map(acc, param_specs),
            v=_map(acc, param_specs),
            residual=_map(res, param_specs) if with_residual else None,
        )

    @torch.no_grad()
    def project(self, state: OptState) -> OptState:
        """Bring a restored state back among the states Adam reaches, in
        place: each v at least ``(m / C)**2``, where ``C**2 = (1 - b1)**2
        / ((1 - b2) * (1 - b1**2 / b2))`` bounds ``m**2 / v`` for any
        gradients (Cauchy-Schwarz over the two EWMAs), less a 2**-6
        margin so that a state a step made is left as it is.  A lossy
        (FPTC-compressed) checkpoint brings small v back negative or near
        zero beside a nonzero m (a tenth of a smoke model's v entries came
        back negative), and ``m / (sqrt(v) + eps)`` then gives NaN or a
        step of ``|m| / eps``; projected, every step stays within ``C *
        sqrt(1 - b2**t) / (1 - b1**t)`` of ``lr``.  With ``b1**2 >= b2``
        there is no such bound and v is only kept from going negative."""
        c = self.config
        ratio = c.b1 * c.b1 / c.b2
        inv_c2 = ((1 - c.b2) * (1 - ratio) / (1 - c.b1) ** 2
                  * (1 - 2.0 ** -6)) if ratio < 1 else 0.0
        for m, v in zip(tree_leaves(state.m), tree_leaves(state.v)):
            v.copy_(torch.maximum(v.float(), inv_c2 * torch.square(
                m.float())))
        return state

    @torch.no_grad()
    def update(self, params: PyTree, state: OptState, grads: PyTree,
               residual: Optional[PyTree] = None, *,
               shares: Optional[list] = None):
        """One AdamW step: the global-norm clip (fp32), bias-corrected
        moments, decoupled weight decay added to the step before the ``lr``
        multiply.  Writes the new parameters, m and v into ``params``,
        ``state.m`` and ``state.v``; returns ``(params, OptState, gnorm)``
        with ``gnorm`` a 0-d fp32 tensor.  ``shares`` (one a leaf, in
        leaf order): the leaves are this rank's blocks, each held by a
        ``1 / share`` of the ranks; each block's sum of squares is
        weighted by its share and the total summed across the ranks of
        the default group, so every element counts once."""
        c = self.config
        step = state.step + 1
        lr = cosine_schedule(step, base_lr=c.base_lr, warmup=c.warmup,
                             total=c.total_steps)
        g_leaves = tree_leaves(grads)
        if shares is None:
            sq = sum(torch.sum(torch.square(g.float())) for g in g_leaves)
        else:
            sq = sum(w * torch.sum(torch.square(g.float()))
                     for w, g in zip(shares, g_leaves))
            dist.all_reduce(sq)
        gnorm = torch.sqrt(sq)
        scale = torch.clamp(c.clip_norm / (gnorm + 1e-12), max=1.0)
        b1c = 1.0 - c.b1 ** step.float()
        b2c = 1.0 - c.b2 ** step.float()
        for p, g, m, v in zip(tree_leaves(params), g_leaves,
                              tree_leaves(state.m), tree_leaves(state.v)):
            # views: the slices' writes land in the leaves
            p, g, m, v = p.view(-1), g.reshape(-1), m.view(-1), v.view(-1)
            for a in range(0, p.numel(), UPDATE_SLICE):
                p_, g_, m_, v_ = (t[a:a + UPDATE_SLICE] for t in (p, g, m, v))
                g_ = g_.float() * scale
                m32 = c.b1 * m_.float() + (1 - c.b1) * g_
                v32 = c.b2 * v_.float() + (1 - c.b2) * torch.square(g_)
                delta = (m32 / b1c) / (torch.sqrt(v32 / b2c) + c.eps)
                delta = delta + c.weight_decay * p_.float()
                p_.copy_(p_.float() - lr * delta)
                m_.copy_(m32)
                v_.copy_(v32)
        return params, OptState(
            step=step, m=state.m, v=state.v,
            residual=residual if residual is not None else state.residual,
        ), gnorm

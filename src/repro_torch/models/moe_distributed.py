"""Expert-parallel MoE on ranks: scatter dispatch + all-to-all.
Port of ``repro/models/moe_distributed.py``.

The reference writes this with ``shard_map``; here each rank runs its own
block, and the exchanges are ``sharding.all_to_all`` (an autograd
Function: its backward is the same exchange of the cotangents), so the
backward comes through autograd:

  1. each (data, model) rank routes a disjoint slice of its tokens: the
     tokens are whole on every ``model`` rank at entry (the layer's
     gather point), and ``model`` rank j takes the j-th ``1/|model|`` of
     them (``t_eff``);
  2. position-in-expert is a **sort-rank** (a stable argsort by expert
     id, segment-relative ranks; ``sort_rank``) — no ``[T, E]`` one-hot;
  3. the kept pairs are scattered into a per-rank ``[E, C, d]`` send
     buffer, C = ``max(8, round_up_8(ceil(2 * t_eff * k / E)))`` (the
     dense dispatch's capacity is another rule, over all tokens);
  4. the all-to-all hands each rank its experts' slots from every rank:
     ``[E, C, d] -> [E/n, C*n, d]``;
  5. the experts run as batched matmuls over the local expert dim;
  6. the reverse all-to-all, the gather-back and the gate-weighted
     combine into this rank's token slice.

Two layouts (the weights' ``experts`` spec entry, ``transformer.
expert_block``): **full EP** when the experts divide ``data x model``
(``data`` > 1): whole experts on each rank, never gathered, one exchange
over both axes; **model-axis EP** otherwise: experts over ``model``, each
rank's expert weights gathered over ``data`` by the train step's FSDP
(whole in serving), the exchange over ``model``.  The output is this
rank's token slice in a zero ``[B, S, d]``: a partial sum over ``model``
that the layer reduce-scatters onto the sequence (the reference's
``psum_scatter``) or all-reduces (its ``psum``).  The reference's nested
branch (inside the pod-manual compressed step) is not ported: the
pod-compressed step with a ``model`` axis is ROADMAP item 6c-iii.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.common import silu
from repro_torch.models.config import ArchConfig

__all__ = ["moe_apply_sharded", "sort_rank", "shard_capacity"]


def sort_rank(expert_ids: torch.Tensor, num_experts: int) -> torch.Tensor:
    """``rank[i]`` = #(j < i with ``expert_ids[j] == expert_ids[i]``), by
    a stable argsort: sort by expert, segment-relative ranks from a
    cummax over the segment starts, the permutation inverted."""
    del num_experts  # the reference's signature; the sort needs no count
    n = expert_ids.shape[0]
    order = torch.argsort(expert_ids, stable=True)
    sorted_e = expert_ids[order]
    idx = torch.arange(n, device=expert_ids.device)
    is_start = torch.ones(n, dtype=torch.bool, device=expert_ids.device)
    is_start[1:] = sorted_e[1:] != sorted_e[:-1]
    seg_start = torch.cummax(torch.where(is_start, idx, 0), 0).values
    return torch.empty_like(idx).scatter_(0, order, idx - seg_start)


def shard_capacity(cfg: ArchConfig, t_eff: int) -> int:
    """Slots per expert for a rank's ``t_eff`` tokens: twice the mean
    load, rounded up to 8, at least 8."""
    cap = -(-2 * t_eff * cfg.moe_top_k // cfg.moe_num_experts)
    return max(8, -(-cap // 8) * 8)


def moe_apply_sharded(cfg: ArchConfig, p, x: torch.Tensor, ax,
                      stats: Optional[dict] = None) -> torch.Tensor:
    """x: this data rank's ``[B, S, d]``, whole on every ``model`` rank ->
    ``[B, S, d]``, zero but for this rank's token slice (a partial sum
    over ``model``).  ``p``: the router whole, the expert weights this
    rank's experts.  ``stats``: this rank's slice's ``dropped`` pairs and
    ``experts_hit``, 0-d device tensors, and its pairs' ``keep`` mask
    ``[t_eff, k]`` from flattened token ``first``."""
    from repro_torch.distributed.sharding import all_to_all, axis_group
    from repro_torch.models.transformer import expert_block

    b, s, d = x.shape
    x2 = x.reshape(b * s, d)
    t_loc = b * s
    ne, topk = cfg.moe_num_experts, cfg.moe_top_k
    nm = ax.size
    t_eff = max(t_loc // nm, 1)
    cap = shard_capacity(cfg, t_eff)
    axes, _, n_local = expert_block(cfg, ax)
    full_ep = "data" in axes and ax.policy.axis_sizes["data"] > 1
    group = axis_group(ax.mesh, ("data", "model") if full_ep
                       else ("model",))
    n = ne // n_local  # ranks in the exchange

    # route this rank's slice (the reference's dynamic_slice clamps)
    start = min(ax.index * t_eff, t_loc - t_eff)
    xj = x2.narrow(0, start, t_eff)
    logits = xj.float() @ p["router"]
    gates, chosen = torch.topk(logits, topk, dim=-1)
    gates = torch.softmax(gates, dim=-1)
    e_flat = chosen.reshape(-1)
    rank = sort_rank(e_flat, ne)
    keep = rank < cap
    slot = torch.where(keep, rank, cap - 1)
    kept = keep[:, None].to(x.dtype)

    # dispatch: kept pairs into their expert's slot (a dropped pair adds
    # zeros to its expert's last slot)
    xdup = xj.repeat_interleave(topk, 0)
    send = x.new_zeros((ne, cap, d)).index_put(
        (e_flat, slot), xdup * kept, accumulate=True)
    recv = all_to_all(send, group)  # block i from rank i
    recv = recv.view(n, n_local, cap, d).transpose(0, 1).reshape(
        n_local, n * cap, d)
    h = silu(torch.bmm(recv, p["wg"])) * torch.bmm(recv, p["wi"])
    out_e = torch.bmm(h, p["wo"])  # [E/n, n * C, d]
    back = all_to_all(out_e.view(n_local, n, cap, d).transpose(0, 1)
                      .reshape(ne, cap, d), group)  # [E, C, d]

    # combine: each pair's row times keep, times its bf16 gate, summed
    y_dup = back[e_flat, slot] * kept
    g = gates.reshape(-1, 1).to(x.dtype)
    y = (y_dup * g).view(t_eff, topk, d).float().sum(1).to(x.dtype)
    out = torch.cat([x2.new_zeros((start, d)), y,
                     x2.new_zeros((t_loc - start - t_eff, d))])
    if stats is not None:
        stats["dropped"] = (~keep).sum()
        stats["experts_hit"] = (torch.bincount(e_flat, minlength=ne)
                                > 0).sum()
        stats["keep"], stats["first"] = keep.view(t_eff, topk), start
    return out.view(b, s, d)

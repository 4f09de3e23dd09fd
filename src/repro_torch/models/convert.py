"""Carry parameters, optimizer state and caches between the reference's
layout and the port's.

The reference keeps a model's parameters, and Adam's m and v beside them,
as nested dicts whose stacks' leaves (``group<i>``, RWKV's ``layers``,
whisper's ``encoder`` and ``decoder``) are stacked on a leading layer
axis; the port keeps one module per layer, and m and v per parameter
(``OptState.m`` and ``.v`` keyed by ``model.named_parameters()`` names).

* ``params_from_jax(tree, model)`` loads a reference parameter tree
  (``jax.tree_util.tree_map(np.asarray, params)``) into a
  :class:`~repro_torch.models.api.Model`, one layer at a time, every leaf
  in its own dtype (the MoE router and the SSM's ``dt_bias``, ``A_log``
  and ``D`` are fp32; expert stacks ``[E, ...]`` stay whole per layer);
  ``opt_state_from_jax(state, model)`` turns the reference's ``OptState``
  into the port's.
* ``train_state_tree(model, opt_state)`` is the port's training state as
  the reference's ``{"params", "m", "v"}`` tree, the tree a training
  checkpoint saves (so the two packages restore each other's);
  ``save_train_state(directory, step, model, opt_state, ...)`` saves it,
  its weights raw; ``load_train_state(tree, model, opt_state, step,
  optimizer)`` loads such a tree (numpy arrays or tensors) back.
* ``cache_from_jax(tree, device)`` turns a reference decode cache into the
  port's.

bf16 arrays arrive as ``ml_dtypes.bfloat16`` and are read through their
16-bit patterns, so neither JAX nor ``ml_dtypes`` is imported here.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, List, Mapping, Tuple

import numpy as np
import torch

from repro_torch.models.api import spec_leaves

__all__ = ["to_torch", "params_from_jax", "cache_from_jax",
           "opt_state_from_jax", "train_state_tree", "save_train_state",
           "load_train_state"]

# the keys of a training state whose leaves a checkpoint writes raw
# (``save_checkpoint(raw=...)``): the weights, fp32 ones included (the
# hybrid's SSM leaves, RWKV's ``w_base`` and ``u``, the MoE routers), come
# back bit for bit; only Adam's m and v go through the lossy codec.  The
# reference compresses fp32 weights too
_TRAIN_STATE_RAW = ("params",)


def to_torch(arr: Any, device=None) -> torch.Tensor:
    """A numpy array (bf16 through its bit pattern) or a tensor as a tensor
    on ``device`` (None: a tensor stays where it is, an array lands on the
    CPU)."""
    if isinstance(arr, torch.Tensor):
        return arr if device is None else arr.to(device)
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.tensor(arr.view(np.int16), device=device).view(
            torch.bfloat16)
    return torch.tensor(arr, device=device)


def _in_stack(path: Tuple[str, ...]) -> bool:
    """Whether a spec leaf lies in a stack of layers: every top-level
    leaf is a ``ParamSpec``, every stack a subtree."""
    return len(path) > 1


def _leaf_names(model) -> Iterator[Tuple[Tuple[str, ...], List[str]]]:
    """``(reference path, port names)`` of every leaf of the model's spec
    tree: a stacked leaf has one parameter name per layer."""
    for path, _ in spec_leaves(model.param_specs()):
        if _in_stack(path):
            count = len(model[path[0]])
            yield path, [".".join((path[0], str(li)) + path[1:])
                         for li in range(count)]
        else:
            yield path, [path[0]]


def _check_keys(tree: Mapping, specs: Mapping, where: str = "") -> None:
    if set(tree) != set(specs):
        raise KeyError(
            f"{where or 'params'}: keys only in the given tree "
            f"{sorted(set(tree) - set(specs))}, only in the model "
            f"{sorted(set(specs) - set(tree))}")
    for k, s in specs.items():
        if isinstance(s, Mapping):
            if not isinstance(tree[k], Mapping):
                raise KeyError(f"{where}.{k}: a leaf where the model has "
                               f"a subtree")
            _check_keys(tree[k], s, f"{where}.{k}" if where else k)


def _unstacked(tree: Mapping, model) -> Dict[str, Any]:
    """The leaves of a reference-layout tree by port parameter name (a
    stacked leaf's layer ``li`` is its ``[li]``)."""
    _check_keys(tree, model.param_specs())
    out: Dict[str, Any] = {}
    for path, names in _leaf_names(model):
        leaf = tree
        for k in path:
            leaf = leaf[k]
        if _in_stack(path):
            leaf = leaf if isinstance(leaf, torch.Tensor) else np.asarray(
                leaf)
            for li, name in enumerate(names):
                out[name] = leaf[li]
        else:
            out[names[0]] = leaf
    return out


def _stacked(model, by_name: Mapping[str, torch.Tensor]) -> dict:
    """``by_name`` (one tensor per parameter) in the reference's layout."""
    tree: dict = {}
    for path, names in _leaf_names(model):
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        if _in_stack(path):
            node[path[-1]] = torch.stack([by_name[n] for n in names])
        else:
            node[path[-1]] = by_name[names[0]]
    return tree


def _copy(dst: torch.Tensor, src: Any, name: str) -> None:
    t = to_torch(src)
    if tuple(t.shape) != tuple(dst.shape) or t.dtype != dst.dtype:
        raise ValueError(f"{name}: given {t.dtype} {tuple(t.shape)}, the "
                         f"model holds {dst.dtype} {tuple(dst.shape)}")
    with torch.no_grad():
        dst.copy_(t)


def params_from_jax(tree: Mapping, model) -> None:
    """Load the reference's parameter tree into ``model`` in place.  A key
    in one tree and not the other raises ``KeyError``; a shape or dtype
    mismatch ``ValueError``."""
    leaves = _unstacked(tree, model)
    for name, p in model.named_parameters():
        _copy(p, leaves[name], name)


def opt_state_from_jax(state: Any, model):
    """The reference's ``OptState`` (its leaves as numpy arrays: ``jax.
    tree_util.tree_map(np.asarray, state)``) as the port's, m and v per
    parameter on the model's device.  The error-feedback residual is not
    carried (the pod-compressed mode is not ported)."""
    from repro_torch.distributed.optimizer import OptState

    dev = model.device
    m, v = _unstacked(state.m, model), _unstacked(state.v, model)
    return OptState(
        step=torch.tensor(int(np.asarray(state.step)), dtype=torch.int32,
                          device=dev),
        m={n: to_torch(np.asarray(m[n]), dev) for n, _ in
           model.named_parameters()},
        v={n: to_torch(np.asarray(v[n]), dev) for n, _ in
           model.named_parameters()},
    )


@torch.no_grad()
def train_state_tree(model, opt_state) -> dict:
    """``{"params", "m", "v"}`` in the reference's layout (keys, shapes and
    dtypes), on the model's device: what a training checkpoint saves.
    Stacking a group's layers is a copy, so while the tree lives the state
    takes twice its memory (cheap at a cut depth; at full depth a save
    doubles the state's memory for its duration)."""
    params = {n: p.detach() for n, p in model.named_parameters()}
    return {"params": _stacked(model, params),
            "m": _stacked(model, opt_state.m),
            "v": _stacked(model, opt_state.v)}


def save_train_state(directory: str, step: int, model, opt_state, *,
                     compress: bool = False, device=None) -> str:
    """``save_checkpoint`` of ``train_state_tree(model, opt_state)`` as
    step ``step`` under ``directory``; returns the step's directory.  With
    ``compress``, m and v are FPTC-compressed (encoded on ``device``, the
    card unless ``"cpu"``) and the weights written raw, so they come back
    bit for bit."""
    from repro_torch.distributed.checkpoint import save_checkpoint

    return save_checkpoint(directory, step, train_state_tree(model,
                                                             opt_state),
                           compress=compress, device=device,
                           raw=_TRAIN_STATE_RAW)


def load_train_state(tree: Mapping, model, opt_state, step: int,
                     optimizer):
    """Load a ``{"params", "m", "v"}`` tree in the reference's layout (as
    ``restore_latest`` returns it) into ``model`` and ``opt_state``'s m and
    v in place, m and v projected onto the states ``optimizer`` reaches
    (``AdamW.project``: a compressed checkpoint brings v back negative in
    places; a raw one is left as it was); returns the ``OptState`` at
    ``step``."""
    params = _unstacked(tree["params"], model)
    m, v = _unstacked(tree["m"], model), _unstacked(tree["v"], model)
    for name, p in model.named_parameters():
        _copy(p, params[name], f"params.{name}")
        _copy(opt_state.m[name], m[name], f"m.{name}")
        _copy(opt_state.v[name], v[name], f"v.{name}")
    optimizer.project(opt_state)
    return opt_state._replace(step=torch.tensor(
        step, dtype=torch.int32, device=opt_state.step.device))


def cache_from_jax(tree: Mapping, device=None) -> dict:
    """The reference's decode cache (dicts of arrays stacked on the layer
    axis, nested by group or flat: ``k``/``v``, MLA's ``ckv``/``kr``, the
    hybrid's ``conv`` and fp32 ``ssm``, RWKV's ``shift1``/``shift2`` and
    fp32 ``wkv``, whisper's ``k``/``v``/``ck``/``cv``) as the port's, each
    leaf in its own dtype, on ``device``."""
    return {k: cache_from_jax(v, device) if isinstance(v, Mapping)
            else to_torch(v, device) for k, v in tree.items()}

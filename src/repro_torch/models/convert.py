"""Carry the reference's parameters and caches into the port.

``params_from_jax(tree, model)`` loads a parameter tree of the JAX package
(``jax.tree_util.tree_map(np.asarray, params)``: nested dicts of numpy
arrays, each ``group<i>`` stacked on a leading layer axis) into a
:class:`~repro_torch.models.api.Model`, one layer at a time.
``cache_from_jax(tree, device)`` turns a reference decode cache into the
port's.  bf16 leaves arrive as ``ml_dtypes.bfloat16`` arrays; they are
read through their 16-bit patterns, so neither JAX nor ``ml_dtypes`` is
imported here.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

__all__ = ["to_torch", "params_from_jax", "cache_from_jax"]


def to_torch(arr: Any, device=None) -> torch.Tensor:
    """A numpy array (bf16 through its bit pattern) as a tensor on
    ``device``."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.tensor(arr.view(np.int16), device=device).view(
            torch.bfloat16)
    return torch.tensor(arr, device=device)


def _same_keys(got: Mapping, want: Mapping, where: str) -> None:
    if set(got) != set(want):
        raise KeyError(
            f"{where or 'params'}: keys only in the given tree "
            f"{sorted(set(got) - set(want))}, only in the model "
            f"{sorted(set(want) - set(got))}")


def _copy(p: torch.Tensor, arr: np.ndarray, name: str) -> None:
    t = to_torch(arr)
    if tuple(t.shape) != tuple(p.shape) or t.dtype != p.dtype:
        raise ValueError(f"{name}: given {t.dtype} {tuple(t.shape)}, the "
                         f"model holds {p.dtype} {tuple(p.shape)}")
    with torch.no_grad():
        p.copy_(t)


def _load(dst, tree: Mapping, where: str, layer: int) -> None:
    """Copy layer ``layer`` of ``tree``'s stacked leaves into the layer
    module ``dst``."""
    _same_keys(tree, {**dst._parameters, **dst._modules}, where)
    for k, v in tree.items():
        name = f"{where}.{k}"
        if isinstance(v, Mapping):
            _load(dst[k], v, name, layer)
        else:
            _copy(dst[k], np.asarray(v)[layer], name)


def params_from_jax(tree: Mapping, model) -> None:
    """Load the reference's parameter tree into ``model`` in place.  A key
    in one tree and not the other raises ``KeyError``; a shape or dtype
    mismatch ``ValueError``."""
    _same_keys(tree, {**model._parameters, **model._modules}, "")
    for k, v in tree.items():
        if k.startswith("group"):
            for li, layer in enumerate(model[k]):
                _load(layer, v, f"{k}[{li}]", li)
        else:
            _copy(model[k], np.asarray(v), k)


def cache_from_jax(tree: Mapping, device=None) -> dict:
    """The reference's decode cache (nested dicts of ``[L, B, T, KV, hd]``
    arrays) as the port's, on ``device``."""
    return {k: cache_from_jax(v, device) if isinstance(v, Mapping)
            else to_torch(v, device) for k, v in tree.items()}

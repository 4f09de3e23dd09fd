"""Nested containers of tensors ("trees"): the walk the workloads and the
checkpoint share.

The reference walks pytrees with ``jax.tree_util``; the port's trees are
nested ``dict``s, ``list``s and ``tuple``s whose other values are leaves
(tensors, arrays, scalars), and ``None`` is an empty subtree, as in JAX.
The walk reproduces JAX's order — a dict's keys sorted, a sequence's items
in place — and its key strings (``jax.tree_util.keystr``: ``['p']['w']``
for dict keys, ``[0]`` for a sequence index), so a checkpoint written by
either package names its leaves, and their files, alike.
"""
from __future__ import annotations

from typing import Any, Iterator, List, Sequence, Tuple

__all__ = ["tree_flatten_with_path", "tree_leaves", "tree_unflatten"]


def _children(tree: Any):
    """``(key string, child)`` pairs of an inner node, or None for a leaf."""
    if isinstance(tree, dict):
        return [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return [(f"[{i}]", v) for i, v in enumerate(tree)]
    return None


def _walk(tree: Any, prefix: str) -> Iterator[Tuple[str, Any]]:
    if tree is None:
        return
    children = _children(tree)
    if children is None:
        yield prefix, tree
        return
    for key, child in children:
        yield from _walk(child, prefix + key)


def tree_flatten_with_path(tree: Any) -> List[Tuple[str, Any]]:
    """``(key string, leaf)`` for every leaf, in JAX's flattening order."""
    return list(_walk(tree, ""))


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of ``tree`` in JAX's flattening order."""
    return [leaf for _, leaf in _walk(tree, "")]


def tree_unflatten(tree_like: Any, leaves: Sequence[Any]) -> Any:
    """A tree of ``tree_like``'s structure holding ``leaves`` in order."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            return type(node)((k, build(node[k])) for k in sorted(node))
        if isinstance(node, (list, tuple)):
            items = [build(v) for v in node]
            return items if isinstance(node, list) else type(node)(items)
        return next(it)

    out = build(tree_like)
    if next(it, it) is not it:
        raise ValueError("more leaves than the tree has places for")
    return out

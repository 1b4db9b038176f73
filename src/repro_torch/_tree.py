"""Nested-dict parameter trees: the port's stand-in for JAX pytrees.

Parameters, gradients, masks and optimizer moments are nested ``dict``s of
tensors. Flattening visits keys in sorted order, exactly as
``jax.tree_util`` flattens a dict, so leaf indices, packed-plan entry
order and segment ids agree with the JAX package leaf for leaf.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

__all__ = ["flatten_with_path", "leaves", "unflatten_like", "tree_map"]


def flatten_with_path(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """[(``'/'``-joined path, leaf)] in JAX's dict order (sorted keys)."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            path = f"{prefix}/{k}" if prefix else str(k)
            out.extend(flatten_with_path(tree[k], path))
        return out
    return [(prefix, tree)]


def leaves(tree: Any) -> List[Any]:
    """The leaves of ``tree`` in flattening order."""
    return [leaf for _, leaf in flatten_with_path(tree)]


def unflatten_like(tree: Any, new_leaves: List[Any]) -> Any:
    """A tree shaped like ``tree`` whose leaves are ``new_leaves`` (in
    flattening order)."""
    it = iter(new_leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)

    out = build(tree)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has slots")
    return out


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leafwise over trees of identical structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)

"""Parameter trees of the port: nested dicts and lists with tensor leaves
(the JAX package's pytrees).  Leaves are visited in insertion order."""

from __future__ import annotations

from typing import Any, Callable, List, Tuple


def tree_leaves(tree) -> List[Any]:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) pairs, paths joined with "/" ("blocks/0/self_attn/q/w")."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in tree_paths(v, f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in tree_paths(v, f"{prefix}/{i}")]
    return [(prefix.lstrip("/"), tree)]


def tree_map(fn: Callable, tree, *rest):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)

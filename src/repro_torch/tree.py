"""Walking nested-dict trees (params, optimizer state, checkpoints) in
the JAX package's leaf order.

``jax.tree`` flattens a dict in sorted-key order, a list or tuple in
index order, and treats ``None`` as a node without leaves. The port's
optimizers, gradient compression and checkpoints walk their trees the
same way, so sums over leaves (``optim.adamw.global_norm``) add in the
reference's order and checkpoint keys (``"stack__scan__p0__ln1"``) name
the same leaves.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

PyTree = Any


def _children(tree: PyTree):
    if isinstance(tree, dict):
        return [(k, tree[k]) for k in sorted(tree)]
    return list(enumerate(tree))


def _is_node(tree: PyTree) -> bool:
    return isinstance(tree, (dict, list, tuple)) or tree is None


def flatten_with_path(tree: PyTree, prefix: Tuple = ()
                      ) -> List[Tuple[Tuple, Any]]:
    """[(path, leaf)] in the JAX package's order; a path is the tuple of
    dict keys and sequence indices from the root."""
    if tree is None:
        return []
    if not _is_node(tree):
        return [(prefix, tree)]
    out = []
    for k, v in _children(tree):
        out.extend(flatten_with_path(v, prefix + (k,)))
    return out


def leaves(tree: PyTree) -> List[Any]:
    return [leaf for _, leaf in flatten_with_path(tree)]


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (same structure), visited in the JAX package's order."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def structure(tree: PyTree) -> str:
    """The tree's shape with ``*`` for each leaf, written as
    ``jax.tree_util.tree_structure`` prints a tree of dicts."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {structure(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        inner = ", ".join(structure(v) for v in tree)
        return f"[{inner}]" if isinstance(tree, list) else f"({inner})"
    return "*"

"""Nested dict / list / tuple trees of tensors: the port's stand-in for
`jax.tree` over parameters, gradients, optimizer moments and checkpoints.
Dict keys are walked in sorted order and ``None`` is an empty subtree,
as in JAX."""
from __future__ import annotations


def tree_map(fn, tree, *rest):
    """`fn` applied leaf by leaf to `tree` and the trees in `rest`, which
    share its structure, in the order of `tree_leaves`."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def _join(prefix: str, key) -> str:
    return f"{prefix}/{key}" if prefix else str(key)


def tree_map_with_path(fn, tree, prefix: str = ""):
    """`fn(name, leaf)` leaf by leaf; a name joins the dict keys and list
    indices above the leaf with "/", as the reference's checkpoint names
    them."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, t, _join(prefix, k))
                for k, t in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, t, _join(prefix, i))
                          for i, t in enumerate(tree))
    return fn(prefix, tree)


def named_leaves(tree, prefix: str = "") -> list:
    """[(name, leaf)] in sorted-key order (names as `tree_map_with_path`
    gives them)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        items = sorted(tree.items())
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return [(prefix, tree)]
    return [named for k, sub in items
            for named in named_leaves(sub, _join(prefix, k))]


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in named_leaves(tree)]

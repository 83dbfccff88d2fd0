"""Maps over the port's parameter trees: nested dicts (and tuples or lists,
such as the Q-Former's per-layer list) whose leaves are tensors or None (an
absent leaf, such as a tied ``lm_head``)."""
from __future__ import annotations


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of structurally equal trees; None stays None."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The non-None leaves, dict keys in insertion order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [] if tree is None else [tree]


def tree_paths(tree, prefix: tuple = ()) -> list:
    """The path (a tuple of dict keys and sequence indices) of every leaf of
    ``tree_leaves``, in its order."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in tree_paths(v, prefix + (k,))]
    if isinstance(tree, (tuple, list)):
        return [p for i, v in enumerate(tree) for p in tree_paths(v, prefix + (i,))]
    return [] if tree is None else [prefix]

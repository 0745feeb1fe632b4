"""The port's trees: nested dicts, lists, tuples and named tuples of tensors
(weights, optimizer state, train state, checkpoints).

One leaf order, shared by the optimizer, the train step and checkpoints:
dict values in sorted key order (as ``jax.tree`` orders them), sequences in
order. Named tuples (``TrainState``, ``AdamWState``, ``Quantized``) are
nodes; ``is_leaf`` stops the walk at a subtree, as in ``jax.tree``.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

IsLeaf = Optional[Callable[[Any], bool]]


def _node(tree, is_leaf: IsLeaf):
    """(keys, children, make) of a node in leaf order, or None for a leaf;
    ``make`` builds the node's type from new children."""
    if is_leaf is not None and is_leaf(tree):
        return None
    if isinstance(tree, dict):
        keys = sorted(tree)
        return keys, [tree[k] for k in keys], lambda v: dict(zip(keys, v))
    if isinstance(tree, (list, tuple)):
        keys = range(len(tree))
        if hasattr(tree, "_fields"):
            return keys, list(tree), lambda v: type(tree)(*v)
        return keys, list(tree), lambda v: type(tree)(v)
    return None


def flatten(tree, is_leaf: IsLeaf = None
            ) -> Tuple[List[Any], Callable[[List[Any]], Any]]:
    """(leaves, rebuild): the leaves in the fixed order, and a function that
    builds the same structure from a list of new leaves."""
    node = _node(tree, is_leaf)
    if node is None:
        return [tree], lambda leaves: leaves[0]
    _, kids, make = node
    parts = [flatten(k, is_leaf) for k in kids]
    sizes = [len(ls) for ls, _ in parts]

    def rebuild(leaves):
        out, i = [], 0
        for (_, fn), n in zip(parts, sizes):
            out.append(fn(leaves[i:i + n]))
            i += n
        return make(out)
    return [x for ls, _ in parts for x in ls], rebuild


def tree_leaves(tree, is_leaf: IsLeaf = None) -> List[Any]:
    return flatten(tree, is_leaf)[0]


def tree_map(fn: Callable, tree, *rest, is_leaf: IsLeaf = None):
    """``fn`` over the leaves of ``tree``, in leaf order, zipping in the
    trees ``rest`` along ``tree``'s structure: where ``tree`` has a leaf,
    their subtree is passed whole (so an int8 moment's ``Quantized`` meets
    its parameter)."""
    node = _node(tree, is_leaf)
    if node is None:
        return fn(tree, *rest)
    keys, kids, make = node
    return make([tree_map(fn, kid, *(r[k] for r in rest), is_leaf=is_leaf)
                 for k, kid in zip(keys, kids)])

"""Nested containers of tensors (the port's parameter and state trees).

The port keeps parameters as dicts of tensors, with each stack a list of
per-group dicts, and optimizer state as a NamedTuple of such trees.
These helpers walk them the way ``jax.tree_util`` walks the JAX
package's pytrees, so that sums over leaves and checkpoint keys come out
alike: dict keys in sorted order, list and tuple items in order, a
NamedTuple's fields in order; ``None`` is an empty subtree; anything
else (a tensor, a numpy array, a Python number) is a leaf.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple


def is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def children(tree) -> List[Tuple[Any, Any]]:
    """(key, child) pairs of an inner node, in JAX's order; [] for a
    leaf or None.  A NamedTuple's keys are its field names, a dict's its
    keys, a list's or tuple's the indices."""
    if isinstance(tree, dict):
        return [(k, tree[k]) for k in sorted(tree)]
    if is_namedtuple(tree):
        return list(zip(tree._fields, tree))
    if isinstance(tree, (list, tuple)):
        return list(enumerate(tree))
    return []


def is_leaf(tree) -> bool:
    return tree is not None and not isinstance(tree, (dict, list, tuple))


def leaves(tree) -> List[Any]:
    """Every leaf of ``tree``, in JAX's order."""
    if is_leaf(tree):
        return [tree]
    return [x for _, c in children(tree) for x in leaves(c)]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``, trees of the same structure), keeping the structure."""
    if tree is None:
        return None
    if is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    items = [tree_map(fn, v, *(r[i] for r in rest))
             for i, v in enumerate(tree)]
    if is_namedtuple(tree):
        return type(tree)(*items)
    return type(tree)(items)


def unflatten_like(tree, values: Iterator):
    """``tree``'s structure with its leaves replaced, in JAX's order, by
    the next items of ``values``."""
    if tree is None:
        return None
    if is_leaf(tree):
        return next(values)
    if isinstance(tree, dict):
        return {k: unflatten_like(tree[k], values) for k in sorted(tree)}
    items = [unflatten_like(v, values) for v in tree]
    if is_namedtuple(tree):
        return type(tree)(*items)
    return type(tree)(items)

"""Mapping, selection and flattening over nested NamedTuples of tensors."""

from __future__ import annotations

import torch


def tree_map(fn, tree):
    """`fn` applied to every tensor of nested NamedTuples (None leaves pass
    through)."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    return type(tree)(*(tree_map(fn, x) for x in tree))


def tree_where(cond: torch.Tensor, a, b):
    """Leaf-wise `torch.where(cond, a, b)` over nested NamedTuples of tensors
    (None leaves pass through).  `cond` covers the leading axes of every leaf
    and is broadcast over the trailing ones: a 0-d `cond` selects whole trees,
    an `(O,)` one selects per object."""
    if a is None:
        return None
    if isinstance(a, torch.Tensor):
        return torch.where(cond.reshape(cond.shape + (1,) * (a.ndim - cond.ndim)), a, b)
    return type(a)(*(tree_where(cond, x, y) for x, y in zip(a, b)))


def tree_flatten(tree) -> tuple:
    """(the tensors of nested tuples and NamedTuples in order, the tree's
    hashable spec): its types, each tensor's shape, dtype and device, and
    the other leaves (Python numbers, None) by value."""
    leaves: list = []

    def spec(x):
        if isinstance(x, torch.Tensor):
            leaves.append(x)
            return ("tensor", tuple(x.shape), x.dtype, x.device)
        if isinstance(x, tuple):
            return (type(x), tuple(spec(y) for y in x))
        return ("value", x)

    return leaves, spec(tree)


def tree_unflatten(spec, leaves):
    """The tree of a `tree_flatten` spec with its tensors taken in order from
    `leaves`."""
    it = iter(leaves)

    def build(s):
        if s[0] == "tensor":
            return next(it)
        if s[0] == "value":
            return s[1]
        kind, parts = s
        items = [build(p) for p in parts]
        return kind(*items) if hasattr(kind, "_fields") else kind(items)

    return build(spec)

"""Selection over nested NamedTuples of tensors."""

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

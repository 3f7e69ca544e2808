"""Checkpoint / resume for SLAM state.

The reference has no optimizer checkpointing — its nearest mechanism is the
offline replay txts.  Here any tree (the factor graph, the whole online
state) round-trips through a single .npz file keyed by tree path, so long
runs (KITTI sequences) can resume and results can be archived next to the
txt artifact dumps.

A tree is a nesting of NamedTuples (keyed by field name), tuples and lists
(keyed by position) and dicts (keyed by key) with tensors or arrays at the
leaves; None holds no leaf.  The key of a leaf is its path joined by "/",
e.g. "graph/cam_Tcw/quat": the scheme of the JAX implementation's
checkpoints, so a file written by either loads into the other's types.
"""

from __future__ import annotations

import pathlib

import numpy as np
import torch


def _leaves(tree, prefix=()):
    """(path, leaf) pairs of a tree, in field order."""
    if tree is None:
        return
    if hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    elif isinstance(tree, dict):
        items = sorted(tree.items())
    elif isinstance(tree, (tuple, list)):
        items = enumerate(tree)
    else:
        yield prefix, tree
        return
    for key, sub in items:
        yield from _leaves(sub, prefix + (str(key),))


def _rebuild(tree, values, prefix=()):
    """`tree`'s structure with the leaves taken from `values` by path."""
    if tree is None:
        return None
    if hasattr(tree, "_fields"):
        return type(tree)(
            *(_rebuild(sub, values, prefix + (k,)) for k, sub in zip(tree._fields, tree))
        )
    if isinstance(tree, dict):
        return {k: _rebuild(sub, values, prefix + (str(k),)) for k, sub in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(
            _rebuild(sub, values, prefix + (str(i),)) for i, sub in enumerate(tree)
        )
    return values["/".join(prefix)]


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _resolve(path) -> pathlib.Path:
    """np.savez appends '.npz' to names lacking the suffix; resolve to the
    filename that actually lands on disk so save/load stay symmetric (a
    '<name>.carry' companion is stored as '<name>.carry.npz')."""
    p = pathlib.Path(path)
    return p if p.suffix == ".npz" else p.with_name(p.name + ".npz")


def save_pytree(path, tree) -> None:
    """Save any tree of tensors to one .npz file (keys = tree paths)."""
    payload = {"/".join(p): _to_numpy(leaf) for p, leaf in _leaves(tree)}
    path = _resolve(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **payload)


def load_pytree(path, template):
    """Restore a tree saved by save_pytree into `template`'s structure.

    Shapes must match the template's leaves (strict — resuming into a
    different graph capacity is an error, not a silent truncation); every
    leaf takes the dtype of the template's leaf, and its device where that
    leaf is a tensor."""
    data = np.load(_resolve(path))
    values = {}
    for p, tmpl_leaf in _leaves(template):
        key = "/".join(p)
        if key not in data:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr = data[key]
        if isinstance(tmpl_leaf, torch.Tensor):
            if tuple(arr.shape) != tuple(tmpl_leaf.shape):
                raise ValueError(
                    f"checkpoint leaf {key!r} shape {arr.shape} != template {tuple(tmpl_leaf.shape)}"
                )
            values[key] = torch.as_tensor(arr).to(device=tmpl_leaf.device, dtype=tmpl_leaf.dtype)
        else:
            tmpl_arr = np.asarray(tmpl_leaf)
            if arr.shape != tmpl_arr.shape:
                raise ValueError(
                    f"checkpoint leaf {key!r} shape {arr.shape} != template {tmpl_arr.shape}"
                )
            values[key] = arr.astype(tmpl_arr.dtype)
    return _rebuild(template, values)

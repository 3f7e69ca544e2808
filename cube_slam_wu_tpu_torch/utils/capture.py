"""Replay of a function of tensor trees from one CUDA graph per signature.

`Captured(fn)` wraps a function whose arguments are nested tuples and
NamedTuples of tensors, Python numbers and None, and which makes no host read.
On a card its first call for a signature warms `fn` up on a side stream
(library handles, workspaces, the device constants of `core/`), captures it
on static copies of the arguments' tensors and keeps the graph with its
static inputs and outputs.  Every call copies the arguments' tensors into
the static ones and replays, so the host enqueues one graph instead of
`fn`'s kernels.  It hands back clones of the static outputs: the next replay
overwrites those buffers, and a caller keeps what it got.  On any other
device it is `fn` itself.

The signature is `utils.tree.tree_flatten`'s spec of the positional
arguments and the keyword options together: their structure, each tensor's
shape, dtype and device, and every other leaf (an option's number, a None)
by value.  A call that passes an option with another value, or tensors of
another shape, captures a graph of its own.

Users: `slam/point_ba.py::captured_lm` (the fixed-lag point LM) and
`slam/window.py::captured_absorb` (the prior's absorption of a departing
frame).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from cube_slam_wu_tpu_torch.utils.tree import tree_flatten, tree_map, tree_unflatten


class _Graph(NamedTuple):
    graph: "torch.cuda.CUDAGraph"
    inputs: list  # the static input tensors, in `tree_flatten` order
    outputs: object  # the static outputs, a tree like `fn`'s result


def signature(args: tuple, options: dict) -> tuple:
    """(the tensors of `args` and `options` in order, the hashable spec a
    graph is keyed by)."""
    return tree_flatten((tuple(args), tuple(sorted(options.items()))))


def _call(fn, spec, leaves):
    args, options = tree_unflatten(spec, leaves)
    return fn(*args, **dict(options))


class Captured:
    """`fn`, captured in one CUDA graph per signature and replayed (module
    docstring).  `captures` and `replays` count the calls that captured and
    those that replayed (every call on a card replays).

    Each signature's graph, with its static tensors and its private memory
    pool, is kept for the life of the `Captured` (for the module-level users,
    the process), so a process holds one graph per signature it ever used;
    the drivers run one signature per user (PERF.md §4).

    Capture needs the card to itself: no other thread may launch CUDA work
    while a first call for a signature runs."""

    def __init__(self, fn):
        self.fn = fn
        self.graphs: dict = {}
        self.captures = 0
        self.replays = 0

    def __call__(self, *args, **options):
        leaves, spec = signature(args, options)
        if leaves[0].device.type != "cuda":
            return self.fn(*args, **options)
        found = self.graphs.get(spec)
        if found is None:
            found = self.graphs[spec] = self._capture(spec, leaves)
            self.captures += 1
        for static, new in zip(found.inputs, leaves):
            static.copy_(new)
        found.graph.replay()
        self.replays += 1
        return tree_map(torch.clone, found.outputs)

    def _capture(self, spec, leaves: list) -> _Graph:
        """Warm `fn` up on a side stream, then capture it on static copies
        of `leaves`."""
        static = [t.clone() for t in leaves]
        with torch.cuda.device(leaves[0].device):
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                _call(self.fn, spec, static)
            torch.cuda.current_stream().wait_stream(side)
            cuda_graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(cuda_graph):
                outputs = _call(self.fn, spec, static)
        return _Graph(cuda_graph, static, outputs)

"""CUDA graphs for the port's two hot loops, with counters that count replays.

The JAX package compiles each calibration chunk and each explorer scoring
pass into one device program (``jax.jit``). Here the counterpart is a CUDA
graph (``torch.cuda.graph``): the work of one step, one rebin or one scoring
batch is captured once and replayed, so the host launches one graph where it
launched hundreds of eager operations.

A replay runs no Python, so Python-side counters that the captured code
raises (each kernel wrapper's ``.launches``, ``SpaceExplorer.last_bin_states``)
would stand still. ``Graph`` records how far the capture moved each counter,
takes that back (a capture launches nothing), and adds it on every replay, so
the counters keep counting what ran on the card.

Graphs are CUDA only: the same functions run eagerly on the CPU.
"""
from __future__ import annotations

import torch

__all__ = ["Counters", "Graph", "warm_up"]


class Counters:
    """Host-side counters, each an attribute of an object: ``slots`` are
    (holder, attribute name) pairs."""

    def __init__(self, slots):
        self.slots = list(slots)

    @classmethod
    def kernels(cls, *extra):
        """Every kernel wrapper's launch counter (ops.pose_raster.COUNTED),
        and the ``extra`` (holder, attribute) slots."""
        from ..ops import pose_raster, pose_raster_compact, tile_raster  # noqa: F401

        return cls([(fn, "launches") for fn in pose_raster.COUNTED] + list(extra))

    def read(self) -> list[int]:
        return [getattr(h, a) for h, a in self.slots]

    def add(self, delta) -> None:
        for (h, a), d in zip(self.slots, delta):
            if d:
                setattr(h, a, getattr(h, a) + d)

    def moved_by(self, fn) -> list[int]:
        """Run fn() -> how far it moved each counter, with the counters put
        back where they were."""
        before = self.read()
        fn()
        moved = [a - b for a, b in zip(self.read(), before)]
        self.add([-m for m in moved])
        return moved


def warm_up(fn, counters: Counters, device) -> None:
    """Run fn() once on a side stream, as PyTorch requires before a capture
    (it settles lazy initialisation: the kernels' libraries and grid sizes,
    autograd's device thread). Its launches do none of the caller's work and
    are taken back from the counters."""
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        counters.moved_by(fn)
    torch.cuda.current_stream(device).wait_stream(side)


class Graph:
    """fn() captured as one CUDA graph; ``replay()`` reruns its work on the
    tensors the capture read and wrote, and advances ``counters`` by what
    the capture moved them. ``pool``: the memory pool to share (another
    Graph's ``graph.pool()``). A failed capture raises."""

    def __init__(self, fn, counters: Counters, pool=None):
        self.graph = torch.cuda.CUDAGraph()
        self.counters = counters

        def capture():
            with torch.cuda.graph(self.graph, pool=pool):
                fn()

        self.moved = counters.moved_by(capture)

    def replay(self) -> None:
        self.graph.replay()
        self.counters.add(self.moved)

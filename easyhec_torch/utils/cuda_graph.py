"""CUDA graphs for the JAX package's compiled programs, with counters that
count replays.

The JAX package compiles each calibration chunk, each explorer scoring
pass, the global search's three stages and the LR finder's sweep into
device programs (``jax.jit``). Here the counterpart is a CUDA graph
(``torch.cuda.graph``): the work of one step or one batch is captured once
and replayed (``repeat``), so the host launches one graph where it
launched hundreds of eager operations. Where the JAX program branches on
the device (``lax.cond``), ``CondGraph`` captures ``if flag: body()`` then
``tail()`` as one graph with a conditional node: a replay runs the body only
when a device flag is set, with no host read. PyTorch 2.11 has no API for
the node (2.13 has ``CUDAGraph.begin_capture_to_if_node``), so
ops/csrc/graph_cond.cu assembles it around two PyTorch captures.

A replay runs no Python, so Python-side counters that the captured code
raises (each kernel wrapper's ``.launches``, ``SpaceExplorer.last_bin_states``)
would stand still. A graph records how far the capture moved each counter,
takes that back (a capture launches nothing), and adds it on every replay, so
the counters keep counting what ran on the card. A conditional body's
movement is kept apart and added once per taken branch (``CondGraph.taken``),
from a count the caller reads off the device.

Each warm-up, capture and instantiation is a span of utils.profiling:
``graph.warm_up``, ``graph.capture`` (a ``torch.cuda.graph`` block, with the
gc.collect and empty_cache torch runs at its start and the instantiation at
its end) and ``graph.instantiate`` (the conditional graph's assembly).

Where graphs are made is ``captures(device)`` (yes on CUDA) and what each
caller reads off its inputs (a renderer's route, a mesh's backend, a hook);
``capture`` makes every graph. Elsewhere the same functions run eagerly.
"""
from __future__ import annotations

import ctypes
import weakref

import torch

from .profiling import span

__all__ = ["CondGraph", "Counters", "Graph", "capture", "captures", "repeat", "warm_up"]


class Counters:
    """Host-side counters, each an attribute of an object: ``slots`` are
    (holder, attribute name) pairs."""

    def __init__(self, slots):
        self.slots = list(slots)

    @classmethod
    def kernels(cls, *extra):
        """Every kernel wrapper's launch counter (ops.pose_raster.COUNTED),
        and the ``extra`` (holder, attribute) slots."""
        from ..ops import binning, pose_raster, pose_raster_compact, step, tile_raster  # noqa: F401

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
    with span("graph.warm_up"):
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            counters.moved_by(fn)
        torch.cuda.current_stream(device).wait_stream(side)


def _captured(fn, graph, pool=None) -> None:
    """fn() captured into graph (torch.cuda.graph, in ``pool``) inside a
    ``graph.capture`` span."""
    with span("graph.capture"), torch.cuda.graph(graph, pool=pool):
        fn()


class Graph:
    """fn() captured as one CUDA graph; ``replay()`` reruns its work on the
    tensors the capture read and wrote, and advances ``counters`` by what
    the capture moved them. ``pool``: the memory pool to share (another
    Graph's ``graph.pool()``). A failed capture raises."""

    def __init__(self, fn, counters: Counters, pool=None):
        self.graph = torch.cuda.CUDAGraph()
        self.counters = counters
        self.moved = counters.moved_by(lambda: _captured(fn, self.graph, pool))

    def replay(self) -> None:
        self.graph.replay()
        self.counters.add(self.moved)


def captures(device) -> bool:
    """Whether work on ``device`` runs as CUDA graphs: yes on CUDA. Callers
    add the facts of their inputs that rule a graph out; the card's eager
    comparisons patch this function alone."""
    return torch.device(device).type == "cuda"


def capture(fn, bufs: dict, *extra, pool=None, cond=None) -> Graph | CondGraph:
    """fn(bufs) as a CUDA graph, fn reading and writing only bufs (a dict of
    tensors, or of lists of tensors, to which fn may add) and what it
    closes over: warmed up once on copies of bufs, then captured on bufs,
    counting every kernel wrapper's launches and the ``extra`` (holder,
    attribute) slots. -> a Graph in ``pool``; with ``cond=(flag, body)``,
    CondGraph(bufs[flag], body(bufs), fn(bufs)), the body warmed up first."""
    counters = Counters.kernels(*extra)
    flag, body = cond or (None, None)
    copies = {k: v.clone() if torch.is_tensor(v) else [t.clone() for t in v]
              for k, v in bufs.items()}

    def once():
        if body is not None:
            body(copies)
        fn(copies)

    dev = next(iter(bufs.values()))
    dev = (dev if torch.is_tensor(dev) else dev[0]).device
    with torch.cuda.device(dev):
        warm_up(once, counters, dev)
        del copies
        if body is None:
            return Graph(lambda: fn(bufs), counters, pool)
        return CondGraph(bufs[flag], lambda: body(bufs), lambda: fn(bufs), counters)


def repeat(fn, bufs: dict, n: int, captured: bool, *extra, pool=None) -> Graph | None:
    """fn(bufs) n times: where ``captured`` (the caller's reading of
    ``captures`` and of its inputs), one graph (``capture``) replayed n
    times, returned while the caller shares its pool; else eagerly, None."""
    if not captured:
        for _ in range(n):
            fn(bufs)
        return None
    graph = capture(fn, bufs, *extra, pool=pool)
    for _ in range(n):
        graph.replay()
    return graph


def _versions() -> str:
    return f"torch {torch.__version__}, CUDA {torch.version.cuda}"


def _lib():
    """ops/csrc/graph_cond.cu: the conditional node's graph assembly."""
    from ..ops import _build

    lib = _build.load("graph_cond")
    if not getattr(lib, "typed", False):
        vp, rc = ctypes.c_void_p, ctypes.c_int
        lib.cond_graph_build.argtypes = [vp, vp, vp, ctypes.POINTER(vp), ctypes.POINTER(vp)]
        lib.cond_graph_launch.argtypes = [vp, vp]
        lib.cond_graph_destroy.argtypes = [vp, vp]
        for f in (lib.cond_graph_build, lib.cond_graph_launch, lib.cond_graph_destroy):
            f.restype = rc
        lib.cond_error_string.argtypes = [rc]
        lib.cond_error_string.restype = ctypes.c_char_p
        lib.typed = True
    return lib


def _check(rc: int, what: str) -> None:
    if rc:
        err = _lib().cond_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({err}); {_versions()}; a conditional "
                           "graph node needs CUDA 12.4 or later")


class _CondExec:
    """One executable CUDA graph: a one-thread kernel that sets an IF node's
    condition from the device bool ``flag``, the IF node around ``body``'s
    graph, then ``tail``'s graph (ops/csrc/graph_cond.cu). body and tail
    are PyTorch captures kept as raw graphs; they are cloned in, and the
    caller keeps them (and so their memory pool) alive. ``launches``
    counts the launches of every such graph, as the kernel wrappers count
    theirs."""

    launches = 0

    def __init__(self, flag: torch.Tensor, body, tail):
        lib = _lib()
        x, g = ctypes.c_void_p(), ctypes.c_void_p()
        with span("graph.instantiate"):
            rc = lib.cond_graph_build(flag.data_ptr(), body.raw_cuda_graph(),
                                      tail.raw_cuda_graph(), ctypes.byref(x), ctypes.byref(g))
        _check(rc, "building the graph with a conditional node")
        self.exec = x
        weakref.finalize(self, lib.cond_graph_destroy, x, g)

    def launch(self) -> None:
        _check(_lib().cond_graph_launch(self.exec, torch.cuda.current_stream().cuda_stream),
               "cudaGraphLaunch")
        _CondExec.launches += 1


def _raw_graph():
    """A PyTorch CUDA graph that keeps its cudaGraph_t (``raw_cuda_graph``)."""
    try:
        return torch.cuda.CUDAGraph(keep_graph=True)
    except TypeError as e:
        raise RuntimeError(f"{_versions()}: torch.cuda.CUDAGraph has no keep_graph, which the "
                           "conditional graph node needs") from e


class CondGraph:
    """``if flag: body()`` then ``tail()`` as one executable CUDA graph
    (``_CondExec``), the counterpart of a ``lax.cond`` at the head of a
    compiled step. ``flag`` is a 0-d bool tensor on the card, tested there
    at each replay. body and tail are captured by PyTorch, in that order
    and in one memory pool, so the pool's sharing follows the replay order:
    a skipped body leaves its outputs as its last run wrote them, and the
    tail reads them. A replay adds the tail's counter movement (``moved``);
    ``taken(n)`` adds the body's (``body_moved``) n times. Raises, naming
    the versions, where this torch or the driver cannot make the node."""

    def __init__(self, flag: torch.Tensor, body, tail, counters: Counters):
        self.counters = counters
        body_graph, tail_graph = _raw_graph(), _raw_graph()
        self.body_moved = counters.moved_by(lambda: _captured(body, body_graph))
        self.moved = counters.moved_by(lambda: _captured(tail, tail_graph, body_graph.pool()))
        self.exec = _CondExec(flag, body_graph, tail_graph)
        self.parts = (body_graph, tail_graph)  # the exec's children and their pool

    def replay(self) -> None:
        self.exec.launch()
        self.counters.add(self.moved)

    def taken(self, n: int) -> None:
        """Count n runs of the body (the caller's count of the taken
        branches, read off the device after the replays)."""
        if n:
            self.counters.add([m * n for m in self.body_moved])

"""Device-resident solver loops: one step body, two drivers.

The JAX package runs an ADMM chunk with its CG, and the ALM inner pass, as
``lax.while_loop`` programs on the device and reads one stats blob a chunk
(``solver/admm.py`` ``_chunk_step`` / ``parse_blob``, ``solver/alm.py``
``_inner_pass``).  The port writes each loop once, as a body over device
tensors that makes no host read, and states its control through a *flow*:

* ``flow.if_(pred, fn)`` runs ``fn()`` when the 0-dim bool tensor ``pred``
  holds;
* ``flow.while_(cond, fn)`` runs ``fn()`` while ``cond()`` holds.

Three flows run a body:

* :class:`HostFlow`, the CPU driver: it reads each predicate on the host,
  where a read is free, so a CPU run is a Python loop over the same
  arithmetic as the graph's;
* :class:`WarmFlow`: every body once, unconditionally, on the streams a
  capture uses (the capture's warm-up: libraries loaded, cuBLAS handles and
  workspaces made outside the graph's memory);
* :class:`CaptureFlow`: the body captured into a CUDA graph whose IF and
  WHILE conditional nodes (``csrc/graph_cond.cu``, CUDA 12.4 or later) take
  the decisions on the card.

:class:`DeviceGraph` warms a body up, captures it once and replays it.  The
graph's allocations come from a private pool of PyTorch's caching allocator
(every allocation of the capturing thread, on the capture stream and on the
body streams).  A kernel's own counter sees a launch inside a graph once, at
capture; the graph keeps each conditional body's launches and counts the
body's runs on the device, and :meth:`DeviceGraph.account` adds runs x
launches to the kernels' counters after each replay, so that
``kernels.counts()`` holds the launches that ran.  A failed capture, node or
replay raises: nothing falls back to an eager loop.

No graph is captured or replayed while ``torch.profiler`` is active
(:func:`refuse_under_profiler`).  Under CUPTI's kernel tracing, a graph
with conditional nodes that was instantiated after CUPTI had started
faults with an illegal address on a replay that runs many kernels (with
CUDA 12.8 / 12.9 and driver 580 on an H100;
``scripts/cond_graph_cupti.py`` reproduces it with no solver code), and a
graph instantiated before CUPTI started replays unseen by it.  Time the
replays with CUDA events outside the profiler.
"""

from __future__ import annotations

import ctypes
import time
import weakref
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..ops import kernels as K

MAX_BODIES = 64          # conditional bodies one graph may count
N_STREAMS = 6            # the capture stream and five levels of bodies

_P = ctypes.c_void_p
_U64 = ctypes.c_ulonglong
_LIB: Dict[str, ctypes.CDLL] = {}
_STREAMS: Dict[int, List[torch.cuda.Stream]] = {}


def _lib() -> ctypes.CDLL:
    """``csrc/graph_cond.cu``, built with the kernels and bound once."""
    if "lib" not in _LIB:
        K.GRAPH_COND.fn()
        lib = K.GRAPH_COND._lib
        lib.ltr_cond_begin.argtypes = [_P, _P, _P, ctypes.c_int,
                                       ctypes.POINTER(_U64)]
        lib.ltr_cond_set.argtypes = [_U64, _P, _P]
        lib.ltr_cond_nodes.argtypes = [_P, ctypes.POINTER(_U64)]
        lib.ltr_cond_end.argtypes = [_P]
        lib.ltr_capture_begin.argtypes = [_P]
        lib.ltr_capture_end.argtypes = [_P, ctypes.POINTER(_P),
                                        ctypes.POINTER(_U64)]
        lib.ltr_graph_instantiate.argtypes = [_P, ctypes.POINTER(_P)]
        lib.ltr_graph_launch.argtypes = [_P, _P]
        lib.ltr_graph_destroy.argtypes = [_P, _P]
        version = ctypes.c_int(0)
        _check(K.GRAPH_COND.fn()(ctypes.byref(version)), "runtime version")
        if version.value < 12040:
            raise RuntimeError(f"CUDA runtime {version.value}: conditional "
                               "graph nodes need 12.4 or later")
        _LIB["lib"] = lib
    return _LIB["lib"]


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA graph {what} failed: cudaError {err}")


def streams(dev: torch.device) -> List[torch.cuda.Stream]:
    """The capture stream and the body streams of ``dev``, made once: a
    body nested d deep captures on stream d."""
    if dev.index not in _STREAMS:
        _STREAMS[dev.index] = [torch.cuda.Stream(dev)
                               for _ in range(N_STREAMS)]
    return _STREAMS[dev.index]


def refuse_under_profiler(what: str) -> None:
    """Raises while a ``torch.profiler`` session is active (see the module's
    docstring)."""
    if torch._C._autograd._profiler_enabled():
        raise RuntimeError(
            f"{what}: a CUDA graph with conditional nodes is not captured or "
            "replayed while torch.profiler is active: under CUPTI's kernel "
            "tracing such a graph faults (an illegal address) once it was "
            "instantiated after CUPTI started, and is not seen by it "
            "otherwise (scripts/cond_graph_cupti.py). Time the replays with "
            "CUDA events outside the profiler.")


class HostFlow:
    """The CPU driver: each predicate read on the host."""

    @staticmethod
    def if_(pred: torch.Tensor, fn: Callable[[], None]) -> None:
        if bool(pred):
            fn()

    @staticmethod
    def while_(cond: Callable[[], torch.Tensor],
               fn: Callable[[], None]) -> None:
        while bool(cond()):
            fn()


class WarmFlow:
    """Every body once, unconditionally, each on the stream its capture
    gives it (a capture's warm-up)."""

    def __init__(self, dev: torch.device):
        self.streams = streams(dev)
        self.depth = 0

    def _run(self, fn: Callable[[], None]) -> None:
        parent = torch.cuda.current_stream()
        body = self.streams[self.depth + 1]
        body.wait_stream(parent)
        self.depth += 1
        try:
            with torch.cuda.stream(body):
                fn()
        finally:
            self.depth -= 1
        parent.wait_stream(body)

    def if_(self, pred, fn) -> None:
        self._run(fn)

    def while_(self, cond, fn) -> None:
        cond()
        self._run(fn)
        cond()


def _kernel_counts() -> Dict[str, Tuple[int, int, int]]:
    return {k.name: (k.launches, k.launches_f32, k.folds)
            for k in K.KERNELS.values()}


def _minus(a, b):
    return {n: tuple(x - y for x, y in zip(a[n], b[n])) for n in a}


def _restore(snap) -> None:
    for name, (launches, f32, folds) in snap.items():
        k = K.KERNELS[name]
        k.launches, k.launches_f32, k.folds = launches, f32, folds


class _Frame:
    """One body (or the top level) being captured: its launches so far."""

    def __init__(self, index: int):
        self.index = index
        self.start = _kernel_counts()
        self.children = {n: (0, 0, 0) for n in self.start}

    def close(self):
        incl = _minus(_kernel_counts(), self.start)
        return incl, _minus(incl, self.children)


class CaptureFlow:
    """Captures a body's decisions as conditional nodes of the graph that
    the capture stream records."""

    def __init__(self, graph: "DeviceGraph"):
        self.graph = graph
        self.streams = streams(graph.dev)
        self.lib = _lib()
        self.depth = 0
        self.frames = [_Frame(-1)]

    def _open(self, pred: torch.Tensor, kind: int):
        if pred.dtype != torch.bool or pred.dim() != 0:
            raise ValueError("a conditional node takes a 0-dim bool tensor")
        if self.depth + 1 >= len(self.streams):
            raise RuntimeError("conditional bodies nested too deep")
        parent = torch.cuda.current_stream()
        body = self.streams[self.depth + 1]
        handle = _U64(0)
        _check(self.lib.ltr_cond_begin(_P(parent.cuda_stream),
                                       _P(body.cuda_stream),
                                       _P(pred.data_ptr()), kind,
                                       ctypes.byref(handle)),
               "conditional node")
        index = len(self.graph.bodies)
        if index >= MAX_BODIES:
            raise RuntimeError(f"more than {MAX_BODIES} conditional bodies")
        self.graph.bodies.append(None)
        self.frames.append(_Frame(index))
        self.depth += 1
        return handle.value, body

    def _close(self, body: torch.cuda.Stream) -> None:
        frame = self.frames.pop()
        incl, excl = frame.close()
        if any(v != (0, 0, 0) for v in excl.values()):
            # count this body's runs (only bodies that launch kernels)
            self.graph.runs[frame.index].add_(1)
        nodes = _U64(0)
        _check(self.lib.ltr_cond_nodes(_P(body.cuda_stream),
                                       ctypes.byref(nodes)), "node count")
        self.graph.bodies[frame.index] = excl
        self.graph.nodes += nodes.value
        parent = self.frames[-1]
        parent.children = {n: tuple(a + b for a, b in
                                    zip(parent.children[n], incl[n]))
                           for n in incl}
        self.depth -= 1

    def if_(self, pred: torch.Tensor, fn: Callable[[], None]) -> None:
        _, body = self._open(pred, 0)
        with torch.cuda.stream(body):
            fn()
            self._close(body)
        _check(self.lib.ltr_cond_end(_P(body.cuda_stream)), "IF body")

    def while_(self, cond: Callable[[], torch.Tensor],
               fn: Callable[[], None]) -> None:
        handle, body = self._open(cond(), 1)
        with torch.cuda.stream(body):
            fn()
            again = cond()
            self._close(body)
            _check(self.lib.ltr_cond_set(handle, _P(again.data_ptr()),
                                         _P(body.cuda_stream)), "WHILE set")
        _check(self.lib.ltr_cond_end(_P(body.cuda_stream)), "WHILE body")


_CAPTURING = [0]         # captures in progress in this process
_PENDING: List[tuple] = []


def _destroy(lib, graph, exec_, dev_index, pool) -> None:
    """Frees a collected graph and its pool; deferred while a capture is in
    progress (a collection can run inside one), done at the next graph's
    capture or launch."""
    _PENDING.append((lib, graph, exec_, dev_index, pool))
    if not _CAPTURING[0]:
        _flush()


def _flush() -> None:
    release = getattr(torch._C, "_cuda_releasePool", None)
    while _PENDING:
        lib, graph, exec_, dev_index, pool = _PENDING.pop()
        torch.cuda.synchronize(dev_index)
        lib.ltr_graph_destroy(graph, exec_)
        if release is not None:
            release(dev_index, pool)


class DeviceGraph:
    """``body(flow)`` warmed up on ``warm_state``'s copies, captured once on
    ``dev`` and replayed on the current stream.

    ``body(flow, state)`` must touch only ``state`` (its static tensors,
    written in place) and the problem's operators.  ``warm_state()`` gives a
    throwaway state of the same shapes for the warm-up run.  ``nodes`` is
    the node count of the graph and its bodies, ``instantiate_ms`` the
    instantiation's host time; ``runs`` (MAX_BODIES,) counts each body's
    runs on the device since the last :meth:`launch`."""

    def __init__(self, name: str, dev: torch.device, body, state,
                 warm_state: Callable):
        refuse_under_profiler(f"capture of {name}")
        self.name = name
        self.dev = dev
        self.bodies: List[Optional[dict]] = []
        self.nodes = 0
        self.runs = torch.zeros(MAX_BODIES, dtype=torch.int64, device=dev)
        lib = _lib()
        _flush()
        snap = _kernel_counts()
        cur = torch.cuda.current_stream(dev)
        cap = streams(dev)[0]
        # warm-up, on the capture's own streams
        cap.wait_stream(cur)
        with torch.cuda.stream(cap):
            body(WarmFlow(dev), warm_state())
        torch.cuda.synchronize(dev)
        _restore(snap)
        pool = torch.cuda.graph_pool_handle()
        flow = CaptureFlow(self)
        graph, top = _P(), _U64(0)
        err = None
        torch._C._cuda_beginAllocateCurrentThreadToPool(dev.index, pool)
        _CAPTURING[0] += 1
        try:
            with torch.cuda.stream(cap):
                _check(lib.ltr_capture_begin(_P(cap.cuda_stream)),
                       "capture")
                try:
                    body(flow, state)
                    # the top level's own launches, run once a replay
                    self.top = flow.frames[0].close()[1]
                finally:
                    err = lib.ltr_capture_end(_P(cap.cuda_stream),
                                              ctypes.byref(graph),
                                              ctypes.byref(top))
        finally:
            torch._C._cuda_endAllocateToPool(dev.index, pool)
            _CAPTURING[0] -= 1
            _restore(snap)
        _check(err, f"capture of {name}")
        self.nodes += top.value
        exec_ = _P()
        t = time.perf_counter()
        _check(lib.ltr_graph_instantiate(graph, ctypes.byref(exec_)),
               f"instantiation of {name}")
        self.instantiate_ms = (time.perf_counter() - t) * 1e3
        self._exec = exec_
        self._lib = lib
        self._finalizer = weakref.finalize(self, _destroy, lib, graph, exec_,
                                           dev.index, pool)
        self._finalizer.atexit = False
        self.replays = 0

    def launch(self) -> None:
        """One replay on the current stream (the body runs counted anew)."""
        refuse_under_profiler(f"replay of {self.name}")
        if _PENDING:
            _flush()
        self.runs.zero_()
        _check(self._lib.ltr_graph_launch(
            self._exec, _P(torch.cuda.current_stream(self.dev).cuda_stream)),
            f"replay of {self.name}")
        self.replays += 1

    def account(self, runs: Sequence[float]) -> None:
        """Adds one replay's launches to the kernels' counters, from the
        body runs read after it (``runs``: the first len(bodies) entries
        of :attr:`runs`)."""
        totals = dict(self.top)
        for excl, n in zip(self.bodies, runs):
            n = int(n)
            if excl and n:
                totals = {k: tuple(a + n * b for a, b in zip(totals[k], v))
                          for k, v in excl.items()}
        for name, (launches, f32, folds) in totals.items():
            k = K.KERNELS[name]
            k.launches += launches
            k.launches_f32 += f32
            k.folds += folds

    def describe(self) -> Tuple[str, int, float]:
        return (self.name, self.nodes, self.instantiate_ms)

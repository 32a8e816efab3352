"""The port's ``while_loop`` and the CUDA-graph programs the train step is
replayed from.

JAX runs the tracer's loops on the device (``lax.while_loop``) inside one
jitted step.  The port's counterpart keeps each loop's state in a fixed set
of tensors that a body updates in place, and a predicate the body computes
on the device:

* ``while_loop(cond, body, state, max_iters)`` runs ``body(state, i)`` while
  ``i < max_iters`` and ``cond(state)`` (a one-element bool tensor) holds,
  reading the predicate on the host once an iteration, exactly as a plain
  Python loop would;
* inside ``capture_program`` (the graphed train step, ``train/trainer.py``)
  it instead ends the CUDA graph being captured, captures the body once as
  a graph of its own (one graph per iteration index with ``per_iter``, for a
  body whose work depends on it), and starts the next graph.  The step is so
  cut into straight-line graphs at its predicate reads; ``Program.replay``
  replays them in order and runs each loop while its predicate, read once
  an iteration, holds.  A loop inside a body (the line search in the march)
  nests.

Every graph of a program is captured into one memory pool on one side
stream.  A tensor alive at the end of a capture keeps its address for every
replay, so what a graph reads from an earlier one must stay referenced (the
loop state does: it is allocated before the loop and written in place).

What a captured graph launched of the fused SDF-MLP kernels is taken out of
``ops.fused_mlp.launch_counts`` when its capture ends (a capture runs
nothing) and added back on each of its replays, per variant and per
cluster size, so the counts mean launches under replay as they do in an
eager run.
"""

from __future__ import annotations

import contextlib
import gc
from typing import Callable, Dict, Iterator, List, Optional

import torch

from ..ops import fused_mlp as fm

_recorder: Optional["_Recorder"] = None
_side_streams: Dict[int, "torch.cuda.Stream"] = {}


def side_stream(device: torch.device) -> "torch.cuda.Stream":
    """The one side stream of ``device`` that graphed steps warm up and
    capture on.  One for all: autograd keeps a parameter's gradient
    accumulator on the stream it first ran on, and cuBLAS keeps a workspace
    for every stream it ran on."""
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    if index not in _side_streams:
        _side_streams[index] = torch.cuda.Stream(index)
    return _side_streams[index]


def while_loop(cond: Callable[[Dict[str, torch.Tensor]], torch.Tensor],
               body: Callable[[Dict[str, torch.Tensor], int], None],
               state: Dict[str, torch.Tensor], max_iters: int,
               per_iter: bool = False) -> Dict[str, torch.Tensor]:
    """Run ``body(state, i)`` for i = 0, 1, ... while ``i < max_iters`` and
    ``cond(state)`` holds; the predicate is computed (and read) only when
    ``i < max_iters``.  ``body`` updates ``state``'s tensors in place.
    ``per_iter`` says that the body's work depends on ``i`` (a captured
    program then holds one body per index).  Returns ``state``."""
    if _recorder is None:
        i = 0
        while i < max_iters and bool(cond(state)):
            body(state, i)
            i += 1
    else:
        _recorder.loop(cond, body, state, max_iters, per_iter)
    return state


class _Graph:
    """One captured graph and the fused-kernel launches it makes."""

    def __init__(self, graph: "torch.cuda.CUDAGraph", launches: Dict[str, Dict[str, int]]):
        self.graph, self.launches = graph, launches

    def replay(self) -> None:
        self.graph.replay()
        fm.add_launch_counts(self.launches)


class _Loop:
    """A loop of a program: the predicate computed before it, its bodies
    (one, or one per index) with the predicate each computes last."""

    def __init__(self, pred0: torch.Tensor, bodies: List["Program"],
                 preds: List[torch.Tensor], max_iters: int):
        self.pred0, self.bodies, self.preds, self.max_iters = pred0, bodies, preds, max_iters

    def replay(self) -> None:
        i, pred = 0, self.pred0
        while i < self.max_iters and bool(pred):
            j = min(i, len(self.bodies) - 1)
            self.bodies[j].replay()
            pred = self.preds[j]
            i += 1


class Program:
    """Captured graphs and loops, replayed in order."""

    def __init__(self):
        self.items: List = []

    def replay(self) -> None:
        for item in self.items:
            item.replay()

    def graphs(self) -> int:
        """The number of captured graphs, loop bodies included."""
        return sum(1 if isinstance(it, _Graph) else sum(b.graphs() for b in it.bodies)
                   for it in self.items)


class _Recorder:
    def __init__(self, pool, stream: "torch.cuda.Stream"):
        self.pool, self.stream = pool, stream
        self.programs: List[Program] = [Program()]
        self.ctx = None

    def begin(self) -> None:
        self.graph = torch.cuda.CUDAGraph()
        self.before = fm.snapshot_launch_counts()
        self.ctx = torch.cuda.graph(self.graph, pool=self.pool, stream=self.stream)
        self.ctx.__enter__()

    def end(self) -> None:
        ctx, self.ctx = self.ctx, None
        ctx.__exit__(None, None, None)
        launched = fm.launch_counts_since(self.before)
        fm.add_launch_counts(launched, sign=-1)   # the capture ran nothing
        self.programs[-1].items.append(_Graph(self.graph, launched))

    def abort(self) -> None:
        """End a capture that an exception cut short (its error is raised)."""
        if self.ctx is not None:
            ctx, self.ctx = self.ctx, None
            with contextlib.suppress(Exception):
                ctx.__exit__(None, None, None)
            fm.add_launch_counts(fm.launch_counts_since(self.before), sign=-1)

    def loop(self, cond, body, state, max_iters: int, per_iter: bool) -> None:
        pred0 = cond(state)   # the last work of the graph before the loop
        self.end()
        bodies, preds = [], []
        for i in range(max_iters if per_iter else min(max_iters, 1)):
            self.programs.append(Program())
            self.begin()
            body(state, i)
            preds.append(cond(state))
            self.end()
            bodies.append(self.programs.pop())
        self.programs[-1].items.append(_Loop(pred0, bodies, preds, max_iters))
        self.begin()


@contextlib.contextmanager
def capture_program(pool=None, stream: Optional["torch.cuda.Stream"] = None) -> Iterator[Program]:
    """Capture the CUDA work of the ``with`` block as a ``Program``, cut at
    every ``while_loop``.  Nothing runs: replay the program to run it.  A
    host read or any other operation that cannot be captured raises; there
    is no eager fallback."""
    global _recorder
    if _recorder is not None:
        raise RuntimeError("capture_program does not nest")
    rec = _Recorder(torch.cuda.graph_pool_handle() if pool is None else pool,
                    torch.cuda.Stream() if stream is None else stream)
    # a CUDA graph that the cyclic collector frees during a capture would
    # break it: collect before, and not during
    gc.collect()
    gc_was_enabled = gc.isenabled()
    gc.disable()
    _recorder = rec
    try:
        rec.begin()
        yield rec.programs[0]
        rec.end()
    except BaseException:
        rec.abort()
        raise
    finally:
        _recorder = None
        if gc_was_enabled:
            gc.enable()

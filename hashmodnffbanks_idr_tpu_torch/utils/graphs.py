"""The port's ``while_loop`` and the one CUDA graph the train step is
launched as.

JAX runs the tracer's loops on the device (``lax.while_loop``) inside one
jitted step.  The port's counterpart keeps each loop's state in a fixed set
of tensors that a body updates in place, a predicate the body computes on
the device, and the iteration counter on the device too (JAX's ``k`` and
``it`` in the carry):

* ``while_loop(cond, body, state, max_iters, counter)`` runs ``body(state,
  i)`` while ``i < max_iters`` and ``cond(state)`` (a one-element bool
  tensor) holds, reading the predicate on the host once an iteration,
  exactly as a plain Python loop would;
* inside ``capture_program`` (the graphed train step, ``train/trainer.py``)
  it instead ends the CUDA graph being captured, captures the body once as
  a graph of its own, and starts the next graph: the step is recorded as a
  tree of straight-line segments and loops (a loop inside a body, the line
  search in the march, nests).  ``Program.instantiate`` assembles the tree
  into one executable graph (``ops/graph_loops.py``): each segment a
  child-graph node, each loop a conditional while-node whose condition,
  ``pred and counter < max_iters``, the ``set_while`` kernel sets on the
  device before the node and at the end of every body.  ``Program.replay``
  is one launch, with no host read inside.

Every graph of a program is captured into one memory pool on one side
stream.  A tensor alive at the end of a capture keeps its address for every
launch, so what a graph reads from an earlier one must stay referenced (the
loop state does: it is allocated before the loop and written in place).  A
body runs several times before the segment after its loop, in the order
the graphs were captured in, so what it frees is reused only by graphs that
run after it.

What a captured segment launched of the fused SDF-MLP kernels is taken out
of ``ops.fused_mlp.launch_counts`` when its capture ends (a capture runs
nothing).  Each launch of a program adds its top-level segments' launches
on the host; a loop's body runs as many times as the device decides, so
each loop totals its iterations on the device, and ``fold_device_counts``
adds total x the body's launches (per variant, points and cluster size)
with one host read, before ``fused_mlp``'s counts are read.
``loop_iterations`` holds the iterations by loop (its body's name): the
eager loop counts them on the host, a program's are folded in from the
device totals.

With tracing on (``utils/profiling.py:set_tracing``) the same read folds
the spans' device totals, and a program instantiated then counts each
captured segment's nodes by type (the span stamps left out) and its
``set_while`` nodes; ``node_counts`` holds the nodes run, folded as the
launches are: a launch adds its top-level segments' nodes, a loop's
iterations its body's.
"""

from __future__ import annotations

import contextlib
import gc
import weakref
from typing import Callable, Dict, Iterator, List, Optional

import torch

from ..ops import fused_mlp as fm
from ..ops import graph_loops
from . import profiling

_recorder: Optional["_Recorder"] = None
_side_streams: Dict[int, "torch.cuda.Stream"] = {}
# the instantiated programs whose loops' device totals are folded in
_programs: "weakref.WeakSet[Program]" = weakref.WeakSet()
# iterations of each loop, by its body's name
loop_iterations: Dict[str, int] = {}
# nodes the instantiated programs ran, by type (counted with tracing on)
node_counts: Dict[str, int] = {k: 0 for k in graph_loops.NODE_TYPES}


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
               body: Callable[[Dict[str, torch.Tensor], Optional[int]], None],
               state: Dict[str, torch.Tensor], max_iters: int,
               counter: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """Run ``body(state, i)`` for i = 0, 1, ... while ``i < max_iters`` and
    ``cond(state)`` holds; the predicate is computed (and read) only when
    ``i < max_iters``.  ``body`` updates ``state``'s tensors in place.  The
    loop's counter, a 0-d int64 tensor on the state's device, is set to 0
    before the loop and advanced after each body; ``counter`` names the
    state entry that holds it, for a body that reads it (the line search's
    ``k``).  A captured body is passed ``i = None``: its work must not
    depend on the host's index.  Returns ``state``."""
    if max_iters <= 0:
        return state
    i_dev = torch.zeros((), dtype=torch.int64, device=next(iter(state.values())).device)
    if counter:
        state[counter] = i_dev
    if _recorder is not None:
        _recorder.loop(cond, body, state, max_iters, i_dev)
        return state
    i = 0
    while i < max_iters and bool(cond(state)):
        body(state, i)
        i_dev.add_(1)
        i += 1
    loop_iterations[body.__name__] = loop_iterations.get(body.__name__, 0) + i
    return state


class _Segment:
    """One captured straight-line graph, the fused-kernel launches it
    recorded and the span stamps among its kernel nodes; ``nodes``, its
    nodes by type without the stamps, is set when a program is instantiated
    with tracing on."""

    def __init__(self, graph: "torch.cuda.CUDAGraph", launches: Dict[str, Dict[str, int]],
                 stamps: int = 0):
        self.graph, self.launches, self.stamps = graph, launches, stamps
        self.nodes: Optional[Dict[str, int]] = None


class _Loop:
    """A loop of a program: the predicate and counter that ``set_while``
    reads (computed before the loop and at the end of every body), its
    cap, its body, and its iterations totalled on the device (``total``;
    ``folded`` of them already counted on the host); ``launched``, the
    fused-kernel launches of one iteration, is set when the program is
    instantiated, and ``nodes``, an iteration's nodes, when it is
    instantiated with tracing on."""

    def __init__(self, name: str, pred: torch.Tensor, counter: torch.Tensor, max_iters: int,
                 body: "Program"):
        self.name, self.pred, self.counter, self.max_iters, self.body = (
            name, pred, counter, max_iters, body)
        self.total = torch.zeros((), dtype=torch.int64, device=pred.device)
        self.folded = 0
        self.nodes: Optional[Dict[str, int]] = None


def _sum_nodes(program: "Program") -> Dict[str, int]:
    """The nodes a run of ``program``'s own items adds (not the bodies of its
    loops): its segments' nodes, and one ``set_while`` kernel node before
    each of its loops."""
    out = {k: 0 for k in graph_loops.NODE_TYPES}
    for item in program.items:
        for k, v in (item.nodes.items() if isinstance(item, _Segment) else [("kernel", 1)]):
            out[k] += v
    return out


def _sum_launches(program: "Program") -> Dict[str, Dict[str, int]]:
    """The fused-kernel launches of ``program``'s own segments (not of the
    bodies of its loops)."""
    out = {name: {k: 0 for k in c} for name, c in fm.launch_counts.items()}
    for item in program.items:
        if isinstance(item, _Segment):
            for name, c in item.launches.items():
                for k, v in c.items():
                    out[name][k] += v
    return out


class Program:
    """Captured segments and loops, in order; ``instantiate`` makes them one
    executable graph, which ``replay`` launches."""

    def __init__(self):
        self.items: List = []
        self.executable = None
        self.launches = 0
        self._nodes: Optional[Dict[str, int]] = None

    def graphs(self) -> int:
        """The number of captured segments, loop bodies included."""
        return sum(1 if isinstance(it, _Segment) else it.body.graphs() for it in self.items)

    def loops(self) -> List[_Loop]:
        """Every loop, nested ones after the loop whose body holds them."""
        out = []
        for it in self.items:
            if isinstance(it, _Loop):
                out += [it] + it.body.loops()
        return out

    def segments(self) -> List[_Segment]:
        """Every captured segment, loop bodies' included."""
        out = []
        for it in self.items:
            out += [it] if isinstance(it, _Segment) else it.body.segments()
        return out

    def instantiate(self, assembler=None) -> None:
        """Assemble the program into one executable graph with
        ``assembler`` (``ops.graph_loops.Assembler`` by default); with
        tracing on, count its nodes first."""
        asm = graph_loops.Assembler() if assembler is None else assembler
        if profiling.tracing():
            for seg in self.segments():
                seg.nodes = asm.count_nodes(seg.graph)
                seg.nodes["kernel"] -= seg.stamps
            self._nodes = _sum_nodes(self)
            for lp in self.loops():
                # an iteration: the body's nodes, and the set_while closing it
                lp.nodes = _sum_nodes(lp.body)
                lp.nodes["kernel"] += 1

        def add(body, program: Program) -> None:
            for it in program.items:
                if isinstance(it, _Segment):
                    asm.child(body, it.graph)
                else:
                    inner = asm.while_loop(body, it)
                    add(inner, it.body)
                    asm.end_body(inner, it)

        root = asm.graph()
        add(root, self)
        self.executable = asm.instantiate(root)
        self._launched = _sum_launches(self)
        for lp in self.loops():
            lp.launched = _sum_launches(lp.body)
        _programs.add(self)

    def replay(self) -> None:
        """One launch of the executable on the current stream."""
        self.executable.launch()
        self.launches += 1
        fm.add_launch_counts(self._launched)
        graph_loops.launch_counts["set_while"] += sum(isinstance(it, _Loop) for it in self.items)
        _add_nodes(self._nodes)


def _add_nodes(nodes: Optional[Dict[str, int]], times: int = 1) -> None:
    for k, v in (nodes or {}).items():
        node_counts[k] += times * v


def fold_device_counts() -> None:
    """Add what the instantiated programs' loops ran since the last fold to
    the counts, reading every loop's device total, and the spans' totals,
    in one host read: each iteration of a loop counts its body's own
    segments' launches in ``fused_mlp.launch_counts`` (and nodes in
    ``node_counts``), one in ``loop_iterations``, and its ``set_while``
    runs (its own, and one for each loop its body enters); the spans' go to
    ``profiling.fold_totals``.  Nothing while a capture records."""
    if _recorder is not None:
        return
    loops = [lp for p in list(_programs) for lp in p.loops()]
    spans = profiling.device_totals()
    parts = ([torch.stack([lp.total for lp in loops])] if loops else []) + (
        [spans] if spans is not None else [])
    if not parts:
        return
    values = _host_read(torch.cat(parts))
    for lp, total in zip(loops, values):
        delta, lp.folded = total - lp.folded, total
        if delta:
            fm.add_launch_counts(lp.launched, times=delta)
            loop_iterations[lp.name] = loop_iterations.get(lp.name, 0) + delta
            nested = sum(isinstance(it, _Loop) for it in lp.body.items)
            graph_loops.launch_counts["set_while"] += delta * (1 + nested)
            _add_nodes(lp.nodes, times=delta)
    if spans is not None:
        profiling.fold_totals(values[len(loops):])


def _host_read(t: torch.Tensor) -> List[int]:
    """The one device-to-host read of a fold."""
    return t.tolist()


fm.device_folds.append(fold_device_counts)


class _Recorder:
    def __init__(self, pool, stream: "torch.cuda.Stream"):
        self.pool, self.stream = pool, stream
        self.programs: List[Program] = [Program()]
        self.ctx = None

    def begin(self) -> None:
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        self.before = fm.snapshot_launch_counts()
        self.stamps = profiling.stamps_launched
        self.ctx = torch.cuda.graph(self.graph, pool=self.pool, stream=self.stream)
        self.ctx.__enter__()

    def end(self) -> None:
        ctx, self.ctx = self.ctx, None
        ctx.__exit__(None, None, None)
        launched = fm.launch_counts_since(self.before)
        fm.add_launch_counts(launched, times=-1)   # the capture ran nothing
        self.programs[-1].items.append(
            _Segment(self.graph, launched, profiling.stamps_launched - self.stamps))

    def abort(self) -> None:
        """End a capture that an exception cut short (its error is raised)."""
        if self.ctx is not None:
            ctx, self.ctx = self.ctx, None
            with contextlib.suppress(Exception):
                ctx.__exit__(None, None, None)
            fm.add_launch_counts(fm.launch_counts_since(self.before), times=-1)

    def loop(self, cond, body, state, max_iters: int, counter: torch.Tensor) -> None:
        pred = cond(state)   # the last work of the segment before the loop
        self.end()
        self.programs.append(Program())
        self.begin()
        body(state, None)
        counter.add_(1)
        pred.copy_(cond(state))
        self.end()
        inner = self.programs.pop()
        self.programs[-1].items.append(_Loop(body.__name__, pred, counter, max_iters, inner))
        self.begin()


@contextlib.contextmanager
def capture_program(pool=None, stream: Optional["torch.cuda.Stream"] = None) -> Iterator[Program]:
    """Capture the CUDA work of the ``with`` block as a ``Program``, cut at
    every ``while_loop``.  Nothing runs: instantiate the program, then
    replay it to run it.  A host read or any other operation that cannot be
    captured raises; there is no eager fallback."""
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

"""The span segment of a ``--trace 1`` run, and the reading of its spans.

The port times its train step's layers on the card inside the step's CUDA
graph (``hashmodnffbanks_idr_tpu_torch/utils/profiling.py``: ``span``,
``set_tracing``; the span totals folded with the loops' device totals, a
ring of every stamp, ``utils/graphs.py`` ``node_counts``).  With tracing
off, as in the window and the harness's own traced stretch, the step's graph
holds no span.  The segment, run once after that traced stretch and before
the reference:

1. switches tracing on and takes ``WARM_STEPS`` steps (the first captures
   the step again, with its spans);
2. resets the span totals and takes ``UNTRACED_STEPS`` steps (two epochs of
   the 49-view scan) with no profiler, timed by CUDA events as the window
   is; then reads the totals (one fold) and the ring;
3. profiles one step, ``TRACED_STEPS`` steps and one more step in one
   profile (a trace loses records of a graph's first launch in it, and of
   the work that ends it), the ring reset before the ``TRACED_STEPS`` and a
   ``MARK`` kernel on each side of them, and aligns them
   with the ring (``align``): the k-th ``span_stamp`` kernel record is the
   k-th stamp of the ring, both in device order on one stream, so every
   span lands on the trace's clock; each device operation is put in the
   spans that contain it and each idle gap is named by its innermost span
   (or "between steps") and by the innermost host range or operation at
   its midpoint.  A stretch is whole when the trace holds as many stamps
   as the ring, the intervals between them agree with the ring's, and the
   ``step`` spans hold as many kernels, fills and copies as the program's
   node counts for the same steps; it is profiled again, ``TRIES`` times
   at most;
4. switches tracing off.

It prints one ``[spans]`` line a span (ms a step untraced and traced,
device operations, busy and idle ms a step, the share of the untraced
step), the step's self time, the step span with the wait between steps
against the CUDA events' median step, the fitted offset and rate between
the card's ``%globaltimer`` and the trace's clock with the fit's largest
residual, the least nonzero gap between stamps in the ring, and its own
seconds.

The metric readers call ``reading(ctx)`` with the ``MetricContext`` they
are given.  ``run_cell``, which calls them, hands them no more than that,
and a run's objects are found on the stack: the frame of
``run_cell`` whose ``ctx`` is the one given holds the run's step, feed,
scene and device.  The segment runs once a context; a program without
spans (no ``profiling.set_tracing``), a context that no run made, and a
segment that fails give None, so that the readers report nothing."""

from __future__ import annotations

import inspect
import re
import statistics
import sys
import time
import traceback
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

WARM_STEPS = 2
UNTRACED_STEPS = 98
TRACED_STEPS = 12
TRIES = 3
# a stretch's stamp records fit its ring when this share of the intervals
# between consecutive stamps of INTERVAL_NS or more agrees within 25%: the
# trace's clock runs within a few tenths of a percent of %globaltimer's, but
# not on one line, over a stretch
AGREEMENT = 0.95
INTERVAL_NS = 10_000
MARK = re.compile(r"\bspin_kernel\b")    # torch.cuda._sleep's kernel, the stretch's bounds
MARK_CYCLES = 1000
STAMP = re.compile(r"\bspan_stamp\b")
BETWEEN = "between steps"
TOP = ("tracer", "render", "backward", "update")
NODE_KINDS = ("kernel", "memset", "memcpy")


@dataclass
class Aligned:
    """A profiled stretch on the trace's clock (ns), every sum over the
    stretch: per span, inclusive of the spans inside it."""
    span_ns: Dict[str, float] = field(default_factory=dict)
    ops: Dict[str, int] = field(default_factory=dict)         # device operations, stamps out
    busy_ns: Dict[str, float] = field(default_factory=dict)
    idle_ns: Dict[str, float] = field(default_factory=dict)
    idle_by: Dict[Tuple[str, str], float] = field(default_factory=dict)  # (span, host) -> ns
    offset_ns: float = 0.0      # trace clock - %globaltimer at the first stamp, fitted
    rate: float = 0.0           # the trace clock's rate over %globaltimer's, less 1
    residual_ns: float = 0.0    # the fit's largest residual


@dataclass
class SpanReading:
    steps: int                      # the untraced steps
    span_ns: Dict[str, int]         # the device's span totals over them
    span_count: Dict[str, int]
    between_ns: int
    between_count: int
    nodes: int                      # kernel, memset and memcpy nodes run in them
    median_step_ms: float           # CUDA events over the same steps
    traced_steps: int = TRACED_STEPS
    traced: Optional[Aligned] = None
    edges: List[Tuple[str, Optional[str]]] = field(default_factory=list)  # (span, parent)

    def ms(self, name: str) -> float:
        """Span ``name``'s untraced ms a step."""
        return self.span_ns[name] / self.steps / 1e6

    def launch_gap_ms(self) -> Optional[float]:
        return self.between_ns / self.between_count / 1e6 if self.between_count else None

    def node_gap_us(self) -> Optional[float]:
        t = self.traced
        if t is None or not t.ops.get("step"):
            return None
        return t.idle_ns.get("step", 0.0) / t.ops["step"] / 1e3


def _innermost_host(mids: Sequence[float], host_ops: Sequence[Tuple[float, float, str]]):
    """For each of the sorted ``mids``, the innermost host operation (the
    latest-starting one) whose interval holds it, or "no host operation"."""
    ordered = sorted(host_ops)
    active: List[Tuple[float, float, str]] = []    # by start; the ended ones left until on top
    k, out = 0, []
    for m in mids:
        while k < len(ordered) and ordered[k][0] <= m:
            active.append(ordered[k])
            k += 1
        while active and active[-1][1] < m:
            active.pop()
        out.append(active[-1][2] if active else "no host operation")
    return out


def _fit(xs: Sequence[int], ys: Sequence[float]) -> Tuple[float, float, float]:
    """The least-squares line y = offset + (1 + rate) x through the stamps'
    %globaltimer times ``xs`` and trace times ``ys`` (ns): the offset at the
    first stamp, the rate, and the largest residual (printed, not held)."""
    x0, y0 = xs[0], ys[0]
    u = [x - x0 for x in xs]
    v = [y - y0 for y in ys]
    mu, mv = sum(u) / len(u), sum(v) / len(v)
    var = sum((a - mu) ** 2 for a in u)
    slope = sum((a - mu) * (b - mv) for a, b in zip(u, v)) / var if var else 1.0
    off = mv - slope * mu
    return y0 - x0 + off, slope - 1.0, max(abs(b - off - slope * a) for a, b in zip(u, v))


def align(device_ops: Sequence[Tuple[float, float, str]], ring: Sequence[Tuple[int, str, int]],
          host_ops: Sequence[Tuple[float, float, str]] = (),
          nodes: Optional[int] = None) -> Tuple[Optional[Aligned], str]:
    """Place the ring's spans on the trace's clock.  ``device_ops`` are the
    trace's device records of the stretch (start, end, name; ns), ``ring``
    its stamps (``profiling.read_ring``: ns on %globaltimer, span, 0 entry
    / 1 exit), ``host_ops`` its host records (start, end, name; ns);
    ``nodes``, the program's count of kernel, memset and memcpy nodes over
    the stretch, which the operations inside the ``step`` spans must equal.
    The k-th ``span_stamp`` record is the k-th stamp; a span runs from its
    entry stamp's end to its exit stamp's start.  The stretch is whole when
    the counts agree and the records' intervals agree with the ring's
    (``AGREEMENT``; a record lost and another gained would shift them).
    Returns the alignment, or None with the reason."""
    ops = sorted(device_ops)
    stamps = [op for op in ops if STAMP.search(op[2])]
    if len(stamps) != len(ring):
        return None, f"{len(stamps)} span_stamp records traced, {len(ring)} stamps in the ring"
    a = Aligned()
    if stamps:
        mids = [0.5 * (s + e) for s, e, _ in stamps]
        a.offset_ns, a.rate, a.residual_ns = _fit([t for t, _, _ in ring], mids)
        pairs = [(m1 - m0, r1[0] - r0[0]) for m0, m1, r0, r1 in zip(mids, mids[1:], ring, ring[1:])
                 if r1[0] - r0[0] >= INTERVAL_NS]
        agree = sum(0.8 <= dm / dr <= 1.25 for dm, dr in pairs) / max(len(pairs), 1)
        if agree < AGREEMENT:
            return None, (f"{100 * agree:.1f}% of the stamps' intervals agree with the ring's")
    stack: List[Tuple[str, float]] = []
    gaps: List[Tuple[float, float, str, Tuple[str, ...]]] = []
    k = 0
    for j, (s, e, name) in enumerate(ops):
        if STAMP.search(name):
            _, span, end = ring[k]
            k += 1
            if not end:
                stack.append((span, e))
            elif not stack or stack[-1][0] != span:
                return None, f"stamp {k - 1} closes {span} inside {stack[-1][0] if stack else None}"
            else:
                _, begin = stack.pop()
                a.span_ns[span] = a.span_ns.get(span, 0.0) + s - begin
        else:
            for span, _ in stack or [(BETWEEN, 0.0)]:
                a.ops[span] = a.ops.get(span, 0) + 1
                a.busy_ns[span] = a.busy_ns.get(span, 0.0) + e - s
        if j + 1 < len(ops) and ops[j + 1][0] > e:
            names = tuple(n for n, _ in stack) or (BETWEEN,)
            gaps.append((e, ops[j + 1][0], names[-1], names))
    if stack:
        return None, f"spans left open at the stretch's end: {[n for n, _ in stack]}"
    hosts = _innermost_host([0.5 * (g0 + g1) for g0, g1, _, _ in gaps], host_ops)
    for (g0, g1, inner, names), host in zip(gaps, hosts):
        for n in names:
            a.idle_ns[n] = a.idle_ns.get(n, 0.0) + g1 - g0
        a.idle_by[(inner, host)] = a.idle_by.get((inner, host), 0.0) + g1 - g0
    if nodes is not None and a.ops.get("step", 0) != nodes:
        return None, (f"{a.ops.get('step', 0)} device records inside the step spans, "
                      f"{nodes} nodes counted")
    return a, "whole"


def _run_locals(ctx) -> Optional[dict]:
    """The locals of the ``run_cell`` frame that made ``ctx``, or None."""
    frame = inspect.currentframe()
    try:
        while frame is not None:
            if frame.f_code.co_name == "run_cell" and frame.f_locals.get("ctx") is ctx:
                return dict(frame.f_locals)
            frame = frame.f_back
        return None
    finally:
        del frame


def _events(prof):
    """The profile's device records, sorted, and its host records: (start,
    end, name), ns on the profiler's clock, read from its raw events."""
    from torch.autograd import DeviceType

    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        rec = (e.start_ns(), e.end_ns(), e.name())
        if e.device_type() == DeviceType.CUDA and not e.is_user_annotation():
            device.append(rec)
        elif e.device_type() == DeviceType.CPU:
            host.append(rec)
    return sorted(device), host


def between_marks(device_ops: Sequence[Tuple[float, float, str]]):
    """The device records between the two ``MARK`` kernels that bound the
    stretch on the device's own timeline (the profiler's clock, converted
    from the card's, drifts against the host's by milliseconds over a
    profile, so a host range cannot bound it), or None."""
    marks = [k for k, op in enumerate(device_ops) if MARK.search(op[2])]
    return device_ops[marks[0] + 1:marks[1]] if len(marks) == 2 else None


def _nodes(graphs) -> int:
    graphs.fold_device_counts()
    return sum(graphs.node_counts[k] for k in NODE_KINDS)


def segment(run_step, feed, scene, device, log=sys.stderr) -> Optional[SpanReading]:
    """Run the span segment (the module's docstring) on the run's step and
    feed; None where the program has no spans."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from hashmodnffbanks_idr_tpu_torch.ops import fused_mlp as fm
    from hashmodnffbanks_idr_tpu_torch.utils import graphs, profiling

    from .driver import Clock, sync
    from .stats import step_times_ms

    if not hasattr(profiling, "set_tracing"):
        return None
    on_cuda = torch.device(device).type == "cuda"

    def steps(k, clock=None):
        for _ in range(k):
            inp = feed.next()
            losses = run_step(scene, inp)
            if clock is not None:
                clock.mark()
            if inp["epoch_end"]:   # the runner's one host read an epoch
                torch.stack(list(losses.values())).tolist()
        sync(device)

    t0 = time.perf_counter()
    profiling.set_tracing(True, device)
    try:
        steps(WARM_STEPS)
        t_warm = time.perf_counter() - t0
        profiling.reset_spans()
        nodes0 = _nodes(graphs)
        clock = Clock(device)
        clock.mark()
        steps(UNTRACED_STEPS, clock)
        fm.snapshot_launch_counts()
        snap = profiling.snapshot_spans()
        ring, stamped = profiling.read_ring()
        r = SpanReading(steps=UNTRACED_STEPS,
                        span_ns={n: snap[n]["ns"] for n in profiling.SPANS},
                        span_count={n: snap[n]["count"] for n in profiling.SPANS},
                        between_ns=snap["between_steps"]["ns"],
                        between_count=snap["between_steps"]["count"],
                        nodes=_nodes(graphs) - nodes0,
                        median_step_ms=statistics.median(step_times_ms(clock.times_ms())),
                        edges=sorted(profiling.span_edges, key=str))
        resolution = min((b[0] - a[0] for a, b in zip(ring, ring[1:]) if b[0] > a[0]),
                         default=None)
        activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        for attempt in range(TRIES if on_cuda else 0):
            t_try = time.perf_counter()
            with profile(activities=activities) as prof:
                steps(1)   # a trace loses a record of a graph's first launch in it
                profiling.reset_spans()
                nodes0 = _nodes(graphs)
                torch.cuda._sleep(MARK_CYCLES)
                steps(TRACED_STEPS)
                torch.cuda._sleep(MARK_CYCLES)
                traced_ring, traced_stamps = profiling.read_ring()
                nodes = _nodes(graphs) - nodes0
                steps(1)   # and the last records of a stretch that ends the trace
            t_read = time.perf_counter()
            device_ops, host_ops = _events(prof)
            del prof
            stretch = between_marks(device_ops)
            if stretch is None:
                aligned, why = None, "the stretch's two marks are not both in the trace"
            elif traced_stamps != len(traced_ring):
                aligned, why = None, f"the ring overflowed ({traced_stamps} stamps)"
            else:
                aligned, why = align(stretch, traced_ring, host_ops, nodes)
            print(f"[spans] try {attempt + 1}: {why}; profiled {t_read - t_try:.3f} s, read and "
                  f"aligned {time.perf_counter() - t_read:.3f} s", file=log, flush=True)
            if aligned is not None:
                r.traced = aligned
                break
    finally:
        profiling.set_tracing(False)
    _report(r, stamped, resolution, t_warm, time.perf_counter() - t0, log)
    return r


def _report(r: SpanReading, stamped: int, resolution: Optional[int], t_warm: float,
            seconds: float, log) -> None:
    step = r.ms("step")
    top = sum(r.ms(n) for n in TOP)
    gap = r.launch_gap_ms() or 0.0
    print(f"[spans] {r.steps} untraced steps, {stamped} stamps, {r.nodes / r.steps:.1f} nodes a "
          f"step; step span {step:.4f} ms, of it {TOP} {top:.4f} (step self time "
          f"{step - top:.4f}); wait between steps {gap:.4f} ms ({r.between_count} waits); step "
          f"+ wait {step + gap:.4f} ms against the CUDA events' median step "
          f"{r.median_step_ms:.4f} ({(step + gap) / r.median_step_ms:.4f}); %globaltimer's "
          f"least nonzero gap between stamps {resolution} ns", file=log)
    print(f"[spans] tree (span < the span it ran in): "
          f"{', '.join(f'{c} < {p}' for c, p in r.edges if p)}", file=log)
    t = r.traced
    for name in ("step",) + TOP + ("march", "line_search", "sweep", "secant", "encoder.points",
                                   "encoder.views"):
        line = (f"[spans] {name}: untraced {r.ms(name):.4f} ms a step "
                f"({r.span_count[name] / r.steps:g} a step), "
                f"{100 * r.span_ns[name] / max(r.span_ns['step'], 1):.2f}% of the step")
        if t is not None:
            k = r.traced_steps
            line += (f"; traced {t.span_ns.get(name, 0.0) / k / 1e6:.4f} ms, device operations "
                     f"{t.ops.get(name, 0) / k:.1f}, busy {t.busy_ns.get(name, 0.0) / k / 1e6:.4f} "
                     f"ms, idle {t.idle_ns.get(name, 0.0) / k / 1e6:.4f} ms a step")
        print(line, file=log)
    if t is not None:
        k = r.traced_steps
        traced_top = sum(t.span_ns.get(n, 0.0) for n in TOP) / k / 1e6
        idle = sorted(t.idle_by.items(), key=lambda kv: -kv[1])[:10]
        print(f"[spans] traced: step self time {t.span_ns['step'] / k / 1e6 - traced_top:.4f} ms; "
              f"node gap {r.node_gap_us():.4f} us; clock offset (trace - %globaltimer) "
              f"{t.offset_ns:.0f} ns at the first stamp, rate {1e6 * t.rate:.1f} ppm, largest "
              f"residual {t.residual_ns:.0f} ns; idle ms a step by "
              f"span and host operation {[(s, h, round(v / k / 1e6, 4)) for (s, h), v in idle]}",
              file=log)
    print(f"[spans] segment {seconds:.3f} s (tracing on and the capture {t_warm:.3f} s)",
          file=log, flush=True)


_cache: List = [None, None]      # the context read last, and its reading


def reading(ctx) -> Optional[SpanReading]:
    """The span segment's reading for the run that made ``ctx``, run at the
    first call; None where there is nothing to read."""
    if _cache[0] is ctx:
        return _cache[1]
    found = _run_locals(ctx)
    result = None
    if found is not None:
        try:
            result = segment(found["run_step"], found["feed"], found["scene"], found["device"])
        except Exception:   # the readers report nothing rather than end the run
            traceback.print_exc()
    _cache[:] = [ctx, result]
    return result

"""Profiling: the train step's spans, a profiler window, the host's syncs.

Counterpart of ``hashmodnffbanks_idr_tpu/utils/profiling.py``:

  * :func:`span`: a named layer boundary of the train step (``SPANS``).
    With tracing on (:func:`set_tracing`), on the card each entry and exit
    inside a captured step launches one ``span_stamp`` kernel
    (``ops/csrc/spans.cu``), a node of the step's CUDA graph that reads the
    card's clock; on the CPU the same stamp is taken on the host's clock.
    Each span's total time and count, and the time the card waited between
    one step's work and the next, are folded in with the loops' device
    totals (``utils/graphs.py:fold_device_counts``, one host read) into
    ``span_totals`` and ``between_steps``; every stamp is kept in a ring on
    the device (:func:`read_ring`).  With tracing off ``span`` does nothing,
    so a step captured then is the graph it would be without spans, and the
    stamp kernel is neither built nor loaded;
  * :func:`trace`: a ``torch.profiler`` window, optionally written as a
    Chrome trace (open it in chrome://tracing or Perfetto) with its
    ``key_averages`` (``scripts/profile_torch_step.py`` measures through it);
  * :func:`host_syncs`: the host's synchronisations with the card inside a
    block, counted or refused (``chip_smoke.py``, the profile script);
  * ``H100_PEAK_*``: an NVIDIA H100 SXM's peaks (data sheet, dense, at the
    700 W limit).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import os
import time
from pathlib import Path
from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..ops import fused_mlp as fm
from .compile_cache import build_library

# H100 SXM peaks (NVIDIA data sheet; dense, at the 700 W limit): f32 on the
# CUDA cores, tf32 and bf16 on the tensor cores; HBM3 bandwidth
H100_PEAK_FLOPS = {"f32": 67e12, "tf32": 495e12, "bf16": 989e12}
H100_PEAK_BYTES_PER_S = 3.35e12

# the spans, by id; ``step`` is 0 (the stamp kernel times between steps by it)
SPANS = ("step", "tracer", "march", "line_search", "sweep", "secant", "render", "backward",
         "update", "encoder.points", "encoder.views")
RING = 1 << 17           # stamps the ring keeps after a reset

# the buffer's layout (ops/csrc/spans.cu): open, total ns and count by span,
# then between-steps ns and count, the last step's end, the ring's cursor
_N = len(SPANS)
_TOTALS = slice(_N, 3 * _N + 2)          # what a fold reads
_LAST_STEP_END, _CURSOR = 3 * _N + 2, 3 * _N + 3
_RING0 = 3 * _N + 4
_CSRC = Path(__file__).resolve().parents[1] / "ops" / "csrc" / "spans.cu"

# folded totals: each span's ns and exits, and the card's wait between steps
span_totals: Dict[str, Dict[str, int]] = {name: {"ns": 0, "count": 0} for name in SPANS}
between_steps: Dict[str, int] = {"ns": 0, "count": 0}
# (span, the span it was entered in, or None), as the host saw them
span_edges: Set[Tuple[str, Optional[str]]] = set()
# stamp kernels launched; inside a capture, the graph's nodes that
# ``utils/graphs.py`` leaves out of its node counts
stamps_launched = 0

_on = False
_buf: Optional[torch.Tensor] = None     # kept when tracing goes off: a fold still reads it
_folded: List[int] = []                 # the buffer's totals at the last fold
_open: List[str] = []                   # spans entered and not left, innermost last
_lib = None


def _load_library() -> ctypes.CDLL:
    """Build ``ops/csrc/spans.cu`` (once per source content), load it and
    load its kernel's module."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_library(_CSRC, "spans")))
        lib.sp_stamp.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                                 ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.sp_load.argtypes = []
        lib.sp_stamp.restype = lib.sp_load.restype = ctypes.c_int
        err = lib.sp_load()
        if err:
            raise RuntimeError(f"loading span_stamp failed: CUDA error {err}")
        _lib = lib
    return _lib


def set_tracing(on: bool, device=None) -> None:
    """Switch the spans on, their buffer on ``device`` (None -> the CUDA
    card; there the stamp kernel is built and loaded now), or off.  A
    graphed train step captures again at its next call."""
    global _on, _buf, _folded
    if on:
        device = resolve_device(device)
        if _buf is None or _buf.device != device:
            if _buf is not None:
                fm.fold_device_counts()
            if device.type == "cuda":
                _load_library()
            _buf = torch.zeros(_RING0 + 2 * RING, dtype=torch.int64, device=device)
            _folded = [0] * (_TOTALS.stop - _TOTALS.start)
    _on = bool(on)


def tracing() -> bool:
    return _on


def stamp_plain(buf: np.ndarray, i: int, end: int, t: int) -> None:
    """The stamp kernel's math on the host, at time ``t`` (ns)."""
    if not end:
        buf[i] = t
        if i == 0 and buf[_LAST_STEP_END] > 0:
            buf[3 * _N] += t - buf[_LAST_STEP_END]
            buf[3 * _N + 1] += 1
    else:
        buf[_N + i] += t - buf[i]
        buf[2 * _N + i] += 1
        if i == 0:
            buf[_LAST_STEP_END] = t
    k = int(buf[_CURSOR])
    buf[_CURSOR] += 1
    if k < RING:
        buf[_RING0 + 2 * k:_RING0 + 2 * k + 2] = (t, 2 * i + end)


def _stamp(i: int, end: int) -> None:
    """One stamp: a ``span_stamp`` launch on the card while a capture
    records (the step's graph holds it; nothing is stamped outside a
    capture there), the host's clock on the CPU."""
    global stamps_launched
    if _buf.device.type != "cuda":
        stamp_plain(_buf.numpy(), i, end, time.perf_counter_ns())
        return
    if not torch.cuda.is_current_stream_capturing():
        return
    err = _lib.sp_stamp(ctypes.c_void_p(_buf.data_ptr()), _N, RING, i, end,
                        ctypes.c_void_p(torch.cuda.current_stream(_buf.device).cuda_stream))
    if err:
        raise RuntimeError(f"span_stamp failed: CUDA error {err}")
    stamps_launched += 1


@contextlib.contextmanager
def span(name: str):
    """Time the block as span ``name`` (one of ``SPANS``) with tracing on;
    nothing with it off.  A block that raises is not stamped at its exit."""
    if not _on:
        yield
        return
    i = SPANS.index(name)
    span_edges.add((name, _open[-1] if _open else None))
    _open.append(name)
    _stamp(i, 0)
    try:
        yield
    finally:
        _open.pop()
    _stamp(i, 1)


def spanned(name: str):
    """A decorator: each call of the function is span ``name`` (a while
    loop's body: a span an iteration)."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def device_totals() -> Optional[torch.Tensor]:
    """What a fold reads (a view of the buffer): each span's total ns, each
    span's count, then the between-steps ns and count; None before tracing
    was first switched on."""
    return None if _buf is None else _buf[_TOTALS]


def fold_totals(values: List[int]) -> None:
    """Add what ``device_totals()``, read as ``values``, holds beyond the
    last fold to ``span_totals`` and ``between_steps``."""
    global _folded
    delta = [v - f for v, f in zip(values, _folded)]
    _folded = list(values)
    for k, name in enumerate(SPANS):
        span_totals[name]["ns"] += delta[k]
        span_totals[name]["count"] += delta[_N + k]
    between_steps["ns"] += delta[2 * _N]
    between_steps["count"] += delta[2 * _N + 1]


def snapshot_spans() -> Dict[str, Dict[str, int]]:
    """``span_totals`` with ``between_steps`` under its own name, as they
    stand after a fold (``fm.snapshot_launch_counts`` makes one)."""
    return {**{k: dict(v) for k, v in span_totals.items()}, "between_steps": dict(between_steps)}


def reset_spans() -> None:
    """Fold, then zero the folded totals, the ring's cursor and the last
    step's end (the next step adds no time between steps)."""
    fm.fold_device_counts()
    for c in list(span_totals.values()) + [between_steps]:
        for k in c:
            c[k] = 0
    if _buf is not None:
        _buf[_LAST_STEP_END:_CURSOR + 1].zero_()


def read_ring() -> Tuple[List[Tuple[int, str, int]], int]:
    """The ring since the last reset, in device order, as (time ns, span,
    0 at its entry or 1 at its exit), and the stamps counted (more than
    ``RING`` when the ring overflowed)."""
    if _buf is None:
        return [], 0
    n = int(_buf[_CURSOR])
    flat = _buf[_RING0:_RING0 + 2 * min(n, RING)].tolist()
    return [(flat[j], SPANS[flat[j + 1] // 2], flat[j + 1] % 2)
            for j in range(0, len(flat), 2)], n


@contextlib.contextmanager
def trace(logdir: Optional[str] = None, device=None):
    """Profile the body on ``device`` (None -> the CUDA card; 'cpu' records
    host activity only).  Yields the ``torch.profiler.profile``; on exit,
    given a ``logdir``, writes ``<logdir>/trace.json`` and
    ``<logdir>/key_averages.txt``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if resolve_device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
        if ProfilerActivity.CUDA in activities:
            torch.cuda.synchronize()
    if logdir is None:
        return
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    sort = "cuda_time_total" if ProfilerActivity.CUDA in activities else "cpu_time_total"
    with open(os.path.join(logdir, "key_averages.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by=sort, row_limit=50))


@contextlib.contextmanager
def host_syncs(mode: str = "warn"):
    """Count the host's synchronisations with the card inside the block
    (``torch.cuda.set_sync_debug_mode``: "warn" counts them, "error" raises
    at the first).  Yields a one-element list that holds the count once the
    block has ended."""
    import warnings

    count = [0]
    torch.cuda.set_sync_debug_mode(mode)
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            yield count
        count[0] = sum("synchronizing CUDA operation" in str(w.message) for w in seen)
    finally:
        torch.cuda.set_sync_debug_mode("default")

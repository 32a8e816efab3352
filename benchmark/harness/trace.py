"""The reading of a ``torch.profiler`` trace of the train step: the device's
operations (kernels inside the step's CUDA graph too), the time the device
was busy, the largest operations and the longest idle gaps by what the host
was doing."""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

from torch.autograd import DeviceType

_NOT_KERNEL = ("Memcpy", "Memset")


@dataclass
class TraceReading:
    steps: int
    window_s: float                      # the traced window by the host's clock
    busy_s: float                        # union of the device's operations in it
    kernel_count: int
    kernel_s: Dict[str, float] = field(default_factory=dict)   # device seconds by name
    kernel_n: Dict[str, int] = field(default_factory=dict)     # launches by name
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)

    def kernel_seconds(self, pattern: str) -> float:
        """Device seconds of the kernels whose name matches ``pattern``."""
        rx = re.compile(pattern)
        return sum(s for name, s in self.kernel_s.items() if rx.search(name))

    def kernel_launches(self, pattern: str) -> int:
        """Launches of the kernels whose name matches ``pattern``."""
        rx = re.compile(pattern)
        return sum(k for name, k in self.kernel_n.items() if rx.search(name))

    def top_ops(self, n: int = 10) -> List[Tuple[str, float]]:
        return sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:n]


def _merge(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def read_profile(prof, steps: int, window_s: float, n_gaps: int = 10) -> TraceReading:
    """Reduce a finished ``torch.profiler.profile`` over ``steps`` steps and
    ``window_s`` host seconds.  Busy time is the union of the device's
    operations (kernels, copies, fills); an idle gap between two of them is
    named by the innermost host operation under its midpoint."""
    events = prof.events()
    device_ops, host_ops = [], []
    kernel_s: Dict[str, float] = {}
    kernel_n: Dict[str, int] = {}
    count = 0
    for e in events:
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            start, end = e.time_range.start, e.time_range.end
            device_ops.append((start, end))
            if not e.name.startswith(_NOT_KERNEL):
                count += 1
                kernel_s[e.name] = kernel_s.get(e.name, 0.0) + (end - start) * 1e-6
                kernel_n[e.name] = kernel_n.get(e.name, 0) + 1
        elif e.device_type == DeviceType.CPU:
            host_ops.append((e.time_range.start, e.time_range.end, e.name))
    merged = _merge(device_ops)
    busy_s = sum(e - s for s, e in merged) * 1e-6
    gaps = sorted(((b[0] - a[1], a[1], b[0]) for a, b in zip(merged, merged[1:])),
                  reverse=True)[:n_gaps]
    named = []
    for width, s, e in gaps:
        mid = 0.5 * (s + e)
        under = [(he - hs, name) for hs, he, name in host_ops if hs <= mid <= he]
        named.append((min(under)[1] if under else "no host operation", width * 1e-6))
    return TraceReading(steps=steps, window_s=window_s, busy_s=busy_s,
                        kernel_count=count, kernel_s=kernel_s, kernel_n=kernel_n,
                        idle_gaps=named)

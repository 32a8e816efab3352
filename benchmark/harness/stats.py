"""The end-to-end arithmetic: the rate over the window and the tail of the
step times."""

from __future__ import annotations

import statistics
from typing import List, Sequence


def step_times_ms(event_ms: Sequence[float]) -> List[float]:
    """Step times from the event times of one window, in ms: ``event_ms[0]``
    is the window's start, ``event_ms[k]`` the event recorded after the
    k-th step's launch (each completes when the device has finished that
    step), so step k took ``event_ms[k] - event_ms[k - 1]``."""
    return [b - a for a, b in zip(event_ms, event_ms[1:])]


def p95(values: Sequence[float]) -> float:
    """The 95th percentile, linearly interpolated between order statistics
    (``statistics.quantiles(..., n=20, method='inclusive')``); of one value,
    that value."""
    if len(values) == 1:
        return float(values[0])
    return statistics.quantiles(values, n=20, method="inclusive")[18]


def rate(items: int, seconds: float) -> float:
    """Items a second over the window."""
    if seconds <= 0:
        raise ValueError(f"window of {seconds} s")
    return items / seconds

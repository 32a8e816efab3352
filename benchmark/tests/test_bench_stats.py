"""The end-to-end arithmetic on hand-worked event times."""

import pytest

from harness import stats


def test_step_times_from_events():
    assert stats.step_times_ms([0.0, 40.0, 81.0, 120.0]) == [40.0, 41.0, 39.0]


def test_p95_and_rate_with_one_stalled_step():
    # 99 steps of 40 ms after the window's start, one stalled at 400 ms (an
    # epoch's host read behind a long step)
    events = [0.0]
    for k in range(100):
        events.append(events[-1] + (400.0 if k == 50 else 40.0))
    times = stats.step_times_ms(events)
    assert len(times) == 100 and max(times) == 400.0
    # order statistics 95 and 96 of 100 (1-based) are both 40 ms: one stall
    # in a hundred steps stays out of the 95th percentile
    assert stats.p95(times) == pytest.approx(40.0)
    # six stalls in a hundred reach it
    times6 = [400.0] * 6 + [40.0] * 94
    assert stats.p95(times6) == pytest.approx(400.0)
    # the rate is over all the window's work and time, stall included
    window_s = events[-1] / 1e3
    assert stats.rate(2048 * 100, window_s) == pytest.approx(2048 * 100 / 4.36)


def test_p95_interpolates():
    assert stats.p95(list(range(1, 21))) == pytest.approx(19.05)


def test_rate_needs_a_window():
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)

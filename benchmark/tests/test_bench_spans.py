"""The span segment's alignment (``harness/spans.py``) on hand-made kernel
records and a hand-made ring: the spans placed on the trace's clock across
an offset, device operations and idle gaps put in their spans, gaps named
by span and host operation, a lost record or a node count that disagrees
making the stretch not whole; and the new readers reading nothing where no
run made the context."""

from types import SimpleNamespace as NS

import pytest

from bench_helpers import ROOT
from harness import spans, spec

NEW = ("tracer_device_ms", "encoder_fwd_device_ms", "render_device_ms", "backward_device_ms",
       "update_device_ms", "launch_gap_ms", "graph_nodes_per_step", "node_gap_us")
OFFSET_NS = 5_000_000_123     # the trace's clock less %globaltimer
STAMP = "span_stamp(long long*, int, long long, int, int)"
UNIT = 10_000                  # ns a unit of the plan below


def stretch():
    """Two steps on the trace's clock (ns, planned in ``UNIT``s): step >
    tracer > march, then render; a fill between them.  Each stamp is a
    record of one unit, its ring time at its midpoint less the offset."""
    plan = [  # (start, name or a span stamp (span, end))
        (0, ("step", 0)), (2, ("tracer", 0)), (4, "k_trace"), (10, ("march", 0)),
        (12, "k_march"), (20, ("march", 1)), (22, ("tracer", 1)), (30, ("render", 0)),
        (31, "memcpy"), (40, ("render", 1)), (41, ("step", 1)),
        (60, "fill"),
        (100, ("step", 0)), (101, "k_other"), (110, ("step", 1)),
    ]
    us = UNIT
    ops, ring = [], []
    for start, what in plan:
        if isinstance(what, tuple):
            ops.append((start * us, (start + 1) * us, STAMP))
            ring.append((int((start + 0.5) * us - OFFSET_NS), what[0], what[1]))
        else:
            ops.append((start * us, (start + (4 if what == "k_march" else 2)) * us, what))
    host = [(0, 200 * us, "step loop"), (45 * us, 70 * us, "step.inputs"),
            (50 * us, 55 * us, "cudaMemcpyAsync")]
    return ops, ring, host


def test_alignment_places_spans_ops_and_gaps():
    ops, ring, host = stretch()
    # the profile around the stretch: a step before and after, each with a
    # stamp, and the two marks that bound the stretch on the device
    mark = "void at::cuda::(anonymous namespace)::spin_kernel(long)"
    profiled = sorted(ops + [(-9 * UNIT, -8 * UNIT, STAMP), (-2 * UNIT, -1 * UNIT, mark),
                             (120 * UNIT, 121 * UNIT, mark), (130 * UNIT, 131 * UNIT, STAMP)])
    assert spans.between_marks(profiled) == sorted(ops)
    assert spans.between_marks(profiled[1:-1] + [profiled[1]]) is None
    a, why = spans.align(ops, ring, host, nodes=4)
    assert why == "whole"
    assert a.offset_ns == pytest.approx(OFFSET_NS, abs=1) and a.residual_ns < 1
    assert a.rate == pytest.approx(0, abs=1e-9)
    # a span runs from its entry stamp's end to its exit stamp's start
    assert a.span_ns["step"] == pytest.approx(UNIT * ((41 - 1) + (110 - 101)))
    assert a.span_ns["march"] == pytest.approx(UNIT * (20 - 11))
    assert a.ops == {"step": 4, "tracer": 2, "march": 1, "render": 1, "between steps": 1}
    assert a.busy_ns["march"] == pytest.approx(4 * UNIT)
    assert a.busy_ns["step"] == pytest.approx(10 * UNIT)
    # idle inside march: 11-12 and 16-20; inside tracer also 3-4, 6-10, 21-22
    assert a.idle_ns["march"] == pytest.approx(5 * UNIT)
    assert a.idle_ns["tracer"] == pytest.approx((5 + 1 + 4 + 1) * UNIT)
    # the gaps between the steps are named "between steps" and by the host
    # operation under their midpoints
    assert a.idle_by[("between steps", "cudaMemcpyAsync")] == pytest.approx(18 * UNIT)  # 42-60
    assert a.idle_by[("between steps", "step loop")] == pytest.approx(38 * UNIT)        # 62-100
    assert a.idle_by[("render", "step loop")] == pytest.approx(7 * UNIT)                # 33-40
    r = spans.SpanReading(steps=2, span_ns={}, span_count={}, between_ns=0, between_count=0,
                          nodes=4, median_step_ms=0.0, traced_steps=2, traced=a)
    assert r.node_gap_us() == pytest.approx(a.idle_ns["step"] / 4 / 1e3)


def test_a_lost_record_is_not_whole():
    ops, ring, host = stretch()
    a, why = spans.align(ops[:1] + ops[2:], ring, host)           # one stamp record lost
    assert a is None and "10 stamps in the ring" in why
    a, why = spans.align(ops, ring, host, nodes=5)                # one record fewer than nodes
    assert a is None and "nodes counted" in why
    # a stamp record lost and one gained elsewhere: the counts agree, the
    # intervals between the stamps do not
    gained = ops[:1] + ops[2:] + [(105 * UNIT, 106 * UNIT, STAMP)]
    a, why = spans.align(gained, ring, host)
    assert a is None and "intervals agree" in why


def test_new_readers_read_nothing_without_a_run():
    ctx = NS(conf={}, rays=2048, window=None, traced=None, traced_counts=None)
    for name in NEW:
        assert spec.metric_reader(ROOT, name)(ctx) is None


def test_new_metrics_are_declared_for_every_cell():
    bench = spec.load_benchmark(ROOT)
    declared = {m["name"]: m for m in bench["per_layer"]}
    for name in NEW:
        assert "workloads" not in declared[name] and declared[name]["moves"] == "train_rays_per_s"

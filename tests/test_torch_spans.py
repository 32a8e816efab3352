"""The train step's spans on the CPU (``utils/profiling.py``): nothing with
tracing off; with it on, the eager step's span tree, its nesting in the
ring, the loop bodies' spans once an iteration, the totals folded in one
host read, the card's wait between steps, the stamp's math, the graphed
step capturing again when tracing is switched, the node counts of a program
folded as its launches are (``utils/graphs.py``, on the fakes of
``torch_graph_fakes``), and the runner's ``--trace_spans`` scalars.

On the CPU a stamp reads the host's clock; the stamps as nodes of the
captured graph, on the card's clock, are held in ``tests/test_torch_cuda.py``.
"""

import json
import pathlib

import numpy as np
import pytest
import torch

from hashmodnffbanks_idr_tpu_torch.config.hocon import parse_file
from hashmodnffbanks_idr_tpu_torch.data import dummy_cli
from hashmodnffbanks_idr_tpu_torch.models.loss import IDRLossConfig
from hashmodnffbanks_idr_tpu_torch.models.renderer import IDRNetwork
from hashmodnffbanks_idr_tpu_torch.ops import fused_mlp as fm
from hashmodnffbanks_idr_tpu_torch.testing import flagship_conf, scene_to_device, synthetic_scene
from hashmodnffbanks_idr_tpu_torch.train import exp_runner
from hashmodnffbanks_idr_tpu_torch.train import trainer as tr
from hashmodnffbanks_idr_tpu_torch.utils import graphs, profiling

import torch_graph_fakes as fakes

N_RAYS = 64
DUMMY_CONF = (pathlib.Path(__file__).resolve().parents[1]
              / "hashmodnffbanks_idr_tpu/config/confs/dummy_stylemodnffb.conf")
TOP = ("tracer", "render", "backward", "update")
# each span's parent; the encoders' may be any span that queries the SDF
PARENT = {"step": None, "tracer": "step", "render": "step", "backward": "step",
          "update": "step", "march": "tracer", "line_search": "march", "sweep": "tracer",
          "secant": "tracer"}
ENCODER_PARENTS = {"tracer", "march", "line_search", "sweep", "secant", "render"}


@pytest.fixture(autouse=True)
def _spans_state(monkeypatch):
    """Each test starts with tracing off and empty totals, and leaves the
    module as it found it."""
    monkeypatch.setattr(profiling, "_on", False)
    monkeypatch.setattr(profiling, "_buf", None)
    monkeypatch.setattr(profiling, "_folded", [])
    monkeypatch.setattr(profiling, "span_totals",
                        {n: {"ns": 0, "count": 0} for n in profiling.SPANS})
    monkeypatch.setattr(profiling, "between_steps", {"ns": 0, "count": 0})
    monkeypatch.setattr(profiling, "span_edges", set())
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _step(mode="mixed", graphed=False):
    """A narrow flagship step on a 2-view 32x32 scene, its scene and a
    function that takes one step of view ``i``."""
    conf = flagship_conf(num_pixels=N_RAYS, small=True)
    conf.put("model.tracer_fast", mode)
    model = IDRNetwork(conf.get_config("model"), device="cpu", seed=0)
    step = tr.build_train_step(model, IDRLossConfig(0.1, 200.0, 50.0), tr.make_optimizer(model),
                               graphed=graphed)
    scene = scene_to_device(synthetic_scene(n_views=2, img_res=(32, 32), seed=0), "cpu")
    gen = torch.Generator().manual_seed(1)
    pixels = torch.randperm(32 * 32, generator=gen)[:N_RAYS]

    def run(i=0):
        return step(scene, torch.tensor([i % 2]), pixels, gen, 50.0)
    return step, run


def _nesting(ring):
    """(span, parent) pairs and the per-span durations read off the ring;
    fails unless every exit closes the innermost open span."""
    stack, edges, ns = [], set(), {}
    for t, name, end in ring:
        if not end:
            edges.add((name, stack[-1][0] if stack else None))
            stack.append((name, t))
        else:
            top, t0 = stack.pop()
            assert top == name, f"{name} closed inside {top}"
            ns[name] = ns.get(name, 0) + t - t0
    assert not stack
    return edges, ns


def test_span_records_nothing_with_tracing_off():
    _, run = _step()
    run()
    fm.snapshot_launch_counts()
    assert profiling.span_edges == set() and profiling._buf is None
    assert all(c == {"ns": 0, "count": 0} for c in profiling.span_totals.values())
    assert profiling.read_ring() == ([], 0)
    assert profiling._lib is None          # the stamp kernel is neither built nor loaded


@pytest.mark.parametrize("mode,graphed", [("mixed", False), ("exact", False), ("mixed", True)],
                         ids=["mixed-eager", "exact-eager", "mixed-graphed"])
def test_step_span_tree_nesting_and_iteration_counts(mode, graphed):
    _, run = _step(mode, graphed)
    run()                                  # the Adam state and the kernels' plain twins
    profiling.set_tracing(True, "cpu")
    profiling.reset_spans()
    loops = dict(graphs.loop_iterations)
    for i in range(2):
        run(i)
    fm.snapshot_launch_counts()
    ring, stamps = profiling.read_ring()
    assert stamps == len(ring) > 0
    edges, ns = _nesting(ring)
    assert edges == profiling.span_edges
    for name, parent in edges:
        if name.startswith("encoder."):
            assert parent in ENCODER_PARENTS, (name, parent)
        else:
            assert parent == PARENT[name], (name, parent)
    lines = graphs.loop_iterations["line_body"] - loops.get("line_body", 0)
    assert {n for n, _ in edges} == set(profiling.SPANS) - ({"line_search"} if not lines else set())
    totals = profiling.span_totals
    assert totals["step"]["count"] == 2
    assert all(totals[n]["count"] == 2 for n in ("tracer", "backward", "update", "sweep",
                                                 "secant"))
    assert totals["render"]["count"] == 4  # the forward after the tracer, the loss terms
    # a loop body's span once an iteration
    assert totals["march"]["count"] == graphs.loop_iterations["march_body"] - loops["march_body"]
    assert totals["line_search"]["count"] == lines
    assert {n: c["ns"] for n, c in totals.items() if c["count"]} == ns
    assert sum(totals[n]["ns"] for n in TOP) <= totals["step"]["ns"]
    assert profiling.between_steps["count"] == 1     # none before the first step after a reset


def test_totals_fold_in_one_read(monkeypatch):
    _, run = _step()
    profiling.set_tracing(True, "cpu")
    reads = []
    monkeypatch.setattr(graphs, "_host_read", lambda t: reads.append(t) or t.tolist())
    for i in range(3):
        run(i)
    assert profiling.span_totals["step"]["count"] == 0   # nothing is read until a fold
    fm.snapshot_launch_counts()
    assert len(reads) == 1
    assert profiling.span_totals["step"]["count"] == 3
    assert profiling.between_steps["count"] == 2
    fm.snapshot_launch_counts()                          # a second fold adds nothing new
    assert len(reads) == 2 and profiling.span_totals["step"]["count"] == 3


def test_stamp_math_and_reset():
    """The kernel's math on the host: entry and exit, the between-steps
    total from the last ``step`` exit, the ring in order; a reset zeroes
    the totals, the cursor and the last exit."""
    profiling.set_tracing(True, "cpu")
    buf = profiling._buf.numpy()
    step, tracer = profiling.SPANS.index("step"), profiling.SPANS.index("tracer")
    for i, end, t in [(step, 0, 100), (tracer, 0, 110), (tracer, 1, 150), (step, 1, 200),
                      (step, 0, 260), (step, 1, 300)]:
        profiling.stamp_plain(buf, i, end, t)
    fm.snapshot_launch_counts()
    assert profiling.span_totals["step"] == {"ns": 100 + 40, "count": 2}
    assert profiling.span_totals["tracer"] == {"ns": 40, "count": 1}
    assert profiling.between_steps == {"ns": 60, "count": 1}
    assert profiling.read_ring() == ([(100, "step", 0), (110, "tracer", 0), (150, "tracer", 1),
                                      (200, "step", 1), (260, "step", 0), (300, "step", 1)], 6)
    profiling.reset_spans()
    assert profiling.read_ring() == ([], 0)
    assert profiling.span_totals["step"] == {"ns": 0, "count": 0}
    profiling.stamp_plain(buf, step, 0, 400)   # no last exit: no time between steps
    fm.snapshot_launch_counts()
    assert profiling.between_steps == {"ns": 0, "count": 0}


def test_switching_tracing_changes_the_graphed_steps_signature():
    step, run = _step(graphed=True)
    run()
    key = step._key
    profiling.set_tracing(True, "cpu")
    run()
    assert step._key != key and step._key[-1] is True
    profiling.set_tracing(False)
    run()
    assert step._key == key


def test_node_counts_fold_as_launches_do(monkeypatch):
    """A program of a segment, a loop and a segment under the fake capture,
    instantiated with tracing on: each launch adds its top-level segments'
    nodes and a ``set_while`` node before the loop; each iteration its
    body's nodes and the ``set_while`` closing it, folded from the loop's
    device total; a stamp in the body is left out."""
    fakes.install(monkeypatch)
    profiling.set_tracing(True, "cpu")
    state = {"n": torch.zeros((), dtype=torch.int64), "limit": torch.tensor(3),
             "stamp": torch.zeros((), dtype=torch.int64)}

    def body(st, _):
        st["stamp"].add_(1)                # stands for a span's stamp kernel
        profiling.stamps_launched += 1
        st["n"].add_(1)

    with graphs.capture_program(pool=object(), stream=object()) as program:
        state["n"].zero_()
        graphs.while_loop(lambda st: st["n"] < st["limit"], body, state, max_iters=5)
        state["stamp"].fill_(0)
    asm = fakes.FakeAssembler()
    program.instantiate(asm)
    first, loop, last = program.items
    assert (first.stamps, loop.body.items[0].stamps, last.stamps) == (0, 1, 0)
    counted = [asm.count_nodes(seg.graph) for seg in (first, loop.body.items[0], last)]
    top = {k: counted[0][k] + counted[2][k] for k in counted[0]}
    top["kernel"] += 1                     # the set_while before the loop
    it = dict(counted[1])                  # the stamp out, the set_while closing the body in
    assert counted[2]["memset"] == 1 and counted[1]["memcpy"] == 1   # fill_; the predicate
    fm.snapshot_launch_counts()
    before = dict(graphs.node_counts)
    program.replay()
    program.replay()
    fm.snapshot_launch_counts()
    got = {k: v - before[k] for k, v in graphs.node_counts.items()}
    assert got == {k: 2 * top[k] + 6 * it[k] for k in top}     # 3 iterations a launch


def test_runner_logs_span_scalars(tmp_path):
    dummy_cli.main(["--out", str(tmp_path / "data" / "dummy" / "scan0"), "--views", "3",
                    "--size", "32"])
    conf = parse_file(str(DUMMY_CONF))
    for k, v in {"model.implicit_network.dims": [128] * 8, "model.rendering_network.dims": [64, 64],
                 "model.feature_vector_size": 32, "model.ray_tracer.n_steps": 28,
                 "train.num_pixels": 64, "dataset.img_res": [32, 32]}.items():
        conf.put(k, v)
    (tmp_path / "narrow.conf").write_text(conf.dump())
    runner = exp_runner.main(["--conf", str(tmp_path / "narrow.conf"), "--data_root",
                              str(tmp_path / "data"), "--exps_folder_name",
                              str(tmp_path / "exps"), "--platform", "cpu", "--no_tensorboard",
                              "--nepoch", "1", "--trace_spans"])
    with open(f"{runner.rundir}/logs/scalars.jsonl") as f:
        rows = [json.loads(line) for line in f]
    assert len(rows) == 2
    for r in rows:
        ms = {n: r[f"span_ms/{n}"] for n in profiling.SPANS}
        assert ms["step"] > 0 and all(ms[n] > 0 for n in TOP)
        assert sum(ms[n] for n in TOP) <= ms["step"]
        assert np.isfinite(r["launch_gap_ms"]) and r["launch_gap_ms"] >= 0

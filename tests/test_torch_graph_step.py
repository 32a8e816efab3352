"""The graphed train step's program on the CPU: the one executable graph
it is assembled into, run as the card runs it (``torch_graph_fakes``: a
fake capture that replays what it recorded into the same tensors, a fake
assembler that runs while-nodes with the device's semantics), the launch
counts a launch adds and the ones folded in from the loops' device totals,
a capture cut short, and one step of the program against JAX's step.

On the CPU ``build_train_step(graphed=True)`` runs the graphed step's
program eagerly (no capture).  Its launches as one CUDA graph are held
against the eager step on the card (``tests/test_torch_cuda.py``).
"""

import contextlib
import re

import jax
import pytest
import torch

from hashmodnffbanks_idr_tpu_torch.models.loss import IDRLossConfig
from hashmodnffbanks_idr_tpu_torch.ops import fused_mlp as fm
from hashmodnffbanks_idr_tpu_torch.ops import graph_loops as gl
from hashmodnffbanks_idr_tpu_torch.testing import flagship_conf, scene_to_device
from hashmodnffbanks_idr_tpu_torch.train import trainer as tr
from hashmodnffbanks_idr_tpu_torch.utils import graphs

import torch_graph_fakes as fakes
import torch_step_parity as tsp

ALPHA = 50.0
N_RAYS = 64


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """The test workers share the cores: torch's default thread pool in
    each of them makes these CPU steps crawl."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


# ---------------------------------------------------------------------------
# the program as one graph: its loops as while-nodes, its launch accounting
# ---------------------------------------------------------------------------

def _launch(variant, n, cluster):
    """What ``fused_mlp._launch`` counts for one launch."""
    c = fm.launch_counts[f"fused_sdf_raw_{variant}"]
    c["launches"] += 1
    c["points"] += n
    c[f"cluster_{cluster}"] += 1


def test_replayed_program_counts_the_launches_its_capture_recorded(monkeypatch):
    """A program of a graph, a loop and a graph, captured under the fake
    capture: what the capture counted is taken out when each graph's
    capture ends; each launch adds its top-level graphs' launches (per
    variant, points and cluster size) on the host, and the loop's body
    launches are folded in from the loop's device total when the counts are
    read; the loop runs its body while its predicate, evaluated after each
    body, holds, and its cap cuts it."""
    fakes.install(monkeypatch)
    fm.reset_launch_counts()
    state = {"n": torch.zeros((), dtype=torch.int64), "limit": torch.tensor(3)}

    def body(st, _):
        _launch("bf16", 4096, 2)
        st["n"].add_(1)

    with graphs.capture_program(pool=object(), stream=object()) as program:
        _launch("f32", 2048, 2)
        state["n"].zero_()
        graphs.while_loop(lambda st: st["n"] < st["limit"], body, state, max_iters=5)
        _launch("f32", 49152, 1)
    assert all(v == 0 for c in fm.launch_counts.values() for v in c.values())
    assert program.graphs() == 3
    program.instantiate(fakes.FakeAssembler())

    program.replay()
    f32, bf16 = fm.launch_counts["fused_sdf_raw_f32"], fm.launch_counts["fused_sdf_raw_bf16"]
    assert (f32["launches"], f32["points"], f32["cluster_1"], f32["cluster_2"]) == \
        (2, 2048 + 49152, 1, 1)
    assert bf16["launches"] == 0   # not folded in yet: only the device knows
    counts = fm.snapshot_launch_counts()
    assert int(state["n"]) == 3
    assert (counts["fused_sdf_raw_bf16"]["launches"], counts["fused_sdf_raw_bf16"]["points"],
            counts["fused_sdf_raw_bf16"]["cluster_2"]) == (3, 3 * 4096, 3)
    assert counts["fused_sdf_raw_f32"] == f32

    state["limit"].fill_(100)   # the body every time: max_iters cuts the loop
    program.replay()
    counts = fm.snapshot_launch_counts()
    assert int(state["n"]) == 5 and program.launches == 2
    assert counts["fused_sdf_raw_bf16"]["launches"] == 3 + 5
    assert counts["fused_sdf_raw_f32"]["launches"] == 4
    fm.reset_launch_counts()


def _nested(state):
    """A graph, a loop whose body holds a graph, a loop (reading its
    counter) and a graph, then a graph: the march and its line search."""
    def inner(st, _):
        _launch("bf16", 4096, 2)
        st["y"].add_(st["k"] + 1)

    def outer(st, _):
        _launch("f32", 2048, 2)
        st["x"].add_(1)
        graphs.while_loop(lambda st: st["y"] < st["x"] * 2, inner, st, 3, "k")
        _launch("f32", 4096, 4)

    _launch("bf16", 69632, 1)
    state["x"].fill_(0.0)
    state["y"].fill_(0.0)
    graphs.while_loop(lambda st: st["x"] < st["stop"], outer, state, 4)
    _launch("f32", 49152, 1)


@pytest.mark.parametrize("stop", [0.0, 2.0, 10.0])
def test_assembled_program_runs_nested_loops_as_while_nodes(stop, monkeypatch):
    """The nested program captured and assembled as on the card (the fake
    assembler: a child graph per segment, a while-node per loop, the inner
    loop's node inside the outer loop's body), against the same program run
    eagerly with its predicates read on the host: the same state, every
    loop's iterations and the fused-kernel launches (per variant, points
    and cluster size) folded in from the device totals equal to the eager
    counts, with a predicate false at once (no body runs), a loop ended by
    its predicate and one cut by its cap.  The order of what ran: the
    segments in capture order, a body's condition evaluated only after it,
    the inner loop entered once per outer iteration; ``set_while`` counted
    once before each while-node and once after each body."""
    def fresh():
        return {"x": torch.zeros(()), "y": torch.zeros(()), "stop": torch.tensor(stop)}

    fm.reset_launch_counts()
    graphs.loop_iterations.clear()
    eager = fresh()
    _nested(eager)
    want_counts, want_iters = fm.snapshot_launch_counts(), dict(graphs.loop_iterations)

    fakes.install(monkeypatch)
    state = fresh()
    with graphs.capture_program(pool=object(), stream=object()) as program:
        _nested(state)
    [outer] = program.items[1:2]
    assert [lp.name for lp in program.loops()] == ["outer", "inner"]
    assert outer.body.loops()[0].counter is state["k"]
    asm = fakes.FakeAssembler()
    program.instantiate(asm)
    fm.reset_launch_counts()
    graphs.loop_iterations.clear()
    gl.launch_counts["set_while"] = 0
    program.replay()
    assert fm.snapshot_launch_counts() == want_counts
    assert graphs.loop_iterations == {k: v for k, v in want_iters.items() if v} or \
        not any(want_iters.values())
    assert all(torch.equal(state[k], eager[k]) for k in ("x", "y"))
    n_outer, n_inner = want_iters.get("outer", 0), want_iters.get("inner", 0)
    assert gl.launch_counts["set_while"] == 1 + 2 * n_outer + n_inner
    assert (n_outer > 0) == (stop > 0) and (n_outer == 4) == (stop == 10.0)

    first = next(i for kind, i in asm.log if kind == "segment")
    mark = {"enter": "<", "iteration": "|", "exit": ">"}
    tokens = " ".join(f"S{i - first}" if kind == "segment" else f"{mark[kind]}{i}"
                      for kind, i in asm.log)
    assert re.fullmatch(r"S0 <outer (\|outer S1 <inner (\|inner S2 )*>inner S3 )*>outer S4",
                        tokens), tokens
    assert asm.log.count(("enter", "inner")) == n_outer
    assert asm.log.count(("iteration", "outer")) == n_outer
    assert asm.log.count(("iteration", "inner")) == n_inner
    fm.reset_launch_counts()


def test_capture_program_aborts_cleanly_when_the_block_raises(monkeypatch):
    """An error inside a capture ends the capture, takes out what it counted
    and propagates: no fallback, no recorder left behind."""
    fakes.install(monkeypatch)
    fm.reset_launch_counts()
    with pytest.raises(RuntimeError, match="host read"):
        with graphs.capture_program(pool=object(), stream=object()):
            _launch("f32", 64, 1)
            raise RuntimeError("a host read inside the capture")
    assert fm.launch_counts["fused_sdf_raw_f32"]["launches"] == 0
    assert graphs._recorder is None


# ---------------------------------------------------------------------------
# the graphed step against JAX's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["exact", "mixed"])
def test_graphed_step_matches_jax(mode):
    """One step of the narrowed flagship through the graphed step's program
    (draws copied into its static buffers, alpha a tensor, the masked
    update) against JAX's ``build_train_step`` on the same weights, pixels
    and draws: loss terms, clipped gradients and the Adam update at
    ``torch_step_parity.EXACT`` (loss rtol 1e-4, gradients 1e-3 / 1e-5,
    update 1e-6)."""
    conf = tsp.narrow(flagship_conf(num_pixels=N_RAYS), mode, view="StyleModNFFB")
    jmodel, params, model, scene_np, pixel_idx = tsp.setup(conf, perturb=False)
    with contextlib.ExitStack() as stack:
        if mode == "mixed":
            stack.enter_context(tsp.jax_kernel_guidance(jmodel))
        jlosses, jgrads, jnew = tsp.jax_train_step(jmodel)(params, scene_np, pixel_idx)
    step = tr.build_train_step(model, IDRLossConfig(0.1, 200.0, ALPHA), tr.make_optimizer(model),
                               graphed=True)
    assert isinstance(step, tr.GraphedTrainStep) and not step.capture
    losses = step(scene_to_device(scene_np, "cpu"), torch.tensor([0]),
                  torch.as_tensor(pixel_idx).long(), None, ALPHA,
                  draws=tsp.draws(model, jax.random.PRNGKey(7), len(pixel_idx)))
    tsp.assert_step(tsp.step_metrics(model, {k: float(v) for k, v in losses.items()},
                                     jlosses, jgrads, jnew))
    assert step.skipped == 0

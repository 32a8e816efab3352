"""The tracer's loops on the port's ``while_loop`` (``utils/graphs.py``), on
the CPU: the loop helper against a plain loop and against JAX's
``lax.while_loop`` (counter and cap), the line search's backsteps from its
device counter against the per-k Python step, the march bit for bit
against the Python loops it replaced, and the whole tracer captured and
run as the card runs its while-nodes (``torch_graph_fakes``) against the
eager tracer.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hashmodnffbanks_idr_tpu_torch.models import ray_tracing as rt
from hashmodnffbanks_idr_tpu_torch.models.renderer import IDRNetwork
from hashmodnffbanks_idr_tpu_torch.ops import graph_loops as gl
from hashmodnffbanks_idr_tpu_torch.testing import flagship_conf, scene_to_device, synthetic_scene
from hashmodnffbanks_idr_tpu_torch.utils import graphs

import torch_graph_fakes as fakes
import torch_step_parity as tsp

N_RAYS = 64


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """The test workers share the cores: torch's default thread pool in
    each of them makes these CPU steps crawl."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _march_reference(cfg, sdf, cam, dirs, mask_intersect, near, far, *, iters, threshold,
                     resume=None):
    """The march as the port ran it before ``while_loop``: one Python loop
    per JAX ``lax.while_loop``, its predicate read on the host."""
    min_dis = torch.where(mask_intersect, near, 0.0)
    max_dis = torch.where(mask_intersect, far, 0.0)
    if resume is None:
        unfin_s = unfin_e = mask_intersect
        acc_s, acc_e = min_dis, max_dis
    else:
        acc_s, acc_e = resume
        unfin_s = unfin_e = mask_intersect & (acc_s < acc_e)

    pts_s0 = cam + acc_s[:, None] * dirs
    curr_pts = torch.where(unfin_s[:, None], pts_s0, 0.0)

    def sdf2(pa, pb):
        v = sdf(torch.cat([pa, pb], dim=0))
        return v[: pa.shape[0]], v[pa.shape[0]:]

    def clamp(v):
        return torch.where(v <= threshold, 0.0, v)

    s0, e0 = sdf2(pts_s0, cam + acc_e[:, None] * dirs)
    curr_s = clamp(torch.where(unfin_s, s0, 0.0))
    curr_e = clamp(torch.where(unfin_e, e0, 0.0))
    unfin_s = unfin_s & (curr_s > threshold)
    unfin_e = unfin_e & (curr_e > threshold)

    it = 0
    while it < iters and bool((unfin_s | unfin_e).any()):
        acc_s = acc_s + curr_s
        acc_e = acc_e - curr_e
        sv, ev = sdf2(cam + acc_s[:, None] * dirs, cam + acc_e[:, None] * dirs)
        next_s = torch.where(unfin_s, sv, 0.0)
        next_e = torch.where(unfin_e, ev, 0.0)
        k = 0
        not_ps, not_pe = next_s < 0, next_e < 0
        while k < cfg.line_step_iters and bool((not_ps | not_pe).any()):
            step = (1.0 - cfg.line_search_step) / (2.0**k)
            acc_s = torch.where(not_ps, acc_s - step * curr_s, acc_s)
            acc_e = torch.where(not_pe, acc_e + step * curr_e, acc_e)
            sv, ev = sdf2(cam + acc_s[:, None] * dirs, cam + acc_e[:, None] * dirs)
            next_s = torch.where(not_ps, sv, next_s)
            next_e = torch.where(not_pe, ev, next_e)
            not_ps, not_pe = next_s < 0, next_e < 0
            k += 1
        unfin_s = unfin_s & (acc_s < acc_e)
        unfin_e = unfin_e & (acc_s < acc_e)
        curr_s = clamp(torch.where(unfin_s, next_s, 0.0))
        curr_e = clamp(torch.where(unfin_e, next_e, 0.0))
        unfin_s = unfin_s & (curr_s > threshold)
        unfin_e = unfin_e & (curr_e > threshold)
        curr_pts = cam + acc_s[:, None] * dirs
        it += 1
    return curr_pts, unfin_s, acc_s, acc_e, min_dis, max_dis


# ---------------------------------------------------------------------------
# the loop helper
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("start,limit,max_iters", [(0, 5, 10), (0, 5, 3), (7, 5, 10), (0, 5, 0)])
def test_while_loop_matches_a_python_loop(start, limit, max_iters):
    """``while_loop`` against the plain loop it stands for: the same state,
    the same bodies in the same order with their indices, and the
    predicate read once an iteration while ``i < max_iters`` (exact)."""
    reads, calls = [], []

    def cond(st):
        reads.append(1)
        return st["x"] < limit

    def body(st, i):
        calls.append(i)
        st["x"].add_(1)
        st["y"].mul_(2)

    st = {"x": torch.tensor(start), "y": torch.tensor(1.0)}
    assert graphs.while_loop(cond, body, st, max_iters) is st

    x, y, i, want_reads = start, 1.0, 0, 0
    while i < max_iters and (want_reads := want_reads + 1) and x < limit:
        x, y, i = x + 1, y * 2, i + 1
    assert (int(st["x"]), float(st["y"])) == (x, y)
    assert calls == list(range(i)) and len(reads) == want_reads


# ---------------------------------------------------------------------------
# the march on the loop helper, bit for bit against the loop it replaced
# ---------------------------------------------------------------------------

def _tracer_case(kind):
    """A narrowed conf, its model with spread weights (so the march steps,
    backs up and stops at different iterations), and one step's rays."""
    if kind.startswith("flagship"):
        conf = tsp.narrow(flagship_conf(num_pixels=N_RAYS),
                          "mixed" if kind.endswith("mixed") else "exact", view="StyleModNFFB")
    else:
        conf = tsp.ngp_k3("mixed" if kind.endswith("mixed") else "exact")
    model = IDRNetwork(conf.get_config("model"), device="cpu", seed=3)
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for p in model.implicit_network.parameters():
            p.add_(0.01 * torch.randn(p.shape, generator=gen))
        # an SDF that overstates the distance: the march overshoots and the
        # line search backs up, up to its 3 steps
        last = model.implicit_network.lin[-1]
        last.g.mul_(3.0)
        last.b.mul_(3.0)
    scene = scene_to_device(synthetic_scene(n_views=2, img_res=(32, 32), seed=0), "cpu")
    pix = torch.randperm(32 * 32, generator=gen)[:N_RAYS]
    from hashmodnffbanks_idr_tpu_torch.geometry.cameras import get_camera_params
    dirs, cam = get_camera_params(scene["uv"][pix][None], scene["pose"][[1]],
                                  scene["intrinsics"][[1]])
    mask = scene["mask"][1][pix]
    draws = model.draw_uniforms(gen, N_RAYS, "cpu")
    return model, cam, dirs, mask, draws


@pytest.mark.parametrize("kind", ["flagship-exact", "flagship-mixed", "ngp-exact", "ngp-mixed"])
def test_march_on_while_loop_is_bit_identical_to_the_python_loop(kind, monkeypatch):
    """The whole tracer (plain march, and the guided march's phases A and
    B in 'mixed' and with level-pruned guidance) with the refactored
    ``_march`` and with the loop it replaced: every output bit-identical,
    and as many SDF calls."""
    model, cam, dirs, mask, draws = _tracer_case(kind)
    outs, calls, line_steps = {}, {}, []

    def counting_loop(cond, body, state, max_iters, per_iter=False):
        def counted_body(st, i):
            if per_iter:
                line_steps.append(i)
            body(st, i)
        return graphs.while_loop(cond, counted_body, state, max_iters, per_iter)

    monkeypatch.setattr(rt, "while_loop", counting_loop)
    for name, march in (("while_loop", rt._march), ("python", _march_reference)):
        monkeypatch.setattr(rt, "_march", march)
        with torch.no_grad():
            sdf, guidance = model._tracer_sdfs()
            n = [0]

            def counted(f):
                def g(x):
                    n[0] += 1
                    return f(x)
                return g

            assert model.has_coarse_guide() == bool(guidance and "coarse" in guidance)
            guidance = {k: counted(f) for k, f in (guidance or {}).items()} or None
            outs[name] = rt.ray_trace(model.ray_tracer, counted(sdf), cam, mask, dirs,
                                      sdf_guidance=guidance, draws=draws)
        calls[name] = n[0]
    for a, b in zip(outs["while_loop"], outs["python"]):
        assert torch.equal(a, b)
    assert calls["while_loop"] == calls["python"]
    # the line search ran (in the flagship cases to its last step)
    assert line_steps
    if kind.startswith("flagship"):
        assert max(line_steps) == model.ray_tracer.line_step_iters - 1




# ---------------------------------------------------------------------------
# the line search's counter and backstep table, the loop's counter and cap
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("line_search_step,line_step_iters",
                         [(0.5, 3), (0.3, 5), (1.0 / 3.0, 8), (0.9, 1)])
def test_line_search_steps_are_the_python_steps(line_search_step, line_step_iters):
    """The backstep table (``line_search_steps``) against the Python step
    ``(1 - line_search_step) / 2**k`` rounded to float32, bit for bit; one
    backstep taken through the counter on the device (``index_select`` at
    k = 0, mid-range and the last k) against the same update with the
    Python float, bit for bit; and k at ``line_step_iters``: a line search
    whose predicate never clears runs exactly ``line_step_iters`` bodies,
    reading k = 0, 1, ..., leaves its counter there, and ``set_while``'s
    math stops it."""
    cfg = rt.RayTracerConfig(line_search_step=line_search_step,
                             line_step_iters=line_step_iters)
    table = rt.line_search_steps(cfg, "cpu")
    want = torch.tensor([(1.0 - line_search_step) / 2.0**k for k in range(line_step_iters)],
                        dtype=torch.float32)
    assert table.dtype == torch.float32
    assert torch.equal(table.view(torch.int32), want.view(torch.int32))

    rng = np.random.default_rng(0)
    acc = torch.from_numpy(rng.uniform(0.5, 3.0, 257).astype(np.float32))
    curr = torch.from_numpy(rng.uniform(-0.1, 0.4, 257).astype(np.float32))
    for k in sorted({0, line_step_iters // 2, line_step_iters - 1}):
        got = acc - table.index_select(0, torch.tensor(k).reshape(1)) * curr
        ref = acc - ((1.0 - line_search_step) / 2.0**k) * curr
        assert torch.equal(got.view(torch.int32), ref.view(torch.int32)), k

    st = {"x": torch.zeros(()), "flag": torch.tensor(True)}
    seen = []

    def body(st, _):
        seen.append(int(st["k"]))
        st["x"].add_(table.index_select(0, st["k"].reshape(1))[0])

    graphs.while_loop(lambda st: st["flag"], body, st, line_step_iters, "k")
    assert seen == list(range(line_step_iters)) and int(st["k"]) == line_step_iters
    ref = torch.zeros(())
    for k in range(line_step_iters):
        ref.add_(want[k])
    assert torch.equal(st["x"], ref)
    assert not gl.set_while_plain(st["flag"], st["k"], line_step_iters,
                                  torch.zeros((), dtype=torch.int64), 1)


def _lax_loop(start, limit, max_iters):
    """JAX's loop: the cap in the condition, the counter in the carry."""
    def cond(c):
        i, x, _ = c
        return (i < max_iters) & (x < limit)

    def body(c):
        i, x, y = c
        return i + 1, x + 1, y * 2.0 + i

    i, x, y = jax.lax.while_loop(cond, body, (jnp.int32(0), jnp.int32(start), jnp.float32(1.0)))
    return int(i), int(x), float(y)


def _torch_loop(st, limit, max_iters):
    """The same loop on ``while_loop``; the body reads the counter."""
    def body(st, _):
        st["x"].add_(1)
        st["y"].copy_(st["y"] * 2.0 + st["i"])

    return graphs.while_loop(lambda st: st["x"] < limit, body, st, max_iters, "i")


@pytest.mark.parametrize("start,limit,max_iters", [(0, 5, 10), (0, 5, 3), (7, 5, 10), (0, 5, 0)])
def test_while_loop_counter_and_cap_match_lax_while_loop(start, limit, max_iters, monkeypatch):
    """One loop whose body reads its counter, eager (the predicate read on
    the host) and captured then run as the card runs a while-node (the
    fakes: the condition set before the node and after each body), against
    ``lax.while_loop`` on the CPU with the same condition, body and cap: the
    state, the counter and the iterations (the host's count, the device
    total folded in) equal, exactly, over a loop that runs to its predicate,
    one cut by the cap, one whose predicate fails at once and one of cap 0;
    a second launch from the same inputs runs the same iterations again."""
    i, x, y = _lax_loop(start, limit, max_iters)

    graphs.loop_iterations.clear()
    eager = _torch_loop({"x": torch.tensor(start), "y": torch.tensor(1.0)}, limit, max_iters)
    assert (int(eager["x"]), float(eager["y"])) == (x, y)
    assert int(eager.get("i", 0)) == i and graphs.loop_iterations.get("body", 0) == i

    fakes.install(monkeypatch)
    st = {"x": torch.tensor(start), "y": torch.tensor(1.0)}
    with graphs.capture_program(pool=object(), stream=object()) as program:
        _torch_loop(st, limit, max_iters)
    program.instantiate(fakes.FakeAssembler())
    assert len(program.loops()) == (max_iters > 0)
    graphs.loop_iterations.clear()
    for launch in (1, 2):
        st["x"].fill_(start)   # the inputs, as the step fills its static buffers
        st["y"].fill_(1.0)
        program.replay()
        graphs.fold_device_counts()
        assert (int(st["x"]), float(st["y"])) == (x, y)
        assert int(st.get("i", 0)) == i
        assert graphs.loop_iterations.get("body", 0) == launch * i


# ---------------------------------------------------------------------------
# the tracer captured and run as while-nodes, against the eager tracer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["flagship-exact", "flagship-mixed", "ngp-exact", "ngp-mixed"])
def test_tracer_on_device_loops_matches_the_eager_tracer(kind, monkeypatch):
    """The whole tracer (both march phases in the guided cases, the line
    search nested in the march) captured into a program and run, twice, as
    the card runs the assembled graph (the fakes): every output bit-identical
    to the eager tracer's, each loop's iterations (device totals folded in)
    equal to the eager loop's, the line search entered once per march
    iteration, and the march a while-node of the top graph with the line
    search nested in its body."""
    model, cam, dirs, mask, draws = _tracer_case(kind)
    with torch.no_grad():
        sdf, guidance = model._tracer_sdfs()

        def trace():
            return rt.ray_trace(model.ray_tracer, sdf, cam, mask, dirs, sdf_guidance=guidance,
                                draws=draws)

        graphs.loop_iterations.clear()
        want = trace()
        eager = dict(graphs.loop_iterations)
        fakes.install(monkeypatch)
        with graphs.capture_program(pool=object(), stream=object()) as program:
            got = trace()
        asm = fakes.FakeAssembler()
        program.instantiate(asm)
        graphs.loop_iterations.clear()
        for launch in (1, 2):
            program.replay()
            graphs.fold_device_counts()
            for a, b in zip(got, want):
                assert torch.equal(a, b)
            assert graphs.loop_iterations == {k: launch * v for k, v in eager.items()}
    assert eager["march_body"] > 0 and eager["line_body"] > 0
    marches = [lp for lp in program.items if isinstance(lp, graphs._Loop)]
    assert [lp.name for lp in marches] == ["march_body"] * (2 if guidance and "march" in guidance
                                                           else 1)
    for lp in marches:
        assert [inner.name for inner in lp.body.loops()] == ["line_body"]
    entered = [e for e in asm.log if e == ("enter", "line_body")]
    assert len(entered) == 2 * eager["march_body"]

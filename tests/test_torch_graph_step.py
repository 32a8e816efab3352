"""The graphed train step's parts on the CPU: the port's ``while_loop``, the
march refactored onto it, the masked update, the step's static inputs, the
launch accounting of a replayed program, and the step against JAX's.

On the CPU ``build_train_step(graphed=True)`` runs the graphed step's
program eagerly (no capture): the same static buffers, draws taken before
the program, the same masked update.  Its replays from CUDA graphs are held
against the eager step on the card (``tests/test_torch_cuda.py``).
"""

import contextlib

import jax
import numpy as np
import pytest
import torch

from hashmodnffbanks_idr_tpu_torch.models import loss as tloss
from hashmodnffbanks_idr_tpu_torch.models import ray_tracing as rt
from hashmodnffbanks_idr_tpu_torch.models.loss import IDRLossConfig
from hashmodnffbanks_idr_tpu_torch.models.renderer import IDRNetwork
from hashmodnffbanks_idr_tpu_torch.ops import fused_mlp as fm
from hashmodnffbanks_idr_tpu_torch.testing import flagship_conf, scene_to_device, synthetic_scene
from hashmodnffbanks_idr_tpu_torch.train import trainer as tr
from hashmodnffbanks_idr_tpu_torch.utils import graphs

import torch_step_parity as tsp

ALPHA = 50.0
N_RAYS = 64


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
# the graphed step's program, run eagerly, against the eager step
# ---------------------------------------------------------------------------

def _step_case(cameras=False, seed=0):
    conf = tsp.narrow(flagship_conf(num_pixels=N_RAYS), "exact", view="SHEncoder")
    model = IDRNetwork(conf.get_config("model"), device="cpu", seed=seed)
    scene_np = synthetic_scene(n_views=3, img_res=(32, 32), seed=0)
    pose_vecs = cam_opt = None
    if cameras:
        from hashmodnffbanks_idr_tpu_torch.geometry.cameras import rot_to_quat
        poses = scene_np["pose"]
        pose_vecs = torch.tensor(np.concatenate(
            [rot_to_quat(poses[:, :3, :3].astype(np.float64)), poses[:, :3, 3]], axis=1),
            dtype=torch.float32, requires_grad=True)
        cam_opt = tr.sparse_adam_init(pose_vecs)
    return model, scene_to_device(scene_np, "cpu"), pose_vecs, cam_opt


def _build(model, pose_vecs, cam_opt, graphed):
    return tr.build_train_step(model, IDRLossConfig(0.1, 200.0, ALPHA), tr.make_optimizer(model),
                               pose_vecs=pose_vecs, cam_opt=cam_opt, graphed=graphed)


def _state(model, step, pose_vecs, cam_opt):
    """Every tensor a step may write, cloned."""
    out = {f"param/{n}": p.detach().clone() for n, p in model.named_parameters()}
    for i, p in enumerate(step.optimizer.state if hasattr(step, "optimizer") else ()):
        for k, v in step.optimizer.state[p].items():
            out[f"adam/{i}/{k}"] = v.clone()
    if pose_vecs is not None:
        out["pose_vecs"] = pose_vecs.detach().clone()
        out.update({f"cam_opt/{k}": v.clone() for k, v in cam_opt.items()})
    return out


def _bits_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(
            a[k].view(torch.int32) if a[k].dtype == torch.float32 else a[k],
            b[k].view(torch.int32) if b[k].dtype == torch.float32 else b[k]), k


@pytest.mark.parametrize("cameras", [False, True])
def test_graphed_step_with_finite_gradients_equals_the_eager_step(cameras):
    """Three steps from the same weights and generator, the graphed step
    taking its draws before its program: loss terms, parameters, Adam state
    and (with cameras) the pose table and SparseAdam state bit-identical to
    the eager step's, and nothing skipped."""
    results = {}
    for graphed in (False, True):
        model, scene, pose_vecs, cam_opt = _step_case(cameras)
        step = _build(model, pose_vecs, cam_opt, graphed)
        gen = torch.Generator().manual_seed(11)
        losses = []
        for i in range(3):
            pix = torch.randperm(32 * 32, generator=gen)[:N_RAYS]
            losses.append(step(scene, torch.tensor([i % 3]), pix, gen, ALPHA))
        results[graphed] = (losses, {f"param/{n}": p.detach().clone()
                                     for n, p in model.named_parameters()},
                            step.skipped, pose_vecs, cam_opt)
    (l_e, p_e, s_e, pv_e, co_e), (l_g, p_g, s_g, pv_g, co_g) = results[False], results[True]
    assert s_e == s_g == 0
    for a, b in zip(l_e, l_g):
        assert list(a) == list(b)
        for k in a:
            assert torch.equal(a[k], b[k]), k
    _bits_equal(p_e, p_g)
    if cameras:
        assert torch.equal(pv_e, pv_g)
        for k in co_e:
            assert torch.equal(co_e[k], co_g[k]), k


@pytest.mark.parametrize("cameras", [False, True])
def test_graphed_step_adam_state_equals_the_eager_steps(cameras):
    """The Adam moments and step counts after two steps, graphed (state made
    before its first update) against eager (state made by Adam): equal bit
    for bit."""
    states = {}
    for graphed in (False, True):
        model, scene, pose_vecs, cam_opt = _step_case(cameras, seed=1)
        opt = tr.make_optimizer(model)
        step = tr.build_train_step(model, IDRLossConfig(0.1, 200.0, ALPHA), opt,
                                   pose_vecs=pose_vecs, cam_opt=cam_opt, graphed=graphed)
        gen = torch.Generator().manual_seed(5)
        for i in range(2):
            step(scene, torch.tensor([i]), torch.randperm(1024, generator=gen)[:N_RAYS], gen,
                 ALPHA)
        states[graphed] = {f"{n}/{k}": v.clone() for n, p in model.named_parameters()
                           for k, v in opt.state.get(p, {}).items()}
    _bits_equal(states[False], states[True])


@pytest.mark.parametrize("cameras,poison", [(False, "nan"), (False, "inf"), (True, "nan"),
                                            (True, "inf"), (True, "camera-nan")])
def test_masked_update_skips_a_nonfinite_step(cameras, poison):
    """A finite step, then one whose gradient is made NaN or inf (a hook on
    the SDF's last layer; with cameras also a NaN pose gradient alone): the
    parameters, Adam's moments and step counts, and with cameras the pose
    table and SparseAdam's state are bit-unchanged, the device counter
    reads one more, the loss terms of the skipped step are kept; the next
    finite step updates again."""
    model, scene, pose_vecs, cam_opt = _step_case(cameras, seed=2)
    step = _build(model, pose_vecs, cam_opt, graphed=True)
    gen = torch.Generator().manual_seed(9)
    pix = torch.randperm(1024, generator=gen)[:N_RAYS]
    step(scene, torch.tensor([0]), pix, gen, ALPHA)
    before = _state(model, step, pose_vecs, cam_opt)
    bad = float("nan") if "nan" in poison else float("inf")
    target = pose_vecs if poison == "camera-nan" else model.implicit_network.lin[-1].v
    handle = target.register_hook(lambda g: torch.full_like(g, bad))
    losses = step(scene, torch.tensor([1]), pix, gen, ALPHA)
    handle.remove()
    _bits_equal(before, _state(model, step, pose_vecs, cam_opt))
    assert step.skipped == 1
    kept = step.last_skipped_terms()
    assert list(kept) == list(losses)
    assert kept == pytest.approx({k: float(v) for k, v in losses.items()})
    step(scene, torch.tensor([2]), pix, gen, ALPHA)
    assert step.skipped == 1
    after = _state(model, step, pose_vecs, cam_opt)
    assert not torch.equal(after["param/implicit_network.lin.0.v"],
                           before["param/implicit_network.lin.0.v"])


def test_tensor_lr_and_alpha_match_float_ones():
    """Adam with a tensor learning rate against a float one (three steps of
    the same gradients, ``set_lr`` changing it between them), and the mask
    loss with a 0-d tensor alpha against a float one: bit-identical."""
    gen = torch.Generator().manual_seed(0)
    grads = [torch.randn(5, 7, generator=gen) for _ in range(3)]
    init = torch.randn(5, 7, generator=gen)
    out = {}
    for kind in ("float", "tensor"):
        p = torch.nn.Parameter(init.clone())
        lr = 1e-3 if kind == "float" else torch.tensor(1e-3)
        opt = torch.optim.Adam([p], lr=lr, betas=(0.9, 0.999), eps=1e-8)
        for i, g in enumerate(grads):
            tr.set_lr(opt, 1e-3 * 0.5 ** i)
            p.grad = g.clone()
            opt.step()
        assert torch.is_tensor(opt.param_groups[0]["lr"]) == (kind == "tensor")
        out[kind] = p.detach().clone()
    assert torch.equal(out["float"], out["tensor"])

    sdf = torch.randn(64, 1, generator=gen) * 0.1
    net, obj = torch.rand(64, generator=gen) > 0.5, torch.rand(64, generator=gen) > 0.5
    for alpha in (50.0, 100.0, 800.0):
        want = tloss.mask_loss(sdf, net, obj, alpha, 64.0)
        got = tloss.mask_loss(sdf, net, obj, torch.tensor(alpha), 64.0)
        assert torch.equal(want, got), alpha


def test_checkpoint_keeps_the_optimizers_learning_rate(tmp_path):
    """A checkpoint's optimizer state loaded into an optimizer with a tensor
    learning rate keeps that tensor (the graphed step holds its address)
    and gives it the saved value; a float-rate optimizer stays float."""
    from hashmodnffbanks_idr_tpu_torch.train import checkpoints as ckpt

    model, _, _, _ = _step_case()
    opt = tr.make_optimizer(model, lr=3e-4)
    ckpt.save_checkpoint(str(tmp_path), 1, model, opt, 5)
    params = list(model.parameters())
    lr = torch.tensor(1e-4)
    other = torch.optim.Adam(params, lr=lr)
    ckpt.load_checkpoint(str(tmp_path), "latest", model, other)
    assert other.param_groups[0]["lr"] is lr and float(lr) == pytest.approx(3e-4)
    plain = torch.optim.Adam(params, lr=1e-4)
    ckpt.load_checkpoint(str(tmp_path), "latest", model, plain)
    assert plain.param_groups[0]["lr"] == pytest.approx(3e-4)


# ---------------------------------------------------------------------------
# the launch accounting of a captured program, under a fake capture
# ---------------------------------------------------------------------------

class _FakeGraph:
    """Stands in for ``torch.cuda.CUDAGraph``: records its replays."""

    def __init__(self):
        self.replays = 0
        self.on_replay = None

    def replay(self):
        self.replays += 1
        if self.on_replay is not None:
            self.on_replay(self)


@contextlib.contextmanager
def _fake_capture(graph, pool=None, stream=None):
    yield


def _launch(variant, n, cluster):
    """What ``fused_mlp._launch`` counts for one launch."""
    c = fm.launch_counts[f"fused_sdf_raw_{variant}"]
    c["launches"] += 1
    c["points"] += n
    c[f"cluster_{cluster}"] += 1


def test_replayed_program_counts_the_launches_its_capture_recorded(monkeypatch):
    """A program of a graph, a loop and a graph, captured under a fake
    capture: what the capture counted is taken out when each graph's
    capture ends, and each replay adds its graph's launches (per variant,
    points and cluster size); the loop replays its body while its
    predicate holds, reading it once an iteration."""
    monkeypatch.setattr(graphs.torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(graphs.torch.cuda, "graph", _fake_capture)
    fm.reset_launch_counts()
    flag = torch.tensor(True)
    reads = []

    class Pred:
        def __bool__(self):
            reads.append(bool(flag))
            return bool(flag)

    state = {"x": torch.zeros(())}

    def body(st, _):
        _launch("bf16", 4096, 2)

    with graphs.capture_program(pool=object(), stream=object()) as program:
        _launch("f32", 2048, 2)
        graphs.while_loop(lambda st: Pred(), body, state, max_iters=5)
        _launch("f32", 49152, 1)
    assert all(v == 0 for c in fm.launch_counts.values() for v in c.values())
    assert program.graphs() == 3

    body_graph = program.items[1].bodies[0].items[0].graph
    body_graph.on_replay = lambda g: flag.fill_(g.replays < 3)
    program.replay()
    f32, bf16 = fm.launch_counts["fused_sdf_raw_f32"], fm.launch_counts["fused_sdf_raw_bf16"]
    assert (f32["launches"], f32["points"], f32["cluster_1"], f32["cluster_2"]) == \
        (2, 2048 + 49152, 1, 1)
    assert (bf16["launches"], bf16["points"], bf16["cluster_2"]) == (3, 3 * 4096, 3)
    assert reads == [True, True, True, False]

    flag.fill_(True)
    body_graph.on_replay = None
    reads.clear()
    program.replay()   # the body every time: max_iters cuts the loop, no read past it
    assert fm.launch_counts["fused_sdf_raw_bf16"]["launches"] == 3 + 5
    assert reads == [True] * 5
    fm.reset_launch_counts()


def test_capture_program_aborts_cleanly_when_the_block_raises(monkeypatch):
    """An error inside a capture ends the capture, takes out what it counted
    and propagates: no fallback, no recorder left behind."""
    monkeypatch.setattr(graphs.torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(graphs.torch.cuda, "graph", _fake_capture)
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

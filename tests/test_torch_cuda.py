"""The port's CUDA kernel on the card, against its plain twin.

These tests need an NVIDIA GPU and skip without one.  They import nothing of
JAX, so they also run on a machine without it:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

(``--noconftest`` skips ``tests/conftest.py``, which sets JAX up.)  The last
tests hold the train step replayed from CUDA graphs against the eager step.
"""

import numpy as np
import pytest
import torch

from hashmodnffbanks_idr_tpu_torch.models.networks import ImplicitNetwork
from hashmodnffbanks_idr_tpu_torch.ops import fused_mlp as fm
from hashmodnffbanks_idr_tpu_torch.utils.debug import deterministic

pytestmark = pytest.mark.cuda

# the flagship SDF network (testing.py:flagship_conf): d_in 59, 8x512, skip at 4
NET_KW = dict(feature_vector_size=256, d_in=3, d_out=1, dims=[512] * 8,
              geometric_init=True, bias=0.6, skip_in=[4], weight_norm=True,
              multires=6, embed_type="StyleModNFFB", log2_max_hash_size=5,
              max_points_per_entry=2, base_resolution=16, desired_resolution=512,
              bound=0.45)
# GPU expf/log1pf and the summation order differ from the CPU's; bf16 operands
TOL = {"f32": 1e-5, "bf16": 3e-2}
DTYPE = {"f32": torch.float32, "bf16": torch.bfloat16}
# each variant: the edges of its tiles (csrc/fused_mlp.cu, f32::TM, 64
# points; bf16k::Split<C>::TM, 64 points at C = 1 and 128 at C = 4)
# and the tracer's batch sizes up to its largest call (on the H100 the rule
# runs the f32 kernel's 2048 and up on clusters of 2)
F32_TILE = 64
BF16_TILES = (64, 128)
CHECK_N = {"f32": (1, F32_TILE - 1, F32_TILE, F32_TILE + 1, 513, 2048, 4096, 49152),
           "bf16": (1,) + tuple(n for t in BF16_TILES for n in (t - 1, t, t + 1))
           + (513, 4096, 49152, 69632)}
# the f32 kernel at every compiled depth and cluster size against its plain
# twin at the main path's sizes (chip_smoke.py F32_HELD_N)
F32_HELD_N = (256, 2048, 4096, 24576, 49152, 69632)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


@pytest.fixture
def net(cuda_device):
    net = ImplicitNetwork(**NET_KW)
    net.reset_parameters(torch.Generator().manual_seed(0))
    return net.to(cuda_device)


def _points(net, n, seed):
    """Embedded points of the tracer's box, on the net's device."""
    rng = np.random.default_rng(seed)
    pts = torch.from_numpy(rng.uniform(-0.6, 0.6, (n, 3)).astype(np.float32))
    with torch.no_grad():
        return net._embed(pts.to(net.lin[0].b.device)).contiguous()


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_cuda_kernel_matches_plain(net, precision):
    packed = fm.pack_params(net.lin, 59, 512, dtype=DTYPE[precision])
    for n in CHECK_N[precision]:
        x = _points(net, n, seed=n)
        fm.reset_launch_counts()
        got = fm.fused_sdf_raw(x, packed)
        want = fm.fused_sdf_raw_plain(x, packed)
        torch.cuda.synchronize()
        counts = fm.launch_counts[f"fused_sdf_raw_{precision}"]
        assert (counts["launches"], counts["points"]) == (1, n)
        assert got.shape == (n,)
        assert float((got - want).abs().max()) <= TOL[precision]
        if precision == "bf16":
            big = want.abs() > 5e-2
            assert bool((torch.sign(got[big]) == torch.sign(want[big])).all())


def test_cuda_wrapper_refuses_what_the_kernel_does_not_take(net):
    packed = fm.pack_params(net.lin, 59, 512, dtype=torch.float32)
    x = _points(net, 8, seed=0)
    with pytest.raises(ValueError):
        fm.fused_sdf_raw(x.double(), packed)                    # dtype
    with pytest.raises(ValueError):
        fm.fused_sdf_raw(x[:, :58].contiguous(), packed)        # width
    with pytest.raises(ValueError):
        fm.fused_sdf_raw(x.t().contiguous().t(), packed)        # layout
    with pytest.raises(ValueError):
        fm.fused_sdf_raw(x, dict(packed, b_in=packed["b_in"].cpu()))  # device
    for dtype in DTYPE.values():                                # cluster size
        with pytest.raises(ValueError):
            fm._launch(x, fm.pack_params(net.lin, 59, 512, dtype=dtype), cluster=3)
    with pytest.raises(ValueError):                             # f32: no C = 1
        fm._launch(x, packed, cluster=1)
    bf16 = fm.pack_params(net.lin, 59, 512, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="cluster must be one of"):  # bf16: no C = 2
        fm._launch(x, bf16, cluster=2)
    with pytest.raises(ValueError, match="w_img"):              # bf16: no weight stream
        fm._launch(x, {k: v for k, v in bf16.items() if k != "w_img"})


def test_cuda_bf16_pack_holds_only_the_kernels_stream(net):
    """On the card a bf16 pack holds the kernel's weight stream ``w_img``
    and no ``w_in``/``w_mid`` beside it (no second copy of the weights a
    step); read back (``plain_pack``), they are the layers' weights in
    bf16."""
    packed = fm.pack_params(net.lin, 59, 512, dtype=torch.bfloat16)
    assert "w_img" in packed and not {"w_in", "w_mid"} & set(packed)
    back = fm.plain_pack(packed, 59)
    with torch.no_grad():
        assert torch.equal(back["w_in"], net.lin[0].weight().T.bfloat16())
        assert torch.equal(back["w_mid"][0], net.lin[1].weight().T.bfloat16())


@pytest.mark.parametrize("cluster", [2, 4])
def test_cuda_f32_cluster_matches_c1_bit_for_bit(net, cluster):
    """Each cluster size the f32 kernel compiles (the CTAs that share a
    64-point tile through distributed shared memory) within the f32
    tolerance of the plain twin and equal to the launch at its smallest C
    (2; it has no C = 1) bit for bit, since every column keeps its k order
    and fold grouping; at the tile's edges, the secant's and the march's
    sizes and one past them."""
    packed = fm.pack_params(net.lin, 59, 512, dtype=torch.float32)
    smallest = fm.cluster_sizes("fused_sdf_raw_f32")[0]
    for n in (1, F32_TILE - 1, F32_TILE, F32_TILE + 1, 2048, 2049, 4096, 4113):
        x = _points(net, n, seed=n)
        fm.reset_launch_counts()
        got = fm._launch(x, packed, cluster=cluster)
        ref = fm._launch(x, packed, cluster=smallest)
        want = fm.fused_sdf_raw_plain(x, packed)
        torch.cuda.synchronize()
        counts = fm.launch_counts["fused_sdf_raw_f32"]
        assert counts[f"cluster_{cluster}"] == (2 if cluster == smallest else 1)
        assert float((got - want).abs().max()) <= TOL["f32"], n
        assert torch.equal(got.view(torch.int32), ref.view(torch.int32)), n


@pytest.mark.parametrize("d_in", [59, 102, 198, 510])
def test_cuda_f32_every_depth_and_cluster_at_the_main_paths_sizes(cuda_device, d_in):
    """The f32 kernel at each compiled first-layer depth (K0 64, 128, 256,
    512), its input weights spread so that every input column counts, and
    each cluster size it compiles: within 1e-5 of the plain twin at the
    main path's sizes, each C bit-identical to the smallest."""
    kw = {59: {}, **DEPTH_KW}[d_in]
    net = ImplicitNetwork(**{**NET_KW, **kw})
    net.reset_parameters(torch.Generator().manual_seed(d_in))
    net = net.to(cuda_device)
    assert net.dims[0] == d_in
    with torch.no_grad():
        for l in (0, *net.skip_in):
            net.lin[l].v.add_(0.03 * torch.randn(net.lin[l].v.shape, device=cuda_device,
                                                 generator=torch.Generator(cuda_device)
                                                 .manual_seed(l)))
    packed = fm.pack_params(net.lin, d_in, 512, dtype=torch.float32)
    sizes = fm.cluster_sizes("fused_sdf_raw_f32")
    for n in F32_HELD_N:
        x = _points(net, n, seed=n)
        want = fm.fused_sdf_raw_plain(x, packed)
        got = {c: fm._launch(x, packed, cluster=c) for c in sizes}
        torch.cuda.synchronize()
        for c, out in got.items():
            assert float((out - want).abs().max()) <= TOL["f32"], (n, c)
            assert torch.equal(out.view(torch.int32), got[sizes[0]].view(torch.int32)), (n, c)


@pytest.mark.parametrize("cluster", [1, 4])
def test_cuda_bf16_cluster_matches_c1_bit_for_bit(net, cluster):
    """The bf16 kernel at each configuration (a 64-point tile at C = 1, a
    128-point tile at C = 4): within the bf16 tolerance of the plain
    twin with the signs agreeing, and equal to the C = 1 launch bit for bit
    (every column keeps its k order and its k16 grouping); at the tiles'
    edges and the variant's batch sizes."""
    packed = fm.pack_params(net.lin, 59, 512, dtype=torch.bfloat16)
    for n in CHECK_N["bf16"]:
        x = _points(net, n, seed=n)
        fm.reset_launch_counts()
        got = fm._launch(x, packed, cluster=cluster)
        ref = fm._launch(x, packed, cluster=1)
        want = fm.fused_sdf_raw_plain(x, packed)
        torch.cuda.synchronize()
        counts = fm.launch_counts["fused_sdf_raw_bf16"]
        assert counts[f"cluster_{cluster}"] == (2 if cluster == 1 else 1)
        assert float((got - want).abs().max()) <= TOL["bf16"], n
        big = want.abs() > 5e-2
        assert bool((torch.sign(got[big]) == torch.sign(want[big])).all()), n
        assert torch.equal(got.view(torch.int32), ref.view(torch.int32)), n


def _takes_the_rules_cluster_size(net, precision, sizes):
    packed = fm.pack_params(net.lin, 59, 512, dtype=DTYPE[precision])
    name = f"fused_sdf_raw_{precision}"
    slots = fm.cluster_slots(name, fm.kernel_depth(59), net.lin[0].b.device)
    assert all(slots[c] >= c for c in fm.cluster_sizes(name)), slots
    for n in sizes:
        fm.reset_launch_counts()
        fm.fused_sdf_raw(_points(net, n, seed=n), packed)
        torch.cuda.synchronize()
        want = fm.cluster_size(n, slots, fm.WAVE_MS[name], fm.TILES[name])
        assert fm.launch_counts[name][f"cluster_{want}"] == 1, (n, want)


def test_cuda_f32_wrapper_takes_the_rules_cluster_size(net):
    """The card seats a cluster of each size (the occupancy query), and the
    wrapper launches the size that ``cluster_size`` gives for N."""
    _takes_the_rules_cluster_size(net, "f32", (256, 2048, 4096, 49152, 69632))


def test_cuda_bf16_wrapper_takes_the_rules_cluster_size(net):
    """The same for the bf16 kernel, at its calls on the main path."""
    _takes_the_rules_cluster_size(net, "bf16", (256, 2048, 4096, 24576, 49152, 69632))


# every encoder's first-layer depth (chip_smoke.py CHECK_D_IN): the kernel
# depth the wrapper picks and the zero rows past d_in.  No conf gives a depth
# past 128; NerfPos at multires 32 (198) and 84 (510) holds K0 256 and 512
DEPTH_KW = {9: dict(embed_type="FourierFeatures"), 15: dict(embed_type="HashGridTcnn",
                                                            log2_max_hash_size=15),
            27: dict(embed_type="HashGrid"), 102: dict(embed_type="NerfPos", multires=16),
            198: dict(embed_type="NerfPos", multires=32),
            510: dict(embed_type="NerfPos", multires=84)}


@pytest.mark.parametrize("d_in", sorted(DEPTH_KW))
@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_cuda_kernel_matches_plain_at_every_depth(cuda_device, precision, d_in):
    """With the geometric init, whose first-layer and skip weights past the
    3 coordinates are zero, and again with those weights spread, so that
    every input column counts; at N=4096 at every cluster size, each equal
    to the smallest C bit for bit (bf16: the signs agreeing)."""
    assert fm.kernel_depth(d_in) == max(64, 1 << (d_in - 1).bit_length())
    torch.manual_seed(d_in)
    net = ImplicitNetwork(**{**NET_KW, **DEPTH_KW[d_in]})
    net.reset_parameters(torch.Generator().manual_seed(d_in))
    net = net.to(cuda_device)
    assert net.dims[0] == d_in
    for spread in (False, True):
        if spread:
            with torch.no_grad():
                for l in (0, *net.skip_in):
                    net.lin[l].v.add_(0.03 * torch.randn_like(net.lin[l].v))
        packed = fm.pack_params(net.lin, d_in, 512, dtype=DTYPE[precision])
        for n in (1, 65, 4096):
            x = _points(net, n, seed=n)
            got = fm.fused_sdf_raw(x, packed)
            want = fm.fused_sdf_raw_plain(x, packed)
            torch.cuda.synchronize()
            assert float((got - want).abs().max()) <= TOL[precision], (spread, n)
        big = want.abs() > 5e-2
        sizes = fm.cluster_sizes(f"fused_sdf_raw_{precision}")
        ref = fm._launch(x, packed, cluster=sizes[0])
        for c in sizes:
            got = fm._launch(x, packed, cluster=c)
            torch.cuda.synchronize()
            assert float((got - want).abs().max()) <= TOL[precision], (spread, c)
            assert bool((torch.sign(got[big]) == torch.sign(want[big])).all()), (spread, c)
            assert torch.equal(got.view(torch.int32), ref.view(torch.int32)), (spread, c)


def test_cuda_pose7_step_matches_cpu(cuda_device):
    """One trainable-camera step of the flagship at full width (exact tracer
    through the f32 kernel, 64 rays) on the card and on the CPU from the
    same weights, pose table and draws: hit masks equal, loss terms within
    1e-5, the pose gradient and SparseAdam's first moment within 1e-4 of
    their largest entry, the poses after the step within 1e-6 wherever |g|
    exceeds 2e-4 of the largest (there the first step is lr * sign(g) on
    both sides); the f32 kernel ran.  The same bounds as ``chip_smoke.py``'s
    ``[cameras]`` step."""
    from hashmodnffbanks_idr_tpu_torch.geometry.cameras import rot_to_quat
    from hashmodnffbanks_idr_tpu_torch.models.loss import IDRLossConfig
    from hashmodnffbanks_idr_tpu_torch.models.renderer import IDRNetwork
    from hashmodnffbanks_idr_tpu_torch.testing import (flagship_conf, scene_to_device,
                                                       synthetic_scene)
    from hashmodnffbanks_idr_tpu_torch.train.trainer import (build_train_step, make_optimizer,
                                                             sparse_adam_init)

    n_rays, lr_cam = 64, 1e-4
    conf = flagship_conf(num_pixels=n_rays)
    conf.put("model.tracer_exact_fused", True)
    scene_np = synthetic_scene(n_views=3, img_res=(64, 64), seed=0)
    poses = scene_np["pose"]
    pose0 = np.concatenate([rot_to_quat(poses[:, :3, :3].astype(np.float64)),
                            poses[:, :3, 3]], axis=1).astype(np.float32)
    g = torch.Generator().manual_seed(5)
    pix = torch.randperm(64 * 64, generator=g)[:n_rays]
    draws = {"coarse": torch.rand(12, generator=g), "fine": torch.rand(24, generator=g),
             "eik": torch.rand(n_rays // 2, 3, generator=g) * 2 - 1}
    out = {}
    for device in (cuda_device, torch.device("cpu")):
        model = IDRNetwork(conf.get_config("model"), device=device, seed=0)
        pose_vecs = torch.tensor(pose0, device=device, requires_grad=True)
        cam_opt = sparse_adam_init(pose_vecs)
        step = build_train_step(model, IDRLossConfig(0.1, 200.0, 50.0), make_optimizer(model),
                                pose_vecs=pose_vecs, cam_opt=cam_opt, lr_cam=lr_cam)
        captured = {}
        model.register_forward_hook(lambda m, a, o: captured.update(o))
        fm.reset_launch_counts()
        losses = step(scene_to_device(scene_np, device), torch.tensor([1], device=device),
                      pix.to(device), None, 50.0,
                      draws={k: v.to(device) for k, v in draws.items()})
        launches = fm.snapshot_launch_counts()["fused_sdf_raw_f32"]["launches"]
        out[device.type] = ({k: float(v) for k, v in losses.items()}, pose_vecs.grad.cpu(),
                            pose_vecs.detach().cpu(), launches, int(cam_opt["step"]),
                            cam_opt["m"].cpu(), captured["network_object_mask"].cpu())
    (l_gpu, g_gpu, p_gpu, n_gpu, s_gpu, m_gpu, hit_gpu), \
        (l_cpu, g_cpu, p_cpu, n_cpu, s_cpu, m_cpu, hit_cpu) = out["cuda"], out["cpu"]
    assert n_gpu > 0 and n_cpu == 0 and s_gpu == s_cpu == 1
    assert torch.equal(hit_gpu, hit_cpu) and hit_cpu.any()
    for k in l_cpu:
        assert abs(l_gpu[k] - l_cpu[k]) <= 1e-5 * abs(l_cpu[k]), (k, l_gpu[k], l_cpu[k])
    gmax = float(g_cpu.abs().max())
    grad_err = float((g_gpu - g_cpu).abs().max())
    assert gmax > 0 and grad_err <= 1e-4 * gmax, (grad_err, gmax)
    assert float((m_gpu - m_cpu).abs().max()) <= 1e-4 * float(m_cpu.abs().max())
    clear = g_cpu.abs() > 2e-4 * gmax
    assert clear.any()
    assert float((p_gpu - p_cpu)[clear].abs().max()) <= 1e-6
    assert torch.equal(p_gpu[[0, 2]], torch.from_numpy(pose0)[[0, 2]])


# ---------------------------------------------------------------------------
# the graphed train step against the eager one
# ---------------------------------------------------------------------------

GRAPH_RAYS = 512
# (tracer_fast, tracer_exact_fused, the kernel its tracer launches)
# the tracer settings of the flagship steps: (tracer_fast,
# tracer_exact_fused, the fused kernels a step launches); the mixed tracer
# decides on the f32 kernel and guides on the bf16 one
TRACER_MODES = {"exact+fused": ("exact", True, ("fused_sdf_raw_f32",)),
                "mixed": ("mixed", False, ("fused_sdf_raw_bf16", "fused_sdf_raw_f32")),
                "exact": ("exact", False, ()),
                "fast": ("fast", False, ("fused_sdf_raw_bf16",))}
GRAPH_MODES = {k: TRACER_MODES[k] for k in ("exact+fused", "mixed")}


def _flagship_step(device, mode, graphed, seed=0, ray_tracer=None):
    from hashmodnffbanks_idr_tpu_torch.models.loss import IDRLossConfig
    from hashmodnffbanks_idr_tpu_torch.models.renderer import IDRNetwork
    from hashmodnffbanks_idr_tpu_torch.testing import flagship_conf
    from hashmodnffbanks_idr_tpu_torch.train.trainer import build_train_step, make_optimizer

    tracer, fused, _ = TRACER_MODES[mode]
    conf = flagship_conf(num_pixels=GRAPH_RAYS)
    conf.put("model.tracer_fast", tracer)
    conf.put("model.tracer_exact_fused", fused)
    for k, v in (ray_tracer or {}).items():
        conf.put(f"model.ray_tracer.{k}", v)
    model = IDRNetwork(conf.get_config("model"), device=device, seed=seed)
    opt = make_optimizer(model)
    step = build_train_step(model, IDRLossConfig(0.1, 200.0, 50.0), opt, graphed=graphed)
    captured = {}
    model.register_forward_hook(lambda m, a, o: captured.update(o))
    return model, opt, step, captured


def _graph_scene(device):
    from hashmodnffbanks_idr_tpu_torch.testing import scene_to_device, synthetic_scene

    return scene_to_device(synthetic_scene(n_views=2, img_res=(240, 320), seed=0), device)


def _run_steps(device, mode, graphed, n_steps, ray_tracer=None):
    """``n_steps`` flagship steps from seed-0 weights and a generator seeded
    1 (``ray_tracer`` overrides entries of the conf's ``ray_tracer``): per step
    the loss terms, the hit masks, the fused kernels' launches (by variant
    and cluster size), each loop's iterations and the graph's launches;
    then the model, optimizer, step and scene.  Every graphed call after
    the first (which warms up and captures) runs under the sync-debug mode
    "error": a host synchronisation inside it raises."""
    from hashmodnffbanks_idr_tpu_torch.utils import graphs
    from hashmodnffbanks_idr_tpu_torch.utils.sampling import sample_pixels

    scene = _graph_scene(device)
    model, opt, step, captured = _flagship_step(device, mode, graphed, ray_tracer=ray_tracer)
    gen = torch.Generator(device=device).manual_seed(1)
    out = []
    for i in range(n_steps):
        seen = fm.snapshot_launch_counts()
        iters_seen = dict(graphs.loop_iterations)
        launched = step.program.launches if graphed and step.program is not None else 0
        img, pix = (torch.tensor([i % 2], device=device),
                    sample_pixels(gen, 240 * 320, GRAPH_RAYS))
        torch.cuda.set_sync_debug_mode("error" if graphed and i > 0 else "default")
        try:
            losses = step(scene, img, pix, gen, 50.0)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        out.append({"losses": {k: v.clone() for k, v in losses.items()},
                    "mask": captured["network_object_mask"].clone(),
                    "launches": fm.launch_counts_since(seen),
                    "iterations": {k: v - iters_seen.get(k, 0)
                                   for k, v in graphs.loop_iterations.items()
                                   if v != iters_seen.get(k, 0)},
                    "graph_launches": step.program.launches - launched if graphed else 0})
    return out, model, opt, step, scene


@pytest.mark.parametrize("mode", sorted(GRAPH_MODES))
def test_cuda_graphed_step_matches_the_eager_step(cuda_device, mode):
    """The flagship (512 rays) graphed and eager from the same weights and
    generator.  As the step runs by default: step 1's loss terms and hit
    masks bit-identical (the same kernels in the same order).  Two eager
    runs part after a few steps (the hash grid's backward sums with atomics,
    and the mixed tracer's bf16 choices turn 1e-7 into 1e-3 of loss), so the
    next 10 steps run with deterministic index ops, where two eager runs
    agree bit for bit: every step's loss terms and hit masks and the
    parameters after the 10 steps bit-identical (so within 1e-6 and 5e-4 /
    2e-6); one capture."""
    eager, *_ = _run_steps(cuda_device, mode, False, 1)
    graphed, *_ = _run_steps(cuda_device, mode, True, 1)
    for k in eager[0]["losses"]:
        assert torch.equal(graphed[0]["losses"][k], eager[0]["losses"][k]), k
    assert torch.equal(graphed[0]["mask"], eager[0]["mask"])
    with deterministic():
        eager, m_e, *_ = _run_steps(cuda_device, mode, False, 10)
        graphed, m_g, _, step, _ = _run_steps(cuda_device, mode, True, 10)
    for i, (g, e) in enumerate(zip(graphed, eager)):
        for k in e["losses"]:
            assert torch.equal(g["losses"][k], e["losses"][k]), (i, k)
        assert torch.equal(g["mask"], e["mask"]), i
    for (name, p), q in zip(m_e.named_parameters(), m_g.parameters()):
        assert torch.equal(q.detach(), p.detach()), name
    assert step.captures == 1 and step.skipped == 0


@pytest.mark.parametrize("mode", sorted(GRAPH_MODES))
def test_cuda_graphed_step_counts_its_kernel_launches(cuda_device, mode):
    """The fused kernels' launches, points and cluster sizes folded in from
    the loops' device totals, step by step, as the eager step counts them
    on the same inputs (with deterministic index ops, so that the march
    makes the same iterations on both sides), each of the mode's kernels
    launched in every step; each loop's iterations equal to the eager
    loop's; one graph launch a step."""
    kernels = GRAPH_MODES[mode][2]
    with deterministic():
        eager, *_ = _run_steps(cuda_device, mode, False, 3)
        graphed, *_ = _run_steps(cuda_device, mode, True, 3)
    assert [g["graph_launches"] for g in graphed] == [1, 1, 1]
    for i in range(1, 3):   # step 1 of the graphed step also ran its warm-up
        assert graphed[i]["launches"] == eager[i]["launches"], i
        for kernel in kernels:
            assert graphed[i]["launches"][kernel]["launches"] > 0, (i, kernel)
        assert graphed[i]["iterations"] == eager[i]["iterations"], i
        assert graphed[i]["iterations"]["march_body"] > 0


@pytest.mark.parametrize("mode", sorted(TRACER_MODES))
def test_cuda_step_launches_its_modes_kernels(cuda_device, mode):
    """One eager flagship step launches its mode's fused kernels and no
    other: the f32 one in exact+fused and in mixed (its float32 decisions),
    the bf16 one in mixed and fast, neither in exact without the fused
    kernel."""
    run, *_ = _run_steps(cuda_device, mode, False, 1)
    launched = {k for k in ("fused_sdf_raw_f32", "fused_sdf_raw_bf16")
                if run[0]["launches"][k]["launches"]}
    assert launched == set(TRACER_MODES[mode][2])


def test_cuda_mixed_decisions_are_the_f32_kernels_queries(cuda_device):
    """The graphed mixed flagship step, step by step: every float32 decision
    runs the f32 kernel, so its points are the f32 encode kernel's (the
    decisions' encode), as the bf16 kernel's are the bf16 encode's (the
    guidance's)."""
    graphed, *_ = _run_steps(cuda_device, "mixed", True, 3)
    for i in range(1, 3):   # step 1 of the graphed step also ran its warm-up
        c = graphed[i]["launches"]
        assert c["fused_sdf_raw_f32"]["points"] == c["nffb_encode_f32"]["points"] > 0, (i, c)
        assert c["fused_sdf_raw_bf16"]["points"] == c["nffb_encode_bf16"]["points"] > 0, (i, c)


def test_cuda_mixed_trace_on_the_f32_kernel_agrees_with_the_chain(cuda_device):
    """The mixed flagship forward (2048 rays of the synthetic scene) with
    its float32 decisions on the f32 kernel against the same forward with
    them on the layer chain, same weights, guidance and draws: hit masks
    equal on at least 99.9% of the rays and the SDF at the rays' points
    within 5e-6 in the median (the exact+fused tolerances: the eval render's
    mask agreement, the benchmark's ``sdf_ray_gap``), the points on the rays
    both hit within the tracer's ``sdf_threshold`` in the median."""
    from hashmodnffbanks_idr_tpu_torch.models.loss import IDRLossConfig
    from hashmodnffbanks_idr_tpu_torch.models.renderer import IDRNetwork
    from hashmodnffbanks_idr_tpu_torch.testing import flagship_conf
    from hashmodnffbanks_idr_tpu_torch.train.trainer import loss_fn
    from hashmodnffbanks_idr_tpu_torch.utils.sampling import sample_pixels

    n_rays = 2048
    conf = flagship_conf(num_pixels=n_rays)
    conf.put("model.tracer_fast", "mixed")
    scene = _graph_scene(cuda_device)
    outs = {}
    for side in ("kernel", "chain"):
        model = IDRNetwork(conf.get_config("model"), device=cuda_device, seed=0)
        if side == "chain":
            tracer_sdfs = model._tracer_sdfs
            model._tracer_sdfs = lambda: (model.implicit_network.sdf, tracer_sdfs()[1])
        gen = torch.Generator(device=cuda_device).manual_seed(3)
        pix = sample_pixels(gen, 240 * 320, n_rays)
        draws = model.draw_uniforms(gen, n_rays, cuda_device)
        captured = {}
        model.register_forward_hook(lambda m, a, o: captured.update(o))
        seen = fm.snapshot_launch_counts()
        loss_fn(model, IDRLossConfig(0.1, 200.0, 50.0), scene,
                torch.tensor([0], device=cuda_device), pix, None, 50.0, draws=draws)
        launched = fm.launch_counts_since(seen)
        outs[side] = ({k: captured[k].detach() for k in
                       ("network_object_mask", "points", "sdf_output")},
                      launched["fused_sdf_raw_f32"]["launches"])
    (kernel, f32_k), (chain, f32_c) = outs["kernel"], outs["chain"]
    assert f32_k > 0 and f32_c == 0
    hit_k, hit_c = kernel["network_object_mask"], chain["network_object_mask"]
    assert float((hit_k == hit_c).float().mean()) >= 0.999
    sdf_gap = (kernel["sdf_output"] - chain["sdf_output"]).abs().reshape(-1)
    assert float(sdf_gap.median()) <= 5e-6
    both = hit_k & hit_c
    assert int(both.sum()) > 0
    points_gap = (kernel["points"] - chain["points"]).norm(dim=-1)[both]
    assert float(points_gap.median()) <= model.ray_tracer.sdf_threshold


@pytest.mark.parametrize("case", ["cap", "none"])
def test_cuda_graphed_step_loop_totals_equal_the_eager_loops(cuda_device, case):
    """The loops' device totals against the eager loops' counts, in a conf
    whose march cap binds (``sphere_tracing_iters`` 2: the march stops at
    its cap with rays unfinished) and in one where every ray is finished at
    the init (``sdf_threshold`` 1e3: no march iteration, no line search)."""
    tracer = {"sphere_tracing_iters": 2} if case == "cap" else {"sdf_threshold": 1e3}
    with deterministic():
        eager, *_ = _run_steps(cuda_device, "exact+fused", False, 2, ray_tracer=tracer)
        graphed, *_ = _run_steps(cuda_device, "exact+fused", True, 2, ray_tracer=tracer)
    for i in range(2):
        for k in eager[i]["losses"]:
            assert torch.equal(graphed[i]["losses"][k], eager[i]["losses"][k]), (i, k)
    # step 1 of the graphed step also ran its warm-up: step 2 alone
    assert graphed[1]["iterations"] == eager[1]["iterations"]
    if case == "cap":
        assert eager[1]["iterations"]["march_body"] == 2
    else:
        assert "march_body" not in eager[1]["iterations"]
        assert "line_body" not in eager[1]["iterations"]


def test_cuda_spans_are_stamped_inside_the_graph(cuda_device):
    """The mixed flagship step (512 rays) captured with tracing off, then
    again with it on: the second's captured segments hold the same nodes by
    type as the first's, and the span stamps besides (so a step captured
    with tracing off is the graph without spans); under the profiler, with
    tracing on, every stamp of three steps is one ``span_stamp`` kernel
    record (as many as the ring holds), the spans nest on the card's clock
    in device order, a step's four top-level spans lie within its ``step``
    span, and the loop bodies' spans count their loops' iterations."""
    from torch.profiler import ProfilerActivity, profile

    from hashmodnffbanks_idr_tpu_torch.ops import graph_loops as gl
    from hashmodnffbanks_idr_tpu_torch.utils import graphs, profiling
    from hashmodnffbanks_idr_tpu_torch.utils.sampling import sample_pixels

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=activities):   # device tracing up before any capture
        torch.zeros(1, device=cuda_device).add_(1)
    scene = _graph_scene(cuda_device)
    _, _, step, _ = _flagship_step(cuda_device, "mixed", True)
    gen = torch.Generator(device=cuda_device).manual_seed(1)

    def run(i):
        step(scene, torch.tensor([i % 2], device=cuda_device),
             sample_pixels(gen, 240 * 320, GRAPH_RAYS), gen, 50.0)

    def nodes():
        out = dict.fromkeys(gl.NODE_TYPES, 0)
        for seg in step.program.segments():
            for k, v in gl.Assembler.count_nodes(seg.graph).items():
                out[k] += v
        return out

    try:
        stamps = profiling.stamps_launched
        run(0)
        off = nodes()
        assert profiling.stamps_launched == stamps and step.captures == 1
        profiling.set_tracing(True, cuda_device)
        run(1)
        on = nodes()
        stamped = profiling.stamps_launched - stamps
        assert step.captures == 2 and stamped > 0
        assert sum(seg.stamps for seg in step.program.segments()) == stamped
        assert on == dict(off, kernel=off["kernel"] + stamped)
        with profile(activities=activities):
            run(2)
            torch.cuda.synchronize()
        profiling.reset_spans()
        loops = dict(graphs.loop_iterations)
        with profile(activities=activities) as prof:
            for i in range(3):
                run(i)
            torch.cuda.synchronize()
        ring, n = profiling.read_ring()
        records = [e for e in prof.events() if "span_stamp" in e.name
                   and e.device_type == torch.autograd.DeviceType.CUDA]
        assert len(records) == n == len(ring) > 0
        assert [t for t, _, _ in ring] == sorted(t for t, _, _ in ring)
        stack, top = [], {}
        for t, name, end in ring:
            if not end:
                stack.append((name, t))
                continue
            opened, t0 = stack.pop()
            assert opened == name
            if len(stack) == 1:
                top[name] = top.get(name, 0) + t - t0
            elif not stack:
                assert sum(top.values()) <= t - t0
                assert set(top) == {"tracer", "render", "backward", "update"}
                top = {}
        assert not stack
        fm.snapshot_launch_counts()
        totals = profiling.span_totals
        assert totals["step"]["count"] == 3 and profiling.between_steps["count"] == 2
        assert totals["march"]["count"] == (graphs.loop_iterations["march_body"]
                                            - loops["march_body"])
        assert totals["line_search"]["count"] == (graphs.loop_iterations["line_body"]
                                                  - loops["line_body"])
    finally:
        profiling.set_tracing(False)


def test_cuda_graphed_step_skips_a_nonfinite_step_on_the_device(cuda_device):
    """A step whose loss is NaN (alpha NaN, a static input of the graphs):
    the parameters and the Adam state bit-unchanged, the device counter one
    more, as the eager step skips it; the next step updates again."""
    from hashmodnffbanks_idr_tpu_torch.utils.sampling import sample_pixels

    _, model, opt, step, scene = _run_steps(cuda_device, "exact+fused", True, 2)
    before = ([p.detach().clone() for p in model.parameters()],
              [t.clone() for st in opt.state.values() for t in st.values()])
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    losses = step(scene, torch.tensor([0], device=cuda_device),
                  sample_pixels(gen, 240 * 320, GRAPH_RAYS), gen, float("nan"))
    assert not torch.isfinite(losses["loss"]) and step.skipped == 1
    for a, b in zip(before[0], model.parameters()):
        assert torch.equal(a, b.detach())
    for a, b in zip(before[1], [t for st in opt.state.values() for t in st.values()]):
        assert torch.equal(a, b)
    step(scene, torch.tensor([1], device=cuda_device),
         sample_pixels(gen, 240 * 320, GRAPH_RAYS), gen, 50.0)
    assert step.skipped == 1 and step.captures == 1
    assert not all(torch.equal(a, b.detach()) for a, b in zip(before[0], model.parameters()))


def test_cuda_graphed_step_captures_again_after_a_resume(cuda_device, tmp_path):
    """Two graphed steps, a checkpoint, and the checkpoint loaded back (the
    optimizer's state tensors are new): the next call captures again, and
    with deterministic index ops its loss terms, hit masks and parameters
    equal bit for bit those of an eager step resumed from the same
    checkpoint."""
    from hashmodnffbanks_idr_tpu_torch.train import checkpoints as ckpt
    from hashmodnffbanks_idr_tpu_torch.utils.sampling import sample_pixels

    _, model, opt, step, scene = _run_steps(cuda_device, "exact+fused", True, 2)
    ckpt.save_checkpoint(str(tmp_path), 2, model, opt, 2)
    after = {}
    with deterministic():
        for graphed in (True, False):
            if not graphed:
                model, opt, step, captured = _flagship_step(cuda_device, "exact+fused", False,
                                                            seed=5)
            else:
                captured = {}
                model.register_forward_hook(lambda m, a, o: captured.update(o))
            ckpt.load_checkpoint(str(tmp_path), "latest", model, opt)
            gen = torch.Generator(device=cuda_device).manual_seed(3)
            losses = step(scene, torch.tensor([1], device=cuda_device),
                          sample_pixels(gen, 240 * 320, GRAPH_RAYS), gen, 50.0)
            torch.cuda.synchronize()
            after[graphed] = (losses, captured["network_object_mask"].clone(),
                              [p.detach().clone() for p in model.parameters()], step)
    (l_g, m_g, p_g, s_g), (l_e, m_e, p_e, _) = after[True], after[False]
    assert s_g.captures == 2
    for k in l_e:
        assert torch.equal(l_g[k], l_e[k]), k
    assert torch.equal(m_g, m_e)
    for a, b in zip(p_g, p_e):
        assert torch.equal(a, b)

"""The published FFB_TCNN model (NFFB on the instant-ngp hash grid,
``benchmark/configs/idr-ffbtcnn-log2-15``) on the port's normal path.

On the CPU: the port's eager train step against the benchmark's plain
reference (``benchmark/reference``, which imports neither the port nor
JAX) for three steps, at a size the CPU holds: the published encoders
(points: 6 levels x 2 features, 2^15 rows a level, trilinear, bound 0.45,
style modulation; views: 4 levels), narrow MLPs, a 3-view 24x32 scan, 64
rays a step, the conf's mixed tracer; and which of the conf's encoders
take the encode kernel.  On the card (``cuda`` marker; they skip without
one): the graphed step with the ngp encode kernel against the eager step,
and the StyleModNFFB step counting no ngp launches.  The file imports
nothing of JAX, so on the card it runs as

    python -m pytest tests/test_torch_ffbtcnn.py -m cuda --noconftest -q
"""

import json
import statistics
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT / "benchmark") not in sys.path:
    sys.path.insert(0, str(ROOT / "benchmark"))

from hashmodnffbanks_idr_tpu_torch.config.hocon import Config  # noqa: E402
from hashmodnffbanks_idr_tpu_torch.models.renderer import IDRNetwork  # noqa: E402
from hashmodnffbanks_idr_tpu_torch.ops import fused_mlp as fm  # noqa: E402
from hashmodnffbanks_idr_tpu_torch.ops import nffb_encode  # noqa: E402

CONFIG = ROOT / "benchmark" / "configs" / "idr-ffbtcnn-log2-15.json"
WORKLOAD = "ffbtcnn15.dtu49.mixed"
# narrow MLPs for the CPU; the encoders keep the published shapes
NARROW = {"implicit_network": [64] * 8, "rendering_network": [64] * 4}
FEATURES = 32
SEED = 2_147_483_659


def _model_conf():
    """The configuration's conf with the cell's mixed tracer."""
    conf = json.loads(CONFIG.read_text())["conf"]
    conf["model"]["tracer_fast"] = "mixed"
    return conf


def test_ffbtcnn_encoders_take_the_ngp_kernel():
    """The conf's points encoder is FFBTcnn at (3, 6, 2, 28) with 2^15 rows
    a level (so the bf16 path rounds its corner values), its view
    directions' at (3, 4, 2, 20) (8 rows a level, no rounding); both take
    the kernel's ngp grid, and only for a CUDA input without autograd."""
    from types import SimpleNamespace

    model = IDRNetwork(Config(_model_conf()["model"]), device="cpu")
    points = model.implicit_network.embedder
    views = model.rendering_network.view_embedder
    assert nffb_encode.shape(points) == ("ngp", (3, 6, 2, 28))
    assert nffb_encode.shape(views) == ("ngp", (3, 4, 2, 20))
    assert points.grid.spec.rounds_inference() and not views.grid.spec.rounds_inference()
    assert model.implicit_network.dims[0] == 31
    for enc in (points, views):
        assert enc.fused_encode and enc.style_modulation
        assert enc.grid.spec.interpolation == "linear"
        with torch.no_grad():
            assert enc.takes_kernel(SimpleNamespace(is_cuda=True))
            assert not enc.takes_kernel(torch.zeros(2, 3))
        with torch.enable_grad():
            assert not enc.takes_kernel(SimpleNamespace(is_cuda=True))
    # the level-pruning keys of the conf take no effect on an NFFB encoder
    assert not model.implicit_network.supports_level_pruning()


def _run(device="cpu"):
    """The port's first three steps and the reference's, on the same
    weights (drawn from ``SEED``) and inputs."""
    from harness import driver, spec
    from harness.scene import build_scene
    from reference import step as ref_step

    cell = spec.resolve(ROOT, WORKLOAD)
    model = cell.config["conf"]["model"]
    model["implicit_network"]["dims"] = list(NARROW["implicit_network"])
    model["rendering_network"]["dims"] = list(NARROW["rendering_network"])
    model["feature_vector_size"] = FEATURES
    cell.traffic = dict(cell.traffic, n_views=3, img_res=[24, 32], rays_per_step=64)
    torch.manual_seed(0)
    scene = build_scene(cell.traffic, device)
    st = driver.start(cell, scene, SEED, device)
    ref = ref_step.run_steps(cell.conf, scene, st.weights, st.checked)
    return st, ref


@pytest.fixture(scope="module")
def steps():
    return _run()


def test_ffbtcnn_eager_step_matches_the_reference_losses(steps):
    """Each of the three steps' loss terms within 1e-6 of the reference's,
    relative, and the first step's hit masks equal: both sides run the same
    float32 math on the CPU (the bf16 guidance rounded at the same points),
    so they read equal to the bit here; 1e-6 leaves a few float32 ulps for
    a CPU library that sums a product in another order, well under the
    1e-4 that one ray landing elsewhere moves a 64-ray loss by."""
    st, ref = steps
    for k, (p, r) in enumerate(zip(st.prog["losses"], ref["losses"])):
        for term, v in r.items():
            assert abs(p[term] - v) <= 1e-6 * max(abs(v), 1e-6), (k, term, p[term], v)
    hit_p = st.prog["rays1"]["network_object_mask"]
    assert torch.equal(hit_p, ref["rays1"]["network_object_mask"])


def test_ffbtcnn_eager_step_matches_the_reference_gradients(steps):
    """The first step's gradient, leaf by leaf, within 1e-5 of the larger of
    the leaf's reference norm and the median leaf's (it reads about 1e-7):
    float32 rounding of the same products, summed in other orders (the
    port's graph-safe backward against the reference's as written), carried
    through the eikonal term's second-order backward; the median floor
    keeps a leaf with a gradient of rounding alone from reading a relative
    gap of 1."""
    st, ref = steps
    g_p, g_r = st.prog["grad1"], ref["grad1"]
    assert set(g_p) >= set(g_r)
    norms = {k: float(torch.linalg.vector_norm(v.double())) for k, v in g_r.items()}
    floor = statistics.median(norms.values())
    for k, v in g_r.items():
        gap = float(torch.linalg.vector_norm((g_p[k] - v).double()))
        assert gap <= 1e-5 * max(norms[k], floor), (k, gap, norms[k])
    # the ngp table and the NFFB trunk of both encoders are among the leaves
    assert {"implicit_network.embedder.grid.table",
            "rendering_network.view_embedder.grid.table"} <= set(g_r)


def test_ffbtcnn_eager_step_matches_the_reference_parameters(steps):
    """The parameters' change over the three steps, leaf by leaf, within
    1e-4 of the larger of the leaf's reference change and the median
    leaf's (it reads 0 here): Adam divides each entry by the root of its
    second moment, so an entry whose gradient is rounding alone can move by
    a full step on one side and not on the other; the median floor keeps
    such a leaf from counting, while a leaf that trained reads its change
    to 1e-4.  The hash tables move from the second step on (the geometric
    init gives them no gradient at the first)."""
    st, ref = steps
    init, p_p, p_r = st.weights, st.prog["params"], ref["params"]
    d = {k: float(torch.linalg.vector_norm((p_r[k] - init[k]).double())) for k in p_r}
    floor = statistics.median(d.values())
    assert floor > 0
    for k in p_r:
        gap = float(torch.linalg.vector_norm((p_p[k] - p_r[k]).double()))
        assert gap <= 1e-4 * max(d[k], floor), (k, gap, d[k])
    assert d["implicit_network.embedder.grid.table"] > 0


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


GRAPH_RAYS = 512


def _card_steps(device, graphed, n_steps, conf_model):
    """``n_steps`` steps of ``conf_model`` (512 rays on a 2-view 240x320
    noise scene) from seed-0 weights and a generator seeded 1: per step the
    loss terms, the hit masks and what the kernels counted."""
    from hashmodnffbanks_idr_tpu_torch.models.loss import IDRLossConfig
    from hashmodnffbanks_idr_tpu_torch.testing import scene_to_device, synthetic_scene
    from hashmodnffbanks_idr_tpu_torch.train.trainer import build_train_step, make_optimizer
    from hashmodnffbanks_idr_tpu_torch.utils.sampling import sample_pixels

    scene = scene_to_device(synthetic_scene(n_views=2, img_res=(240, 320), seed=0), device)
    model = IDRNetwork(Config(conf_model), device=device, seed=0)
    opt = make_optimizer(model)
    step = build_train_step(model, IDRLossConfig(0.1, 200.0, 50.0), opt, graphed=graphed)
    captured = {}
    model.register_forward_hook(lambda m, a, o: captured.update(o))
    gen = torch.Generator(device=device).manual_seed(1)
    out = []
    for i in range(n_steps):
        seen = fm.snapshot_launch_counts()
        img, pix = torch.tensor([i % 2], device=device), sample_pixels(gen, 240 * 320,
                                                                         GRAPH_RAYS)
        losses = step(scene, img, pix, gen, 50.0)
        torch.cuda.synchronize()
        out.append({"losses": {k: v.clone() for k, v in losses.items()},
                    "mask": captured["network_object_mask"].clone(),
                    "launches": fm.launch_counts_since(seen)})
    return out


@pytest.mark.cuda
def test_cuda_graphed_ffbtcnn_step_with_the_ngp_encode_kernel(cuda_device):
    """The FFB_TCNN step (mixed tracer, 512 rays) captures the ngp encode
    kernel: graphed against eager at the flagship's bounds (step 1's loss
    terms and hit masks bit-identical; 3 steps with deterministic index ops
    bit-identical), both precisions of the ngp kernel in every step, every
    bf16 guidance query encoded by it (its points are the bf16 MLP
    kernel's), and the torch grid's kernel never."""
    from hashmodnffbanks_idr_tpu_torch.utils.debug import deterministic

    model = _model_conf()["model"]
    eager = _card_steps(cuda_device, False, 1, model)
    graphed = _card_steps(cuda_device, True, 1, model)
    for k in eager[0]["losses"]:
        assert torch.equal(graphed[0]["losses"][k], eager[0]["losses"][k]), k
    assert torch.equal(graphed[0]["mask"], eager[0]["mask"])
    with deterministic():
        eager = _card_steps(cuda_device, False, 3, model)
        graphed = _card_steps(cuda_device, True, 3, model)
    for i, (g, e) in enumerate(zip(graphed, eager)):
        for k in e["losses"]:
            assert torch.equal(g["losses"][k], e["losses"][k]), (i, k)
        assert torch.equal(g["mask"], e["mask"]), i
    for i in range(1, 3):   # step 1 of the graphed step also ran its warm-up
        for run in (eager[i], graphed[i]):
            launched = run["launches"]
            for v in ("nffb_ngp_encode_f32", "nffb_ngp_encode_bf16"):
                assert launched[v]["launches"] > 0, (i, v)
            assert (launched["nffb_ngp_encode_bf16"]["points"]
                    == launched["fused_sdf_raw_bf16"]["points"]), (i, launched)
            assert launched["nffb_encode_f32"]["launches"] == 0
            assert launched["nffb_encode_bf16"]["launches"] == 0
        assert graphed[i]["launches"] == eager[i]["launches"], i


@pytest.mark.cuda
def test_cuda_stylemodnffb_step_counts_no_ngp_launch(cuda_device):
    """The StyleModNFFB step (mixed, the torch grid) counts its encodes
    under ``nffb_encode_*`` as before (``encoder_fused_points_per_step``
    reads them): the bf16 encode's points are the bf16 MLP kernel's, and
    the ngp counters stay at 0."""
    from hashmodnffbanks_idr_tpu_torch.config.hocon import parse_file

    conf = parse_file(str(ROOT / "benchmark" / "configs" / "idr-stylemodnffb.conf"))
    model = conf.get_config("model").data
    model["tracer_fast"] = "mixed"
    for run in _card_steps(cuda_device, True, 2, model)[1:]:
        launched = run["launches"]
        assert launched["nffb_encode_bf16"]["launches"] > 0
        assert launched["nffb_encode_bf16"]["points"] == launched["fused_sdf_raw_bf16"]["points"]
        assert launched["nffb_encode_f32"]["launches"] > 0
        for v in ("nffb_ngp_encode_f32", "nffb_ngp_encode_bf16"):
            assert launched[v] == {"launches": 0, "points": 0}, v

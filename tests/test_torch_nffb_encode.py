"""NFFB's gradient-free encode kernel (``ops/nffb_encode.py``), on the torch
grid ('FFB', 'StyleModNFFB') and the ngp grid ('FFBTcnn').

On the CPU: which encoders of the repo's confs take the kernel, that the
plain forward runs (bit for bit, nothing counted) with autograd or on a CPU
tensor, and that the wrapper refuses what the kernel does not take before
it loads the library.  On the card (``cuda`` marker; they skip without
one): the kernel against the module's plain forward in both precisions at
the tracer's sizes, the SDF through the bf16 fused kernel, and the graphed
steps that capture it against the eager steps.  The file imports nothing of
JAX, so on the card it runs as

    python -m pytest tests/test_torch_nffb_encode.py -m cuda --noconftest -q
"""

from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from hashmodnffbanks_idr_tpu_torch.config.hocon import parse_file
from hashmodnffbanks_idr_tpu_torch.models.embedders import build_embedder
from hashmodnffbanks_idr_tpu_torch.models.renderer import IDRNetwork
from hashmodnffbanks_idr_tpu_torch.ops import fused_mlp as fm
from hashmodnffbanks_idr_tpu_torch.ops import nffb_encode

CONF_DIR = Path(__file__).resolve().parents[1] / "hashmodnffbanks_idr_tpu" / "config" / "confs"
CONFS = sorted(str(p.relative_to(CONF_DIR)) for p in CONF_DIR.rglob("*.conf"))
KERNEL_TYPES = ("FFB", "StyleModNFFB", "FFBTcnn")
GRID = {"FFB": "torch", "StyleModNFFB": "torch", "FFBTcnn": "ngp"}

# the points encoder of the NFFB confs (benchmark/configs/idr-stylemodnffb)
# and RenderingNetwork's view-direction NFFB (multires_view 4)
ENCODERS = {
    "points": dict(input_dims=3, multires=6, log2_max_hash_size=5, max_points_per_entry=2,
                   base_resolution=16, desired_resolution=512, bound=0.45),
    "views": dict(input_dims=3, multires=4, log2_max_hash_size=3, max_points_per_entry=2,
                  base_resolution=16, desired_resolution=512, bound=1.0),
}
# the FFB_TCNN conf's points grid (benchmark/configs/idr-ffbtcnn-log2-15):
# 2^15 rows a level, so the bf16 path rounds its corner values
LOG2 = {("points", "FFBTcnn"): 15}
CHECK_N = (1, 4095, 4096, 24576, 69632)
F32_TOL = 1e-5
BF16_WITHIN_ULP = 0.999


def _encoder(kind, embed_type, device="cpu", seed=0):
    kw = dict(ENCODERS[kind])
    kw["log2_max_hash_size"] = LOG2.get((kind, embed_type), kw["log2_max_hash_size"])
    enc = build_embedder(embed_type, **kw)
    enc.reset_parameters(torch.Generator().manual_seed(seed))
    return enc.to(device)


def _points(n, seed, device, box=0.6):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.uniform(-box, box, (n, 3)).astype(np.float32)).to(device)


def _plain(enc, x, fast):
    """The module's plain forward on x, whatever the device."""
    fused, enc.fused_encode = enc.fused_encode, False
    try:
        with torch.no_grad():
            return enc(x, fast=fast)
    finally:
        enc.fused_encode = fused


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("conf", CONFS)
def test_nffb_kernel_takes_the_torch_grid_nffbs_of_every_conf(conf):
    """In every conf of the repo, an encoder takes the kernel exactly when
    it is an NFFB: 'FFB' or 'StyleModNFFB' (the torch grid, floor corner) or
    'FFBTcnn' (the ngp grid, trilinear), the points and the view directions
    alike; every other encoder does not."""
    model_conf = parse_file(str(CONF_DIR / conf)).get_config("model")
    model = IDRNetwork(model_conf, device="cpu")
    # the points encoder's type as IDRNetwork reads it: embedding_network's
    # keys over implicit_network's
    points = dict(model_conf.get_config("implicit_network").data)
    points.update(getattr(model_conf.get_config("embedding_network", None), "data", {}))
    roles = {"points": (model.implicit_network.embedder, points.get("embed_type")),
             "views": (model.rendering_network.view_embedder,
                       model_conf.get_config("rendering_network").get("viewdirs_embed_type",
                                                                      None))}
    for role, (enc, embed_type) in roles.items():
        takes = getattr(enc, "fused_encode", False)
        assert takes == (enc is not None and embed_type in KERNEL_TYPES), (role, embed_type)
        if takes:
            grid, dims = nffb_encode.shape(enc)
            assert grid == GRID[embed_type] and dims in nffb_encode.SHAPES[grid]


def test_nffb_kernel_is_built_for_every_torch_grid_nffb_the_confs_use():
    """Every shape of the repo's confs takes the kernel: on the torch grid
    with and without style modulation, the points encoder (L 6, width 56)
    and the view directions' (L 4, width 40); on the ngp grid ('FFBTcnn',
    the style preset) the points (L 6, width 28) and the view directions (L
    4, width 20).  A torch grid with linear interpolation, and an ngp grid
    with floor interpolation, do not."""
    for kind in ENCODERS:
        for embed_type in KERNEL_TYPES:
            assert _encoder(kind, embed_type).fused_encode, (kind, embed_type)
        assert not build_embedder("StyleModNFFB", grid_interpolation="linear",
                                  **ENCODERS[kind]).fused_encode
        assert not build_embedder("FFBTcnn", grid_interpolation="floor",
                                  **ENCODERS[kind]).fused_encode
    seen = set()
    for conf in CONFS:
        model = IDRNetwork(parse_file(str(CONF_DIR / conf)).get_config("model"), device="cpu")
        for enc in (model.implicit_network.embedder, model.rendering_network.view_embedder):
            if getattr(enc, "fused_encode", False):
                seen.add((*nffb_encode.shape(enc), enc.style_modulation))
    assert {s[:2] for s in seen} == {(g, d) for g, dims in nffb_encode.SHAPES.items()
                                     for d in dims}
    assert {s[2] for s in seen if s[0] == "torch"} == {False, True}
    assert {s[2] for s in seen if s[0] == "ngp"} == {True}


@pytest.mark.parametrize("grad", [True, False])
@pytest.mark.parametrize("embed_type", KERNEL_TYPES)
def test_nffb_forward_stays_plain_with_grad_or_on_the_cpu(monkeypatch, embed_type, grad):
    """With autograd on, or on a CPU tensor, the forward is the plain one:
    the same bits as with the kernel's dispatch turned off, the wrapper never
    called, nothing counted; the dispatch takes a CUDA input only without
    autograd."""
    enc = _encoder("points", embed_type)
    x = _points(257, seed=1, device="cpu")

    def refuse(*_):
        raise AssertionError("the kernel's wrapper was called")

    monkeypatch.setattr(nffb_encode, "encode", refuse)
    fm.reset_launch_counts()
    for fast in (False, True):
        with torch.set_grad_enabled(grad):
            got = enc(x, fast=fast)
        assert torch.equal(got, _plain(enc, x, fast)), fast
    assert all(fm.launch_counts[v] == {"launches": 0, "points": 0}
               for by_fast in nffb_encode.VARIANTS.values() for v in by_fast.values())
    cuda_like = SimpleNamespace(is_cuda=True)
    with torch.set_grad_enabled(grad):
        assert enc.takes_kernel(cuda_like) == (not grad)
        assert not enc.takes_kernel(x)


BAD_INPUTS = {
    "dtype": lambda x: x.double(),
    "width": lambda x: x[:, :2].contiguous(),
    "rank": lambda x: x.reshape(-1),
    "layout": lambda x: x.t().contiguous().t(),
    "device": lambda x: x,
}


@pytest.mark.parametrize("case", sorted(BAD_INPUTS))
def test_nffb_encode_refuses_what_the_kernel_does_not_take(monkeypatch, case):
    """A wrong dtype, width, rank or layout, or a tensor off the card, is
    refused with ValueError before the library is loaded (so before any
    launch)."""
    def refuse():
        raise AssertionError("the library was loaded")

    monkeypatch.setattr(nffb_encode, "load_library", refuse)
    enc = _encoder("points", "StyleModNFFB")
    x = BAD_INPUTS[case](_points(8, seed=2, device="cpu"))
    with pytest.raises(ValueError):
        nffb_encode.check_input(x, 3)
    with pytest.raises(ValueError):
        nffb_encode.encode(enc, x, fast=False)


@pytest.mark.parametrize("case", ["levels", "interpolation"])
def test_nffb_encode_refuses_an_ngp_module_it_is_not_built_for(monkeypatch, case):
    """An 'FFBTcnn' the kernel is not built for (5 levels, or the floor
    corner) keeps the plain forward, and ``encode`` refuses it with
    ValueError before it looks at the input or loads the library."""
    def refuse():
        raise AssertionError("the library was loaded")

    monkeypatch.setattr(nffb_encode, "load_library", refuse)
    kw = dict(ENCODERS["points"])
    if case == "levels":
        kw["multires"] = 5
    else:
        kw["grid_interpolation"] = "floor"
    enc = build_embedder("FFBTcnn", **kw)
    assert not enc.fused_encode
    assert not enc.takes_kernel(SimpleNamespace(is_cuda=True))
    with pytest.raises(ValueError, match="not built"):
        nffb_encode.encode(enc, _points(8, seed=2, device="cpu"), fast=False)


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


def _trained(kind, embed_type, device, steps=5):
    """The encoder after ``steps`` Adam steps (lr 1e-3) on a smooth target,
    so that its weights are no longer the init's."""
    enc = _encoder(kind, embed_type, device)
    opt = torch.optim.Adam(enc.parameters(), lr=1e-3)
    x = _points(4096, seed=3, device=device)
    target = torch.sin(3.0 * x).sum(dim=1, keepdim=True)
    for _ in range(steps):
        opt.zero_grad()
        out = enc(x)[:, 3:]
        ((out.sum(dim=1, keepdim=True) - target) ** 2).mean().backward()
        opt.step()
    return enc


def _bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at each value of v (v itself bf16-exact)."""
    e = torch.frexp(v.abs().clamp_min(torch.finfo(torch.float32).tiny))[1]
    return torch.ldexp(torch.ones_like(v), e - 8)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", sorted(ENCODERS))
@pytest.mark.parametrize("embed_type", KERNEL_TYPES)
@pytest.mark.parametrize("fast", [False, True], ids=["f32", "bf16"])
def test_cuda_nffb_encode_matches_the_plain_forward(cuda_device, kind, embed_type, fast):
    """The kernel against the module's plain forward on the card, after a
    few Adam steps, at the tracer's sizes: float32 within 1e-5 in every
    output column; the bf16 guidance path within one bf16 ulp of the plain
    path in 99.9% of the elements (the sums run in another order, so a
    rounding point can land on the other side of a tie).  One launch a call,
    its points counted."""
    enc = _trained(kind, embed_type, cuda_device)
    variant = nffb_encode.VARIANTS[GRID[embed_type]][fast]
    for n in CHECK_N:
        x = _points(n, seed=n, device=cuda_device)
        fm.reset_launch_counts()
        with torch.no_grad():
            got = enc(x, fast=fast)
        want = _plain(enc, x, fast)
        torch.cuda.synchronize()
        assert fm.launch_counts[variant] == {"launches": 1, "points": n}
        assert got.shape == want.shape == (n, 3 + enc.out_width)
        err = (got - want).abs()
        if not fast:
            assert float(err.max()) <= F32_TOL, (n, float(err.max()))
        else:
            within = err <= _bf16_ulp(want.to(torch.bfloat16).float())
            assert float(within.float().mean()) >= BF16_WITHIN_ULP, (n, float(err.max()))


@pytest.mark.cuda
def test_cuda_nffb_encode_sdf_through_the_bf16_kernel(cuda_device):
    """The mixed tracer's guidance SDF (the bf16 encode, then the bf16 fused
    MLP) with the encode kernel against the same with the plain encode:
    within the bf16 kernel's 3e-2, signs agreeing where |sdf| > 5e-2."""
    from hashmodnffbanks_idr_tpu_torch.models.networks import ImplicitNetwork

    net = ImplicitNetwork(feature_vector_size=256, d_in=3, d_out=1, dims=[512] * 8,
                          geometric_init=True, bias=0.6, skip_in=[4], weight_norm=True,
                          multires=6, embed_type="StyleModNFFB", log2_max_hash_size=5,
                          max_points_per_entry=2, base_resolution=16, desired_resolution=512,
                          bound=0.45)
    net.reset_parameters(torch.Generator().manual_seed(0))
    net = net.to(cuda_device)
    sdf = net.make_fast_sdf("bf16")
    for n in (4096, 69632):
        x = _points(n, seed=n, device=cuda_device)
        with torch.no_grad():
            got = sdf(x)
            net.embedder.fused_encode = False
            try:
                want = sdf(x)
            finally:
                net.embedder.fused_encode = True
        assert float((got - want).abs().max()) <= 3e-2
        big = want.abs() > 5e-2
        assert bool((torch.sign(got[big]) == torch.sign(want[big])).all())


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["exact+fused", "mixed"])
def test_cuda_graphed_step_with_the_encode_kernel(cuda_device, mode):
    """The flagship steps (512 rays) capture the encode kernel: graphed
    against eager at test_cuda_graphed_step_matches_the_eager_step's bounds
    (step 1's loss terms and hit masks bit-identical; 3 steps with
    deterministic index ops bit-identical), the kernel in every step, and
    every query of the fused MLP kernel encoded by it: in exact+fused the
    f32 encode's points are the f32 kernel's, in mixed the bf16 encode's
    the bf16 kernel's."""
    from hashmodnffbanks_idr_tpu_torch.utils.debug import deterministic
    from test_torch_cuda import _run_steps

    mlp, encode = {"exact+fused": ("fused_sdf_raw_f32", "nffb_encode_f32"),
                   "mixed": ("fused_sdf_raw_bf16", "nffb_encode_bf16")}[mode]
    eager, *_ = _run_steps(cuda_device, mode, False, 1)
    graphed, *_ = _run_steps(cuda_device, mode, True, 1)
    for k in eager[0]["losses"]:
        assert torch.equal(graphed[0]["losses"][k], eager[0]["losses"][k]), k
    assert torch.equal(graphed[0]["mask"], eager[0]["mask"])
    with deterministic():
        eager, *_ = _run_steps(cuda_device, mode, False, 3)
        graphed, *_ = _run_steps(cuda_device, mode, True, 3)
    for i, (g, e) in enumerate(zip(graphed, eager)):
        for k in e["losses"]:
            assert torch.equal(g["losses"][k], e["losses"][k]), (i, k)
        assert torch.equal(g["mask"], e["mask"]), i
    for i in range(1, 3):   # step 1 of the graphed step also ran its warm-up
        for run in (eager[i], graphed[i]):
            launched = run["launches"]
            assert launched[encode]["launches"] > 0, i
            assert launched[encode]["points"] == launched[mlp]["points"], (i, launched)
        assert graphed[i]["launches"] == eager[i]["launches"], i

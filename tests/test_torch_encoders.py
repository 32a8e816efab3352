"""Every encoder of the JAX factory, the positional encodings and the
rendering network's view branches and modes, against the JAX package.

Same numpy-seeded points and the same weights (``weights.from_jax_params``
from the JAX init) through both: each ``build_embedder`` entry as the SDF
encoder (d_in 3, multires 6) and as the deep view encoder (the reference's
hard-coded view settings), with overrides; ``RenderingNetwork`` with the
classic ``nerfpos`` view embedding and in the 'no_view_dir' / 'no_normal'
modes.  Outputs atol 1e-5, x-gradients within 1e-4 of the largest, the
``fast`` outputs of the NFFB encoders (bf16) 3e-2.  And every conf file of the repo
builds an ``IDRNetwork`` with the JAX network's layer widths.
"""

from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hashmodnffbanks_idr_tpu.config.hocon import parse_file as j_parse_file
from hashmodnffbanks_idr_tpu.models.embedders import build_embedder as j_build_embedder
from hashmodnffbanks_idr_tpu.models.networks import RenderingNetwork as JRenderingNetwork
from hashmodnffbanks_idr_tpu.models.renderer import IDRNetwork as JIDRNetwork
from hashmodnffbanks_idr_tpu.ops import encodings as jenc

from hashmodnffbanks_idr_tpu_torch.config.hocon import parse_file
from hashmodnffbanks_idr_tpu_torch.models.embedders import build_embedder
from hashmodnffbanks_idr_tpu_torch.models.networks import RenderingNetwork
from hashmodnffbanks_idr_tpu_torch.models.renderer import IDRNetwork
from hashmodnffbanks_idr_tpu_torch.ops import encodings as enc
from hashmodnffbanks_idr_tpu_torch.ops import fused_mlp as fm
from hashmodnffbanks_idr_tpu_torch.weights import from_jax_params

ATOL = 1e-5
# x-gradients within 1e-4 of the largest (tests/test_torch_networks.py's
# gradient tolerance): the NFFB SIREN trunk (w0 = 30) scales float32 noise
GRAD_TOL = 1e-4
CONF_DIR = Path(__file__).resolve().parents[1] / "hashmodnffbanks_idr_tpu" / "config" / "confs"
CONFS = sorted(str(p.relative_to(CONF_DIR)) for p in CONF_DIR.rglob("*.conf"))

# the SDF encoder's settings (dtu_shaped_*.conf) and the view encoder's
# (RenderingNetwork's hard-coded deep-embedder settings, multires_view 4)
SDF_KW = dict(input_dims=3, multires=6, log2_max_hash_size=15, max_points_per_entry=2,
              base_resolution=16, desired_resolution=512, bound=0.75,
              network_dims=[3] + [64] * 4 + [33])
VIEW_KW = dict(input_dims=3, multires=4, log2_max_hash_size=3, max_points_per_entry=2,
               base_resolution=16, desired_resolution=512, bound=1.0,
               network_dims=[265, 64, 64, 3])
FACTORY = [
    ("HashGrid", {}), ("HashGrid", {"interpolation": "linear"}),
    ("FFB", {}), ("StyleModNFFB", {}), ("StyleModNFFB", {"grid_interpolation": "linear"}),
    ("FFBTcnn", {}), ("FFBTcnn", {"style_modulation": False, "grid_interpolation": "floor"}),
    ("NerfPos", {}), ("FourierFeatures", {}),
    ("HashGridTcnn", {}), ("HashGridTcnn", {"gridtype": "tiled", "interpolation": "smoothstep"}),
    ("HashGridCUDA", {}),
    ("MultiResHashEncoderCUDA", {"align_corners": True, "size": 0.75, "interpolation": "floor"}),
    ("SHEncoder", {}), ("SHEncoder", {"degree": 3}),
]


def test_positional_encodings_match_jax():
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (50, 3)).astype(np.float32)
    for num_freqs, max_log2, inc in ((6, 5, True), (16, 5, True), (4, 3, False)):
        want = jenc.positional_encoding(jnp.asarray(x), num_freqs, max_log2, include_input=inc)
        got = enc.positional_encoding(torch.from_numpy(x), num_freqs, max_log2, include_input=inc)
        assert got.shape[-1] == enc.posenc_actual_dim(3, num_freqs, inc)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    for m in (1, 4, 6, 10):
        assert enc.get_embedder_dims(m) == jenc.get_embedder_dims(m)
        got = enc.nerf_embed(torch.from_numpy(x), m)
        np.testing.assert_allclose(got.numpy(), np.asarray(jenc.nerf_embed(jnp.asarray(x), m)),
                                   rtol=0, atol=ATOL)
        assert got.shape[-1] == enc.get_embedder_dims(m) + 3


def _bridge(jmod, mod, seed):
    params = jax.jit(jmod.init)(jax.random.PRNGKey(seed))
    mod.load_state_dict(from_jax_params(jax.tree_util.tree_map(np.asarray, params), mod))
    return params


@pytest.mark.parametrize("role", ["sdf", "view"])
@pytest.mark.parametrize("embed_type,overrides", FACTORY,
                         ids=[f"{t}-{i}" for i, (t, _) in enumerate(FACTORY)])
def test_factory_entry_matches_jax(embed_type, overrides, role):
    """Width, parameters, output, the tracer's ``fast`` output where the
    encoder has one, the x-gradient and the TV loss."""
    kw = SDF_KW if role == "sdf" else VIEW_KW
    jemb = j_build_embedder(embed_type, **kw, **overrides)
    emb = build_embedder(embed_type, **kw, **overrides)
    assert emb.embeddings_dim == jemb.embeddings_dim
    params = _bridge(jemb, emb, seed=3)
    rng = np.random.default_rng(4)
    # inside and outside the grids' boxes: unit directions for the view
    x = rng.uniform(-1.1, 1.1, (80, 3)).astype(np.float32)
    if role == "view":
        x /= np.linalg.norm(x, axis=1, keepdims=True)

    want = np.asarray(jemb.apply(params, jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = emb(xt)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=ATOL)

    cot = rng.normal(size=want.shape).astype(np.float32)
    jg = jax.grad(lambda xx: jnp.sum(jemb.apply(params, xx) * cot))(jnp.asarray(x))
    (g,) = torch.autograd.grad((got * torch.from_numpy(cot)).sum(), xt)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=0,
                               atol=GRAD_TOL * max(1.0, float(np.abs(jg).max())))

    try:
        jfast = np.asarray(jemb.apply(params, jnp.asarray(x), fast=True))
    except TypeError:  # JAX's _embed falls back to the plain apply
        jfast = want
    with torch.no_grad():
        fast = emb(torch.from_numpy(x), fast=True).numpy()
    np.testing.assert_allclose(fast, jfast, rtol=0, atol=3e-2 if embed_type.endswith("NFFB")
                               or embed_type.startswith("FFB") else ATOL)

    jtv = jemb.tv_loss(params, jnp.asarray(x))
    tv = emb.tv_loss(torch.from_numpy(x))
    assert (tv is None) == (jtv is None)
    if tv is not None:
        np.testing.assert_allclose(float(tv.detach()), float(jtv), rtol=1e-5, atol=1e-12)


@pytest.mark.parametrize("mode,view,multires_view,d_in",
                         [("idr", "NerfPos", 4, 9), ("idr", "NerfPos", 6, 9),
                          ("idr", "HashGridCUDA", 4, 9), ("no_view_dir", "NerfPos", 0, 6),
                          ("no_normal", "NerfPos", 4, 6), ("no_view_dir", "SHEncoder", 4, 6)])
def test_rendering_network_modes_match_jax(mode, view, multires_view, d_in):
    """'nerfpos' views go through ``nerf_embed`` at the declared width
    ``get_embedder_dims``; outside mode 'idr' no view embedder is built."""
    kw = dict(feature_vector_size=32, mode=mode, d_in=d_in, d_out=3, dims=[64, 64],
              weight_norm=True, multires_view=multires_view, viewdirs_embed_type=view)
    jnet, net = JRenderingNetwork(**kw), RenderingNetwork(**kw)
    assert net.dims == jnet.dims
    params = _bridge(jnet, net, seed=5)
    rng = np.random.default_rng(6)
    pts, normals, feats = (rng.normal(size=(40, k)).astype(np.float32) for k in (3, 3, 32))
    views = rng.normal(size=(40, 3)).astype(np.float32)
    views /= np.linalg.norm(views, axis=1, keepdims=True)
    want = jnet.apply(params, *(jnp.asarray(a) for a in (pts, normals, views, feats)))
    got = net(*(torch.from_numpy(a) for a in (pts, normals, views, feats)))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=ATOL)


def test_rendering_network_refuses_an_unknown_mode():
    with pytest.raises(ValueError, match="rendering mode"):
        RenderingNetwork(32, "idr_typo", 9, 3, [64])


@pytest.mark.parametrize("conf", CONFS)
def test_every_repo_conf_builds_an_idr_network(conf):
    """The model block of every conf in the repo builds on the CPU, with the
    JAX network's layer widths; a fusion-eligible SDF MLP gets a CUDA
    kernel depth."""
    jmodel = JIDRNetwork(j_parse_file(str(CONF_DIR / conf)).get_config("model"))
    model = IDRNetwork(parse_file(str(CONF_DIR / conf)).get_config("model"), device="cpu")
    assert model.implicit_network.dims == jmodel.implicit_network.dims
    assert model.rendering_network.dims == jmodel.rendering_network.dims
    assert model.tracer_mode == jmodel.tracer_mode
    assert tuple(model.ray_tracer) == tuple(jmodel.ray_tracer)
    dims = model.implicit_network.dims
    if fm.supports_fusion(dims, model.implicit_network.skip_in):
        assert dims[0] <= fm.kernel_depth(dims[0]) < 2 * max(dims[0], 64)

"""The port's spherical-harmonics view encoder against the JAX package: the
basis for degrees 1-5 (atol 1e-6), the factory preset, and
``RenderingNetwork`` with ``viewdirs_embed_type = SHEncoder`` through
``from_jax_params`` (atol 1e-5).  Every training conf in the repo uses it.
"""

import pathlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hashmodnffbanks_idr_tpu.config.hocon import parse_file as j_parse_file
from hashmodnffbanks_idr_tpu.models.networks import RenderingNetwork as JRenderingNetwork
from hashmodnffbanks_idr_tpu.ops import encodings as jenc

from hashmodnffbanks_idr_tpu_torch.config.hocon import parse_file
from hashmodnffbanks_idr_tpu_torch.models.embedders import SHEmbedder, build_embedder
from hashmodnffbanks_idr_tpu_torch.models.networks import RenderingNetwork
from hashmodnffbanks_idr_tpu_torch.ops import encodings as enc
from hashmodnffbanks_idr_tpu_torch.weights import from_jax_params

DUMMY_CONF = str(pathlib.Path(__file__).resolve().parents[1]
                 / "hashmodnffbanks_idr_tpu/config/confs/dummy_stylemodnffb.conf")
REND_KW = dict(feature_vector_size=32, mode="idr", d_in=9, d_out=3, dims=[64, 64],
               weight_norm=True, multires_view=4, viewdirs_embed_type="SHEncoder")


def _unit_dirs(n, seed):
    d = np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


@pytest.mark.parametrize("degree", [1, 2, 3, 4, 5])
def test_spherical_harmonics_matches_jax(degree):
    d = _unit_dirs(500, degree)
    want = np.asarray(jenc.spherical_harmonics(jnp.asarray(d), degree))
    got = enc.spherical_harmonics(torch.from_numpy(d), degree).numpy()
    assert got.shape == want.shape == (500, degree**2)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_sh_factory_preset_and_unported_embedders():
    emb = build_embedder("SHEncoder", input_dims=3, multires=6, log2_max_hash_size=5,
                         max_points_per_entry=2, base_resolution=16,
                         desired_resolution=512, bound=1.0)
    assert isinstance(emb, SHEmbedder) and emb.degree == 4 and emb.embeddings_dim == 16
    assert not list(emb.parameters())
    # every JAX embed_type is ported now: only an unknown type is refused,
    # with the JAX factory's error
    with pytest.raises(ValueError, match="Not a valid embedding model type"):
        build_embedder("HashGridTcnnX", input_dims=3, multires=6, log2_max_hash_size=5,
                       max_points_per_entry=2, base_resolution=16,
                       desired_resolution=512, bound=1.0)


def test_rendering_network_sh_matches_jax():
    """SH of degree ``multires_view`` (not the factory's preset): 16 dims,
    so ``dims[0] = 9 + 32 + 16 - 3``; the JAX params hold an empty
    ``view_embed`` that the bridge maps to nothing."""
    jnet = JRenderingNetwork(**REND_KW)
    net = RenderingNetwork(**REND_KW)
    assert net.dims == jnet.dims == [54, 64, 64, 3]
    params = jax.jit(jnet.init)(jax.random.PRNGKey(5))
    assert params["view_embed"] == {}
    params_np = jax.tree_util.tree_map(np.asarray, params)
    net.load_state_dict(from_jax_params(params_np, net))

    rng = np.random.default_rng(6)
    pts = rng.uniform(-0.5, 0.5, (128, 3)).astype(np.float32)
    normals = rng.normal(size=(128, 3)).astype(np.float32)
    view = _unit_dirs(128, 7)
    feats = rng.normal(size=(128, 32)).astype(np.float32)
    want = np.asarray(jax.jit(jnet.apply)(params, pts, normals, view, feats))
    got = net(*map(torch.from_numpy, (pts, normals, view, feats))).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_dummy_conf_rendering_width_matches_jax():
    """The repo's dummy conf at full width: 9 + 256 + 13 = 278 inputs."""
    jconf, conf = j_parse_file(DUMMY_CONF), parse_file(DUMMY_CONF)
    jnet = JRenderingNetwork(256, **jconf.get_config("model.rendering_network").data)
    net = RenderingNetwork(256, **conf.get_config("model.rendering_network").data)
    assert net.dims == jnet.dims == [278, 512, 512, 512, 512, 3]

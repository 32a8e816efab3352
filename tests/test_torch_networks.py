"""The port's networks against the JAX package through ``from_jax_params``:
the StyleModNFFB/FFB embedders, ``ImplicitNetwork`` (outputs, spatial
gradient, bf16 fast path) and ``RenderingNetwork`` with the deep view
embedder, at small widths.  Outputs atol 1e-5, gradients atol 1e-4.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hashmodnffbanks_idr_tpu.models.embedders import build_embedder as j_build_embedder
from hashmodnffbanks_idr_tpu.models.networks import ImplicitNetwork as JImplicitNetwork
from hashmodnffbanks_idr_tpu.models.networks import RenderingNetwork as JRenderingNetwork

from hashmodnffbanks_idr_tpu_torch.models.embedders import build_embedder
from hashmodnffbanks_idr_tpu_torch.models.networks import ImplicitNetwork, RenderingNetwork
from hashmodnffbanks_idr_tpu_torch.weights import from_jax_params

EMB_KW = dict(multires=6, log2_max_hash_size=5, max_points_per_entry=2,
              base_resolution=16, desired_resolution=512, bound=0.45)
IMPL_KW = dict(feature_vector_size=32, d_in=3, d_out=1, dims=[64] * 6, geometric_init=True,
               bias=0.6, skip_in=[4], weight_norm=True, embed_type="StyleModNFFB", **EMB_KW)
REND_KW = dict(feature_vector_size=32, mode="idr", d_in=9, d_out=3, dims=[64, 64],
               weight_norm=True, multires_view=4, viewdirs_embed_type="StyleModNFFB")


def _load(jmod, mod, seed=0):
    params = jax.jit(jmod.init)(jax.random.PRNGKey(seed))
    params_np = jax.tree_util.tree_map(np.asarray, params)
    mod.load_state_dict(from_jax_params(params_np, mod))
    return params


def _points(n, seed, scale=0.5):
    return np.random.default_rng(seed).uniform(-scale, scale, (n, 3)).astype(np.float32)


@pytest.mark.parametrize("embed_type", ["StyleModNFFB", "FFB"])
def test_nffb_embedder_matches_jax(embed_type):
    jemb = j_build_embedder(embed_type, input_dims=3, network_dims=[3, 64], **EMB_KW)
    emb = build_embedder(embed_type, input_dims=3, **EMB_KW)
    assert emb.embeddings_dim == jemb.embeddings_dim == 59
    assert emb.nffb_lin_dims == jemb.nffb_lin_dims == [3, 56, 56, 56, 56, 56]
    params = _load(jemb, emb)
    # the Fourier-aux B of the grid is a trained parameter
    assert emb.grid.ff.B.requires_grad and tuple(emb.grid.ff.B.shape) == (3, 6)
    x = _points(300, 1, scale=0.6)  # some outside the [-bound, bound] box
    want = np.asarray(jax.jit(jemb.apply)(params, jnp.asarray(x)))
    got = emb(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # the tracer's bf16 fast path follows JAX's own bf16 path
    want_f = np.asarray(jax.jit(lambda p, x: jemb.apply(p, x, fast=True))(params, x))
    got_f = emb(torch.from_numpy(x), fast=True).detach().numpy()
    np.testing.assert_allclose(got_f, want_f, rtol=0, atol=2e-2)


@pytest.fixture(scope="module")
def implicit():
    jnet = JImplicitNetwork(**IMPL_KW)
    net = ImplicitNetwork(**IMPL_KW)
    assert net.dims == jnet.dims == [59, 64, 64, 64, 64, 64, 64, 33]
    params = _load(jnet, net)
    return jnet, params, net


def test_implicit_apply_and_gradient_match_jax(implicit):
    jnet, params, net = implicit
    x = _points(256, 2)
    want = np.asarray(jax.jit(jnet.apply)(params, jnp.asarray(x)))
    got = net(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)

    want_g = np.asarray(jax.jit(jnet.gradient)(params, jnp.asarray(x)))
    got_g = net.gradient(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got_g, want_g, rtol=0, atol=1e-4)


def test_implicit_fast_path_matches_jax(implicit):
    jnet, params, net = implicit
    x = _points(256, 3)
    want = np.asarray(jax.jit(lambda p, x: jnet.apply(p, x, fast=True))(params, x))[:, 0]
    with torch.no_grad():
        got = net.make_fast_sdf(precision="bf16")(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=3e-2)


def test_eikonal_second_order_matches_jax(implicit):
    """d/dparams of the eikonal penalty: the double backward through the
    SIREN trunk, instance norm and style linear."""
    jnet, params, net = implicit
    x = _points(64, 4)

    def jpen(p):
        g = jnet.gradient(p, jnp.asarray(x))
        return jnp.mean((jnp.linalg.norm(g, axis=-1) - 1.0) ** 2)

    jg = jax.jit(jax.grad(jpen))(params)
    net.zero_grad(set_to_none=True)
    g = net.gradient(torch.from_numpy(x))
    ((torch.linalg.vector_norm(g, dim=-1) - 1.0) ** 2).mean().backward()
    for name, want in (("lin.0.v", jg["lin"][0]["v"]),
                       ("embedder.ff_lin.1.w", jg["embed"]["ff_lin"][1]["w"]),
                       ("embedder.style.linear_transform.w",
                        jg["embed"]["style"]["linear_transform"]["w"]),
                       ("embedder.grid.table", jg["embed"]["grid"]["table"])):
        got = dict(net.named_parameters())[name].grad.numpy()
        got = got.T if name.endswith((".v", ".w")) else got
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-3, atol=1e-4, err_msg=name)
    # zero by construction: the singleton softmax and the detached beta
    assert float(net.embedder.style.attention.w.grad.abs().max()) == 0.0
    assert net.density.beta.grad is None


def test_rendering_network_matches_jax():
    jnet = JRenderingNetwork(**REND_KW)
    net = RenderingNetwork(**REND_KW)
    assert net.dims == jnet.dims == [81, 64, 64, 3]
    params = _load(jnet, net, seed=5)
    rng = np.random.default_rng(6)
    pts, normals = _points(128, 7), rng.normal(size=(128, 3)).astype(np.float32)
    view = rng.normal(size=(128, 3)).astype(np.float32)
    view /= np.linalg.norm(view, axis=-1, keepdims=True)
    feats = rng.normal(size=(128, 32)).astype(np.float32)
    want = np.asarray(jax.jit(jnet.apply)(params, pts, normals, view, feats))
    got = net(*map(torch.from_numpy, (pts, normals, view, feats))).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_weight_bridge_rejects_unmatched_leaves(implicit):
    _, params, net = implicit
    params_np = jax.tree_util.tree_map(np.asarray, params)
    with pytest.raises(KeyError):
        from_jax_params({**params_np, "extra": {"w": np.zeros((2, 2))}}, net)
    with pytest.raises(KeyError):
        from_jax_params({k: v for k, v in params_np.items() if k != "density"}, net)

"""Level-pruned tracer guidance and the fused kernel at every first-layer
depth, against the JAX package.

``ImplicitNetwork`` on the instant-ngp grid (HashGridTcnn at log2 15, the
page-path table, d_in 15) with the 8-layer skip-4 MLP (width 128 here, so
``supports_fusion`` holds and the port runs the kernel's plain twin):
``forward`` and ``make_fast_sdf`` with ``max_level``/``floor_interp``, f32
against JAX's ``apply`` at 1e-5 and bf16 against JAX's ``make_fast_sdf(...,
interpret=True)`` (its Pallas kernel in interpret mode) at 3e-2 with signs
agreeing where |sdf| > 5e-2.  The fused kernel's plain twin against the
Pallas kernel at d_in 15 and 102 (f32 1e-5, bf16 3e-2), and the kernel
depth the wrapper picks for every d_in.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hashmodnffbanks_idr_tpu.models.networks import ImplicitNetwork as JImplicitNetwork
from hashmodnffbanks_idr_tpu.ops import fused_mlp as jfm

from hashmodnffbanks_idr_tpu_torch.models.networks import ImplicitNetwork
from hashmodnffbanks_idr_tpu_torch.ops import fused_mlp as fm
from hashmodnffbanks_idr_tpu_torch.ops.linear import Linear
from hashmodnffbanks_idr_tpu_torch.weights import from_jax_params

NGP_KW = dict(feature_vector_size=32, d_in=3, d_out=1, dims=[128] * 8, geometric_init=True,
              bias=0.6, skip_in=[4], weight_norm=True, multires=6, embed_type="HashGridTcnn",
              log2_max_hash_size=15, max_points_per_entry=2, base_resolution=16,
              desired_resolution=512, bound=0.75)
TOL_F32 = 1e-5   # raw SDFs near 1 here: float32 over nine layers
TOL_BF16 = 3e-2


@pytest.fixture(scope="module")
def ngp_nets():
    jnet = JImplicitNetwork(**NGP_KW)
    params = jax.jit(jnet.init)(jax.random.PRNGKey(0))
    # trained weights read the encoding, which the geometric init leaves
    # unread (zero rows in l0 and the skip layer), and a trained table is far
    # from its 1e-4 init: spread both so that pruning moves the SDF
    keys = jax.random.split(jax.random.PRNGKey(1), 3)
    emb = params["embed"]
    emb["table"] = emb["table"] + 0.05 * jax.random.normal(keys[0], emb["table"].shape)
    for key, lin in zip(keys[1:], (params["lin"][0], params["lin"][4])):
        lin["v"] = lin["v"] + 0.3 * jax.random.normal(key, lin["v"].shape)
    net = ImplicitNetwork(**NGP_KW)
    net.load_state_dict(from_jax_params(jax.tree_util.tree_map(np.asarray, params), net))
    assert fm.supports_fusion(net.dims, net.skip_in) and net.dims[0] == 15
    assert net.supports_level_pruning() and jnet.supports_level_pruning()
    return jnet, params, net


def _points(n=300, seed=2):
    return np.random.default_rng(seed).uniform(-0.8, 0.8, (n, 3)).astype(np.float32)


@pytest.mark.parametrize("max_level,floor_interp",
                         [(None, False), (None, True), (3, False), (3, True), (1, True),
                          (16, True)])
def test_pruned_sdf_matches_jax(ngp_nets, max_level, floor_interp):
    """The f32 guidance SDF (``forward`` and ``make_fast_sdf('f32')``, both
    fused and through the layers) equals JAX's ``apply`` with the same
    pruning; K >= the level count prunes nothing."""
    jnet, params, net = ngp_nets
    x = _points()
    want = np.asarray(jnet.apply(params, jnp.asarray(x), max_level=max_level,
                                 floor_interp=floor_interp))
    with torch.no_grad():
        xt = torch.from_numpy(x)
        got = net(xt, max_level=max_level, floor_interp=floor_interp).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        for fused in (True, False):
            sdf = net.make_fast_sdf("f32", max_level=max_level, floor_interp=floor_interp,
                                    fused=fused)
            np.testing.assert_allclose(sdf(xt).numpy(), want[:, 0], rtol=0, atol=1e-5)
    if max_level is not None or floor_interp:
        full = np.asarray(jnet.apply(params, jnp.asarray(x)))[:, 0]
        assert np.abs(want[:, 0] - full).max() > 1e-3  # the guidance differs


@pytest.mark.parametrize("max_level,floor_interp", [(None, False), (3, True), (16, True)])
def test_pruned_bf16_sdf_matches_jax_kernel(ngp_nets, max_level, floor_interp):
    """The bf16 guidance SDF through the fused kernel's plain twin against
    JAX's through the Pallas kernel in interpret mode."""
    jnet, params, net = ngp_nets
    x = _points(n=257, seed=3)
    want = np.asarray(jnet.make_fast_sdf(params, interpret=True, max_level=max_level,
                                         floor_interp=floor_interp)(jnp.asarray(x)))
    with torch.no_grad():
        got = net.make_fast_sdf("bf16", max_level=max_level,
                                floor_interp=floor_interp)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL_BF16)
    big = np.abs(want) > 5e-2
    assert (np.sign(got[big]) == np.sign(want[big])).all()


def _packed_pair(d_in, seed):
    """The same random 8x512 skip-4 weights as JAX's packed dict and the
    port's."""
    g = torch.Generator().manual_seed(seed)
    dims = [d_in] + [512] * 8 + [33]
    lins = []
    for l in range(9):
        d_out = dims[l + 1] - d_in if l + 1 == 4 else dims[l + 1]
        lin = Linear(dims[l], d_out, weight_norm=True)
        lin.init_normal(g, 0.0, float(np.sqrt(2.0 / d_out)), 0.0)
        lin.b.data.uniform_(-0.05, 0.05, generator=g)
        lins.append(lin)
    jlin = [{"v": jnp.asarray(l.v.detach().numpy().T), "g": jnp.asarray(l.g.detach().numpy()),
             "b": jnp.asarray(l.b.detach().numpy())} for l in lins]
    return jlin, lins


@pytest.mark.parametrize("d_in", [15, 102])
@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_plain_twin_matches_pallas_kernel_at_new_depths(d_in, precision):
    """The kernel's math at the encoders' first-layer depths (HashGridTcnn
    15, NerfPos multires 16: 102), past the 64 the CUDA kernel was first
    compiled for."""
    jdt, dt = ((jnp.float32, torch.float32) if precision == "f32"
               else (jnp.bfloat16, torch.bfloat16))
    jlin, lins = _packed_pair(d_in, seed=d_in)
    jpacked = jfm.pack_params(jlin, d_in, 512, dtype=jdt)
    packed = fm.pack_params(lins, d_in, 512, dtype=dt)
    rng = np.random.default_rng(d_in)
    for n in (1, 65, 300):
        x = rng.normal(scale=0.3, size=(n, d_in)).astype(np.float32)
        want = np.asarray(jfm.fused_sdf_raw(jnp.asarray(x), jpacked, d_in, 512, interpret=True))
        got = fm.fused_sdf_raw(torch.from_numpy(x), packed).numpy()
        if precision == "f32":
            np.testing.assert_allclose(got, want, rtol=0, atol=TOL_F32)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=TOL_BF16)
            big = np.abs(want) > 5e-2
            assert (np.sign(got[big]) == np.sign(want[big])).all()


def test_kernel_depth_covers_every_supported_d_in():
    """The wrapper takes the smallest compiled depth that covers d_in, for
    every d_in the JAX kernel takes (< 512), and refuses the rest."""
    assert [fm.kernel_depth(d) for d in (1, 9, 15, 27, 31, 42, 59, 64, 65, 102, 128, 129,
                                         256, 257, 511)] == \
        [64, 64, 64, 64, 64, 64, 64, 64, 128, 128, 128, 256, 256, 512, 512]
    for d in (0, 512, 600):
        with pytest.raises(ValueError, match="d_in"):
            fm.kernel_depth(d)
    assert all(fm.supports_fusion([d] + [512] * 8 + [257], (4,)) == (d < 512)
               == jfm.supports_fusion([d] + [512] * 8 + [257], (4,)) for d in (15, 102, 511, 512))

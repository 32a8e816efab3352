"""PyTorch port ops against the JAX package: linear/softplus, encodings and
the floor hash-grid encode, on the same numpy-seeded inputs (atol 1e-6)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hashmodnffbanks_idr_tpu.ops import encodings as jenc
from hashmodnffbanks_idr_tpu.ops import hashgrid as jhg
from hashmodnffbanks_idr_tpu.ops import linear as jlin

from hashmodnffbanks_idr_tpu_torch.ops import encodings as enc
from hashmodnffbanks_idr_tpu_torch.ops import hashgrid as hg
from hashmodnffbanks_idr_tpu_torch.ops.linear import Linear, softplus

ATOL = 1e-6


def _port_linear(p):
    lin = Linear(*np.asarray(p.get("v", p.get("w"))).shape, weight_norm="v" in p)
    with torch.no_grad():
        for k, v in p.items():
            v = np.asarray(v)
            getattr(lin, k).copy_(torch.from_numpy(v.T.copy() if v.ndim == 2 else v.copy()))
    return lin


@pytest.mark.parametrize("weight_norm", [False, True])
@pytest.mark.parametrize("bf16", [False, True])
def test_linear_matches_jax(weight_norm, bf16):
    rng = np.random.default_rng(0)
    # unit-scale outputs, so atol 1e-6 is ~10 float32 ulps
    p = {"w": jnp.asarray(rng.normal(size=(17, 9)).astype(np.float32) * 0.25),
         "b": jnp.asarray(rng.normal(size=(9,)).astype(np.float32) * 0.25)}
    if weight_norm:
        p = jlin.weight_normalize(p)
        p["g"] = p["g"] * 1.3  # g no longer equals ||v||
    x = rng.normal(size=(33, 17)).astype(np.float32) * 0.5
    want = jlin.apply_linear(p, jnp.asarray(x), compute_dtype=jnp.bfloat16 if bf16 else None)
    got = _port_linear(p)(torch.from_numpy(x), bf16=bf16)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0,
                               atol=ATOL * (10 if bf16 else 1))


def test_softplus_matches_jax():
    x = np.concatenate([np.linspace(-1, 1, 2001), [0.2, 0.2 + 1e-7, -30.0, 30.0]])
    x = x.astype(np.float32)
    want = np.asarray(jlin.softplus(jnp.asarray(x), beta=100.0))
    got = softplus(torch.from_numpy(x), beta=100.0).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_frequency_encodings_match_jax():
    np.testing.assert_array_equal(enc.freq_bands(6, 5, True), jenc.freq_bands(6, 5, True))
    np.testing.assert_array_equal(enc.freq_bands(4, 3, False), jenc.freq_bands(4, 3, False))
    for d, f, inc in ((2, 6, True), (3, 4, False), (2, 4, True)):
        assert enc.posenc_declared_dim(d, f, inc) == jenc.posenc_declared_dim(d, f, inc)
        assert enc.posenc_actual_dim(d, f, inc) == jenc.posenc_actual_dim(d, f, inc)
        assert enc.fourier_features_dim(d, f, inc) == jenc.fourier_features_dim(d, f, inc)
    # the declared-vs-actual quirk NFFB relies on (frequency_enc.py:13-16,25):
    # declared for F=2 inputs, run on 2F=4 wide levels
    assert enc.posenc_declared_dim(2, 6, True) == 28
    assert enc.posenc_actual_dim(4, 6, True) == 56

    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, size=(40, 3)).astype(np.float32)
    B = rng.normal(size=(3, 6)).astype(np.float32) * 0.4
    for inc in (True, False):
        want = np.asarray(jenc.fourier_features(jnp.asarray(x), jnp.asarray(B), inc))
        got = enc.fourier_features(torch.from_numpy(x), torch.from_numpy(B), inc).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def _spec_pair(**kw):
    kw = {**dict(input_dim=3, num_levels=6, level_dim=2, base_resolution=16,
                 log2_hashmap_size=5, desired_resolution=512), **kw}
    return (hg.HashGridSpec(**kw, variant="torch", interpolation="floor"),
            jhg.HashGridSpec(**kw, variant="torch", interpolation="floor"))


@pytest.mark.parametrize("log2", [5, 12])
def test_floor_hash_encode_matches_jax(log2):
    spec, jspec = _spec_pair(log2_hashmap_size=log2)
    for m in ("level_resolutions", "level_sizes", "offsets", "padded_total_rows"):
        np.testing.assert_array_equal(getattr(spec, m)(), getattr(jspec, m)())
    rng = np.random.default_rng(2)
    # inside and outside [0, 1], negative, and far enough out that the
    # coordinate*prime products wrap uint32
    x = np.concatenate([rng.uniform(0, 1, (64, 3)), rng.uniform(-3, 4, (64, 3)),
                        rng.uniform(-2e4, 2e4, (64, 3))]).astype(np.float32)
    table = rng.normal(size=(spec.padded_total_rows(), 2)).astype(np.float32)
    want = np.asarray(jhg.hash_encode(jnp.asarray(x), jnp.asarray(table), jspec,
                                      zero_oob=False))
    got = hg.hash_encode(torch.from_numpy(x), torch.from_numpy(table), spec).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, jhg.hash_encode_numpy(x, table, jspec), rtol=0, atol=ATOL)


def test_hash_u32_wraps_like_uint32():
    rng = np.random.default_rng(3)
    coords = rng.integers(-2**31, 2**31, size=(500, 3), dtype=np.int64)
    got = hg._hash_u32(torch.from_numpy(coords), hg.TORCH_PRIMES).numpy()
    c = coords.astype(np.int32).astype(np.uint32).astype(np.uint64)
    want = np.zeros(500, np.uint64)
    for d in range(3):
        want ^= (c[:, d] * np.uint64(hg.TORCH_PRIMES[d])) & np.uint64(0xFFFFFFFF)
    np.testing.assert_array_equal(got, want.astype(np.int64))


def test_table_gradient_is_second_order():
    """The gather is differentiable in the table to second order (the
    eikonal term differentiates through the encoder twice)."""
    spec, _ = _spec_pair()
    x = torch.rand(20, 3, generator=torch.Generator().manual_seed(0))
    table = torch.randn(spec.padded_total_rows(), 2, requires_grad=True)
    y = (hg.hash_encode(x, table, spec) ** 2).sum()
    (g,) = torch.autograd.grad(y, table, create_graph=True)
    (gg,) = torch.autograd.grad(g.sum(), table)
    assert torch.isfinite(gg).all() and gg.abs().sum() > 0


def test_as_rows_accepts_page_image():
    spec, jspec = _spec_pair(log2_hashmap_size=12)
    rows = spec.padded_total_rows()
    table = jax.random.uniform(jax.random.PRNGKey(0), (rows, 2))
    pages = np.asarray(jhg.pack_pages(table))
    np.testing.assert_array_equal(hg.as_rows(pages, rows, 2), np.asarray(table))
    np.testing.assert_array_equal(hg.as_rows(np.asarray(table), rows, 2), np.asarray(table))
    with pytest.raises(ValueError):
        hg.as_rows(np.zeros((3, 5), np.float32), rows, 2)

"""The port's hash grid (``ops/hashgrid.py``) against the JAX package's.

Same numpy-seeded inputs and tables through both: the encode over variant x
interpolation x gridtype x align_corners x zero_oob, on points inside [0, 1],
outside it, negative and far out (uint32 wrap of the hash and of the dense
stride product), for a small table (JAX's one-hot path) and one past 1024
rows a level (JAX's page path, where ``inference`` rounds to bfloat16);
first- and second-order gradients in x and in the table; the level-pruned
encode with its fill, ``level_means`` and the TV loss.  Forward atol 1e-6;
gradients within 1e-5 of the largest gradient (the second-order table
gradient reaches ~1e3 through two position scales of up to 64, where float32
summation order alone moves the last digits).
"""

import itertools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hashmodnffbanks_idr_tpu.ops import hashgrid as jhg

from hashmodnffbanks_idr_tpu_torch.ops import hashgrid as hg

FWD_ATOL = 1e-6
GRAD_TOL = 1e-5


def _specs(**kw):
    kw = {**dict(input_dim=3, num_levels=4, level_dim=2, base_resolution=8,
                 log2_hashmap_size=5, desired_resolution=64), **kw}
    return hg.HashGridSpec(**kw), jhg.HashGridSpec(**kw)


def _points(seed, n=24):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.uniform(0, 1, (n, 3)), rng.uniform(-1.5, 2.0, (n, 3)),
                           rng.uniform(-300, 300, (n // 2, 3))]).astype(np.float32)


def _table(spec, seed):
    return np.random.default_rng(seed).normal(size=(spec.padded_total_rows(), 2)).astype(np.float32)


CASES = list(itertools.product(["ngp", "torch"], ["linear", "smoothstep", "floor"],
                               ["hash", "tiled"], [False, True]))


@pytest.mark.parametrize("variant,interpolation,gridtype,align_corners", CASES)
def test_hash_encode_matches_jax(variant, interpolation, gridtype, align_corners):
    """Both table sizes (log2 5: one-hot in JAX; log2 12: pages), zero_oob
    on and off, inference on and off."""
    x = _points(0)
    for log2 in (5, 12):
        spec, jspec = _specs(log2_hashmap_size=log2, variant=variant,
                             interpolation=interpolation, gridtype=gridtype,
                             align_corners=align_corners)
        for m in ("level_scales", "level_grid_resolutions", "level_sizes", "offsets",
                  "dense_mask", "padded_total_rows"):
            np.testing.assert_array_equal(getattr(spec, m)(), getattr(jspec, m)(), err_msg=m)
        assert spec.rounds_inference() == (log2 == 12)
        table = _table(spec, log2)
        for zero_oob, inference in itertools.product((False, True), (False, True)):
            want = np.asarray(jhg.hash_encode(jnp.asarray(x), jnp.asarray(table), jspec,
                                              zero_oob=zero_oob, inference=inference))
            got = hg.hash_encode(torch.from_numpy(x), torch.from_numpy(table), spec,
                                 zero_oob=zero_oob, inference=inference).numpy()
            np.testing.assert_allclose(got, want, rtol=0, atol=FWD_ATOL,
                                       err_msg=f"log2={log2} zero_oob={zero_oob} inf={inference}")


def test_inference_rounds_only_on_the_page_path():
    """bfloat16 rounding where JAX gathers from its bf16 page image (more than
    1024 rows in the largest level) and nowhere else, checked against the
    float32 encode of the same table."""
    x = torch.from_numpy(_points(1))
    for log2, rounds in ((5, False), (12, True)):
        spec, _ = _specs(log2_hashmap_size=log2)
        table = torch.from_numpy(_table(spec, 3))
        exact = hg.hash_encode(x, table, spec)
        approx = hg.hash_encode(x, table, spec, inference=True)
        from_bf16 = hg.hash_encode(x, table.to(torch.bfloat16).float(), spec)
        torch.testing.assert_close(approx, from_bf16 if rounds else exact, rtol=0, atol=1e-6)
        assert bool((approx != exact).any()) == rounds


def test_hash_arithmetic_wraps_like_uint32():
    """The dense stride index of a tiled grid and the hash of negative and
    huge coordinates wrap at 2^32 before the modulo, as JAX's uint32 does."""
    spec, jspec = _specs(gridtype="tiled", log2_hashmap_size=7)
    rng = np.random.default_rng(5)
    corners = rng.integers(-2**31, 2**31 - 2, size=(50, spec.num_levels, 8, 3)).astype(np.int32)
    want = np.asarray(jhg._level_indices(jspec, jnp.asarray(corners)))
    consts = hg.level_constants(spec)
    got = hg._level_rows(spec, consts, torch.from_numpy(corners.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("variant,interpolation,align_corners",
                         [("ngp", "linear", False), ("ngp", "smoothstep", True),
                          ("torch", "linear", False)])
def test_gradients_match_jax_to_second_order(variant, interpolation, align_corners):
    """d(sum enc^2)/d(x, table), and the table gradient of the squared
    x-gradient (the eikonal's mixed second derivative)."""
    spec, jspec = _specs(variant=variant, interpolation=interpolation,
                         align_corners=align_corners, log2_hashmap_size=12)
    rng = np.random.default_rng(6)
    x = rng.uniform(0.02, 0.98, (30, 3)).astype(np.float32)
    # features at a trained table's scale (~1e-2; the init is 1e-4): with unit
    # features the x-gradients reach ~1e2, where float32 holds ~1e-5 absolute
    table = _table(spec, 7) * np.float32(0.01)
    cot = rng.normal(size=(30, spec.output_dim())).astype(np.float32)

    def jf(xx, t):
        return jnp.sum(jhg.hash_encode(xx, t, jspec) * cot)

    def jsecond(xx, t):
        gx = jax.grad(jf, argnums=0)(xx, t)
        return jnp.sum(gx ** 2)

    jgx, jgt = jax.grad(jf, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(table))
    jgt2 = jax.grad(jsecond, argnums=1)(jnp.asarray(x), jnp.asarray(table))

    xt = torch.from_numpy(x).requires_grad_(True)
    tt = torch.from_numpy(table).requires_grad_(True)
    y = (hg.hash_encode(xt, tt, spec) * torch.from_numpy(cot)).sum()
    gx, gt = torch.autograd.grad(y, (xt, tt), create_graph=True)
    (gt2,) = torch.autograd.grad((gx ** 2).sum(), tt)
    for got, want in ((gx, jgx), (gt, jgt), (gt2, jgt2)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                                   atol=GRAD_TOL * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("variant,log2", [("ngp", 12), ("ngp", 5), ("torch", 12)])
def test_max_level_fill_and_level_means_match_jax(variant, log2):
    """``max_level`` freezes the growth factor; the fill is the level means of
    each level's own rows, zeroed out of bounds for ngp with zero_oob; value
    and table gradient."""
    spec, jspec = _specs(variant=variant, log2_hashmap_size=log2, num_levels=5)
    table = _table(spec, 8)
    means = hg.level_means(torch.from_numpy(table), spec)
    jmeans = jhg.level_means(jnp.asarray(table), jspec)
    np.testing.assert_allclose(means.numpy(), np.asarray(jmeans), rtol=0, atol=FWD_ATOL)
    for k in (1, 3):  # the truncated spec's constants are the full spec's first k
        for a, b in zip(hg.level_constants(spec.truncated(k)), hg.level_constants(spec).head(k)):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    x = _points(9)
    for K, zero_oob, with_fill in itertools.product((2, 4), (False, True), (False, True)):
        want = np.asarray(jhg.hash_encode(jnp.asarray(x), jnp.asarray(table), jspec,
                                          zero_oob=zero_oob, max_level=K,
                                          fill=jmeans if with_fill else None, inference=True))
        got = hg.hash_encode(torch.from_numpy(x), torch.from_numpy(table), spec,
                             zero_oob=zero_oob, max_level=K,
                             fill=means if with_fill else None, inference=True).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=FWD_ATOL,
                                   err_msg=f"K={K} zero_oob={zero_oob} fill={with_fill}")

    cot = np.random.default_rng(10).normal(size=(x.shape[0], spec.output_dim())).astype(np.float32)
    jg = jax.grad(lambda t: jnp.sum(jhg.hash_encode(
        jnp.asarray(x), t, jspec, max_level=3, fill=jhg.level_means(t, jspec)) * cot))(
        jnp.asarray(table))
    tt = torch.from_numpy(table).requires_grad_(True)
    y = (hg.hash_encode(torch.from_numpy(x), tt, spec, max_level=3,
                        fill=hg.level_means(tt, spec)) * torch.from_numpy(cot)).sum()
    (g,) = torch.autograd.grad(y, tt)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-5, atol=GRAD_TOL)


@pytest.mark.parametrize("variant,gridtype", [("ngp", "hash"), ("ngp", "tiled"),
                                              ("torch", "hash")])
def test_total_variation_matches_jax(variant, gridtype):
    spec, jspec = _specs(variant=variant, gridtype=gridtype, log2_hashmap_size=12)
    x = _points(11)
    table = _table(spec, 12)
    jtv, jg = jax.value_and_grad(lambda t: jhg.total_variation_loss(jnp.asarray(x), t, jspec))(
        jnp.asarray(table))
    tt = torch.from_numpy(table).requires_grad_(True)
    tv = hg.total_variation_loss(torch.from_numpy(x), tt, spec)
    (g,) = torch.autograd.grad(tv, tt)
    np.testing.assert_allclose(float(tv.detach()), float(jtv), rtol=1e-5)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-5, atol=GRAD_TOL)


def test_as_rows_trims_the_page_images_tail():
    """The JAX ngp table stored as a page image whose page count is rounded
    up to 8 (ops/hashgrid.py:186-187) loads as the port's rows."""
    spec, jspec = _specs(log2_hashmap_size=15, num_levels=6, desired_resolution=512,
                         base_resolution=16)
    assert jhg.spec_uses_pages(jspec)
    pages = np.asarray(jhg.init_table(jax.random.PRNGKey(0), jspec))
    assert pages.shape[1] == 128 and pages.shape[0] % 8 == 0
    assert pages.size > spec.padded_total_rows() * 2
    rows = hg.as_rows(pages, spec.padded_total_rows(), 2)
    np.testing.assert_array_equal(rows[: spec.total_rows()],
                                  np.asarray(jhg.as_rows(jnp.asarray(pages), jspec)))

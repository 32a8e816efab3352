"""The port's fused SDF-MLP (pack_params + plain twin) against the JAX Pallas
kernel in interpret mode, at the flagship width 512 and d_in 59.

Tolerances as in tests/test_fused_mlp.py: f32 atol 2e-6; bf16 atol 3e-2
plus sign agreement where |sdf| > 5e-2.  The f32 CUDA kernel's split-TF32
arithmetic and the bf16 kernel's accumulation on ``wgmma`` are emulated
here and held to the same tolerances.  The CUDA kernel itself is held
against the plain twin by tests/test_torch_cuda.py (skipped without a
card) and by chip_smoke.py.
"""

import re
from fractions import Fraction

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hashmodnffbanks_idr_tpu.models.networks import ImplicitNetwork as JImplicitNetwork
from hashmodnffbanks_idr_tpu.ops import fused_mlp as jfm

from hashmodnffbanks_idr_tpu_torch.models.networks import ImplicitNetwork
from hashmodnffbanks_idr_tpu_torch.ops import fused_mlp as fm
from hashmodnffbanks_idr_tpu_torch.ops.linear import softplus
from hashmodnffbanks_idr_tpu_torch.weights import from_jax_params

NET_KW = dict(feature_vector_size=256, d_in=3, d_out=1, dims=[512] * 8,
              geometric_init=True, bias=0.6, skip_in=[4], weight_norm=True,
              multires=6, embed_type="StyleModNFFB", log2_max_hash_size=5,
              max_points_per_entry=2, base_resolution=16, desired_resolution=512,
              bound=0.45)


@pytest.fixture(scope="module")
def nets():
    jnet = JImplicitNetwork(**NET_KW)
    params = jax.jit(jnet.init)(jax.random.PRNGKey(0))
    net = ImplicitNetwork(**NET_KW)
    net.load_state_dict(from_jax_params(jax.tree_util.tree_map(np.asarray, params), net))
    return jnet, params, net


def _inputs(n, seed):
    """Embedding-like inputs: the first 3 columns in [0, 1], the rest O(0.1)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(scale=0.1, size=(n, 59)).astype(np.float32)
    x[:, :3] = rng.uniform(0.1, 0.9, size=(n, 3))
    return x


@pytest.mark.parametrize("precision", ["f32", "bf16"])
# 63-65: the edges of the CUDA kernels' 64-point tile
@pytest.mark.parametrize("n", [1, 63, 64, 65, 96, 513])
def test_plain_matches_pallas_kernel(nets, precision, n):
    jnet, params, net = nets
    jdt, dt = ((jnp.float32, torch.float32) if precision == "f32"
               else (jnp.bfloat16, torch.bfloat16))
    jpacked = jfm.pack_params(params["lin"], 59, 512, dtype=jdt)
    packed = fm.pack_params(net.lin, 59, 512, dtype=dt)
    # same weights, the port without the 128-lane padding; the f32 effective
    # weights may differ in the last ulp, which can move a bf16 rounding
    rtol = 2e-6 if precision == "f32" else 2.0**-7
    for k, sl in (("w_in", np.s_[:59]), ("w_mid", np.s_[:]), ("b_in", np.s_[:]),
                  ("b_mid", np.s_[:]), ("w_out", np.s_[:, 0]), ("b_out", np.s_[:1])):
        want = np.asarray(jnp.asarray(jpacked[k], jnp.float32))[sl]
        np.testing.assert_allclose(packed[k].float().numpy(), want, rtol=rtol, atol=1e-7,
                                   err_msg=k)

    x = _inputs(n, seed=n)
    want = np.asarray(jfm.fused_sdf_raw(jnp.asarray(x), jpacked, 59, 512, interpret=True))
    got = fm.fused_sdf_raw(torch.from_numpy(x), packed).numpy()
    assert got.shape == (n,)
    if precision == "f32":
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=3e-2)
        big = np.abs(want) > 5e-2
        assert (np.sign(got[big]) == np.sign(want[big])).all()


def _tf32(t):
    """float32 -> TF32 (10 mantissa bits), to nearest with ties away from
    zero: the bits of ``cvt.rna.tf32.f32``, computed on the int32 view as
    the kernel computes them."""
    return ((t.contiguous().view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _dot_split_tf32(h, w):
    """The f32 kernel's product: each operand split as hi + lo, three TF32
    products in float32, the two small ones first."""
    h_hi, w_hi = _tf32(h), _tf32(w)
    h_lo, w_lo = _tf32(h - h_hi), _tf32(w - w_hi)
    return (h_lo @ w_hi + h_hi @ w_lo) + h_hi @ w_hi


def _dot_one_tf32(h, w):
    return _tf32(h) @ _tf32(w)


def _emulated_sdf(x, packed, dot):
    """fused_sdf_raw_plain with the eight matrix layers' products taken by
    ``dot``; the last layer stays a float32 dot of the activations in the
    weight type, as in the kernel."""
    skip_cols = packed["w_in"].shape[1] - x.shape[1]
    h = softplus(dot(x, packed["w_in"]) + packed["b_in"])
    for l in range(packed["w_mid"].shape[0]):
        h = softplus(dot(h, packed["w_mid"][l]) + packed["b_mid"][l])
        if l == fm.SKIP_AFTER_MID:
            h = torch.cat([h[:, :skip_cols], x], dim=1) * (1.0 / np.sqrt(2.0))
    wd = packed["w_out"].dtype
    return h.to(wd).float() @ packed["w_out"].float() + packed["b_out"][0]


_PALLAS_F32 = {}


def _pallas_f32(nets, n):
    """Inputs of n points, the port's packed f32 weights and the Pallas
    kernel's output on them (interpret mode; computed once per n)."""
    _, params, net = nets
    if n not in _PALLAS_F32:
        jpacked = jfm.pack_params(params["lin"], 59, 512, dtype=jnp.float32)
        x = _inputs(n, seed=n)
        _PALLAS_F32[n] = (x, np.asarray(jfm.fused_sdf_raw(jnp.asarray(x), jpacked, 59, 512,
                                                            interpret=True)))
    x, want = _PALLAS_F32[n]
    return torch.from_numpy(x), fm.pack_params(net.lin, 59, 512, dtype=torch.float32), want


@pytest.mark.parametrize("n", [1, 96, 513])
def test_split_tf32_scheme_matches_pallas_kernel(nets, n):
    """The CUDA f32 kernel's arithmetic (three TF32 products per float32
    product on the tensor cores), emulated in torch, holds the f32 Pallas
    kernel's tolerance."""
    x, packed, want = _pallas_f32(nets, n)
    got = _emulated_sdf(x, packed, _dot_split_tf32).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


# the fold depths (8-deep k-steps a partial sum spans) the f32 kernel may
# take: csrc/fused_mlp.cu f32::FOLD, which must divide l0's 64-deep K0
FOLDS = (1, 2, 4, 8)


def _dot_split_tf32_folded(fold):
    """The wgmma kernel's product: each operand split as hi + lo, the low
    13 bits of both cleared (``_tf32``), three TF32 products; the tensor
    cores sum the products of ``fold`` 8-deep k-steps into a fresh partial
    sum (here exactly, then rounded to float32), and round-to-nearest
    float32 adds fold the partial sums into the accumulator in k order."""
    depth = 8 * fold

    def dot(h, w):
        h_hi, w_hi = _tf32(h), _tf32(w)
        h_lo, w_lo = _tf32(h - h_hi), _tf32(w - w_hi)
        k = h.shape[1]
        pad = -k % depth  # the kernel's zero rows past d_in
        hs = [torch.nn.functional.pad(v, (0, pad)).double() for v in (h_hi, h_lo)]
        ws = [torch.nn.functional.pad(v, (0, 0, 0, pad)).double() for v in (w_hi, w_lo)]
        acc = torch.zeros(h.shape[0], w.shape[1], dtype=torch.float32)
        for k0 in range(0, k + pad, depth):
            sl = slice(k0, k0 + depth)
            part = (hs[1][:, sl] @ ws[0][sl] + hs[0][:, sl] @ ws[1][sl]
                    + hs[0][:, sl] @ ws[0][sl])
            acc = acc + part.float()
        return acc
    return dot


@pytest.mark.parametrize("fold", FOLDS)
@pytest.mark.parametrize("n", [1, 96, 513])
def test_wgmma_split_tf32_fold_matches_pallas_kernel(nets, fold, n):
    """The f32 kernel's arithmetic on ``wgmma`` (split-TF32 with explicit hi
    and lo, and a fresh partial sum folded every ``fold`` k-steps), emulated
    in torch, holds the f32 Pallas kernel's tolerance at every fold depth
    the kernel may take."""
    x, packed, want = _pallas_f32(nets, n)
    got = _emulated_sdf(x, packed, _dot_split_tf32_folded(fold)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


def test_kernel_fold_depth_is_one_of_the_emulated():
    """The fold depth compiled into the f32 kernel is one the test above
    holds, and divides l0's shallowest depth."""
    m = re.search(r"constexpr int FOLD = (\d+);", fm._CSRC.read_text())
    assert m and int(m.group(1)) in FOLDS and fm.KERNEL_DEPTHS[0] % (8 * int(m.group(1))) == 0


def test_one_tf32_product_misses_the_card_tolerance(nets):
    """A kernel that took only hi*hi (plain TF32) would fail the card's 1e-5
    check (chip_smoke.py, tests/test_torch_cuda.py), so that check tells it
    from the split-TF32 scheme."""
    x, packed, want = _pallas_f32(nets, 513)
    assert np.abs(_emulated_sdf(x, packed, _dot_one_tf32).numpy() - want).max() > 1e-5


def _dot_bf16_k16_truncated(h, w):
    """The bf16 kernel's product on ``wgmma``: both operands bf16, exact
    products, each 16-deep k-step's sum added into the float accumulator
    rounded toward zero (the tensor cores' truncating adds), in k order,
    the first k-step setting it; no fold into a separately rounded sum."""
    hb, wb = h.to(torch.bfloat16).double(), w.double()
    pad = -hb.shape[1] % 16  # the kernel's zero rows past d_in
    hb = torch.nn.functional.pad(hb, (0, pad))
    wb = torch.nn.functional.pad(wb, (0, 0, 0, pad))
    acc = torch.zeros(h.shape[0], w.shape[1], dtype=torch.float32)
    for k0 in range(0, hb.shape[1], 16):
        exact = acc.double() + hb[:, k0:k0 + 16] @ wb[k0:k0 + 16]
        near = exact.float()
        acc = torch.where(near.double().abs() > exact.abs(),
                          torch.nextafter(near, torch.zeros_like(near)), near)
    return acc


_PALLAS_BF16 = {}


@pytest.mark.parametrize("n", [1, 96, 513])
def test_bf16_wgmma_accumulation_matches_pallas_kernel(nets, n):
    """The bf16 CUDA kernel's arithmetic (bf16 operands, float accumulators
    that the tensor cores add into with truncation, 16 k at a time, with no
    fold), emulated in torch, holds the bf16 Pallas kernel's tolerance with
    the signs agreeing: the truncating adds stay far below bf16 rounding."""
    _, params, net = nets
    if n not in _PALLAS_BF16:
        jpacked = jfm.pack_params(params["lin"], 59, 512, dtype=jnp.bfloat16)
        x = _inputs(n, seed=n)
        _PALLAS_BF16[n] = (x, np.asarray(jfm.fused_sdf_raw(jnp.asarray(x), jpacked, 59, 512,
                                                             interpret=True)))
    x, want = _PALLAS_BF16[n]
    packed = fm.pack_params(net.lin, 59, 512, dtype=torch.bfloat16)
    got = _emulated_sdf(torch.from_numpy(x), packed, _dot_bf16_k16_truncated).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=3e-2)
    big = np.abs(want) > 5e-2
    assert (np.sign(got[big]) == np.sign(want[big])).all()


@pytest.mark.parametrize("d_in", [9, 59, 102, 198, 510])
def test_stream_image_lays_out_the_bf16_weight_stream(d_in):
    """``pack_params`` gives the bf16 kernel its weight stream: l0's rows
    zero-padded to the compiled depth K0, then l1..l7's, element (k, n) at
    [k // 8, n // 8, k % 8, n % 8], so that a CTA's columns of an 8-row
    group are one run of bytes; only in bf16 and at the kernel's width."""
    rng = np.random.default_rng(d_in)
    w_in = torch.from_numpy(rng.normal(size=(d_in, 512)).astype(np.float32)).bfloat16()
    w_mid = torch.from_numpy(rng.normal(size=(fm.N_MID, 512, 512)).astype(np.float32)).bfloat16()
    img = fm.stream_image(w_in, w_mid)
    k0 = fm.kernel_depth(d_in)
    assert img.shape == ((k0 + fm.N_MID * 512) // 8, 64, 8, 8) and img.is_contiguous()
    stream = torch.cat([w_in, torch.zeros(k0 - d_in, 512, dtype=torch.bfloat16),
                        w_mid.reshape(-1, 512)])
    k = torch.from_numpy(rng.integers(0, stream.shape[0], 4000))
    n = torch.from_numpy(rng.integers(0, 512, 4000))
    assert torch.equal(img[k // 8, n // 8, k % 8, n % 8], stream[k, n])
    # a CTA's columns [c0, c0 + cols) of 8-row group g: one contiguous run
    flat = img.reshape(-1)
    g, c0, cols = 3, 128, 256
    run = flat[(g * 64 + c0 // 8) * 64:(g * 64 + (c0 + cols) // 8) * 64].view(cols // 8, 8, 8)
    assert torch.equal(run, stream[8 * g:8 * g + 8, c0:c0 + cols].view(8, cols // 8, 8)
                       .transpose(0, 1))


def test_pack_params_adds_the_stream_only_for_the_bf16_kernel(nets):
    """The stream is the bf16 kernel's, which runs only on the card: a pack
    on the CPU, in either weight type, holds ``w_in`` and ``w_mid``, the
    plain twin's form, and no ``w_img``."""
    _, _, net = nets
    for dtype in (torch.bfloat16, torch.float32):
        packed = fm.pack_params(net.lin, 59, 512, dtype=dtype)
        assert "w_img" not in packed and {"w_in", "w_mid"} <= set(packed)
        assert packed["w_in"].dtype == packed["w_mid"].dtype == dtype


def test_plain_twin_reads_the_bf16_stream(nets):
    """A pack that holds only the bf16 kernel's stream (``w_img``, as
    ``pack_params`` builds it on the card) gives back ``w_in`` and ``w_mid``
    bit for bit (``plain_pack``), and the plain twin the same bits on it."""
    _, _, net = nets
    packed = fm.pack_params(net.lin, 59, 512, dtype=torch.bfloat16)
    img = {k: v for k, v in packed.items() if k not in ("w_in", "w_mid")}
    img["w_img"] = fm.stream_image(packed["w_in"], list(packed["w_mid"]))
    back = fm.plain_pack(img, 59)
    assert set(back) == set(packed)
    for k in packed:
        assert torch.equal(back[k], packed[k]), k
    x = torch.from_numpy(_inputs(97, seed=5))
    assert torch.equal(fm.fused_sdf_raw_plain(x, img), fm.fused_sdf_raw_plain(x, packed))


def test_fast_sdf_f32_matches_exact_sdf(nets):
    """``make_fast_sdf('f32')`` (the exact tracer's fused path) is the same
    math as ``sdf``."""
    _, _, net = nets
    x = torch.from_numpy(np.random.default_rng(1).uniform(-0.4, 0.4, (200, 3)).astype(np.float32))
    with torch.no_grad():
        np.testing.assert_allclose(net.make_fast_sdf(precision="f32")(x).numpy(),
                                   net.sdf(x).numpy(), rtol=0, atol=2e-6)


def test_supports_fusion_matches_jax():
    for dims, skip in (([59] + [512] * 8 + [257], (4,)), ([59] + [128] * 8 + [33], (4,)),
                       ([3, 64, 64, 17], (4,)), ([59] + [512] * 8 + [257], (3,)),
                       ([59] + [96] * 8 + [257], (4,)), ([600] + [512] * 8 + [257], (4,))):
        assert fm.supports_fusion(dims, skip) == jfm.supports_fusion(dims, skip)


def test_wrapper_refuses_gradients(nets):
    _, _, net = nets
    packed = fm.pack_params(net.lin, 59, 512, dtype=torch.float32)
    x = torch.zeros(4, 59, requires_grad=True)
    with pytest.raises(ValueError):
        fm.fused_sdf_raw(x, packed)


# the kernels' configuration from N (ops/fused_mlp.py:cluster_size): the
# waves of clusters of C times each C's measured wave time, per variant, over
# the configurations the variant compiles (f32: 64-point tiles at C = 2 and
# 4; bf16: a 64-point tile at C = 1, a 128-point tile at C = 4).  132
# slots: an H100's 132 SMs, one CTA an SM at every cluster size; the card's
# own slots, by its occupancy query, are 132 / 132 / 120 (its GPCs seat 30
# clusters of 4)
SLOTS_132 = {1: 132, 2: 132, 4: 132}
SLOTS_H100 = {1: 132, 2: 132, 4: 120}
F32, BF16 = fm.WAVE_MS["fused_sdf_raw_f32"], fm.WAVE_MS["fused_sdf_raw_bf16"]
F32_TILES, BF16_TILES = fm.TILES["fused_sdf_raw_f32"], fm.TILES["fused_sdf_raw_bf16"]
# the bf16 kernel's (tile, C) at the card's slots
BF16_AT_H100 = [(256, (128, 4)), (2048, (128, 4)), (4096, (64, 1)), (24576, (64, 1)),
                (49152, (64, 1)), (69632, (64, 1))]


def _cost(n, slots, wave_ms, tiles, c):
    """The modelled time of n points on clusters of c, in exact decimals."""
    return -(-(-(-n // tiles[c])) * c // slots[c]) * Fraction(str(wave_ms[c]))


def test_each_variant_compiles_its_cluster_sizes():
    """The f32 kernel holds a partial and a float accumulator a column, which
    one CTA a tile could not keep in registers: its clusters are of 2 and 4,
    and the wrapper refuses a tile on one CTA before it reaches the card."""
    assert fm.cluster_sizes("fused_sdf_raw_f32") == (2, 4)
    assert fm.cluster_sizes("fused_sdf_raw_bf16") == (1, 4)
    assert set(fm.CLUSTER_SIZES) == set(F32) | set(BF16)
    assert set(F32) == set(F32_TILES) and set(BF16) == set(BF16_TILES)
    x = torch.zeros(8, 59)
    packed = {"w_in": torch.zeros(59, 512), "b_in": torch.zeros(512),
              "w_mid": torch.zeros(fm.N_MID, 512, 512), "b_mid": torch.zeros(fm.N_MID, 512),
              "w_out": torch.zeros(512), "b_out": torch.zeros(1)}
    with pytest.raises(ValueError, match="cluster must be one of"):
        fm._launch(x, packed, cluster=1)


@pytest.mark.parametrize("dtype, cluster", [(torch.bfloat16, 2), (torch.bfloat16, 3),
                                            (torch.bfloat16, 8), (torch.float32, 1),
                                            (torch.float32, 8)])
def test_wrapper_refuses_a_configuration_the_kernel_does_not_compile(dtype, cluster):
    """The cluster size fixes the tile (``TILES``): the bf16 kernel compiles
    a 64-point tile at C = 1 (two consumer warpgroups of 64 x 256
    accumulators; a 128-point tile would need 256 registers a thread) and a
    128-point tile at C = 4 (its (128, 2) never wins on the H100), the f32
    kernel 64-point tiles at C = 2 and 4; the wrapper refuses any other C
    before it reaches the card, the bf16 one on a pack of the card's form
    (``w_img`` only)."""
    assert BF16_TILES == {1: 64, 4: 128} and F32_TILES == {2: 64, 4: 64}
    x = torch.zeros(8, 59)
    w_in, w_mid = torch.zeros(59, 512, dtype=dtype), torch.zeros(fm.N_MID, 512, 512, dtype=dtype)
    packed = {"b_in": torch.zeros(512), "b_mid": torch.zeros(fm.N_MID, 512),
              "w_out": torch.zeros(512, dtype=dtype), "b_out": torch.zeros(1)}
    if dtype == torch.bfloat16:
        packed["w_img"] = fm.stream_image(w_in, w_mid)
    else:
        packed.update(w_in=w_in, w_mid=w_mid)
    with pytest.raises(ValueError, match="cluster must be one of"):
        fm._launch(x, packed, cluster=cluster)


@pytest.mark.parametrize("n, want", [(2048, 4), (4096, 2), (256, 4), (1, 4), (24576, 2),
                                     (49152, 2), (69632, 2)])
def test_cluster_size_at_132_slots(n, want):
    """The f32 kernel: the secant's calls (2048) on clusters of 4, the
    march's (4096) on clusters of 2 (two waves of 4 cost more than one of
    2), the camera step's (256) on 4, the exact sweep's probes (24576,
    49152) and the ngp cells' (69632) on clusters of 2."""
    assert fm.cluster_size(n, SLOTS_132, F32, F32_TILES) == want


@pytest.mark.parametrize("n, want", BF16_AT_H100)
def test_bf16_cluster_size_at_the_h100s_slots(n, want):
    """The bf16 kernel's (tile, C) on the card's slots: the camera step's
    calls (256), the guided secant's (2048), the mixed march's (4096), the
    fast sweep's (24576, 49152) and the mixed sweep's coarse probes
    (69632)."""
    c = fm.cluster_size(n, SLOTS_H100, BF16, BF16_TILES)
    assert (BF16_TILES[c], c) == want


def test_f32_cluster_size_at_69632_weighs_the_wave_time():
    """The ngp cells' largest f32 call: 37 waves of clusters of 4 are 18.5
    two-CTA waves' worth against 17 waves of clusters of 2, and a wave of
    clusters of 4 takes more than half of one of 2: the rule takes C = 2."""
    tiles = 69632 // F32_TILES[2]
    assert -(-tiles * 2 // 132) == 17 and -(-tiles * 4 // 120) == 37
    assert 2 * F32[4] > F32[2]
    assert fm.cluster_size(69632, SLOTS_H100, F32, F32_TILES) == \
        fm.cluster_size(69632, SLOTS_132, F32, F32_TILES) == 2


@pytest.mark.parametrize("variant", sorted(fm.WAVE_MS))
@pytest.mark.parametrize("slots", [SLOTS_132, SLOTS_H100,
                                   {1: 132, 2: 130, 4: 128}, {1: 132, 2: 132, 4: 0},
                                   {1: 114, 2: 114, 4: 112}])
def test_cluster_size_never_worse_than_one_cta_a_tile(slots, variant):
    """Over N up to 200,000 the rule takes the least modelled time, never
    more than that of the smallest C the variant compiles (one CTA a tile
    for bf16, clusters of 2 for f32), the smaller C on a tie, and no C that
    the card cannot seat."""
    wave_ms, tiles = fm.WAVE_MS[variant], fm.TILES[variant]
    smallest = fm.cluster_sizes(variant)[0]
    for n in range(1, 200_000, 89):
        c = fm.cluster_size(n, slots, wave_ms, tiles)
        assert slots[c] > 0 and c in wave_ms
        cost = {d: _cost(n, slots, wave_ms, tiles, d) for d in wave_ms if slots[d] > 0}
        best = min(cost.values())
        assert cost[c] == best <= cost[smallest]
        assert all(cost[d] > best for d in cost if d < c)


def test_cluster_size_moves_to_two_with_fewer_slots_for_four():
    """Where the card seats fewer clusters of 4 than 132 / 4 (GPCs whose SM
    count is not a multiple of 4), the f32 kernel's N=2048 needs two waves
    of clusters of 4, which cost more than one wave of clusters of 2."""
    assert fm.cluster_size(2048, SLOTS_H100, F32, F32_TILES) == 2
    assert fm.cluster_size(4096, SLOTS_H100, F32, F32_TILES) == 2

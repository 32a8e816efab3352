"""The port's CUDA kernel on the card, against its plain twin.

These tests need an NVIDIA GPU and skip without one.  They import nothing of
JAX, so they also run on a machine without it:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

(``--noconftest`` skips ``tests/conftest.py``, which sets JAX up.)
"""

import numpy as np
import pytest
import torch

from hashmodnffbanks_idr_tpu_torch.models.networks import ImplicitNetwork
from hashmodnffbanks_idr_tpu_torch.ops import fused_mlp as fm

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
# each variant: the edges of its 64-point tile (csrc/fused_mlp.cu, f32::TM
# and bf16k::TM) and the tracer's batch sizes up to its largest call
F32_TILE = 64
BF16_TILE = 64
CHECK_N = {"f32": (1, F32_TILE - 1, F32_TILE, F32_TILE + 1, 513, 4096, 49152),
           "bf16": (1, BF16_TILE - 1, BF16_TILE, BF16_TILE + 1, 513, 4096, 69632)}


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
    every input column counts."""
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

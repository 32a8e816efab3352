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


def test_cuda_pose7_step_matches_cpu(cuda_device):
    """One trainable-camera step of the flagship at full width (exact tracer
    through the f32 kernel, 64 rays) on the card and on the CPU from the
    same weights, pose table and draws: hit masks equal, loss terms within
    1e-5, the pose gradient and SparseAdam's first moment within 1e-4 of
    their largest entry, the poses after the step within 1e-6 wherever |g|
    exceeds 2e-4 of the largest (there the first step is lr * sign(g) on
    both sides); the f32 kernel ran.  The same bounds as ``chip_smoke.py``'s
    ``[cameras]`` step."""
    from hashmodnffbanks_idr_tpu_torch.geometry.cameras import rot_to_quat
    from hashmodnffbanks_idr_tpu_torch.models.loss import IDRLossConfig
    from hashmodnffbanks_idr_tpu_torch.models.renderer import IDRNetwork
    from hashmodnffbanks_idr_tpu_torch.testing import (flagship_conf, scene_to_device,
                                                       synthetic_scene)
    from hashmodnffbanks_idr_tpu_torch.train.trainer import (build_train_step, make_optimizer,
                                                             sparse_adam_init)

    n_rays, lr_cam = 64, 1e-4
    conf = flagship_conf(num_pixels=n_rays)
    conf.put("model.tracer_exact_fused", True)
    scene_np = synthetic_scene(n_views=3, img_res=(64, 64), seed=0)
    poses = scene_np["pose"]
    pose0 = np.concatenate([rot_to_quat(poses[:, :3, :3].astype(np.float64)),
                            poses[:, :3, 3]], axis=1).astype(np.float32)
    g = torch.Generator().manual_seed(5)
    pix = torch.randperm(64 * 64, generator=g)[:n_rays]
    draws = {"coarse": torch.rand(12, generator=g), "fine": torch.rand(24, generator=g),
             "eik": torch.rand(n_rays // 2, 3, generator=g) * 2 - 1}
    out = {}
    for device in (cuda_device, torch.device("cpu")):
        model = IDRNetwork(conf.get_config("model"), device=device, seed=0)
        pose_vecs = torch.tensor(pose0, device=device, requires_grad=True)
        cam_opt = sparse_adam_init(pose_vecs)
        step = build_train_step(model, IDRLossConfig(0.1, 200.0, 50.0), make_optimizer(model),
                                pose_vecs=pose_vecs, cam_opt=cam_opt, lr_cam=lr_cam)
        captured = {}
        model.register_forward_hook(lambda m, a, o: captured.update(o))
        fm.reset_launch_counts()
        losses = step(scene_to_device(scene_np, device), torch.tensor([1], device=device),
                      pix.to(device), None, 50.0,
                      draws={k: v.to(device) for k, v in draws.items()})
        out[device.type] = ({k: float(v) for k, v in losses.items()}, pose_vecs.grad.cpu(),
                            pose_vecs.detach().cpu(), fm.launch_counts["fused_sdf_raw_f32"]
                            ["launches"], int(cam_opt["step"]), cam_opt["m"].cpu(),
                            captured["network_object_mask"].cpu())
    (l_gpu, g_gpu, p_gpu, n_gpu, s_gpu, m_gpu, hit_gpu), \
        (l_cpu, g_cpu, p_cpu, n_cpu, s_cpu, m_cpu, hit_cpu) = out["cuda"], out["cpu"]
    assert n_gpu > 0 and n_cpu == 0 and s_gpu == s_cpu == 1
    assert torch.equal(hit_gpu, hit_cpu) and hit_cpu.any()
    for k in l_cpu:
        assert abs(l_gpu[k] - l_cpu[k]) <= 1e-5 * abs(l_cpu[k]), (k, l_gpu[k], l_cpu[k])
    gmax = float(g_cpu.abs().max())
    grad_err = float((g_gpu - g_cpu).abs().max())
    assert gmax > 0 and grad_err <= 1e-4 * gmax, (grad_err, gmax)
    assert float((m_gpu - m_cpu).abs().max()) <= 1e-4 * float(m_cpu.abs().max())
    clear = g_cpu.abs() > 2e-4 * gmax
    assert clear.any()
    assert float((p_gpu - p_cpu)[clear].abs().max()) <= 1e-6
    assert torch.equal(p_gpu[[0, 2]], torch.from_numpy(pose0)[[0, 2]])

"""The profiler's reading on a hand-made trace: busy time as the union of
the device's operations, kernel counts and times by name, idle gaps named
by the innermost host operation under them."""

from types import SimpleNamespace as NS

import pytest
from torch.autograd import DeviceType

from harness.trace import read_profile


def ev(name, start, end, device):
    return NS(name=name, time_range=NS(start=start, end=end), device_type=device,
              is_user_annotation=False)


def test_read_profile():
    cuda, cpu = DeviceType.CUDA, DeviceType.CPU
    events = [
        ev("void f32::fused_sdf_kernel<64, 2>(...)", 0, 100, cuda),
        ev("ampere_sgemm", 50, 150, cuda),             # overlaps the first
        ev("Memcpy HtoD", 400, 410, cuda),             # busy, not a kernel
        ev("ampere_sgemm", 1000, 1100, cuda),
        ev("cudaGraphLaunch", 0, 5, cpu),
        ev("epoch read", 150, 1000, cpu),
        ev("cudaStreamSynchronize", 160, 990, cpu),    # innermost under both gaps
    ]
    prof = NS(events=lambda: events)
    r = read_profile(prof, steps=2, window_s=2e-3)
    assert r.busy_s == pytest.approx((150 + 10 + 100) * 1e-6)
    assert r.kernel_count == 3
    assert r.kernel_seconds(r"\bf32::fused_sdf_kernel<") == pytest.approx(100e-6)
    assert r.top_ops(1) == [("ampere_sgemm", pytest.approx(200e-6))]
    assert [name for name, _ in r.idle_gaps] == ["cudaStreamSynchronize"] * 2
    assert r.idle_gaps[0][1] == pytest.approx(590e-6)

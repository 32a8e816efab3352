"""A run of the harness at a size the CPU holds (full widths, a 3-view
24x32 scan, 64 rays a step): the port's step against the reference comes
out correct, and with the timed path broken underneath, not correct; the
command refuses to run without the card."""

import subprocess
import sys
import time

import pytest
import torch

from bench_helpers import BENCH, ROOT, small
from harness import driver, scene, spec

LIMITS = {"loss_gap": 1e-4, "grad_gap": 1e-3, "change_gap": 1e-3, "rgb_ray_gap": 1e-5}


def _run(workload, wrap=None, seed=2_147_483_659):
    torch.manual_seed(0)
    cell = small(spec.resolve(ROOT, workload))
    cell.limits = dict(LIMITS)
    return driver.run_cell(cell, ROOT, seed=seed, seconds=0.5, trace=False, device="cpu",
                           t_start=time.perf_counter(), wrap_program=wrap)


def test_sound_run_is_correct():
    res = _run("nffb.dtu49.exact-fused")
    assert res["correct"], res["check"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) == {"train_rays_per_s", "step_ms_p95", "setup_s"}
    assert list(res)[-1] == "check"


def unchanged(program):
    """A step that returns its state unchanged: it computes the loss, then
    puts the parameters and Adam's state back as they were."""
    def step(scene, inp):
        keep = [t.detach().clone() for t in _state(program)]
        losses = program(scene, inp)
        with torch.no_grad():
            for t, k in zip(_state(program), keep):
                t.copy_(k)
        return losses
    return step


def _state(program):
    out = list(program.model.parameters())
    for st in program.optimizer.state.values():
        out += [t for t in st.values() if torch.is_tensor(t)]
    return out


def half_batch(program):
    """Half of the batch left out, the mean taken over the rest."""
    def step(scene, inp):
        r = inp["pixel_idx"].shape[0] // 2
        draws = dict(inp["draws"], eik=inp["draws"]["eik"][: r // 2])
        return program(scene, dict(inp, pixel_idx=inp["pixel_idx"][:r], draws=draws))
    return step


@pytest.mark.parametrize("fault", [unchanged, half_batch], ids=lambda f: f.__name__)
def test_fault_under_the_timed_path_is_not_correct(fault):
    res = _run("nffb.dtu49.mixed", wrap=fault)
    assert not res["correct"], res["check"]


def test_scene_is_the_generators():
    """The harness's scene renders as the port's ``data/dtu_shaped.py``
    generator does (view 5 of the 49, at 30x40)."""
    from hashmodnffbanks_idr_tpu_torch.data import dtu_shaped

    s = scene.build_scene({"n_views": 49, "img_res": [30, 40]}, "cpu", views_per_batch=7)
    H, W = 30, 40
    K = torch.eye(3, dtype=torch.float64).numpy()
    K[0, 0] = K[1, 1] = 2200.0 * (W / 1600.0)
    K[0, 2], K[1, 2] = W / 2.0, H / 2.0
    pos, R, _ = dtu_shaped.make_cameras(49, seed=0)[5]
    rgb, mask = dtu_shaped.render_view(pos, R, K, (H, W), device="cpu")
    assert torch.equal(s["mask"][5], torch.as_tensor(mask.reshape(-1)))
    diff = (s["rgb"][5].int() - torch.as_tensor(rgb.reshape(-1, 3)).int()).abs()
    assert int(diff.max()) <= 1     # rounding of the batched ray directions
    assert s["pose"][5, :3, 3].numpy() == pytest.approx(pos, abs=1e-6)


def test_command_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                          "nffb.dtu49.mixed", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA card" in out.stderr

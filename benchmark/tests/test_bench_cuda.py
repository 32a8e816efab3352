"""On the card: the comparison's limits separate the program from its
control (the reference with TF32 products and fp8 guidance), from TF32
products alone and from a fault (half of each step's rays), at the
cell's own size (one seed a cell; the limits were set from a dozen seeds
and more, ``calibrate.py``):

    python -m pytest benchmark/tests/test_bench_cuda.py -m cuda -q
"""

import pytest
import torch

from bench_helpers import ROOT
from harness import check, driver, spec
from harness.scene import build_scene
from reference import step as ref_step

WORKLOADS = ("nffb.dtu49.mixed", "ngp15.dtu49.mixed", "nffb.dtu49.exact-fused")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WORKLOADS)
def test_program_passes_and_control_fails(cuda_card, workload):
    cell = spec.resolve(ROOT, workload)
    scene = build_scene(cell.traffic, cuda_card)
    st = driver.start(cell, scene, 2_147_483_711, cuda_card)
    prog, weights, checked = st.prog, st.weights, st.checked
    del st
    driver.free(cuda_card)
    ref = ref_step.run_steps(cell.conf, scene, weights, checked)
    assert check.verdict(check.gaps(prog, ref, weights), cell.limits)
    control = ref_step.run_steps(cell.conf, scene, weights, checked, tf32=True,
                                 guide_dtype=torch.float8_e4m3fn)
    assert not check.verdict(check.gaps(control, ref, weights), cell.limits)
    # TF32 products alone, the guidance left in bf16, fail too
    tf32 = ref_step.run_steps(cell.conf, scene, weights, checked, tf32=True)
    assert not check.verdict(check.gaps(tf32, ref, weights), cell.limits)
    half = ref_step.run_steps(cell.conf, scene, weights, checked,
                              keep_rays=cell.traffic["rays_per_step"] // 2)
    assert not check.verdict(check.gaps(half, ref, weights), cell.limits)

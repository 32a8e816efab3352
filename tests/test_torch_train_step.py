"""One flagship-shaped train step of the PyTorch port against the JAX package.

A small fusion-eligible conf (implicit dims [128]*8 so ``supports_fusion``
holds and the port's tracer goes through ``fused_sdf_raw``, here its plain
twin on the CPU), and the flagship itself at full width (8x512 SDF MLP,
4x512 rendering MLP, 256 features, 100 tracer steps) on a few rays: the
same weights (``from_jax_params``), the same pixels and the same random
draws: the JAX step's draws are regenerated from its key and injected into
the port.
"""

import numpy as np
import jax
import pytest

from hashmodnffbanks_idr_tpu.models.renderer import IDRNetwork as JIDRNetwork
from hashmodnffbanks_idr_tpu.testing import flagship_conf as j_flagship_conf
from hashmodnffbanks_idr_tpu.testing import synthetic_scene

from hashmodnffbanks_idr_tpu_torch.models.renderer import IDRNetwork
from hashmodnffbanks_idr_tpu_torch.testing import flagship_conf
from hashmodnffbanks_idr_tpu_torch.weights import from_jax_params

from torch_step_parity import check_exact_step, check_mixed_step

N_RAYS = 64


def _patch(conf, mode, view, narrow=True):
    if narrow:
        conf.put("model.implicit_network.dims", [128] * 8)
        conf.put("model.rendering_network.dims", [64, 64])
        conf.put("model.feature_vector_size", 32)
        conf.put("model.ray_tracer.n_steps", 28)      # hierarchical stride 9
    conf.put("model.tracer_fast", mode)
    conf.put("model.tracer_exact_fused", True)
    conf.put("model.rendering_network.viewdirs_embed_type", view)
    return conf


def _setup(mode, view="StyleModNFFB", narrow=True, n_rays=N_RAYS):
    jconf = _patch(j_flagship_conf(num_pixels=n_rays), mode, view, narrow).get_config("model")
    jmodel = JIDRNetwork(jconf)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    model = IDRNetwork(_patch(flagship_conf(num_pixels=n_rays), mode, view,
                              narrow).get_config("model"), device="cpu")
    params_np = jax.tree_util.tree_map(np.asarray, params)
    model.load_state_dict(from_jax_params(params_np, model))
    scene_np = synthetic_scene(n_views=2, img_res=(32, 32), seed=0)
    pixel_idx = np.random.default_rng(3).permutation(32 * 32)[:n_rays]
    return jmodel, params, model, scene_np, pixel_idx


@pytest.mark.parametrize("view", ["StyleModNFFB", "SHEncoder"])
def test_exact_fused_step_matches_jax(view):
    """Loss, clipped gradients and Adam-updated parameters of one step, with
    the flagship's deep view embedder and with SH (every conf's)."""
    check_exact_step(*_setup("exact", view))


def test_full_width_step_matches_jax():
    """The flagship step at its published widths (``flagship_conf``
    unnarrowed) on 16 rays, at the width-128 case's tolerances."""
    n_rays = 16
    check_exact_step(*_setup("exact", narrow=False, n_rays=n_rays))


def test_mixed_step_agrees_with_jax():
    """bf16 guidance of march phase A and the coarse probes, f32 decisions,
    against JAX's kernel path: hit masks equal ray for ray, and the step at
    the exact step's bounds (tests/torch_step_parity.py:check_mixed_step)."""
    check_mixed_step(*_setup("mixed"))

#!/usr/bin/env python3
"""The numbers behind the bounds of the 'mixed' tracer's parity tests
(``tests/torch_step_parity.py``: ``check_mixed_step``, ``LOOSE``), on the
CPU, both packages.

    python scripts/mixed_parity_report.py [--keys 7 21 33]

For each narrowed instant-ngp preset in 'mixed' (``ngp_log2_15_k3`` with
two guided secant steps, ``ngp_log2_15`` with floor-only guidance and four)
it measures:
  - ``guidance``: JAX's bf16 guidance through the Pallas kernel in
    interpret mode against the port's (the fused kernel's plain twin) on
    4,096 points: raw SDFs that differ and by how much, from the same
    packed weights and from each package's own packing (``weights_differ``
    counts the packed bf16 weights that differ);
  - ``trace_kernel`` / ``trace_same``: the two traces of one forward
    (image 1, key 11) through JAX's kernel path and with the port's
    guidance in JAX's tracer: hit masks equal, rays whose distance differs
    by more than 1e-5, the largest difference;
  - ``jax_step_vs_forward``: with the port's guidance, the distances of the
    forward inside JAX's jitted train step against JAX's jitted forward
    (image 0, key 7);
  - ``steps``: per key, the step through JAX's kernel path, measured by
    the tests' own ``torch_step_parity.step_metrics``: each loss term's
    relative difference, the relative gradient error of the whole step and
    of its worst parameter, and the share of updated entries (where JAX's
    gradient exceeds 1e-5) within 1e-6, over the step and in its worst
    parameter.
It prints one JSON line per preset.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [REPO, os.path.join(REPO, "tests")]
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from hashmodnffbanks_idr_tpu.ops import fused_mlp as j_fm  # noqa: E402

from hashmodnffbanks_idr_tpu_torch.ops import fused_mlp as fm  # noqa: E402
from hashmodnffbanks_idr_tpu_torch.testing import ngp_conf  # noqa: E402
from hashmodnffbanks_idr_tpu_torch.weights import from_jax_params  # noqa: E402

from torch_step_parity import (forward_pair, jax_inputs, jax_kernel_guidance,  # noqa: E402
                               jax_port_guidance, jax_train_step, narrow, ngp_k3, port_step,
                               setup, step_traces)
from torch_step_parity import step_metrics as parity_metrics  # noqa: E402

PRESETS = {"ngp_log2_15_k3": lambda: ngp_k3("mixed"),
           "ngp_log2_15": lambda: narrow(ngp_conf("ngp_log2_15", num_pixels=64), "mixed")}


def guidance(jmodel, params, model):
    net = model.implicit_network
    p = params["implicit_network"]
    rt = model.ray_tracer
    x = np.random.default_rng(0).uniform(-1, 1, (4096, 3)).astype(np.float32)
    level = rt.prune_levels_march if rt.prune_levels_march < net.embedder.spec.num_levels else None
    with torch.no_grad():
        emb = net._embed(torch.as_tensor(x), True, level, rt.prune_floor_interp).numpy()
        own = fm.fused_sdf_raw(torch.as_tensor(emb),
                               fm.pack_params(net.lin, net.dims[0], net.dims[1])).numpy()
    packed = j_fm.pack_params(p["lin"], net.dims[0], net.dims[1], dtype=jnp.bfloat16)
    jax_raw = np.asarray(j_fm.fused_sdf_raw(jnp.asarray(emb), packed, net.dims[0], net.dims[1],
                                            interpret=True))
    same = {k: torch.tensor(np.asarray(v.astype(jnp.float32))) for k, v in packed.items()}
    same = {"w_in": same["w_in"][: net.dims[0]].bfloat16(), "b_in": same["b_in"],
            "w_mid": same["w_mid"].bfloat16(), "b_mid": same["b_mid"],
            "w_out": same["w_out"][:, 0].bfloat16(), "b_out": same["b_out"][:1]}
    with torch.no_grad():
        shared = fm.fused_sdf_raw(torch.as_tensor(emb), same).numpy()
    ours = fm.pack_params(net.lin, net.dims[0], net.dims[1])["w_mid"].float().numpy()
    return {"points": len(x),
            "differ_same_weights": int((shared != jax_raw).sum()),
            "max_same_weights": float(np.abs(shared - jax_raw).max()),
            "differ_own_packing": int((own != jax_raw).sum()),
            "max_own_packing": float(np.abs(own - jax_raw).max()),
            "weights_differ": int((ours != np.asarray(packed["w_mid"].astype(jnp.float32))).sum()),
            "weights": int(ours.size)}


def trace(jmodel, params, model, scene, pixels):
    jout, out, agree = forward_pair(jmodel, params, model, scene, pixels, seed=11)
    d = np.abs(out["dists"].numpy() - np.asarray(jout["dists"]))
    return {"masks_equal": bool(agree == 1.0), "rays_moved": int((d > 1e-5).sum()),
            "rays": len(d), "max_dist_diff": float(d.max())}


def step_metrics(jmodel, params, model, scene, pixels, key):
    """``torch_step_parity.step_metrics`` of one step, summed up: each loss
    term's relative difference, the whole gradient's relative error, the
    worst parameter's, and the share of updated entries within 1e-6, over
    the whole step and in the worst parameter."""
    jl, jg, jn = jax_train_step(jmodel)(params, scene, pixels, key)
    model.load_state_dict(from_jax_params(jax.tree_util.tree_map(np.asarray, params), model))
    m = parity_metrics(model, port_step(model, scene, pixels, key), jl, jg, jn)
    leaves = m["leaves"]
    worst = max(leaves, key=lambda n: leaves[n]["grad_rel"])
    share = {n: l["within"] / l["updated"] for n, l in leaves.items() if l["updated"]}
    low = min(share, key=share.get)
    return {"key": key, "loss_rel": m["loss_rel"], "grad_rel": m["whole"]["grad_rel"],
            "leaf_grad_rel": leaves[worst]["grad_rel"], "leaf_grad_rel_at": worst,
            "update_share": m["whole"]["update_share"], "leaf_update_share": share[low],
            "leaf_update_share_at": f"{low} ({leaves[low]['updated']} updated)"}


def jax_step_vs_forward(jmodel, params, model, scene, pixels):
    """The forward's distances inside JAX's jitted step against JAX's
    jitted forward, same inputs and key."""
    with step_traces(jmodel, model) as traces:
        jax_train_step(jmodel)(params, scene, pixels, 7)
    inputs = jax_inputs(scene, np.asarray([0], np.int32), pixels)
    fwd = np.asarray(jax.jit(lambda p: jmodel.apply(p, inputs, jax.random.PRNGKey(7),
                                                    training=True))(params)["dists"])
    d = np.abs(traces["jax"]["dists"] - fwd)
    return {"rays_moved": int((d > 1e-5).sum()), "max_dist_diff": float(d.max())}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--keys", type=int, nargs="+", default=[7, 21, 33])
    args = p.parse_args(argv)
    jax.config.update("jax_platforms", "cpu")
    for name, make in PRESETS.items():
        jmodel, params, model, scene, pixels = setup(make())
        rec = {"preset": name, "guidance": guidance(jmodel, params, model)}
        with jax_kernel_guidance(jmodel):
            rec["trace_kernel"] = trace(jmodel, params, model, scene, pixels)
            rec["steps"] = [step_metrics(jmodel, params, model, scene, pixels, k)
                            for k in args.keys]
        model.load_state_dict(from_jax_params(jax.tree_util.tree_map(np.asarray, params), model))
        with jax_port_guidance(jmodel, model):
            rec["trace_same"] = trace(jmodel, params, model, scene, pixels)
            rec["jax_step_vs_forward"] = jax_step_vs_forward(jmodel, params, model, scene,
                                                              pixels)
        print(json.dumps(rec))


if __name__ == "__main__":
    main()

"""Generate the conf tree into a directory given on the command line:

    python -m hashmodnffbanks_idr_tpu_torch.config.gen_confs --out <root>

A copy of ``hashmodnffbanks_idr_tpu/config/gen_confs.py`` (the reference's
conf inventory, SURVEY.md §2.7): one directory per encoder variant under
``embedder_conf_var/`` with ``dtu_fixed_cameras.conf`` and
``dtu_trained_cameras.conf``, the four ablation confs, and the CPU-runnable
dummy-scene confs.  The files are byte for byte the JAX generator's.  The
output root is required: the repo's committed confs are the JAX package's
and are read in place, never rewritten.
"""

from __future__ import annotations

import argparse
import os

TEMPLATE = """train{{
    expname = {expname}
    dataset_class = hashmodnffbanks_idr_tpu.data.scene_dataset.SceneDataset
    model_class = hashmodnffbanks_idr_tpu.models.renderer.IDRNetwork
    loss_class = hashmodnffbanks_idr_tpu.models.loss.IDRLoss
    learning_rate = 1.0e-4
{lr_cam}    num_pixels = 2048
    plot_freq = 100
    alpha_milestones = [250,500,750,1000,1250]
    alpha_factor = 2
    sched_milestones = [1000,1500]
    sched_factor = 0.5
}}
plot{{
    plot_nimgs = 1
    max_depth = 3.0
    resolution = 100
}}
loss{{
    eikonal_weight = 0.1
    mask_weight = {mask_weight}
    alpha = 50.0
}}
dataset{{
    data_dir = {data_dir}
    img_res = {img_res}
    scan_id = {scan_id}
{cam_file}}}
model{{
    feature_vector_size = {fvs}
    implicit_network
    {{
        d_in = 3
        d_out = 1
        dims = [ 512, 512, 512, 512, 512, 512, 512, 512 ]
        geometric_init = True
        bias = 0.6
        skip_in = [4]
        weight_norm = True
        multires = {multires}
    }}
    rendering_network
    {{
        mode = {mode}
        d_in = {rend_d_in}
        d_out = 3
        viewdirs_embed_type = {viewdirs}
        dims = [ 512, 512, 512, 512]
        weight_norm = True
        multires_view = {multires_view}
    }}
    ray_tracer
    {{
        object_bounding_sphere = 1.0
        sdf_threshold = 5.0e-5
        line_search_step = 0.5
        line_step_iters = 3
        sphere_tracing_iters = 10
        n_steps = 100
        n_secant_steps = 8
{tracer_extra}    }}
{embedding}}}
"""

EMBED_TEMPLATE = """    embedding_network {{
        embed_type = {embed_type}
        log2_max_hash_size = {log2}
        max_points_per_entry = 2
        base_resolution = {base_res}
        desired_resolution = 512
        bound = {bound}
    }}
"""

# variant dir -> (embed_type, viewdirs_fixed, viewdirs_trained, log2, base_res,
#                 bound, mask_weight_fixed) — viewdirs values mirror the
#                 reference conf tree exactly (grep over
#                 confs/embedder_conf_var/*/dtu_{fixed,trained}_cameras.conf)
VARIANTS = {
    "CUDA_HashGrid": ("HashGridCUDA", "HashGridCUDA", "SHEncoder", 15, 16, 1.0, 100.0),
    "FFB": ("FFB", "FFB", "FFB", 5, 16, 0.45, 200.0),
    "FFB_StyleMod": ("StyleModNFFB", "StyleModNFFB", "SHEncoder", 5, 16, 0.45, 200.0),
    "FFB_TCNN": ("FFBTcnn", "FFBTcnn", "NerfPos", 15, 16, 0.45, 200.0),
    "FourierFeatures": ("FourierFeatures", "FourierFeatures", "NerfPos", 5, 16, 0.45, 200.0),
    "HashGrid_TCNN_PointsAndViewDirs": ("HashGridTcnn", "NerfPos", "NerfPos", 15, 16, 1.0, 100.0),
    "MultiResHashPointsAndViewDirs": ("HashGrid", "HashGrid", "HashGrid", 5, 8, 1.0, 200.0),
    "MultiResHashPointsPosencViews": ("HashGrid", "NerfPos", "NerfPos", 5, 64, 1.0, 100.0),
    "PosEnc": ("NerfPos", "NerfPos", "NerfPos", 5, 16, 1.0, 100.0),
}


def render(expname, embed_type, viewdirs, log2, base_res, bound, mask_weight,
           trained=False, multires=6, data_dir="DTU", img_res="[1200, 1600]",
           scan_id=65, mode="idr", rend_d_in=9, fvs=256, multires_view=4,
           cam_file=None):
    emb = EMBED_TEMPLATE.format(embed_type=embed_type, log2=log2,
                                base_res=base_res, bound=bound)
    # large-table presets get level-pruned/floor-corner tracer guidance
    # (RESULTS.md r4: 1.5x step at no quality cost); small-table encoders
    # trace with the plain mixed-precision default
    tracer_extra = ""
    if log2 >= 15 and embed_type in ("HashGridCUDA", "HashGridTcnn", "FFBTcnn"):
        tracer_extra = ("        prune_levels_march = 16\n"
                        "        prune_levels_coarse = 16\n"
                        "        prune_secant_iters = 4\n")
    return TEMPLATE.format(
        expname=expname,
        lr_cam="    learning_rate_cam = 1.0e-4\n" if trained else "",
        mask_weight=mask_weight if not trained else 100.0,
        data_dir=data_dir, img_res=img_res, scan_id=scan_id,
        cam_file=f"    cam_file = {cam_file}\n" if cam_file else "",
        fvs=fvs, multires=multires, mode=mode, rend_d_in=rend_d_in,
        viewdirs=viewdirs, multires_view=multires_view, embedding=emb,
        tracer_extra=tracer_extra,
    )


def main(root: str):
    for name, (etype, vd_fixed, vd_trained, log2, base, bound, mw) in VARIANTS.items():
        d = os.path.join(root, "embedder_conf_var", name)
        os.makedirs(d, exist_ok=True)
        mr = 16 if name == "PosEnc" else 6
        with open(os.path.join(d, "dtu_fixed_cameras.conf"), "w") as f:
            f.write(render("dtu_fixed_cameras", etype, vd_fixed, log2, base,
                           bound, mw, multires=mr))
        with open(os.path.join(d, "dtu_trained_cameras.conf"), "w") as f:
            f.write(render("dtu_trained_cameras", etype, vd_trained, log2, base,
                           bound, mw, trained=True, multires=mr))

    # ablation confs (classic-IDR posenc encoder, mode switches)
    ab = os.path.join(root, "ablation-IDR-Study")
    os.makedirs(ab, exist_ok=True)
    common = dict(embed_type="NerfPos", viewdirs="NerfPos", log2=5, base_res=16,
                  bound=1.0, mask_weight=100.0, multires=6)
    with open(os.path.join(ab, "dtu_no_normal.conf"), "w") as f:
        f.write(render("dtu_no_normal", mode="no_normal", rend_d_in=6, **common))
    with open(os.path.join(ab, "dtu_no_view_dir.conf"), "w") as f:
        f.write(render("dtu_no_view_dir", mode="no_view_dir", rend_d_in=6,
                       multires_view=0, **common))
    with open(os.path.join(ab, "dtu_no_feature_vector.conf"), "w") as f:
        f.write(render("dtu_no_feature_vector", fvs=0, **common))
    with open(os.path.join(ab, "dtu_fixed_noisy_cameras.conf"), "w") as f:
        f.write(render("dtu_fixed_noisy_cameras",
                       cam_file="cameras_linear_init.npz", **common))

    # dummy smoke-test confs (CPU-runnable; BASELINE.json config 1)
    dummy = render("dummy_fourier", "FourierFeatures", "NerfPos", 5, 16, 1.0,
                   100.0, data_dir="dummy", img_res="[64, 64]", scan_id=0)
    with open(os.path.join(root, "dummy.conf"), "w") as f:
        f.write(dummy)
    dummy_nffb = render("dummy_stylemodnffb", "StyleModNFFB", "SHEncoder", 5, 16,
                        0.45, 100.0, data_dir="dummy", img_res="[64, 64]", scan_id=0)
    with open(os.path.join(root, "dummy_stylemodnffb.conf"), "w") as f:
        f.write(dummy_nffb)
    print(f"wrote confs under {root}")


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--out", required=True, help="directory to write the conf tree into")
    main(p.parse_args().out)

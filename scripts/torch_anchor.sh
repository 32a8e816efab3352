#!/usr/bin/env bash
# One seed of the 400-epoch head-to-head anchor through the PyTorch port, on
# the CUDA card: the same three stages as the JAX package's anchor()
# (scripts/run_r5_queue.sh:23-35).
#   1. exp_runner on headtohead_ours_400_f32.conf, 400 epochs, --seed SEED;
#   2. run_eval --resolution 200 --eval_rendering (mesh + all 8 views);
#   3. dtu_chamfer --downsample_density 0.005 against the scene's gt_mesh.ply.
# The scene data/dtu_shaped_small/scan0 (8 views, 240x320, scan 0) is
# generated first by the port's dtu_shaped, if it is not there.
#
# Usage: scripts/torch_anchor.sh SEED [OUT_DIR] [--train_cameras]
# OUT_DIR (default exps/anchor_s<SEED>) receives the small records:
# anchor_s<SEED>.json (metrics, times, the card), the run's scalars.jsonl,
# the metric CSVs, summary.json and the Chamfer log.  Checkpoints, meshes
# and renders stay in a temporary work directory, removed at the end.
# With --train_cameras it runs the trained-camera anchor instead:
# headtohead_ours_trained_cameras_400.conf with the cameras optimised from
# the scene's noisy linear init (exp_runner --train_cameras), run_eval with
# --eval_cameras, and the record anchor_cameras_s<SEED>.json adds the
# camera errors after training and at the init (default OUT_DIR
# exps/anchor_cameras_s<SEED>).
set -euo pipefail
cd "$(dirname "$0")/.."

seed="$1"
confs=hashmodnffbanks_idr_tpu/config/confs
scene=data/dtu_shaped_small/scan0
case "${3:-}" in
  --train_cameras)
    conf="$confs/headtohead_ours_trained_cameras_400.conf"
    exp="headtohead_ours_trained400_torch_s${seed}"
    record="anchor_cameras_s${seed}"
    extra_train=(--train_cameras)
    extra_eval=(--eval_cameras) ;;
  "")
    conf="$confs/headtohead_ours_400_f32.conf"
    exp="headtohead_ours400_f32_torch_s${seed}"
    record="anchor_s${seed}"
    extra_train=()
    extra_eval=() ;;
  *) echo "unknown option $3" >&2; exit 2 ;;
esac
out="${2:-exps/${record}}"
work=$(mktemp -d)
trap 'rm -rf "$work"' EXIT
mkdir -p "$out"
now() { python3 -c 'import time; print(time.time())'; }

t0=$(now)
if [ ! -f "$scene/gt_mesh.ply" ]; then
  python3 -m hashmodnffbanks_idr_tpu_torch.data.dtu_shaped --out "$work/gen" \
    --n_views 8 --img_res 240 320 --scan_id 0
  mkdir -p "$(dirname "$scene")"
  mv "$work/gen/dtu_shaped/scan0" "$scene"
fi
t1=$(now)
python3 -m hashmodnffbanks_idr_tpu_torch.train.exp_runner --conf "$conf" --nepoch 400 \
  --data_root data --seed "$seed" --expname "$exp" --exps_folder_name "$work/exps" \
  --no_tensorboard ${extra_train[@]+"${extra_train[@]}"}
t2=$(now)
python3 -m hashmodnffbanks_idr_tpu_torch.eval.run_eval --conf "$conf" --expname "$exp" \
  --data_root data --resolution 200 --eval_rendering --exps_folder "$work/exps" \
  --evals_folder "$work/evals" ${extra_eval[@]+"${extra_eval[@]}"}
t3=$(now)
evals="$work/evals/${exp}_0"
mesh=$(ls -t "$evals"/surface_world_coordinates_*.ply | head -1)
python3 -m hashmodnffbanks_idr_tpu_torch.eval.dtu_chamfer --data "$mesh" \
  --gt "$scene/gt_mesh.ply" --downsample_density 0.005 --log "$evals/chamfer_log.txt"
t4=$(now)

rundir=$(ls -d "$work/exps/${exp}_0"/*/ | tail -1)
cp "$rundir/logs/scalars.jsonl" "$evals"/metrics/*.csv "$evals/metrics/summary.json" \
  "$evals/chamfer_log.txt" "$out/"
if [ -f "$evals/camera_accuracy.json" ]; then cp "$evals/camera_accuracy.json" "$out/"; fi
card=$(nvidia-smi --query-gpu=name,power.limit --format=csv,noheader 2>/dev/null || echo "no nvidia-smi")
python3 - "$out" "$seed" "$card" "$record" "$t0" "$t1" "$t2" "$t3" "$t4" <<'EOF'
import json, os, statistics, sys
out, seed, card, record = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4]
t = [float(x) for x in sys.argv[5:]]
rows = [json.loads(l) for l in open(f"{out}/scalars.jsonl")]
summary = json.load(open(f"{out}/summary.json"))
chamfer = json.loads(open(f"{out}/chamfer_log.txt").read().splitlines()[-1])
rec = {"seed": seed, "card": card, "epochs": rows[-1]["step"],
       "generate_s": t[1] - t[0], "train_wall_s": t[2] - t[1],
       "eval_s": t[3] - t[2], "chamfer_s": t[4] - t[3],
       "mesh_s": summary["mesh_s"], "render_s": summary["render_s"],
       "rays_per_s_median": statistics.median(r["rays_per_s"] for r in rows[1:]),
       "loss_first": rows[0]["loss"], "loss_last": rows[-1]["loss"],
       "psnr": summary["psnr_mean"], "ssim": summary["ssim_mean"],
       "lpips": summary["lpips_mean"], "lpips_weights": summary["lpips_weights"],
       "chamfer_d2s": chamfer["mean_d2s"], "chamfer_s2d": chamfer["mean_s2d"],
       "chamfer_overall": chamfer["over_all"]}
if os.path.exists(f"{out}/camera_accuracy.json"):
    from hashmodnffbanks_idr_tpu_torch.data.scene_dataset import SceneDataset
    from hashmodnffbanks_idr_tpu_torch.eval.evaluator import camera_alignment
    from hashmodnffbanks_idr_tpu_torch.geometry.cameras import quat_to_rot
    import torch
    keys = ("rot_err_mean", "rot_err_median", "t_err_mean", "t_err_median")
    acc = json.load(open(f"{out}/camera_accuracy.json"))
    ds = SceneDataset(True, "dtu_shaped_small", [240, 320], 0, data_root="data")
    init, gt = ds.get_pose_init(), ds.get_gt_pose(scaled=True)
    init_acc = camera_alignment(quat_to_rot(torch.from_numpy(init[:, :4])).numpy(),
                                gt[:, :3, :3], init[:, 4:], gt[:, :3, 3])
    rec["camera_error_trained"] = {k: acc[k] for k in keys}
    rec["camera_error_init"] = {k: init_acc[k] for k in keys}
json.dump(rec, open(f"{out}/{record}.json", "w"), indent=1)
print("[anchor] " + json.dumps(rec))
EOF

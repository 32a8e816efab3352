"""Geometry/appearance disentanglement evaluation.

Counterpart of ``hashmodnffbanks_idr_tpu/eval/disentanglement.py``
(code/evaluation/eval_disentanglement.py:16-195 of the reference): load a
geometry checkpoint and an appearance checkpoint, swap the rendering
network's weights (the entire mechanism — eval_disentanglement.py:85),
generate a cubic-spline camera orbit in quaternion space, and render novel
views with empty object masks through ``Evaluator``.

    python -m hashmodnffbanks_idr_tpu_torch.eval.disentanglement --conf <conf> \
        --geometry_run_dir <run> --appearance_run_dir <run> [--platform cpu]
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from ..config.hocon import Config
from ..data.image_io import write_png
from ..geometry.cameras import quat_to_rot, rot_to_quat
from ..models.renderer import IDRNetwork
from .evaluator import Evaluator

_APPEARANCE = "rendering_network."


def swap_appearance(state_geometry: Dict[str, torch.Tensor],
                    state_appearance: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The appearance-transfer mechanism (eval_disentanglement.py:85) on
    state dicts: the geometry's, with every ``rendering_network.*`` entry
    taken from the appearance's."""
    out = {k: v for k, v in state_geometry.items() if not k.startswith(_APPEARANCE)}
    out.update({k: v for k, v in state_appearance.items() if k.startswith(_APPEARANCE)})
    return out


def spline_camera_orbit(poses: np.ndarray, n_frames: int = 30) -> np.ndarray:
    """Cubic-spline interpolation through the train poses in quat+t space
    (eval_disentanglement.py:108-123). poses: (V, 4, 4) -> (n_frames, 4, 4)."""
    from scipy.interpolate import CubicSpline

    quats = rot_to_quat(poses[:, :3, :3])
    trans = poses[:, :3, 3]
    vec = np.concatenate([quats, trans], axis=1)  # (V, 7)
    t = np.arange(len(vec))
    cs = CubicSpline(t, vec, axis=0, bc_type="periodic" if np.allclose(vec[0], vec[-1]) else "not-a-knot")
    ts = np.linspace(0, len(vec) - 1, n_frames)
    v = cs(ts)
    # back to matrices
    R = quat_to_rot(torch.as_tensor(v[:, :4], dtype=torch.float32)).numpy()
    out = np.tile(np.eye(4, dtype=np.float32), (n_frames, 1, 1))
    out[:, :3, :3] = R
    out[:, :3, 3] = v[:, 4:]
    return out


def render_disentangled(
    conf: Config, state_geometry: Dict[str, torch.Tensor],
    state_appearance: Dict[str, torch.Tensor],
    out_dir: str, n_frames: int = 10, data_root: Optional[str] = None,
    scan_id: int = -1, device=None,
):
    """Render ``n_frames`` orbit frames of the swapped model on ``device``
    (None -> the CUDA card) into ``out_dir/frame_<i>.png``."""
    model = IDRNetwork(conf.get_config("model"), device=device)
    model.load_state_dict(swap_appearance(state_geometry, state_appearance))
    ev = Evaluator(conf, model, data_root=data_root, scan_id=scan_id)
    orbit = spline_camera_orbit(ev.dataset.pose_all, n_frames)
    os.makedirs(out_dir, exist_ok=True)
    H, W = ev.dataset.img_res
    sample, _ = ev.dataset.full_image_inputs(0)
    for i, pose in enumerate(orbit):
        frame = dict(sample, pose=pose[None],
                     object_mask=np.zeros_like(sample["object_mask"]))  # empty masks
        rgb = ev.render_pixels(frame)["rgb_values"].reshape(H, W, 3)
        write_png(os.path.join(out_dir, f"frame_{i:03d}.png"),
                  ((rgb + 1.0) * 127.5).clip(0, 255).astype(np.uint8))
    return out_dir


def main(argv=None):
    """CLI parity with code/evaluation/eval_disentanglement.py."""
    import argparse

    from ..config.hocon import parse_file

    p = argparse.ArgumentParser()
    p.add_argument("--conf", required=True)
    p.add_argument("--geometry_run_dir", required=True,
                   help="run dir providing the SDF (checkpoints/latest.pt)")
    p.add_argument("--appearance_run_dir", required=True,
                   help="run dir providing the rendering network")
    p.add_argument("--out_dir", default="evals_disentanglement")
    p.add_argument("--n_frames", type=int, default=10)
    p.add_argument("--scan_id", type=int, default=-1)
    p.add_argument("--data_root", default=None)
    p.add_argument("--platform", default=None,
                   help="torch device to render on (default: the CUDA card; 'cpu')")
    args = p.parse_args(argv)

    def load(run_dir):
        return torch.load(os.path.join(run_dir, "checkpoints", "latest.pt"),
                          map_location="cpu", weights_only=True)["model"]

    return render_disentangled(parse_file(args.conf), load(args.geometry_run_dir),
                               load(args.appearance_run_dir), args.out_dir,
                               n_frames=args.n_frames, data_root=args.data_root,
                               scan_id=args.scan_id, device=args.platform)


if __name__ == "__main__":
    main()

"""Paths and a small cell for the harness's tests."""

from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def small(cell, views=3, res=(24, 32), rays=64):
    """``cell`` on a scene and batch a CPU test can hold: full widths, a
    3-view 24x32 scan, 64 rays a step."""
    cell.traffic = dict(cell.traffic, n_views=views, img_res=list(res), rays_per_step=rays)
    return cell

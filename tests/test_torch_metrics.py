"""The port's copied eval helpers and its metrics against the JAX package.

``utils/ply``, ``ops/mesh_extract``, ``eval/html_viewer``,
``models/metrics`` (PSNR, SSIM, Chamfer) and ``eval/dtu_chamfer`` are
copies: the same inputs give the same outputs to 1e-12 (bit for bit where
the code is numpy alone).  LPIPS is torch against JAX on the same fallback
weights (<= 1e-5 on 64x64), the official-weights import path on a
fabricated state dict, ``quat_to_rot`` to 1e-6, and the depth map's viridis
table against ``cv2.applyColorMap``.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hashmodnffbanks_idr_tpu.eval import dtu_chamfer as j_dtu_chamfer
from hashmodnffbanks_idr_tpu.eval.html_viewer import write_scene_html as j_write_scene_html
from hashmodnffbanks_idr_tpu.geometry.cameras import quat_to_rot as j_quat_to_rot
from hashmodnffbanks_idr_tpu.models import lpips as J_LPIPS
from hashmodnffbanks_idr_tpu.models import metrics as j_metrics
from hashmodnffbanks_idr_tpu.ops import mesh_extract as j_mesh
from hashmodnffbanks_idr_tpu.utils import ply as j_ply

from hashmodnffbanks_idr_tpu_torch.eval import dtu_chamfer
from hashmodnffbanks_idr_tpu_torch.eval.html_viewer import write_scene_html
from hashmodnffbanks_idr_tpu_torch.eval.plots import VIRIDIS_RGB, save_depth_map
from hashmodnffbanks_idr_tpu_torch.geometry.cameras import quat_to_rot
from hashmodnffbanks_idr_tpu_torch.models import lpips as L
from hashmodnffbanks_idr_tpu_torch.models import metrics
from hashmodnffbanks_idr_tpu_torch.ops import mesh_extract
from hashmodnffbanks_idr_tpu_torch.utils import ply

EXACT = dict(rtol=0, atol=1e-12)


def _sphere_field(res, r=0.6, wobble=0.0):
    ax = np.linspace(-1, 1, res)
    X, Y, Z = np.meshgrid(ax, ax, ax, indexing="ij")
    return np.sqrt(X**2 + Y**2 + Z**2) - r + wobble * np.sin(7 * X) * np.cos(5 * Y)


def _two_spheres(res=32):
    ax = np.linspace(-2, 2, res)
    X, Y, Z = np.meshgrid(ax, ax, ax, indexing="ij")
    return np.minimum(np.sqrt((X + 1) ** 2 + Y**2 + Z**2) - 0.8,
                      np.sqrt((X - 1.2) ** 2 + Y**2 + Z**2) - 0.3)


@pytest.mark.parametrize("colors", [False, True])
def test_ply_is_the_jax_copy(tmp_path, colors):
    rng = np.random.default_rng(0)
    verts = rng.normal(size=(23, 3)).astype(np.float32)
    faces = rng.integers(0, 23, (9, 3))
    col = rng.random((23, 3)) if colors else None
    ply.write_ply(str(tmp_path / "a.ply"), verts, faces, col)
    j_ply.write_ply(str(tmp_path / "b.ply"), verts, faces, col)
    assert (tmp_path / "a.ply").read_bytes() == (tmp_path / "b.ply").read_bytes()
    for got, want in zip(ply.read_ply(str(tmp_path / "b.ply")),
                         j_ply.read_ply(str(tmp_path / "a.ply"))):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("field", ["sphere", "wobbly", "two_spheres"])
def test_mesh_extract_is_the_jax_copy(field):
    vals = {"sphere": lambda: _sphere_field(24),
            "wobbly": lambda: _sphere_field(32, 0.5, 0.08),
            "two_spheres": _two_spheres}[field]()
    v, f = mesh_extract.marching_tetrahedra(vals)
    jv, jf = j_mesh.marching_tetrahedra(vals)
    assert len(f) > 100
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(f, jf)
    lv, lf = mesh_extract.largest_component(v, f)
    jlv, jlf = j_mesh.largest_component(jv, jf)
    np.testing.assert_array_equal(lv, jlv)
    np.testing.assert_array_equal(lf, jlf)


def test_html_viewer_is_the_jax_copy(tmp_path):
    rng = np.random.default_rng(1)
    verts = rng.random((40, 3)).astype(np.float32)
    faces = rng.integers(0, 40, (60, 3))
    poses = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    poses[:, :3, 3] = rng.normal(size=(3, 3))
    write_scene_html(str(tmp_path / "a.html"), verts, faces, poses, title="t <1>")
    j_write_scene_html(str(tmp_path / "b.html"), verts, faces, poses, title="t <1>")
    assert (tmp_path / "a.html").read_text() == (tmp_path / "b.html").read_text()


def test_psnr_ssim_chamfer_are_the_jax_copy():
    rng = np.random.default_rng(2)
    img = rng.uniform(0, 1, (32, 30, 3)).astype(np.float32)
    gt = np.clip(img + 0.05 * rng.normal(size=img.shape), 0, 1).astype(np.float32)
    mask = rng.random((32, 30)) > 0.3
    np.testing.assert_allclose(metrics.masked_psnr(img, gt, mask, 1.0),
                               j_metrics.masked_psnr(img, gt, mask, 1.0), **EXACT)
    assert np.isnan(metrics.masked_psnr(img, gt, np.zeros_like(mask)))
    np.testing.assert_allclose(metrics.ssim(img, gt, 1.0), j_metrics.ssim(img, gt, 1.0), **EXACT)
    p1, p2 = rng.normal(size=(300, 3)), rng.normal(size=(250, 3))
    got, want = metrics.chamfer_distance(p1, p2), j_metrics.chamfer_distance(p1, p2)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **EXACT)


def test_dtu_chamfer_is_the_jax_copy(tmp_path):
    vals = _sphere_field(24)
    verts, faces = mesh_extract.marching_tetrahedra(vals)
    verts = verts * (2 / 23) - 1.0
    d = np.random.default_rng(0).normal(size=(3000, 3))
    gt = 0.6 * d / np.linalg.norm(d, axis=-1, keepdims=True)
    np.testing.assert_array_equal(dtu_chamfer.sample_mesh_surface(verts, faces, 5000),
                                  j_dtu_chamfer.sample_mesh_surface(verts, faces, 5000))
    np.testing.assert_array_equal(dtu_chamfer.downsample(gt, 0.05),
                                  j_dtu_chamfer.downsample(gt, 0.05))
    got = dtu_chamfer.dtu_chamfer(verts, faces, gt, downsample_density=0.05)
    want = j_dtu_chamfer.dtu_chamfer(verts, faces, gt, downsample_density=0.05)
    assert got == want and got["over_all"] < 0.05
    # the CLI, both packages, on the same files
    ply.write_ply(str(tmp_path / "m.ply"), verts, faces)
    ply.write_ply(str(tmp_path / "gt.ply"), gt, np.zeros((0, 3), np.int64))
    for mod, log in ((dtu_chamfer, "a.txt"), (j_dtu_chamfer, "b.txt")):
        mod.main(["--data", str(tmp_path / "m.ply"), "--gt", str(tmp_path / "gt.ply"),
                  "--downsample_density", "0.05", "--log", str(tmp_path / log)])
    assert (tmp_path / "a.txt").read_text() == (tmp_path / "b.txt").read_text()


def _rand_img(rng, h=64, w=64):
    return rng.random((h, w, 3)).astype(np.float32) * 2.0 - 1.0


def test_lpips_fallback_matches_jax():
    """Both packages draw identical fallback weights; the torch forward is
    the JAX forward to 1e-5 on two 64x64 images (and on a non-square pair)."""
    w, jw = L.init_fallback_weights(), J_LPIPS.init_fallback_weights()
    assert w.keys() == jw.keys()
    for k in w:
        np.testing.assert_array_equal(w[k], jw[k])
    assert L.weights_source() == J_LPIPS.weights_source() == "fallback"
    rng = np.random.default_rng(3)
    for h, wd in ((64, 64), (48, 80)):
        img = _rand_img(rng, h, wd)
        gt = np.clip(img + 0.3 * rng.standard_normal(img.shape), -1, 1).astype(np.float32)
        got = L.lpips(img, gt, device="cpu")
        np.testing.assert_allclose(got, J_LPIPS.lpips(img, gt), rtol=0, atol=1e-5)
        np.testing.assert_allclose(metrics.lpips_or_none(img, gt, device="cpu"), got, **EXACT)
    assert L.lpips(img, img.copy(), device="cpu") == pytest.approx(0.0, abs=1e-6)


@pytest.mark.parametrize("hw", [(15, 40), (24, 32), (30, 64), (31, 31)])
def test_lpips_small_images_as_jax(hw):
    """Below 16 pixels a side both raise (``lpips_or_none`` gives None);
    from 16 to 30 both give NaN (an empty pooled map); 31 is finite."""
    rng = np.random.default_rng(4)
    img, gt = _rand_img(rng, *hw), _rand_img(rng, *hw)
    if min(hw) < 16:
        with pytest.raises(ValueError):
            L.lpips(img, gt, device="cpu")
        assert metrics.lpips_or_none(img, gt, device="cpu") is None
        assert j_metrics.lpips_or_none(img, gt) is None
        return
    got, want = L.lpips(img, gt, device="cpu"), J_LPIPS.lpips(img, gt)
    assert np.isnan(got) == np.isnan(want) == (min(hw) < 31)
    if not np.isnan(want):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_lpips_official_import_path(tmp_path, monkeypatch):
    """A torchvision-format ``alexnet.pth`` (with classifier keys to ignore)
    and an lpips-format ``lpips_alex.pth`` (one negative head entry to
    clip), seeded: both packages import the same arrays, flip their tag to
    'official' and agree to 1e-5."""
    g = torch.Generator().manual_seed(7)
    alex, in_ch = {}, 3
    for fi, (out_ch, k, _, _) in zip([0, 3, 6, 8, 10], L._CONVS):
        alex[f"features.{fi}.weight"] = torch.randn(
            (out_ch, in_ch, k, k), generator=g) * (2.0 / (in_ch * k * k)) ** 0.5
        alex[f"features.{fi}.bias"] = torch.randn((out_ch,), generator=g) * 0.01
        in_ch = out_ch
    alex["classifier.1.weight"] = torch.zeros((8, 8))
    heads = {f"lin{i}.model.1.weight": torch.randn((1, c, 1, 1), generator=g).abs()
             for i, (c, _, _, _) in enumerate(L._CONVS)}
    heads["lin0.model.1.weight"][0, 0, 0, 0] = -0.5
    torch.save(alex, tmp_path / "alexnet.pth")
    torch.save(heads, tmp_path / "lpips_alex.pth")

    w, jw = L.load_torch_lpips(str(tmp_path)), J_LPIPS.load_torch_lpips(str(tmp_path))
    for k in jw:
        np.testing.assert_array_equal(w[k], jw[k])
    assert w["lin0_w"][0] == 0.0
    monkeypatch.setenv("HMNFFB_LPIPS_WEIGHTS", str(tmp_path))
    monkeypatch.setattr(L, "_WEIGHTS_CACHE", {})
    monkeypatch.setattr(J_LPIPS, "_WEIGHTS_CACHE", {})
    assert L.weights_source() == J_LPIPS.weights_source() == "official"
    rng = np.random.default_rng(11)
    img = _rand_img(rng)
    gt = np.clip(img + 0.2 * rng.standard_normal(img.shape), -1, 1).astype(np.float32)
    np.testing.assert_allclose(L.lpips(img, gt, device="cpu"), J_LPIPS.lpips(img, gt),
                               rtol=0, atol=1e-5)


def test_quat_to_rot_matches_jax():
    q = np.random.default_rng(5).normal(size=(64, 4)).astype(np.float32)
    got = quat_to_rot(torch.as_tensor(q)).numpy()
    np.testing.assert_allclose(got, np.asarray(j_quat_to_rot(jnp.asarray(q))), rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.einsum("nij,nik->njk", got, got),
                               np.tile(np.eye(3), (64, 1, 1)), atol=1e-5)


def test_viridis_table_is_opencvs(tmp_path):
    import cv2
    levels = np.arange(256, dtype=np.uint8)[None]
    np.testing.assert_array_equal(
        VIRIDIS_RGB, cv2.applyColorMap(levels, cv2.COLORMAP_VIRIDIS)[0][:, ::-1])
    # the depth map file decodes to what the JAX package's cv2 path writes
    from hashmodnffbanks_idr_tpu.eval.plots import save_depth_map as j_save_depth_map
    rng = np.random.default_rng(6)
    dists, mask = rng.uniform(1, 3, (20, 24)), rng.random((20, 24)) > 0.4
    save_depth_map(str(tmp_path / "a.png"), dists, mask)
    j_save_depth_map(str(tmp_path / "b.png"), dists, mask)
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "a.png")),
                                  cv2.imread(str(tmp_path / "b.png")))


def test_plot_files_match_jax(tmp_path):
    """The render grid decodes to the JAX package's cv2-written file; the
    camera cloud's PLY is the same bytes."""
    import cv2
    from hashmodnffbanks_idr_tpu.eval import plots as j_plots
    from hashmodnffbanks_idr_tpu_torch.eval import plots

    rng = np.random.default_rng(7)
    rendered, gt = (rng.uniform(-1.2, 1.2, (12, 16, 3)).astype(np.float32) for _ in range(2))
    mask = rng.random((12, 16)) > 0.5
    plots.save_image_grid(str(tmp_path / "a.png"), rendered, gt, mask)
    j_plots.save_image_grid(str(tmp_path / "b.png"), rendered, gt, mask)
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "a.png")),
                                  cv2.imread(str(tmp_path / "b.png")))
    poses = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    poses[:, :3, 3] = rng.normal(size=(3, 3))
    plots.camera_frustum_ply(str(tmp_path / "a.ply"), poses)
    j_plots.camera_frustum_ply(str(tmp_path / "b.ply"), poses)
    assert (tmp_path / "a.ply").read_bytes() == (tmp_path / "b.ply").read_bytes()


@pytest.mark.parametrize("total,tile", [(1024, 1024), (1000, 300), (7, 10)])
def test_pixel_tiles_are_the_jax_copy(total, tile):
    from hashmodnffbanks_idr_tpu.utils.chunking import iter_pixel_tiles as j_tiles
    from hashmodnffbanks_idr_tpu_torch.utils.chunking import iter_pixel_tiles, render_in_tiles

    assert list(iter_pixel_tiles(total, tile)) == list(j_tiles(total, tile))
    # render_in_tiles hands each tile its slice and merges on the host
    uv = torch.arange(total * 2, dtype=torch.float32).reshape(1, total, 2)
    mask = torch.arange(total).reshape(1, total) % 3 == 0
    seen = []

    def render(inp):
        seen.append(inp["uv"].shape[1])
        return {"s": inp["uv"][0].sum(-1), "m": inp["object_mask"][0], "k": inp["k"][None]}

    out = render_in_tiles(render, {"uv": uv, "object_mask": mask, "k": torch.ones(())},
                          total, tile)
    assert seen == [s for _, s, _ in iter_pixel_tiles(total, tile)]
    np.testing.assert_array_equal(out["s"], uv[0].sum(-1).numpy())
    np.testing.assert_array_equal(out["m"], mask[0].numpy())
    assert out["k"].shape == (len(seen),)

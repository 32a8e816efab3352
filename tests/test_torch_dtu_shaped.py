"""The port's ``dtu_shaped`` generator against the JAX package's, on the CPU.

``scene_sdf`` for scans 0-2 to 1e-6 and ``scene_color`` to 1e-5 on random
points; ``render_view`` at 24x32: hit masks agree on >= 99% of pixels and
where both hit the uint8 colours are within 1 level; the CLI's
``cameras.npz`` and ``cameras_linear_init.npz`` exactly; ``write_gt_mesh``
at 24^3: the same face count, triangle corners within 1e-5.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hashmodnffbanks_idr_tpu.data import dtu_shaped as J
from hashmodnffbanks_idr_tpu.utils.ply import read_ply as j_read_ply

from hashmodnffbanks_idr_tpu_torch.data import dtu_shaped
from hashmodnffbanks_idr_tpu_torch.data.image_io import load_gray
from hashmodnffbanks_idr_tpu_torch.utils.ply import read_ply

SCANS = [0, 1, 2]


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Many small ops: with every test worker on torch's default thread pool
    they crawl (as in tests/test_torch_runner.py)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _points(seed, n=4096):
    return np.random.default_rng(seed).uniform(-0.8, 0.8, (n, 3)).astype(np.float32)


@pytest.mark.parametrize("scan", SCANS)
def test_scene_sdf_matches_jax(scan):
    p = _points(scan)
    got = dtu_shaped.scene_sdf(torch.as_tensor(p), scan).numpy()
    want = np.asarray(J.scene_sdf(jnp.asarray(p), scan))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert (got < 0).any() and (got > 0).any()


@pytest.mark.parametrize("scan", SCANS)
def test_scene_color_matches_jax(scan):
    rng = np.random.default_rng(10 + scan)
    p = _points(20 + scan)
    n = rng.normal(size=p.shape).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    v = rng.normal(size=p.shape).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    got = dtu_shaped.scene_color(*(torch.as_tensor(a) for a in (p, n, v)), scene_id=scan).numpy()
    want = np.asarray(J.scene_color(jnp.asarray(p), jnp.asarray(n), jnp.asarray(v), scan))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("scan", SCANS)
def test_render_view_matches_jax(scan):
    H, W = 24, 32
    K = np.eye(3)
    K[0, 0] = K[1, 1] = 2200.0 * (W / 1600.0)
    K[0, 2], K[1, 2] = W / 2.0, H / 2.0
    pos, R, _ = dtu_shaped.make_cameras(4, seed=scan)[scan]
    rgb, hit = dtu_shaped.render_view(pos, R, K, (H, W), scene_id=scan, device="cpu")
    j_rgb, j_hit = J.render_view(pos, R, K, (H, W), chunk=1024, scene_id=scan)
    assert hit.dtype == bool and rgb.dtype == np.uint8 and rgb.shape == (H, W, 3)
    assert 0.1 < hit.mean() < 0.9
    assert (hit == j_hit).mean() >= 0.99
    both = hit & j_hit
    assert np.abs(rgb[both].astype(int) - j_rgb[both].astype(int)).max() <= 1
    assert not rgb[~hit].any()


def test_make_cameras_is_the_jax_copy():
    for (p, R, t), (jp, jR, jt) in zip(dtu_shaped.make_cameras(9, seed=3),
                                       J.make_cameras(9, seed=3)):
        np.testing.assert_array_equal(p, jp)
        np.testing.assert_array_equal(R, jR)
        np.testing.assert_array_equal(t, jt)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """One 2-view 24x32 scene of scan 1 from each package's generator."""
    root = tmp_path_factory.mktemp("dtu_shaped")
    out = dtu_shaped.main(["--out", str(root / "port"), "--n_views", "2", "--img_res", "24", "32",
                           "--mesh_resolution", "24", "--seed", "3", "--scan_id", "1",
                           "--platform", "cpu"])
    J.main(["--out", str(root / "jax"), "--n_views", "2", "--img_res", "24", "32",
            "--mesh_resolution", "24", "--seed", "3", "--scan_id", "1"])
    return out, str(root / "jax" / "dtu_shaped" / "scan1")


def test_generated_cameras_are_exact(scenes):
    port, jax_dir = scenes
    for name in ("cameras.npz", "cameras_linear_init.npz"):
        got, want = np.load(f"{port}/{name}"), np.load(f"{jax_dir}/{name}")
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{name}:{k}")


def test_generated_images_and_mesh_match_jax(scenes):
    port, jax_dir = scenes
    for i in range(2):
        m, jm = (load_gray(f"{d}/mask/{i:03d}.png") for d in (port, jax_dir))
        assert (m == jm).mean() >= 0.99
    v, f = read_ply(f"{port}/gt_mesh.ply")
    jv, jf = j_read_ply(f"{jax_dir}/gt_mesh.ply")
    # the weld rounds vertices to 1e-6, so a corner 1e-7 apart may weld to
    # one more or one fewer vertex: compare the triangles' corners
    assert len(f) == len(jf) > 100
    np.testing.assert_allclose(v[f], jv[jf], rtol=0, atol=1e-5)

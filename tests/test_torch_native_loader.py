"""The port's parallel scene decode (``data/native_loader.py``) against the
serial decode, on a scan of distinct views written with every PNG row
filter (None, Sub, Up, Average, Paeth, one per row in turn): equal bit for
bit and in view order, in worker processes; a missing, corrupt or
mis-sized file raises its error from the worker; and ``SceneDataset``
through the parallel decode equals the JAX package's (OpenCV) arrays.
"""

import os

import numpy as np
import pytest

pytest.importorskip("cv2")

from hashmodnffbanks_idr_tpu.data.scene_dataset import SceneDataset as JSceneDataset

from hashmodnffbanks_idr_tpu_torch.data import native_loader
from hashmodnffbanks_idr_tpu_torch.data.image_io import write_png
from hashmodnffbanks_idr_tpu_torch.data.scene_dataset import SceneDataset, glob_imgs

V, H, W = 6, 40, 48
ROW_FILTERS = np.arange(H) % 5


@pytest.fixture(scope="module")
def scan(tmp_path_factory):
    """``<root>/dtu/scan0`` with V distinct views: each its own noise over a
    per-view gradient, so that no two views are equal."""
    root = tmp_path_factory.mktemp("scan")
    scan = root / "dtu" / "scan0"
    (scan / "image").mkdir(parents=True)
    (scan / "mask").mkdir()
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:H, 0:W]
    images, masks = [], []
    for i in range(V):
        shade = (xx * (i + 1) + yy * 3 + 40 * i)[..., None] + rng.integers(0, 30, (H, W, 3))
        img = (shade % 256).astype(np.uint8)
        mask = ((((xx - W / 2) ** 2 + (yy - H / 2) ** 2) < (4 + 3 * i) ** 2) * 255).astype(np.uint8)
        write_png(str(scan / "image" / f"{i:03d}.png"), img, filters=ROW_FILTERS)
        write_png(str(scan / "mask" / f"{i:03d}.png"), mask, filters=ROW_FILTERS[::-1])
        images.append(img.reshape(-1, 3))
        masks.append(mask.reshape(-1) > 127)
    wm = np.eye(4)
    wm[:3, :3] = [[1.2 * W, 0, W / 2], [0, 1.2 * W, H / 2], [0, 0, 1]]
    wm[:3, 3] = wm[:3, :3] @ [0.0, 0.0, 2.5]
    np.savez(scan / "cameras.npz", **{f"{m}_{i}": a for i in range(V)
                                      for m, a in (("world_mat", wm), ("scale_mat", np.eye(4)))})
    paths = [glob_imgs(str(scan / sub)) for sub in ("image", "mask")]
    return root, paths, np.stack(images), np.stack(masks)


@pytest.mark.parametrize("n_workers", [3, 6])
def test_parallel_decode_equals_serial(scan, n_workers):
    _, (images, masks), want_rgb, want_mask = scan
    assert len({v.tobytes() for v in want_rgb}) == V, "the views must be distinct"
    serial = native_loader.load_scene_native(images, masks, (H, W), workers="serial")
    got = native_loader.load_scene_native(images, masks, (H, W), n_workers=n_workers,
                                          workers="process")
    for a, b in zip(got, serial):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert got[0].shape == (V, H * W, 3) and got[0].dtype == np.uint8
    assert got[1].shape == (V, H * W) and got[1].dtype == np.bool_
    for i in range(V):  # view order: each view is the file written as it
        np.testing.assert_array_equal(got[0][i], want_rgb[i], err_msg=f"view {i}")
        np.testing.assert_array_equal(got[1][i], want_mask[i], err_msg=f"mask {i}")


@pytest.mark.parametrize("workers", ["process", "serial"])
def test_missing_file_raises(scan, workers):
    _, (images, masks), _, _ = scan
    missing = images[:3] + [os.path.join(os.path.dirname(images[0]), "gone.png")] + images[4:]
    with pytest.raises(FileNotFoundError):
        native_loader.load_scene_native(missing, masks, (H, W), n_workers=2, workers=workers)


@pytest.mark.parametrize("workers", ["process", "serial"])
def test_corrupt_file_raises(scan, tmp_path, workers):
    """A flipped byte inside a PNG chunk fails its CRC in the worker, which
    raises ValueError there; the caller raises it again."""
    _, (images, masks), _, _ = scan
    data = bytearray(open(images[2], "rb").read())
    data[60] ^= 0xFF
    bad = tmp_path / "bad.png"
    bad.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="CRC"):
        native_loader.load_scene_native(images[:2] + [str(bad)] + images[3:], masks, (H, W),
                                        n_workers=2, workers=workers)


def test_wrong_size_and_counts_raise(scan):
    _, (images, masks), _, _ = scan
    with pytest.raises(ValueError, match="img_res"):
        native_loader.load_scene_native(images, masks, (H, W + 1), n_workers=2,
                                        workers="process")
    with pytest.raises(ValueError, match="masks"):
        native_loader.load_scene_native(images, masks[:-1], (H, W))
    with pytest.raises(ValueError, match="workers"):
        native_loader.load_scene_native(images, masks, (H, W), workers="thread")


def test_scene_dataset_parallel_decode_matches_jax(scan, monkeypatch):
    """``SceneDataset`` decodes this scan in worker processes (the
    small-scan threshold lowered to 0) and equals the JAX package's
    OpenCV-decoded arrays."""
    root, *_ = scan
    calls = []
    load = native_loader.load_scene_native

    def spy(*args, **kw):
        calls.append(kw)
        return load(*args, **kw)

    monkeypatch.setattr(native_loader, "MIN_PARALLEL_PIXELS", 0)
    monkeypatch.setattr("hashmodnffbanks_idr_tpu_torch.data.scene_dataset.load_scene_native", spy)
    ds = SceneDataset(False, "dtu", [H, W], 0, data_root=str(root))
    jds = JSceneDataset(False, "dtu", [H, W], 0, data_root=str(root))
    assert len(calls) == 1
    np.testing.assert_array_equal(ds.rgb_images, jds.rgb_images)
    np.testing.assert_array_equal(ds.object_masks, jds.object_masks)
    assert ds.rgb_images.dtype == np.uint8 and ds.object_masks.dtype == bool

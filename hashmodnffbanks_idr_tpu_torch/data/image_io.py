"""PNG reading and writing in numpy and the standard library's ``zlib``.

The JAX package decodes with OpenCV (``data/scene_dataset.py:32-48``, or the
OpenCV-linked ``native/scene_loader.cpp``); the port needs no OpenCV.

``read_png`` takes 8-bit, non-interlaced grayscale, RGB and RGBA files and
undoes all five row filters.  None, Sub and Up rows are undone a row at a
time (Sub is a ``uint8`` cumulative sum at a stride of one pixel).  Average
and Paeth depend on the pixel to the left in the same row, so a block of rows
holding them is undone along anti-diagonals: pixel (r, x) needs only
(r, x-1), (r-1, x) and (r-1, x-1), so every pixel of one anti-diagonal is
computed in one numpy step, about H + W steps for the block.  Any other file
(16-bit, palette, gray+alpha, interlaced, a bad CRC) raises ``ValueError``.

``load_rgb`` and ``load_gray`` give what ``cv2.imread`` gives with
``IMREAD_COLOR`` (converted to RGB) and ``IMREAD_GRAYSCALE``.
"""

from __future__ import annotations

import struct
import zlib
from typing import Sequence, Union

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}   # colour type -> samples a pixel (8-bit only)
_COLOR_TYPE = {1: 0, 3: 2, 4: 6}
# libpng's rgb-to-gray weights as OpenCV's PNG decoder sets them
# (png_set_rgb_to_gray(.., 0.299, 0.587)): 15-bit fixed point, truncated
_GRAY_WEIGHTS = (9797, 19234, 3737)


def _chunks(data: bytes, path: str):
    pos = len(PNG_SIGNATURE)
    while pos + 12 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        if pos + 12 + n > len(data):
            raise ValueError(f"{path}: truncated {kind!r} chunk")
        body = data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"{path}: corrupt {kind!r} chunk (CRC)")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + n
    raise ValueError(f"{path}: no IEND chunk")


def read_png(path: str) -> np.ndarray:
    """(H, W) uint8 for grayscale, (H, W, 3) for RGB, (H, W, 4) for RGBA,
    channels in the file's order (R, G, B, A)."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    W, H, depth, color, compression, filter_method, interlace = header
    if depth != 8 or color not in _CHANNELS:
        raise ValueError(f"{path}: only 8-bit grayscale, RGB and RGBA PNGs are read "
                         f"(bit depth {depth}, colour type {color})")
    if interlace != 0 or compression != 0 or filter_method != 0:
        raise ValueError(f"{path}: interlaced or non-standard PNGs are not read")
    bpp = _CHANNELS[color]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), dtype=np.uint8)
    if raw.size != H * (1 + W * bpp):
        raise ValueError(f"{path}: {raw.size} bytes of image data, expected "
                         f"{H * (1 + W * bpp)}")
    raw = raw.reshape(H, 1 + W * bpp)
    out = unfilter(raw[:, 0], raw[:, 1:], bpp)
    return out.reshape(H, W) if bpp == 1 else out.reshape(H, W, bpp)


def unfilter(ftype: np.ndarray, rows: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the PNG row filters: ``ftype`` (H,) filter bytes, ``rows``
    (H, W*bpp) filtered bytes -> (H, W*bpp) uint8 image bytes."""
    if ftype.size and int(ftype.max()) > 4:
        raise ValueError(f"unknown PNG row filter {int(ftype.max())}")
    H = rows.shape[0]
    out = np.empty_like(rows)
    zero = np.zeros(rows.shape[1], np.uint8)
    # rows lo..hi-1 span every Average/Paeth row
    slow = np.flatnonzero(ftype >= 3)
    lo, hi = (int(slow[0]), int(slow[-1]) + 1) if slow.size else (H, H)
    for r in range(lo):
        out[r] = _unfilter_row(int(ftype[r]), rows[r], out[r - 1] if r else zero, bpp)
    if hi > lo:
        out[lo:hi] = _unfilter_diagonals(ftype[lo:hi], rows[lo:hi],
                                         out[lo - 1] if lo else zero, bpp)
    for r in range(hi, H):
        out[r] = _unfilter_row(int(ftype[r]), rows[r], out[r - 1] if r else zero, bpp)
    return out


def _unfilter_row(t: int, row: np.ndarray, above: np.ndarray, bpp: int) -> np.ndarray:
    """One None (0), Sub (1) or Up (2) row."""
    if t == 0:
        return row
    if t == 1:
        return row.reshape(-1, bpp).cumsum(axis=0, dtype=np.uint8).reshape(-1)
    return row + above


def _unfilter_diagonals(ftype, rows, above, bpp):
    """Rows of any filters, given the row above them, along anti-diagonals.

    Pixel (r, x) lives at ``o[r + x + 2, r + 1]`` of a zero-padded skewed
    array, so anti-diagonal d is the contiguous row j = d + 2 of ``o``, and
    the pixel's left (r, x-1), upper (r-1, x) and upper-left (r-1, x-1)
    neighbours are ``o[j-1, i]``, ``o[j-1, i-1]`` and ``o[j-2, i-1]``.
    Lane 0 holds the row above."""
    k, W = rows.shape[0], rows.shape[1] // bpp
    r_idx = np.arange(k)[:, None]
    diag = r_idx + np.arange(W)[None, :] + 2
    o = np.zeros((k + W + 1, k + 1, bpp), np.int16)
    o[1:W + 1, 0] = above.reshape(W, bpp)
    filt = np.zeros((k + W + 1, k + 1, bpp), np.int16)
    filt[diag, r_idx + 1] = rows.reshape(k, W, bpp)
    # each lane's prediction, chosen by its row's filter (lane 0 is unused)
    t = np.concatenate([[0], ftype]).astype(np.int16)[:, None]
    use_a, use_b = np.isin(t, (1, 3)), np.isin(t, (2, 3))
    is_avg, is_paeth = t == 3, t == 4
    for j in range(2, k + W + 1):
        i0, i1 = max(1, j - W), min(k, j - 1) + 1
        a = o[j - 1, i0:i1]
        b = o[j - 1, i0 - 1:i1 - 1]
        c = o[j - 2, i0 - 1:i1 - 1]
        # None 0, Sub a, Up b, Average (a + b) >> 1: one sum of masked terms
        pred = (a * use_a[i0:i1] + b * use_b[i0:i1]) >> is_avg[i0:i1]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        o[j, i0:i1] = (filt[j, i0:i1] + np.where(is_paeth[i0:i1], paeth, pred)) & 255
    return o[diag, r_idx + 1].astype(np.uint8).reshape(k, W * bpp)


def load_rgb(path: str) -> np.ndarray:
    """(H, W, 3) uint8 RGB, as ``cv2.imread(IMREAD_COLOR)`` + BGR->RGB:
    gray is repeated, alpha dropped."""
    img = read_png(path)
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, axis=-1)
    return np.ascontiguousarray(img[..., :3])


def load_gray(path: str) -> np.ndarray:
    """(H, W) uint8, as ``cv2.imread(IMREAD_GRAYSCALE)``: alpha dropped, RGB
    weighted by libpng's truncating fixed-point rgb-to-gray."""
    img = read_png(path)
    if img.ndim == 2:
        return img
    rgb = img[..., :3].astype(np.uint32)
    wr, wg, wb = _GRAY_WEIGHTS
    return ((wr * rgb[..., 0] + wg * rgb[..., 1] + wb * rgb[..., 2]) >> 15).astype(np.uint8)


def _filter_rows(img: np.ndarray, filters: np.ndarray, bpp: int) -> np.ndarray:
    """Apply each row's PNG filter (the inverse of ``unfilter``)."""
    x = img.astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    pred = np.stack([np.zeros_like(x), a, b, (a + b) >> 1, paeth])
    return ((x - pred[filters, np.arange(x.shape[0])]) & 255).astype(np.uint8)


def write_png(path: str, img: np.ndarray,
              filters: Union[int, Sequence[int]] = 0) -> None:
    """Write (H, W) gray, (H, W, 3) RGB or (H, W, 4) RGBA uint8 as an 8-bit
    PNG.  ``filters`` is one PNG row filter (0-4) for every row, or one per
    row."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3):
        raise ValueError(f"write_png takes 2-d or 3-d uint8, got {img.dtype} {img.shape}")
    bpp = 1 if img.ndim == 2 else img.shape[2]
    if bpp not in _COLOR_TYPE:
        raise ValueError(f"write_png takes 1, 3 or 4 channels, got {bpp}")
    H, W = img.shape[:2]
    f = np.broadcast_to(np.asarray(filters, dtype=np.int64), (H,))
    if f.size and (f.min() < 0 or f.max() > 4):
        raise ValueError(f"PNG row filters are 0-4, got {filters}")
    rows = _filter_rows(img.reshape(H, W * bpp), f, bpp)
    raw = np.concatenate([f.astype(np.uint8)[:, None], rows], axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    ihdr = struct.pack(">IIBBBBB", W, H, 8, _COLOR_TYPE[bpp], 0, 0, 0)
    with open(path, "wb") as fh:
        fh.write(PNG_SIGNATURE + chunk(b"IHDR", ihdr)
                 + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)) + chunk(b"IEND", b""))

"""Multiview PNG dataset loading (host side, startup only).

Equivalent of the reference's image_loading.rs: PNG -> float32 RGBA
normalized /255 (load_image_as_array, src/image_loading.rs:6-24), path
generation ``{dir}/image-{i}.png`` over ``start..end step`` with the
same divisibility asserts (get_image_paths, src/image_loading.rs:37-54),
and the hemisphere view-angle grid lives in ops/rays.view_angle_grid
(src/image_loading.rs:67-80).

Images are loaded once at startup into one (N, H, W, 4) uint8 host
array that is then device_put as the resident pixel store
(data/device_dataset.py) — per-step batches never touch these files.

PNG is read and written here with the standard library (zlib, struct):
8-bit, non-interlaced grayscale, gray+alpha, RGB and RGBA, every
scanline filter type (PNG spec §9).
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import List, Tuple

import numpy as np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
# color type -> channels (8-bit depths only)
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def encode_png(arr: np.ndarray) -> bytes:
    """(H, W) / (H, W, 1|2|3|4) uint8 -> PNG bytes (filter type 0 on
    every scanline, one IDAT)."""
    arr = np.asarray(arr)
    if arr.dtype != np.uint8:
        raise ValueError(f"encode_png needs uint8, got {arr.dtype}")
    if arr.ndim == 2:
        arr = arr[..., None]
    h, w, c = arr.shape
    color = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    rows = np.concatenate(
        [np.zeros((h, 1), np.uint8), arr.reshape(h, w * c)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)
    return (_PNG_SIG + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def _unfilter(data: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-scanline filters (PNG spec §9.2)."""
    if len(data) != h * (stride + 1):
        raise ValueError(f"PNG data is {len(data)} bytes, expected "
                         f"{h * (stride + 1)}")
    raw = np.frombuffer(data, np.uint8).reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        ft, line = raw[y, 0], raw[y, 1:]
        if ft == 0:
            cur = line
        elif ft == 1:  # Sub: running sum per channel, mod 256
            cur = np.cumsum(line.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif ft == 2:  # Up
            cur = line + prev
        elif ft in (3, 4):  # Average / Paeth: sequential along the row
            ln, up = line.tolist(), prev.tolist()
            cur = [0] * stride
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                b = up[i]
                if ft == 3:
                    pred = (a + b) >> 1
                else:
                    c = up[i - bpp] if i >= bpp else 0
                    pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                    pred = a if pa <= pb and pa <= pc else (
                        b if pb <= pc else c)
                cur[i] = (ln[i] + pred) & 0xFF
            cur = np.asarray(cur, np.uint8)
        else:
            raise ValueError(f"bad PNG filter type {ft} in row {y}")
        out[y] = cur
        prev = out[y]
    return out


def decode_png(blob: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, C) uint8, C = 1 (gray), 2 (gray+alpha),
    3 (RGB) or 4 (RGBA). Raises ValueError on anything else (16-bit,
    palette, interlaced) and on a corrupt file."""
    if blob[:8] != _PNG_SIG:
        raise ValueError("not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos + 8 <= len(blob):
        (n,) = struct.unpack(">I", blob[pos:pos + 4])
        tag, data = blob[pos + 4:pos + 8], blob[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", blob[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(tag + data) & 0xFFFFFFFF != crc:
            raise ValueError(f"PNG chunk {tag!r} fails its CRC")
        pos += 12 + n
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", data)
        elif tag == b"IDAT":
            idat.append(data)
        elif tag == b"IEND":
            break
    if hdr is None or not idat:
        raise ValueError("PNG file has no IHDR or no IDAT")
    w, h, depth, color, _, _, interlace = hdr
    if depth != 8 or color not in _CHANNELS or interlace != 0:
        raise ValueError(
            f"unsupported PNG (bit depth {depth}, color type {color}, "
            f"interlace {interlace}): need 8-bit non-interlaced "
            f"gray/gray+alpha/RGB/RGBA")
    c = _CHANNELS[color]
    rows = _unfilter(zlib.decompress(b"".join(idat)), h, w * c, c)
    return rows.reshape(h, w, c)


def _to_rgba(img: np.ndarray) -> np.ndarray:
    """(H, W, C) uint8 -> (H, W, 4) RGBA (opaque where no alpha)."""
    h, w, c = img.shape
    rgb = img[..., :1].repeat(3, -1) if c <= 2 else img[..., :3]
    alpha = (img[..., -1:] if c in (2, 4)
             else np.full((h, w, 1), 255, np.uint8))
    return np.concatenate([rgb, alpha], axis=-1)


def get_image_paths(dir: str, start: int, end: int, step: int = 1) -> List[str]:
    """``{dir}/image-{i}.png`` for i in start..end by step, with the
    reference's asserts (src/image_loading.rs:37-44)."""
    assert start < end, "view_start must be < view_end"
    assert (end - start) % step == 0, "(end - start) must be divisible by step"
    assert (end - start) // step > 0
    return [os.path.join(dir, f"image-{i}.png") for i in range(start, end, step)]


def load_image(path: str) -> np.ndarray:
    """One PNG -> (H, W, 4) uint8 RGBA (the /255 normalization happens
    on-device at gather time, keeping the pixel store 4x smaller than
    the reference's f32 Vec<[f32;4]>)."""
    with open(path, "rb") as f:
        return _to_rgba(decode_png(f.read()))


def box_downsample(img: np.ndarray, factor: int) -> np.ndarray:
    """Area-averaged (box-filter) decimation by an integer factor —
    each output pixel is the mean of its factor x factor source block
    (trailing rows/cols beyond a whole block are cropped). Strided
    subsampling (img[::f, ::f]) aliases high-frequency capture content;
    the pixel-footprint argument is mip-NeRF's own (arXiv 2103.13415
    §1) and this matches eval's box-downsampled gold pyramid
    (data/device_dataset.build_pyramid)."""
    h, w = img.shape[:2]
    h2, w2 = h // factor, w // factor
    a = img[: h2 * factor, : w2 * factor].astype(np.float32)
    a = a.reshape(h2, factor, w2, factor, -1).mean(axis=(1, 3))
    if np.issubdtype(img.dtype, np.integer):
        return np.clip(np.rint(a), 0, 255).astype(img.dtype)
    return a.astype(img.dtype)


def load_images(paths: List[str]) -> np.ndarray:
    """All views as one (N, H, W, 4) uint8 stack
    (load_multiple_images_as_arrays, src/image_loading.rs:56-65)."""
    imgs = [load_image(p) for p in paths]
    shapes = {im.shape for im in imgs}
    assert len(shapes) == 1, f"inconsistent view shapes: {shapes}"
    return np.stack(imgs, axis=0)


def load_multiview_dir(
    dir: str, start: int, end: int, step: int = 1
) -> Tuple[np.ndarray, int, int]:
    """Load the reference's dataset layout; returns (images, H, W)."""
    imgs = load_images(get_image_paths(dir, start, end, step))
    return imgs, imgs.shape[1], imgs.shape[2]


def save_png(path: str, rgb: np.ndarray) -> None:
    """Write a float [0,1] (H, W, 3|4) array as PNG — the headless
    replacement for the reference's live minifb window (SURVEY §2.17)."""
    arr = np.clip(np.asarray(rgb) * 255.0, 0, 255).astype(np.uint8)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(encode_png(arr))

"""The standard-library PNG codec (data/images.py): round trips, every
scanline filter type a decoder meets in files written elsewhere, and
the files it refuses."""

import struct
import zlib

import numpy as np
import pytest

from nerf_rs_tpu.data.images import decode_png, encode_png, load_image


def _img(h, w, c, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (h, w, c), np.uint8)


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_roundtrip(channels):
    img = _img(7, 5, channels)
    np.testing.assert_array_equal(decode_png(encode_png(img)), img)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _filtered_png(img, ft):
    """Encode with filter type ``ft`` on every scanline (PNG spec §9.2),
    written out element by element as the reference."""
    h, w, c = img.shape
    color = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    x = img.reshape(h, w * c).astype(int)
    rows = []
    for y in range(h):
        out = [ft]
        for i in range(w * c):
            a = x[y, i - c] if i >= c else 0
            b = x[y - 1, i] if y > 0 else 0
            cc = x[y - 1, i - c] if y > 0 and i >= c else 0
            pred = {0: 0, 1: a, 2: b, 3: (a + b) // 2,
                    4: _paeth(a, b, cc)}[ft]
            out.append((x[y, i] - pred) % 256)
        rows.append(bytes(out))

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("ft", [1, 2, 3, 4])
def test_decodes_every_filter_type(ft):
    img = _img(6, 9, 3, seed=ft)
    np.testing.assert_array_equal(decode_png(_filtered_png(img, ft)), img)


def test_rejects_a_corrupt_chunk():
    blob = bytearray(encode_png(_img(4, 4, 3)))
    blob[40] ^= 0xFF  # inside IDAT
    with pytest.raises(ValueError, match="CRC"):
        decode_png(bytes(blob))


def test_rejects_16_bit():
    ihdr = struct.pack(">IIBBBBB", 2, 2, 16, 2, 0, 0, 0)
    blob = (b"\x89PNG\r\n\x1a\n" + struct.pack(">I", 13) + b"IHDR" + ihdr
            + struct.pack(">I", zlib.crc32(b"IHDR" + ihdr) & 0xFFFFFFFF)
            + struct.pack(">I", 0) + b"IDAT"
            + struct.pack(">I", zlib.crc32(b"IDAT") & 0xFFFFFFFF))
    with pytest.raises(ValueError, match="bit depth 16"):
        decode_png(blob)


def test_load_image_gives_rgba(tmp_path):
    gray = _img(3, 4, 1)
    path = tmp_path / "g.png"
    path.write_bytes(encode_png(gray))
    rgba = load_image(str(path))
    assert rgba.shape == (3, 4, 4)
    np.testing.assert_array_equal(rgba[..., 0], gray[..., 0])
    np.testing.assert_array_equal(rgba[..., 2], gray[..., 0])
    assert (rgba[..., 3] == 255).all()

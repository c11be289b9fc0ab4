"""The zlib + NumPy PNG decoder of the KITTI loader."""

import io
import struct
import zlib

import numpy as np
import pytest

from opendlv_perception_vision_orbslam2_jax.io import kitti


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _filter_row(ftype, row, prev, bpp):
    """PNG encoder-side filter of one row (spec section 9), byte by byte;
    types above 4 are invalid and write the row unfiltered."""
    out = []
    for i, x in enumerate(row):
        a = row[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        pred = (0, a, b, (a + b) // 2, _paeth(a, b, c))[ftype] if ftype < 5 else 0
        out.append((x - pred) % 256)
    return bytes([ftype] + out)


def _png(pixels, color, ftypes):
    h, w = pixels.shape[:2]
    bpp = 1 if pixels.ndim == 2 else pixels.shape[2]
    flat = pixels.reshape(h, w * bpp).astype(int)
    prev = [0] * (w * bpp)
    raw = b""
    for y in range(h):
        raw += _filter_row(ftypes[y % len(ftypes)], list(flat[y]), prev, bpp)
        prev = list(flat[y])

    def chunk(t, body):
        return (struct.pack(">I", len(body)) + t + body
                + struct.pack(">I", zlib.crc32(t + body) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
def test_each_filter_type_gray(ftype):
    img = np.random.default_rng(ftype).integers(0, 256, (9, 13)).astype(np.uint8)
    out = kitti.decode_png_bytes(_png(img, 0, [ftype]))
    np.testing.assert_array_equal(out, img.astype(np.float32))


def test_mixed_filters_rgb_and_alpha():
    rng = np.random.default_rng(7)
    rgb = rng.integers(0, 256, (11, 6, 3)).astype(np.uint8)
    want = rgb.astype(np.float32) @ np.float32([0.299, 0.587, 0.114])
    out = kitti.decode_png_bytes(_png(rgb, 2, [0, 1, 2, 3, 4]))
    np.testing.assert_allclose(out, want, rtol=0, atol=1e-3)
    rgba = np.concatenate([rgb, rng.integers(0, 256, (11, 6, 1))], axis=2)
    out = kitti.decode_png_bytes(_png(rgba.astype(np.uint8), 6, [4, 3, 1]))
    np.testing.assert_allclose(out, want, rtol=0, atol=1e-3)


def test_encoder_roundtrip_and_pil_files(tmp_path):
    from PIL import Image

    img = np.random.default_rng(3).integers(0, 256, (48, 64)).astype(np.uint8)
    data = kitti.encode_png_gray(img)
    np.testing.assert_array_equal(kitti.decode_png_bytes(data), img)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))), img)
    buf = io.BytesIO()
    Image.fromarray(img, "L").save(buf, format="PNG")
    np.testing.assert_array_equal(kitti.decode_png_bytes(buf.getvalue()), img)

    kitti.write_sequence(str(tmp_path), [img], [img[::-1]], [0.5])
    assert (tmp_path / "times.txt").read_text().split() == ["5.000000e-01"]
    left, right = kitti.image_paths(str(tmp_path), 0)
    with open(right, "rb") as f:
        np.testing.assert_array_equal(kitti.decode_png_bytes(f.read()),
                                      img[::-1])


def test_rejects_what_it_cannot_decode():
    img = np.zeros((4, 4), np.uint8)
    good = _png(img, 0, [0])
    with pytest.raises(ValueError):
        kitti.decode_png_bytes(b"GIF89a" + good[6:])
    sixteen = good.replace(struct.pack(">IIBB", 4, 4, 8, 0),
                           struct.pack(">IIBB", 4, 4, 16, 0))
    with pytest.raises(ValueError):
        kitti.decode_png_bytes(sixteen)
    with pytest.raises(ValueError):
        kitti.decode_png_bytes(_png(img, 0, [5]))

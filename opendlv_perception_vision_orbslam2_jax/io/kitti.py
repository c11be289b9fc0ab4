"""KITTI odometry dataset runner (the benchmarkable path).

Host re-design of KittiRunner (reference: src/kittirunner.cpp): load
``times.txt`` plus 6-digit PNGs from ``image_0/`` / ``image_1/``
(reference: loadImages :42-77), feed each stereo pair to the SLAM engine
with optional real-time pacing (reference: ProcessImage :99-173, pacing
:163-170), and report median/mean tracking time at shutdown (reference:
ShutDown :83-97).

The decode+transfer pipeline prefetches the next pair on a worker thread so
PNG decoding overlaps device compute (SURVEY.md section 7 hard-part 7);
the C++ decoder in native/ is used when built, else a zlib + NumPy decoder
of 8-bit non-interlaced PNGs.
"""

from __future__ import annotations

import os
import statistics
import struct
import threading
import time
import zlib
from queue import Queue

import numpy as np

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> samples per pixel (gray, RGB, gray+alpha, RGBA)
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def load_times(kitti_path: str) -> list[float]:
    with open(os.path.join(kitti_path, "times.txt")) as f:
        return [float(line) for line in f if line.strip()]


def image_paths(kitti_path: str, index: int) -> tuple[str, str]:
    name = f"{index:06d}.png"
    return (
        os.path.join(kitti_path, "image_0", name),
        os.path.join(kitti_path, "image_1", name),
    )


def decode_png_gray(path: str) -> np.ndarray:
    """Grayscale float32 [H, W]; native decoder if built, else
    :func:`decode_png_bytes`."""
    try:
        from ..native import png_native

        arr = png_native.decode_gray(path)
        if arr is not None:
            return arr
    except OSError:
        pass
    with open(path, "rb") as f:
        return decode_png_bytes(f.read())


def _unfilter_rows(rows: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the per-row PNG filters (types 0-4) of ``rows [H, 1 + stride]``
    (filter byte first); ``bpp`` bytes per pixel.  Returns ``uint8
    [H, stride]``."""
    h, stride = rows.shape[0], rows.shape[1] - 1
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int64)
    for y in range(h):
        ftype = int(rows[y, 0])
        line = rows[y, 1:].astype(np.int64)
        if ftype == 0:
            cur = line
        elif ftype == 1:      # Sub: running sum per channel, mod 256
            cur = np.cumsum(line.reshape(-1, bpp), axis=0).reshape(-1) & 0xFF
        elif ftype == 2:      # Up
            cur = (line + prev) & 0xFF
        elif ftype in (3, 4):  # Average / Paeth: sequential along the row
            cur = line.tolist()
            up = prev.tolist()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                b = up[i]
                if ftype == 3:
                    pred = (a + b) >> 1
                else:
                    c = up[i - bpp] if i >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[i] = (cur[i] + pred) & 0xFF
            cur = np.asarray(cur, np.int64)
        else:
            raise ValueError(f"PNG row {y}: unknown filter type {ftype}")
        out[y] = cur
        prev = cur
    return out


def decode_png_bytes(data: bytes) -> np.ndarray:
    """8-bit gray / gray+alpha / RGB / RGBA non-interlaced PNG -> grayscale
    float32 [H, W].  Colour converts with the BT.601 luma weights (alpha is
    dropped); other bit depths, palettes and interlacing raise ValueError."""
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError("not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or interlace != 0 or color not in _PNG_CHANNELS:
        raise ValueError(
            f"unsupported PNG: depth {depth}, colour {color}, interlace {interlace}"
        )
    ch = _PNG_CHANNELS[color]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (1 + w * ch):
        raise ValueError("PNG data size does not match its header")
    px = _unfilter_rows(raw.reshape(h, 1 + w * ch), ch).reshape(h, w, ch)
    px = px.astype(np.float32)
    if ch >= 3:
        return px[..., 0] * 0.299 + px[..., 1] * 0.587 + px[..., 2] * 0.114
    return px[..., 0]


def encode_png_gray(img) -> bytes:
    """uint8-range [H, W] array -> an 8-bit grayscale PNG (filter type 0)."""
    a = np.clip(np.rint(np.asarray(img, np.float64)), 0, 255).astype(np.uint8)
    h, w = a.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), a], axis=1)

    def chunk(ctype: bytes, body: bytes) -> bytes:
        crc = zlib.crc32(ctype + body) & 0xFFFFFFFF
        return struct.pack(">I", len(body)) + ctype + body + struct.pack(">I", crc)

    return (_PNG_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + chunk(b"IEND", b""))


def write_sequence(kitti_path: str, lefts, rights, times) -> None:
    """Write a KITTI-layout stereo sequence: ``times.txt`` plus
    ``image_0/``/``image_1/`` 6-digit grayscale PNGs."""
    for sub in ("image_0", "image_1"):
        os.makedirs(os.path.join(kitti_path, sub), exist_ok=True)
    with open(os.path.join(kitti_path, "times.txt"), "w") as f:
        f.writelines(f"{t:.6e}\n" for t in times)
    for i, (left, right) in enumerate(zip(lefts, rights)):
        for path, img in zip(image_paths(kitti_path, i), (left, right)):
            with open(path, "wb") as f:
                f.write(encode_png_gray(img))


class KittiRunner:
    """Drives a SLAM target over a KITTI sequence directory.

    ``slam`` is either a :class:`..models.selflocalization.Selflocalization`
    pipeline (preferred: its ``track`` publishes pose+map per frame and
    collects the fps.txt series itself, matching the reference's
    runKitti -> Track -> sendPose/sendMap flow,
    reference: src/selflocalization.cpp:65-99) or a bare engine exposing
    ``process`` (tests/bench), in which case this runner publishes."""

    def __init__(self, kitti_path: str, slam, real_time: bool = False,
                 publisher=None, prefetch: int = 4):
        self.kitti_path = kitti_path
        self.slam = slam
        self.real_time = real_time
        self.publisher = publisher
        self.times = load_times(kitti_path)
        self.track_times: list[float] = []
        self._queue: Queue = Queue(maxsize=prefetch)
        self._n = len(self.times)

    @property
    def _trajectory(self):
        inner = getattr(self.slam, "slam", None)
        return (inner or self.slam).trajectory

    def _producer(self):
        for i in range(self._n):
            left_path, right_path = image_paths(self.kitti_path, i)
            self._queue.put(
                (i, decode_png_gray(left_path), decode_png_gray(right_path))
            )
        self._queue.put(None)

    def run(self, max_frames: int | None = None):
        """Process the sequence; returns the trajectory list."""
        t = threading.Thread(target=self._producer, daemon=True)
        t.start()
        processed = 0
        while True:
            item = self._queue.get()
            if item is None:
                break
            i, left, right = item
            t0 = time.time()
            if hasattr(self.slam, "track"):
                # Selflocalization pipeline: publishes + records fps series
                self.slam.track(left, right, timestamp=self.times[i])
            else:
                self.slam.process(left, right, timestamp=self.times[i])
                if self.publisher is not None:
                    self._publish(i)
            dt = time.time() - t0
            self.track_times.append(dt)
            processed += 1

            if self.real_time and i + 1 < self._n:
                budget = self.times[i + 1] - self.times[i]
                if dt < budget:  # real-time pacing (reference :163-170)
                    time.sleep(budget - dt)
            if max_frames is not None and processed >= max_frames:
                break
        return self._trajectory

    def _publish(self, frame_idx: int):
        """Engine-mode publishing: a REAL pose per frame (sendPose contract,
        reference: src/selflocalization.cpp:83-86, 301-328) and the full map
        every 20 frames."""
        from ..models.selflocalization import pose_to_geolocation
        from .messages import chunk_map_messages

        traj = self._trajectory
        if not traj:
            return
        T = np.asarray(traj[-1])
        self.publisher.send(pose_to_geolocation(T, 0.0, 0.0, 0.0))
        # full map every 20 frames, pose-only otherwise (cadence contract,
        # reference: src/selflocalization.cpp:88-99)
        if frame_idx % 20 == 0 and hasattr(self.slam, "map"):
            m = self.slam.map
            pts = np.asarray(m.pt_pos)[np.asarray(m.pt_valid)]
            for msg in chunk_map_messages(T, pts.tolist()):
                self.publisher.send(msg)

    def shutdown_stats(self) -> dict:
        """Median/mean tracking time (reference: src/kittirunner.cpp:88-96)."""
        if not self.track_times:
            return {"median_s": 0.0, "mean_s": 0.0, "fps": 0.0}
        med = statistics.median(self.track_times)
        mean = sum(self.track_times) / len(self.track_times)
        return {
            "median_s": med,
            "mean_s": mean,
            "fps": 1.0 / mean if mean > 0 else 0.0,
        }

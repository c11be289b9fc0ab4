"""Plain NumPy references for the front-end kernels.

Each function computes on the host, in the most direct way, what one device
kernel computes: the FAST score + non-max suppression map, the window
gathers, the descriptor blur, the steered BRIEF sampling and the Hamming
matrix.  The CPU tests and ``chip_smoke.py`` compare the kernels with these.
Everything except :func:`blur_patches` is comparisons, copies and integer
counts, so the kernels must match it exactly; the blur is a float sum whose
order differs, and matches to float32 rounding.
"""

from __future__ import annotations

import numpy as np

from .fast import ARC_LEN, CIRCLE16
from .orb import BRIEF_HALF, N_ANGLE_BINS, N_BITS, brief_pattern


def fast_nms(img, ini_threshold: float, min_threshold: float, border: int):
    """FAST-9/16 on ``img [H, W]``: returns ``(scores, strong)``.

    ``scores`` is the V-score (the largest threshold at which some circular
    9-arc of the 16-pixel circle is all brighter, or all darker, than the
    centre) where it exceeds ``min_threshold``, else 0; then 3x3 non-max
    suppression (a pixel survives when no neighbour is larger) and zero
    within ``border`` of the edge.  ``strong`` is the pre-suppression
    ``score > ini_threshold`` mask.  Out-of-image circle samples repeat the
    edge pixel.
    """
    img = np.asarray(img, np.float32)
    h, w = img.shape
    p = np.pad(img, 3, mode="edge")
    d = np.stack([p[3 + dy:3 + dy + h, 3 + dx:3 + dx + w] - img
                  for dy, dx in CIRCLE16])                      # [16, H, W]

    def best_arc(diff):
        arcs = [diff[[(i + k) % 16 for k in range(ARC_LEN)]].min(axis=0)
                for i in range(16)]
        return np.max(arcs, axis=0)

    v = np.maximum(best_arc(d), best_arc(-d))
    scores = np.where(v > min_threshold, v, np.float32(0.0)).astype(np.float32)
    strong = scores > ini_threshold
    q = np.pad(scores, 1, constant_values=-np.inf)
    neighbourhood = np.max(
        [q[dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3)], axis=0
    )
    kept = np.where(scores >= neighbourhood, scores, np.float32(0.0))
    out = np.zeros_like(kept)
    if h > 2 * border and w > 2 * border:
        out[border:h - border, border:w - border] = (
            kept[border:h - border, border:w - border])
    return out, strong


def windows(img, y0, x0, ph: int, pw: int):
    """``[N, ph, pw]`` windows of ``img`` with top-left corners ``(y0, x0)``,
    each start clipped so that the window lies inside the image."""
    img = np.asarray(img)
    h, w = img.shape
    ys = np.clip(np.asarray(y0), 0, h - ph)
    xs = np.clip(np.asarray(x0), 0, w - pw)
    return np.stack([img[y:y + ph, x:x + pw] for y, x in zip(ys, xs)])


def blur_patches(patches):
    """7x7 Gaussian (sigma 2) of raw ``[N, 45, 45]`` patches, valid interior
    only: ``[N, 39, 39]``, accumulated in float64."""
    x = np.arange(-3, 4, dtype=np.float64)
    k = np.exp(-(x * x) / 8.0)
    k /= k.sum()
    p = np.asarray(patches, np.float64)
    n_out = p.shape[-1] - 6
    rows = sum(k[i] * p[:, i:i + n_out, :] for i in range(7))
    return sum(k[i] * rows[:, :, i:i + n_out] for i in range(7))


def brief_from_blurred(blurred, angles):
    """Steered binned BRIEF of blurred ``[N, 39, 39]`` interiors, packed
    ``uint32 [N, 8]`` (bit ``i`` of the descriptor in bit ``i % 32`` of word
    ``i // 32``).  The angle falls in one of 30 bins of 12 degrees; the
    pattern rotates by the bin's centre angle, rounds to the nearest pixel
    and clips to the interior; bit ``i`` is ``v(a_i) < v(b_i)``."""
    blurred = np.asarray(blurred)
    angles = np.asarray(angles, np.float32)
    pat = brief_pattern().astype(np.float64)
    bins = np.floor(
        (angles + np.float32(np.pi)) / np.float32(2.0 * np.pi)
        * np.float32(N_ANGLE_BINS)
    ).astype(np.int64) % N_ANGLE_BINS
    out = np.zeros((len(blurred), N_BITS // 32), np.uint32)
    for n, (patch, b) in enumerate(zip(blurred, bins)):
        th = (b + 0.5) * 2.0 * np.pi / N_ANGLE_BINS - np.pi
        c, s = np.cos(th), np.sin(th)

        def sample(px, py):
            rx = np.clip(np.round(px * c - py * s), -BRIEF_HALF, BRIEF_HALF)
            ry = np.clip(np.round(px * s + py * c), -BRIEF_HALF, BRIEF_HALF)
            return patch[ry.astype(int) + BRIEF_HALF, rx.astype(int) + BRIEF_HALF]

        bits = sample(pat[:, 0], pat[:, 1]) < sample(pat[:, 2], pat[:, 3])
        out[n] = np.packbits(bits, bitorder="little").view("<u4")
    return out


def hamming_matrix(a, b):
    """All-pairs Hamming distances of packed descriptors ``uint32 [N, 8]``
    and ``[M, 8]`` -> ``int32 [N, M]``, by counting set bits of the XOR."""
    a8 = np.ascontiguousarray(a, np.uint32).view(np.uint8)
    b8 = np.ascontiguousarray(b, np.uint32).view(np.uint8)
    x = np.bitwise_xor(a8[:, None, :], b8[None, :, :])
    return np.unpackbits(x, axis=-1).sum(axis=-1).astype(np.int32)

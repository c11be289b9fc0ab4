"""FAST-16 corner detection as a dense, whole-image vectorized kernel.

The reference runs OpenCV ``cv::FAST`` per 30x30 cell with a threshold
fallback (reference: src/orbextractor.cpp:950-956) and scores corners for the
quadtree by Harris/FAST response.  A per-cell scalar loop is the opposite of
what an accelerator wants, so here the segment test runs on *every pixel at once*:

- 16 circle neighbours materialize as 16 shifted views (XLA fuses the shifts),
- the "9 contiguous brighter/darker" test is an OR over the 16 circular
  9-windows of AND-reduced comparisons,
- the response is OpenCV's V-score: the largest threshold at which the pixel
  stays a corner = max over arcs of (min over the 9-arc of |p_i - p|),
- 3x3 non-max suppression is a max-pool compare.

Everything is branch-free elementwise work on [H, W] arrays, which XLA
fuses into a few kernels per level.
"""

from __future__ import annotations

import jax.numpy as jnp

from .image import max_pool_3x3_same

# Bresenham circle of radius 3, OpenCV pixel order, as (dy, dx).
CIRCLE_OFFSETS = (
    (0, 3), (1, 3), (2, 2), (3, 1), (3, 0), (3, -1), (-2, 2), (-1, 3),
)
# Full 16-point circle in circular order (clockwise from 12 o'clock).
CIRCLE16 = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)

ARC_LEN = 9  # contiguous run length for FAST-9/16 (OpenCV K=8 means >8)


def _neighbor_views(img):
    """16 shifted [H, W] views of the circle neighbours (padded slices —
    plain 2-D elementwise chains that XLA fuses fully, unlike a stacked
    [16, H, W] roll pipeline which materializes the cube repeatedly)."""
    H, W = img.shape
    p = jnp.pad(img, 3, mode="edge")
    return [p[3 + dy : 3 + dy + H, 3 + dx : 3 + dx + W] for (dy, dx) in CIRCLE16]


def fast_v_score(img):
    """Un-gated FAST V-score surface: the best-arc response at every pixel
    with no corner threshold applied (may be small-positive at non-corners).
    Shared core of :func:`fast_score_map`; also used raw for sub-pixel peak
    interpolation, where the threshold gate would flatten the surface."""
    img = img.astype(jnp.float32)
    nb = _neighbor_views(img)            # 16 x [H, W]
    diff = [n - img for n in nb]         # p_i - p

    def arc_response(d):
        # min over each circular 9-window via a prefix-min doubling tree:
        # p2[i] = min(d[i], d[i+1]), p4 = min(p2[i], p2[i+2]),
        # p8 = min(p4[i], p4[i+4]), w9[i] = min(p8[i], d[i+8]).
        p2 = [jnp.minimum(d[i], d[(i + 1) % 16]) for i in range(16)]
        p4 = [jnp.minimum(p2[i], p2[(i + 2) % 16]) for i in range(16)]
        p8 = [jnp.minimum(p4[i], p4[(i + 4) % 16]) for i in range(16)]
        w9 = [jnp.minimum(p8[i], d[(i + 8) % 16]) for i in range(16)]
        out = w9[0]
        for i in range(1, 16):
            out = jnp.maximum(out, w9[i])
        return out                        # best arc per pixel

    bright = arc_response(diff)
    dark = arc_response([-x for x in diff])
    return jnp.maximum(bright, dark)


def fast_score_map(img, threshold: float):
    """Dense FAST-9/16 response.

    Returns ``scores [H, W]`` float32: 0 where not a corner, else the V-score
    (max threshold at which the segment test still passes).  Matches the
    semantics OpenCV uses for NMS ordering; used here to rank candidates for
    the per-cell top-k distribution that replaces DistributeOctTree
    (reference: src/orbextractor.cpp:680-904, intentional approximation per
    SURVEY.md section 7).
    """
    v = fast_v_score(img)
    is_corner = v > threshold
    return jnp.where(is_corner, v, 0.0)


def subpixel_peak_from_patches(patches, center: int):
    """Sub-pixel corner localization: ``[N, S, S]`` raw intensity patches
    centred on detected corners -> ``[N, 2]`` (dx, dy) offsets in level px.

    Evaluates the un-gated FAST V-score on the central 3x3 of each patch and
    fits a 1-D parabola per axis — the same interpolation the reference uses
    for stereo disparity (reference: src/orbframe.cpp:641-649), applied here
    to corner *position*.  The reference keeps integer corner coordinates
    (src/orbextractor.cpp:906-994); this is a deliberate accuracy improvement
    that cuts per-level quantization noise (+-0.5 px at the level, scaled by
    1.2^octave at level 0) roughly in half.
    """
    import jax

    # V-score at the 3x3 around the centre needs circle samples within
    # +-(1+3) px: a 9x9 crop suffices and its central 3x3 sees no padding.
    crops = patches[:, center - 4 : center + 5, center - 4 : center + 5]
    v = jax.vmap(fast_v_score)(crops)[:, 3:6, 3:6]

    def fit(s_m, c, s_p):
        den = s_m + s_p - 2.0 * c
        off = jnp.where(den < -1e-6, 0.5 * (s_m - s_p) / den, 0.0)
        return jnp.clip(off, -0.5, 0.5)

    dx = fit(v[:, 1, 0], v[:, 1, 1], v[:, 1, 2])
    dy = fit(v[:, 0, 1], v[:, 1, 1], v[:, 2, 1])
    return jnp.stack([dx, dy], axis=-1)


def fast_with_fallback(img, ini_threshold: float, min_threshold: float):
    """Two-threshold FAST identical in spirit to the reference's retry
    (reference: src/orbextractor.cpp:950-962: try iniThFAST=20, if a cell is
    empty retry with minThFAST=7).

    Dense form: compute the min-threshold score map once; a pixel's score
    already encodes the max passing threshold, so cells that have any
    score > ini use those, and cells with none fall back to score > min.
    The per-cell selection happens in the extractor (per-cell top-k), so here
    we simply return the min-threshold map plus a boolean "strong" mask.
    """
    scores = fast_score_map(img, min_threshold)
    strong = scores > ini_threshold
    return scores, strong


def nms_scores(scores):
    """3x3 non-max suppression: keep only local maxima."""
    local_max = max_pool_3x3_same(scores)
    return jnp.where(scores >= local_max, scores, 0.0)


def mask_border(scores, border: int):
    """Zero responses within ``border`` px of the image edge (the reference
    clamps detection to EDGE_THRESHOLD-3 and descriptors need 19,
    reference: src/orbextractor.cpp:133-135, 916-921)."""
    H, W = scores.shape
    out = jnp.zeros_like(scores)
    if H <= 2 * border or W <= 2 * border:
        return out
    return out.at[border : H - border, border : W - border].set(
        scores[border : H - border, border : W - border]
    )

"""Stereo left<->right descriptor matching + SAD sub-pixel refinement.

Batched re-design of OrbFrame::ComputeStereoMatches (reference:
src/orbframe.cpp:511-705).  The reference loops left keypoints, looks up
row-band candidate lists, picks the best Hamming match, then slides an 11x11
SAD window on the matched pyramid level with parabola sub-pixel fitting and
finally cuts outliers at 1.5*1.4*median(SAD).

Here the same pipeline is a handful of masked dense ops:

- candidate gating is a boolean [KL, KR] mask (row band scaled by the right
  keypoint's octave, octave agreement within +-1, disparity range),
- best match per row comes from the shared Hamming kernel,
- the SAD slide gathers all left/right windows from a *pyramid atlas* (all
  levels stacked into one image) in a single batched gather — no per-octave
  loop,
- the median outlier cut is a masked quantile.

Depth convention matches the reference: ``depth = bf / disparity``; invalid
entries hold -1 (reference: src/orbframe.cpp:668-676).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from .hamming import TH_HIGH, TH_LOW, hamming_matrix, MAX_DIST
from .orb import gather_atlas_windows


SAD_HALF = 5          # w in the reference (11x11 window)
SLIDE = 5             # L in the reference (+-5 px slide)
TH_ORB = (TH_HIGH + TH_LOW) // 2   # 75 (reference: src/orbframe.cpp:540)
MIN_DISPARITY = 0.05  # reference clamps <=0 to 0.01; we invalidate instead


def build_atlas(levels):
    """Stack pyramid levels into one [sum(H_l), W0] image plus per-level row
    offsets, enabling octave-indexed patch gathers in a single pass."""
    w0 = levels[0].shape[1]
    padded = [jnp.pad(im, ((0, 0), (0, w0 - im.shape[1]))) for im in levels]
    offsets = np.cumsum([0] + [im.shape[0] for im in levels[:-1]]).astype(np.int32)
    return jnp.concatenate(padded, axis=0), jnp.asarray(offsets)


def _gather_windows(atlas, cx, cy, dx_grid, dy_grid):
    """Gather [N, ...window...] pixel windows centred at integer (cx, cy)."""
    H, W = atlas.shape
    ys = jnp.clip(cy[:, None] + dy_grid[None, :], 0, H - 1)
    xs = jnp.clip(cx[:, None] + dx_grid[None, :], 0, W - 1)
    return jnp.take(atlas.reshape(-1), ys * W + xs, axis=0)


def stereo_match(feat_left, feat_right, atlas_left, atlas_right, row_offsets,
                 scale_factor: float, fx: float, bf: float):
    """Returns ``(u_right [KL], depth [KL])`` with -1 for unmatched slots.

    ``feat_*`` are :class:`..models.frame.Features`; atlases come from
    :func:`build_atlas` over the two image pyramids.
    """
    KL = feat_left.xy.shape[0]
    uL, vL = feat_left.xy[:, 0], feat_left.xy[:, 1]
    uR, vR = feat_right.xy[:, 0], feat_right.xy[:, 1]
    octL, octR = feat_left.octave, feat_right.octave

    scaleR = jnp.power(jnp.float32(scale_factor), octR.astype(jnp.float32))
    max_d = fx          # maxD = bf / baseline = fx (reference: src/orbframe.cpp:534)
    min_d = 0.0

    # Candidate gating (reference: src/orbframe.cpp:544-575).
    row_ok = jnp.abs(vR[None, :] - vL[:, None]) <= 2.0 * scaleR[None, :]
    oct_ok = jnp.abs(octR[None, :] - octL[:, None]) <= 1
    u_ok = (uR[None, :] >= (uL[:, None] - max_d)) & (uR[None, :] <= (uL[:, None] - min_d))
    mask = row_ok & oct_ok & u_ok & feat_left.valid[:, None] & feat_right.valid[None, :]

    dist = hamming_matrix(feat_left.desc, feat_right.desc)
    big = MAX_DIST + 1
    d = jnp.where(mask, dist, big)
    best_r = jnp.argmin(d, axis=1)
    best_d = jnp.take_along_axis(d, best_r[:, None], axis=1)[:, 0]
    matched = best_d < TH_ORB

    # --- SAD sub-pixel refinement on the matched octave level -------------
    inv_scale_l = jnp.power(jnp.float32(1.0 / scale_factor), octL.astype(jnp.float32))
    su = jnp.round(uL * inv_scale_l).astype(jnp.int32)
    sv = jnp.round(vL * inv_scale_l).astype(jnp.int32)
    sur0 = jnp.round(jnp.take(uR, best_r) * inv_scale_l).astype(jnp.int32)
    row_base = jnp.take(row_offsets, octL)

    win = 2 * SAD_HALF + 1

    # Windows via batched slice gathers (the same window gather as the
    # descriptor patches).  Atlases are edge-padded so starts never
    # clamp-shift for valid keypoints; the few out-of-band starts produce
    # junk SAD that the interior/disparity/median gates already reject.
    yl = sv + row_base
    lp = jnp.pad(atlas_left, SAD_HALF, mode="edge")

    patch_l = gather_atlas_windows(lp, yl, su, win, win).reshape(KL, win * win)
    center_l = patch_l[:, (win * win) // 2]
    patch_l = patch_l - center_l[:, None]

    strip_w = win + 2 * SLIDE
    rp = jnp.pad(atlas_right, ((SAD_HALF, SAD_HALF),
                               (SAD_HALF + SLIDE, SAD_HALF + SLIDE)),
                 mode="edge")

    strip_r = gather_atlas_windows(rp, yl, sur0, win, strip_w)  # [KL, 11, 21]
    patches_r = jnp.stack(
        [strip_r[:, :, i : i + win] for i in range(2 * SLIDE + 1)], axis=1
    ).reshape(KL, 2 * SLIDE + 1, win * win)
    centers_r = patches_r[:, :, (win * win) // 2]
    patches_r = patches_r - centers_r[:, :, None]

    sad = jnp.sum(jnp.abs(patches_r - patch_l[:, None, :]), axis=-1)       # [KL, 11]
    best_inc_idx = jnp.argmin(sad, axis=1)
    best_sad = jnp.take_along_axis(sad, best_inc_idx[:, None], axis=1)[:, 0]
    interior = (best_inc_idx > 0) & (best_inc_idx < 2 * SLIDE)

    # Parabola fit over (dist1, dist2, dist3) (reference: src/orbframe.cpp:641-649).
    idx_m = jnp.clip(best_inc_idx - 1, 0, 2 * SLIDE)
    idx_p = jnp.clip(best_inc_idx + 1, 0, 2 * SLIDE)
    d1 = jnp.take_along_axis(sad, idx_m[:, None], axis=1)[:, 0]
    d3 = jnp.take_along_axis(sad, idx_p[:, None], axis=1)[:, 0]
    denom = 2.0 * (d1 + d3 - 2.0 * best_sad)
    delta = jnp.where(jnp.abs(denom) > 1e-6, (d1 - d3) / denom, 2.0)
    delta_ok = jnp.abs(delta) <= 1.0
    delta = jnp.where(delta_ok, delta, 0.0)

    scale_l = jnp.power(jnp.float32(scale_factor), octL.astype(jnp.float32))
    # The SAD slide aligns the right strip to the left window centred at the
    # *integer* level pixel su, so the measured right coordinate corresponds
    # to su — carry the left keypoint's sub-pixel offset (uL - su*scale, from
    # ops/fast.subpixel_peak_from_patches) onto u_right so that the output
    # coordinate pairs stay consistent and the disparity remains the
    # SAD-aligned one.
    frac_u = uL - su.astype(jnp.float32) * scale_l
    best_ur = frac_u + scale_l * (
        sur0.astype(jnp.float32) + (best_inc_idx - SLIDE).astype(jnp.float32) + delta
    )
    disparity = uL - best_ur
    disp_ok = (disparity >= MIN_DISPARITY) & (disparity < max_d)
    good = matched & interior & delta_ok & disp_ok

    # Median SAD outlier cut (reference: src/orbframe.cpp:684-704, with the
    # empty-median guard SURVEY.md flags as a reference bug).
    n_good = jnp.sum(good)
    sad_sorted = jnp.sort(jnp.where(good, best_sad, jnp.inf))
    median_idx = jnp.clip(n_good // 2, 0, KL - 1)
    median = sad_sorted[median_idx]
    th_dist = 1.5 * 1.4 * jnp.where(jnp.isfinite(median), median, 0.0)
    good = good & (best_sad < th_dist) & (n_good > 0)

    u_right = jnp.where(good, best_ur, -1.0)
    depth = jnp.where(good, bf / jnp.maximum(disparity, MIN_DISPARITY), -1.0)
    return u_right, depth

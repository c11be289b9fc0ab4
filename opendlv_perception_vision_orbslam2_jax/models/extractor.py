"""ORB feature extraction pipeline (pyramid -> FAST -> distribute -> describe).

Array re-design of OrbExtractor::ExtractFeatures (reference:
src/orbextractor.cpp:582-642):

- the per-cell scalar FAST loops (reference: src/orbextractor.cpp:906-994)
  become one dense score map per pyramid level;
- DistributeOctTree's pointer quadtree (reference: src/orbextractor.cpp:680-904)
  becomes a *per-cell top-k + breadth-first global selection*: candidates are
  ranked (cell-slot, response) so every cell's best corner is taken before any
  cell's second-best — the same spatial-uniformity objective with fully static
  shapes (intentional approximation, SURVEY.md section 7);
- the ini/min FAST threshold fallback (reference: src/orbextractor.cpp:950-962)
  is preserved: strong (>= iniThFAST) corners outrank weak (>= minThFAST) ones
  inside each cell, so weak corners surface only where no strong ones exist;
- orientation + steered BRIEF run as batched gathers per level.

The whole function jits once per image shape; both stereo images batch through
it via vmap (replacing the reference's two extraction threads,
reference: src/orbframe.cpp:73-76).
"""

from __future__ import annotations

import functools
import math
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import fast as fast_ops
from ..ops import image as image_ops
from ..ops import orb as orb_ops
from ..utils.config import OrbConfig
from .frame import Features

EDGE_BORDER = 16  # detection border, reference EDGE_THRESHOLD-3 (src/orbextractor.cpp:916)
CANDIDATES_PER_CELL = 4


def per_level_budgets(n_features: int, scale_factor: float, n_levels: int) -> list[int]:
    """Geometric per-level feature budgets (reference ctor,
    src/orbextractor.cpp:497-510: last level absorbs the remainder)."""
    factor = 1.0 / scale_factor
    n_desired = n_features * (1.0 - factor) / (1.0 - factor ** n_levels)
    budgets = []
    acc = 0
    for _ in range(n_levels - 1):
        b = int(round(n_desired))
        budgets.append(b)
        acc += b
        n_desired *= factor
    budgets.append(max(n_features - acc, 0))
    return budgets


def _select_level_keypoints(scores, strong, budget: int, cell: int):
    """Spatially-uniform top-``budget`` selection from a dense score map.

    Returns (xy [budget, 2] float32 level coords, response [budget], valid).
    """
    H, W = scores.shape
    ncy = math.ceil(H / cell)
    ncx = math.ceil(W / cell)
    pad_y, pad_x = ncy * cell - H, ncx * cell - W
    s = jnp.pad(scores, ((0, pad_y), (0, pad_x)))
    st = jnp.pad(strong, ((0, pad_y), (0, pad_x)))

    # [ncy*ncx, cell*cell] per-cell flattening.
    cells = s.reshape(ncy, cell, ncx, cell).transpose(0, 2, 1, 3).reshape(-1, cell * cell)
    cells_strong = (
        st.reshape(ncy, cell, ncx, cell).transpose(0, 2, 1, 3).reshape(-1, cell * cell)
    )
    # Strong corners dominate within the cell (threshold-fallback semantics).
    in_cell_key = jnp.where(cells > 0, cells + 1e6 * cells_strong, -1.0)
    k = min(CANDIDATES_PER_CELL, cell * cell)
    # k iterated argmaxes instead of lax.top_k: top_k lowers to a full sort
    # of every cell row; four masked max passes are plain elementwise work.
    col = jax.lax.broadcasted_iota(jnp.int32, in_cell_key.shape, 1)
    cur = in_cell_key
    tv, ti = [], []
    for _ in range(k):
        i = jnp.argmax(cur, axis=1)
        tv.append(jnp.take_along_axis(cur, i[:, None], axis=1)[:, 0])
        ti.append(i)
        cur = jnp.where(col == i[:, None], -1.0, cur)
    top_vals = jnp.stack(tv, axis=1)                        # [C, k]
    top_idx = jnp.stack(ti, axis=1)

    # Global breadth-first key: slot rank beats response, so cell coverage is
    # maximized before densifying any one cell (quadtree-equivalent).
    resp = jnp.where(top_vals > 0, jnp.minimum(top_vals, 1e6 - 1.0), 0.0)
    resp = jnp.where(resp >= 1e6 - 1.0, top_vals - 1e6, resp)  # strip strong bonus
    slot = jnp.broadcast_to(jnp.arange(k)[None, :], top_vals.shape)
    global_key = jnp.where(
        top_vals > 0, (k - 1 - slot).astype(jnp.float32) * 1e4 + resp, -1.0
    )

    flat_key = global_key.reshape(-1)
    flat_resp = resp.reshape(-1)
    flat_idx = top_idx.reshape(-1)
    cell_id = jnp.arange(flat_key.shape[0]) // k
    if flat_key.shape[0] < budget:  # tiny images (tests): pad candidate pool
        deficit = budget - flat_key.shape[0]
        flat_key = jnp.pad(flat_key, (0, deficit), constant_values=-1.0)
        flat_resp = jnp.pad(flat_resp, (0, deficit))
        flat_idx = jnp.pad(flat_idx, (0, deficit))
        cell_id = jnp.pad(cell_id, (0, deficit))
    sel_key, sel = jax.lax.top_k(flat_key, budget)

    sel_cell = jnp.take(cell_id, sel)
    sel_local = jnp.take(flat_idx, sel)
    cy = sel_cell // ncx
    cx = sel_cell % ncx
    ly = sel_local // cell
    lx = sel_local % cell
    y = (cy * cell + ly).astype(jnp.float32)
    x = (cx * cell + lx).astype(jnp.float32)
    response = jnp.take(flat_resp, sel)
    valid = sel_key > 0
    return jnp.stack([x, y], axis=-1), response, valid


@functools.partial(jax.jit, static_argnums=(1,))
def extract_features(img, config: OrbConfig) -> Features:
    """Full ORB extraction for one grayscale image ``[H, W]`` float32."""
    levels = image_ops.build_pyramid(img, config.n_levels, config.scale_factor)
    return extract_from_pyramid(levels, config)


def _select_pyramid_keypoints(levels: Sequence, config: OrbConfig):
    """FAST + NMS + spatially-uniform selection over all pyramid levels,
    batched over a leading image axis (the two stereo eyes run as one
    vmapped program per level).

    ``levels``: list of ``[B, H_l, W_l]`` stacked level images.  Returns
    per-level-concatenated ``(xy level-coords [B, N, 2], response [B, N],
    octave [B, N], valid [B, N], y0 [B, N], x0 [B, N])`` where ``(y0, x0)``
    are *level-local* patch-centre pixel coords (integer, border-clipped);
    :func:`_gather_all_patches` maps them into its gather layout.
    """
    budgets = per_level_budgets(config.n_features, config.scale_factor, config.n_levels)

    xs, resps, octs, valids, y0s, x0s = [], [], [], [], [], []
    for lvl, (level_img, budget) in enumerate(zip(levels, budgets)):
        B, H, W = level_img.shape

        def sel_one(img, budget=budget):
            scores, strong = fast_ops.fast_with_fallback(
                img, float(config.ini_th_fast), float(config.min_th_fast)
            )
            scores = fast_ops.nms_scores(scores)
            scores = fast_ops.mask_border(scores, EDGE_BORDER)
            return _select_level_keypoints(scores, strong, budget, config.cell_size)

        xy, response, valid = jax.vmap(sel_one)(level_img)
        y0s.append(jnp.clip(jnp.round(xy[..., 1]).astype(jnp.int32), 0, H - 1))
        x0s.append(jnp.clip(jnp.round(xy[..., 0]).astype(jnp.int32), 0, W - 1))
        xs.append(xy)
        resps.append(response)
        octs.append(jnp.full((B, budget), lvl, jnp.int32))
        valids.append(valid)

    return (
        jnp.concatenate(xs, axis=1),
        jnp.concatenate(resps, axis=1),
        jnp.concatenate(octs, axis=1),
        jnp.concatenate(valids, axis=1),
        jnp.concatenate(y0s, axis=1),
        jnp.concatenate(x0s, axis=1),
    )


def _gather_all_patches(levels: Sequence, y0, x0, config: OrbConfig):
    """One 45x45 raw patch per keypoint for every eye and level.

    ``levels``: list of ``[B, H_l, W_l]``; ``y0/x0 [B, N]`` level-local
    centre pixels from :func:`_select_pyramid_keypoints`.  Returns
    ``[B*N, side, side]`` patches ordered eye-major (eye 0's levels, then
    eye 1's).

    All levels stack into one edge-padded atlas per eye, the eyes' atlases
    concatenate, and one vmap(dynamic_slice) slice gather cuts every patch.
    Patch centre c maps to top-left c - half + half = c in the half-padded
    image, so the padded-image start IS the centre coordinate.
    """
    side = orb_ops.PATCH_SIDE
    B = levels[0].shape[0]
    budgets = per_level_budgets(config.n_features, config.scale_factor,
                                config.n_levels)

    atlases = [orb_ops.build_patch_atlas([lv[e] for lv in levels])
               for e in range(B)]
    atlas = jnp.concatenate([a for a, _ in atlases], axis=0)
    lvl_off = jnp.asarray(np.repeat(atlases[0][1], budgets))      # [N]
    eye_rows = atlases[0][0].shape[0]
    ys = jnp.concatenate([y0[e] + lvl_off + e * eye_rows for e in range(B)])
    xs = jnp.concatenate([x0[e] for e in range(B)])
    return orb_ops.gather_atlas_windows(atlas, ys, xs, side, side)


def _to_features(config, xy_lvl, response, octave, angle, desc, valid) -> Features:
    """Scale level coords to level-0 pixels and pad to the static capacity
    (reference scales keypoints back up, src/orbextractor.cpp:630-641)."""
    scale = jnp.power(jnp.float32(config.scale_factor), octave.astype(jnp.float32))
    xy = xy_lvl * scale[:, None]

    cap = config.max_keypoints
    n = xy.shape[0]
    if n > cap:
        raise ValueError(f"n_features {n} exceeds max_keypoints {cap}")
    pad = cap - n

    def padded(a, fill=0):
        widths = ((0, pad),) + tuple((0, 0) for _ in a.shape[1:])
        return jnp.pad(a, widths, constant_values=fill)

    return Features(
        xy=padded(xy),
        response=padded(response),
        octave=padded(octave),
        angle=padded(angle),
        desc=padded(desc),
        valid=padded(valid, False),
        u_right=padded(-jnp.ones((n,), jnp.float32), -1),
        depth=padded(-jnp.ones((n,), jnp.float32), -1),
    )


def extract_from_pyramid(levels: Sequence, config: OrbConfig) -> Features:
    """ORB extraction given a prebuilt pyramid (lets callers reuse the levels
    for the stereo SAD atlas without recomputing them).

    All levels' keypoints gather their 45x45 patches from one stacked atlas
    in a single batched window gather, then orientation, the descriptor blur
    and the binned steered BRIEF run over every keypoint of the image at
    once (see ops/orb.py).
    """
    stacked = [lv[None] for lv in levels]
    xy, response, octave, valid, y0, x0 = _select_pyramid_keypoints(
        stacked, config
    )
    patches = _gather_all_patches(stacked, y0, x0, config)
    xy = xy + fast_ops.subpixel_peak_from_patches(
        patches, orb_ops.PATCH_HALF
    )[None]
    angle = orb_ops.ic_angles_from_patches(patches)
    desc = orb_ops.brief_from_patches(patches, angle)
    return _to_features(config, xy[0], response[0], octave[0], angle, desc,
                        valid[0])


def extract_from_pyramid_pair(levels_lr: Sequence, config: OrbConfig):
    """Joint L/R extraction: FAST + selection vmap over the two eyes, then
    both eyes' keypoints share ONE atlas gather and ONE describe stage (2x
    the rows per kernel, half the kernel dispatches).
    Array analogue of the reference's two extraction threads (reference:
    src/orbframe.cpp:73-76).

    ``levels_lr``: list of ``[2, H_l, W_l]`` stacked level images.
    """
    xy, response, octave, valid, y0, x0 = _select_pyramid_keypoints(
        levels_lr, config
    )
    n = xy.shape[1]
    patches = _gather_all_patches(levels_lr, y0, x0, config)
    xy = xy + fast_ops.subpixel_peak_from_patches(
        patches, orb_ops.PATCH_HALF
    ).reshape(xy.shape)
    angle = orb_ops.ic_angles_from_patches(patches)
    desc = orb_ops.brief_from_patches(patches, angle)

    def feats(e, sl):
        return _to_features(config, xy[e], response[e], octave[e],
                            angle[sl], desc[sl], valid[e])

    return feats(0, slice(0, n)), feats(1, slice(n, 2 * n))


@functools.partial(jax.jit, static_argnums=(2,))
def extract_stereo_pair(img_left, img_right, config: OrbConfig):
    """Full stereo extraction from raw images (pyramids built internally)."""
    both = jnp.stack([img_left, img_right], axis=0)
    levels_lr = jax.vmap(
        lambda im: image_ops.build_pyramid(im, config.n_levels, config.scale_factor)
    )(both)
    return extract_from_pyramid_pair(levels_lr, config)

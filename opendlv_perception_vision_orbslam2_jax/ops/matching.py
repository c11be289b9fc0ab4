"""Projection-guided matching (frame <-> frame / frame <-> map).

Array re-design of the ORBmatcher SearchByProjection family
(frame<->last-frame variant, reference: src/orbmatcher.cpp:1337-1483; the
frame<->local-map variant :42-128 reuses the same masks with different
candidate sources).  The reference loops source points, queries the bucket
grid (GetFeaturesInArea reference: src/orbframe.cpp:308-379), picks the
best Hamming match and applies the rotation-consistency histogram.  Here:

- "grid query + loops" become one dense ``[K_src, K_dst]`` boolean gate
  (radius by octave, octave window, stereo right-u agreement),
- best match per source point is a masked argmin over the Hamming matrix,
- the rotation histogram filter is the shared kernel in ops/hamming.py.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from . import lie
from .hamming import (
    MAX_DIST,
    TH_HIGH,
    TH_LOW,
    hamming_matrix,
    rotation_consistency_mask,
)


class ProjectionMatches(NamedTuple):
    """Per-source-slot match results (padded, masked)."""

    dst_idx: jnp.ndarray   # [S] best destination feature index
    dist: jnp.ndarray      # [S] Hamming distance (MAX_DIST+1 when no match)
    valid: jnp.ndarray     # [S] bool


def search_by_projection(
    p_w,                  # [S, 3] world points to project
    src_valid,            # [S] bool
    src_desc,             # [S, 8] uint32 descriptors of the source points
    src_octave,           # [S] int32 octave (scale prediction source)
    src_angle,            # [S] float32 (rotation-consistency reference)
    dst_features,         # Features of the target frame
    T_cw,                 # [4, 4] predicted target pose
    *,
    fx: float, fy: float, cx: float, cy: float, bf: float,
    width: int, height: int,
    radius_th: float,      # 7 stereo / 15 mono, x2 on retry (reference
                           # src/tracking.cpp:718-748)
    scale_factor: float,
    max_dist: int = TH_HIGH,
    check_rotation: bool = True,
    forward_backward_gating: bool = True,
    z_motion: jnp.ndarray | None = None,  # scalar tz of T_last->T_cur
    baseline: float = 0.0,
    dist=None,                 # optional precomputed Hamming matrix [S, K]
    nn_ratio: float = 0.0,     # >0: best/second ratio test.  The reference's
                               # tight-gate variant has none (the 7px window
                               # is the precision mechanism); wide bootstrap
                               # gates need it to keep match precision high.
):
    """Returns :class:`ProjectionMatches` over source slots.

    ``forward_backward_gating`` mirrors the reference's octave window choice
    by dominant camera z-motion (reference: src/orbmatcher.cpp:1361-1366,
    1395-1417): moving forward -> expect features at coarser octaves.
    """
    S = p_w.shape[0]
    p_c = lie.transform_points(T_cw[None], p_w[None])[0]
    z = p_c[:, 2]
    uv = lie.project(p_c, fx, fy, cx, cy)
    in_img = (
        (uv[:, 0] >= 0) & (uv[:, 0] < width)
        & (uv[:, 1] >= 0) & (uv[:, 1] < height)
        & (z > 0.1)
    )
    proj_ur = uv[:, 0] - bf / jnp.maximum(z, 0.1)

    radius = radius_th * jnp.power(
        jnp.float32(scale_factor), src_octave.astype(jnp.float32)
    )

    d_uv = dst_features.xy[None, :, :] - uv[:, None, :]
    within = jnp.maximum(jnp.abs(d_uv[..., 0]), jnp.abs(d_uv[..., 1])) <= radius[:, None]

    oct_d = dst_features.octave[None, :]
    oct_s = src_octave[:, None]
    if forward_backward_gating and z_motion is not None:
        forward = z_motion > baseline
        backward = z_motion < -baseline
        oct_ok = jnp.where(
            forward,
            oct_d >= oct_s,
            jnp.where(
                backward,
                oct_d <= oct_s,
                jnp.abs(oct_d - oct_s) <= 1,
            ),
        )
    else:
        oct_ok = jnp.abs(oct_d - oct_s) <= 1

    # stereo right-u agreement (reference: src/orbmatcher.cpp:1422-1427)
    has_ur = dst_features.u_right[None, :] >= 0
    ur_ok = jnp.where(
        has_ur,
        jnp.abs(proj_ur[:, None] - dst_features.u_right[None, :]) <= radius[:, None],
        True,
    )

    gate = (
        within & oct_ok & ur_ok
        & src_valid[:, None] & in_img[:, None]
        & dst_features.valid[None, :]
    )

    if dist is None:
        dist = hamming_matrix(src_desc, dst_features.desc)
    big = MAX_DIST + 1
    d = jnp.where(gate, dist, big)
    best = jnp.argmin(d, axis=1)
    best_d = jnp.take_along_axis(d, best[:, None], axis=1)[:, 0]
    ok = best_d <= max_dist

    if nn_ratio > 0.0:
        d2 = d.at[jnp.arange(d.shape[0]), best].set(big)
        second = jnp.min(d2, axis=1)
        ok = ok & (
            best_d.astype(jnp.float32)
            <= nn_ratio * second.astype(jnp.float32)
        )

    if check_rotation:
        ok = rotation_consistency_mask(
            src_angle, dst_features.angle, best, ok
        )

    return ProjectionMatches(dst_idx=best, dist=best_d, valid=ok)


def search_for_initialization(
    feats_a, feats_b, *, window: float = 100.0, nn_ratio: float = 0.9,
    max_dist: int = TH_LOW, check_rotation: bool = True,
):
    """Window-gated matching for monocular initialization
    (SearchForInitialization, reference: src/orbmatcher.cpp:411-529): only
    level-0 keypoints, +-window px search box, best/second ratio 0.9 and the
    rotation-consistency histogram.  Returns (b_idx [A], valid [A])."""
    d_uv = feats_b.xy[None, :, :] - feats_a.xy[:, None, :]
    within = jnp.maximum(jnp.abs(d_uv[..., 0]), jnp.abs(d_uv[..., 1])) <= window
    lvl0 = (feats_a.octave[:, None] == 0) & (feats_b.octave[None, :] == 0)
    gate = within & lvl0 & feats_a.valid[:, None] & feats_b.valid[None, :]
    dist = hamming_matrix(feats_a.desc, feats_b.desc)
    big = MAX_DIST + 1
    d = jnp.where(gate, dist, big)
    best = jnp.argmin(d, axis=1)
    best_d = jnp.take_along_axis(d, best[:, None], axis=1)[:, 0]
    d2 = d.at[jnp.arange(d.shape[0]), best].set(big)
    second = jnp.min(d2, axis=1)
    ok = (best_d <= max_dist) & (
        best_d.astype(jnp.float32) <= nn_ratio * second.astype(jnp.float32)
    )
    if check_rotation:
        ok = rotation_consistency_mask(feats_a.angle, feats_b.angle, best, ok)
    m = resolve_duplicate_targets(
        ProjectionMatches(dst_idx=best, dist=best_d, valid=ok),
        feats_b.xy.shape[0],
    )
    return m.dst_idx, m.valid


def search_by_bow(
    desc_a, node_a, valid_a, angle_a,
    desc_b, node_b, valid_b, angle_b,
    *,
    max_dist: int = 50,          # TH_LOW (reference: src/orbmatcher.cpp:36)
    nn_ratio: float = 0.75,
    check_rotation: bool = True,
):
    """BoW-node-gated descriptor matching (SearchByBoW, reference:
    src/orbmatcher.cpp:164-292 KF<->frame and :531-663 KF<->KF).

    The reference walks the two feature vectors' shared vocabulary nodes;
    here the node agreement is a dense boolean gate on the Hamming matrix —
    identical association rule (same-node candidates, best + ratio test +
    rotation histogram), one masked argmin.  Returns
    ``(b_idx_per_a [A], valid [A])``.
    """
    gate = (
        (node_a[:, None] == node_b[None, :])
        & (node_a[:, None] >= 0)
        & valid_a[:, None] & valid_b[None, :]
    )
    dist = hamming_matrix(desc_a, desc_b)
    big = MAX_DIST + 1
    d = jnp.where(gate, dist, big)
    best = jnp.argmin(d, axis=1)
    best_d = jnp.take_along_axis(d, best[:, None], axis=1)[:, 0]
    d2 = d.at[jnp.arange(d.shape[0]), best].set(big)
    second = jnp.min(d2, axis=1)
    ok = (best_d <= max_dist) & (
        best_d.astype(jnp.float32) <= nn_ratio * second.astype(jnp.float32)
    )
    if check_rotation:
        ok = rotation_consistency_mask(angle_a, angle_b, best, ok)
    # one a per b (cross-duplicate resolution)
    m = resolve_duplicate_targets(
        ProjectionMatches(dst_idx=best, dist=best_d, valid=ok),
        desc_b.shape[0],
    )
    return m.dst_idx, m.valid


def resolve_duplicate_targets(matches: ProjectionMatches, n_dst: int):
    """Keep only the lowest-distance source per destination feature
    (scatter-min), mirroring the reference's implicit one-point-per-keypoint
    binding in m_mapPoints."""
    big = MAX_DIST + 1
    d = jnp.where(matches.valid, matches.dist, big)
    best_per_dst = jnp.full((n_dst,), big, d.dtype).at[matches.dst_idx].min(d)
    keep = matches.valid & (d <= jnp.take(best_per_dst, matches.dst_idx))
    # break remaining ties (two sources with identical distance) by index
    S = d.shape[0]
    order = jnp.arange(S)
    first_at = jnp.full((n_dst,), S).at[matches.dst_idx].min(
        jnp.where(keep, order, S)
    )
    keep = keep & (jnp.take(first_at, matches.dst_idx) == order)
    return matches._replace(valid=keep)


def motion_ladder_match(p_w, usable, desc_s, oct_s, ang_s, depth_s,
                        cur_features, T_pred, *, fx, fy, cx, cy, bf,
                        width, height, scale_factor, z_motion, baseline,
                        th_far, radius_mult: int = 1, min_matches: int = 20):
    """Shared motion-model matching ladder (x1 -> x2 -> brute), used by both
    the VO tracker (models/tracking.py) and the map tracker (models/slam.py).

    The reference retries SearchByProjection with a doubled radius when
    matches < 20 (reference: src/tracking.cpp:744-748) and falls back to
    BoW reference-keyframe matching when the motion model is stale
    (reference: src/tracking.cpp:587-629).  Here all three rungs evaluate in
    one program over a shared Hamming matrix and the first sufficient rung
    wins via masked select; rung sufficiency demands close-point coverage
    (translation information), not just match count.

    ``p_w [S,3]`` source world points, ``usable [S]`` mask, ``desc_s/oct_s/
    ang_s/depth_s`` per-source features, ``depth_s`` < 0 where unknown.
    Returns ``(ProjectionMatches, n_matches)``.
    """
    dist = hamming_matrix(desc_s, cur_features.desc)
    big = MAX_DIST + 1

    def match_at(mult):
        m = search_by_projection(
            p_w, usable, desc_s, oct_s, ang_s,
            cur_features, T_pred,
            fx=fx, fy=fy, cx=cx, cy=cy, bf=bf,
            width=width, height=height,
            radius_th=7.0 * mult * radius_mult,
            scale_factor=scale_factor,
            z_motion=z_motion, baseline=baseline,
            dist=dist, nn_ratio=0.0,
        )
        m = resolve_duplicate_targets(m, cur_features.capacity)
        return m, jnp.sum(m.valid)

    def brute_match():
        # gate-free appearance rung: ratio test + mutual cross-check +
        # rotation consistency
        gate = usable[:, None] & cur_features.valid[None, :]
        d = jnp.where(gate, dist, big)
        best = jnp.argmin(d, axis=1)
        best_d = jnp.take_along_axis(d, best[:, None], axis=1)[:, 0]
        d2 = d.at[jnp.arange(d.shape[0]), best].set(big)
        second = jnp.min(d2, axis=1)
        ok = (best_d <= TH_HIGH) & (
            best_d.astype(jnp.float32) <= 0.8 * second.astype(jnp.float32)
        )
        back = jnp.argmin(jnp.where(gate, dist, big), axis=0)
        ok = ok & (jnp.take(back, best) == jnp.arange(d.shape[0]))
        ok = rotation_consistency_mask(ang_s, cur_features.angle, best, ok)
        mb = ProjectionMatches(dst_idx=best, dist=best_d, valid=ok)
        mb = resolve_duplicate_targets(mb, cur_features.capacity)
        return mb, jnp.sum(mb.valid)

    m1, n1 = match_at(1)
    m2, n2 = match_at(2)
    m8, n8 = brute_match()

    # Rung rule: smallest radius with enough matches AND enough CLOSE-point
    # coverage.  A bare match-count rule settles on a tight gate that (under
    # a stale motion prediction) only captures low-flow FAR points — pure
    # rotation information, translation collapses.  Close points (src depth
    # < thDepth*baseline) are where translation accuracy lives, so each rung
    # must retain at least half the widest gate's close matches.
    close_src = (depth_s > 0) & (depth_s < th_far)
    c1 = jnp.sum(m1.valid & close_src)
    c2 = jnp.sum(m2.valid & close_src)
    c8 = jnp.sum(m8.valid & close_src)
    # monocular frames carry no depth: fall back to plain count coverage
    has_close = jnp.sum(close_src) > 0
    th_close = jnp.maximum(10, (c8 + 1) // 2)
    good1 = (n1 >= min_matches) & jnp.where(
        has_close, c1 >= th_close, 2 * n1 >= n8
    )
    good2 = (n2 >= min_matches) & jnp.where(
        has_close, c2 >= th_close, 2 * n2 >= n8
    )

    pick = lambda c, a, b: jnp.where(c, a, b)
    m = ProjectionMatches(
        dst_idx=pick(good1, m1.dst_idx, pick(good2, m2.dst_idx, m8.dst_idx)),
        dist=pick(good1, m1.dist, pick(good2, m2.dist, m8.dist)),
        valid=pick(good1, m1.valid, pick(good2, m2.valid, m8.valid)),
    )
    return m, jnp.sum(m.valid)

"""Full stereo SLAM pipeline: tracking against the map + local mapping.

This is the array re-design of the reference's tracking/mapping duet
(Tracking::Track with TrackWithMotionModel -> TrackLocalMap -> NeedNewKeyFrame
-> CreateNewKeyFrame, reference: src/tracking.cpp:262-339, 696-976, and the
Mapping thread consuming the keyframe queue, reference: src/mapping.cpp:48-116).

Thread structure -> staged pipeline (SURVEY.md section 7): the per-frame
device step is one jitted program; keyframe insertion + local BA run as a
second jitted stage invoked by the host scheduler when the keyframe decision
fires — same semantics, no locks.

Frame<->map binding: ``bindings [F] int32`` maps current-frame feature slots
to map point slots (-1 = none) — the array analogue of
``OrbFrame::m_mapPoints`` (reference: include/orbframe.hpp:157).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import lie, matching
from ..ops.hamming import MAX_DIST, TH_HIGH, hamming_matrix
from ..optim.pose_opt import PoseObs, pose_optimize, robust_pose_estimate
from ..utils.config import SystemConfig
from .frame import FrameState, features_scale_sigma2
from .frontend import process_stereo
from .fusion import run_fusion
from .local_mapping import local_mapping_step
from .map_state import MapState, empty_map, insert_keyframe, cull_points, cull_keyframes
from .tracking import MIN_MATCHES_MOTION

N_LOCAL_KFS = 10       # local-map keyframe window (reference caps at 80,
                       # src/tracking.cpp:1121; 10 covers the covisible core)
PL_TRACK = 8192        # local point capacity for frame tracking
MIN_INLIERS_MAP = 30   # TrackLocalMap acceptance (reference: src/tracking.cpp:800)


class TrackOutputs(NamedTuple):
    T_cw: jnp.ndarray
    bindings: jnp.ndarray       # [F] point slot per current feature (-1 none)
    n_inliers: jnp.ndarray      # after local-map pose optimization
    n_matches_mm: jnp.ndarray   # motion-model matches
    n_tracked_close: jnp.ndarray
    n_untracked_close: jnp.ndarray
    pt_visible_delta: jnp.ndarray  # [P] int32 (visible counter updates)
    pt_found_delta: jnp.ndarray    # [P] int32


def _motion_model_match(m: MapState, last_frame: FrameState, last_bindings,
                        T_pred, velocity, cur_frame: FrameState,
                        config: SystemConfig):
    """Projection match vs last frame with the multi-radius ladder; source
    world positions come from the map for bound features and from last-frame
    stereo unprojection for temporal VO points (UpdateLastFrame semantics,
    reference: src/tracking.cpp:631-694)."""
    cam = config.camera
    feats_last = last_frame.features
    P = m.pt_capacity

    bound = last_bindings >= 0
    safe_b = jnp.clip(last_bindings, 0, P - 1)
    p_w_map = m.pt_pos[safe_b]
    T_wc = lie.inv_T(last_frame.T_cw)
    p_w_vo = lie.transform_points(T_wc[None], last_frame.point_cam[None])[0]
    p_w = jnp.where(bound[:, None], p_w_map, p_w_vo)
    th_far = config.tracking.th_depth * cam.baseline_m
    has_depth = (feats_last.depth > 0) & feats_last.valid
    usable = (bound & m.pt_valid[safe_b] & feats_last.valid) | (
        has_depth & (feats_last.depth < th_far)
    )

    mm, n = matching.motion_ladder_match(
        p_w, usable, feats_last.desc, feats_last.octave, feats_last.angle,
        feats_last.depth, cur_frame.features, T_pred,
        fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, bf=cam.bf,
        width=cam.width, height=cam.height,
        scale_factor=config.orb.scale_factor,
        z_motion=velocity[2, 3], baseline=cam.baseline_m,
        th_far=th_far, min_matches=MIN_MATCHES_MOTION,
    )
    return mm, p_w, n


def _local_point_window(m: MapState, bindings):
    """Local map = points of the keyframes sharing points with the current
    frame (UpdateLocalKeyFrames/UpdateLocalPoints, reference:
    src/tracking.cpp:1031-1175).  Returns ``local_pts [PL]`` map slots."""
    K, F, P = m.kf_capacity, m.feat_capacity, m.pt_capacity
    cur_bound = jnp.zeros((P,), bool).at[
        jnp.where(bindings >= 0, bindings, P - 1)
    ].set(bindings >= 0)
    cur_bound = cur_bound.at[P - 1].set(False)

    # keyframes ranked by shared-point count (one [K,F] gather), with
    # RECENCY as the tie-break: when the frame inherited few/no map
    # bindings (stale prediction, wide-rung matches on temporal VO points)
    # a zero-share mask used to empty the whole local window and the frame
    # could never re-acquire the map; the reference's UpdateLocalKeyFrames
    # always keeps the latest keyframes reachable through the
    # neighbour/parent expansion (src/tracking.cpp:1067-1175)
    sees = jnp.where(
        m.kf_feat_valid & (m.kf_obs_point >= 0),
        jnp.take(cur_bound, jnp.clip(m.kf_obs_point, 0, P - 1)),
        False,
    ) & m.kf_valid[:, None]
    share = jnp.sum(sees, axis=1)
    # packed (share, recency) rank in int32: share clipped to 2^11-1 and id
    # to 2^20-1 so the packed value provably fits (share=2048 at F=2048
    # overflowed to a negative score — advisor r4 finding)
    rank_score = jnp.where(
        m.kf_valid,
        jnp.minimum(share, (1 << 11) - 1) * (1 << 20)
        + jnp.clip(m.kf_id, 0, (1 << 20) - 1),
        -1,
    )
    top_w, top_kfs = jax.lax.top_k(rank_score, N_LOCAL_KFS)
    # zero-share keyframes join the window ONLY when nothing shares at all
    # (the recovery fallback): admitting them alongside genuine covisible
    # keyframes feeds the matcher aliased far-region points every frame
    has_share = jnp.any(share > 0)
    kf_ok = jnp.where(has_share, top_w >= (1 << 20), top_w >= 0)

    binds = m.kf_obs_point[top_kfs]                         # [NK, F]
    b_ok = m.kf_feat_valid[top_kfs] & (binds >= 0) & kf_ok[:, None]
    pt_in = jnp.zeros((P,), bool).at[
        jnp.where(b_ok, binds, P - 1)
    ].set(b_ok)
    pt_in = pt_in.at[P - 1].set(False) & m.pt_valid

    rank = jnp.cumsum(pt_in.astype(jnp.int32)) - 1
    g2l = jnp.where(pt_in & (rank < PL_TRACK), rank, -1)
    local_pts = jnp.full((PL_TRACK,), -1, jnp.int32).at[
        jnp.where(g2l >= 0, g2l, PL_TRACK - 1)
    ].set(jnp.where(g2l >= 0, jnp.arange(P, dtype=jnp.int32), -1))
    return local_pts


def _search_local_points(m: MapState, local_pts, bindings, T_cw,
                         cur_frame: FrameState, config: SystemConfig,
                         radius_scale: float = 1.0):
    """Project unbound local points into the frame and match by descriptor
    (SearchLocalPoints + matcher SearchByProjection(frame, local map),
    reference: src/tracking.cpp:978-1029, src/orbmatcher.cpp:42-128).

    Returns (new bindings, visible local mask -> [P] visible delta)."""
    cam = config.camera
    P = m.pt_capacity
    PL = local_pts.shape[0]
    ok = local_pts >= 0
    slots = jnp.clip(local_pts, 0, P - 1)
    # skip points already bound to this frame
    already = jnp.zeros((P,), bool).at[
        jnp.where(bindings >= 0, bindings, P - 1)
    ].set(bindings >= 0)
    ok = ok & ~jnp.take(already, slots)

    p_w = m.pt_pos[slots]
    p_c = lie.transform_points(T_cw[None], p_w[None])[0]
    z = p_c[:, 2]
    uv = lie.project(p_c, cam.fx, cam.fy, cam.cx, cam.cy)
    cam_center = lie.inv_T(T_cw)[:3, 3]
    view = p_w - cam_center
    dist_w = jnp.linalg.norm(view, axis=-1) + 1e-9
    # frustum + scale band + viewing angle (IsInFrustum, reference:
    # src/orbframe.cpp:239-305: viewCos > 0.5)
    view_cos = jnp.sum(view * m.pt_normal[slots], axis=-1) / dist_w
    in_frustum = (
        (z > 0.1)
        & (uv[:, 0] >= 0) & (uv[:, 0] < cam.width)
        & (uv[:, 1] >= 0) & (uv[:, 1] < cam.height)
        & (dist_w >= 0.8 * m.pt_min_dist[slots])
        & (dist_w <= 1.2 * m.pt_max_dist[slots])
        & (view_cos > 0.5)
    )
    visible = ok & in_frustum

    # predicted octave from distance (PredictScale, reference:
    # src/orbmappoint.cpp:445-476)
    ratio = jnp.maximum(m.pt_max_dist[slots] / jnp.maximum(dist_w, 1e-6), 1.0)
    pred_oct = jnp.clip(
        jnp.ceil(jnp.log(ratio) / jnp.log(config.orb.scale_factor)).astype(jnp.int32),
        0, config.orb.n_levels - 1,
    )
    radius = radius_scale * jnp.where(view_cos > 0.998, 2.5, 4.0) * jnp.power(
        jnp.float32(config.orb.scale_factor), pred_oct.astype(jnp.float32)
    )

    feats = cur_frame.features
    d_uv = feats.xy[None, :, :] - uv[:, None, :]
    within = jnp.maximum(jnp.abs(d_uv[..., 0]), jnp.abs(d_uv[..., 1])) <= radius[:, None]
    oct_ok = (feats.octave[None, :] >= pred_oct[:, None] - 1) & (
        feats.octave[None, :] <= pred_oct[:, None] + 1
    )
    unbound_dst = bindings < 0
    gate = (
        within & oct_ok & visible[:, None]
        & feats.valid[None, :] & unbound_dst[None, :]
    )
    dmat = hamming_matrix(m.pt_desc[slots], feats.desc)
    big = MAX_DIST + 1
    d = jnp.where(gate, dmat, big)
    best = jnp.argmin(d, axis=1)
    best_d = jnp.take_along_axis(d, best[:, None], axis=1)[:, 0]
    d2 = d.at[jnp.arange(PL), best].set(big)
    second_idx = jnp.argmin(d2, axis=1)
    second = jnp.take_along_axis(d2, second_idx[:, None], axis=1)[:, 0]
    # ratio test 0.8 + TH_HIGH, applied ONLY when best and second sit at
    # the same pyramid level (reference: src/orbmatcher.cpp:105-123 —
    # `if(bestLevel==bestLevel2 && bestDist>mfNNratio*bestDist2) continue`);
    # an unconditional ratio dropped ~30% of true matches on scenes with
    # cross-octave descriptor twins (measured: 268 vs 382 bindings)
    same_level = jnp.take(feats.octave, best) == jnp.take(
        feats.octave, second_idx
    )
    ratio_ok = (~same_level) | (
        best_d.astype(jnp.float32) <= 0.8 * second.astype(jnp.float32)
    )
    good = (best_d <= TH_HIGH) & ratio_ok
    pm = matching.resolve_duplicate_targets(
        matching.ProjectionMatches(dst_idx=best, dist=best_d, valid=good),
        feats.capacity,
    )
    # write new bindings
    new_bindings = bindings.at[
        jnp.where(pm.valid, pm.dst_idx, feats.capacity - 1)
    ].max(jnp.where(pm.valid, slots, -1))
    vis_delta = jnp.zeros((P,), jnp.int32).at[
        jnp.where(visible, slots, P - 1)
    ].add(visible.astype(jnp.int32))
    vis_delta = vis_delta.at[P - 1].set(0)
    return new_bindings, vis_delta


@functools.partial(jax.jit, static_argnums=(6, 7))
def track_frame_with_map(m: MapState, last_frame: FrameState, last_bindings,
                         T_cw, velocity, cur_frame: FrameState,
                         config: SystemConfig,
                         pose_solver=None) -> TrackOutputs:
    """The per-frame device program for the full pipeline.

    ``pose_solver``: optional mesh-sharded pose optimizer (static; built by
    make_sharded_pose_optimizer) used for the local-map pose solve when
    more than one device is present — observations shard over the mesh and
    each GN step reduces one 6x6 system via psum (P8).  None = the
    single-device pose_optimize."""
    cam = config.camera
    P = m.pt_capacity
    F = cur_frame.features.capacity
    T_pred = velocity @ T_cw

    # --- stage 1: motion-model matching + first pose optimization --------
    mm, p_w_src, n_mm = _motion_model_match(
        m, last_frame, last_bindings, T_pred, velocity, cur_frame, config
    )
    sigma2 = features_scale_sigma2(cur_frame.features, config.orb.scale_factor)
    dst = mm.dst_idx
    obs1 = PoseObs(
        p_w=p_w_src,
        uv=jnp.take(cur_frame.features.xy, dst, axis=0),
        u_right=jnp.take(cur_frame.features.u_right, dst, axis=0),
        sigma2=jnp.take(sigma2, dst, axis=0),
        valid=mm.valid,
    )
    T1, _, _ = robust_pose_estimate(
        T_pred, obs1, jax.random.PRNGKey(0),
        fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, bf=cam.bf,
    )

    # inherit map bindings through the match (cur feature <- last feature)
    inherited = jnp.full((F,), -1, jnp.int32).at[
        jnp.where(mm.valid, mm.dst_idx, F - 1)
    ].max(jnp.where(mm.valid, last_bindings, -1))

    # --- stage 2: local-map search + second pose optimization ------------
    local_pts = _local_point_window(m, inherited)
    bindings, vis_delta = _search_local_points(
        m, local_pts, inherited, T1, cur_frame, config
    )

    bound = bindings >= 0
    safe_b = jnp.clip(bindings, 0, P - 1)
    obs2 = PoseObs(
        p_w=m.pt_pos[safe_b],
        uv=cur_frame.features.xy,
        u_right=cur_frame.features.u_right,
        sigma2=sigma2,
        valid=bound & m.pt_valid[safe_b] & cur_frame.features.valid,
    )
    if pose_solver is None:
        T2, inliers, n_inl = pose_optimize(
            T1, obs2, fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, bf=cam.bf
        )
    else:
        T2, inliers, n_inl = pose_solver(T1, obs2)
    # drop outlier bindings (reference removes them post-opt,
    # src/tracking.cpp:783-798)
    bindings = jnp.where(obs2.valid & inliers, bindings, -1)

    found_delta = jnp.zeros((P,), jnp.int32).at[
        jnp.where(bindings >= 0, bindings, P - 1)
    ].add((bindings >= 0).astype(jnp.int32))
    found_delta = found_delta.at[P - 1].set(0)

    # keyframe-decision stats (NeedNewKeyFrame, reference:
    # src/tracking.cpp:832-866): close tracked vs close untracked
    th_far = config.tracking.th_depth * cam.baseline_m
    depth = cur_frame.features.depth
    close = (depth > 0) & (depth < th_far) & cur_frame.features.valid
    n_tracked_close = jnp.sum(close & (bindings >= 0))
    n_untracked_close = jnp.sum(close & (bindings < 0))

    return TrackOutputs(
        T_cw=T2,
        bindings=bindings,
        n_inliers=n_inl,
        n_matches_mm=n_mm,
        n_tracked_close=n_tracked_close,
        n_untracked_close=n_untracked_close,
        pt_visible_delta=vis_delta,
        pt_found_delta=found_delta,
    )


@jax.jit
def apply_point_counters(m: MapState, vis_delta, found_delta) -> MapState:
    return m._replace(
        pt_visible=m.pt_visible + vis_delta,
        pt_found=m.pt_found + found_delta,
    )


@jax.jit
def adoption_fixup(m: MapState, pt_id_pre, vis_delta, found_delta,
                   bindings):
    """Reconcile tracker state with an async mapping stage's output.

    While the stage was in flight the tracker formed bindings (and
    visible/found deltas) against the INTERIM map; a point the stage
    culled whose slot was reallocated by same-stage triangulation would
    leave a binding silently pointing at different geometry (validity
    masks cannot catch slot reuse — advisor r4 finding).  Point identity =
    ``pt_first_kf_id`` per slot (same check as IncrementalGBA.merge): a
    cull + realloc within one stage always changes it, because culling
    only touches points >=2 keyframes old while triangulation stamps the
    current keyframe id.  Deltas and bindings on identity-changed slots
    are dropped."""
    same = pt_id_pre == m.pt_first_kf_id                   # [P]
    m = apply_point_counters(
        m,
        jnp.where(same, vis_delta, 0),
        jnp.where(same, found_delta, 0),
    )
    safe = jnp.clip(bindings, 0, m.pt_capacity - 1)
    keep = (bindings >= 0) & jnp.take(same & m.pt_valid, safe)
    return m, jnp.where(keep, bindings, -1)


@functools.partial(jax.jit, static_argnames=("config",))
def insert_stage(m: MapState, frame, bindings, config: SystemConfig):
    """The TRACKING-thread half of keyframe creation as one cheap device
    program: insert the keyframe + spawn close stereo points + refresh its
    covisibility row (CreateNewKeyFrame runs on the tracking thread in the
    reference too, src/tracking.cpp:898-976).

    Returns ``(m, slot, new_bindings, occ)`` where ``occ`` packs
    [n_kf_valid, n_pt_valid] for ONE host fetch (capacity-bucket decisions).
    """
    # monocular keyframes create no depth points (new geometry arrives only
    # through covisible triangulation, reference: src/tracking.cpp:906-911)
    th_far = (
        -1.0 if config.camera_type == "mono"
        else config.tracking.th_depth * config.camera.baseline_m
    )
    m, slot = insert_keyframe(m, frame, bindings, th_far, covis_mode="row")
    occ = jnp.stack([
        jnp.sum(m.kf_valid).astype(jnp.int32),
        jnp.sum(m.pt_valid).astype(jnp.int32),
    ])
    return m, slot, m.kf_obs_point[slot], occ


@functools.partial(
    jax.jit,
    static_argnames=("config", "do_triangulate", "do_fuse", "do_lba",
                     "do_cull"),
)
def mapping_stage(m: MapState, slot, config: SystemConfig,
                  do_triangulate: bool, do_fuse: bool, do_lba: bool,
                  do_cull: bool):
    """The MAPPING-thread work for one inserted keyframe as ONE device
    program: point-cull -> triangulate -> fuse -> local BA -> keyframe-cull
    -> covisibility rebuild.

    This is the reference Mapping::Run loop body (src/mapping.cpp:48-116)
    fused for the device: a single dispatch (no per-pass host
    round-trips), ONE observation-count
    recount threaded incrementally through every pass, and ONE covisibility
    rebuild at the end.  The host dispatches it ASYNCHRONOUSLY and keeps
    tracking against the post-insert snapshot until the result is ready —
    the staged-pipeline form of the reference's background mapping thread
    (P1, reference: src/selflocalization.cpp:361-367).

    Returns ``(m, aux)`` with aux packing
    [n_ref_matches(>=3-obs tracked points of the new KF), n_kf_valid,
    n_pt_valid] so adoption costs ONE host fetch; the do_* flags mirror the
    n_keyframes>=N bootstrap ramp and are static.

    Covisibility staleness (documented approximation): all passes run with
    ``update_covis=False`` — fusion neighbour selection and the local-BA
    window are chosen from weights that ignore same-stage point culls,
    triangulated links and fusion merges (the reference refreshes
    connections in ProcessNewKeyFrame and after SearchInNeighbors).  The
    full rebuild at stage end bounds the staleness to one keyframe.
    """
    from .map_state import (
        point_observation_counts,
        recompute_covisibility,
    )
    from .triangulation import create_new_map_points

    # sensor-dependent knobs (reference: src/mapping.cpp:286 — 20 triangulation
    # neighbours mono vs 10 stereo; src/mapping.cpp:536 — cnThObs 2 mono, 3
    # stereo)
    mono = config.camera_type == "mono"
    counts = point_observation_counts(m)
    m, counts = cull_points(
        m, m.next_kf_id - 1, th_obs=2 if mono else 3, counts=counts
    )
    if do_triangulate:
        m, counts = create_new_map_points(
            m, slot, config, n_neighbors=20 if mono else 10,
            update_covis=False, counts=counts,
        )
    if do_fuse:
        m, counts = run_fusion(m, slot, config, update_covis=False,
                               counts=counts)
    if do_lba:
        # divergence guard (beyond-reference robustness): a local BA seeded
        # with a few garbage stereo edges can throw the window meters away;
        # adopting that poisons the tracker through the pose rebase.  A
        # legitimate local correction is centimetres, so revert the whole
        # LBA output when the center keyframe moved implausibly far.
        T_pre = m.kf_T_cw[slot]
        m2, counts2 = local_mapping_step(m, slot, config, update_covis=False,
                                         counts=counts)
        moved = jnp.linalg.norm(
            (lie.inv_T(T_pre) @ m2.kf_T_cw[slot])[:3, 3]
        )
        ok = moved < 1.0
        m = jax.tree.map(lambda a, b: jnp.where(ok, a, b), m2, m)
        counts = jnp.where(ok, counts2, counts)
    if do_cull:
        m = cull_keyframes(m, slot, update_covis=False, counts=counts)
    m = m._replace(covis=recompute_covisibility(m))

    # nRefMatches for the keyframe decision (TrackedMapPoints(minObs), with
    # minObs 3 — 2 while the map has <=2 keyframes — reference:
    # src/tracking.cpp:825-829 + src/orbkeyframe.cpp:281-305)
    counts_now = point_observation_counts(m)
    binds = m.kf_obs_point[slot]
    bound = m.kf_feat_valid[slot] & (binds >= 0)
    safe = jnp.clip(binds, 0, m.pt_capacity - 1)
    min_obs = jnp.where(m.next_kf_id > 2, 3, 2)
    n_ref = jnp.sum(bound & m.pt_valid[safe] & (counts_now[safe] >= min_obs))
    aux = jnp.stack([
        n_ref.astype(jnp.int32),
        jnp.sum(m.kf_valid).astype(jnp.int32),
        jnp.sum(m.pt_valid).astype(jnp.int32),
    ])
    return m, aux


@functools.partial(
    jax.jit,
    static_argnames=("config", "do_triangulate", "do_fuse", "do_lba",
                     "do_cull"),
)
def keyframe_stage(m: MapState, frame, bindings, config: SystemConfig,
                   do_triangulate: bool, do_fuse: bool, do_lba: bool,
                   do_cull: bool):
    """insert_stage + mapping_stage fused into one synchronous program (the
    round-3 monolith, kept for the synchronous callers: monocular bootstrap
    and tests).  Returns ``(m, slot)``."""
    from .map_state import evict_oldest_if_full

    m = evict_oldest_if_full(m)
    m, slot, _, _ = insert_stage(m, frame, bindings, config)
    m, _ = mapping_stage(m, slot, config, do_triangulate, do_fuse, do_lba,
                         do_cull)
    return m, slot


@functools.partial(jax.jit, static_argnames=("config",))
def _wide_recovery_program(m: MapState, cur: FrameState, T_guess, key,
                           config: SystemConfig):
    """Projection-based recovery rung: the reloc-by-projection matcher
    (SearchByProjection reloc variant, reference: src/orbmatcher.cpp:
    1485-1617) against the RECENT-keyframe window from the last good pose
    with a wide radius, then the RANSAC-rescued pose solve.  Catches the
    common loss mode — a few bad frames near mapped territory — without
    needing BoW at all.  Returns (T, bindings, n_inliers)."""
    from ..optim.pose_opt import PoseObs, robust_pose_estimate
    from .frame import features_scale_sigma2

    cam = config.camera
    P = m.pt_capacity
    F = cur.features.capacity
    none = -jnp.ones((F,), jnp.int32)
    local_pts = _local_point_window(m, none)   # recency-ranked window
    bindings, _ = _search_local_points(
        m, local_pts, none, T_guess, cur, config, radius_scale=8.0
    )
    bound = bindings >= 0
    safe_b = jnp.clip(bindings, 0, P - 1)
    sigma2 = features_scale_sigma2(cur.features, config.orb.scale_factor)
    obs = PoseObs(
        p_w=m.pt_pos[safe_b],
        uv=cur.features.xy,
        u_right=cur.features.u_right,
        sigma2=sigma2,
        valid=bound & m.pt_valid[safe_b] & cur.features.valid,
    )
    T, inliers, n_inl = robust_pose_estimate(
        T_guess, obs, key,
        fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, bf=cam.bf,
    )
    bindings = jnp.where(obs.valid & inliers, bindings, -1)
    return T, bindings, n_inl


@functools.partial(jax.jit, static_argnames=("config",))
def _track_ref_kf_program(m: MapState, kf_nodes, last_bindings,
                          cur: FrameState, cur_nodes, T_cw,
                          config: SystemConfig):
    """TrackReferenceKeyFrame as one program (reference:
    src/tracking.cpp:587-629): pick the keyframe sharing most points with
    the last frame, BoW-match the current frame against it, pose-optimize
    from the last pose.  Returns (T_est, bindings, n_pair, n_inl)."""
    from ..ops.matching import search_by_bow
    from ..optim.pose_opt import PoseObs, pose_optimize
    from .frame import features_scale_sigma2

    cam = config.camera
    P = m.pt_capacity
    binds = last_bindings
    cur_bound = jnp.zeros((P,), bool).at[
        jnp.where(binds >= 0, binds, P - 1)
    ].set(binds >= 0).at[P - 1].set(False)
    sees = jnp.where(
        m.kf_feat_valid & (m.kf_obs_point >= 0),
        jnp.take(cur_bound, jnp.clip(m.kf_obs_point, 0, P - 1)),
        False,
    ) & m.kf_valid[:, None]
    ref_slot = jnp.argmax(jnp.sum(sees, axis=1))

    feats = cur.features
    idx_kf, ok = search_by_bow(
        feats.desc, cur_nodes, feats.valid, feats.angle,
        m.kf_desc[ref_slot], kf_nodes[ref_slot],
        m.kf_feat_valid[ref_slot], m.kf_angle[ref_slot],
        max_dist=50, nn_ratio=0.7,
    )
    bind = m.kf_obs_point[ref_slot][idx_kf]
    pair_ok = ok & (bind >= 0) & m.pt_valid[jnp.clip(bind, 0, P - 1)]
    sigma2 = features_scale_sigma2(feats, config.orb.scale_factor)
    obs = PoseObs(
        p_w=m.pt_pos[jnp.clip(bind, 0, P - 1)],
        uv=feats.xy, u_right=feats.u_right, sigma2=sigma2, valid=pair_ok,
    )
    T_est, inliers, n_inl = pose_optimize(
        T_cw, obs, fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, bf=cam.bf,
    )
    bindings = jnp.where(pair_ok & inliers, bind, -1)
    return T_est, bindings, jnp.sum(pair_ok), n_inl


@jax.jit
def rebase_pose(T_cur, T_kf_pre, T_kf_post):
    """Re-express the tracker pose after an async mapping stage moved its
    keyframe: keep the tracked relative pose cur<-KF, compose with the
    post-BA keyframe pose (the functional-map form of the reference tracker
    reading KF poses back through covisibility refs,
    src/tracking.cpp:546-585).  Degenerate inputs (non-finite or collapsed
    rotation) leave the pose untouched instead of zeroing it."""
    T = (T_cur @ lie.inv_T(T_kf_pre)) @ T_kf_post
    ok = jnp.all(jnp.isfinite(T)) & (
        jnp.abs(jnp.linalg.det(T[:3, :3]) - 1.0) < 0.1
    )
    return jnp.where(ok, T, T_cur)


class StereoSlam:
    """Host scheduler for the full pipeline (BASELINE configs 2-3):
    per-frame tracking stage + keyframe/local-BA stage + loop closing +
    relocalization, mirroring the reference's Selflocalization orchestration
    (reference: src/selflocalization.cpp:330-377 wiring)."""

    def __init__(self, config: SystemConfig, vocab=None,
                 enable_loop_closing: bool = True,
                 enable_relocalization: bool = True,
                 tracking_only: bool = False):
        #: localization-only mode (the reference's mbOnlyTracking,
        #: src/tracking.cpp:1538-1640): the map is frozen — no keyframes,
        #: no mapping stages — and the tracker runs the mbVO dual-hypothesis
        #: logic when it falls off the map (fewer than 10 map inliers:
        #: visual odometry carries the pose while relocalization is tried
        #: every frame; a successful reloc snaps back to the map).
        self.tracking_only = tracking_only
        self._vo_mode = False
        self.config = config
        self.map = empty_map(
            min(config.initial_keyframes, config.max_keyframes),
            min(config.initial_map_points, config.max_map_points),
            config.orb.max_keypoints,
        )
        self.T_cw = jnp.eye(4, dtype=jnp.float32)
        self.velocity = jnp.eye(4, dtype=jnp.float32)
        self.last_frame: FrameState | None = None
        self.last_bindings = None
        self.frames_since_kf = 0
        self.ref_kf_tracked = 0
        self.trajectory: list = []
        # per-frame (ref_kf_slot, ref_kf_id, T_rel) for the retro-corrected
        # trajectory (reference SaveTrajectoryKITTI semantics)
        self.traj_ref: list = []
        self.last_kf_id = -1
        self.lost = False
        self.n_keyframes = 0
        self.frame_idx = 0
        self.last_reloc_frame = -(10 ** 9)
        # occupancy snapshot [n_kf_valid, n_pt_valid] from the last stage
        # fetch (drives capacity-bucket growth + eviction headroom)
        self._occ = (0, 0)
        # in-flight async mapping stage:
        # dict(map, aux, slot(host int-able dev scalar), kf_id, T_kf_pre)
        self._kf_pending = None
        # inserted keyframes awaiting their mapping stage: [(slot, kf_id)]
        self._kf_queue: list = []
        # previous frame's decision scalars (device array, fetched next frame)
        self._decision_pending = None
        # tracked-counter deltas accumulated while a stage is in flight
        self._pending_vis = None
        self._pending_found = None
        # place recognition state (vocabulary may arrive lazily: the
        # reference loads ORBvoc.txt which does not ship; we train from the
        # first keyframe's descriptors when none is given)
        self.vocab = vocab
        self.enable_loop_closing = enable_loop_closing
        self.enable_relocalization = enable_relocalization
        self.db = None
        self.kf_nodes = None
        self.loop_closer = None
        self.loops_closed = 0
        self.pending_gba = None   # in-flight incremental post-loop GBA
        self._loop_pending: list = []  # FIFO of in-flight loop-detection fetches
        self._verify_pending = None    # in-flight Sim3 verification verdict
        self._verify_todo = None       # accepted candidate awaiting dispatch
        self._reloc_key = jax.random.PRNGKey(11)
        # P8: with more than one device the per-frame local-map pose solve
        # runs observation-sharded over the full mesh (the same switch the
        # production GBA uses); single-chip keeps the local solver
        self._pose_solver = None
        devs = jax.devices()
        if len(devs) > 1 and config.orb.max_keypoints % len(devs) == 0:
            from jax.sharding import Mesh

            from ..parallel.sharded_pose import make_sharded_pose_optimizer

            cam = config.camera
            self._pose_solver = make_sharded_pose_optimizer(
                Mesh(np.array(devs), ("obs",)), "obs",
                fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, bf=cam.bf,
            )

    # vocabulary lifecycle: the online vocabulary retrains as the map grows
    # — first at 8 keyframes (the bootstrap vocab from one frame has
    # near-zero discriminativeness), then at every 4x keyframe count
    # (32, 128, 512, ...).  The reference loads a ~1M-word offline ORBvoc
    # (src/orbvocabulary.cpp:39-118); none ships here, so the vocabulary is
    # trained online and kept representative of the map's lifetime instead
    # of frozen at its 8-keyframe era (a one-shot refresh silently degraded
    # the BoW relocalization rung on long drives — VERDICT r4).
    VOCAB_REFRESH_AT = 8
    # keyframes sampled for the retrain pool (bounds the pool fetch and the
    # k-means cost on big maps)
    VOCAB_POOL_KFS = 32

    def _ensure_vocab(self, frame: FrameState):
        if self.vocab is not None or not (
            self.enable_loop_closing or self.enable_relocalization
        ):
            return
        from . import vocabulary as voc

        descs = np.asarray(frame.features.desc)[np.asarray(frame.features.valid)]
        if len(descs) < 64:
            return
        self.vocab = voc.train_vocabulary(descs, branching=10, levels=4,
                                          seed=0)

    # keyframes between starting a retrain and swapping it in: the swap
    # happens at a FIXED keyframe count, not "whenever the thread happens
    # to finish" — thread-timing-dependent swap keyframes made the BoW rows
    # (and therefore loop detections) differ run to run (observed: a churn
    # drive closing 2 loops or 0 depending on host load)
    VOCAB_SWAP_DELAY = 4

    def _maybe_refresh_vocab(self):
        """Periodic vocabulary retrain, off the tracking path.

        The k-means train is pure-numpy host work and runs in a BACKGROUND
        thread; the finished vocabulary is swapped in (BoW rows + node
        tables rebuilt in one batched dispatch) at a DETERMINISTIC keyframe
        count (`trigger + VOCAB_SWAP_DELAY`), joining the thread if it is
        somehow still running — determinism is worth a rare bounded wait."""
        if self.db is None:
            return
        import threading

        t = getattr(self, "_vocab_thread", None)
        if t is not None:
            if self.n_keyframes < getattr(self, "_vocab_swap_at", 0):
                return
            if t.is_alive():
                t.join()
            self._vocab_thread = None
            vocab = getattr(self, "_vocab_result", None)
            self._vocab_result = None
            if vocab is not None:
                self._adopt_vocab(vocab)
            return
        due = getattr(self, "_next_vocab_refresh", self.VOCAB_REFRESH_AT)
        if self.n_keyframes < due:
            return
        # snapshot DEVICE handles only; the worker thread pays the pool
        # fetch (up to ~2 MB of descriptors) and the k-means — the
        # tracking path just starts the thread
        kf_desc, kf_feat_valid, kf_valid = (
            self.map.kf_desc, self.map.kf_feat_valid, self.map.kf_valid,
        )
        self._next_vocab_refresh = max(due * 4, self.n_keyframes + 1)
        self._vocab_swap_at = self.n_keyframes + self.VOCAB_SWAP_DELAY
        seed = int(due)
        pool_cap = self.VOCAB_POOL_KFS

        def work():
            from . import vocabulary as voc

            live = np.nonzero(np.asarray(kf_valid))[0]
            if live.size == 0:
                return
            rng = np.random.default_rng(seed)
            sel = (live if live.size <= pool_cap
                   else rng.choice(live, pool_cap, replace=False))
            sel_d = jnp.asarray(np.sort(sel))
            descs = np.asarray(kf_desc[sel_d])
            feat_ok = np.asarray(kf_feat_valid[sel_d])
            pool = descs[feat_ok]
            if len(pool) < 1000:
                return
            # cap the k-means pool: past ~24k descriptors extra samples
            # barely move the centroids but the Hamming-assignment cost is
            # linear in pool size, and on a small host the training thread
            # competes with the tracking loop for cores
            if len(pool) > 24000:
                pool = pool[rng.choice(len(pool), 24000, replace=False)]
            self._vocab_result = voc.train_vocabulary(
                pool, branching=10, levels=4, seed=seed
            )

        self._vocab_result = None
        self._vocab_thread = threading.Thread(target=work, daemon=True)
        self._vocab_thread.start()

    def _adopt_vocab(self, vocab):
        """Swap in a freshly trained vocabulary: rebuild the database rows
        and node tables for every live keyframe in ONE batched device
        dispatch (padded vocabularies share compiled programs, so this
        costs no recompilation after the first refresh)."""
        from . import vocabulary as voc
        from .kfdb import empty_kfdb

        m = self.map
        self.vocab = vocab
        self.db = empty_kfdb(m.kf_capacity, vocab.n_words)
        self.kf_nodes = -jnp.ones(
            (m.kf_capacity, self.config.orb.max_keypoints), jnp.int32
        )
        words, nodes = voc.transform_all(vocab, m.kf_desc, m.kf_feat_valid)
        rows = voc.bow_vectors(vocab, words)
        live = m.kf_valid
        self.db = self.db._replace(
            bow=jnp.where(live[:, None], rows, 0.0),
            has_row=live,
        )
        self.kf_nodes = jnp.where(live[:, None], nodes, -1)

    def _bg_fetch(self, fn, *args, ready=None):
        """Run a blocking device->host fetch on a daemon thread; returns a
        Future (see utils.host.bg_fetch for the rationale: daemon vs pool,
        and the is_ready poll)."""
        from ..utils.host import bg_fetch

        return bg_fetch(fn, *args, ready=ready)

    def _log_pose(self, T):
        """Append a frame pose to the trajectory AND its reference-keyframe
        relative transform.  The reference saves trajectories by re-chaining
        each frame through its reference keyframe at SAVE time
        (SaveTrajectoryKITTI, reference: src/tracking.cpp:1449-1536) so
        loop-closure / GBA corrections applied after the frame was tracked
        retro-correct the dumped trajectory; ``corrected_trajectory``
        reproduces that here."""
        self.trajectory.append(T)
        slot, kf_id = self.last_kf_slot_id
        if slot >= 0:
            T_rel = T @ lie.inv_T(self.map.kf_T_cw[slot])
        else:
            T_rel = T
        self.traj_ref.append((slot, kf_id, T_rel))

    def _relog_pose(self, T):
        """Replace the latest logged pose (post-hoc relocalization)."""
        self.trajectory.pop()
        self.traj_ref.pop()
        self._log_pose(T)

    @property
    def last_kf_slot_id(self):
        slot = getattr(self, "last_kf_slot", -1)
        return (slot, self.last_kf_id) if slot is not None else (-1, -1)

    def corrected_trajectory(self):
        """KITTI-style retro-corrected trajectory: each frame pose
        re-expressed through its reference keyframe's CURRENT (post-loop,
        post-GBA) pose.  Frames whose reference keyframe was culled or
        evicted (slot recycled: id mismatch) fall back to the raw online
        pose.  One batched device fetch."""
        if not self.traj_ref:
            return [np.asarray(T) for T in self.trajectory]
        rels = np.asarray(jax.device_get(
            jnp.stack([t[2] for t in self.traj_ref])
        ))
        raws = np.asarray(jax.device_get(jnp.stack(list(self.trajectory))))
        kf_valid = np.asarray(self.map.kf_valid)
        kf_ids = np.asarray(self.map.kf_id)
        T_kf = np.asarray(self.map.kf_T_cw)
        out = []
        for i, (slot, kf_id, _) in enumerate(self.traj_ref):
            if slot >= 0 and kf_valid[slot] and kf_ids[slot] == kf_id:
                out.append(rels[i] @ T_kf[slot])
            else:
                out.append(raws[i])
        return out

    def _register_keyframe(self, slot: int, kf_id: int):
        """BoW row + node table + loop detection for a new keyframe.

        Runs at ADOPTION time (after the async mapping stage lands) — the
        same pipeline position as the reference, whose LoopClosing thread
        consumes keyframes only after Mapping processed them and adds them
        to the keyframe database there (reference: src/mapping.cpp:90,
        src/loopclosing.cpp:216 mpKeyFrameDB->add)."""
        if self.vocab is None:
            return
        from . import vocabulary as voc
        from .kfdb import add_keyframe, empty_kfdb
        from .loop_closing import LoopCloser

        if self.db is None:
            self.db = empty_kfdb(self.map.kf_capacity, self.vocab.n_words)
            self.kf_nodes = -jnp.ones(
                (self.map.kf_capacity, self.config.orb.max_keypoints),
                jnp.int32,
            )
            self.loop_closer = LoopCloser(self.config)
            self.loop_closer.defer_gba = True

        self._maybe_refresh_vocab()
        words, nodes = voc.transform(
            self.vocab, self.map.kf_desc[slot], self.map.kf_feat_valid[slot]
        )
        self.db = add_keyframe(self.db, slot, voc.bow_vector(self.vocab, words))
        self.kf_nodes = self.kf_nodes.at[slot].set(nodes)
        # drop rows of culled keyframes
        self.db = self.db._replace(has_row=self.db.has_row & self.map.kf_valid)

        if self.enable_loop_closing and self.loop_closer is not None:
            # dispatch the new keyframe's queries WITHOUT blocking: results
            # queue up and are consumed on later frames (_try_harvest_loop)
            # strictly when their device values are ready.  Forcing the
            # previous harvest here used to DRAIN the whole device pipeline
            # (everything enqueued behind the detection programs) once per
            # keyframe; the reference's LoopClosing thread lags its queue
            # the same way (src/loopclosing.cpp:49-83).
            pend = self.loop_closer.dispatch(
                self.map, self.db, self.kf_nodes, slot, kf_id
            )
            if pend is not None:
                self._loop_pending.append(pend)

    def _try_harvest_loop(self, force: bool = False):
        """Drive the staged loop-closing pipeline without blocking (unless
        ``force``):

        1. consume finished detection fetches (host consistency logic on
           numpy data — :meth:`LoopCloser.harvest_detect`);
        2. on an accepted candidate, dispatch the Sim3 verification +
           masked apply as ONE device program (verify_and_apply) and adopt
           its output optimistically — with a failed verification the
           program returns the map unchanged, so nothing on the host ever
           waits for the verdict;
        3. consume the verdict lazily (worker-thread fetch) to bump
           counters / schedule the incremental GBA.

        The reference runs the same three phases on its LoopClosing thread
        (src/loopclosing.cpp:49-83); here the device pipeline is the
        "thread" and the host only ever touches finished fetches."""
        if self.loop_closer is None:
            return
        # ---- 3: consume a finished verification verdict ------------------
        vp = self._verify_pending
        if vp is not None and (force or vp["fetch"].done()):
            self._verify_pending = None
            if bool(vp["fetch"].result()):
                self.loops_closed += 1
                self.loop_closer.last_loop_kf_id = vp["kf_id"]
                self.loop_closer.prev_groups = []
                self.loop_closer.prev_counts = []
                self._verify_todo = None  # superseded by the closure
                # drop queued detections: their snapshots predate the
                # correction and the 10-keyframe cooldown skips them anyway
                self._loop_pending.clear()
                # schedule the full-map refinement incrementally; a newer
                # closure aborts (drops) any in-flight solve (reference:
                # src/loopclosing.cpp:409-420 mbStopGBA)
                from .global_ba import IncrementalGBA

                self.pending_gba = IncrementalGBA(self.map, self.config)
        # ---- 1: consume finished detections ------------------------------
        while self._loop_pending:
            pend = self._loop_pending[0]
            if not force and not pend["ready"]():
                break
            self._loop_pending.pop(0)
            det = self.loop_closer.harvest_detect(pend)
            if det is not None:
                # cooldown may have been consumed lazily above
                if det[1] - self.loop_closer.last_loop_kf_id >= 10:
                    self._verify_todo = det  # latest nomination wins
            if not force:
                break
        # ---- 2: dispatch a pending verification when the pipeline allows -
        # (an in-flight mapping stage's adoption would overwrite the
        # verified map; a second in-flight verify would fork it)
        if (self._verify_todo is not None and self._kf_pending is None
                and self._verify_pending is None):
            det, self._verify_todo = self._verify_todo, None
            self._dispatch_verify(det)
            if force:
                self._try_harvest_loop(force=True)

    def _dispatch_verify(self, det):
        """Launch verify_and_apply for an accepted loop candidate and adopt
        its (masked) output: map, rebased pose and velocity are all device
        values — consistency never waits on the host verdict."""
        from .loop_closing import verify_and_apply

        kf_slot, kf_id, cand_slot, cand_id = det
        lc = self.loop_closer
        lc.key, sub = jax.random.split(lc.key)
        m2, valid, T_pre, T_post = verify_and_apply(
            self.map, self.kf_nodes, kf_slot, cand_slot, kf_id, cand_id,
            sub, self.config, lc.fix_scale,
        )
        self.map = m2
        # ride the correction: keep the tracked cur<-KF relative pose
        T_reb = rebase_pose(self.T_cw, T_pre, T_post)
        self.T_cw = jnp.where(valid, lie.orthonormalize_T(T_reb), self.T_cw)
        self.velocity = jnp.where(
            valid, jnp.eye(4, dtype=jnp.float32), self.velocity
        )
        if self.last_frame is not None:
            self.last_frame = self.last_frame._replace(T_cw=self.T_cw)
        self._verify_pending = {
            "kf_id": kf_id,
            "fetch": self._bg_fetch(jax.device_get, valid,
                                    ready=valid.is_ready),
        }

    def _service_gba(self):
        """One bounded GBA chunk per frame; merge on completion (the
        between-frames slice of the reference's detached GBA thread)."""
        if self.pending_gba is None:
            return
        if self.pending_gba.step():
            self.map = self.pending_gba.merge(self.map)
            self.pending_gba = None

    def _track_reference_keyframe(self, cur: FrameState):
        """BoW-match the frame against its reference keyframe and
        pose-optimize from the last pose (TrackReferenceKeyFrame, reference:
        src/tracking.cpp:587-629) — the fallback rung between motion-model
        tracking and full relocalization.  ONE device program + ONE host
        fetch (it runs exactly when the system is already struggling)."""
        if self.vocab is None or self.kf_nodes is None:
            return False
        from . import vocabulary as voc

        feats = cur.features
        words, nodes = voc.transform(self.vocab, feats.desc, feats.valid)
        T_est, bindings, n_pair, n_inl = _track_ref_kf_program(
            self.map, self.kf_nodes, self.last_bindings, cur, nodes,
            self.T_cw, self.config,
        )
        stats = np.asarray(jnp.stack([n_pair, n_inl]))
        # reference gates: >=15 BoW matches (:607), >=10 map inliers (:625)
        if int(stats[0]) < 15 or int(stats[1]) < 10:
            return False
        self.T_cw = T_est
        self.last_bindings = bindings
        self.lost = False
        return True

    def _try_wide_recovery(self, cur: FrameState):
        """Wide projection recovery from the last good pose (see
        _wide_recovery_program).  Accepts at the TrackLocalMap threshold."""
        self._reloc_key, sub = jax.random.split(self._reloc_key)
        T, bindings, n_inl = _wide_recovery_program(
            self.map, cur, self.T_cw, sub, self.config
        )
        if int(np.asarray(n_inl)) < MIN_INLIERS_MAP:
            return False
        self.T_cw = T
        self.last_bindings = bindings
        self.lost = False
        return True

    def _try_relocalize(self, cur: FrameState):
        if not self.enable_relocalization or self.db is None:
            return False
        from .relocalization import relocalize

        self._reloc_key, sub = jax.random.split(self._reloc_key)
        res = relocalize(
            self.map, self.db, self.kf_nodes, self.vocab, cur,
            self.config, sub,
        )
        if res.success:
            self.T_cw = res.T_cw
            self.velocity = jnp.eye(4, dtype=jnp.float32)
            self.last_bindings = res.bindings
            self.lost = False
            return True
        return False

    def _try_global_reloc(self, cur: FrameState):
        """Vocabulary-free exact-NN relocalization over the whole map
        (relocalize_brute) — the rung that works when the online-trained
        BoW is too weak to rank candidates."""
        if not self.enable_relocalization:
            return False
        from .relocalization import relocalize_brute

        self._reloc_key, sub = jax.random.split(self._reloc_key)
        res = relocalize_brute(self.map, cur, self.config, sub)
        if res.success:
            self.T_cw = res.T_cw
            self.velocity = jnp.eye(4, dtype=jnp.float32)
            self.last_bindings = res.bindings
            self.lost = False
            return True
        return False

    @property
    def _th_far(self):
        return self.config.tracking.th_depth * self.config.camera.baseline_m

    @property
    def mapping_busy(self) -> bool:
        """True while an async mapping stage is in flight — the staged
        analogue of Mapping::AcceptKeyFrames()==false (reference:
        src/mapping.cpp:56, src/tracking.cpp:831)."""
        return self._kf_pending is not None

    # max keyframes inserted-but-not-yet-mapped while a stage is in flight
    # (the reference's stereo queue discipline: insert while fewer than 3
    # wait, src/tracking.cpp:884-893).  Queued keyframes skip local BA
    # (InterruptBA semantics), so admitting bursts costs less device time
    # than forcing each keyframe through the full stage.
    KF_QUEUE_CAP = 2

    def _insert_only(self, frame: FrameState, bindings):
        """Tracking-thread half (sync dispatch, no host round-trip): insert
        the keyframe + close points (CreateNewKeyFrame runs on the tracking
        thread in the reference too, src/tracking.cpp:898-976).  Returns
        (slot, kf_id, post-insert bindings)."""
        self.map, slot, new_bindings, occ = insert_stage(
            self.map, frame, bindings, self.config
        )
        kf_id = self.n_keyframes
        self.n_keyframes += 1
        self.frames_since_kf = 0
        self._inserts_since_occ = getattr(self, "_inserts_since_occ", 0) + 1
        return slot, kf_id, new_bindings

    def _dispatch_mapping(self, slot, kf_id, do_lba: bool = True):
        """Launch the heavy mapping stage asynchronously for an inserted
        keyframe.  ``do_lba=False`` skips the local BA — the analogue of the
        reference's InterruptBA when more keyframes wait in the queue
        (src/mapping.cpp:118-123)."""
        m_new, aux = mapping_stage(
            self.map, slot, self.config,
            do_triangulate=kf_id >= 1,
            do_fuse=kf_id >= 1,
            do_lba=kf_id >= 2 and do_lba,
            do_cull=kf_id >= 4,
        )
        self._kf_pending = {
            "map": m_new, "aux": aux, "slot": slot, "kf_id": kf_id,
            "T_kf_pre": self.map.kf_T_cw[slot],
            # interim-map point identities for the adoption-time binding
            # reconciliation (adoption_fixup)
            "pt_id_pre": self.map.pt_first_kf_id,
            # fetch on the worker thread, so that adoption reads a finished
            # host copy instead of blocking on the device
            "fetch": self._bg_fetch(jax.device_get, (aux, slot),
                                    ready=aux.is_ready),
        }
        P = self.map.pt_capacity
        self._pending_vis = jnp.zeros((P,), jnp.int32)
        self._pending_found = jnp.zeros((P,), jnp.int32)

    def _dispatch_keyframe(self, frame: FrameState, bindings):
        """Insert a keyframe; run its mapping stage now if the pipeline is
        idle, else queue it (burst-insertion semantics like the reference's
        abortable mapping queue).

        Queued keyframes keep their SOURCE DATA, not their slot: the
        in-flight stage's output replaces the whole map at adoption, which
        would silently erase any keyframe inserted after its dispatch (and
        its point allocations could collide with the stage's triangulated
        slots).  The insert below still happens immediately so TRACKING
        sees the new close points; at adoption the keyframe is re-inserted
        onto the settled map (bindings the tracker formed against the
        interim points are dropped by validity masks — a bounded,
        documented cost of the lock-free functional map)."""
        slot, kf_id, new_bindings = self._insert_only(frame, bindings)
        if self._kf_pending is None:
            self._dispatch_mapping(slot, kf_id)
            if not getattr(self, "_pipeline_healthy", False):
                # marginal tracking: settle the map NOW so the next frame
                # tracks fully-triangulated/fused/refined geometry (the
                # synchronous round-3 behaviour); async is a healthy-regime
                # optimization
                self._try_adopt_mapping(force=True)
                return self.map.kf_obs_point[self.last_kf_slot]
        else:
            self._kf_queue.append({"frame": frame, "bindings": bindings,
                                   "kf_id": kf_id})
        return new_bindings

    def _try_adopt_mapping(self, force: bool = False):
        """Adopt the async mapping-stage result once the device finished it
        (checked without blocking).  ``force`` blocks — used at shutdown and
        by the monocular bootstrap."""
        if self._kf_pending is None:
            return
        pend = self._kf_pending
        if not force and not pend["fetch"].done():
            return
        self._kf_pending = None
        m = pend["map"]
        # re-apply tracking's visible/found deltas accumulated in flight
        # and drop bindings/deltas whose point identity changed across the
        # stage (cull + same-stage slot reuse, see adoption_fixup)
        bindings = (
            self.last_bindings
            if self.last_bindings is not None
            else -jnp.ones((m.feat_capacity,), jnp.int32)
        )
        m, bindings = adoption_fixup(
            m, pend["pt_id_pre"], self._pending_vis, self._pending_found,
            bindings,
        )
        if self.last_bindings is not None:
            self.last_bindings = bindings
        self._pending_vis = self._pending_found = None
        # rebase the tracker onto the post-BA keyframe pose
        T_kf_post = m.kf_T_cw[pend["slot"]]
        self.T_cw = rebase_pose(self.T_cw, pend["T_kf_pre"], T_kf_post)
        if self.last_frame is not None:
            self.last_frame = self.last_frame._replace(T_cw=self.T_cw)
        self.map = m
        # both reads arrive via the worker-thread fetch started at dispatch
        stats, slot_np = pend["fetch"].result()
        self.ref_kf_tracked = max(int(stats[0]), 1)
        self._occ = (int(stats[1]), int(stats[2]))
        self._inserts_since_occ = len(self._kf_queue)
        slot = int(slot_np)
        self.last_kf_slot = slot
        self.last_kf_id = pend["kf_id"]
        self._maybe_resize(extra_kf=len(self._kf_queue))
        self._register_keyframe(slot, pend["kf_id"])
        # Sim3 verification slot: dispatch a pending loop candidate NOW —
        # the pipeline is momentarily idle (stage just adopted, next stage
        # not yet dispatched), and this is the ONLY guaranteed idle point
        # at high keyframe cadence.  Relying on _try_harvest_loop's
        # opportunistic gate alone starved verification: with a keyframe
        # every ~2 frames the mapping pipeline is never idle there and a
        # 200-frame churn drive verified exactly ONE candidate (and closed
        # zero loops) while the same drive closes 2+ when verification gets
        # this adoption-time slot.
        if (self._verify_todo is not None and self._verify_pending is None
                and self.loop_closer is not None):
            det, self._verify_todo = self._verify_todo, None
            self._dispatch_verify(det)
        # drain the insertion queue: REPLAY the queued keyframes onto the
        # settled map (see _dispatch_keyframe), then start the next mapping
        # stage; LBA only when the backlog is clear (InterruptBA semantics)
        if self._kf_queue:
            for q in self._kf_queue:
                # entries queued while the just-adopted stage was in flight
                # are not in its output map: re-insert them.  Entries
                # replayed at an earlier adoption are already part of every
                # later stage's base map and keep their slot.
                if q.get("slot") is None:
                    self.map, q_slot, _, _ = insert_stage(
                        self.map, q["frame"], q["bindings"], self.config
                    )
                    q["slot"] = q_slot
            first = self._kf_queue.pop(0)
            self._dispatch_mapping(first["slot"], first["kf_id"],
                                   do_lba=not self._kf_queue)
            if force:
                self._try_adopt_mapping(force=True)

    def _maybe_resize(self, extra_kf: int = 0):
        """Capacity-bucket growth / eviction headroom, decided from the
        occupancy snapshot (no extra device reads).  ``extra_kf``: queued
        keyframes about to be replayed on top of the snapshot."""
        cfg = self.config
        n_kf, n_pt = self._occ
        n_kf += extra_kf
        K, P = self.map.kf_capacity, self.map.pt_capacity
        grow_k = K if n_kf < K - 4 else min(K * 4, cfg.max_keyframes)
        grow_p = (
            P if n_pt < P - 2 * self.config.orb.max_keypoints
            else min(P * 4, cfg.max_map_points)
        )
        if (grow_k, grow_p) != (K, P):
            from .map_state import grow_map

            self.map = grow_map(self.map, grow_k, grow_p)
            if self.db is not None:
                dK = grow_k - K
                self.db = self.db._replace(
                    bow=jnp.pad(self.db.bow, ((0, dK), (0, 0))),
                    has_row=jnp.pad(self.db.has_row, (0, dK)),
                )
                self.kf_nodes = jnp.pad(
                    self.kf_nodes, ((0, dK), (0, 0)), constant_values=-1
                )
            # an in-flight GBA snapshot has the old shapes: drop it (the
            # reference aborts GBA on map topology changes too)
            self.pending_gba = None
        elif n_kf >= K - 5 and K >= cfg.max_keyframes:
            # at the top bucket: make room the recycling way — keep enough
            # headroom for one in-flight insert plus the full queue
            from .map_state import evict_oldest_if_full

            for _ in range(3):
                self.map = evict_oldest_if_full(self.map, min_free=5)

    def _insert_keyframe(self, frame: FrameState, bindings):
        """Synchronous insert + mapping + registration (bootstrap path and
        API compatibility for tests/tools; steady-state frames use
        _dispatch_keyframe + _try_adopt_mapping)."""
        bindings = self._dispatch_keyframe(frame, bindings)
        self._try_adopt_mapping(force=True)
        return self.map.kf_obs_point[self.last_kf_slot]

    def finish(self):
        """Settle all in-flight asynchronous work: adopt the pending mapping
        stage and run any in-flight incremental GBA to completion (the
        functional analogue of Selflocalization::Shutdown joining the
        mapping/loop-closing threads, reference:
        src/selflocalization.cpp:560-570).  Call before reading final map /
        trajectory state.  On return no fetch or retrain thread is left
        holding device arrays."""
        t = getattr(self, "_vocab_thread", None)
        if t is not None:
            t.join()
        if self._decision_pending is not None:
            stats_fut, T_before, binds, frame = self._decision_pending
            self._decision_pending = None
            self._handle_decision(stats_fut.result(), T_before, binds,
                                  frame)
        self._try_adopt_mapping(force=True)
        self._try_harvest_loop(force=True)
        while self.pending_gba is not None:
            self._service_gba()

    def reset(self):
        """Full system reset (Selflocalization::Reset -> Tracking::Reset,
        reference: src/selflocalization.cpp:577-580, src/tracking.cpp:1340-1385):
        clear map, database and tracker state; the trajectory log survives."""
        cfg = self.config
        self.map = empty_map(
            min(cfg.initial_keyframes, cfg.max_keyframes),
            min(cfg.initial_map_points, cfg.max_map_points),
            cfg.orb.max_keypoints,
        )
        self.T_cw = jnp.eye(4, dtype=jnp.float32)
        self.velocity = jnp.eye(4, dtype=jnp.float32)
        self.last_frame = None
        self.last_bindings = None
        self.frames_since_kf = 0
        self.ref_kf_tracked = 0
        self.lost = False
        self.n_keyframes = 0
        self.last_kf_id = -1
        # keyframe ids restart at 0 after a reset: old traj_ref entries
        # could falsely re-anchor to recycled (slot, id) pairs — demote
        # them to their raw poses
        self.traj_ref = [(-1, -1, t[2]) for t in self.traj_ref]
        self.last_reloc_frame = -(10 ** 9)
        self._occ = (0, 0)
        self._inserts_since_occ = 0
        self._kf_pending = None
        self._kf_queue = []
        self._decision_pending = None
        self._pending_vis = self._pending_found = None
        self.db = None
        self.kf_nodes = None
        self.loop_closer = None
        self.pending_gba = None
        self._loop_pending = []
        self._verify_pending = None
        self._verify_todo = None

    def process(self, img_left, img_right, timestamp: float = 0.0):
        cfg = self.config
        img_left = jnp.asarray(img_left, jnp.float32)
        img_right = jnp.asarray(img_right, jnp.float32)
        cur = process_stereo(img_left, img_right, cfg, timestamp)
        return self._step(cur)

    def process_rgbd(self, img, depth_map, timestamp: float = 0.0):
        """RGB-D ingestion (GrabImageRGBD, reference: src/tracking.cpp:202-230).

        After frame construction the RGB-D frame carries the same
        u_right/depth fields as a stereo frame, so tracking, mapping and
        loop closing are shared verbatim (reference treats the two sensors
        identically past OrbFrame construction).
        """
        from .frontend import process_rgbd as _process_rgbd
        cur = _process_rgbd(
            jnp.asarray(img, jnp.float32),
            jnp.asarray(depth_map, jnp.float32),
            self.config, timestamp,
        )
        return self._step(cur)

    def _need_new_keyframe(self, tracked, n_tracked_close,
                           n_untracked_close) -> bool:
        """Faithful NeedNewKeyFrame (reference: src/tracking.cpp:812-896).

        c1a: max_frames elapsed since the last keyframe.
        c1b: min_frames elapsed AND mapping idle.
        c1c: weak tracking (<0.25 of the reference keyframe's mature
             matches) or close-point starvation (stereo).
        c2:  real degradation vs the reference KF (<thRefRatio, 0.4 for a
             2-KF map else 0.75 stereo) or close starvation — AND >15
             matches so a dying tracker never spawns keyframes.
        Busy discipline: with a mapping stage in flight, stereo/RGB-D
        keyframes may still QUEUE while fewer than ``KF_QUEUE_CAP`` wait
        (the reference interrupts BA and queues while fewer than 3 wait,
        :884-893); queued keyframes are replayed at adoption with local BA
        skipped (InterruptBA semantics).  Monocular never queues.
        Post-relocalization window: no insertions within max_frames of a
        reloc while the map has more keyframes than that (reference: :820).
        """
        cfg = self.config
        if self.lost:
            return False
        if (self.frame_idx < self.last_reloc_frame + cfg.tracking.max_frames
                and self.n_keyframes > cfg.tracking.max_frames):
            return False
        busy = self.mapping_busy
        n_ref = max(self.ref_kf_tracked, 1)
        # thRefRatio: 0.9 mono, 0.75 stereo, 0.4 with a 2-keyframe map
        # (reference: src/tracking.cpp:848-856)
        if cfg.camera_type == "mono":
            th_ref_ratio = 0.9
        else:
            th_ref_ratio = 0.75 if self.n_keyframes > 2 else 0.4
        need_close = (n_tracked_close < 100) and (n_untracked_close > 70)
        c1a = self.frames_since_kf >= cfg.tracking.max_frames
        c1b = self.frames_since_kf >= cfg.tracking.min_frames and not busy
        c1c = need_close or tracked < 0.25 * n_ref
        c2 = (tracked < th_ref_ratio * n_ref or need_close) and tracked > 15
        # insertion admission (reference: src/tracking.cpp:884-893): idle ->
        # insert; busy -> stereo/RGB-D may still QUEUE while fewer than
        # KF_QUEUE_CAP wait (the mapping stage drains them with LBA
        # skipped), monocular never queues
        can_insert = (not busy) or (
            cfg.camera_type != "mono"
            and len(self._kf_queue) < self.KF_QUEUE_CAP
        )
        # hard capacity guard: never insert into a map without a free slot
        # (slot allocation would overwrite keyframe 0, the gauge anchor)
        est_kf = self._occ[0] + getattr(self, "_inserts_since_occ", 0)
        can_insert = can_insert and est_kf < self.map.kf_capacity - 1
        return (c1a or c1b or c1c) and c2 and can_insert

    def _step(self, cur: FrameState):
        cfg = self.config
        self.frame_idx += 1
        # adopt a finished async mapping stage before tracking (non-blocking)
        self._try_adopt_mapping()
        # drive the loop-closing pipeline.  Detection consumption (phase 1)
        # and verdict consumption (phase 3) never touch the map, so they
        # are safe at any pipeline state; the map-mutating verify DISPATCH
        # (phase 2) gates itself on an idle mapping pipeline and also gets
        # a guaranteed slot at every stage adoption.  (An earlier
        # settled-map guard HERE starved the whole pipeline at high
        # keyframe cadence: with a keyframe every ~2 frames the mapping
        # stage is never idle at this point, detections piled up unread,
        # and a 200-frame churn drive verified exactly one candidate.)
        self._try_harvest_loop()
        # auto-reset if lost right after bootstrap (reference:
        # src/tracking.cpp:305-313: lost with <=5 keyframes => full reset)
        if self.lost and self.last_frame is not None and self.n_keyframes <= 5:
            self._try_adopt_mapping(force=True)
            self.reset()

        if self.last_frame is None:
            if self.tracking_only:
                # localization-only: no map bootstrap — relocalize against
                # the preloaded map (reference activates OnlyTracking on an
                # existing map)
                self.last_frame = cur
                self.last_bindings = -jnp.ones(
                    (cur.features.capacity,), jnp.int32
                )
                self._try_relocalize(cur)
                self._log_pose(self.T_cw)
                return self.T_cw
            # stereo initialization (reference: src/tracking.cpp:342-395)
            n_depth = int(jnp.sum(cur.features.depth > 0))
            if n_depth < 100:
                return None
            self._ensure_vocab(cur)
            bindings = self._insert_keyframe(
                cur, -jnp.ones((cur.features.capacity,), jnp.int32)
            )
            self.last_frame = cur
            self.last_bindings = bindings
            self._log_pose(jnp.eye(4, dtype=jnp.float32))
            return self.T_cw

        out = track_frame_with_map(
            self.map, self.last_frame, self.last_bindings,
            self.T_cw, self.velocity, cur, cfg, self._pose_solver,
        )
        if self.mapping_busy:
            # the in-flight stage's output would overwrite these counters;
            # accumulate and re-apply at adoption
            self._pending_vis = self._pending_vis + out.pt_visible_delta
            self._pending_found = self._pending_found + out.pt_found_delta
        self.map = apply_point_counters(
            self.map, out.pt_visible_delta, out.pt_found_delta
        )
        # Optimistic pose integration: assume the frame tracked (the common
        # case) and update pose/velocity on-device without reading anything
        # back.  The decision scalars are fetched ONE FRAME LATE, below —
        # the fetch for frame N-1 overlaps the device computing frame N, so
        # steady-state throughput is device-bound instead of paying a
        # host round-trip per frame on top of the compute.
        # pose hygiene (device-side, fetched with the stats): finite entries
        # and an orthonormal-ish rotation.  A degenerate pose (a NaN wiped
        # to zeros somewhere upstream) must never be integrated — inv_T of
        # a ~zero rotation silently zeroes every later rebase.  Valid poses
        # are re-projected onto SE(3): composition chains (velocity priors,
        # rebases) otherwise accumulate scale in R exponentially.
        T_new = out.T_cw
        R = T_new[:3, :3]
        pose_ok = jnp.all(jnp.isfinite(T_new)) & (
            jnp.abs(jnp.linalg.det(R) - 1.0) < 0.1
        )
        T_new = jnp.where(
            pose_ok, lie.orthonormalize_T(T_new), self.T_cw
        )
        stats_dev = jnp.stack([
            out.n_inliers.astype(jnp.int32) * pose_ok.astype(jnp.int32),
            jnp.sum(out.bindings >= 0).astype(jnp.int32),
            out.n_tracked_close.astype(jnp.int32),
            out.n_untracked_close.astype(jnp.int32),
        ])
        T_before = self.T_cw
        bindings_before = self.last_bindings
        frame_before = self.last_frame
        self.velocity = T_new @ lie.inv_T(self.T_cw)
        self.T_cw = T_new
        cur = cur._replace(T_cw=T_new)
        self.last_frame = cur
        self.last_bindings = out.bindings
        self.frames_since_kf += 1
        self._log_pose(T_new)

        # ---- decision handling -------------------------------------------
        # Healthy steady state: act on the PREVIOUS frame's scalars — the
        # fetch for frame N-1 overlaps the device computing frame N, hiding
        # the device round-trip behind compute.  Marginal tracking or a
        # young map: decide SYNCHRONOUSLY on the current frame — stale
        # decisions on a degrading tracker delay keyframes/recovery exactly
        # when a single frame matters.
        pend = getattr(self, "_decision_pending", None)
        # Pipeline aggressiveness is gated on tracking margin: deferral and
        # asynchronous mapping hide the device round-trip / stage latency,
        # but they track against a not-yet-settled map on one-frame-stale
        # decisions — on marginal tracking (fast rotation, sparse texture)
        # that is the difference between recovering and collapsing.  The
        # gate is deliberately conservative (5x the lost threshold; a 2x
        # experiment on the loop-drive bench lost 7 frames and tripled
        # ATE — the sync fallback genuinely carries the marginal regime).
        # Below it the scheduler degrades to the fully synchronous round-3
        # semantics (settled map every frame).
        healthy = (
            not getattr(self, "force_sync_decisions", False)
            and self.n_keyframes > 5
            and getattr(self, "last_stats", None) is not None
            and int(self.last_stats[0]) >= 5 * MIN_INLIERS_MAP
            and not self.lost
        )
        self._pipeline_healthy = healthy
        if healthy:
            # the stats fetch rides the worker thread; next frame's
            # deferred decision reads a finished numpy array
            self._decision_pending = (
                self._bg_fetch(np.asarray, stats_dev,
                               ready=stats_dev.is_ready), T_before,
                bindings_before, frame_before,
            )
            if pend is not None:
                self._handle_decision(pend[0].result(), pend[1], pend[2],
                                      pend[3])
        else:
            # sync mode: the current frame's scalars supersede any deferred
            # ones (a lost previous frame shows up in the current inliers
            # too — it tracked from the same bad pose)
            self._decision_pending = None
            self._handle_decision(np.asarray(stats_dev), T_before,
                                  bindings_before, None)
        self._service_gba()
        return self.T_cw

    def _handle_decision(self, stats, T_last_good=None, bindings_good=None,
                         frame_good=None):
        """Lost check + keyframe decision from the latest fetched stats.

        In deferred mode the stats describe the PREVIOUS frame and
        ``frame_good`` is that frame: it is the one inserted as a keyframe
        — its quality is exactly what the stats certify (inserting the
        still-unverified current frame once let a 3-inlier frame seed the
        map and blow up local BA).  Sync mode (``frame_good=None``) inserts
        the current frame like the reference's CreateNewKeyFrame."""
        cfg = self.config
        n_inl, tracked = int(stats[0]), int(stats[1])
        n_tracked_close, n_untracked_close = int(stats[2]), int(stats[3])
        self.last_stats = stats  # observability: [n_inl, tracked, close+, close-]
        if self.tracking_only:
            # mbVO dual hypothesis (reference: src/tracking.cpp:1570-1640):
            # with <10 map inliers the motion-model/VO estimate carries the
            # pose (mbVO=true) and relocalization runs every frame; success
            # snaps the tracker back onto the frozen map.
            self._vo_mode = n_inl < 10
            self.lost = False
            if self._vo_mode and self._try_relocalize(self.last_frame):
                self._vo_mode = False
                self.last_reloc_frame = self.frame_idx
                self._relog_pose(self.T_cw)
            return
        # strict acceptance within the post-reloc window (reference:
        # src/tracking.cpp:800-806: >=50 inliers for 1 s after reloc)
        min_inliers = (
            50 if self.frame_idx < self.last_reloc_frame
            + cfg.tracking.max_frames else MIN_INLIERS_MAP
        )
        self.lost = n_inl < min_inliers
        if not self.lost:
            # remember the last trustworthy inter-frame motion — the prior
            # that carries the pose through outages below (orthonormalized:
            # it gets composed repeatedly while dead-reckoning)
            self._motion_prior = lie.orthonormalize_T(self.velocity)
        if self.lost:
            # recovery needs the settled map (and may rebuild trust in it)
            self._try_adopt_mapping(force=True)
            # The lost frame's estimate was integrated optimistically; roll
            # it back, then DEAD-RECKON one step on the constant-velocity
            # prior.  (The reference freezes the pose while LOST,
            # src/tracking.cpp:266-276; freezing makes every recovery rung
            # search ~N frames behind the real camera after an N-frame
            # outage — the predicted pose keeps projection-based recovery
            # and map continuation anchored near the truth.)
            prior = getattr(self, "_motion_prior", None)
            if prior is None:
                prior = jnp.eye(4, dtype=jnp.float32)
            if T_last_good is not None:
                self.T_cw = lie.orthonormalize_T(prior @ T_last_good)
            self.velocity = prior
            cur = self.last_frame
            # the reference-keyframe vote must come from the last GENUINELY
            # tracked bindings — the current frame tracked from a bad pose
            # and its bindings are near-empty, which would vote slot 0
            cur_bindings = self.last_bindings
            if bindings_good is not None:
                self.last_bindings = bindings_good
            # fallback ladder (UpdatePoses dispatch, reference:
            # src/tracking.cpp:1538-1640): reference-KF BoW tracking, then
            # full relocalization, then wide projection recovery (a
            # beyond-reference rung: the trained-online vocabulary is far
            # weaker than ORBvoc, so a geometry-first rung backstops BoW)
            if self._track_reference_keyframe(cur):
                pass
            elif self._try_relocalize(cur):
                self.last_reloc_frame = self.frame_idx
            elif self._try_wide_recovery(cur):
                self.last_reloc_frame = self.frame_idx
            elif self._try_global_reloc(cur):
                self.last_reloc_frame = self.frame_idx
            else:
                self.last_bindings = cur_bindings
            self._lost_streak = (
                getattr(self, "_lost_streak", 0) + 1 if self.lost else 0
            )
            # Map continuation (beyond-reference robustness, the idea behind
            # ORB-SLAM3's Atlas): the reference stays LOST forever once
            # relocalization keeps failing on a >5-keyframe map
            # (src/tracking.cpp:305-313 only resets small maps).  After a
            # sustained outage, re-bootstrap a NEW map region from stereo
            # depth at the last good pose; the regions share one MapState
            # and the loop closer can later stitch them.
            if (self._lost_streak >= 8 and not self.tracking_only
                    and self.config.camera_type != "mono"
                    and not self.mapping_busy):
                n_depth = int(jnp.sum(
                    (cur.features.depth > 0) & cur.features.valid
                ))
                # same capacity guard as _need_new_keyframe: this path
                # bypasses the admission check, and on a full top-bucket
                # map the insert's argmin slot allocation would overwrite
                # slot 0, the gauge anchor (advisor r4 finding)
                est_kf = self._occ[0] + getattr(self, "_inserts_since_occ", 0)
                if n_depth >= 100 and est_kf >= self.map.kf_capacity - 1:
                    from .map_state import evict_oldest_if_full

                    for _ in range(3):
                        self.map = evict_oldest_if_full(self.map, min_free=3)
                    est_kf = int(np.asarray(jnp.sum(self.map.kf_valid)))
                    self._occ = (est_kf, self._occ[1])
                    self._inserts_since_occ = 0
                if n_depth >= 100 and est_kf < self.map.kf_capacity - 1:
                    self.last_frame = cur._replace(T_cw=self.T_cw)
                    self.last_bindings = self._dispatch_keyframe(
                        self.last_frame,
                        -jnp.ones((cur.features.capacity,), jnp.int32),
                    )
                    self.lost = False
                    self._lost_streak = 0
            # velocity stays on the dead-reckoning prior (set above) so the
            # next frame's prediction keeps moving with the camera
            if self.last_frame is not None:
                self.last_frame = self.last_frame._replace(T_cw=self.T_cw)
            self._relog_pose(self.T_cw)
            return
        if self._need_new_keyframe(tracked, n_tracked_close,
                                   n_untracked_close):
            if frame_good is not None:
                # deferred: insert the certified previous frame; its new
                # points reach the tracker through the local-map window
                self._dispatch_keyframe(frame_good, bindings_good)
            else:
                self.last_bindings = self._dispatch_keyframe(
                    self.last_frame, self.last_bindings
                )
            # until the stage lands, the decision ratio runs against the
            # live tracked count (refreshed with mature-obs counts at
            # adoption)
            self.ref_kf_tracked = max(tracked, 1)

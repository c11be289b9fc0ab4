"""Loop closing: detection, relative-pose solve, map correction.

Re-designs the LoopClosing thread (reference: src/loopclosing.cpp):

- DetectLoop (reference: :98-224): BoW candidates below the covisible
  min-score, with the 3-consecutive-detection covisibility-consistency check
  (``mnCovisibilityConsistencyTh = 3``) — detection is a jitted database
  query; the small consistency-group bookkeeping stays on the host exactly
  like the reference keeps it across invocations.
- ComputeSim3 (reference: :226-398): BoW feature matches whose both sides
  carry map points give 3D-3D pairs; a *hypothesis-batched* Horn RANSAC
  (reference iterates 5 at a time per candidate; here all hypotheses solve in
  one vmap) yields the relative transform, scale fixed for stereo
  (reference: src/sim3solver.cpp:45-47).
- CorrectLoop (reference: :400-585): pose-graph optimization over the
  essential graph (strong covisibility edges + temporal chain + loop edge,
  loop keyframe fixed) followed by point correction through each point's
  reference keyframe — the array form of the spanning-tree propagation.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import lie
from ..ops.horn import horn_align
from ..ops.matching import search_by_bow
from ..optim.pose_graph import PoseGraphProblem, optimize_pose_graph
from ..utils.config import SystemConfig
from .kfdb import KeyFrameDatabase, detect_candidates, query_scores
from .map_state import MapState, recompute_covisibility

COVIS_CONSISTENCY_TH = 3    # reference: src/loopclosing.cpp:35
MIN_LOOP_INLIERS = 20       # reference: src/loopclosing.cpp:344
MIN_LOOP_TOTAL = 40         # region-projection gate (reference: :391-397)
ESSENTIAL_COVIS_MIN = 100   # strong-edge weight (reference: src/orboptimizer.cpp:962)
N_SIM3_HYPOTHESES = 128
GEO_VOTE_MIN = 40           # exact-NN votes to accept a geometric candidate


@jax.jit
def loop_min_score(m: MapState, db: KeyFrameDatabase, kf_slot):
    """Minimum BoW score of the current KF against its covisible neighbours
    (reference: src/loopclosing.cpp:112-131)."""
    scores = query_scores(db, db.bow[kf_slot])
    neighbor = (m.covis[kf_slot] > 0) & m.kf_valid
    masked = jnp.where(neighbor, scores, jnp.inf)
    ms = jnp.min(masked)
    return jnp.where(jnp.isfinite(ms), ms, 0.0)


@functools.partial(jax.jit, static_argnums=(3,))
def loop_candidates(m: MapState, db: KeyFrameDatabase, kf_slot,
                    n_candidates: int = 8):
    """Database query excluding the current KF + its covisible group."""
    exclude = (m.covis[kf_slot] > 0) | (
        jnp.arange(m.kf_capacity) == kf_slot
    ) | (~m.kf_valid)
    min_s = loop_min_score(m, db, kf_slot)
    return detect_candidates(
        db, db.bow[kf_slot], exclude, min_s, m.covis, n_candidates
    )


class LoopMatch(NamedTuple):
    ok: jnp.ndarray          # [] bool
    T_rel: jnp.ndarray       # [4, 4]: corrected T_cur_cw = T_rel @ T_cand_cw
    s_rel: jnp.ndarray       # [] scale of the relative Sim3 (1 for stereo)
    n_inliers: jnp.ndarray   # [] int32 (GN-refined 3D-3D inliers)
    n_total: jnp.ndarray     # [] int32 loop-region projection matches


def _sim3_gn_refine(x_b, x_a, uv_a, uv_b, w, R0, t0, s0, cam,
                    fix_scale: bool, n_iters: int = 8):
    """Small Gauss-Newton refine of the relative Sim3 on weighted 3D-3D
    pairs via mutual reprojection residuals — the OptimizeSim3 role
    (reference: src/orboptimizer.cpp:1064-1261: single Sim3 vertex with
    bidirectional projection edges).  Parameters: (rho, phi, sigma)."""

    def params_to_sim3(dx):
        R = lie.exp_so3(dx[3:6]) @ R0
        t = t0 + dx[:3]
        s = s0 * jnp.exp(dx[6])
        return R, t, s

    def residuals(dx):
        R, t, s = params_to_sim3(dx)
        x_in_a = s * (x_b @ R.T) + t
        Ri, ti, si = lie.sim3_inverse(R, t, s)
        x_in_b = si * (x_a @ Ri.T) + ti

        def proj(x):
            z = jnp.maximum(x[..., 2], 1e-3)
            return jnp.stack(
                [cam.fx * x[..., 0] / z + cam.cx,
                 cam.fy * x[..., 1] / z + cam.cy], -1
            )

        r = jnp.concatenate(
            [(proj(x_in_a) - uv_a), (proj(x_in_b) - uv_b)], axis=0
        )                                               # [2N, 2]
        return r.reshape(-1)

    ww = jnp.sqrt(jnp.concatenate([w, w]))
    ww2 = jnp.repeat(ww, 2)

    def step(dx, _):
        r = residuals(dx) * ww2
        J = jax.jacfwd(residuals)(dx) * ww2[:, None]
        if fix_scale:
            J = J.at[:, 6].set(0.0)   # remove sigma from the system
        H = J.T @ J + 1e-6 * jnp.eye(7)
        g = J.T @ r
        if fix_scale:
            H = H.at[6, 6].add(1.0)
            g = g.at[6].set(0.0)
        d = jnp.linalg.solve(H, -g)
        d = jnp.where(jnp.all(jnp.isfinite(d)), d, 0.0)
        return dx + d, None

    dx, _ = jax.lax.scan(step, jnp.zeros((7,)), None, length=n_iters)
    return params_to_sim3(dx)


@functools.partial(jax.jit, static_argnums=(5, 6))
def compute_loop_transform(m: MapState, kf_nodes, cur_slot, cand_slot, key,
                           config: SystemConfig,
                           fix_scale: bool = True) -> LoopMatch:
    """Relative Sim(3) between the current and candidate keyframes.

    Stages mirror LoopClosing::ComputeSim3 (reference:
    src/loopclosing.cpp:226-398):
    1. BoW 3D-3D pairs + batched Horn RANSAC (Sim3Solver, reference:
       src/sim3solver.cpp:154-221; scale solved when ``fix_scale`` is False).
    2. SearchBySim3-style match growth: project each side's map points into
       the other under the estimate, scale-gated Hamming, mutual agreement
       (reference: src/orbmatcher.cpp:1110-1336).
    3. Gauss-Newton Sim3 refine on the grown inliers (OptimizeSim3,
       reference: src/orboptimizer.cpp:1064-1261), >= 20 inliers.
    4. Loop-region projection gate: candidate + covisible group's points
       projected through the corrected pose must yield >= 40 matches
       (SearchByProjection(Scw), reference: src/loopclosing.cpp:352-397).
    """
    cam = config.camera
    P = m.pt_capacity
    F = m.feat_capacity
    K = m.kf_capacity

    # --- stage 1 pairing: exact-NN keyframe-to-keyframe ------------------
    # The reference pairs cur<->cand FEATURES via BoW shared nodes
    # (SearchByBoW(KF,KF), reference: src/loopclosing.cpp:252-262) because
    # descending ORBvoc is all it can afford; here one matrix product
    # affords the exact [F, F] Hamming matrix.  Crucially both 3D sides come from ONE
    # keyframe each: under accumulated odometric drift the two map regions
    # are not globally rigid to each other, but each keyframe's own bound
    # points are locally consistent — the relative Sim3 absorbs the drift
    # (that is its entire purpose).
    from ..ops.hamming import TH_LOW as _TH_LOW
    from ..ops.hamming import hamming_matrix as _ham

    desc_a = m.kf_desc[cur_slot]
    bind_a0 = m.kf_obs_point[cur_slot]
    has3d_a = (
        m.kf_feat_valid[cur_slot] & (bind_a0 >= 0)
        & m.pt_valid[jnp.clip(bind_a0, 0, P - 1)]
    )
    bind_b0 = m.kf_obs_point[cand_slot]
    has3d_b = (
        m.kf_feat_valid[cand_slot] & (bind_b0 >= 0)
        & m.pt_valid[jnp.clip(bind_b0, 0, P - 1)]
    )
    d_ab = _ham(desc_a, m.kf_desc[cand_slot])               # [F, F]
    d_ab = jnp.where(has3d_a[:, None] & has3d_b[None, :], d_ab, 999)
    fb = jnp.argmin(d_ab, axis=1)
    bd = jnp.take_along_axis(d_ab, fb[:, None], 1)[:, 0]
    back = jnp.argmin(d_ab, axis=0)
    pair_ok = (
        has3d_a & (bd <= _TH_LOW)
        & (jnp.take(back, fb) == jnp.arange(F))             # mutual best
    )
    x_a = lie.transform_points(
        m.kf_T_cw[cur_slot][None],
        m.pt_pos[jnp.clip(bind_a0, 0, P - 1)][None],
    )[0]
    matched_pt_b = jnp.clip(bind_b0[fb], 0, P - 1)
    x_b = lie.transform_points(
        m.kf_T_cw[cand_slot][None], m.pt_pos[matched_pt_b][None]
    )[0]
    uv_b = m.kf_xy[cand_slot][fb]

    # --- stage 1: RANSAC over 3-point sets --------------------------------
    B = N_SIM3_HYPOTHESES
    logits = jnp.log(pair_ok.astype(jnp.float32) + 1e-9)
    sets = jax.random.categorical(key, logits, shape=(B, 3))
    sets_ok = jnp.all(jnp.take(pair_ok, sets), axis=1)

    R_h, t_h, s_h = jax.vmap(
        lambda s: horn_align(x_b[s], x_a[s], fix_scale=fix_scale)
    )(sets)

    # inlier check: mutual reprojection (reference: src/sim3solver.cpp:354-394)
    x_b_in_a = s_h[:, None, None] * jnp.einsum(
        "bij,nj->bni", R_h, x_b
    ) + t_h[:, None, :]
    Rt = jnp.swapaxes(R_h, 1, 2)
    x_a_in_b = jnp.einsum(
        "bij,bnj->bni", Rt, x_a[None] - t_h[:, None, :]
    ) / s_h[:, None, None]

    def reproj_err(x_cam, uv_ref):
        z = jnp.maximum(x_cam[..., 2], 1e-3)
        u = cam.fx * x_cam[..., 0] / z + cam.cx
        v = cam.fy * x_cam[..., 1] / z + cam.cy
        return (u - uv_ref[..., 0]) ** 2 + (v - uv_ref[..., 1]) ** 2

    uv_a = m.kf_xy[cur_slot]
    err_a = reproj_err(x_b_in_a, uv_a[None])
    err_b = reproj_err(x_a_in_b, uv_b[None])
    inl = (
        (err_a <= 9.21) & (err_b <= 9.21)
        & pair_ok[None, :] & sets_ok[:, None]
    )
    counts = jnp.sum(inl, axis=1)
    best = jnp.argmax(counts)
    best_inl = inl[best]

    # Horn re-fit on the winning inlier set
    w = best_inl.astype(jnp.float32)
    R1, t1, s1 = horn_align(x_b, x_a, w, fix_scale=fix_scale)

    # --- stage 2: SearchBySim3 match growth -------------------------------
    # project candidate KF's bound points into the current KF under the
    # estimate and vice versa; accept mutual best Hamming matches inside a
    # scale-gated radius (reference: src/orbmatcher.cpp:1110-1336)
    from ..ops.hamming import MAX_DIST, TH_HIGH, hamming_matrix

    bind_a = m.kf_obs_point[cur_slot]
    bind_b_raw = m.kf_obs_point[cand_slot]
    has_a = (bind_a >= 0) & m.pt_valid[jnp.clip(bind_a, 0, P - 1)] \
        & m.kf_feat_valid[cur_slot]
    has_b = (bind_b_raw >= 0) & m.pt_valid[jnp.clip(bind_b_raw, 0, P - 1)] \
        & m.kf_feat_valid[cand_slot]
    xb_all = lie.transform_points(
        m.kf_T_cw[cand_slot][None],
        m.pt_pos[jnp.clip(bind_b_raw, 0, P - 1)][None],
    )[0]
    xa_all = lie.transform_points(
        m.kf_T_cw[cur_slot][None],
        m.pt_pos[jnp.clip(bind_a, 0, P - 1)][None],
    )[0]
    xb_in_a = s1 * (xb_all @ R1.T) + t1
    Ri1, ti1, si1 = lie.sim3_inverse(R1, t1, s1)
    xa_in_b = si1 * (xa_all @ Ri1.T) + ti1

    def proj_uv(x):
        z = jnp.maximum(x[..., 2], 1e-3)
        return jnp.stack(
            [cam.fx * x[..., 0] / z + cam.cx,
             cam.fy * x[..., 1] / z + cam.cy], -1
        ), x[..., 2] > 0.1

    uvb_in_a, zb_ok = proj_uv(xb_in_a)        # [F, 2] cand pts in cur image
    uva_in_b, za_ok = proj_uv(xa_in_b)
    scale_a = jnp.power(
        jnp.float32(config.orb.scale_factor),
        m.kf_octave[cur_slot].astype(jnp.float32),
    )
    scale_b = jnp.power(
        jnp.float32(config.orb.scale_factor),
        m.kf_octave[cand_slot].astype(jnp.float32),
    )
    # radius 7.5 px * octave scale of the TARGET feature (reference th=7.5)
    d2_a = jnp.sum(
        (m.kf_xy[cur_slot][:, None, :] - uvb_in_a[None, :, :]) ** 2, -1
    )                                           # [Fa, Fb]
    d2_b = jnp.sum(
        (m.kf_xy[cand_slot][:, None, :] - uva_in_b[None, :, :]) ** 2, -1
    )                                           # [Fb, Fa]
    win_a = d2_a <= (7.5 * scale_a[:, None]) ** 2
    win_b = d2_b <= (7.5 * scale_b[:, None]) ** 2
    ham = hamming_matrix(m.kf_desc[cur_slot], m.kf_desc[cand_slot])  # [Fa, Fb]
    big = MAX_DIST + 1
    gate_ab = (
        win_a & win_b.T & (ham <= TH_HIGH)
        & m.kf_feat_valid[cur_slot][:, None] & has_b[None, :]
        & zb_ok[None, :] & za_ok[:, None] & has_a[:, None]
    )
    dg = jnp.where(gate_ab, ham, big)
    best_b_for_a = jnp.argmin(dg, axis=1)
    best_a_for_b = jnp.argmin(dg, axis=0)
    mutual = (
        jnp.take(best_a_for_b, best_b_for_a) == jnp.arange(F)
    ) & (jnp.take_along_axis(dg, best_b_for_a[:, None], 1)[:, 0] <= TH_HIGH)

    # grown 3D-3D pairs: cur point i <-> cand point best_b_for_a[i]
    grown_b = jnp.clip(m.kf_obs_point[cand_slot][best_b_for_a], 0, P - 1)
    xg_b = lie.transform_points(
        m.kf_T_cw[cand_slot][None], m.pt_pos[grown_b][None]
    )[0]
    uvg_b = m.kf_xy[cand_slot][best_b_for_a]
    pair2 = mutual | best_inl               # union with RANSAC inliers
    x_b2 = jnp.where(best_inl[:, None], x_b, xg_b)
    uv_b2 = jnp.where(best_inl[:, None], uv_b, uvg_b)

    # --- stage 3: GN Sim3 refine + inlier recount -------------------------
    w2 = pair2.astype(jnp.float32)
    R2, t2, s2 = _sim3_gn_refine(
        x_b2, x_a, uv_a, uv_b2, w2, R1, t1, s1, cam, fix_scale
    )
    x2 = s2 * (x_b2 @ R2.T) + t2
    e2a = reproj_err(x2, uv_a)
    Ri2, ti2, si2 = lie.sim3_inverse(R2, t2, s2)
    x2b = si2 * (xa_all @ Ri2.T) + ti2
    e2b = reproj_err(x2b, uv_b2)
    inl2 = pair2 & (e2a <= 9.21) & (e2b <= 9.21)
    n_inl = jnp.sum(inl2)

    # --- stage 4: loop-region projection gate -----------------------------
    # points observed by the candidate or its covisible group, projected
    # into the current frame through the corrected pose (reference
    # :352-397: nTotalMatches >= 40)
    group = (m.covis[cand_slot] > 0) | (
        jnp.arange(m.kf_capacity) == cand_slot
    )
    obs_masked = jnp.where(
        (group[:, None] & (m.kf_obs_point >= 0)),
        jnp.clip(m.kf_obs_point, 0, P - 1), P - 1,
    )
    region = jnp.zeros((P,), bool).at[obs_masked.reshape(-1)].set(True)
    region = region | jnp.take(
        group, jnp.clip(m.pt_ref_kf, 0, m.kf_capacity - 1)
    )
    region = region.at[P - 1].set(False) & m.pt_valid
    # corrected current camera: S_cur = S_rel ∘ S_cand
    x_cand = lie.transform_points(m.kf_T_cw[cand_slot][None], m.pt_pos[None])[0]
    x_cur = s2 * (x_cand @ R2.T) + t2
    uv_r, z_ok_r = proj_uv(x_cur)
    in_img = (
        (uv_r[:, 0] >= 0) & (uv_r[:, 0] < cam.width)
        & (uv_r[:, 1] >= 0) & (uv_r[:, 1] < cam.height)
    )
    cand_pts = region & z_ok_r & in_img
    d2_r = jnp.sum(
        (m.kf_xy[cur_slot][:, None, :] - uv_r[None, :, :]) ** 2, -1
    )                                            # [F, P] feature x point
    ham_r = hamming_matrix(m.kf_desc[cur_slot], m.pt_desc)
    gate_r = (
        (d2_r <= (10.0 * scale_a[:, None]) ** 2) & (ham_r <= TH_HIGH)
        & m.kf_feat_valid[cur_slot][:, None] & cand_pts[None, :]
    )
    matched_feat = jnp.any(gate_r, axis=1)
    n_total = jnp.sum(matched_feat)

    T_ab = lie.make_T(R2, t2)            # SE3 part: maps cand-cam -> cur-cam
    ok = (n_inl >= MIN_LOOP_INLIERS) & (n_total >= MIN_LOOP_TOTAL)
    return LoopMatch(ok=ok, T_rel=T_ab, s_rel=s2, n_inliers=n_inl,
                     n_total=n_total)


@functools.partial(jax.jit, static_argnums=(3,))
def _geometric_loop_query(m: MapState, kf_slot, key, config: SystemConfig):
    """Vocabulary-free loop CANDIDATE query: exact-NN Hamming
    match of the keyframe's descriptors against every OLD keyframe's
    descriptors (one bit-dot matrix product) and a vote for the keyframe owning the
    most nearest neighbours.  This is candidate NOMINATION by appearance
    votes only — geometric verification is deliberately left to the Sim3
    pipeline every candidate must pass (Horn RANSAC >=20 inliers, GN
    refine, >=40 region-projection matches, compute_loop_transform).

    The reference can only afford an approximate BoW inverted file for this
    (src/orbkeyframedatabase.cpp:70-198); with the brute matcher the weak
    online-trained vocabulary stops being a single point of failure for
    loop closure.  Returns (n_votes, owner_slot).
    """
    from .relocalization import _brute_match_points

    K, F, P = m.kf_capacity, m.feat_capacity, m.pt_capacity
    # candidate keyframes must be OLD — created well before the current one
    # (the temporal analogue of DetectLoop excluding the covisible group,
    # reference: src/loopclosing.cpp:140-150)
    cur_id = m.kf_id[kf_slot]
    old_kf = m.kf_valid & (m.kf_id <= cur_id - 20)

    # exact-NN vote over the STACKED keyframe descriptors: each current
    # feature names its globally nearest old-keyframe feature; the keyframe
    # collecting most votes is the loop candidate (the inverted-file query
    # of the reference, src/orbkeyframedatabase.cpp:70-198, with a matrix product
    # replacing the approximate word index by exact Hamming NN)
    flat_desc = m.kf_desc.reshape(K * F, 8)
    flat_ok = (m.kf_feat_valid & old_kf[:, None]).reshape(K * F)
    best_flat, ok = _brute_match_points(
        m.kf_desc[kf_slot], m.kf_feat_valid[kf_slot], flat_desc, flat_ok
    )
    owner_of = best_flat // F
    votes = jnp.zeros((K,), jnp.int32).at[
        jnp.where(ok, owner_of, K - 1)
    ].add(ok.astype(jnp.int32))
    votes = jnp.where(old_kf & (jnp.arange(K) != kf_slot), votes, 0)
    owner = jnp.argmax(votes)
    n_votes = votes[owner]
    return n_votes, owner


class EssentialEdges(NamedTuple):
    e_i: jnp.ndarray
    e_j: jnp.ndarray
    e_T: jnp.ndarray
    e_s: jnp.ndarray
    e_w: jnp.ndarray
    e_valid: jnp.ndarray


@jax.jit
def build_essential_edges(m: MapState, cur_slot, cand_slot, T_loop, s_loop):
    """Strong covisibility edges + temporal chain + the NEW loop edge + all
    PERSISTENT loop edges from earlier closures (reference:
    src/orboptimizer.cpp:875-1000 — the reference inserts every keyframe's
    stored loop edges into each essential-graph solve,
    src/orbkeyframe.cpp:458-470)."""
    K = m.kf_capacity
    L = m.loop_valid.shape[0]
    ids = jnp.where(m.kf_valid, m.kf_id, jnp.iinfo(jnp.int32).max)

    # temporal chain: each KF connects to the KF with the next-lower id
    order = jnp.argsort(ids)                         # valid KFs first by id
    nxt = jnp.roll(order, -1)
    chain_ok = (
        jnp.take(m.kf_valid, order) & jnp.take(m.kf_valid, nxt)
        & (jnp.arange(K) < jnp.sum(m.kf_valid) - 1)
    )

    # strong covisibility edges (upper triangle)
    covis_mask = (
        (m.covis >= ESSENTIAL_COVIS_MIN)
        & (jnp.arange(K)[:, None] < jnp.arange(K)[None, :])
    )
    ci, cj = jnp.nonzero(covis_mask, size=4 * K, fill_value=0)
    c_ok = covis_mask[ci, cj]

    # persistent loop edges (both endpoints must still be valid)
    lp_ok = m.loop_valid & jnp.take(m.kf_valid, m.loop_i) \
        & jnp.take(m.kf_valid, m.loop_j)

    e_i = jnp.concatenate([order, ci, m.loop_i, cur_slot[None]])
    e_j = jnp.concatenate([nxt, cj, m.loop_j, cand_slot[None]])
    e_valid = jnp.concatenate([chain_ok, c_ok, lp_ok, jnp.array([True])])
    T_i = m.kf_T_cw[e_i]
    T_j = m.kf_T_cw[e_j]
    e_T = jnp.einsum("eij,ejk->eik", T_i, jax.vmap(lie.inv_T)(T_j))
    e_s = jnp.ones((e_i.shape[0],))
    # measured relative similarities for the loop edges: S_ij = S_rel
    e_T = jax.lax.dynamic_update_slice(e_T, m.loop_T, (K + 4 * K, 0, 0))
    e_s = jax.lax.dynamic_update_slice(e_s, m.loop_s, (K + 4 * K,))
    e_T = e_T.at[-1].set(T_loop)
    e_s = e_s.at[-1].set(s_loop)
    e_w = jnp.concatenate([
        jnp.ones((K,)), jnp.ones((4 * K,)), jnp.full((L,), 5.0),
        jnp.array([5.0]),
    ])
    return EssentialEdges(e_i=e_i, e_j=e_j, e_T=e_T, e_s=e_s, e_w=e_w,
                          e_valid=e_valid)


@functools.partial(jax.jit, static_argnums=(5, 6))
def correct_loop(m: MapState, cur_slot, cand_slot, T_loop, s_loop,
                 n_iters: int = 15, fix_scale: bool = True) -> MapState:
    """Essential-graph Sim(3) optimization + point correction via reference
    KFs (reference: src/loopclosing.cpp:400-585 + RunGlobalBundleAdjustment's
    spanning-tree propagation :645-750).  With ``fix_scale=False`` (mono)
    the per-vertex scales absorb scale drift and points are corrected by the
    full similarity."""
    K, P = m.kf_capacity, m.pt_capacity
    T_old = m.kf_T_cw
    edges = build_essential_edges(m, cur_slot, cand_slot, T_loop, s_loop)
    fixed = jnp.zeros((K,), bool).at[cand_slot].set(True)
    prob = PoseGraphProblem(
        T=T_old,
        v_valid=m.kf_valid,
        v_fixed=fixed,
        e_i=edges.e_i, e_j=edges.e_j, e_T_ij=edges.e_T,
        e_weight=edges.e_w, e_valid=edges.e_valid,
        e_s_ij=edges.e_s,
    )
    T_new, s_new = optimize_pose_graph(prob, n_iters=n_iters,
                                       fix_scale=fix_scale)
    T_new = jnp.where(m.kf_valid[:, None, None], T_new, T_old)
    s_new = jnp.where(m.kf_valid, s_new, 1.0)
    # divergence-revert guard (same policy as the local BA): a solve that
    # emits non-finite poses or teleports vertices far outside the map's
    # extent is discarded wholesale — a partially-applied essential graph
    # is worse than an uncorrected one
    extent = jnp.max(jnp.abs(jnp.where(
        m.kf_valid[:, None], T_old[:, :3, 3], 0.0
    )))
    sane = jnp.all(jnp.isfinite(T_new)) & jnp.all(jnp.isfinite(s_new)) & (
        jnp.max(jnp.abs(T_new[:, :3, 3])) < 100.0 * (extent + 1.0)
    )
    T_new = jnp.where(sane, T_new, T_old)
    s_new = jnp.where(sane, s_new, 1.0)

    # correct points through their reference keyframe with the full
    # similarity: p' = S_wc_new[ref] ∘ S_cw_old[ref] (reference CorrectLoop
    # point update, src/loopclosing.cpp:467-500)
    ref = jnp.clip(m.pt_ref_kf, 0, K - 1)
    R_new = T_new[:, :3, :3]
    t_sim = T_new[:, :3, 3] * s_new[:, None]    # Sim3 translation
    Rw, tw, sw = lie.sim3_inverse(R_new, t_sim, s_new)   # [K,...] S_wc_new
    R_old = T_old[:, :3, :3]
    t_old = T_old[:, :3, 3]
    # S_corr = S_wc_new ∘ S_cw_old (old scale = 1)
    Rc, tc, sc = lie.sim3_compose(
        Rw, tw, sw, R_old, t_old, jnp.ones((K,))
    )
    pc = sc[ref, None] * jnp.einsum(
        "pij,pj->pi", Rc[ref], m.pt_pos
    ) + tc[ref]
    pt_pos = jnp.where(m.pt_valid[:, None], pc, m.pt_pos)

    m = m._replace(kf_T_cw=T_new, pt_pos=pt_pos)
    return m._replace(covis=recompute_covisibility(m))


@functools.partial(jax.jit, static_argnums=(7, 8))
def verify_and_apply(m: MapState, kf_nodes, cur_slot, cand_slot,
                     expect_cur_id, expect_cand_id, key,
                     config: SystemConfig, fix_scale: bool = True):
    """ONE device program: Sim3 verification (Horn RANSAC -> SearchBySim3
    growth -> GN refine -> region gate) + masked loop application.

    The correction applies ONLY when verification succeeds AND both slots
    still hold the keyframes the detection named (slot recycling check done
    ON DEVICE — the host never has to block on a revalidation fetch).
    Returns (map', valid, T_kf_pre, T_kf_post); with ``valid`` False the
    map is returned unchanged, so the caller can adopt the output
    optimistically and fetch ``valid`` lazily — the staged analogue of the
    reference running ComputeSim3+CorrectLoop on the LoopClosing thread
    (src/loopclosing.cpp:228-266, 400-585) off the tracking path."""
    lm = compute_loop_transform(
        m, kf_nodes, cur_slot, cand_slot, key, config, fix_scale
    )
    valid = (
        lm.ok
        & m.kf_valid[cur_slot] & (m.kf_id[cur_slot] == expect_cur_id)
        & m.kf_valid[cand_slot] & (m.kf_id[cand_slot] == expect_cand_id)
    )
    T_pre = m.kf_T_cw[cur_slot]

    def do_apply(mm):
        from .map_state import add_loop_edge

        mm = correct_loop(mm, cur_slot, cand_slot, lm.T_rel, lm.s_rel,
                          fix_scale=fix_scale)
        return add_loop_edge(
            mm, jnp.asarray(cur_slot, jnp.int32),
            jnp.asarray(cand_slot, jnp.int32), lm.T_rel, lm.s_rel,
        )

    m2 = jax.lax.cond(valid, do_apply, lambda mm: mm, m)
    return m2, valid, T_pre, m2.kf_T_cw[cur_slot]


class LoopCloser:
    """Host-side detection state machine (consistency groups across
    consecutive keyframes, reference: src/loopclosing.cpp:150-211)."""

    def __init__(self, config: SystemConfig):
        self.config = config
        # stereo/RGB-D fixes the Sim3 scale; monocular solves it, the whole
        # point of Sim3 loop closure (reference: src/sim3solver.cpp:45-47,
        # src/orboptimizer.cpp:830 _fix_scale)
        self.fix_scale = config.camera_type != "mono"
        self.prev_groups: list[set[int]] = []
        self.prev_counts: list[int] = []
        self.last_loop_kf_id = -10**9
        self.key = jax.random.PRNGKey(7)
        # when True the caller schedules the post-loop GBA incrementally
        # (models/global_ba.IncrementalGBA) instead of blocking here — the
        # reference's detached GBA thread semantics (P2)
        self.defer_gba = False

    def dispatch(self, m: MapState, db: KeyFrameDatabase, kf_nodes,
                 kf_slot: int, kf_id: int):
        """Launch the detection queries for a new keyframe WITHOUT reading
        anything back.  Returns an opaque pending dict (or None when
        detection is skipped); pass it to :meth:`harvest` once
        ``pending["ready"]()`` — the staged-pipeline analogue of the
        reference's LoopClosing thread consuming its keyframe queue
        asynchronously (reference: src/loopclosing.cpp:49-83): no blocking
        ``jax.device_get`` on the tracking path."""
        # skip if <10 KFs since last loop (reference: src/loopclosing.cpp:104)
        if kf_id - self.last_loop_kf_id < 10:
            return None
        cands_d, scores = loop_candidates(m, db, kf_slot)
        safe_c = jnp.clip(cands_d, 0, m.kf_capacity - 1)
        # the geometric query is DISPATCHED here so its result rides the
        # same host fetch as the BoW candidates — one device round-trip per
        # registration
        self._geo_tick = getattr(self, "_geo_tick", 0) + 1
        run_geo = (getattr(self, "geometric_detection", True)
                   and self._geo_tick % 3 == 0)
        if run_geo:
            self.key, sub = jax.random.split(self.key)
            geo_d = _geometric_loop_query(m, kf_slot, sub, self.config)
        else:
            geo_d = (jnp.int32(0), jnp.int32(0))
        handles = (
            cands_d, jnp.sum(m.kf_valid), m.kf_id,
            m.covis[safe_c] > 0,                      # [n_cand, K] bool
            geo_d,
        )
        # fetch on a daemon thread: the blocking device_get happens off
        # the tracking path entirely; harvest reads the finished tuple
        from ..utils.host import bg_fetch

        fut = bg_fetch(jax.device_get, handles, ready=cands_d.is_ready)
        return {
            "future": fut, "kf_slot": kf_slot, "kf_id": kf_id,
            "run_geo": run_geo,
            "ready": fut.done,
        }

    def on_keyframe(self, m: MapState, db: KeyFrameDatabase, kf_nodes,
                    kf_slot: int, kf_id: int | None = None):
        """Synchronous detect + close (dispatch + forced harvest) — the
        bootstrap/tests/mono path.  Returns
        (map, loop_closed: bool, T_corrected_cur or None)."""
        if kf_id is None:
            kf_id = int(m.kf_id[kf_slot])
        pending = self.dispatch(m, db, kf_nodes, kf_slot, kf_id)
        if pending is None:
            return m, False, None
        return self.harvest(pending, m, kf_nodes)

    def harvest_detect(self, pending):
        """Consume a finished detection fetch: the host-side consistency
        logic over the fetched numpy data ONLY — no device reads at all.
        Returns None or an accepted-candidate tuple
        ``(kf_slot, kf_id, cand_slot, cand_id)`` for the verification
        stage (:func:`verify_and_apply`)."""
        kf_slot = pending["kf_slot"]
        kf_id = pending["kf_id"]
        run_geo = pending["run_geo"]
        cands_np, n_valid, kf_ids, covis_rows, geo = pending["future"].result()
        if int(n_valid) < 10:
            return None
        cand_rows = {
            int(c): covis_rows[i] for i, c in enumerate(cands_np) if c >= 0
        }
        cands = list(cand_rows.keys())

        accepted = None
        if cands:
            new_groups, new_counts = [], []
            for c in cands:
                # groups are keyed by STABLE keyframe ids, not slots:
                # culling / capacity eviction between keyframes recycles
                # slot indices, which would silently re-index a group
                group = {int(kf_ids[c])} | {
                    int(kf_ids[j]) for j in np.nonzero(cand_rows[c])[0]
                }
                count = 0
                for g_prev, c_prev in zip(self.prev_groups, self.prev_counts):
                    if group & g_prev:
                        count = max(count, c_prev + 1)
                new_groups.append(group)
                new_counts.append(count)
                if count >= COVIS_CONSISTENCY_TH - 1 and accepted is None:
                    accepted = c
            self.prev_groups, self.prev_counts = new_groups, new_counts
        else:
            self.prev_groups, self.prev_counts = [], []

        if run_geo and int(n_valid) >= 20:
            # geometric channel (fetched above): exact-NN keyframe voting.
            # It runs alongside BoW and takes precedence when strong: on
            # self-similar scenes the BoW 3-consecutive consistency gate
            # can pass for consistently WRONG candidates, and after
            # capacity eviction the true region may exist only as
            # re-anchored points no BoW row can name.  Vote counting alone
            # is NOT geometric verification — that happens below, where
            # every candidate (BoW or geometric) must survive the Horn
            # RANSAC >=20-inlier and >=40-region-projection gates of the
            # Sim3 pipeline (compute_loop_transform).
            if int(geo[0]) >= GEO_VOTE_MIN:
                accepted = int(geo[1])
        if accepted is None:
            return None
        return kf_slot, kf_id, accepted, int(kf_ids[accepted])

    def harvest(self, pending, m: MapState, kf_nodes):
        """Synchronous detect + verify + apply — the bootstrap/tests/mono
        path (the staged pipeline calls :meth:`harvest_detect` and runs
        :func:`verify_and_apply` asynchronously instead).  Slot recycling
        is revalidated ON DEVICE inside the masked apply.  Returns
        (map, loop_closed, T_corrected_cur or None)."""
        det = self.harvest_detect(pending)
        if det is None:
            return m, False, None
        kf_slot, kf_id, cand_slot, cand_id = det
        self.key, sub = jax.random.split(self.key)
        m2, valid, _, _ = verify_and_apply(
            m, kf_nodes, kf_slot, cand_slot, kf_id, cand_id, sub,
            self.config, self.fix_scale,
        )
        if not bool(valid):
            return m, False, None
        m = m2
        # full-map refinement (RunGlobalBundleAdjustment, reference:
        # src/loopclosing.cpp:645-750: GBA with 10 iterations after a loop);
        # deferred mode hands this to the caller's incremental scheduler
        if not self.defer_gba:
            from .global_ba import run_global_ba

            m = run_global_ba(m, self.config, n_outer=10)
        self.last_loop_kf_id = kf_id
        self.prev_groups, self.prev_counts = [], []
        return m, True, m.kf_T_cw[kf_slot]

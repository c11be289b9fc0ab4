"""Relocalization: BoW candidates -> EPnP RANSAC -> pose optimization.

Re-designs Tracking::Relocalization (reference: src/tracking.cpp:1177-1338):
query the keyframe database, BoW-match each candidate (>=15 matches), run
EPnP RANSAC, then pose-optimize and accept at >=50 inliers.  Candidates are
few and relocalization is rare, so the per-candidate loop stays on the host
while each stage is a jitted batched program.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..optim.pnp import pnp_ransac
from ..optim.pose_opt import PoseObs, pose_optimize
from ..ops import lie
from ..ops.matching import search_by_bow
from ..utils.config import SystemConfig
from .frame import FrameState, features_scale_sigma2
from .kfdb import KeyFrameDatabase, detect_candidates
from .map_state import MapState
from . import vocabulary as voc

MIN_BOW_MATCHES = 15   # reference: src/tracking.cpp:1232
MIN_FINAL_INLIERS = 50  # reference: src/tracking.cpp:1322


class RelocResult(NamedTuple):
    success: bool
    T_cw: Optional[jnp.ndarray]
    bindings: Optional[jnp.ndarray]


def relocalize(m: MapState, db: KeyFrameDatabase, kf_nodes,
               vocab: voc.Vocabulary, frame: FrameState,
               config: SystemConfig, key) -> RelocResult:
    cam = config.camera
    P = m.pt_capacity
    feats = frame.features

    words, nodes = voc.transform(vocab, feats.desc, feats.valid)
    qbow = voc.bow_vector(vocab, words)
    exclude = ~m.kf_valid
    cands, _ = detect_candidates(db, qbow, exclude, 0.0, m.covis)
    cands = [int(c) for c in np.asarray(cands) if int(c) >= 0]

    sigma2 = features_scale_sigma2(feats, config.orb.scale_factor)
    for cand in cands[:5]:
        idx_kf, ok = search_by_bow(
            feats.desc, nodes, feats.valid, feats.angle,
            m.kf_desc[cand], kf_nodes[cand], m.kf_feat_valid[cand],
            m.kf_angle[cand],
            max_dist=50, nn_ratio=0.75,
        )
        bind = m.kf_obs_point[cand][idx_kf]
        pair_ok = ok & (bind >= 0) & m.pt_valid[jnp.clip(bind, 0, P - 1)]
        if int(jnp.sum(pair_ok)) < MIN_BOW_MATCHES:
            continue

        p_w = m.pt_pos[jnp.clip(bind, 0, P - 1)]
        key, sub = jax.random.split(key)
        res = pnp_ransac(
            p_w, feats.xy, sigma2, pair_ok, sub,
            fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy,
        )
        if int(res.n_inliers) < 10:
            continue

        T0 = lie.make_T(res.R, res.t)
        obs = PoseObs(
            p_w=p_w, uv=feats.xy, u_right=feats.u_right,
            sigma2=sigma2, valid=pair_ok,
        )
        T_est, inliers, n_inl = pose_optimize(
            T0, obs, fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, bf=cam.bf
        )
        if int(n_inl) >= MIN_FINAL_INLIERS:
            bindings = jnp.where(pair_ok & inliers, bind, -1)
            return RelocResult(True, T_est, bindings)
    return RelocResult(False, None, None)


@jax.jit
def _brute_match_points(feat_desc, feat_valid, pt_desc, pt_valid):
    """Exact nearest-neighbour Hamming match of frame features against ALL
    map point descriptors, chunked over the point axis so the [F, P]
    distance matrix never materializes.  Returns (best_pt [F], ok [F])."""
    from ..ops.hamming import MAX_DIST, TH_LOW, hamming_matrix

    F = feat_desc.shape[0]
    P = pt_desc.shape[0]
    # chunking must cover EVERY point for ANY capacity: chunk=min(8192, P)
    # and ceil-div, with the tail padded invalid (a fixed 8192/floor-div pair
    # raised a trace error for P < 8192 and silently skipped the tail
    # P % 8192 points otherwise — advisor r4 finding)
    chunk = min(8192, P)
    n_chunks = -(-P // chunk)
    pad = n_chunks * chunk - P
    if pad:
        pt_desc = jnp.pad(pt_desc, ((0, pad), (0, 0)))
        pt_valid = jnp.pad(pt_valid, (0, pad))
    big = jnp.int32(MAX_DIST + 1)

    def body(carry, i):
        best_d, best_i, second_d = carry
        sl = jax.lax.dynamic_slice_in_dim(pt_desc, i * chunk, chunk, 0)
        vl = jax.lax.dynamic_slice_in_dim(
            pt_valid.astype(jnp.int32), i * chunk, chunk, 0
        ).astype(bool)
        d = hamming_matrix(feat_desc, sl)                     # [F, chunk]
        d = jnp.where(vl[None, :], d, big)
        c_best = jnp.argmin(d, axis=1)
        c_bd = jnp.take_along_axis(d, c_best[:, None], 1)[:, 0]
        d2 = d.at[jnp.arange(F), c_best].set(big)
        c_sd = jnp.min(d2, axis=1)
        # merge running best-2 with chunk best-2: the overall second-best
        # of {a, b>=a, c, d>=c} is min(max(a, c), b, d)
        new_second = jnp.minimum(
            jnp.maximum(best_d, c_bd), jnp.minimum(second_d, c_sd)
        )
        take = c_bd < best_d
        new_best = jnp.where(take, c_bd, best_d)
        new_idx = jnp.where(take, c_best + i * chunk, best_i)
        return (new_best, new_idx, new_second), None

    init = (jnp.full((F,), big), jnp.zeros((F,), jnp.int32),
            jnp.full((F,), big))
    (best_d, best_i, second_d), _ = jax.lax.scan(
        body, init, jnp.arange(n_chunks)
    )
    # NO best/second ratio test here: the map legitimately holds
    # near-duplicate points (octave twins; revisit twins after capacity
    # churn) whose descriptors tie for best — a ratio gate would reject
    # exactly the true matches.  Precision comes from the geometric
    # consensus (EPnP RANSAC / Horn Sim3) every caller runs next.
    ok = feat_valid & (best_d <= TH_LOW)
    return best_i, ok


def relocalize_brute(m: MapState, frame: FrameState, config: SystemConfig,
                     key) -> RelocResult:
    """Vocabulary-free global relocalization — a capability the reference
    cannot afford: instead of the approximate BoW inverted file
    (reference: src/orbkeyframedatabase.cpp:200-314), match the frame's
    descriptors against EVERY map point by exact Hamming nearest neighbour
    as one matrix product (a [F,256]x[256,P] bit-dot), then EPnP RANSAC + pose optimization with the reference's
    >=50-inlier acceptance (src/tracking.cpp:1322).  Used when the
    BoW-indexed path fails (the online-trained vocabulary is far weaker
    than the reference's offline ORBvoc)."""
    cam = config.camera
    feats = frame.features
    best_pt, ok = _brute_match_points(
        feats.desc, feats.valid, m.pt_desc, m.pt_valid
    )
    if int(jnp.sum(ok)) < MIN_BOW_MATCHES:
        return RelocResult(False, None, None)
    p_w = m.pt_pos[best_pt]
    sigma2 = features_scale_sigma2(feats, config.orb.scale_factor)
    res = pnp_ransac(
        p_w, feats.xy, sigma2, ok, key,
        fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy,
    )
    if int(res.n_inliers) < 10:
        return RelocResult(False, None, None)
    T0 = lie.make_T(res.R, res.t)
    obs = PoseObs(
        p_w=p_w, uv=feats.xy, u_right=feats.u_right,
        sigma2=sigma2, valid=ok,
    )
    T_est, inliers, n_inl = pose_optimize(
        T0, obs, fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, bf=cam.bf
    )
    if int(n_inl) >= MIN_FINAL_INLIERS:
        return RelocResult(True, T_est, jnp.where(ok & inliers, best_pt, -1))
    return RelocResult(False, None, None)

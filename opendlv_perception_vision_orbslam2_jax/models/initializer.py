"""Monocular two-view initialization: batched H/F RANSAC + reconstruction.

Re-designs OrbInitializer (reference: src/orbinitializer.cpp): the reference
spawns two threads computing homography and fundamental models over 200
8-point RANSAC sets (reference: :80-111), picks the model by the score ratio
RH > 0.40 (reference: :114-120), and reconstructs R,t via the Faugeras
decomposition (H, 8 motions) or DecomposeE (F, 4 motions) with
cheirality/parallax checks (reference: :468-930).

Batched form: *all* hypotheses for *both* models evaluate in one program —
vmapped normalized DLT solves (SVD of [B, 16/8, 9]), dense symmetric-transfer
and epipolar scores, then the candidate motions' cheirality checks batch over
motions x points.  The two reference threads become one fused kernel (P4 in
SURVEY.md's parallelism inventory).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops import lie

N_RANSAC = 200          # reference: :84
SET_SIZE = 8
SIGMA = 1.0
TH_H = 5.991            # chi2 for H score (reference: CheckHomography :303)
TH_F = 3.841            # chi2 for F point-line (reference: CheckFundamental :388)
SCORE_GAMMA = 5.991     # score offset (reference uses th/thScore)


def _normalize(pts, valid):
    """Zero-mean unit-average-abs-deviation normalization (reference:
    Normalize :747-792).  Returns (normalized pts, 3x3 transform)."""
    n = jnp.maximum(jnp.sum(valid), 1)
    mean = jnp.sum(jnp.where(valid[:, None], pts, 0.0), axis=0) / n
    d = jnp.where(valid[:, None], jnp.abs(pts - mean), 0.0)
    dev = jnp.sum(d, axis=0) / n
    s = 1.0 / jnp.maximum(dev, 1e-9)
    pn = (pts - mean) * s
    T = jnp.array([[1.0, 0, 0], [0, 1.0, 0], [0, 0, 1.0]])
    T = T.at[0, 0].set(s[0]).at[1, 1].set(s[1])
    T = T.at[0, 2].set(-mean[0] * s[0]).at[1, 2].set(-mean[1] * s[1])
    return pn, T


def _dlt_homography(p1, p2, w=None):
    """H from point pairs (SVD null vector; reference:
    ComputeHomographyMatrix :225-264).  Optional row weights enable the
    all-inlier least-squares refinement after RANSAC."""
    x1, y1 = p1[:, 0], p1[:, 1]
    x2, y2 = p2[:, 0], p2[:, 1]
    z = jnp.zeros_like(x1)
    o = jnp.ones_like(x1)
    rows_a = jnp.stack([z, z, z, -x1, -y1, -o, y2 * x1, y2 * y1, y2], axis=-1)
    rows_b = jnp.stack([x1, y1, o, z, z, z, -x2 * x1, -x2 * y1, -x2], axis=-1)
    A = jnp.concatenate([rows_a, rows_b], axis=0)
    if w is not None:
        A = A * jnp.concatenate([w, w])[:, None]
    _, _, vt = jnp.linalg.svd(A)
    return vt[-1].reshape(3, 3)


def _eight_point_fundamental(p1, p2, w=None):
    """F from pairs with rank-2 projection (reference:
    ComputeFundamentalMatrix :266-301)."""
    x1, y1 = p1[:, 0], p1[:, 1]
    x2, y2 = p2[:, 0], p2[:, 1]
    o = jnp.ones_like(x1)
    A = jnp.stack(
        [x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, o], axis=-1
    )
    if w is not None:
        A = A * w[:, None]
    _, _, vt = jnp.linalg.svd(A)
    Fpre = vt[-1].reshape(3, 3)
    u, s, vt2 = jnp.linalg.svd(Fpre)
    s = s.at[2].set(0.0)
    return u @ jnp.diag(s) @ vt2


def _score_homography(H, H_inv, p1, p2, valid):
    """Symmetric transfer chi2 score (reference: CheckHomography :303-386)."""
    def transfer(Hm, a, b):
        ah = jnp.concatenate([a, jnp.ones((a.shape[0], 1))], axis=1)
        proj = ah @ Hm.T
        w = jnp.where(jnp.abs(proj[:, 2]) < 1e-9, 1e-9, proj[:, 2])
        uv = proj[:, :2] / w[:, None]
        return jnp.sum((uv - b) ** 2, axis=1) / (SIGMA * SIGMA)

    c21 = transfer(H, p1, p2)
    c12 = transfer(H_inv, p2, p1)
    ok = (c21 <= TH_H) & (c12 <= TH_H) & valid
    score = jnp.sum(
        jnp.where(valid & (c21 <= TH_H), SCORE_GAMMA - c21, 0.0)
        + jnp.where(valid & (c12 <= TH_H), SCORE_GAMMA - c12, 0.0)
    )
    return score, ok


def _score_fundamental(F, p1, p2, valid):
    """Epipolar point-line chi2 score (reference: CheckFundamental :388-466)."""
    def line_dist2(Fm, a, b):
        ah = jnp.concatenate([a, jnp.ones((a.shape[0], 1))], axis=1)
        l = ah @ Fm.T                      # epipolar line in image 2
        num = (l[:, 0] * b[:, 0] + l[:, 1] * b[:, 1] + l[:, 2]) ** 2
        den = l[:, 0] ** 2 + l[:, 1] ** 2
        return num / jnp.maximum(den, 1e-12) / (SIGMA * SIGMA)

    c2 = line_dist2(F, p1, p2)
    c1 = line_dist2(F.T, p2, p1)
    ok = (c2 <= TH_F) & (c1 <= TH_F) & valid
    score = jnp.sum(
        jnp.where(valid & (c2 <= TH_F), SCORE_GAMMA - c2, 0.0)
        + jnp.where(valid & (c1 <= TH_F), SCORE_GAMMA - c1, 0.0)
    )
    return score, ok


def _decompose_E(E):
    """4 candidate motions from an essential matrix (reference:
    DecomposeE :906-930)."""
    u, s, vt = jnp.linalg.svd(E)
    # enforce proper rotations
    W = jnp.array([[0.0, -1, 0], [1, 0, 0], [0, 0, 1]])
    R1 = u @ W @ vt
    R1 = R1 * jnp.sign(jnp.linalg.det(R1))
    R2 = u @ W.T @ vt
    R2 = R2 * jnp.sign(jnp.linalg.det(R2))
    t = u[:, 2]
    t = t / (jnp.linalg.norm(t) + 1e-12)
    return jnp.stack([R1, R1, R2, R2]), jnp.stack([t, -t, t, -t])


def decompose_homography(H, K):
    """Full 8-motion Faugeras decomposition of a pixel-space homography.

    Returns ``(R [8, 3, 3], t [8, 3])`` — the complete solution set of
    ReconstructH (reference: src/orbinitializer.cpp:573-730): 4 sign cases of
    (x1, x3) for each of the two singular-value branches d' = d2 (rotation by
    theta) and d' = -d2 (rotation by phi with a reflection).  t is normalized
    to unit length, matching the reference's ``t/||t||`` convention.
    """
    A = jnp.linalg.inv(K) @ H @ K
    Ua, sa, Vta = jnp.linalg.svd(A)
    d1, d2, d3 = sa[0], sa[1], sa[2]
    s_det = jnp.linalg.det(Ua) * jnp.linalg.det(Vta)
    # x1/x3 terms (reference: :600-607)
    aux1 = jnp.sqrt(jnp.maximum((d1 * d1 - d2 * d2) / jnp.maximum(d1 * d1 - d3 * d3, 1e-12), 0.0))
    aux3 = jnp.sqrt(jnp.maximum((d2 * d2 - d3 * d3) / jnp.maximum(d1 * d1 - d3 * d3, 1e-12), 0.0))
    x1s = jnp.array([1.0, 1.0, -1.0, -1.0]) * aux1
    x3s = jnp.array([1.0, -1.0, 1.0, -1.0]) * aux3
    # branch 1: d' = d2 (rotation about y by theta, reference: :609-650)
    sin_t = jnp.sqrt(jnp.maximum(
        (d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), 0.0)) / jnp.maximum(
        (d1 + d3) * d2, 1e-12)
    cos_t = (d2 * d2 + d1 * d3) / jnp.maximum((d1 + d3) * d2, 1e-12)
    sins = jnp.array([1.0, -1.0, -1.0, 1.0]) * sin_t

    def h_motion(x1, x3, st):
        Rp = jnp.array(
            [[cos_t, 0.0, -st], [0.0, 1.0, 0.0], [st, 0.0, cos_t]]
        )
        R = s_det * Ua @ Rp @ Vta
        tp = jnp.array([x1, 0.0, -x3]) * (d1 - d3)
        t = Ua @ tp
        return R, t / (jnp.linalg.norm(t) + 1e-12)

    # branch 2: d' = -d2 (rotation by phi with a reflection,
    # reference: :652-718)
    sin_p = jnp.sqrt(jnp.maximum(
        (d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), 0.0)) / jnp.maximum(
        (d1 - d3) * d2, 1e-12)
    cos_p = (d1 * d3 - d2 * d2) / jnp.maximum((d1 - d3) * d2, 1e-12)
    sins_p = jnp.array([1.0, -1.0, -1.0, 1.0]) * sin_p

    def h_motion2(x1, x3, sp):
        Rp = jnp.array(
            [[cos_p, 0.0, sp], [0.0, -1.0, 0.0], [sp, 0.0, -cos_p]]
        )
        R = s_det * Ua @ Rp @ Vta
        tp = jnp.array([x1, 0.0, x3]) * (d1 + d3)
        t = Ua @ tp
        return R, t / (jnp.linalg.norm(t) + 1e-12)

    R_h1, t_h1 = jax.vmap(h_motion)(x1s, x3s, sins)
    R_h2, t_h2 = jax.vmap(h_motion2)(x1s, x3s, sins_p)
    return jnp.concatenate([R_h1, R_h2]), jnp.concatenate([t_h1, t_h2])


def _check_motion(R, t, p1, p2, valid, K, th2=4.0 * SIGMA * SIGMA):
    """Triangulate all matches under (R, t); count cheirality+reprojection
    inliers and measure parallax (reference: CheckRT :795-904)."""
    P1 = K @ jnp.concatenate([jnp.eye(3), jnp.zeros((3, 1))], axis=1)
    P2 = K @ jnp.concatenate([R, t[:, None]], axis=1)
    X = lie.triangulate_linear(P1, P2, p1, p2)
    z1 = X[:, 2]
    Xc2 = X @ R.T + t
    z2 = Xc2[:, 2]

    def reproj2(P, X, uv):
        Xh = jnp.concatenate([X, jnp.ones((X.shape[0], 1))], axis=1)
        pr = Xh @ P.T
        w = jnp.where(jnp.abs(pr[:, 2]) < 1e-9, 1e-9, pr[:, 2])
        return jnp.sum((pr[:, :2] / w[:, None] - uv) ** 2, axis=1)

    e1 = reproj2(P1, X, p1)
    e2 = reproj2(P2, X, p2)
    # parallax: angle between rays
    c2 = -R.T @ t
    r1 = X
    r2 = X - c2
    cosp = jnp.sum(r1 * r2, axis=1) / (
        jnp.linalg.norm(r1, axis=1) * jnp.linalg.norm(r2, axis=1) + 1e-12
    )
    # Cheirality is only meaningful where parallax is measurable: the
    # reference rejects z<=0 ONLY when cosParallax < 0.99998 (CheckRT,
    # reference: src/orbinitializer.cpp:848-858) — far low-parallax points
    # still count toward nGood if they reproject well.  Gating them on
    # cheirality too (as a naive port would) starves the correct motion of
    # inliers on far-heavy scenes while wrong motions win on fake parallax.
    low_plx = cosp >= 0.99998
    cheir_ok = ((z1 > 0) | low_plx) & ((z2 > 0) | low_plx)
    passing = valid & cheir_ok & (e1 <= th2) & (e2 <= th2)
    n_good = jnp.sum(passing)
    # only real-parallax points become map points (reference: vbGood is set
    # under cosParallax<0.99998, :895-899)
    point_ok = passing & ~low_plx & (z1 > 0) & (z2 > 0)
    cosp_pass = jnp.where(passing, cosp, 1.0)
    parallax_cos = jnp.sort(cosp_pass)[jnp.minimum(50, n_good - 1).astype(jnp.int32)]
    return n_good, point_ok, X, parallax_cos


class InitResult(NamedTuple):
    success: jnp.ndarray     # [] bool
    T_21: jnp.ndarray        # [4, 4] pose of frame 2 wrt frame 1 (t up to scale)
    points: jnp.ndarray      # [N, 3] triangulated points in frame-1 coords
    point_ok: jnp.ndarray    # [N] bool
    used_homography: jnp.ndarray


@functools.partial(jax.jit, static_argnames=("fx", "fy", "cx", "cy",
                                              "min_triangulated"))
def initialize_two_view(xy1, xy2, valid, key, *, fx: float, fy: float,
                        cx: float, cy: float,
                        min_triangulated: int = 50) -> InitResult:
    """Full monocular bootstrap from matched keypoints of two frames.

    ``min_triangulated`` is the reference's minTriangulated=50 floor
    (ReconstructF/H, reference: src/orbinitializer.cpp:468-571, 700-730),
    exposed because it implicitly assumes the reference's 2000-feature
    budget; callers running smaller budgets scale it down.
    """
    K = jnp.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
    N = xy1.shape[0]

    p1n, T1 = _normalize(xy1, valid)
    p2n, T2 = _normalize(xy2, valid)
    T2_inv = jnp.linalg.inv(T2)

    logits = jnp.log(valid.astype(jnp.float32) + 1e-9)
    sets = jax.random.categorical(key, logits, shape=(N_RANSAC, SET_SIZE))

    def solve_set(ii):
        a, b = p1n[ii], p2n[ii]
        Hn = _dlt_homography(a, b)
        Fn = _eight_point_fundamental(a, b)
        H = T2_inv @ Hn @ T1
        F = T2.T @ Fn @ T1
        return H / jnp.where(jnp.abs(H[2, 2]) < 1e-12, 1e-12, H[2, 2]), F

    Hs, Fs = jax.vmap(solve_set)(sets)
    H_invs = jnp.linalg.inv(Hs + 1e-12 * jnp.eye(3)[None])

    h_scores, _ = jax.vmap(
        lambda H, Hi: _score_homography(H, Hi, xy1, xy2, valid)
    )(Hs, H_invs)
    f_scores, _ = jax.vmap(
        lambda F: _score_fundamental(F, xy1, xy2, valid)
    )(Fs)

    bh = jnp.argmax(h_scores)
    bf = jnp.argmax(f_scores)
    SH, SF = h_scores[bh], f_scores[bf]
    H_best, F_best = Hs[bh], Fs[bf]
    _, h_inliers = _score_homography(
        H_best, jnp.linalg.inv(H_best), xy1, xy2, valid
    )
    _, f_inliers = _score_fundamental(F_best, xy1, xy2, valid)

    # least-squares refinement on all inliers (normalized coords); the
    # minimal-set model is noise-limited otherwise
    H_ref = T2_inv @ _dlt_homography(
        p1n, p2n, h_inliers.astype(p1n.dtype)
    ) @ T1
    H_ref = H_ref / jnp.where(jnp.abs(H_ref[2, 2]) < 1e-12, 1e-12, H_ref[2, 2])
    F_ref = T2.T @ _eight_point_fundamental(
        p1n, p2n, f_inliers.astype(p1n.dtype)
    ) @ T1
    _, h_inl2 = _score_homography(H_ref, jnp.linalg.inv(H_ref), xy1, xy2, valid)
    _, f_inl2 = _score_fundamental(F_ref, xy1, xy2, valid)
    better_h = jnp.sum(h_inl2) >= jnp.sum(h_inliers)
    better_f = jnp.sum(f_inl2) >= jnp.sum(f_inliers)
    H_best = jnp.where(better_h, H_ref, H_best)
    h_inliers = jnp.where(better_h, h_inl2, h_inliers)
    F_best = jnp.where(better_f, F_ref, F_best)
    f_inliers = jnp.where(better_f, f_inl2, f_inliers)
    use_H = SH / jnp.maximum(SH + SF, 1e-9) > 0.40   # reference: :114-120

    # Candidate motions: 4 from E (DecomposeE, reference: :906-930) and the
    # full 8 Faugeras solutions of the calibrated homography (ReconstructH,
    # reference: :573-730 — both the d'=d2 and d'=-d2 branches).  Both model
    # paths are evaluated against their own inlier sets and the winner is
    # selected by the RH rule, each with the reference's own acceptance gate.
    E = K.T @ F_best @ K
    R_f, t_f = _decompose_E(E)
    R_h, t_h = decompose_homography(H_best, K)

    nh, gh, Xh, ph = jax.vmap(
        lambda R, t: _check_motion(R, t, xy1, xy2, h_inliers, K)
    )(R_h, t_h)
    nf, gf, Xf, pf = jax.vmap(
        lambda R, t: _check_motion(R, t, xy1, xy2, f_inliers, K)
    )(R_f, t_f)

    # H acceptance (ReconstructH, reference: :700-730): clear winner
    # (second < 0.75*best), best > 0.9*N, enough points, enough parallax.
    bh_i = jnp.argmax(nh)
    nh_best = nh[bh_i]
    nh_second = jnp.sort(nh)[-2]
    Nh = jnp.sum(h_inliers)
    ok_h = (
        (nh_second < 0.75 * nh_best)
        & (nh_best > 0.9 * Nh)
        & (nh_best >= min_triangulated)
        & (ph[bh_i] < 0.9998)
    )

    # F acceptance (ReconstructF, reference: :468-571): maxGood >=
    # max(0.9*N, minTriangulated) and no second similar solution
    # (nsimilar == 1 at 0.7*maxGood).
    bf_i = jnp.argmax(nf)
    nf_best = nf[bf_i]
    nsimilar = jnp.sum(nf > 0.7 * nf_best)
    Nf = jnp.sum(f_inliers)
    ok_f = (
        (nf_best > 0.9 * Nf)
        & (nf_best >= min_triangulated)
        & (nsimilar == 1)
        & (pf[bf_i] < 0.9998)
    )

    success = jnp.where(use_H, ok_h, ok_f)
    R_sel = jnp.where(use_H, R_h[bh_i], R_f[bf_i])
    t_sel = jnp.where(use_H, t_h[bh_i], t_f[bf_i])
    T21 = lie.make_T(R_sel, t_sel)
    return InitResult(
        success=success,
        T_21=T21,
        points=jnp.where(use_H, Xh[bh_i], Xf[bf_i]),
        point_ok=jnp.where(use_H, gh[bh_i], gf[bf_i]),
        used_homography=use_H,
    )

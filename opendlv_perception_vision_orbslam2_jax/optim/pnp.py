"""Hypothesis-batched EPnP RANSAC for relocalization.

Replaces PnPsolver (reference: src/pnpsolver.cpp): the reference runs
adaptive RANSAC over 4-point sets, each solved with EPnP (4 control points,
barycentric coordinates, 12x12 M^T M eigen-decomposition, beta cases,
Gauss-Newton) and checks inliers against per-scale chi2 thresholds
(reference: src/pnpsolver.cpp:36-84, 139-232).

Batched form: ALL hypotheses run at once as one batched pipeline (vmapped EPnP:
eigh of [B, 12, 12], Horn R,t extraction), inliers for all hypotheses x all
correspondences come from one einsum, argmax picks the winner — the
reference's sequential `iterate` loop (reference: src/pnpsolver.cpp:139)
becomes a single device program.  The beta solve uses the dominant-null-space
case (N=1) with sign/scale fixed from control-point distances; the final pose
is refined by the caller's pose optimization, which subsumes the reference's
``Refine()`` (reference: src/pnpsolver.cpp:234-281).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp



N_HYPOTHESES = 256
# 6-point sets: with the dominant-null-space beta (case N=1) the EPnP system
# needs 2n >= 12 equations; the reference's 4-point sets rely on the full
# beta case machinery (reference: src/pnpsolver.cpp:451-541).  Larger sets
# cost a few more RANSAC rounds at equal confidence, which the batched
# 256-hypothesis sweep absorbs.
SET_SIZE = 6


def _polar_rt(p_src, p_dst):
    """Rigid (R, t) aligning ``p_src -> p_dst`` by Newton polar iteration on
    the 3x3 cross-covariance — arithmetic-only replacement for the
    eigh-based Horn quaternion inside the hypothesis sweep (batched small
    eigendecompositions run as serial iterative sweeps; the
    winning hypothesis is re-refined by GN afterwards anyway)."""
    mu_s = jnp.mean(p_src, axis=0)
    mu_d = jnp.mean(p_dst, axis=0)
    H = (p_dst - mu_d).T @ (p_src - mu_s)               # [3, 3]
    X = H / (jnp.linalg.norm(H) + 1e-12)

    def inv3(A):
        # closed-form adjugate inverse
        a = A
        c00 = a[1, 1] * a[2, 2] - a[1, 2] * a[2, 1]
        c01 = a[1, 2] * a[2, 0] - a[1, 0] * a[2, 2]
        c02 = a[1, 0] * a[2, 1] - a[1, 1] * a[2, 0]
        det = a[0, 0] * c00 + a[0, 1] * c01 + a[0, 2] * c02
        adj = jnp.array([
            [c00,
             a[0, 2] * a[2, 1] - a[0, 1] * a[2, 2],
             a[0, 1] * a[1, 2] - a[0, 2] * a[1, 1]],
            [c01,
             a[0, 0] * a[2, 2] - a[0, 2] * a[2, 0],
             a[0, 2] * a[1, 0] - a[0, 0] * a[1, 2]],
            [c02,
             a[0, 1] * a[2, 0] - a[0, 0] * a[2, 1],
             a[0, 0] * a[1, 1] - a[0, 1] * a[1, 0]],
        ])
        return adj / jnp.where(jnp.abs(det) > 1e-12, det, 1e-12)

    for _ in range(8):  # Newton polar: X <- (X + X^-T)/2
        X = 0.5 * (X + inv3(X).T)
    R = X
    t = mu_d - R @ mu_s
    return R, t


def _epnp_single(p_w, uv, fx, fy, cx, cy):
    """EPnP on one minimal set: ``p_w [n, 3]``, ``uv [n, 2]`` -> (R, t).

    Batched re-design of the reference solver (reference:
    src/pnpsolver.cpp:349-541): control points are the centroid + spread-
    scaled *identity* axes instead of PCA axes (EPnP is affine-basis
    independent; identity axes make the barycentrics closed-form and remove
    a batched 3x3 eigh), the M^T M null vector comes from one Cholesky
    inverse iteration instead of a 12x12 eigh, and R, t extraction uses
    Newton polar iteration instead of the 4x4 quaternion eigh.
    """
    n = p_w.shape[0]
    c0 = jnp.mean(p_w, axis=0)
    centered = p_w - c0
    s = jnp.sqrt(jnp.mean(jnp.sum(centered * centered, axis=1)) / 3.0 + 1e-9)
    cw = jnp.concatenate([c0[None], c0[None] + s * jnp.eye(3)], axis=0)

    # closed-form barycentrics for the identity control basis
    beta3 = centered / s                                        # [n, 3]
    alpha = jnp.concatenate(
        [1.0 - jnp.sum(beta3, axis=1, keepdims=True), beta3], axis=1
    )                                                           # [n, 4]

    # M matrix [2n, 12] (reference: fill_M :410-433)
    u, v = uv[:, 0], uv[:, 1]
    zeros = jnp.zeros_like(alpha)
    row_u = jnp.concatenate(
        [alpha * fx, zeros, alpha * (cx - u)[:, None]], axis=1
    )  # [n, 12] — column layout (x-block, y-block, z-block)
    row_v = jnp.concatenate(
        [zeros, alpha * fy, alpha * (cy - v)[:, None]], axis=1
    )
    M = jnp.concatenate([row_u, row_v], axis=0)                 # [2n, 12]
    MtM = M.T @ M
    # Smallest-eigenvector by Cholesky inverse iteration (direct, batched-
    # friendly; replaces jnp.linalg.eigh which runs an iterative QR sweep
    # per hypothesis).
    eps = 1e-8 * jnp.trace(MtM) + 1e-12
    L = jnp.linalg.cholesky(MtM + eps * jnp.eye(12))
    vker = jnp.ones((12,)) / jnp.sqrt(12.0)
    for _ in range(3):
        y = jax.scipy.linalg.solve_triangular(L, vker, lower=True)
        vker = jax.scipy.linalg.solve_triangular(L.T, y, lower=False)
        vker = vker / (jnp.linalg.norm(vker) + 1e-20)
    # layout back to 4 control points: [x0..x3, y0..y3, z0..z3]
    cc = jnp.stack([vker[0:4], vker[4:8], vker[8:12]], axis=1)  # [4, 3]

    # beta (case N=1): match control-point distances, fix cheirality
    pairs = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]
    dw = jnp.stack([jnp.linalg.norm(cw[i] - cw[j]) for i, j in pairs])
    dc = jnp.stack([jnp.linalg.norm(cc[i] - cc[j]) for i, j in pairs])
    beta = jnp.sum(dw * dc) / (jnp.sum(dc * dc) + 1e-12)
    cc = cc * beta
    p_c = alpha @ cc                                            # [n, 3]
    # cheirality: points must be in front
    flip = jnp.sum(p_c[:, 2]) < 0
    p_c = jnp.where(flip, -p_c, p_c)

    R, t = _polar_rt(p_w, p_c)
    return R, t


class PnPResult(NamedTuple):
    R: jnp.ndarray
    t: jnp.ndarray
    inliers: jnp.ndarray   # [N] bool (best hypothesis)
    n_inliers: jnp.ndarray


@functools.partial(
    jax.jit, static_argnames=("fx", "fy", "cx", "cy", "n_hypotheses")
)
def pnp_ransac(p_w, uv, sigma2, valid, key, *, fx: float, fy: float,
               cx: float, cy: float, n_hypotheses: int = N_HYPOTHESES):
    """Batched EPnP RANSAC over ``N`` 3D-2D correspondences.

    Inlier test: squared reprojection error <= 5.991 * sigma2 (the per-scale
    chi2 gate, reference: src/pnpsolver.cpp:62-84, 282-347).
    """
    N = p_w.shape[0]
    # sample hypothesis sets, biased to valid slots
    weights = valid.astype(jnp.float32)
    idx = jax.random.categorical(
        key, jnp.log(weights + 1e-9), shape=(n_hypotheses, SET_SIZE)
    )
    sets_ok = jnp.all(jnp.take(valid, idx), axis=1)

    Rs, ts = jax.vmap(
        lambda ii: _epnp_single(p_w[ii], uv[ii], fx, fy, cx, cy)
    )(idx)

    # score all hypotheses on all correspondences
    p_c = jnp.einsum("bij,nj->bni", Rs, p_w) + ts[:, None, :]
    z = p_c[..., 2]
    z_ok = z > 1e-3
    zs = jnp.where(z_ok, z, 1.0)
    u_hat = fx * p_c[..., 0] / zs + cx
    v_hat = fy * p_c[..., 1] / zs + cy
    err2 = (uv[None, :, 0] - u_hat) ** 2 + (uv[None, :, 1] - v_hat) ** 2
    inl = (err2 <= 5.991 * sigma2[None, :]) & z_ok & valid[None, :] & sets_ok[:, None]
    counts = jnp.sum(inl, axis=1)
    best = jnp.argmax(counts)
    return PnPResult(
        R=Rs[best], t=ts[best], inliers=inl[best], n_inliers=counts[best]
    )

"""Pose-only optimization: masked batched Gauss-Newton/LM on one SE3 vertex.

Replaces g2o's PoseOptimization (reference: src/orboptimizer.cpp:248-461):
a single SE3 vertex with monocular (2D) and stereo (3D) projection edges,
Huber kernels delta = sqrt(5.991) / sqrt(7.815), run as 4 rounds x 10
iterations with chi2 inlier reclassification between rounds and the robust
kernel dropped from round 3 (reference: :379-452, kernel drop at :436-439).

Batched form: all residuals/Jacobians evaluate batched over the static keypoint
capacity with a validity mask; the normal system is a 6x6 reduction (a
``psum``-friendly shape for the future sharded version).  No branches — the
round structure is unrolled, inlier sets are masks.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops import lie

CHI2_MONO = 5.991
CHI2_STEREO = 7.815
ITS_PER_ROUND = 10
N_ROUNDS = 4


class PoseObs(NamedTuple):
    """Batched pose-optimization problem over K observation slots."""

    p_w: jnp.ndarray       # [K, 3] world points
    uv: jnp.ndarray        # [K, 2] measured pixel
    u_right: jnp.ndarray   # [K] measured right-x, <0 => monocular edge
    sigma2: jnp.ndarray    # [K] per-observation sigma^2 (scale^2*octave)
    valid: jnp.ndarray     # [K] bool


def _residuals_jacobian(T_cw, obs: PoseObs, fx, fy, cx, cy, bf):
    """r [K,3], J [K,3,6] for stereo-augmented reprojection.

    Third row is the right-image u residual, weight-masked for mono edges.
    Jacobian is wrt a *left* se3 perturbation: p_c' = exp(xi) T p_w.
    """
    p_c = lie.transform_points(T_cw[None], obs.p_w[None])[0]   # [K, 3]
    x, y, z = p_c[:, 0], p_c[:, 1], p_c[:, 2]
    z_safe = jnp.where(z > 1e-6, z, 1e-6)
    inv_z = 1.0 / z_safe
    inv_z2 = inv_z * inv_z

    u_hat = fx * x * inv_z + cx
    v_hat = fy * y * inv_z + cy
    ur_hat = u_hat - bf * inv_z

    is_stereo = obs.u_right >= 0
    r = jnp.stack(
        [
            obs.uv[:, 0] - u_hat,
            obs.uv[:, 1] - v_hat,
            jnp.where(is_stereo, obs.u_right - ur_hat, 0.0),
        ],
        axis=-1,
    )

    # d(pixel)/d(p_c)
    du = jnp.stack([fx * inv_z, jnp.zeros_like(z), -fx * x * inv_z2], axis=-1)
    dv = jnp.stack([jnp.zeros_like(z), fy * inv_z, -fy * y * inv_z2], axis=-1)
    dur = du + jnp.stack(
        [jnp.zeros_like(z), jnp.zeros_like(z), bf * inv_z2], axis=-1
    )
    d_pix = jnp.stack([du, dv, dur], axis=1)                   # [K, 3, 3]

    # d(p_c)/d(xi) = [I | -hat(p_c)] for xi = (rho, phi)
    I3 = jnp.broadcast_to(jnp.eye(3, dtype=p_c.dtype), (p_c.shape[0], 3, 3))
    d_pc = jnp.concatenate([I3, -lie.hat(p_c)], axis=-1)       # [K, 3, 6]

    # residual = measured - predicted  =>  J = -d(pred)/d(xi)
    J = -jnp.einsum("kij,kjl->kil", d_pix, d_pc)               # [K, 3, 6]
    behind = z <= 1e-6
    return r, J, is_stereo, behind


def _chi2(r, sigma2, is_stereo):
    w = 1.0 / sigma2
    c_mono = (r[:, 0] ** 2 + r[:, 1] ** 2) * w
    c_stereo = jnp.sum(r * r, axis=-1) * w
    return jnp.where(is_stereo, c_stereo, c_mono)


@functools.partial(jax.jit, static_argnames=("fx", "fy", "cx", "cy", "bf"))
def pose_optimize(T_cw_init, obs: PoseObs, *, fx: float, fy: float,
                  cx: float, cy: float, bf: float):
    """Optimize a single pose against fixed world points.

    Returns ``(T_cw, inlier_mask, n_inliers)`` — the array analogue of
    PoseOptimization's return + per-edge outlier flags
    (reference: src/orboptimizer.cpp:444-459).
    """
    delta_mono = jnp.sqrt(CHI2_MONO)
    delta_stereo = jnp.sqrt(CHI2_STEREO)

    def gn_iterations(T, inlier_mask, use_huber):
        # while_loop with a convergence exit instead of a fixed fori: GN on
        # a warm-started pose typically converges in 3-5 steps, after which
        # further iterations are numeric no-ops (g2o also runs a bounded
        # iteration count).  Threshold note: 1e-12 on ||dx||^2 measurably
        # perturbs monocular tracking (mono maps are median-depth-normalized,
        # so pose updates sit ~50x lower than metric stereo); 1e-13 keeps
        # mono bit-stable while still exiting the stereo chains early.
        def body(carry):
            i, T, _ = carry
            r, J, is_stereo, behind = _residuals_jacobian(
                T, obs, fx, fy, cx, cy, bf
            )
            active = obs.valid & inlier_mask & (~behind)
            info = 1.0 / obs.sigma2
            chi = jnp.sqrt(jnp.maximum(_chi2(r, obs.sigma2, is_stereo), 1e-12))
            delta = jnp.where(is_stereo, delta_stereo, delta_mono)
            huber_w = jnp.where(chi <= delta, 1.0, delta / chi)
            w = info * jnp.where(use_huber, huber_w, 1.0)
            w = jnp.where(active, w, 0.0)
            # zero the ur row for mono edges
            row_w = jnp.stack(
                [jnp.ones_like(w), jnp.ones_like(w),
                 jnp.where(is_stereo, 1.0, 0.0)], axis=-1
            ) * w[:, None]
            H = jnp.einsum("kri,kr,krj->ij", J, row_w, J)
            b = -jnp.einsum("kri,kr->i", J, row_w * r)
            H = H + 1e-5 * jnp.eye(6, dtype=H.dtype)
            dx = jnp.linalg.solve(H, b)
            ok = jnp.all(jnp.isfinite(dx))
            dx = jnp.where(ok, dx, 0.0)
            return (i + 1, lie.exp_se3(dx) @ T, jnp.sum(dx * dx))

        def cond(carry):
            i, _, step2 = carry
            return (i < ITS_PER_ROUND) & (step2 > 1e-13)

        _, T, _ = jax.lax.while_loop(
            cond, body, (jnp.int32(0), T, jnp.float32(jnp.inf))
        )
        return T

    T = T_cw_init
    inliers = jnp.ones_like(obs.valid)
    for rnd in range(N_ROUNDS):
        use_huber = rnd < 2  # reference drops the kernel at round 3 (:436)
        T = gn_iterations(T, inliers, use_huber)
        r, _, is_stereo, behind = _residuals_jacobian(T, obs, fx, fy, cx, cy, bf)
        chi2 = _chi2(r, obs.sigma2, is_stereo)
        th = jnp.where(is_stereo, CHI2_STEREO, CHI2_MONO)
        inliers = obs.valid & (chi2 <= th) & (~behind)

    n_inliers = jnp.sum(inliers)
    return T, inliers, n_inliers


@functools.partial(jax.jit, static_argnames=("fx", "fy", "cx", "cy", "bf"))
def robust_pose_estimate(T_pred, obs: PoseObs, key, *, fx: float, fy: float,
                         cx: float, cy: float, bf: float):
    """Pose optimization with a RANSAC rescue branch.

    Gauss-Newton from the motion-model prediction handles the common case;
    when the prediction is stale (bootstrap, post-reset) wide-gate matches
    carry enough outliers to trap GN in the wrong basin.  An EPnP-RANSAC
    seed (the reference's relocalization machinery, src/pnpsolver.cpp)
    is therefore always computed — it is cheap next to the matchers — and a
    second GN runs from it; the result with more inliers wins, branch-free.
    """
    from .pnp import pnp_ransac

    def classify(T):
        r, _, is_stereo, behind = _residuals_jacobian(T, obs, fx, fy, cx, cy, bf)
        chi2 = _chi2(r, obs.sigma2, is_stereo)
        th = jnp.where(is_stereo, CHI2_STEREO, CHI2_MONO)
        return obs.valid & (chi2 <= th) & (~behind)

    res = pnp_ransac(
        obs.p_w, obs.uv, obs.sigma2, obs.valid, key,
        fx=fx, fy=fy, cx=cx, cy=cy,
    )
    T_pnp = lie.make_T(res.R, res.t)
    # Two GN chains — from the motion prediction over all matches, and from
    # the RANSAC seed over the consensus set only (PnPsolver::Refine
    # semantics, reference: src/pnpsolver.cpp:234-281; optimizing over ALL
    # matches from the seed lets Huber-weighted gross outliers drag the pose
    # out of the consensus basin).  vmapped so the 4x10 sequential GN
    # iterations are paid once, not twice.
    T_inits = jnp.stack([T_pred, T_pnp])
    valids = jnp.stack([obs.valid, obs.valid & res.inliers])
    T_ab, _, _ = jax.vmap(
        lambda Ti, v: pose_optimize(
            Ti, obs._replace(valid=v), fx=fx, fy=fy, cx=cx, cy=cy, bf=bf
        )
    )(T_inits, valids)
    T_a, T_b = T_ab[0], T_ab[1]
    # fair comparison: chi2 inliers over the FULL observation set
    inl_a = classify(T_a)
    inl_b = classify(T_b)
    n_a = jnp.sum(inl_a)
    n_b = jnp.sum(inl_b)
    use_b = n_b > n_a
    T = jnp.where(use_b, T_b, T_a)
    inliers = jnp.where(use_b, inl_b, inl_a)
    return T, inliers, jnp.maximum(n_a, n_b)

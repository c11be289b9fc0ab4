"""Bundle adjustment: batched Levenberg-Marquardt with Schur complement.

Replaces g2o's sparse BlockSolver_6_3 + LinearSolverEigen pipeline used by
BundleAdjustment / LocalBundleAdjustment / GlobalBundleAdjustemnt
(reference: src/orboptimizer.cpp:35-38, 54-246, 463-798).  The reference
builds a pointer graph of SE3/XYZ vertices and mono/stereo projection edges
with Huber kernels, then runs LM with landmark marginalization.

Fixed-shape formulation — everything is fixed-shape and masked:

- edges live in flat arrays ``[E]`` (pose idx, point idx, measurement);
- residuals + Jacobians evaluate batched (vmap-free einsums);
- the normal equations assemble by scatter-add:
    Hpp [Ko,6,6], Hll [P,3,3], Hpl [Ko,P,6,3], b;
- landmark blocks are inverted in closed form (3x3 adjugate) and
  Schur-reduced onto the camera system ``S = Hpp - W Hll^-1 W^T`` — the
  W-contractions are plain matmuls;
- the reduced system (6*Ko, small) solves densely; landmarks back-substitute;
- LM damping adapts branch-free (cost-compare + jnp.where keep/revert).

The observation-sharded multi-device version reuses exactly these pieces
with a psum over the per-shard (Hpp, Hpl-contracted) blocks (parallel/).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops import lie

CHI2_MONO = 5.991
CHI2_STEREO = 7.815


class BAProblem(NamedTuple):
    """Fixed-shape BA problem.

    Pose indexing: ``e_kf`` in ``[0, Ko+Kf)``; indices >= Ko refer to fixed
    poses (observers included for constraints but not optimized — the
    LocalBundleAdjustment fixed-camera set, reference:
    src/orboptimizer.cpp:527-557).
    """

    T_opt: jnp.ndarray      # [Ko, 4, 4] optimizable keyframe poses
    opt_valid: jnp.ndarray  # [Ko] bool
    T_fix: jnp.ndarray      # [Kf, 4, 4] fixed poses
    fix_valid: jnp.ndarray  # [Kf] bool
    pts: jnp.ndarray        # [P, 3] landmark positions
    pt_valid: jnp.ndarray   # [P] bool
    e_kf: jnp.ndarray       # [E] int32 pose index (combined opt+fix)
    e_pt: jnp.ndarray       # [E] int32 landmark index
    e_uv: jnp.ndarray       # [E, 2] measured pixels
    e_ur: jnp.ndarray       # [E] measured right-u (<0 mono)
    e_sigma2: jnp.ndarray   # [E]
    e_valid: jnp.ndarray    # [E] bool


def _edge_residuals(T_all, pts, prob: BAProblem, fx, fy, cx, cy, bf):
    """r [E,3], J_pose [E,3,6], J_pt [E,3,3], aux masks."""
    T_e = jnp.take(T_all, prob.e_kf, axis=0)          # [E, 4, 4]
    p_w = jnp.take(pts, prob.e_pt, axis=0)            # [E, 3]
    R = T_e[:, :3, :3]
    p_c = jnp.einsum("eij,ej->ei", R, p_w) + T_e[:, :3, 3]
    x, y, z = p_c[:, 0], p_c[:, 1], p_c[:, 2]
    z_safe = jnp.where(z > 1e-6, z, 1e-6)
    inv_z = 1.0 / z_safe
    inv_z2 = inv_z * inv_z

    u_hat = fx * x * inv_z + cx
    v_hat = fy * y * inv_z + cy
    ur_hat = u_hat - bf * inv_z
    is_stereo = prob.e_ur >= 0
    r = jnp.stack(
        [
            prob.e_uv[:, 0] - u_hat,
            prob.e_uv[:, 1] - v_hat,
            jnp.where(is_stereo, prob.e_ur - ur_hat, 0.0),
        ],
        axis=-1,
    )
    du = jnp.stack([fx * inv_z, jnp.zeros_like(z), -fx * x * inv_z2], axis=-1)
    dv = jnp.stack([jnp.zeros_like(z), fy * inv_z, -fy * y * inv_z2], axis=-1)
    dur = du + jnp.stack(
        [jnp.zeros_like(z), jnp.zeros_like(z), bf * inv_z2], axis=-1
    )
    d_pix = jnp.stack([du, dv, dur], axis=1)          # [E, 3, 3]

    I3 = jnp.broadcast_to(jnp.eye(3, dtype=r.dtype), (r.shape[0], 3, 3))
    d_pc_dxi = jnp.concatenate([I3, -lie.hat(p_c)], axis=-1)   # [E, 3, 6]
    J_pose = -jnp.einsum("eij,ejl->eil", d_pix, d_pc_dxi)      # [E, 3, 6]
    J_pt = -jnp.einsum("eij,ejl->eil", d_pix, R)               # [E, 3, 3]
    behind = z <= 1e-6
    return r, J_pose, J_pt, is_stereo, behind


def _edge_chi2(r, sigma2, is_stereo):
    w = 1.0 / sigma2
    return jnp.where(
        is_stereo,
        jnp.sum(r * r, axis=-1) * w,
        (r[:, 0] ** 2 + r[:, 1] ** 2) * w,
    )


def _inv3x3(A):
    """Batched closed-form 3x3 inverse (adjugate / det)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A11 = e * i - f * h
    A12 = c * h - b * i
    A13 = b * f - c * e
    A21 = f * g - d * i
    A22 = a * i - c * g
    A23 = c * d - a * f
    A31 = d * h - e * g
    A32 = b * g - a * h
    A33 = a * e - b * d
    det = a * A11 + b * A12 + c * A13
    det = jnp.where(jnp.abs(det) < 1e-12, 1e-12, det)
    adj = jnp.stack(
        [
            jnp.stack([A11, A12, A13], -1),
            jnp.stack([A21, A22, A23], -1),
            jnp.stack([A31, A32, A33], -1),
        ],
        axis=-2,
    )
    return adj / det[..., None, None]


class BAResult(NamedTuple):
    T_opt: jnp.ndarray
    pts: jnp.ndarray
    edge_inlier: jnp.ndarray  # [E] bool (post-optimization chi2 gate)
    cost: jnp.ndarray         # [] final robust cost


@functools.partial(
    jax.jit,
    static_argnames=("fx", "fy", "cx", "cy", "bf", "iters_first",
                     "iters_second", "fix_first_pose"),
)
def bundle_adjust(prob: BAProblem, *, fx: float, fy: float, cx: float,
                  cy: float, bf: float, iters_first: int = 5,
                  iters_second: int = 10, fix_first_pose: bool = False):
    """Two-phase LM (5 its -> chi2 outlier cut -> 10 its), mirroring
    LocalBundleAdjustment's schedule (reference: src/orboptimizer.cpp:681-730).

    ``fix_first_pose`` pins T_opt[0] (gauge freedom for global BA; the
    reference fixes keyframe 0, src/orboptimizer.cpp:84-86).
    """
    Ko = prob.T_opt.shape[0]
    P = prob.pts.shape[0]
    delta_mono = jnp.sqrt(CHI2_MONO)
    delta_stereo = jnp.sqrt(CHI2_STEREO)

    pose_free = prob.opt_valid
    if fix_first_pose:
        pose_free = pose_free.at[0].set(False)

    def robust_cost(T_opt, pts, active):
        T_all = jnp.concatenate([T_opt, prob.T_fix], axis=0)
        r, _, _, is_stereo, behind = _edge_residuals(
            T_all, pts, prob, fx, fy, cx, cy, bf
        )
        chi2 = _edge_chi2(r, prob.e_sigma2, is_stereo)
        delta2 = jnp.where(is_stereo, CHI2_STEREO, CHI2_MONO)
        # Huber cost
        c = jnp.where(
            chi2 <= delta2, chi2, 2.0 * jnp.sqrt(delta2 * chi2) - delta2
        )
        # behind-camera edges carry a LARGE constant penalty (worse than any
        # visible outlier) rather than dropping out: zeroing them lets LM
        # monotonically "improve" by pushing weakly-constrained points behind
        # their observers (negative-depth escape hatch — points were observed
        # moving 20-60 m per solve).  Constant because the clamped-z residual
        # there is astronomically large and its gradient is meaningless; the
        # penalty only has to make such steps lose the accept test.
        c = jnp.where(behind, 2.0 * jnp.sqrt(delta2 * 1e8), c)
        return jnp.sum(jnp.where(active, c, 0.0))

    def lm_phase(T_opt, pts, active, n_iters):
        def body(carry, _):
            T_opt, pts, lam, prev_cost = carry
            T_all = jnp.concatenate([T_opt, prob.T_fix], axis=0)
            r, J_pose, J_pt, is_stereo, behind = _edge_residuals(
                T_all, pts, prob, fx, fy, cx, cy, bf
            )
            ok = active & (~behind)
            chi = jnp.sqrt(
                jnp.maximum(_edge_chi2(r, prob.e_sigma2, is_stereo), 1e-12)
            )
            delta = jnp.where(is_stereo, delta_stereo, delta_mono)
            huber_w = jnp.where(chi <= delta, 1.0, delta / chi)
            w = jnp.where(ok, huber_w / prob.e_sigma2, 0.0)
            row_w = (
                jnp.stack(
                    [jnp.ones_like(w), jnp.ones_like(w),
                     jnp.where(is_stereo, 1.0, 0.0)],
                    axis=-1,
                )
                * w[:, None]
            )                                               # [E, 3]

            # weighted Jacobians
            Jp_w = J_pose * row_w[:, :, None]               # [E, 3, 6]
            Jl_w = J_pt * row_w[:, :, None]                 # [E, 3, 3]

            # pose blocks only for edges on optimizable poses
            on_opt = (prob.e_kf < Ko) & jnp.take(
                jnp.concatenate([pose_free, jnp.zeros_like(prob.fix_valid)]),
                prob.e_kf,
            )
            kf_idx = jnp.where(on_opt, prob.e_kf, 0)
            zero_opt = on_opt.astype(r.dtype)[:, None, None]

            Hpp = jnp.zeros((Ko, 6, 6), r.dtype).at[kf_idx].add(
                jnp.einsum("eri,erj->eij", Jp_w * zero_opt, J_pose)
            )
            b_p = jnp.zeros((Ko, 6), r.dtype).at[kf_idx].add(
                -jnp.einsum("eri,er->ei", Jp_w * zero_opt, r)
            )
            Hll = jnp.zeros((P, 3, 3), r.dtype).at[prob.e_pt].add(
                jnp.einsum("eri,erj->eij", Jl_w, J_pt)
            )
            b_l = jnp.zeros((P, 3), r.dtype).at[prob.e_pt].add(
                -jnp.einsum("eri,er->ei", Jl_w, r)
            )
            Hpl = jnp.zeros((Ko, P, 6, 3), r.dtype).at[kf_idx, prob.e_pt].add(
                jnp.einsum("eri,erj->eij", Jp_w * zero_opt, J_pt)
            )

            # LM damping
            Hpp_d = Hpp + lam * jnp.eye(6, dtype=r.dtype)[None]
            Hll_d = Hll + lam * jnp.eye(3, dtype=r.dtype)[None]
            # freeze invalid landmarks/poses by identity blocks
            Hll_d = jnp.where(
                prob.pt_valid[:, None, None], Hll_d,
                jnp.eye(3, dtype=r.dtype)[None],
            )
            Hpp_d = jnp.where(
                pose_free[:, None, None], Hpp_d, jnp.eye(6, dtype=r.dtype)[None]
            )
            b_l_m = jnp.where(prob.pt_valid[:, None], b_l, 0.0)
            b_p_m = jnp.where(pose_free[:, None], b_p, 0.0)

            Hll_inv = _inv3x3(Hll_d)                        # [P, 3, 3]

            # Schur: S = Hpp_blockdiag - W Hll^-1 W^T ; W = Hpl
            A = jnp.einsum("kpij,pjl->kpil", Hpl, Hll_inv)  # [Ko,P,6,3]
            S_off = jnp.einsum("kpil,qpml->kiqm", A, Hpl)   # [Ko,6,Ko,6]
            S = -S_off
            diag_idx = jnp.arange(Ko)
            S = S.at[diag_idx, :, diag_idx, :].add(Hpp_d)
            S = S.reshape(Ko * 6, Ko * 6)
            rhs = (
                b_p_m - jnp.einsum("kpil,pl->ki", A, b_l_m)
            ).reshape(Ko * 6)

            dx_c = jnp.linalg.solve(
                S + 1e-8 * jnp.eye(Ko * 6, dtype=r.dtype), rhs
            )
            dx_c = jnp.where(jnp.all(jnp.isfinite(dx_c)), dx_c, 0.0)
            dx_c6 = dx_c.reshape(Ko, 6)
            # back-substitute landmarks
            Wt_dx = jnp.einsum("kpij,ki->pj", Hpl, dx_c6)
            dx_l = jnp.einsum("pij,pj->pi", Hll_inv, b_l_m - Wt_dx)
            dx_l = jnp.where(prob.pt_valid[:, None], dx_l, 0.0)

            T_new = jax.vmap(lambda d, T: lie.exp_se3(d) @ T)(dx_c6, T_opt)
            T_new = jnp.where(pose_free[:, None, None], T_new, T_opt)
            pts_new = pts + dx_l

            new_cost = robust_cost(T_new, pts_new, active)
            accept = new_cost < prev_cost
            T_keep = jnp.where(accept, T_new, T_opt)
            pts_keep = jnp.where(accept, pts_new, pts)
            lam_next = jnp.where(accept, lam * 0.5, lam * 4.0)
            lam_next = jnp.clip(lam_next, 1e-8, 1e4)
            cost_keep = jnp.where(accept, new_cost, prev_cost)
            return (T_keep, pts_keep, lam_next, cost_keep), None

        init_cost = robust_cost(T_opt, pts, active)
        (T_opt, pts, _, cost), _ = jax.lax.scan(
            body, (T_opt, pts, jnp.asarray(1e-4, T_opt.dtype), init_cost),
            None, length=n_iters,
        )
        return T_opt, pts, cost

    base_active = (
        prob.e_valid
        & jnp.take(prob.pt_valid, prob.e_pt)
        & jnp.take(
            jnp.concatenate([prob.opt_valid, prob.fix_valid]), prob.e_kf
        )
    )
    T_opt, pts, _ = lm_phase(prob.T_opt, prob.pts, base_active, iters_first)

    # chi2 outlier cut between phases (reference: src/orboptimizer.cpp:690-705)
    T_all = jnp.concatenate([T_opt, prob.T_fix], axis=0)
    r, _, _, is_stereo, behind = _edge_residuals(
        T_all, pts, prob, fx, fy, cx, cy, bf
    )
    chi2 = _edge_chi2(r, prob.e_sigma2, is_stereo)
    th = jnp.where(is_stereo, CHI2_STEREO, CHI2_MONO)
    active = base_active & (chi2 <= th) & (~behind)

    T_opt, pts, cost = lm_phase(T_opt, pts, active, iters_second)

    # final inlier classification (drives observation erasure in the caller,
    # reference: src/orboptimizer.cpp:735-760)
    T_all = jnp.concatenate([T_opt, prob.T_fix], axis=0)
    r, _, _, is_stereo, behind = _edge_residuals(
        T_all, pts, prob, fx, fy, cx, cy, bf
    )
    chi2 = _edge_chi2(r, prob.e_sigma2, is_stereo)
    inlier = base_active & (chi2 <= th) & (~behind)
    return BAResult(T_opt=T_opt, pts=pts, edge_inlier=inlier, cost=cost)

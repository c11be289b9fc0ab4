"""Local bundle adjustment on the dense (window-KF x feature) grid.

Replaces g2o's LocalBundleAdjustment solve (reference:
src/orboptimizer.cpp:463-798) for the production mapping stage.  The
edge-list formulation in optim/ba.py assembles its normal equations with
``.at[].add`` scatters — 6 scatter passes per LM iteration, and
arbitrary-index scatter-adds are among the slowest operations XLA emits.

Restructure: keep the edges in their NATURAL dense layout — the
``[KW, F]`` binding grid of the window keyframes — plus a per-point
OBSERVATION TABLE ``obs_table [PL, KW]`` (feature index of point p in
window keyframe w, -1 if unobserved; each point has at most one observation
per keyframe, exactly the reference's per-KF observation map).  Then every
reduction in the LM iteration is either

- a row reduction over F (pose blocks Hpp, b_p), or
- a gather along obs_table followed by a reduction over KW (landmark
  blocks Hll, b_l, the coupling Hpl, and the landmark back-substitution),

i.e. pure einsums and gathers — zero scatters anywhere in the loop.  The
Schur-reduced camera system is dense [6*KO, 6*KO] like before.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops import lie
from .ba import CHI2_MONO, CHI2_STEREO, _inv3x3


class GridBAProblem(NamedTuple):
    """Dense-grid local BA problem.

    ``KW = KO + KFIX`` window keyframes (first ``KO`` optimizable), ``F``
    feature slots each, ``PL`` local points.

    The SOLVE runs natively on the observation-table layout ``[PL, KW]``
    (one slot per point x window-keyframe, measurements gathered once at
    extract) — per-LM-iteration work is then pure elementwise math +
    reductions, no gathers and no scatters.  The ``g_*`` grid views exist
    for the final per-feature inlier gate (observation erasure).
    """

    T_all: jnp.ndarray      # [KW, 4, 4] window poses (first KO optimized)
    kf_valid: jnp.ndarray   # [KW] bool
    pose_free: jnp.ndarray  # [KO] bool (valid AND not gauge-pinned)
    pts: jnp.ndarray        # [PL, 3]
    pt_valid: jnp.ndarray   # [PL] bool
    g_pt: jnp.ndarray       # [KW, F] int32 local point idx (PL-1 dump ok, <0 none)
    g_uv: jnp.ndarray       # [KW, F, 2]
    g_ur: jnp.ndarray       # [KW, F] (<0 mono)
    g_sigma2: jnp.ndarray   # [KW, F]
    g_valid: jnp.ndarray    # [KW, F] bool
    obs_table: jnp.ndarray  # [PL, KW] int32 feature idx (-1 none)
    o_uv: jnp.ndarray       # [PL, KW, 2] measured pixels per observation
    o_ur: jnp.ndarray       # [PL, KW] right-u (<0 mono)
    o_sigma2: jnp.ndarray   # [PL, KW]
    o_valid: jnp.ndarray    # [PL, KW] bool

    @property
    def n_opt(self) -> int:
        return self.pose_free.shape[0]


class GridBAResult(NamedTuple):
    T_opt: jnp.ndarray        # [KO, 4, 4]
    pts: jnp.ndarray          # [PL, 3]
    grid_inlier: jnp.ndarray  # [KW, F] bool (post-optimization chi2 gate)
    cost: jnp.ndarray


def _grid_terms(T_all, pts, prob: GridBAProblem, fx, fy, cx, cy, bf):
    """Residuals + Jacobians over the whole [KW, F] grid."""
    KW, F = prob.g_pt.shape
    PL = prob.pts.shape[0]
    p_idx = jnp.clip(prob.g_pt, 0, PL - 1)
    p_w = pts[p_idx]                                     # [KW, F, 3]
    R = T_all[:, :3, :3]
    t = T_all[:, :3, 3]
    p_c = jnp.einsum("wij,wfj->wfi", R, p_w) + t[:, None, :]
    x, y, z = p_c[..., 0], p_c[..., 1], p_c[..., 2]
    z_safe = jnp.where(z > 1e-6, z, 1e-6)
    inv_z = 1.0 / z_safe
    inv_z2 = inv_z * inv_z

    u_hat = fx * x * inv_z + cx
    v_hat = fy * y * inv_z + cy
    ur_hat = u_hat - bf * inv_z
    is_stereo = prob.g_ur >= 0
    r = jnp.stack(
        [
            prob.g_uv[..., 0] - u_hat,
            prob.g_uv[..., 1] - v_hat,
            jnp.where(is_stereo, prob.g_ur - ur_hat, 0.0),
        ],
        axis=-1,
    )                                                    # [KW, F, 3]
    zeros = jnp.zeros_like(z)
    du = jnp.stack([fx * inv_z, zeros, -fx * x * inv_z2], axis=-1)
    dv = jnp.stack([zeros, fy * inv_z, -fy * y * inv_z2], axis=-1)
    dur = du + jnp.stack([zeros, zeros, bf * inv_z2], axis=-1)
    d_pix = jnp.stack([du, dv, dur], axis=-2)            # [KW, F, 3, 3]

    I3 = jnp.broadcast_to(jnp.eye(3, dtype=r.dtype), p_c.shape + (3,))
    d_pc = jnp.concatenate([I3, -lie.hat(p_c)], axis=-1)  # [KW, F, 3, 6]
    J_pose = -jnp.einsum("wfij,wfjl->wfil", d_pix, d_pc)  # [KW, F, 3, 6]
    J_pt = -jnp.einsum("wfij,wjl->wfil", d_pix, R)        # [KW, F, 3, 3]
    behind = z <= 1e-6
    return r, J_pose, J_pt, is_stereo, behind


def _grid_chi2(r, sigma2, is_stereo):
    w = 1.0 / sigma2
    return jnp.where(
        is_stereo,
        jnp.sum(r * r, axis=-1) * w,
        (r[..., 0] ** 2 + r[..., 1] ** 2) * w,
    )


def _obs_terms(T_all, pts, prob: GridBAProblem, fx, fy, cx, cy, bf):
    """Residuals + Jacobians on the [PL, KW] observation layout — the
    per-iteration workhorse, gather-free."""
    R = T_all[:, :3, :3]                                  # [KW, 3, 3]
    t = T_all[:, :3, 3]
    p_c = jnp.einsum("wij,pj->pwi", R, pts) + t[None, :, :]  # [PL, KW, 3]
    x, y, z = p_c[..., 0], p_c[..., 1], p_c[..., 2]
    z_safe = jnp.where(z > 1e-6, z, 1e-6)
    inv_z = 1.0 / z_safe
    inv_z2 = inv_z * inv_z

    u_hat = fx * x * inv_z + cx
    v_hat = fy * y * inv_z + cy
    ur_hat = u_hat - bf * inv_z
    is_stereo = prob.o_ur >= 0
    r = jnp.stack(
        [
            prob.o_uv[..., 0] - u_hat,
            prob.o_uv[..., 1] - v_hat,
            jnp.where(is_stereo, prob.o_ur - ur_hat, 0.0),
        ],
        axis=-1,
    )                                                     # [PL, KW, 3]
    zeros = jnp.zeros_like(z)
    du = jnp.stack([fx * inv_z, zeros, -fx * x * inv_z2], axis=-1)
    dv = jnp.stack([zeros, fy * inv_z, -fy * y * inv_z2], axis=-1)
    dur = du + jnp.stack([zeros, zeros, bf * inv_z2], axis=-1)
    d_pix = jnp.stack([du, dv, dur], axis=-2)             # [PL, KW, 3, 3]

    I3 = jnp.broadcast_to(jnp.eye(3, dtype=r.dtype), p_c.shape + (3,))
    d_pc = jnp.concatenate([I3, -lie.hat(p_c)], axis=-1)  # [PL, KW, 3, 6]
    J_pose = -jnp.einsum("pwij,pwjl->pwil", d_pix, d_pc)
    J_pt = -jnp.einsum("pwij,wjl->pwil", d_pix, R)
    behind = z <= 1e-6
    return r, J_pose, J_pt, is_stereo, behind


def _scalar_residuals(T_all, pts, o_uT, o_vT, o_qT, fx, fy, cx, cy, bf):
    """Residual component arrays in the [KW, PL] layout.

    Layout note: every array here has exactly two significant dims with
    the big point axis LAST.  The einsum formulation materialized
    [PL, KW, 3, 6] operands whose tiny minor dims pad to whole memory
    tiles; the scalarized form runs the same math on dense [KW, PL]
    arrays."""
    R = T_all[:, :3, :3]
    t = T_all[:, :3, 3]
    pc = jnp.einsum("wij,pj->wip", R, pts) + t[:, :, None]    # [KW, 3, PL]
    x, y, z = pc[:, 0], pc[:, 1], pc[:, 2]
    behind = z <= 1e-6
    iz = 1.0 / jnp.where(z > 1e-6, z, 1e-6)
    u_hat = fx * x * iz + cx
    v_hat = fy * y * iz + cy
    st = o_qT >= 0
    r_u = o_uT - u_hat
    r_v = o_vT - v_hat
    r_q = jnp.where(st, o_qT - (u_hat - bf * iz), 0.0)
    return x, y, z, iz, st, behind, r_u, r_v, r_q, R


def _scalar_cost(T_all, pts, o_uT, o_vT, o_qT, infoT, activeT,
                 fx, fy, cx, cy, bf):
    """Huber-robust total cost on the [KW, PL] layout (residuals only)."""
    _, _, _, _, st, behind, r_u, r_v, r_q, _ = _scalar_residuals(
        T_all, pts, o_uT, o_vT, o_qT, fx, fy, cx, cy, bf
    )
    chi2 = (r_u * r_u + r_v * r_v + r_q * r_q) * infoT
    d2 = jnp.where(st, CHI2_STEREO, CHI2_MONO)
    c = jnp.where(chi2 <= d2, chi2, 2.0 * jnp.sqrt(d2 * chi2) - d2)
    c = jnp.where(behind, 2.0 * jnp.sqrt(d2 * 1e8), c)
    return jnp.sum(jnp.where(activeT, c, 0.0))


@functools.partial(
    jax.jit,
    static_argnames=("fx", "fy", "cx", "cy", "bf", "iters_first",
                     "iters_second"),
)
def bundle_adjust_grid(prob: GridBAProblem, *, fx: float, fy: float,
                       cx: float, cy: float, bf: float,
                       iters_first: int = 5, iters_second: int = 10):
    """Two-phase LM (5 its -> chi2 cut -> 10 its) like the reference
    schedule (src/orboptimizer.cpp:681-730), scatter- and gather-free in
    the iteration loop, with a convergence early-exit (g2o terminates on
    vanishing gain too).

    The whole iteration works on SCALARIZED component arrays [KW, PL] /
    [KO, PL] / [PL] — residuals, the 18 pose-Jacobian and 9 landmark-
    Jacobian components, every normal-equation block — so nothing with
    tiny minor dims ever materializes (see _scalar_residuals).  The only
    dense products are the three [6*KO, PL] @ [PL, 6*KO] Schur coupling
    matmuls and the [6*KO, 6*KO] solve."""
    KW, F = prob.g_pt.shape
    KO = prob.n_opt
    PL = prob.pts.shape[0]
    T_fix = prob.T_all[KO:]
    delta_mono = jnp.sqrt(CHI2_MONO)
    delta_stereo = jnp.sqrt(CHI2_STEREO)

    # one-time transposition into the [KW, PL] compute layout
    o_uT = prob.o_uv[..., 0].T
    o_vT = prob.o_uv[..., 1].T
    o_qT = prob.o_ur.T
    infoT = 1.0 / prob.o_sigma2.T
    obs_okT = (prob.obs_table >= 0).T
    base_activeT = (
        obs_okT & prob.o_valid.T
        & prob.pt_valid[None, :]
        & prob.kf_valid[:, None]
    )
    free_k = prob.pose_free                                 # [KO]
    pt_ok = prob.pt_valid                                   # [PL]
    eye6 = jnp.eye(6, dtype=prob.pts.dtype)
    eyeK = jnp.eye(KO, dtype=prob.pts.dtype)

    def robust_cost(T_opt, pts, activeT):
        T_all = jnp.concatenate([T_opt, T_fix], axis=0)
        return _scalar_cost(T_all, pts, o_uT, o_vT, o_qT, infoT, activeT,
                            fx, fy, cx, cy, bf)

    def lm_phase(T_opt, pts, activeT, n_iters):
        def body(carry):
            it, T_opt, pts, lam, prev_cost, _ = carry
            T_all = jnp.concatenate([T_opt, T_fix], axis=0)
            x, y, z, iz, st, behind, r_u, r_v, r_q, R = _scalar_residuals(
                T_all, pts, o_uT, o_vT, o_qT, fx, fy, cx, cy, bf
            )
            iz2 = iz * iz
            ok = activeT & (~behind)
            chi2 = (r_u * r_u + r_v * r_v + r_q * r_q) * infoT
            chi = jnp.sqrt(jnp.maximum(chi2, 1e-12))
            delta = jnp.where(st, delta_stereo, delta_mono)
            huber_w = jnp.where(chi <= delta, 1.0, delta / chi)
            w = jnp.where(ok, huber_w * infoT, 0.0)          # [KW, PL]
            w_q = jnp.where(st, w, 0.0)

            zeros = jnp.zeros_like(z)
            # pose-Jacobian rows (translation cols 0-2, rotation cols 3-5)
            Ju = (-fx * iz, zeros, fx * x * iz2,
                  fx * x * y * iz2, -fx * (1.0 + x * x * iz2), fx * y * iz)
            Jv = (zeros, -fy * iz, fy * y * iz2,
                  fy * (1.0 + y * y * iz2), -fy * x * y * iz2, -fy * x * iz)
            Jq = (Ju[0], Ju[1], Ju[2] - bf * iz2,
                  Ju[3] - bf * iz2 * y, Ju[4] + bf * iz2 * x, Ju[5])
            # landmark-Jacobian rows: Jl[r][l] = -(d_pix[r] . R[:, l])
            du = (fx * iz, zeros, -fx * x * iz2)
            dv = (zeros, fy * iz, -fy * y * iz2)
            dq = (du[0], du[1], du[2] + bf * iz2)
            Rc = [[R[:, c, l][:, None] for l in range(3)] for c in range(3)]
            Jl_u = [-(du[0] * Rc[0][l] + du[1] * Rc[1][l] + du[2] * Rc[2][l])
                    for l in range(3)]
            Jl_v = [-(dv[0] * Rc[0][l] + dv[1] * Rc[1][l] + dv[2] * Rc[2][l])
                    for l in range(3)]
            Jl_q = [-(dq[0] * Rc[0][l] + dq[1] * Rc[1][l] + dq[2] * Rc[2][l])
                    for l in range(3)]
            rows = ((w, Ju, r_u, Jl_u), (w, Jv, r_v, Jl_v),
                    (w_q, Jq, r_q, Jl_q))

            # pose blocks over the optimizable window only
            Hpp = jnp.stack([jnp.stack([
                sum(jnp.sum((wr * Jr[i] * Jr[j])[:KO], axis=-1)
                    for (wr, Jr, _, _) in rows)
                for j in range(6)], -1) for i in range(6)], -2)  # [KO,6,6]
            b_p = jnp.stack([
                -sum(jnp.sum((wr * Jr[i] * rr)[:KO], axis=-1)
                     for (wr, Jr, rr, _) in rows)
                for i in range(6)], -1)                          # [KO, 6]

            # landmark blocks (entries as [PL] arrays)
            Hll = [[sum(jnp.sum(wr * Jlr[a] * Jlr[b], axis=0)
                        for (wr, _, _, Jlr) in rows)
                    for b in range(3)] for a in range(3)]
            b_l = [-sum(jnp.sum(wr * Jlr[a] * rr, axis=0)
                        for (wr, _, rr, Jlr) in rows) for a in range(3)]
            b_l = [jnp.where(pt_ok, bl, 0.0) for bl in b_l]

            # coupling blocks [KO, PL] per (pose-col i, landmark-col l)
            Hpl = [[sum((wr * Jr[i] * Jlr[l])[:KO]
                        for (wr, Jr, _, Jlr) in rows)
                    for l in range(3)] for i in range(6)]

            # damped 3x3 landmark inverse (analytic, per point)
            a00 = Hll[0][0] + lam
            a11 = Hll[1][1] + lam
            a22 = Hll[2][2] + lam
            a01, a02, a12 = Hll[0][1], Hll[0][2], Hll[1][2]
            c00 = a11 * a22 - a12 * a12
            c01 = a02 * a12 - a01 * a22
            c02 = a01 * a12 - a02 * a11
            c11 = a00 * a22 - a02 * a02
            c12 = a01 * a02 - a00 * a12
            c22 = a00 * a11 - a01 * a01
            det = a00 * c00 + a01 * c01 + a02 * c02
            idet = jnp.where(pt_ok & (jnp.abs(det) > 1e-12),
                             1.0 / jnp.where(jnp.abs(det) > 1e-12, det, 1.0),
                             0.0)
            Hinv = [[c00 * idet, c01 * idet, c02 * idet],
                    [c01 * idet, c11 * idet, c12 * idet],
                    [c02 * idet, c12 * idet, c22 * idet]]

            # A[i][l] = sum_j Hpl[i][j] Hinv[j][l]  : [KO, PL]
            A = [[sum(Hpl[i][j] * Hinv[j][l][None, :] for j in range(3))
                  for l in range(3)] for i in range(6)]

            # Schur coupling S_off[(i,k),(m,q)] = sum_{p,l} A.Hpl — three
            # [6*KO, PL] @ [PL, 6*KO] matmuls (i-major flattening)
            S_off = 0.0
            for l in range(3):
                Al = jnp.concatenate([A[i][l] for i in range(6)], 0)
                Hl = jnp.concatenate([Hpl[m][l] for m in range(6)], 0)
                S_off = S_off + Al @ Hl.T                        # [48, 48]

            # damped/frozen pose blocks, i-major block-diagonal embed
            Hpp_d = Hpp + lam * eye6[None]
            Hpp_d = jnp.where(free_k[:, None, None], Hpp_d, eye6[None])
            b_p_m = jnp.where(free_k[:, None], b_p, 0.0)
            # i-major: index = i * KO + k
            Hpp_im = jnp.einsum("kij,kq->ikjq", Hpp_d, eyeK).reshape(
                KO * 6, KO * 6
            )
            S_off = jnp.where(
                free_k[None, :, None, None].repeat(6, 0).reshape(KO * 6)[
                    :, None
                ] & free_k[None, :, None, None].repeat(6, 0).reshape(KO * 6)[
                    None, :
                ],
                S_off, 0.0,
            )
            S = Hpp_im - S_off
            rhs = (
                b_p_m.T.reshape(-1)
                - jnp.stack([jnp.sum(
                    sum(A[i][l] * b_l[l][None, :] for l in range(3)),
                    axis=-1) for i in range(6)], 0).reshape(-1)
            )
            rhs = jnp.where(
                free_k[None, :].repeat(6, 0).reshape(-1), rhs, 0.0
            )

            dx = jnp.linalg.solve(S + 1e-8 * eye6[0, 0] * jnp.eye(KO * 6),
                                  rhs)
            dx = jnp.where(jnp.all(jnp.isfinite(dx)), dx, 0.0)
            dx6 = dx.reshape(6, KO)                              # [i, k]

            # back-substitute landmarks
            Wt = [sum(jnp.sum(Hpl[i][l] * dx6[i][:, None], axis=0)
                      for i in range(6)) for l in range(3)]
            dxl = [sum(Hinv[l][j] * (b_l[j] - Wt[j]) for j in range(3))
                   for l in range(3)]

            dx_c6 = dx6.T                                        # [KO, 6]
            T_new = jax.vmap(lambda d, T: lie.exp_se3(d) @ T)(dx_c6, T_opt)
            T_new = jnp.where(free_k[:, None, None], T_new, T_opt)
            pts_new = pts + jnp.where(
                pt_ok[:, None], jnp.stack(dxl, -1), 0.0
            )

            new_cost = robust_cost(T_new, pts_new, activeT)
            accept = new_cost < prev_cost
            T_keep = jnp.where(accept, T_new, T_opt)
            pts_keep = jnp.where(accept, pts_new, pts)
            lam_next = jnp.clip(
                jnp.where(accept, lam * 0.5, lam * 4.0), 1e-8, 1e4
            )
            cost_keep = jnp.where(accept, new_cost, prev_cost)
            # convergence: an accepted step whose relative improvement is
            # negligible ends the phase (further iterations are numeric
            # no-ops; g2o's terminate action uses the same gain test)
            done = accept & (
                (prev_cost - new_cost) <= 1e-4 * jnp.maximum(prev_cost, 1e-6)
            )
            return (it + 1, T_keep, pts_keep, lam_next, cost_keep, done)

        def cond(carry):
            it, _, _, _, _, done = carry
            return (it < n_iters) & (~done)

        init_cost = robust_cost(T_opt, pts, activeT)
        _, T_opt, pts, _, cost, _ = jax.lax.while_loop(
            cond, body,
            (jnp.int32(0), T_opt, pts,
             jnp.asarray(1e-4, T_opt.dtype), init_cost, jnp.bool_(False)),
        )
        return T_opt, pts, cost

    T_opt0 = prob.T_all[:KO]
    T_opt, pts, _ = lm_phase(T_opt0, prob.pts, base_activeT, iters_first)

    # chi2 outlier cut between phases (residuals only, [KW, PL] layout)
    T_all = jnp.concatenate([T_opt, T_fix], axis=0)
    _, _, _, _, st, behind, r_u, r_v, r_q, _ = _scalar_residuals(
        T_all, pts, o_uT, o_vT, o_qT, fx, fy, cx, cy, bf
    )
    chi2 = (r_u * r_u + r_v * r_v + r_q * r_q) * infoT
    th = jnp.where(st, CHI2_STEREO, CHI2_MONO)
    activeT = base_activeT & (chi2 <= th) & (~behind)

    T_opt, pts, cost = lm_phase(T_opt, pts, activeT, iters_second)

    # final PER-FEATURE inlier gate on the [KW, F] grid (drives observation
    # erasure in the caller) — one grid evaluation after the solve
    T_all = jnp.concatenate([T_opt, T_fix], axis=0)
    rg, _, _, st_g, behind_g = _grid_terms(
        T_all, pts, prob, fx, fy, cx, cy, bf
    )
    chi2_g = _grid_chi2(rg, prob.g_sigma2, st_g)
    th_g = jnp.where(st_g, CHI2_STEREO, CHI2_MONO)
    g_active = (
        prob.g_valid
        & jnp.take(prob.pt_valid, jnp.clip(prob.g_pt, 0, PL - 1))
        & prob.kf_valid[:, None]
    )
    inlier = g_active & (chi2_g <= th_g) & (~behind_g)
    cost = robust_cost(T_opt, pts, activeT)
    return GridBAResult(T_opt=T_opt, pts=pts, grid_inlier=inlier, cost=cost)

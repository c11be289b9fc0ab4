"""Pose-graph optimization (essential graph) as dense batched Gauss-Newton.

Replaces OptimizeEssentialGraph (reference: src/orboptimizer.cpp:799-1061):
g2o **Sim3** vertices (7-DoF) with loop / spanning-tree / strong-covisibility
edges, LM iterations, then SE3 recovery with ``t/s`` (reference:
:1044-1052).  The stereo/RGB-D path fixes scale (``_fix_scale``, reference:
:830) which reduces the vertices to SE3; the monocular path keeps the scale
column active so loop closure can absorb scale drift — the core reason the
reference uses Sim3 at all.

Array shape: all K vertex states live in one ``[K, 7]`` tangent update
(rho, phi, sigma); per-edge 7x14 Jacobians come from forward-mode autodiff
of the relative-similarity residual (no hand-derived Sim3 adjoints to get
wrong), the normal system assembles by scatter-add of 4 blocks per edge into
a dense ``[7K, 7K]`` matrix — small for any realistic keyframe count — and
solves densely.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..ops import lie


class PoseGraphProblem(NamedTuple):
    T: jnp.ndarray          # [K, 4, 4] initial vertex poses (T_cw, SE3)
    v_valid: jnp.ndarray    # [K] bool
    v_fixed: jnp.ndarray    # [K] bool (loop KF is fixed, reference :858)
    e_i: jnp.ndarray        # [E] int32 source vertex
    e_j: jnp.ndarray        # [E] int32 target vertex
    e_T_ij: jnp.ndarray     # [E, 4, 4] measured relative pose T_i * T_j^-1
    e_weight: jnp.ndarray   # [E] float32 information scale
    e_valid: jnp.ndarray    # [E] bool
    scale: Optional[jnp.ndarray] = None   # [K] initial vertex scales (1.0)
    e_s_ij: Optional[jnp.ndarray] = None  # [E] measured relative scales (1.0)


def _sim3_update(dx, R, t, s):
    """Retraction: left-compose the tangent (rho, phi, sigma) onto (R,t,s)."""
    return (
        lie.exp_so3(dx[3:6]) @ R,
        t + dx[:3],
        s * jnp.exp(dx[6]),
    )


def edge_residual(dx_i, dx_j, T_i, s_i, T_j, s_j, T_ij, s_ij):
    """7-vector residual of S_ij_meas ∘ S_j ∘ S_i^-1 against identity:
    (t_err, log_so3(R_err), log(s_err)).  Vanishes iff the measured relative
    similarity matches the vertices; a smooth local parameterization with
    the same zero set as g2o's Sim3 log residual."""
    Ri, ti, si = _sim3_update(dx_i, T_i[:3, :3], T_i[:3, 3], s_i)
    Rj, tj, sj = _sim3_update(dx_j, T_j[:3, :3], T_j[:3, 3], s_j)
    Rji, tji, sji = lie.sim3_inverse(Ri, ti, si)
    Rm, tm, sm = lie.sim3_compose(
        T_ij[:3, :3], T_ij[:3, 3], s_ij, Rj, tj, sj
    )
    Re, te, se = lie.sim3_compose(Rm, tm, sm, Rji, tji, sji)
    return jnp.concatenate([te, lie.log_so3(Re), jnp.log(se)[None]])


@functools.partial(jax.jit, static_argnames=("n_iters", "fix_scale"))
def optimize_pose_graph(prob: PoseGraphProblem, n_iters: int = 20,
                        fix_scale: bool = True):
    """Returns ``(T [K, 4, 4] SE3-recovered poses, scale [K])``.

    ``fix_scale=True`` pins every vertex's scale (stereo/RGB-D, reference
    _fix_scale); ``False`` lets loop edges with measured scale redistribute
    scale drift along the graph (monocular).  SE3 recovery divides the
    translation by the optimized scale (reference: src/orboptimizer.cpp:
    1044-1052).
    """
    K = prob.T.shape[0]
    D = 7
    s0 = prob.scale if prob.scale is not None else jnp.ones((K,), prob.T.dtype)
    es = (
        prob.e_s_ij if prob.e_s_ij is not None
        else jnp.ones((prob.e_i.shape[0],), prob.T.dtype)
    )

    def iteration(state, _):
        T_all, s_all = state
        T_i = jnp.take(T_all, prob.e_i, axis=0)
        T_j = jnp.take(T_all, prob.e_j, axis=0)
        s_i = jnp.take(s_all, prob.e_i)
        s_j = jnp.take(s_all, prob.e_j)
        zeros = jnp.zeros((prob.e_i.shape[0], D), T_all.dtype)

        r = jax.vmap(edge_residual)(zeros, zeros, T_i, s_i, T_j, s_j,
                                    prob.e_T_ij, es)
        J_i = jax.vmap(
            jax.jacfwd(edge_residual, argnums=0)
        )(zeros, zeros, T_i, s_i, T_j, s_j, prob.e_T_ij, es)   # [E, 7, 7]
        J_j = jax.vmap(
            jax.jacfwd(edge_residual, argnums=1)
        )(zeros, zeros, T_i, s_i, T_j, s_j, prob.e_T_ij, es)

        free_i = jnp.take(prob.v_valid & ~prob.v_fixed, prob.e_i)
        free_j = jnp.take(prob.v_valid & ~prob.v_fixed, prob.e_j)
        w = jnp.where(prob.e_valid, prob.e_weight, 0.0)
        J_i = J_i * (w * free_i)[:, None, None]
        J_j = J_j * (w * free_j)[:, None, None]
        if fix_scale:
            # freezing sigma means removing its COLUMN from the linear
            # system (else the solved 6-DoF step assumes sigma moves and
            # clamping it afterwards corrupts the step)
            J_i = J_i.at[:, :, D - 1].set(0.0)
            J_j = J_j.at[:, :, D - 1].set(0.0)
        rw = r * w[:, None]

        H = jnp.zeros((K, D, K, D), T_all.dtype)
        H = H.at[prob.e_i, :, prob.e_i, :].add(
            jnp.einsum("eri,erj->eij", J_i, J_i)
        )
        H = H.at[prob.e_j, :, prob.e_j, :].add(
            jnp.einsum("eri,erj->eij", J_j, J_j)
        )
        H = H.at[prob.e_i, :, prob.e_j, :].add(
            jnp.einsum("eri,erj->eij", J_i, J_j)
        )
        H = H.at[prob.e_j, :, prob.e_i, :].add(
            jnp.einsum("eri,erj->eij", J_j, J_i)
        )
        b = jnp.zeros((K, D), T_all.dtype)
        b = b.at[prob.e_i].add(-jnp.einsum("eri,er->ei", J_i, rw))
        b = b.at[prob.e_j].add(-jnp.einsum("eri,er->ei", J_j, rw))

        # pin fixed/invalid vertices with identity blocks
        free = prob.v_valid & ~prob.v_fixed
        eyeD = jnp.eye(D, dtype=T_all.dtype)
        diag_fix = jnp.where(free[:, None, None], 0.0, eyeD[None])
        idx = jnp.arange(K)
        H = H.at[idx, :, idx, :].add(diag_fix + 1e-6 * eyeD[None])
        # Levenberg-Marquardt damping RELATIVE to the diagonal (g2o runs LM
        # here too, reference: src/orboptimizer.cpp:799-840).  Pure GN with
        # only an absolute 1e-6 floor can diverge: long chains of degree-2
        # vertices make the [7K, 7K] system ill-conditioned enough that an
        # f32 LU solve emits garbage steps for exactly those vertices.
        diag = H.reshape(K * D, K * D).diagonal().reshape(K, D)
        H = H.at[idx[:, None], jnp.arange(D)[None, :],
                 idx[:, None], jnp.arange(D)[None, :]].add(1e-3 * diag)
        if fix_scale:
            # pin every sigma component (reference _fix_scale: Sim3 vertices
            # with the scale coordinate frozen)
            H = H.at[idx, D - 1, idx, D - 1].add(1.0)
        b = jnp.where(free[:, None], b, 0.0)
        if fix_scale:
            b = b.at[:, D - 1].set(0.0)

        dx = jnp.linalg.solve(H.reshape(K * D, K * D), b.reshape(K * D))
        dx = jnp.where(jnp.all(jnp.isfinite(dx)), dx, 0.0).reshape(K, D)
        dx = jnp.where(free[:, None], dx, 0.0)
        if fix_scale:
            dx = dx.at[:, D - 1].set(0.0)

        R_new = jax.vmap(lambda d, T: lie.exp_so3(d[3:6]) @ T[:3, :3])(
            dx, T_all
        )
        t_new = T_all[:, :3, 3] + dx[:, :3]
        T_new = jax.vmap(lie.make_T)(R_new, t_new)
        s_new = s_all * jnp.exp(dx[:, D - 1])
        return (T_new, s_new), None

    (T_out, s_out), _ = jax.lax.scan(
        iteration, (prob.T, s0), None, length=n_iters
    )
    # SE3 recovery: t / s (reference: src/orboptimizer.cpp:1044-1052)
    T_se3 = T_out.at[:, :3, 3].set(T_out[:, :3, 3] / s_out[:, None])
    return T_se3, s_out


def relative_pose(T_i, T_j):
    """Measured edge transform ``T_ij = T_i * T_j^-1``."""
    return T_i @ lie.inv_T(T_j)

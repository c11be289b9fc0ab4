"""Global bundle adjustment: matrix-free Schur complement + conjugate gradient.

Replaces GlobalBundleAdjustemnt/RunGlobalBundleAdjustment (reference:
src/orboptimizer.cpp:47-52, src/loopclosing.cpp:645-750).  The local BA in
optim/ba.py materializes the camera-landmark coupling ``W = Hpl`` densely —
fine for a covisibility window, impossible for a full map (K x P blocks).
Here the reduced camera system solves *matrix-free*:

    S v = Hpp v - W Hll^-1 W^T v

where every term evaluates as batched per-edge einsums + segment-sum
scatters (never forming W), and S is solved by block-Jacobi-preconditioned
CG.  Per CG iteration the work is O(E) small einsums — exactly the shape an
accelerator runs well, and exactly the computation that shards over a device mesh with
one psum per reduction (parallel/sharded_ba.py reuses these edge passes).

Abortability parity: the reference's GBA can be interrupted by a new loop
(``mbStopGBA``, reference: src/loopclosing.cpp:409-420); here the host can
simply drop the result of the jitted call or run fewer outer iterations —
state is functional, nothing to unwind.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops import lie
from .ba import BAProblem, CHI2_MONO, CHI2_STEREO, _edge_chi2, _edge_residuals, _inv3x3


def _edge_terms(T_all, pts, prob: BAProblem, fx, fy, cx, cy, bf, pose_free):
    """Residuals/Jacobians + robust row weights for all edges."""
    r, J_pose, J_pt, is_stereo, behind = _edge_residuals(
        T_all, pts, prob, fx, fy, cx, cy, bf
    )
    active = (
        prob.e_valid
        & jnp.take(prob.pt_valid, prob.e_pt)
        & (~behind)
    )
    chi = jnp.sqrt(jnp.maximum(_edge_chi2(r, prob.e_sigma2, is_stereo), 1e-12))
    delta = jnp.where(
        is_stereo, jnp.sqrt(CHI2_STEREO), jnp.sqrt(CHI2_MONO)
    )
    huber_w = jnp.where(chi <= delta, 1.0, delta / chi)
    w = jnp.where(active, huber_w / prob.e_sigma2, 0.0)
    row_w = (
        jnp.stack(
            [jnp.ones_like(w), jnp.ones_like(w),
             jnp.where(is_stereo, 1.0, 0.0)], axis=-1
        )
        * w[:, None]
    )
    # pose Jacobians masked for non-free poses
    Ko = pose_free.shape[0]
    on_free = (prob.e_kf < Ko) & jnp.take(
        jnp.concatenate([pose_free, jnp.zeros_like(prob.fix_valid)]), prob.e_kf
    )
    J_pose = J_pose * on_free[:, None, None]
    kf_idx = jnp.where(on_free, prob.e_kf, 0)
    return r, J_pose, J_pt, row_w, kf_idx, active


def _identity(x):
    return x


def gba_core(prob: BAProblem, *, fx: float, fy: float, cx: float,
             cy: float, bf: float, n_outer: int = 10,
             cg_iters: int = 40, fix_first_pose: bool = True,
             reduce_fn=_identity, init_carry=None, return_carry=False):
    """LM with matrix-free Schur-CG inner solves.  Returns (T_opt, pts, cost).

    ``reduce_fn`` is applied to every edge-reduction result ([Ko,6] / [P,3] /
    block tensors and scalars).  Single-device: identity.  Sharded: the
    edges split across a mesh axis and ``reduce_fn = psum`` — that ONE hook
    is the entire distribution story (parallel/sharded_ba.py).

    ``init_carry``/``return_carry`` expose the LM state ``(T_opt, pts, lam,
    cost)`` so the host can run the solve in bounded chunks between frames —
    the functional-state version of the reference's abortable detached GBA
    thread (reference: src/loopclosing.cpp:576-580, 645-750).
    """
    Ko = prob.T_opt.shape[0]
    P = prob.pts.shape[0]
    pose_free = prob.opt_valid
    if fix_first_pose:
        pose_free = pose_free.at[0].set(False)

    def robust_cost(T_opt, pts):
        T_all = jnp.concatenate([T_opt, prob.T_fix], axis=0)
        r, _, _, is_stereo, behind = _edge_residuals(
            T_all, pts, prob, fx, fy, cx, cy, bf
        )
        active = prob.e_valid & jnp.take(prob.pt_valid, prob.e_pt) & (~behind)
        chi2 = _edge_chi2(r, prob.e_sigma2, is_stereo)
        d2 = jnp.where(is_stereo, CHI2_STEREO, CHI2_MONO)
        c = jnp.where(chi2 <= d2, chi2, 2.0 * jnp.sqrt(d2 * chi2) - d2)
        return reduce_fn(jnp.sum(jnp.where(active, c, 0.0)))

    def outer(carry, _):
        T_opt, pts, lam, prev_cost = carry
        T_all = jnp.concatenate([T_opt, prob.T_fix], axis=0)
        r, Jp, Jl, row_w, kf_idx, active = _edge_terms(
            T_all, pts, prob, fx, fy, cx, cy, bf, pose_free
        )
        e_pt = prob.e_pt

        # gradient blocks
        b_p = reduce_fn(jnp.zeros((Ko, 6), r.dtype).at[kf_idx].add(
            -jnp.einsum("eri,er->ei", Jp, row_w * r)
        ))
        b_l = reduce_fn(jnp.zeros((P, 3), r.dtype).at[e_pt].add(
            -jnp.einsum("eri,er->ei", Jl, row_w * r)
        ))
        b_l = jnp.where(prob.pt_valid[:, None], b_l, 0.0)

        # landmark blocks + damping
        Hll = reduce_fn(jnp.zeros((P, 3, 3), r.dtype).at[e_pt].add(
            jnp.einsum("eri,er,erj->eij", Jl, row_w, Jl)
        ))
        Hll = Hll + lam * jnp.eye(3, dtype=r.dtype)[None]
        Hll = jnp.where(
            prob.pt_valid[:, None, None], Hll, jnp.eye(3, dtype=r.dtype)[None]
        )
        Hll_inv = _inv3x3(Hll)

        # pose diagonal blocks (for Hpp·v and the preconditioner)
        Hpp = reduce_fn(jnp.zeros((Ko, 6, 6), r.dtype).at[kf_idx].add(
            jnp.einsum("eri,er,erj->eij", Jp, row_w, Jp)
        ))
        Hpp = Hpp + lam * jnp.eye(6, dtype=r.dtype)[None]
        Hpp = jnp.where(
            pose_free[:, None, None], Hpp, jnp.eye(6, dtype=r.dtype)[None]
        )
        M_inv = jnp.linalg.inv(Hpp)  # block-Jacobi preconditioner [Ko,6,6]

        def Wt_v(v):
            """W^T v: [Ko,6] -> [P,3] (edge pass)."""
            t = jnp.einsum("eri,ei->er", Jp, v[kf_idx]) * row_w
            return reduce_fn(jnp.zeros((P, 3), r.dtype).at[e_pt].add(
                jnp.einsum("eri,er->ei", Jl, t)
            ))

        def W_y(y):
            """W y: [P,3] -> [Ko,6] (edge pass)."""
            t = jnp.einsum("eri,ei->er", Jl, y[e_pt]) * row_w
            return reduce_fn(jnp.zeros((Ko, 6), r.dtype).at[kf_idx].add(
                jnp.einsum("eri,er->ei", Jp, t)
            ))

        def S_v(v):
            hv = jnp.einsum("kij,kj->ki", Hpp, v)
            y = jnp.einsum("pij,pj->pi", Hll_inv, Wt_v(v))
            y = jnp.where(prob.pt_valid[:, None], y, 0.0)
            return hv - W_y(y)

        rhs = b_p - W_y(
            jnp.where(
                prob.pt_valid[:, None],
                jnp.einsum("pij,pj->pi", Hll_inv, b_l), 0.0,
            )
        )
        rhs = jnp.where(pose_free[:, None], rhs, 0.0)

        # preconditioned CG on S dx = rhs
        def precond(x):
            return jnp.einsum("kij,kj->ki", M_inv, x)

        def cg_body(state, _):
            x, res, z, p_dir, rz = state
            Ap = S_v(p_dir)
            alpha = rz / jnp.maximum(jnp.sum(p_dir * Ap), 1e-12)
            x = x + alpha * p_dir
            res = res - alpha * Ap
            z = precond(res)
            rz_new = jnp.sum(res * z)
            beta = rz_new / jnp.maximum(rz, 1e-12)
            p_dir = z + beta * p_dir
            return (x, res, z, p_dir, rz_new), None

        x0 = jnp.zeros_like(rhs)
        z0 = precond(rhs)
        (dx_c, *_), _ = jax.lax.scan(
            cg_body, (x0, rhs, z0, z0, jnp.sum(rhs * z0)), None,
            length=cg_iters,
        )
        dx_c = jnp.where(jnp.all(jnp.isfinite(dx_c)), dx_c, 0.0)
        dx_c = jnp.where(pose_free[:, None], dx_c, 0.0)

        # back-substitute landmarks
        dx_l = jnp.einsum("pij,pj->pi", Hll_inv, b_l - Wt_v(dx_c))
        dx_l = jnp.where(prob.pt_valid[:, None], dx_l, 0.0)

        T_new = jax.vmap(lambda d, T: lie.exp_se3(d) @ T)(dx_c, T_opt)
        T_new = jnp.where(pose_free[:, None, None], T_new, T_opt)
        pts_new = pts + dx_l

        new_cost = robust_cost(T_new, pts_new)
        accept = new_cost < prev_cost
        T_keep = jnp.where(accept, T_new, T_opt)
        pts_keep = jnp.where(accept, pts_new, pts)
        lam2 = jnp.clip(jnp.where(accept, lam * 0.5, lam * 4.0), 1e-8, 1e4)
        cost2 = jnp.where(accept, new_cost, prev_cost)
        return (T_keep, pts_keep, lam2, cost2), None

    if init_carry is None:
        init = (prob.T_opt, prob.pts, jnp.asarray(1e-4, prob.T_opt.dtype),
                robust_cost(prob.T_opt, prob.pts))
    else:
        init = init_carry
    carry, _ = jax.lax.scan(outer, init, None, length=n_outer)
    if return_carry:
        return carry
    T_opt, pts, _, cost = carry
    return T_opt, pts, cost


@functools.partial(
    jax.jit,
    static_argnames=("fx", "fy", "cx", "cy", "bf", "n_outer", "cg_iters",
                     "fix_first_pose"),
)
def global_bundle_adjust(prob: BAProblem, *, fx: float, fy: float, cx: float,
                         cy: float, bf: float, n_outer: int = 10,
                         cg_iters: int = 40, fix_first_pose: bool = True):
    """Single-device entry point (see gba_core)."""
    return gba_core(
        prob, fx=fx, fy=fy, cx=cx, cy=cy, bf=bf, n_outer=n_outer,
        cg_iters=cg_iters, fix_first_pose=fix_first_pose,
    )


@functools.partial(
    jax.jit,
    static_argnames=("fx", "fy", "cx", "cy", "bf", "n_outer", "cg_iters",
                     "fix_first_pose"),
)
def global_bundle_adjust_chunk(prob: BAProblem, carry, *, fx: float,
                               fy: float, cx: float, cy: float, bf: float,
                               n_outer: int = 1, cg_iters: int = 40,
                               fix_first_pose: bool = True):
    """Run ``n_outer`` LM iterations from an explicit ``(T, pts, lam, cost)``
    carry and return the new carry — the bounded-work step of the
    incremental (non-blocking) GBA.  Pass ``carry=None`` shapes via
    :func:`gba_init_carry` first."""
    return gba_core(
        prob, fx=fx, fy=fy, cx=cx, cy=cy, bf=bf, n_outer=n_outer,
        cg_iters=cg_iters, fix_first_pose=fix_first_pose,
        init_carry=carry, return_carry=True,
    )


def gba_init_carry(prob: BAProblem):
    """Initial LM carry for :func:`global_bundle_adjust_chunk` (cost starts
    at +inf so the first chunk's accept test always fires)."""
    return (prob.T_opt, prob.pts, jnp.asarray(1e-4, prob.T_opt.dtype),
            jnp.asarray(jnp.inf, prob.T_opt.dtype))

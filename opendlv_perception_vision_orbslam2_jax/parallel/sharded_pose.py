"""Observation-sharded pose optimization over a device mesh.

The reference has no distributed compute at all (single-process pthreads,
SURVEY.md section 2.3 P8); this module is the new parallelism a multi-device
host allows: reprojection residual/Jacobian evaluation shards over the
observation axis, each device reduces its local 6x6 normal-equation block,
and an ``psum`` over the mesh assembles the global system — the exact
pattern the sharded bundle adjuster scales up (camera systems via psum,
landmark blocks local to their shard).

Uses ``shard_map`` so the collective schedule is explicit (one psum per GN
step, over NVLink on a host of GPUs).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..ops import lie
from ..optim.pose_opt import PoseObs, _residuals_jacobian, _chi2, CHI2_MONO, CHI2_STEREO


def pad_obs_to_multiple(obs: PoseObs, n_shards: int) -> PoseObs:
    """Pad observation slots so the leading axis divides the mesh size."""
    k = obs.p_w.shape[0]
    rem = (-k) % n_shards
    if rem == 0:
        return obs
    pad = lambda a, fill=0: jnp.concatenate(
        [a, jnp.full((rem,) + a.shape[1:], fill, a.dtype)], axis=0
    )
    return PoseObs(
        p_w=pad(obs.p_w),
        uv=pad(obs.uv),
        u_right=pad(obs.u_right, -1),
        sigma2=pad(obs.sigma2, 1),
        valid=pad(obs.valid, False),
    )


def make_sharded_pose_optimizer(mesh: Mesh, axis: str, *, fx, fy, cx, cy, bf,
                                n_iters: int = 10, n_rounds: int = 4):
    """Build a jitted pose optimizer whose observations shard over ``axis``.

    Full ``pose_optimize`` semantics (the reference's PoseOptimization
    schedule, src/orboptimizer.cpp:379-452): ``n_rounds`` rounds of up to
    ``n_iters`` GN steps with chi2 inlier reclassification between rounds
    and the Huber kernel dropped from round 3 — so the production tracker
    can swap this in verbatim when more than one device is present.

    Returns ``fn(T_cw_init, obs) -> (T_cw, inlier_mask, n_inliers)``; every
    leaf of ``obs`` shards on its leading axis, ``inlier_mask`` comes back
    sharded the same way.  Per GN step the only collective is the psum of
    one 6x6 block + 6-vector over the mesh.
    """

    delta_mono = jnp.sqrt(CHI2_MONO)
    delta_stereo = jnp.sqrt(CHI2_STEREO)

    def local_normal_system(T, obs: PoseObs, inlier_mask, use_huber):
        r, J, is_stereo, behind = _residuals_jacobian(T, obs, fx, fy, cx, cy, bf)
        active = obs.valid & inlier_mask & (~behind)
        chi = jnp.sqrt(jnp.maximum(_chi2(r, obs.sigma2, is_stereo), 1e-12))
        delta = jnp.where(is_stereo, delta_stereo, delta_mono)
        huber_w = jnp.where(chi <= delta, 1.0, delta / chi)
        w = (1.0 / obs.sigma2) * jnp.where(use_huber, huber_w, 1.0)
        w = jnp.where(active, w, 0.0)
        row_w = jnp.stack(
            [jnp.ones_like(w), jnp.ones_like(w),
             jnp.where(is_stereo, 1.0, 0.0)], axis=-1
        ) * w[:, None]
        H = jnp.einsum("kri,kr,krj->ij", J, row_w, J)
        b = -jnp.einsum("kri,kr->i", J, row_w * r)
        return H, b

    def classify(T, obs: PoseObs):
        r, _, is_stereo, behind = _residuals_jacobian(T, obs, fx, fy, cx, cy, bf)
        chi2 = _chi2(r, obs.sigma2, is_stereo)
        th = jnp.where(is_stereo, CHI2_STEREO, CHI2_MONO)
        return obs.valid & (chi2 <= th) & (~behind)

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(), PoseObs(P(axis), P(axis), P(axis), P(axis), P(axis))),
        out_specs=(P(), P(axis), P()),
        check_vma=False,
    )
    def _sharded(T0, obs):
        def gn_round(T, inlier_mask, use_huber):
            def body(_, T):
                H_local, b_local = local_normal_system(
                    T, obs, inlier_mask, use_huber
                )
                # The one collective: 6x6 + 6 reduction over the mesh.
                H = jax.lax.psum(H_local, axis)
                b = jax.lax.psum(b_local, axis)
                dx = jnp.linalg.solve(H + 1e-5 * jnp.eye(6, dtype=H.dtype), b)
                dx = jnp.where(
                    jnp.all(jnp.isfinite(dx)), dx, jnp.zeros_like(dx)
                )
                return lie.exp_se3(dx) @ T

            return jax.lax.fori_loop(0, n_iters, body, T)

        T = T0
        inliers = jnp.ones_like(obs.valid)
        for rnd in range(n_rounds):
            T = gn_round(T, inliers, use_huber=rnd < 2)
            inliers = classify(T, obs)
        return T, inliers, jax.lax.psum(jnp.sum(inliers), axis)

    return jax.jit(_sharded)

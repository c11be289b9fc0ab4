"""Full-map global bundle adjustment extraction + write-back.

RunGlobalBundleAdjustment equivalent (reference: src/loopclosing.cpp:645-750):
after a loop correction, refine every keyframe pose and map point.  The
reference spawns a detached, abortable GBA thread and propagates results
through the spanning tree under the map lock; here the whole map converts to
one flat edge list (every [K, F] binding is an edge), the matrix-free
Schur-CG adjuster runs as a single device program, and write-back is a pure
array swap — abort = drop the result.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..ops import lie
from ..optim.ba import BAProblem
from ..optim.gba import global_bundle_adjust
from ..utils.config import SystemConfig
from .map_state import MapState, recompute_covisibility


@jax.jit
def extract_global_ba(m: MapState, scale_factor: float = 1.2) -> BAProblem:
    """All keyframes optimizable (oldest pinned by the caller's
    fix_first_pose through slot reordering is unnecessary: slot order is
    insertion order, and the reference fixes keyframe 0 too,
    reference: src/orboptimizer.cpp:84-86)."""
    K, F, P = m.kf_capacity, m.feat_capacity, m.pt_capacity
    bound = m.kf_feat_valid & (m.kf_obs_point >= 0) & m.kf_valid[:, None]
    e_kf = jnp.broadcast_to(
        jnp.arange(K, dtype=jnp.int32)[:, None], (K, F)
    ).reshape(-1)
    e_pt = jnp.clip(m.kf_obs_point, 0, P - 1).reshape(-1)
    sigma2 = jnp.power(
        jnp.float32(scale_factor), 2.0 * m.kf_octave.astype(jnp.float32)
    ).reshape(-1)
    return BAProblem(
        T_opt=m.kf_T_cw,
        opt_valid=m.kf_valid,
        T_fix=jnp.eye(4, dtype=jnp.float32)[None],
        fix_valid=jnp.zeros((1,), bool),
        pts=m.pt_pos,
        pt_valid=m.pt_valid,
        e_kf=e_kf,
        e_pt=e_pt,
        e_uv=m.kf_xy.reshape(-1, 2),
        e_ur=m.kf_uright.reshape(-1),
        e_sigma2=sigma2,
        e_valid=bound.reshape(-1),
    )


def run_global_ba(m: MapState, config: SystemConfig, n_outer: int = 10,
                  cg_iters: int = 40) -> MapState:
    cam = config.camera
    prob = extract_global_ba(m, config.orb.scale_factor)
    T_opt, pts, _ = global_bundle_adjust(
        prob, fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, bf=cam.bf,
        n_outer=n_outer, cg_iters=cg_iters, fix_first_pose=True,
    )
    m = m._replace(
        kf_T_cw=jnp.where(m.kf_valid[:, None, None], T_opt, m.kf_T_cw),
        pt_pos=jnp.where(m.pt_valid[:, None], pts, m.pt_pos),
    )
    return m._replace(covis=recompute_covisibility(m))


@jax.jit
def _merge_gba(m: MapState, T_new, pts_new, snap_T, snap_kf_id,
               snap_kf_valid, snap_pt_valid, snap_pt_first_kf_id):
    """Fold a finished GBA snapshot into the CURRENT map.

    Keyframes/points that existed at snapshot time take their optimized
    values; everything created since rides its anchor's correction — the
    array form of the reference's spanning-tree propagation after GBA
    (RunGlobalBundleAdjustment, reference: src/loopclosing.cpp:694-741:
    children get T_child * T_parent^-1 * T_parent_corrected, points ride
    their reference keyframe).
    """
    K = m.kf_capacity
    same_kf = m.kf_valid & snap_kf_valid & (m.kf_id == snap_kf_id)
    # per-slot correction of snapshot keyframes
    corr = jnp.einsum("kij,kjl->kil", T_new, jax.vmap(lie.inv_T)(snap_T))
    # anchor = newest snapshot keyframe still alive (temporal parent of all
    # keyframes added during the solve)
    anchor = jnp.argmax(jnp.where(same_kf, m.kf_id, -1))
    corr_a = corr[anchor]
    # new keyframes keep their relative pose to the anchor
    T_ride = jnp.einsum(
        "kij,jl->kil", m.kf_T_cw @ lie.inv_T(snap_T[anchor]), T_new[anchor]
    )
    kf_T = jnp.where(
        same_kf[:, None, None], T_new,
        jnp.where(m.kf_valid[:, None, None], T_ride, m.kf_T_cw),
    )

    same_pt = m.pt_valid & snap_pt_valid & (
        m.pt_first_kf_id == snap_pt_first_kf_id
    )
    # new points ride their reference keyframe's correction when that KF is
    # part of the snapshot, else the anchor's
    ref = jnp.clip(m.pt_ref_kf, 0, K - 1)
    ref_corr = jnp.where(same_kf[ref][:, None, None], corr[ref],
                         corr_a[None])
    # p' = inv(corr) p in world coords: corr maps old cam -> new cam; world
    # points move by T_wc_new @ T_cw_old = inv(T_new) @ snap_T ... per-ref:
    world_corr = jnp.einsum(
        "kij,kjl->kil", jax.vmap(lie.inv_T)(T_new), snap_T
    )
    wc = jnp.where(same_kf[ref][:, None, None], world_corr[ref],
                   world_corr[anchor][None])
    p_ride = jnp.einsum("pij,pj->pi", wc[:, :3, :3], m.pt_pos) + wc[:, :3, 3]
    pt_pos = jnp.where(
        same_pt[:, None], pts_new,
        jnp.where(m.pt_valid[:, None], p_ride, m.pt_pos),
    )
    m = m._replace(kf_T_cw=kf_T, pt_pos=pt_pos)
    return m._replace(covis=recompute_covisibility(m))


class IncrementalGBA:
    """Chunked full-map BA: one LM outer iteration per frame between
    tracking steps — the functional-state equivalent of the reference's
    detached, abortable GBA thread (P2; reference:
    src/loopclosing.cpp:576-580, 645-750).  A new loop closure simply drops
    the instance (abort = discard)."""

    def __init__(self, m: MapState, config: SystemConfig,
                 n_outer_total: int = 10, cg_iters: int = 40,
                 sharded: bool | None = None):
        """``sharded``: None = auto (edge-sharded when >1 local device);
        False forces the single-device solve (bitwise-deterministic chunking
        — psum order in the sharded path perturbs floats ~1e-3)."""
        import jax

        from ..optim.gba import gba_init_carry

        self.config = config
        self.prob = extract_global_ba(m, config.orb.scale_factor)
        self.carry = gba_init_carry(self.prob)
        self.iters_left = n_outer_total
        self.cg_iters = cg_iters
        self.snap_T = m.kf_T_cw
        self.snap_kf_id = m.kf_id
        self.snap_kf_valid = m.kf_valid
        self.snap_pt_valid = m.pt_valid
        self.snap_pt_first_kf_id = m.pt_first_kf_id
        # PRODUCTION multi-chip path (P8): with >1 local device the solve
        # runs edge-sharded over the full mesh — poses/landmarks replicate,
        # each reduction is one psum over the mesh (parallel/sharded_ba.py).
        self._sharded = None
        n_dev = jax.local_device_count()
        if sharded is False:
            n_dev = 1
        if n_dev > 1:
            import numpy as _np

            from ..parallel.sharded_ba import (
                make_sharded_gba_chunk,
                pad_edges_to_multiple,
                shard_problem,
            )
            from jax.sharding import Mesh

            cam = config.camera
            mesh = Mesh(
                _np.array(jax.devices()[:n_dev]).reshape(n_dev), ("edges",)
            )
            self.prob = pad_edges_to_multiple(self.prob, n_dev)
            self.prob = shard_problem(self.prob, mesh, "edges")
            self._sharded = make_sharded_gba_chunk(
                mesh, "edges", fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy,
                bf=cam.bf, n_outer=1, cg_iters=cg_iters,
            )

    def step(self) -> bool:
        """One bounded chunk; returns True when the solve is finished."""
        from ..optim.gba import global_bundle_adjust_chunk

        cam = self.config.camera
        if self._sharded is not None:
            self.carry = self._sharded(self.prob, self.carry)
        else:
            self.carry = global_bundle_adjust_chunk(
                self.prob, self.carry,
                fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, bf=cam.bf,
                n_outer=1, cg_iters=self.cg_iters,
            )
        self.iters_left -= 1
        return self.iters_left <= 0

    def merge(self, m: MapState) -> MapState:
        T_new, pts_new, _, _ = self.carry
        return _merge_gba(
            m, T_new, pts_new, self.snap_T, self.snap_kf_id,
            self.snap_kf_valid, self.snap_pt_valid,
            self.snap_pt_first_kf_id,
        )

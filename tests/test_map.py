"""MapState + local BA integration tests at the geometry level (no images)."""

import numpy as np
import jax.numpy as jnp

from opendlv_perception_vision_orbslam2_jax.models import map_state as ms
from opendlv_perception_vision_orbslam2_jax.models.frame import FrameState, empty_features
from opendlv_perception_vision_orbslam2_jax.models.local_mapping import (
    extract_local_ba,
    local_mapping_step,
)
from opendlv_perception_vision_orbslam2_jax.ops import lie
from opendlv_perception_vision_orbslam2_jax.utils.config import (
    CameraConfig,
    OrbConfig,
    SystemConfig,
)

CAM = CameraConfig(fx=320.0, fy=320.0, cx=256.0, cy=128.0, bf=160.0,
                   width=512, height=256)
CFG = SystemConfig(camera=CAM, orb=OrbConfig(max_keypoints=256))
F = 256  # feature capacity for these tests
N_PTS = 200


def _world(seed=0):
    rng = np.random.default_rng(seed)
    pts = np.stack(
        [rng.uniform(-10, 10, N_PTS), rng.uniform(-4, 4, N_PTS),
         rng.uniform(6, 40, N_PTS)], axis=-1,
    ).astype(np.float32)
    descs = rng.integers(0, 2**32, (N_PTS, 8), dtype=np.uint32)
    return pts, descs


def _synth_frame(T_cw, pts, descs, noise=0.0, seed=0):
    """FrameState whose feature i observes world point i."""
    rng = np.random.default_rng(seed)
    p_c = pts @ np.asarray(T_cw)[:3, :3].T + np.asarray(T_cw)[:3, 3]
    u = CAM.fx * p_c[:, 0] / p_c[:, 2] + CAM.cx + rng.normal(0, noise, N_PTS)
    v = CAM.fy * p_c[:, 1] / p_c[:, 2] + CAM.cy + rng.normal(0, noise, N_PTS)
    ur = u - CAM.bf / p_c[:, 2]
    feats = empty_features(F)._replace(
        xy=jnp.zeros((F, 2)).at[:N_PTS].set(
            jnp.asarray(np.stack([u, v], -1).astype(np.float32))),
        desc=jnp.zeros((F, 8), jnp.uint32).at[:N_PTS].set(jnp.asarray(descs)),
        u_right=jnp.full((F,), -1.0).at[:N_PTS].set(
            jnp.asarray(ur.astype(np.float32))),
        depth=jnp.full((F,), -1.0).at[:N_PTS].set(
            jnp.asarray(p_c[:, 2].astype(np.float32))),
        valid=jnp.zeros((F,), bool).at[:N_PTS].set(True),
    )
    point_cam = jnp.zeros((F, 3)).at[:N_PTS].set(jnp.asarray(p_c))
    return FrameState(features=feats, T_cw=jnp.asarray(T_cw),
                      point_cam=point_cam, timestamp=jnp.asarray(0.0))


def _pose(z):
    T = np.eye(4, dtype=np.float32)
    T[2, 3] = -z  # camera at world z=+z looking forward
    return T


def test_insert_keyframe_creates_points():
    pts, descs = _world()
    m = ms.empty_map(16, 1024, F)
    frame = _synth_frame(_pose(0.0), pts, descs)
    m, slot = ms.insert_keyframe(
        m, frame, -jnp.ones((F,), jnp.int32), close_depth_limit=20.0
    )
    assert int(slot) == 0
    assert bool(m.kf_valid[0])
    n_pts = int(jnp.sum(m.pt_valid))
    # the depth-sorted rule: all close (<20) points, padded with the nearest
    # others to at least 100 — close is a subset of nearest-100 here, so
    # exactly max(100, n_close) spawn (reference: src/tracking.cpp:930-969)
    n_close = int((pts[:, 2] < 20.0).sum())
    assert n_pts == max(100, n_close)
    bound_mask = np.asarray(m.kf_obs_point[0][:N_PTS]) >= 0
    assert bound_mask.sum() == n_pts
    bound = np.asarray(m.kf_obs_point[0][:N_PTS])[bound_mask]
    np.testing.assert_allclose(
        np.asarray(m.pt_pos)[bound], pts[bound_mask], atol=1e-2
    )


def test_covisibility_counts_shared_points():
    pts, descs = _world()
    m = ms.empty_map(16, 1024, F)
    f0 = _synth_frame(_pose(0.0), pts, descs)
    m, s0 = ms.insert_keyframe(m, f0, -jnp.ones((F,), jnp.int32), 20.0)
    binds0 = m.kf_obs_point[0]
    f1 = _synth_frame(_pose(0.5), pts, descs)
    m, s1 = ms.insert_keyframe(m, f1, binds0, 20.0)
    assert int(s1) == 1
    n_shared = int(jnp.sum(binds0 >= 0))
    assert int(m.covis[0, 1]) == n_shared
    assert int(m.covis[1, 0]) == n_shared
    assert int(m.covis[0, 0]) == 0
    counts = ms.point_observation_counts(m)
    assert int(jnp.sum(counts == 2)) == n_shared


def test_extract_local_ba_shapes_and_validity():
    pts, descs = _world()
    m = ms.empty_map(16, 1024, F)
    binds = -jnp.ones((F,), jnp.int32)
    for i, z in enumerate([0.0, 0.4, 0.8]):
        f = _synth_frame(_pose(z), pts, descs, noise=0.2, seed=i)
        m, slot = ms.insert_keyframe(m, f, binds, 20.0)
        binds = m.kf_obs_point[slot]
    ext = extract_local_ba(m, 2, 4, 4, 512)
    assert int(jnp.sum(ext.prob.opt_valid)) == 3
    n_pts_map = int(jnp.sum(m.pt_valid))
    assert int(jnp.sum(ext.prob.pt_valid)) == n_pts_map
    n_edges = int(jnp.sum(ext.prob.e_valid))
    # one edge per (keyframe, bound feature): KF0 bound its 100 created
    # points, KF1 added the remaining 100, KF2 re-observed all 200
    n_bindings = int(jnp.sum((m.kf_obs_point >= 0) & m.kf_feat_valid
                             & m.kf_valid[:, None]))
    assert n_edges == n_bindings


def test_local_ba_refines_noisy_poses():
    pts, descs = _world()
    m = ms.empty_map(16, 1024, F)
    binds = -jnp.ones((F,), jnp.int32)
    true_poses = [_pose(0.0), _pose(0.4), _pose(0.8), _pose(1.2)]
    rng = np.random.default_rng(3)
    for i, T in enumerate(true_poses):
        # corrupt later poses
        if i > 0:
            d = (rng.standard_normal(6) * 0.02).astype(np.float32)
            T_noisy = np.asarray(lie.exp_se3(jnp.asarray(d))) @ T
        else:
            T_noisy = T
        f = _synth_frame(T, pts, descs, noise=0.3, seed=i)
        f = f._replace(T_cw=jnp.asarray(T_noisy))
        m, slot = ms.insert_keyframe(m, f, binds, 20.0)
        binds = m.kf_obs_point[slot]

    errs_before = [
        np.linalg.norm(np.asarray(lie.log_se3(
            jnp.asarray(true_poses[i]) @ lie.inv_T(m.kf_T_cw[i])))[:3])
        for i in range(4)
    ]
    m2 = local_mapping_step(m, 3, CFG, ko=4, kfix=4, pl=512)
    errs_after = [
        np.linalg.norm(np.asarray(lie.log_se3(
            jnp.asarray(true_poses[i]) @ lie.inv_T(m2.kf_T_cw[i])))[:3])
        for i in range(4)
    ]
    # BA has gauge freedom over the whole window (no fixed observers exist in
    # this tiny map), so compare relative pose errors instead
    def rel_err(kf_T):
        errs = []
        for i in range(1, 4):
            rel_est = np.asarray(kf_T[i]) @ np.linalg.inv(np.asarray(kf_T[0]))
            rel_gt = true_poses[i] @ np.linalg.inv(true_poses[0])
            d = np.asarray(lie.log_se3(jnp.asarray(
                rel_gt @ np.linalg.inv(rel_est).astype(np.float32))))
            errs.append(np.linalg.norm(d[:3]))
        return np.asarray(errs)

    rel_before = rel_err(m.kf_T_cw)
    rel_after = rel_err(m2.kf_T_cw)
    assert rel_after.max() < rel_before.max()
    assert rel_after.max() < 0.01


def test_cull_points_removes_low_ratio():
    pts, descs = _world()
    m = ms.empty_map(16, 1024, F)
    f = _synth_frame(_pose(0.0), pts, descs)
    m, _ = ms.insert_keyframe(m, f, -jnp.ones((F,), jnp.int32), 20.0)
    # mark half the points as rarely found
    bad = jnp.arange(m.pt_capacity) < 50
    m = m._replace(
        pt_visible=jnp.where(bad, 10, m.pt_visible),
        pt_found=jnp.where(bad, 1, m.pt_found),
    )
    n_before = int(jnp.sum(m.pt_valid))
    m2 = ms.cull_points(m, m.next_kf_id)
    assert int(jnp.sum(m2.pt_valid)) == n_before - 50
    # bindings to killed points must be cleared
    killed_bound = jnp.sum(
        (m2.kf_obs_point[0] >= 0)
        & ~m2.pt_valid[jnp.clip(m2.kf_obs_point[0], 0, m2.pt_capacity - 1)]
    )
    assert int(killed_bound) == 0


def test_distinctive_descriptor_is_min_median():
    """3 KFs observe the same point with different descriptors; the chosen
    descriptor must minimize the median Hamming distance to the others."""
    rng = np.random.default_rng(7)
    base = rng.integers(0, 2**32, (1, 8), dtype=np.uint32)

    def flip(d, nbits, seed):
        r = np.random.default_rng(seed)
        bits = np.unpackbits(d.view(np.uint8).reshape(1, 32), axis=1,
                             bitorder="little")
        for i in r.choice(256, nbits, replace=False):
            bits[0, i] ^= 1
        return np.packbits(bits, axis=1, bitorder="little").view(np.uint32)

    d0 = base                    # central descriptor
    d1 = flip(base, 10, 1)       # close to d0
    d2 = flip(base, 120, 2)      # far outlier
    descs_per_kf = [d0, d1, d2]

    pts, _ = _world()
    m = ms.empty_map(16, 1024, F)
    binds = -jnp.ones((F,), jnp.int32)
    for i, z in enumerate([0.0, 0.3, 0.6]):
        descs = np.tile(descs_per_kf[i], (N_PTS, 1))
        f = _synth_frame(_pose(z), pts, descs)
        m, slot = ms.insert_keyframe(m, f, binds, 20.0)
        binds = m.kf_obs_point[slot]
    m = ms.refresh_distinctive_descriptors(m)
    # every point observed 3x: distinctive descriptor must be d0 or d1 (the
    # cluster), never the outlier d2
    alive = np.asarray(m.pt_valid)
    got = np.asarray(m.pt_desc)[alive]
    assert not np.any(np.all(got == np.asarray(d2), axis=1))
    match_cluster = np.all(got == d0, axis=1) | np.all(got == d1, axis=1)
    assert match_cluster.all()


def test_evict_oldest_if_full():
    pts, descs = _world()
    m = ms.empty_map(4, 1024, F)  # tiny keyframe capacity
    binds = -jnp.ones((F,), jnp.int32)
    for i in range(4):
        f = _synth_frame(_pose(0.2 * i), pts, descs, seed=i)
        m, slot = ms.insert_keyframe(m, f, binds, 20.0)
        binds = m.kf_obs_point[slot]
    assert bool(jnp.all(m.kf_valid))
    m2 = ms.evict_oldest_if_full(m)
    assert int(jnp.sum(m2.kf_valid)) == 3
    # the absolute oldest (id 0) survives as gauge anchor; id 1 is evicted
    alive_ids = sorted(int(i) for i in np.asarray(m2.kf_id)[np.asarray(m2.kf_valid)])
    assert alive_ids == [0, 2, 3]
    # not full anymore => no-op
    m3 = ms.evict_oldest_if_full(m2)
    assert int(jnp.sum(m3.kf_valid)) == 3


def test_covis_row_update_matches_full_rebuild():
    """covis_update_row must count DISTINCT shared points exactly like the
    incidence-Gram rebuild, including rows where fusion merges left the same
    point bound at several features (the per-feature sum over-counted and
    silently corrupted neighbour selection)."""
    pts, descs = _world(0)
    m = ms.empty_map(8, 1024, F)
    for k, z in enumerate([0.0, 0.5, 1.0]):
        fr = _synth_frame(_pose(z), pts, descs, seed=k)
        m, slot = ms.insert_keyframe(
            m, fr, -jnp.ones((F,), jnp.int32), close_depth_limit=1e9
        )
    # duplicate bindings: bind point 0 at three features of keyframe 1
    row = m.kf_obs_point[1]
    row = row.at[10].set(int(row[0])).at[11].set(int(row[0]))
    m = m._replace(kf_obs_point=m.kf_obs_point.at[1].set(row))
    full = ms.recompute_covisibility(m)
    m_stale = m._replace(covis=jnp.zeros_like(m.covis))
    for slot in range(3):
        m_stale = ms.covis_update_row(m_stale, slot)
    np.testing.assert_array_equal(
        np.asarray(full), np.asarray(m_stale.covis)
    )

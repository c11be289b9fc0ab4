"""Loop closing end-to-end at the geometry level: a drifted circular
trajectory re-observes its start region; detection + Horn RANSAC + essential
graph must snap the loop shut."""

import numpy as np
import jax
import jax.numpy as jnp

from opendlv_perception_vision_orbslam2_jax.models import map_state as ms
from opendlv_perception_vision_orbslam2_jax.models import vocabulary as voc
from opendlv_perception_vision_orbslam2_jax.models.frame import FrameState, empty_features
from opendlv_perception_vision_orbslam2_jax.models.kfdb import add_keyframe, empty_kfdb
from opendlv_perception_vision_orbslam2_jax.models.loop_closing import LoopCloser
from opendlv_perception_vision_orbslam2_jax.ops import lie
from opendlv_perception_vision_orbslam2_jax.utils.config import (
    CameraConfig,
    OrbConfig,
    SystemConfig,
)

CAM = CameraConfig(fx=320.0, fy=320.0, cx=256.0, cy=128.0, bf=160.0,
                   width=512, height=256)
CFG = SystemConfig(camera=CAM, orb=OrbConfig(max_keypoints=512))
F = 512
LAP = 20        # keyframes per full circle
N_KF = 26       # 1.3 laps: the revisit spans several keyframes so the
                # 3-consecutive-detection consistency gate can accumulate
RADIUS = 20.0   # big enough that views never cross the circle interior


def _ring_world(n_per_kf=30, seed=0):
    """Scatter points in front of every ground-truth pose, so consecutive
    poses (and the closing first/last pair) share visible points."""
    rng = np.random.default_rng(seed)
    pts = []
    for i in range(LAP):
        T_wc = np.linalg.inv(_gt_pose(i))
        local = np.stack(
            [
                rng.uniform(-5, 5, n_per_kf),
                rng.uniform(-2, 2, n_per_kf),
                rng.uniform(3.0, 12.0, n_per_kf),
            ],
            axis=-1,
        )
        pts.append(local @ T_wc[:3, :3].T + T_wc[:3, 3])
    pts = np.concatenate(pts).astype(np.float32)
    descs = rng.integers(0, 2**32, (len(pts), 8), dtype=np.uint32)
    return pts, descs


def _gt_pose(i):
    th = 2 * np.pi * i / LAP
    c = np.array([RADIUS * np.sin(th), 0.0, RADIUS * (1 - np.cos(th))])
    R_wc = np.array(
        [[np.cos(th), 0, np.sin(th)], [0, 1, 0], [-np.sin(th), 0, np.cos(th)]]
    )
    T_wc = np.eye(4)
    T_wc[:3, :3] = R_wc
    T_wc[:3, 3] = c
    return np.linalg.inv(T_wc).astype(np.float32)


def _frame_for(T_cw_obs, T_cw_store, pts, descs):
    """Observations from the TRUE pose, stored pose drifted."""
    p_c = pts @ T_cw_obs[:3, :3].T + T_cw_obs[:3, 3]
    z = p_c[:, 2]
    vis = (z > 1.0) & (z < 14.0) & (np.abs(p_c[:, 0] / np.maximum(z, 1e-3)) < 0.7)
    idx = np.nonzero(vis)[0][:F]
    n = len(idx)
    u = CAM.fx * p_c[idx, 0] / p_c[idx, 2] + CAM.cx
    v = CAM.fy * p_c[idx, 1] / p_c[idx, 2] + CAM.cy
    ur = u - CAM.bf / p_c[idx, 2]
    feats = empty_features(F)._replace(
        xy=jnp.zeros((F, 2)).at[:n].set(
            jnp.asarray(np.stack([u, v], -1).astype(np.float32))),
        desc=jnp.zeros((F, 8), jnp.uint32).at[:n].set(jnp.asarray(descs[idx])),
        u_right=jnp.full((F,), -1.0).at[:n].set(jnp.asarray(ur.astype(np.float32))),
        depth=jnp.full((F,), -1.0).at[:n].set(
            jnp.asarray(p_c[idx, 2].astype(np.float32))),
        valid=jnp.zeros((F,), bool).at[:n].set(True),
    )
    point_cam = jnp.zeros((F, 3)).at[:n].set(jnp.asarray(p_c[idx]))
    return FrameState(
        features=feats, T_cw=jnp.asarray(T_cw_store),
        point_cam=point_cam, timestamp=jnp.asarray(0.0),
    ), idx


def test_loop_closing_corrects_drift():
    pts, descs = _ring_world()
    vocab = voc.train_vocabulary(descs, branching=8, levels=3, seed=1)

    gt = [_gt_pose(i) for i in range(N_KF)]
    # drifted odometry: constant small yaw bias accumulates
    rng = np.random.default_rng(2)
    drifted = [gt[0]]
    bias = lie.exp_se3(jnp.asarray(
        np.array([0.01, 0, 0.01, 0, 0.004, 0], np.float32)))
    for i in range(1, N_KF):
        rel = gt[i] @ np.linalg.inv(gt[i - 1])
        drifted.append((np.asarray(bias) @ rel @ drifted[-1]).astype(np.float32))

    m = ms.empty_map(32, 32768, F)
    db = empty_kfdb(32, vocab.n_words)
    kf_nodes = -jnp.ones((32, F), jnp.int32)
    closer = LoopCloser(CFG)
    closer.last_loop_kf_id = -100
    closed_any = False

    closed_at = None
    # consecutive KFs share bindings (covisibility), but associations lapse
    # after a few KFs out of view — the revisit creates DUPLICATE points,
    # exactly the situation loop closure exists to repair
    slot_of_world = -np.ones(len(pts), np.int64)
    last_seen = np.full(len(pts), -100)
    for i in range(N_KF):
        frame, idx = _frame_for(gt[i], drifted[i], pts, descs)
        tracked = -np.ones(F, np.int32)
        fresh = (i - last_seen[idx]) <= 3
        tracked[: len(idx)] = np.where(fresh, slot_of_world[idx], -1)
        m, slot = ms.insert_keyframe(
            m, frame, jnp.asarray(tracked), 20.0
        )
        binds = np.asarray(m.kf_obs_point[slot])
        slot_of_world[idx] = binds[: len(idx)]
        last_seen[idx] = i
        words, nodes = voc.transform(
            vocab, m.kf_desc[slot], m.kf_feat_valid[slot]
        )
        db = add_keyframe(db, slot, voc.bow_vector(vocab, words))
        kf_nodes = kf_nodes.at[slot].set(nodes)
        m, closed, _ = closer.on_keyframe(m, db, kf_nodes, int(slot))
        if closed and closed_at is None:
            closed_at = i
            break  # evaluate at the closure keyframe (a live system would
                   # continue tracking from the corrected pose)

    assert closed_at is not None, "no loop closure fired"

    def err(T_est, T_gt):
        d = np.asarray(lie.log_se3(jnp.asarray(
            T_gt @ np.linalg.inv(np.asarray(T_est)).astype(np.float32))))
        return np.linalg.norm(d[:3])

    before = err(drifted[closed_at], gt[closed_at])
    after = err(np.asarray(m.kf_T_cw[closed_at]), gt[closed_at])
    assert before > 0.2, before
    assert after < 0.5 * before, (closed_at, before, after)


def test_mono_sim3_pose_graph_recovers_scale_drift():
    """7-DoF essential graph (fix_scale=False): monocular scale drift
    injected along the odometry chain must be absorbed by the loop edge's
    measured relative scale (OptimizeEssentialGraph Sim3 vertices,
    reference: src/orboptimizer.cpp:799-1061), recovering the end-of-loop
    scale to <2%."""
    from opendlv_perception_vision_orbslam2_jax.optim.pose_graph import (
        PoseGraphProblem,
        optimize_pose_graph,
    )

    n = 20
    gt = [_gt_pose(i) for i in range(n)]
    k_drift = 1.015            # per-edge scale drift; total ~1.33x
    drifted = [gt[0]]
    scale_acc = 1.0
    for i in range(1, n):
        rel = gt[i] @ np.linalg.inv(gt[i - 1])
        rel_s = rel.copy()
        scale_acc *= k_drift
        rel_s[:3, 3] *= scale_acc     # mono VO: translation at wrong scale
        drifted.append((rel_s @ drifted[-1]).astype(np.float32))

    K = 32
    T = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
    T[:n] = np.stack(drifted)
    v_valid = np.zeros(K, bool); v_valid[:n] = True
    v_fixed = np.zeros(K, bool); v_fixed[0] = True

    e_i, e_j, e_T, e_s, e_w = [], [], [], [], []
    for i in range(1, n):
        e_i.append(i); e_j.append(i - 1)
        e_T.append(drifted[i] @ np.linalg.inv(drifted[i - 1]))
        e_s.append(1.0); e_w.append(1.0)
    # loop edge: S_rel between last and first vertex as the Sim3 solver
    # would measure it — true relative pose, relative scale = accumulated
    # drift of the current vertex (its local map is scale_acc too large)
    e_i.append(n - 1); e_j.append(0)
    e_T.append(gt[n - 1] @ np.linalg.inv(gt[0]))
    e_s.append(float(scale_acc)); e_w.append(5.0)

    E = len(e_i)
    prob = PoseGraphProblem(
        T=jnp.asarray(T),
        v_valid=jnp.asarray(v_valid),
        v_fixed=jnp.asarray(v_fixed),
        e_i=jnp.asarray(e_i, jnp.int32),
        e_j=jnp.asarray(e_j, jnp.int32),
        e_T_ij=jnp.asarray(np.stack(e_T).astype(np.float32)),
        e_weight=jnp.asarray(e_w, jnp.float32),
        e_valid=jnp.ones((E,), bool),
        e_s_ij=jnp.asarray(e_s, jnp.float32),
    )
    T_opt, s_opt = optimize_pose_graph(prob, n_iters=25, fix_scale=False)
    s_opt = np.asarray(s_opt)
    # the end vertex's scale must recover the injected drift to < 2%
    assert abs(s_opt[n - 1] - scale_acc) / scale_acc < 0.02, (
        s_opt[n - 1], scale_acc)
    # and the SE3-recovered end pose must be far closer to ground truth
    def terr(T_est):
        return np.linalg.norm(
            np.asarray(T_est)[:3, 3] - gt[n - 1][:3, 3]
        ) / np.linalg.norm(gt[n - 1][:3, 3])
    assert terr(T_opt[n - 1]) < 0.25 * terr(drifted[n - 1])


def test_loop_rejects_distant_dissimilar_geometry():
    """Two keyframes on opposite sides of the ring (appearance overlap
    impossible) must NOT pass the Sim3 + region-projection gates —
    guards the >=40-total acceptance (reference: src/loopclosing.cpp:391)."""
    from opendlv_perception_vision_orbslam2_jax.models.loop_closing import (
        compute_loop_transform,
    )

    pts, descs = _ring_world()
    gt = [_gt_pose(i) for i in range(N_KF)]
    m = ms.empty_map(32, 32768, F)
    kf_nodes = -jnp.ones((32, F), jnp.int32)
    slots = []
    for i in (0, LAP // 2):        # opposite sides of the circle
        frame, idx = _frame_for(gt[i], gt[i], pts, descs)
        m, slot = ms.insert_keyframe(
            m, frame, -jnp.ones((F,), jnp.int32), 20.0
        )
        slots.append(int(slot))
    lm = compute_loop_transform(
        m, kf_nodes, slots[0], slots[1], jax.random.PRNGKey(0), CFG, True
    )
    assert not bool(lm.ok), (
        int(lm.n_inliers), int(lm.n_total))


def test_persistent_loop_edges_protected_and_reused():
    """Accepted loop edges persist in MapState, are injected into later
    essential-graph builds, and protect their anchor keyframes from
    capacity eviction (reference keeps loop edges on keyframes forever,
    src/orbkeyframe.cpp:458-470)."""
    from opendlv_perception_vision_orbslam2_jax.models.loop_closing import (
        build_essential_edges,
    )

    m = ms.empty_map(8, 512, 16)
    # insert 8 tiny keyframes to fill capacity
    for i in range(8):
        frame = FrameState(
            features=empty_features(16),
            T_cw=jnp.eye(4), point_cam=jnp.zeros((16, 3)),
            timestamp=jnp.asarray(0.0),
        )
        m, slot = ms.insert_keyframe(
            m, frame, -jnp.ones((16,), jnp.int32), 20.0,
            min_total_points=0,
        )
    T_rel = jnp.eye(4)
    m = ms.add_loop_edge(m, jnp.asarray(5, jnp.int32),
                         jnp.asarray(1, jnp.int32), T_rel,
                         jnp.asarray(1.0))
    assert int(jnp.sum(m.loop_valid)) == 1

    # stored edge appears in the essential-graph edge list
    edges = build_essential_edges(
        m, jnp.asarray(6, jnp.int32), jnp.asarray(0, jnp.int32),
        jnp.eye(4), jnp.asarray(1.0),
    )
    ev = np.asarray(edges.e_valid)
    ei = np.asarray(edges.e_i)
    ej = np.asarray(edges.e_j)
    found = any(
        ev[k] and ei[k] == 5 and ej[k] == 1 for k in range(len(ev))
    )
    assert found, "persistent loop edge missing from essential graph"

    # eviction must never pick the loop anchors (slots 1 and 5): with a
    # full map the victim would be the second-oldest (slot 1) without
    # protection
    m2 = ms.evict_oldest_if_full(m)
    assert bool(m2.kf_valid[1]) and bool(m2.kf_valid[5])
    assert int(jnp.sum(m2.kf_valid)) == 7   # someone else was evicted

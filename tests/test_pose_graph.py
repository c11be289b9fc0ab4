"""Pose-graph optimizer: loop-closure drift correction on a synthetic loop."""

import numpy as np
import jax.numpy as jnp

from opendlv_perception_vision_orbslam2_jax.ops import lie
from opendlv_perception_vision_orbslam2_jax.optim.pose_graph import (
    PoseGraphProblem,
    optimize_pose_graph,
    relative_pose,
)


def _circle_poses(n, radius=10.0):
    """Ground-truth T_cw for a camera driving a closed circle."""
    poses = []
    for i in range(n):
        th = 2 * np.pi * i / n
        # camera center on circle, heading tangent
        c = np.array([radius * np.sin(th), 0.0, radius * (1 - np.cos(th))])
        yaw = th
        R_wc = np.array(
            [
                [np.cos(yaw), 0, np.sin(yaw)],
                [0, 1, 0],
                [-np.sin(yaw), 0, np.cos(yaw)],
            ]
        )
        T_wc = np.eye(4)
        T_wc[:3, :3] = R_wc
        T_wc[:3, 3] = c
        poses.append(np.linalg.inv(T_wc).astype(np.float32))
    return poses


def test_pose_graph_closes_drifted_loop():
    n = 24
    gt = _circle_poses(n)
    # odometry with accumulated drift
    rng = np.random.default_rng(0)
    drifted = [gt[0]]
    for i in range(1, n):
        rel_gt = gt[i] @ np.linalg.inv(gt[i - 1])
        noise = lie.exp_se3(jnp.asarray(
            (rng.standard_normal(6) * np.array(
                [0.02, 0.02, 0.02, 0.004, 0.004, 0.004])).astype(np.float32)))
        rel_noisy = np.asarray(noise) @ rel_gt
        drifted.append((rel_noisy @ drifted[-1]).astype(np.float32))
    drifted = np.stack(drifted)

    K = 32  # capacity > n
    T = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
    T[:n] = drifted
    v_valid = np.zeros(K, bool)
    v_valid[:n] = True
    v_fixed = np.zeros(K, bool)
    v_fixed[0] = True

    # edges: odometry chain (drifted measurements) + ground-truth loop edge
    e_i, e_j, e_T, e_w = [], [], [], []
    for i in range(1, n):
        e_i.append(i)
        e_j.append(i - 1)
        e_T.append(drifted[i] @ np.linalg.inv(drifted[i - 1]))
        e_w.append(1.0)
    # loop closure: last-to-first with TRUE relative pose (Sim3/SE3 from the
    # loop detector)
    e_i.append(n - 1)
    e_j.append(0)
    e_T.append(gt[n - 1] @ np.linalg.inv(gt[0]))
    e_w.append(5.0)

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
    )
    T_opt, s_opt = optimize_pose_graph(prob, n_iters=15)
    T_opt = np.asarray(T_opt)
    np.testing.assert_allclose(np.asarray(s_opt)[:n], 1.0, atol=1e-6)

    def end_error(T_all):
        d = np.asarray(lie.log_se3(jnp.asarray(
            gt[n - 1] @ np.linalg.inv(T_all[n - 1]).astype(np.float32))))
        return np.linalg.norm(d[:3])

    err_before = end_error(drifted)
    err_after = end_error(T_opt)
    assert err_before > 0.2          # drift actually accumulated
    assert err_after < 0.3 * err_before
    # fixed vertex untouched
    np.testing.assert_allclose(T_opt[0], gt[0], atol=1e-5)

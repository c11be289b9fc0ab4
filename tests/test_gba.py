"""Matrix-free Schur-CG global BA must match the dense local BA solver."""

import numpy as np
import jax.numpy as jnp

from opendlv_perception_vision_orbslam2_jax.optim.ba import bundle_adjust
from opendlv_perception_vision_orbslam2_jax.optim.gba import global_bundle_adjust
from opendlv_perception_vision_orbslam2_jax.ops import lie

from test_ba import CAM, _make_ba_problem, _pose_errors


def test_gba_converges_like_dense_ba():
    T_gt, pts_gt, prob = _make_ba_problem(0)
    T_opt, pts, cost = global_bundle_adjust(prob, **CAM, n_outer=12,
                                            cg_iters=30)
    errs_t, errs_r = _pose_errors(T_gt, np.asarray(T_opt))
    assert errs_t.max() < 0.02, errs_t
    assert errs_r.max() < 0.005, errs_r
    pt_err = np.linalg.norm(np.asarray(pts) - pts_gt, axis=1)
    assert np.median(pt_err / pts_gt[:, 2]) < 0.02


def test_gba_handles_outliers():
    T_gt, pts_gt, prob = _make_ba_problem(2, outlier_frac=0.15)
    T_opt, pts, cost = global_bundle_adjust(prob, **CAM, n_outer=12,
                                            cg_iters=30)
    errs_t, _ = _pose_errors(T_gt, np.asarray(T_opt))
    assert errs_t.max() < 0.06


def test_gba_large_problem_smoke():
    """Scale check: 40 poses x 3000 points x ~30k edges — a size where the
    dense-W local solver would need a 40x3000 block matrix."""
    rng = np.random.default_rng(11)
    n_poses, n_pts = 40, 3000
    pts = np.stack(
        [rng.uniform(-30, 30, n_pts), rng.uniform(-5, 5, n_pts),
         rng.uniform(5, 60, n_pts)], axis=-1,
    ).astype(np.float32)
    from opendlv_perception_vision_orbslam2_jax.optim.ba import BAProblem

    T_gt, e_kf, e_pt, e_uv, e_ur = [], [], [], [], []
    for k in range(n_poses):
        xi = np.zeros(6, np.float32)
        xi[2] = -0.8 * k
        T = np.asarray(lie.exp_se3(jnp.asarray(xi)))
        T_gt.append(T)
        p_c = pts @ T[:3, :3].T + T[:3, 3]
        vis = (p_c[:, 2] > 2.0) & (p_c[:, 2] < 40.0)
        cand = np.nonzero(vis)[0]
        sel = cand[rng.permutation(len(cand))[:800]]
        u = CAM["fx"] * p_c[sel, 0] / p_c[sel, 2] + CAM["cx"]
        v = CAM["fy"] * p_c[sel, 1] / p_c[sel, 2] + CAM["cy"]
        ur = u - CAM["bf"] / p_c[sel, 2]
        for j, uu, vv, rr in zip(sel, u, v, ur):
            e_kf.append(k)
            e_pt.append(j)
            e_uv.append([uu + rng.normal(0, 0.4), vv + rng.normal(0, 0.4)])
            e_ur.append(rr)
    T_gt = np.stack(T_gt)
    E = len(e_kf)

    T0 = T_gt.copy()
    for k in range(1, n_poses):
        d = (rng.standard_normal(6) * 0.01).astype(np.float32)
        T0[k] = np.asarray(lie.exp_se3(jnp.asarray(d))) @ T_gt[k]
    pts0 = pts + rng.standard_normal(pts.shape).astype(np.float32) * 0.1

    prob = BAProblem(
        T_opt=jnp.asarray(T0),
        opt_valid=jnp.ones((n_poses,), bool),
        T_fix=jnp.eye(4, dtype=jnp.float32)[None],
        fix_valid=jnp.zeros((1,), bool),
        pts=jnp.asarray(pts0),
        pt_valid=jnp.ones((n_pts,), bool),
        e_kf=jnp.asarray(e_kf, jnp.int32),
        e_pt=jnp.asarray(e_pt, jnp.int32),
        e_uv=jnp.asarray(np.asarray(e_uv, np.float32)),
        e_ur=jnp.asarray(np.asarray(e_ur, np.float32)),
        e_sigma2=jnp.ones((E,), jnp.float32),
        e_valid=jnp.ones((E,), bool),
    )
    T_opt, pts_o, cost = global_bundle_adjust(prob, **CAM, n_outer=12,
                                              cg_iters=40)
    errs_t, _ = _pose_errors(T_gt, np.asarray(T_opt))
    # With most landmarks at 30-60 m, stereo depth sigma is metres, so the
    # chain-end forward translation is genuinely uncertain: assert a
    # noise-consistent bound plus a real cost reduction, not mm recovery.
    assert errs_t.max() < 0.15, errs_t.max()
    assert np.median(errs_t) < 0.03, np.median(errs_t)
    # cost must reach the vicinity of the measurement-noise floor
    n_edges = int(np.sum(np.asarray(prob.e_valid)))
    assert float(cost) < 1.0 * n_edges, (float(cost), n_edges)


def test_incremental_gba_chunks_and_merge():
    """IncrementalGBA: bounded per-frame chunks converge like the one-shot
    solve, and the merge folds results into a map that GREW during the solve
    (new keyframe rides the anchor correction) — the functional-state
    version of the reference's detached abortable GBA thread
    (reference: src/loopclosing.cpp:576-580, 645-750)."""
    from test_loop_closing import CFG, F as FCAP, _frame_for, _gt_pose, _ring_world
    from opendlv_perception_vision_orbslam2_jax.models import map_state as ms
    from opendlv_perception_vision_orbslam2_jax.models.global_ba import (
        IncrementalGBA,
    )
    from opendlv_perception_vision_orbslam2_jax.ops import lie as _lie

    pts, descs = _ring_world()
    rng = np.random.default_rng(3)
    n_kf = 8
    m = ms.empty_map(16, 32768, FCAP)
    slot_of_world = -np.ones(len(pts), np.int64)
    gt = []
    for i in range(n_kf):
        T_gt = _gt_pose(i)
        gt.append(T_gt)
        noise = np.asarray(_lie.exp_se3(jnp.asarray(
            (rng.standard_normal(6) * np.array(
                [0.03, 0.03, 0.03, 0.005, 0.005, 0.005])).astype(np.float32))))
        T_noisy = (noise @ T_gt).astype(np.float32)
        frame, idx = _frame_for(T_gt, T_noisy, pts, descs)
        tracked = -np.ones(FCAP, np.int32)
        tracked[: len(idx)] = slot_of_world[idx]
        m, slot = ms.insert_keyframe(m, frame, jnp.asarray(tracked), 20.0)
        binds = np.asarray(m.kf_obs_point[slot])
        slot_of_world[idx] = binds[: len(idx)]

    # single-device pinned: the chunk-vs-oneshot equivalence below is
    # bitwise-level and psum order in the auto-sharded path (8 virtual
    # devices in tests) perturbs floats ~1e-3; the sharded production
    # path has its own equivalence test in test_parallel.py
    gba = IncrementalGBA(m, CFG, n_outer_total=8, cg_iters=30, sharded=False)
    # equivalence target: the one-shot solve on the same snapshot
    cam = CFG.camera
    from opendlv_perception_vision_orbslam2_jax.models.global_ba import (
        extract_global_ba,
    )
    prob_ref = extract_global_ba(m, CFG.orb.scale_factor)
    T_ref, pts_ref, cost_ref = global_bundle_adjust(
        prob_ref, fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, bf=cam.bf,
        n_outer=8, cg_iters=30,
    )

    done = False
    for step in range(8):
        done = gba.step()
        if step == 2:
            # map grows mid-solve: a new keyframe arrives
            T_new_gt = _gt_pose(n_kf)
            frame, idx = _frame_for(T_new_gt, T_new_gt, pts, descs)
            tracked = -np.ones(FCAP, np.int32)
            tracked[: len(idx)] = slot_of_world[idx]
            m, new_slot = ms.insert_keyframe(m, frame, jnp.asarray(tracked), 20.0)
    assert done
    # chunked LM must land where the one-shot scan lands (same iterations,
    # same problem -> same trajectory through state space)
    T_chunk, pts_chunk, _, cost_chunk = gba.carry
    np.testing.assert_allclose(np.asarray(T_chunk), np.asarray(T_ref),
                               atol=1e-4)
    assert abs(float(cost_chunk) - float(cost_ref)) < 1e-2 * max(
        1.0, float(cost_ref))
    m2 = gba.merge(m)
    # snapshot keyframes took the optimized poses
    np.testing.assert_allclose(
        np.asarray(m2.kf_T_cw[:n_kf]), np.asarray(T_ref[:n_kf]), atol=1e-4
    )
    # the keyframe added mid-solve survived and stayed finite/consistent
    assert bool(m2.kf_valid[int(new_slot)])
    assert np.all(np.isfinite(np.asarray(m2.kf_T_cw[int(new_slot)])))
    # its relative pose to the anchor (last snapshot KF) is preserved
    rel_before = np.asarray(m.kf_T_cw[int(new_slot)]) @ np.linalg.inv(
        np.asarray(m.kf_T_cw[n_kf - 1]))
    rel_after = np.asarray(m2.kf_T_cw[int(new_slot)]) @ np.linalg.inv(
        np.asarray(m2.kf_T_cw[n_kf - 1]))
    np.testing.assert_allclose(rel_after, rel_before, atol=1e-4)

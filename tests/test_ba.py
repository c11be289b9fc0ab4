"""Bundle-adjustment unit tests vs synthetic ground truth."""

import numpy as np
import jax.numpy as jnp

from opendlv_perception_vision_orbslam2_jax.ops import lie
from opendlv_perception_vision_orbslam2_jax.optim.ba import BAProblem, bundle_adjust

CAM = dict(fx=320.0, fy=320.0, cx=256.0, cy=128.0, bf=160.0)


def _make_ba_problem(seed=0, n_poses=5, n_pts=200, noise_px=0.4,
                     pose_noise=0.03, pt_noise=0.10, outlier_frac=0.0):
    rng = np.random.default_rng(seed)
    pts = np.stack(
        [rng.uniform(-12, 12, n_pts), rng.uniform(-4, 4, n_pts),
         rng.uniform(6, 40, n_pts)], axis=-1,
    ).astype(np.float32)
    # camera moves forward along z
    T_gt = []
    for i in range(n_poses):
        xi = np.zeros(6, np.float32)
        xi[2] = -0.6 * i   # T_cw translation: camera at z = 0.6 i
        T_gt.append(np.asarray(lie.exp_se3(jnp.asarray(xi))))
    T_gt = np.stack(T_gt)

    e_kf, e_pt, e_uv, e_ur = [], [], [], []
    for k in range(n_poses):
        p_c = pts @ T_gt[k, :3, :3].T + T_gt[k, :3, 3]
        vis = p_c[:, 2] > 1.0
        u = CAM["fx"] * p_c[:, 0] / p_c[:, 2] + CAM["cx"]
        v = CAM["fy"] * p_c[:, 1] / p_c[:, 2] + CAM["cy"]
        ur = u - CAM["bf"] / p_c[:, 2]
        for j in np.where(vis)[0]:
            e_kf.append(k)
            e_pt.append(j)
            e_uv.append([u[j] + rng.normal(0, noise_px),
                         v[j] + rng.normal(0, noise_px)])
            e_ur.append(ur[j] + rng.normal(0, noise_px)
                        if rng.uniform() < 0.7 else -1.0)
    E = len(e_kf)
    e_uv = np.asarray(e_uv, np.float32)
    n_out = int(outlier_frac * E)
    if n_out:
        idx = rng.choice(E, n_out, replace=False)
        e_uv[idx] += rng.uniform(-30, 30, (n_out, 2))

    # perturb initial estimates
    T0 = np.stack([
        np.asarray(lie.exp_se3(jnp.asarray(
            (rng.standard_normal(6) * pose_noise).astype(np.float32)))) @ T_gt[k]
        for k in range(n_poses)
    ])
    T0[0] = T_gt[0]  # first pose fixed at truth
    pts0 = pts + rng.standard_normal(pts.shape).astype(np.float32) * pt_noise

    prob = BAProblem(
        T_opt=jnp.asarray(T0),
        opt_valid=jnp.ones((n_poses,), bool),
        T_fix=jnp.eye(4, dtype=jnp.float32)[None],
        fix_valid=jnp.zeros((1,), bool),
        pts=jnp.asarray(pts0),
        pt_valid=jnp.ones((n_pts,), bool),
        e_kf=jnp.asarray(e_kf, jnp.int32),
        e_pt=jnp.asarray(e_pt, jnp.int32),
        e_uv=jnp.asarray(e_uv),
        e_ur=jnp.asarray(np.asarray(e_ur, np.float32)),
        e_sigma2=jnp.ones((E,), jnp.float32),
        e_valid=jnp.ones((E,), bool),
    )
    return T_gt, pts, prob


def _pose_errors(T_gt, T_est):
    errs_t, errs_r = [], []
    for k in range(len(T_gt)):
        d = np.asarray(
            lie.log_se3(jnp.asarray(T_gt[k]) @ lie.inv_T(jnp.asarray(T_est[k])))
        )
        errs_t.append(np.linalg.norm(d[:3]))
        errs_r.append(np.linalg.norm(d[3:]))
    return np.asarray(errs_t), np.asarray(errs_r)


def test_ba_converges_to_ground_truth():
    T_gt, pts_gt, prob = _make_ba_problem(0)
    res = bundle_adjust(prob, **CAM, fix_first_pose=True)
    errs_t, errs_r = _pose_errors(T_gt, np.asarray(res.T_opt))
    assert errs_t.max() < 0.02, errs_t
    assert errs_r.max() < 0.005, errs_r
    # point error relative to depth (stereo depth sigma ~ z^2 sigma_px / bf:
    # absolute error grows quadratically with distance; 2% median is at the
    # measurement-noise floor for 0.4 px)
    pt_err = np.linalg.norm(np.asarray(res.pts) - pts_gt, axis=1)
    assert np.median(pt_err / pts_gt[:, 2]) < 0.02


def test_ba_improves_initialization():
    T_gt, pts_gt, prob = _make_ba_problem(1, pose_noise=0.05, pt_noise=0.3)
    errs0_t, _ = _pose_errors(T_gt, np.asarray(prob.T_opt))
    res = bundle_adjust(prob, **CAM, fix_first_pose=True)
    errs_t, _ = _pose_errors(T_gt, np.asarray(res.T_opt))
    assert errs_t.max() < 0.3 * errs0_t.max()


def test_ba_with_outliers():
    T_gt, pts_gt, prob = _make_ba_problem(2, outlier_frac=0.15)
    res = bundle_adjust(prob, **CAM, fix_first_pose=True)
    errs_t, errs_r = _pose_errors(T_gt, np.asarray(res.T_opt))
    assert errs_t.max() < 0.05
    # outlier edges must be classified out
    frac_in = float(jnp.mean(res.edge_inlier))
    assert 0.7 < frac_in < 0.95


def test_ba_respects_fixed_poses():
    T_gt, pts_gt, prob = _make_ba_problem(3)
    # mark pose 1 as additionally present in T_fix: freeze via opt_valid
    frozen = prob.T_opt[1]
    prob = prob._replace(opt_valid=prob.opt_valid.at[1].set(False))
    res = bundle_adjust(prob, **CAM, fix_first_pose=True)
    np.testing.assert_allclose(np.asarray(res.T_opt[1]), np.asarray(frozen))


def test_ba_no_behind_camera_escape():
    """A point with contradictory stereo observations must NOT be resolved by
    pushing it behind the cameras: dropping behind-camera edges from the
    accept-test cost used to let LM 'improve' monotonically that way
    (observed 20-950 m point moves in local BA).  The behind penalty keeps
    such points in front; the chi2 cut then classifies the losers out."""
    # two cameras looking down +z from z=0 and z=0.5
    T0 = np.eye(4, dtype=np.float32)
    T1 = np.eye(4, dtype=np.float32)
    T1[2, 3] = -0.5
    pt = np.array([[0.5, 0.2, 10.0]], np.float32)

    def obs(T, depth_for_ur):
        p_c = pt[0] @ T[:3, :3].T + T[:3, 3]
        u = CAM["fx"] * p_c[0] / p_c[2] + CAM["cx"]
        v = CAM["fy"] * p_c[1] / p_c[2] + CAM["cy"]
        return [u, v], u - CAM["bf"] / depth_for_ur

    uv0, ur0 = obs(T0, 10.0)   # consistent: disparity says z=10
    uv1, ur1 = obs(T1, 3.0)    # contradictory: disparity says z=3
    prob = BAProblem(
        T_opt=jnp.asarray(np.stack([T0, T1])),
        opt_valid=jnp.ones((2,), bool),
        T_fix=jnp.eye(4, dtype=jnp.float32)[None],
        fix_valid=jnp.zeros((1,), bool),
        pts=jnp.asarray(pt),
        pt_valid=jnp.ones((1,), bool),
        e_kf=jnp.asarray([0, 1], jnp.int32),
        e_pt=jnp.asarray([0, 0], jnp.int32),
        e_uv=jnp.asarray(np.asarray([uv0, uv1], np.float32)),
        e_ur=jnp.asarray(np.asarray([ur0, ur1], np.float32)),
        e_sigma2=jnp.ones((2,), jnp.float32),
        e_valid=jnp.ones((2,), bool),
    )
    res = bundle_adjust(prob, **CAM, fix_first_pose=True)
    p = np.asarray(res.pts[0])
    assert np.isfinite(p).all()
    # still in front of both cameras and within a sane band
    for T in (np.asarray(res.T_opt[0]), np.asarray(res.T_opt[1])):
        z = (pt_c := p @ T[:3, :3].T + T[:3, 3])[2]
        assert z > 0.5, f"point escaped behind camera: z={z}"
    assert np.linalg.norm(p - pt[0]) < 8.0, p


def _make_grid_problem(seed=0, kw=6, ko=4, n_pts=256, noise_px=0.4,
                       pose_noise=0.03, pt_noise=0.10):
    """Dense-grid BA problem (observation-table layout) vs ground truth."""
    from opendlv_perception_vision_orbslam2_jax.optim.ba_grid import (
        GridBAProblem,
    )

    rng = np.random.default_rng(seed)
    pts = np.stack(
        [rng.uniform(-12, 12, n_pts), rng.uniform(-4, 4, n_pts),
         rng.uniform(6, 40, n_pts)], axis=-1,
    ).astype(np.float32)
    T_gt = []
    for i in range(kw):
        xi = np.zeros(6, np.float32)
        xi[2] = -0.6 * i
        T_gt.append(np.asarray(lie.exp_se3(jnp.asarray(xi))))
    T_gt = np.stack(T_gt)

    F = n_pts  # one feature slot per point for simplicity
    o_uv = np.zeros((n_pts, kw, 2), np.float32)
    o_ur = -np.ones((n_pts, kw), np.float32)
    o_valid = np.zeros((n_pts, kw), bool)
    obs_table = -np.ones((n_pts, kw), np.int32)
    g_pt = -np.ones((kw, F), np.int32)
    g_uv = np.zeros((kw, F, 2), np.float32)
    g_ur = -np.ones((kw, F), np.float32)
    g_valid = np.zeros((kw, F), bool)
    for k in range(kw):
        p_c = pts @ T_gt[k, :3, :3].T + T_gt[k, :3, 3]
        vis = p_c[:, 2] > 1.0
        u = CAM["fx"] * p_c[:, 0] / p_c[:, 2] + CAM["cx"]
        v = CAM["fy"] * p_c[:, 1] / p_c[:, 2] + CAM["cy"]
        ur = u - CAM["bf"] / p_c[:, 2]
        for j in np.where(vis)[0]:
            uu = u[j] + rng.normal(0, noise_px)
            vv = v[j] + rng.normal(0, noise_px)
            qq = (ur[j] + rng.normal(0, noise_px)
                  if rng.uniform() < 0.7 else -1.0)
            o_uv[j, k] = (uu, vv)
            o_ur[j, k] = qq
            o_valid[j, k] = True
            obs_table[j, k] = j
            g_pt[k, j] = j
            g_uv[k, j] = (uu, vv)
            g_ur[k, j] = qq
            g_valid[k, j] = True

    T0 = np.stack([
        np.asarray(lie.exp_se3(jnp.asarray(
            (rng.standard_normal(6) * pose_noise).astype(np.float32))))
        @ T_gt[k]
        for k in range(kw)
    ])
    T0[0] = T_gt[0]
    # fixed observers keep their TRUE poses (they anchor the gauge)
    T0[ko:] = T_gt[ko:]
    pts0 = pts + rng.standard_normal(pts.shape).astype(np.float32) * pt_noise

    prob = GridBAProblem(
        T_all=jnp.asarray(T0),
        kf_valid=jnp.ones((kw,), bool),
        pose_free=jnp.ones((ko,), bool).at[0].set(False),
        pts=jnp.asarray(pts0),
        pt_valid=jnp.ones((n_pts,), bool),
        g_pt=jnp.asarray(g_pt),
        g_uv=jnp.asarray(g_uv),
        g_ur=jnp.asarray(g_ur),
        g_sigma2=jnp.ones((kw, F)),
        g_valid=jnp.asarray(g_valid),
        obs_table=jnp.asarray(obs_table),
        o_uv=jnp.asarray(o_uv),
        o_ur=jnp.asarray(o_ur),
        o_sigma2=jnp.ones((n_pts, kw)),
        o_valid=jnp.asarray(o_valid),
    )
    return prob, T_gt, pts


def test_bundle_adjust_grid_converges_to_ground_truth():
    """The scalarized grid solver recovers poses and points from a
    perturbed initialization (same accuracy contract as the edge-list
    solver's test above)."""
    from opendlv_perception_vision_orbslam2_jax.optim.ba_grid import (
        bundle_adjust_grid,
    )

    prob, T_gt, pts_gt = _make_grid_problem()
    res = bundle_adjust_grid(prob, **CAM)
    T_est = np.asarray(res.T_opt)
    ko = prob.n_opt
    # pose error well below the injected 0.03 perturbation
    for k in range(ko):
        dT = np.linalg.inv(T_gt[k]) @ T_est[k]
        assert np.linalg.norm(dT[:3, 3]) < 8e-3, (k, dT[:3, 3])
        assert abs(np.trace(dT[:3, :3]) - 3.0) < 1e-4
    # depth-relative landmark accuracy at the noise floor (same bound as
    # the edge-list solver's test above: forward motion constrains depth
    # weakly, so absolute error grows with distance)
    pt_err = np.linalg.norm(np.asarray(res.pts) - pts_gt, axis=-1)
    assert float(np.median(pt_err / pts_gt[:, 2])) < 0.02
    # inlier gate keeps the (outlier-free) observations
    assert int(np.asarray(res.grid_inlier).sum()) > 0.9 * int(
        np.asarray(prob.g_valid).sum()
    )


def test_bundle_adjust_grid_respects_masks():
    """Frozen poses must not move; invalid points must not move."""
    from opendlv_perception_vision_orbslam2_jax.optim.ba_grid import (
        bundle_adjust_grid,
    )

    prob, T_gt, pts_gt = _make_grid_problem(seed=3)
    pt_valid = np.asarray(prob.pt_valid).copy()
    pt_valid[:20] = False
    prob = prob._replace(pt_valid=jnp.asarray(pt_valid))
    res = bundle_adjust_grid(prob, **CAM)
    # gauge-pinned pose 0 unchanged
    np.testing.assert_allclose(
        np.asarray(res.T_opt)[0], np.asarray(prob.T_all)[0], atol=1e-7
    )
    # invalid points unchanged
    np.testing.assert_allclose(
        np.asarray(res.pts)[:20], np.asarray(prob.pts)[:20], atol=1e-7
    )

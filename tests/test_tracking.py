"""Pose optimization + end-to-end stereo VO on the synthetic world."""

import numpy as np
import jax.numpy as jnp
import pytest

from opendlv_perception_vision_orbslam2_jax.models.tracking import (
    StereoVisualOdometry,
)
from opendlv_perception_vision_orbslam2_jax.ops import lie
from opendlv_perception_vision_orbslam2_jax.optim.pose_opt import (
    PoseObs,
    pose_optimize,
)
from opendlv_perception_vision_orbslam2_jax.utils import synthetic, trajectory
from opendlv_perception_vision_orbslam2_jax.utils.config import (
    CameraConfig,
    OrbConfig,
    SystemConfig,
)

CAM = dict(fx=320.0, fy=320.0, cx=256.0, cy=128.0, bf=160.0)


def _make_pose_problem(seed, n=200, noise_px=0.3, outlier_frac=0.0):
    rng = np.random.default_rng(seed)
    p_w = np.stack(
        [rng.uniform(-10, 10, n), rng.uniform(-4, 4, n), rng.uniform(4, 40, n)],
        axis=-1,
    ).astype(np.float32)
    xi = (rng.standard_normal(6) * np.array([0.3, 0.3, 0.3, 0.05, 0.05, 0.05])).astype(
        np.float32
    )
    T_true = np.asarray(lie.exp_se3(jnp.asarray(xi)))
    p_c = p_w @ T_true[:3, :3].T + T_true[:3, 3]
    uv = np.stack(
        [
            CAM["fx"] * p_c[:, 0] / p_c[:, 2] + CAM["cx"],
            CAM["fy"] * p_c[:, 1] / p_c[:, 2] + CAM["cy"],
        ],
        axis=-1,
    )
    ur = uv[:, 0] - CAM["bf"] / p_c[:, 2]
    uv += rng.standard_normal(uv.shape) * noise_px
    n_out = int(outlier_frac * n)
    if n_out:
        idx = rng.choice(n, n_out, replace=False)
        uv[idx] += rng.uniform(-40, 40, (n_out, 2))
    obs = PoseObs(
        p_w=jnp.asarray(p_w),
        uv=jnp.asarray(uv.astype(np.float32)),
        u_right=jnp.asarray(ur.astype(np.float32)),
        sigma2=jnp.ones((n,), jnp.float32),
        valid=jnp.ones((n,), bool),
    )
    return T_true, obs


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pose_optimize_converges_from_perturbed_start(seed):
    T_true, obs = _make_pose_problem(seed)
    # start from a perturbed pose (motion-model prediction error)
    d = jnp.asarray(np.array([0.2, -0.1, 0.15, 0.02, -0.03, 0.01], np.float32))
    T0 = lie.exp_se3(d) @ jnp.asarray(T_true)
    T_est, inliers, n_inl = pose_optimize(T0, obs, **CAM)
    err = np.asarray(lie.log_se3(jnp.asarray(T_true) @ lie.inv_T(T_est)))
    assert np.linalg.norm(err[:3]) < 0.02       # translation < 2 cm
    assert np.linalg.norm(err[3:]) < 0.005      # rotation < 0.3 deg
    assert int(n_inl) > 150


def test_pose_optimize_rejects_outliers():
    T_true, obs = _make_pose_problem(7, outlier_frac=0.3)
    d = jnp.asarray(np.array([0.1, 0.1, -0.1, 0.01, 0.01, -0.01], np.float32))
    T0 = lie.exp_se3(d) @ jnp.asarray(T_true)
    T_est, inliers, n_inl = pose_optimize(T0, obs, **CAM)
    err = np.asarray(lie.log_se3(jnp.asarray(T_true) @ lie.inv_T(T_est)))
    assert np.linalg.norm(err[:3]) < 0.05
    # outliers must be flagged out
    assert int(n_inl) < 160 and int(n_inl) > 120


def test_pose_optimize_mono_edges_only():
    T_true, obs = _make_pose_problem(3)
    obs = obs._replace(u_right=-jnp.ones_like(obs.u_right))
    d = jnp.asarray(np.array([0.1, 0.0, 0.1, 0.0, 0.02, 0.0], np.float32))
    T0 = lie.exp_se3(d) @ jnp.asarray(T_true)
    T_est, _, n_inl = pose_optimize(T0, obs, **CAM)
    err = np.asarray(lie.log_se3(jnp.asarray(T_true) @ lie.inv_T(T_est)))
    assert np.linalg.norm(err[:3]) < 0.05
    assert int(n_inl) > 150


@pytest.mark.slow
def test_stereo_vo_on_synthetic_sequence():
    """End-to-end: rendered stereo sequence -> VO -> ATE (SURVEY.md section 4
    layer-3 integration fixture)."""
    cfg = SystemConfig(
        camera=CameraConfig(fx=320.0, fy=320.0, cx=256.0, cy=128.0,
                            bf=160.0, width=512, height=256, fps=10.0),
        orb=OrbConfig(n_features=600, max_keypoints=1024, n_levels=4),
    )
    n_frames = 12
    lefts, rights, gt_poses, _ = synthetic.render_stereo_sequence(
        cfg, n_frames=n_frames, n_points=500, seed=5, step=0.25
    )
    vo = StereoVisualOdometry(cfg)
    for i in range(n_frames):
        T = vo.process(lefts[i], rights[i], timestamp=i * 0.1)
        assert T is not None
        assert not vo.lost, f"lost tracking at frame {i}"
    ate = trajectory.ate_rmse(vo.trajectory, list(np.asarray(gt_poses)), align=False)
    # ~3 m travelled; VO drift must stay well under 10 cm
    assert ate < 0.10, f"ATE {ate:.3f} m too high"

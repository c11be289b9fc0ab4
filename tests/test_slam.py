"""Full-pipeline integration: stereo SLAM (tracking + map + local BA) on the
synthetic rendered sequence."""

import numpy as np
import jax.numpy as jnp
import pytest

from opendlv_perception_vision_orbslam2_jax.models.slam import StereoSlam
from opendlv_perception_vision_orbslam2_jax.utils import synthetic, trajectory
from opendlv_perception_vision_orbslam2_jax.utils.config import (
    CameraConfig,
    OrbConfig,
    SystemConfig,
)


def _config():
    return SystemConfig(
        camera=CameraConfig(fx=320.0, fy=320.0, cx=256.0, cy=128.0,
                            bf=160.0, width=512, height=256, fps=10.0),
        orb=OrbConfig(n_features=600, max_keypoints=1024, n_levels=4),
        tracking=__import__(
            "opendlv_perception_vision_orbslam2_jax.utils.config",
            fromlist=["TrackingConfig"],
        ).TrackingConfig(max_frames=5, th_depth=35.0),
        max_keyframes=32,
        max_map_points=16384,
    )


@pytest.mark.slow
def test_stereo_slam_on_synthetic_sequence():
    cfg = _config()
    n_frames = 14
    lefts, rights, gt_poses, _ = synthetic.render_stereo_sequence(
        cfg, n_frames=n_frames, n_points=500, seed=5, step=0.25
    )
    slam = StereoSlam(cfg)
    for i in range(n_frames):
        T = slam.process(lefts[i], rights[i], timestamp=i * 0.1)
        assert T is not None
        assert not slam.lost, f"lost tracking at frame {i}"

    # map grew beyond the bootstrap keyframe
    assert slam.n_keyframes >= 2
    assert int(jnp.sum(slam.map.pt_valid)) > 100

    ate = trajectory.ate_rmse(
        [np.asarray(T) for T in slam.trajectory],
        list(np.asarray(gt_poses)), align=False,
    )
    assert ate < 0.10, f"ATE {ate:.3f} m too high"


@pytest.mark.slow
def test_stereo_keyframes_triangulate_far_points():
    """The stereo mapping stage must densify beyond the close stereo-depth
    band via covisible triangulation (CreateNewMapPoints, reference:
    src/mapping.cpp:280-525) — far points anchor rotation and loop
    geometry."""
    cfg = _config()
    th_far = cfg.tracking.th_depth * cfg.camera.baseline_m   # 17.5 m
    n_frames = 14
    lefts, rights, gt_poses, world = synthetic.render_stereo_sequence(
        cfg, n_frames=n_frames, n_points=500, seed=5, step=0.25
    )
    slam = StereoSlam(cfg)
    for i in range(n_frames):
        slam.process(lefts[i], rights[i], timestamp=i * 0.1)
    slam.finish()   # settle the async mapping stage before reading the map

    pts = np.asarray(slam.map.pt_pos)[np.asarray(slam.map.pt_valid)]
    # world frame == first camera frame: z is distance along the optical axis
    far = pts[:, 2] > th_far + 1.0
    assert far.sum() > 30, f"only {far.sum()} far map points triangulated"
    # far points must be real geometry, not junk: match nearest world point.
    # Triangulation depth noise grows as z^2/(b*f) (~0.6 m at z=20 with the
    # few-metre keyframe baselines here), so gate on RELATIVE range error.
    wpts = np.asarray(world.points)
    d = np.linalg.norm(pts[far][:, None, :] - wpts[None, :, :], axis=-1)
    rel = d.min(axis=1) / pts[far][:, 2]
    assert np.median(rel) < 0.04, f"median far-point rel error {np.median(rel):.3f}"


@pytest.mark.slow
def test_two_lap_loop_closures_with_capacity_churn():
    """Long-sequence robustness (SURVEY.md section 5 map-growth management):
    1.5 laps of a circular drive at keyframe capacity 64 forces culling AND
    slot eviction while TWO loop closures fire; persistent loop edges must
    survive the churn and the second essential-graph solve must stay
    consistent (reference keeps loop edges on keyframes forever,
    src/orbkeyframe.cpp:458-470)."""
    cfg = SystemConfig(
        camera=CameraConfig(fx=320.0, fy=320.0, cx=256.0, cy=128.0,
                            bf=160.0, width=512, height=256, fps=10.0),
        orb=OrbConfig(n_features=600, max_keypoints=1024, n_levels=4),
        tracking=__import__(
            "opendlv_perception_vision_orbslam2_jax.utils.config",
            fromlist=["TrackingConfig"],
        ).TrackingConfig(max_frames=5),
        max_keyframes=64,
        max_map_points=32768,
    )
    n = 200
    lefts, rights, gt, _ = synthetic.render_loop_sequence(
        cfg, n_frames=n, n_points=2400, seed=4, radius=20.0, laps=1.5
    )
    slam = StereoSlam(cfg)
    lost_frames = 0
    for i in range(n):
        slam.process(lefts[i], rights[i], timestamp=i * 0.1)
        lost_frames += int(slam.lost)
    slam.finish()

    est = np.stack([np.asarray(T) for T in slam.trajectory])
    assert np.isfinite(est).all(), "non-finite poses in trajectory"
    assert lost_frames < 0.1 * n, f"lost {lost_frames}/{n} frames"
    assert slam.loops_closed >= 2, f"only {slam.loops_closed} loop closures"
    assert int(jnp.sum(slam.map.loop_valid)) >= 2, "loop edges not persisted"
    # loop anchors survived capacity eviction
    li = np.asarray(slam.map.loop_i)[np.asarray(slam.map.loop_valid)]
    lj = np.asarray(slam.map.loop_j)[np.asarray(slam.map.loop_valid)]
    kf_valid = np.asarray(slam.map.kf_valid)
    assert kf_valid[li].all() and kf_valid[lj].all()
    # keyframe churn actually happened (more created than capacity)
    assert slam.n_keyframes > cfg.max_keyframes
    ate = trajectory.ate_rmse(list(est), list(np.asarray(gt)), align=True)
    assert ate < 5.0, f"aligned ATE {ate:.2f} m on the 188 m loop drive"

"""Localization-only mode (the reference's mbOnlyTracking + mbVO dual
hypothesis, reference: src/tracking.cpp:1538-1640): frozen map, no keyframe
insertion, VO carries the pose off-map with per-frame relocalization."""

import numpy as np
import jax.numpy as jnp

from opendlv_perception_vision_orbslam2_jax.models.slam import StereoSlam
from opendlv_perception_vision_orbslam2_jax.utils import synthetic, trajectory
from opendlv_perception_vision_orbslam2_jax.utils.config import (
    CameraConfig,
    OrbConfig,
    SystemConfig,
    TrackingConfig,
)


def _config():
    return SystemConfig(
        camera=CameraConfig(fx=320.0, fy=320.0, cx=256.0, cy=128.0,
                            bf=160.0, width=512, height=256, fps=10.0),
        orb=OrbConfig(n_features=600, max_keypoints=1024, n_levels=4),
        tracking=TrackingConfig(max_frames=5, th_depth=35.0),
        max_keyframes=32, max_map_points=16384,
    )


def test_tracking_only_frozen_map():
    cfg = _config()
    n = 16
    lefts, rights, gt, _ = synthetic.render_stereo_sequence(
        cfg, n_frames=n, n_points=500, seed=5, step=0.25
    )
    # phase 1: build the map normally over the first 10 frames
    slam = StereoSlam(cfg)
    for i in range(10):
        slam.process(np.asarray(lefts[i]), np.asarray(rights[i]),
                     timestamp=i * 0.1)
    slam.finish()
    kfs_before = slam.n_keyframes
    pts_before = int(np.asarray(slam.map.pt_valid).sum())

    # phase 2: freeze the map, keep tracking the remaining frames
    slam.tracking_only = True
    for i in range(10, n):
        T = slam.process(np.asarray(lefts[i]), np.asarray(rights[i]),
                         timestamp=i * 0.1)
        assert T is not None
    slam.finish()

    # the map did not move: no keyframes, no new points
    assert slam.n_keyframes == kfs_before
    assert int(np.asarray(slam.map.pt_valid).sum()) <= pts_before
    est = [np.asarray(T) for T in slam.trajectory]
    assert np.isfinite(np.stack(est)).all()
    ate = trajectory.ate_rmse(est, list(np.asarray(gt))[:len(est)],
                              align=False)
    assert ate < 0.2, f"tracking-only ATE {ate:.3f} m"


def test_tracking_only_vo_mode_engages():
    """Off the mapped region the tracker must fall into VO mode (mbVO) and
    keep producing finite poses instead of dying."""
    cfg = _config()
    n = 24
    lefts, rights, gt, _ = synthetic.render_stereo_sequence(
        cfg, n_frames=n, n_points=500, seed=5, step=0.6
    )
    slam = StereoSlam(cfg)
    for i in range(6):
        slam.process(np.asarray(lefts[i]), np.asarray(rights[i]),
                     timestamp=i * 0.1)
    slam.finish()
    slam.tracking_only = True
    engaged = False
    for i in range(6, n):
        T = slam.process(np.asarray(lefts[i]), np.asarray(rights[i]),
                         timestamp=i * 0.1)
        assert T is not None and np.isfinite(np.asarray(T)).all()
        engaged = engaged or slam._vo_mode
    slam.finish()
    # far past the mapped region the map inliers collapse -> mbVO engages
    assert engaged, "VO mode never engaged despite leaving the mapped region"

"""RGB-D pipeline: frame construction from a registered depth map and the
full SLAM loop on the synthetic rendered sequence.

Reference behavior: GrabImageRGBD (src/tracking.cpp:202-230) scales the depth
map by 1/DepthMapFactor, ComputeStereoFromRGBD (src/orbframe.cpp:707-728)
samples depth at each keypoint pixel and synthesizes u_right = u - bf/d; the
rest of the system then treats the frame exactly like stereo.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from opendlv_perception_vision_orbslam2_jax.models.frontend import process_rgbd
from opendlv_perception_vision_orbslam2_jax.models.slam import StereoSlam
from opendlv_perception_vision_orbslam2_jax.utils import synthetic, trajectory
from opendlv_perception_vision_orbslam2_jax.utils.config import (
    CameraConfig,
    OrbConfig,
    SystemConfig,
    TrackingConfig,
)


def _config(depth_map_factor: float = 1.0):
    return SystemConfig(
        camera=CameraConfig(fx=320.0, fy=320.0, cx=256.0, cy=128.0,
                            bf=160.0, width=512, height=256, fps=10.0),
        camera_type="rgbd",
        orb=OrbConfig(n_features=600, max_keypoints=1024, n_levels=4),
        tracking=TrackingConfig(max_frames=5, th_depth=35.0,
                                depth_map_factor=depth_map_factor),
        max_keyframes=32,
        max_map_points=16384,
    )


def test_rgbd_frame_depth_and_virtual_disparity():
    cfg = _config()
    cam = cfg.camera
    world = synthetic.make_world(400, seed=3)
    T0 = jnp.eye(4, dtype=jnp.float32)
    gray = synthetic.render_view(T0, world, cam.height, cam.width,
                                 cam.fx, cam.fy, cam.cx, cam.cy)
    dm = synthetic.render_depth_map(T0, world, cam.height, cam.width,
                                    cam.fx, cam.fy, cam.cx, cam.cy)
    fr = process_rgbd(gray, dm, cfg, 0.0)
    feats = fr.features
    ok = np.asarray(feats.valid & (feats.depth > 0))
    assert ok.sum() > 100

    d = np.asarray(feats.depth)[ok]
    x = np.asarray(feats.xy)[ok, 0]
    ur = np.asarray(feats.u_right)[ok]
    # virtual right coordinate identity u_right = u - bf/d
    np.testing.assert_allclose(ur, x - cam.bf / d, rtol=1e-5, atol=1e-3)

    # sampled depth matches the camera-frame z of the generating world point
    # (the depth map stamps exact z over each sprite; keypoints sit at sprite
    # corners, so associate by 3D backprojection, not image-space proximity)
    pts_cam = np.asarray(world.points)  # T0 = identity => camera frame
    kp = np.asarray(feats.xy)[ok]
    p3 = np.stack([(kp[:, 0] - cam.cx) * d / cam.fx,
                   (kp[:, 1] - cam.cy) * d / cam.fy, d], -1)
    nn = np.argmin(
        ((pts_cam[None, :, :] - p3[:, None, :]) ** 2).sum(-1), axis=1
    )
    exact = np.abs(d - pts_cam[nn, 2]) < 1e-3 * pts_cam[nn, 2]
    assert exact.mean() > 0.9, f"only {exact.mean():.2f} exact-depth keypoints"


def test_rgbd_depth_map_factor_scaling():
    """DepthMapFactor=5000 (TUM-style mm*5 maps): raw = metric * 5000."""
    cfg = _config(depth_map_factor=5000.0)
    cam = cfg.camera
    world = synthetic.make_world(400, seed=3)
    T0 = jnp.eye(4, dtype=jnp.float32)
    gray = synthetic.render_view(T0, world, cam.height, cam.width,
                                 cam.fx, cam.fy, cam.cx, cam.cy)
    dm = synthetic.render_depth_map(T0, world, cam.height, cam.width,
                                    cam.fx, cam.fy, cam.cx, cam.cy)
    fr = process_rgbd(gray, dm * 5000.0, cfg, 0.0)
    fr_ref = process_rgbd(gray, dm, _config(), 0.0)
    ok = np.asarray(fr.features.valid & (fr.features.depth > 0))
    np.testing.assert_allclose(
        np.asarray(fr.features.depth)[ok],
        np.asarray(fr_ref.features.depth)[ok],
        rtol=1e-4,
    )


@pytest.mark.slow
def test_rgbd_slam_on_synthetic_sequence():
    cfg = _config()
    n_frames = 12
    grays, depths, gt_poses, _ = synthetic.render_rgbd_sequence(
        cfg, n_frames=n_frames, n_points=500, seed=5, step=0.25
    )
    slam = StereoSlam(cfg)
    est = []
    for i in range(n_frames):
        T = slam.process_rgbd(grays[i], depths[i], timestamp=i * 0.1)
        if T is not None:
            est.append(np.asarray(T))
    assert len(est) >= n_frames - 1
    gt = np.asarray(gt_poses)[-len(est):]
    ate = trajectory.ate_rmse(np.stack(est), gt)
    assert ate < 0.10, f"RGB-D ATE {ate:.3f} m"

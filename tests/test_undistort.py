"""Undistortion / rectification / bounding-box wiring tests
(FilterKeyPoints + UndistortKeyPoints, reference: src/orbframe.cpp:403-479;
setUpRealtime rectification, reference: src/selflocalization.cpp:380-531)."""

import dataclasses

import numpy as np
import jax.numpy as jnp

from opendlv_perception_vision_orbslam2_jax.models.frontend import process_mono
from opendlv_perception_vision_orbslam2_jax.ops import undistort as und
from opendlv_perception_vision_orbslam2_jax.utils import synthetic
from opendlv_perception_vision_orbslam2_jax.utils.config import (
    CameraConfig,
    OrbConfig,
    SystemConfig,
    TrackingConfig,
)

CAM = CameraConfig(fx=320.0, fy=320.0, cx=256.0, cy=128.0, bf=160.0,
                   width=512, height=256)


def _cfg(**tracking):
    return SystemConfig(
        camera=CAM,
        orb=OrbConfig(n_features=400, max_keypoints=512, n_levels=3),
        tracking=TrackingConfig(**tracking),
    )


def _render():
    cfg = _cfg()
    lefts, _, _, _ = synthetic.render_stereo_sequence(
        cfg, n_frames=1, n_points=400, seed=3
    )
    return jnp.asarray(lefts[0], jnp.float32)


def test_bbox_filter_drops_keypoints_inside_box():
    img = _render()
    cfg = _cfg(bbox_min_x=150.0, bbox_max_x=350.0,
               bbox_min_y=60.0, bbox_max_y=200.0)
    f = process_mono(img, cfg, 0.0)
    xy = np.asarray(f.features.xy)
    valid = np.asarray(f.features.valid)
    inside = (
        (xy[:, 0] > 150) & (xy[:, 0] < 350) & (xy[:, 1] > 60) & (xy[:, 1] < 200)
    )
    assert not np.any(valid & inside), "bbox keypoints not filtered"
    assert valid.sum() > 50, "filter removed everything"
    # disabled box (reference rule: MaxX <= 2 disables) keeps them
    f2 = process_mono(img, _cfg(), 0.0)
    v2 = np.asarray(f2.features.valid)
    xy2 = np.asarray(f2.features.xy)
    inside2 = (
        (xy2[:, 0] > 150) & (xy2[:, 0] < 350)
        & (xy2[:, 1] > 60) & (xy2[:, 1] < 200)
    )
    assert np.any(v2 & inside2)


def test_undistortion_applied_to_keypoint_coords():
    """Same image, same detections: with k1 set the output coords must be
    exactly the undistortion map applied to the raw-detection coords."""
    img = _render()
    cfg0 = _cfg()
    cfg1 = dataclasses.replace(
        cfg0, camera=dataclasses.replace(CAM, k1=-0.1, k2=0.01)
    )
    f0 = process_mono(img, cfg0, 0.0)   # raw coords
    f1 = process_mono(img, cfg1, 0.0)   # undistorted coords
    valid = np.asarray(f0.features.valid)
    want = np.asarray(und.undistort_points(
        f0.features.xy, CAM.fx, CAM.fy, CAM.cx, CAM.cy, -0.1, 0.01, 0.0, 0.0
    ))
    got = np.asarray(f1.features.xy)
    err = np.abs(got[valid] - want[valid]).max()
    assert err < 1e-3, f"undistortion not applied (max err {err})"
    # the correction is non-trivial at the image border
    shift = np.abs(want[valid] - np.asarray(f0.features.xy)[valid]).max()
    assert shift > 1.0


def test_stereo_rectify_aligns_epipolar_rows():
    """After rectification, a 3-D point must project to the same row in
    both cameras and to disparity f*b/z (stereoRectify CALIB_ZERO_DISPARITY
    contract, reference: src/selflocalization.cpp:493)."""
    rng = np.random.default_rng(0)
    R = np.asarray(und.rodrigues(jnp.asarray([0.02, -0.03, 0.01])))
    b = 0.5
    T = R @ np.array([-b, 0.0, 0.0])   # right camera at +x in LEFT coords
    R1, R2, (fx, fy, cx, cy), base = und.stereo_rectify(
        jnp.asarray(R, dtype=jnp.float32), jnp.asarray(T, dtype=jnp.float32),
        320.0, 318.0, 256.0, 126.0, 322.0, 321.0, 254.0, 130.0,
    )
    R1, R2 = np.asarray(R1), np.asarray(R2)
    assert abs(float(base) - b) < 1e-5
    pts = np.stack([
        rng.uniform(-4, 4, 50), rng.uniform(-2, 2, 50), rng.uniform(4, 30, 50)
    ], -1)

    def proj(Rrect, offs):
        pc = (pts + offs) @ Rrect.T
        return (
            float(fx) * pc[:, 0] / pc[:, 2] + float(cx),
            float(fy) * pc[:, 1] / pc[:, 2] + float(cy),
            pc[:, 2],
        )

    # left camera at origin; right camera centre at -R^T T in left coords
    c2 = -R.T @ T
    uL, vL, zL = proj(R1, 0.0)
    uR, vR, zR = proj(R2 @ R, -c2)     # p_r-rect = R2 (R p + T) = R2 R (p - c2)
    np.testing.assert_allclose(vL, vR, atol=1e-3)
    disparity = uL - uR
    np.testing.assert_allclose(disparity, float(fx) * b / zL, rtol=1e-4)

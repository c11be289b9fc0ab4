"""Front-end tests: FAST, extraction, descriptors, stereo depth — on a
synthetic rendered world with known geometry (SURVEY.md section 4 strategy:
kernel unit tests + miniature synthetic fixture)."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from opendlv_perception_vision_orbslam2_jax.models import frontend
from opendlv_perception_vision_orbslam2_jax.models.extractor import (
    extract_features,
    per_level_budgets,
)
from opendlv_perception_vision_orbslam2_jax.ops import fast as fast_ops
from opendlv_perception_vision_orbslam2_jax.ops import hamming as ham
from opendlv_perception_vision_orbslam2_jax.ops import orb as orb_ops
from opendlv_perception_vision_orbslam2_jax.utils import synthetic
from opendlv_perception_vision_orbslam2_jax.utils.config import (
    CameraConfig,
    OrbConfig,
    SystemConfig,
)

# Small camera for CPU-speed tests.
TEST_CAM = CameraConfig(
    fx=320.0, fy=320.0, cx=256.0, cy=128.0, bf=0.5 * 320.0,  # KITTI-like baseline
    width=512, height=256, fps=10.0,
)
TEST_ORB = OrbConfig(n_features=600, max_keypoints=1024, n_levels=4)
TEST_CFG = SystemConfig(camera=TEST_CAM, orb=TEST_ORB)


@pytest.fixture(scope="module")
def world_frame():
    cfg = TEST_CFG
    world = synthetic.make_world(250, seed=3, x_range=(-8, 8), y_range=(-3, 3),
                                 z_range=(3.0, 25.0))
    T_cw = jnp.eye(4)
    img = synthetic.render_view(
        T_cw, world, cfg.camera.height, cfg.camera.width,
        cfg.camera.fx, cfg.camera.fy, cfg.camera.cx, cfg.camera.cy,
    )
    return cfg, world, img


def test_fast_detects_synthetic_corners(world_frame):
    _, _, img = world_frame
    scores = fast_ops.fast_score_map(img, 20.0)
    assert int(jnp.sum(scores > 0)) > 100  # sprites produce corners


def test_fast_rejects_flat_image():
    img = jnp.full((64, 64), 50.0)
    scores = fast_ops.fast_score_map(img, 7.0)
    assert int(jnp.sum(scores > 0)) == 0


def test_fast_single_bright_dot():
    img = jnp.full((32, 32), 10.0).at[16, 16].set(200.0)
    scores = fast_ops.fast_score_map(img, 20.0)
    # a lone bright pixel is a (degenerate) corner at its location
    assert float(scores[16, 16]) > 0


def test_per_level_budgets_sum():
    budgets = per_level_budgets(2000, 1.2, 8)
    assert sum(budgets) == 2000
    assert budgets[0] > budgets[-1]
    assert all(b > 0 for b in budgets)


def test_extract_features_finds_sprites(world_frame):
    cfg, world, img = world_frame
    feats = extract_features(img, cfg.orb)
    n_valid = int(jnp.sum(feats.valid))
    assert n_valid > 100
    # keypoints must be near rendered sprite projections
    from opendlv_perception_vision_orbslam2_jax.ops import lie

    uv = np.asarray(
        lie.project(world.points, cfg.camera.fx, cfg.camera.fy,
                    cfg.camera.cx, cfg.camera.cy)
    )
    kp = np.asarray(feats.xy)[np.asarray(feats.valid)]
    d = np.min(
        np.linalg.norm(kp[:, None, :] - uv[None, :, :], axis=-1), axis=1
    )
    assert np.median(d) < 5.0  # most keypoints sit on sprites


def test_descriptors_stable_across_views(world_frame):
    """Same scene from a slightly moved camera: matched descriptors must be
    closer in Hamming distance than random pairs."""
    cfg, world, img0 = world_frame
    T1 = jnp.eye(4).at[2, 3].set(-0.1)  # small forward step
    img1 = synthetic.render_view(
        T1, world, cfg.camera.height, cfg.camera.width,
        cfg.camera.fx, cfg.camera.fy, cfg.camera.cx, cfg.camera.cy,
    )
    f0 = extract_features(img0, cfg.orb)
    f1 = extract_features(img1, cfg.orb)
    dist = ham.hamming_matrix(f0.desc, f1.desc)
    mask = f0.valid[:, None] & f1.valid[None, :]
    best = jnp.min(jnp.where(mask, dist, 257), axis=1)
    best = best[f0.valid]
    # ORB self-similarity: most best-matches well under TH_LOW
    assert float(jnp.median(best)) < ham.TH_LOW


def test_hamming_kernels_agree():
    rng = np.random.default_rng(0)
    a = jnp.asarray(rng.integers(0, 2**32, (64, 8), dtype=np.uint32))
    b = jnp.asarray(rng.integers(0, 2**32, (96, 8), dtype=np.uint32))
    d1 = ham.hamming_matrix_xor(a, b)
    d2 = ham.hamming_matrix_mxu(a, b)
    np.testing.assert_array_equal(np.asarray(d1), np.asarray(d2))


def test_pack_unpack_roundtrip():
    rng = np.random.default_rng(1)
    d = jnp.asarray(rng.integers(0, 2**32, (16, 8), dtype=np.uint32))
    np.testing.assert_array_equal(
        np.asarray(orb_ops.pack_bits(orb_ops.unpack_bits(d))), np.asarray(d)
    )


def test_stereo_depth_accuracy(world_frame):
    """Stereo-matched depths must agree with ground-truth point depths."""
    cfg, world, img_left = world_frame
    cam = cfg.camera
    b = cam.baseline_m
    T_rl = jnp.eye(4).at[0, 3].set(-b)
    img_right = synthetic.render_view(
        T_rl, world, cam.height, cam.width, cam.fx, cam.fy, cam.cx, cam.cy
    )
    frame = frontend.process_stereo(img_left, img_right, cfg)
    depth = np.asarray(frame.features.depth)
    xy = np.asarray(frame.features.xy)
    has_depth = depth > 0
    assert has_depth.sum() > 50

    # ground truth: nearest projected world point
    from opendlv_perception_vision_orbslam2_jax.ops import lie

    uv = np.asarray(lie.project(world.points, cam.fx, cam.fy, cam.cx, cam.cy))
    z_gt = np.asarray(world.points[:, 2])
    errs = []
    for i in np.where(has_depth)[0]:
        j = np.argmin(np.linalg.norm(uv - xy[i], axis=1))
        if np.linalg.norm(uv[j] - xy[i]) < 3.0:
            errs.append(abs(depth[i] - z_gt[j]) / z_gt[j])
    errs = np.asarray(errs)
    assert len(errs) > 40
    assert np.median(errs) < 0.05  # <5% median relative depth error


def test_undistort_points_inverts_distortion():
    from opendlv_perception_vision_orbslam2_jax.ops import undistort as ud

    rng = np.random.default_rng(3)
    fx = fy = 400.0
    cx, cy = 320.0, 200.0
    k = dict(k1=-0.28, k2=0.07, p1=1e-3, p2=-5e-4, k3=0.0)
    xy_n = rng.uniform(-0.5, 0.5, (200, 2)).astype(np.float32)
    xy_d = np.asarray(ud.distort_normalized(jnp.asarray(xy_n), **k))
    uv_d = xy_d * [fx, fy] + [cx, cy]
    uv_u = np.asarray(ud.undistort_points(
        jnp.asarray(uv_d.astype(np.float32)), fx, fy, cx, cy,
        k["k1"], k["k2"], k["p1"], k["p2"], k["k3"],
    ))
    uv_true = xy_n * [fx, fy] + [cx, cy]
    np.testing.assert_allclose(uv_u, uv_true, atol=0.05)


def test_remap_identity_grid():
    from opendlv_perception_vision_orbslam2_jax.ops import undistort as ud

    rng = np.random.default_rng(4)
    img = jnp.asarray(rng.uniform(0, 255, (32, 48)).astype(np.float32))
    ys, xs = np.mgrid[0:32, 0:48]
    grid = jnp.asarray(np.stack([xs, ys], -1).astype(np.float32))
    out = ud.remap_bilinear(img, grid)
    np.testing.assert_allclose(np.asarray(out), np.asarray(img), atol=1e-3)

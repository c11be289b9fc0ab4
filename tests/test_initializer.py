"""Monocular two-view initializer tests: F-case (general motion) and H-case
(planar scene)."""

import numpy as np
import jax
import jax.numpy as jnp

from opendlv_perception_vision_orbslam2_jax.models.initializer import (
    initialize_two_view,
)
from opendlv_perception_vision_orbslam2_jax.ops import lie

CAM = dict(fx=320.0, fy=320.0, cx=256.0, cy=128.0)


def _project(pts, T):
    p = pts @ np.asarray(T)[:3, :3].T + np.asarray(T)[:3, 3]
    u = CAM["fx"] * p[:, 0] / p[:, 2] + CAM["cx"]
    v = CAM["fy"] * p[:, 1] / p[:, 2] + CAM["cy"]
    return np.stack([u, v], -1).astype(np.float32), p[:, 2]


def _run_init(pts, T21, noise=0.3, seed=0):
    rng = np.random.default_rng(seed)
    uv1, z1 = _project(pts, np.eye(4))
    uv2, z2 = _project(pts, T21)
    valid = (z1 > 0.5) & (z2 > 0.5)
    uv1 += rng.standard_normal(uv1.shape) * noise
    uv2 += rng.standard_normal(uv2.shape) * noise
    return initialize_two_view(
        jnp.asarray(uv1), jnp.asarray(uv2), jnp.asarray(valid),
        jax.random.PRNGKey(1), **CAM,
    )


def _rel_err(T_est, T_gt):
    # translation only up to scale: compare directions
    t_e = np.asarray(T_est)[:3, 3]
    t_g = np.asarray(T_gt)[:3, 3]
    t_e = t_e / (np.linalg.norm(t_e) + 1e-12)
    t_g = t_g / (np.linalg.norm(t_g) + 1e-12)
    dir_err = np.arccos(np.clip(np.abs(t_e @ t_g), -1, 1))
    dR = np.asarray(T_est)[:3, :3].T @ np.asarray(T_gt)[:3, :3]
    ang = np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1))
    return dir_err, ang


def test_init_general_scene_fundamental():
    rng = np.random.default_rng(3)
    pts = np.stack(
        [rng.uniform(-6, 6, 300), rng.uniform(-3, 3, 300),
         rng.uniform(5, 25, 300)], axis=-1,
    ).astype(np.float32)
    # sideways + slight forward translation with small rotation
    xi = np.array([0.6, 0.05, 0.2, 0.0, 0.03, 0.0], np.float32)
    T21 = np.asarray(lie.exp_se3(jnp.asarray(xi)))
    res = _run_init(pts, T21)
    assert bool(res.success)
    dir_err, ang = _rel_err(res.T_21, T21)
    assert dir_err < 0.05          # translation direction within ~3 deg
    assert ang < 0.02
    assert int(jnp.sum(res.point_ok)) > 150
    # triangulated depths positive and correlated with truth (up to scale)
    X = np.asarray(res.points)[np.asarray(res.point_ok)]
    z_est = X[:, 2]
    assert (z_est > 0).mean() > 0.99


def test_init_planar_ambiguity_rejected():
    """An EXACT plane is inherently twofold-ambiguous under H decomposition
    (the conjugate Faugeras solution reprojects perfectly too), so the
    reference's ``secondBest < 0.75*best`` gate must refuse to initialize
    (ReconstructH, reference: src/orbinitializer.cpp:700-730).  Accepting
    here would mean gambling on the wrong motion half the time."""
    rng = np.random.default_rng(4)
    x = rng.uniform(-6, 6, 300)
    y = rng.uniform(-3, 3, 300)
    z = 10.0 + 0.2 * x
    pts = np.stack([x, y, z], -1).astype(np.float32)
    xi = np.array([0.5, 0.1, 0.1, 0.0, 0.04, 0.01], np.float32)
    T21 = np.asarray(lie.exp_se3(jnp.asarray(xi)))
    res = _run_init(pts, T21, noise=0.2)
    assert bool(res.used_homography)
    assert not bool(res.success)


def test_init_planar_scene_with_relief():
    """A dominant plane with modest out-of-plane relief (the realistic
    'planar scene') must initialize with an accurate motion: the relief
    breaks the conjugate-plane ambiguity."""
    rng = np.random.default_rng(4)
    x = rng.uniform(-4, 4, 300)
    y = rng.uniform(-2.5, 2.5, 300)
    z = 6.0 + 0.2 * x + rng.uniform(-0.6, 0.6, 300)
    pts = np.stack([x, y, z], -1).astype(np.float32)
    xi = np.array([0.8, 0.1, 0.1, 0.0, 0.04, 0.01], np.float32)
    T21 = np.asarray(lie.exp_se3(jnp.asarray(xi)))
    res = _run_init(pts, T21, noise=0.2)
    assert bool(res.success)
    dir_err, ang = _rel_err(res.T_21, T21)
    assert dir_err < 0.08
    assert ang < 0.03


def test_faugeras_decomposition_contains_true_motion():
    """decompose_homography must return the full 8-solution Faugeras set:
    for an exact plane-induced homography H = K (R + t n^T / d) K^-1 the
    true (R, t/||t||) must appear among the 8 candidates (ReconstructH,
    reference: src/orbinitializer.cpp:573-730)."""
    from opendlv_perception_vision_orbslam2_jax.models.initializer import (
        decompose_homography,
    )

    K = np.array([[320.0, 0, 256.0], [0, 320.0, 128.0], [0, 0, 1.0]],
                 np.float32)
    rng = np.random.default_rng(11)
    for trial in range(5):
        xi = np.concatenate([
            rng.uniform(-0.5, 0.5, 3), rng.uniform(-0.1, 0.1, 3)
        ]).astype(np.float32)
        T = np.asarray(lie.exp_se3(jnp.asarray(xi)))
        R_true, t_true = T[:3, :3], T[:3, 3]
        n = np.array([0.2, -0.1, -1.0], np.float32)
        n /= np.linalg.norm(n)
        d = 8.0
        H = K @ (R_true + np.outer(t_true, n) / d) @ np.linalg.inv(K)
        R8, t8 = decompose_homography(jnp.asarray(H), jnp.asarray(K))
        t_dir = t_true / (np.linalg.norm(t_true) + 1e-12)
        best_r = min(float(jnp.linalg.norm(R8[i] - R_true))
                     for i in range(8))
        best_t = max(float(jnp.dot(t8[i], t_dir)) for i in range(8))
        assert best_r < 1e-3, (trial, best_r)
        assert best_t > 0.999, (trial, best_t)


def test_init_rejects_pure_rotation():
    rng = np.random.default_rng(5)
    pts = np.stack(
        [rng.uniform(-6, 6, 300), rng.uniform(-3, 3, 300),
         rng.uniform(5, 25, 300)], axis=-1,
    ).astype(np.float32)
    xi = np.array([0.0, 0.0, 0.0, 0.0, 0.06, 0.0], np.float32)  # rotation only
    T21 = np.asarray(lie.exp_se3(jnp.asarray(xi)))
    res = _run_init(pts, T21, noise=0.3)
    # no parallax => must not initialize
    assert not bool(res.success)

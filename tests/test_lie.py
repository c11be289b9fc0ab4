"""Unit tests for SE3/Sim3 ops against NumPy/scipy-free oracles."""

import numpy as np
import jax.numpy as jnp
import pytest

from opendlv_perception_vision_orbslam2_jax.ops import lie


def random_rotation(rng):
    """Gram-Schmidt a random matrix into SO(3)."""
    A = rng.standard_normal((3, 3))
    Q, _ = np.linalg.qr(A)
    if np.linalg.det(Q) < 0:
        Q[:, 0] *= -1
    return Q


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_so3_exp_log_roundtrip(seed):
    rng = np.random.default_rng(seed)
    phi = rng.standard_normal((16, 3)).astype(np.float32)
    phi *= rng.uniform(0.001, 2.5, size=(16, 1))
    R = lie.exp_so3(jnp.asarray(phi))
    phi_back = lie.log_so3(R)
    R_back = lie.exp_so3(phi_back)
    np.testing.assert_allclose(np.asarray(R_back), np.asarray(R), atol=2e-5)


def test_so3_exp_matches_rodrigues_formula():
    rng = np.random.default_rng(7)
    phi = rng.standard_normal(3).astype(np.float32)
    theta = np.linalg.norm(phi)
    k = phi / theta
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    R_np = np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)
    R = lie.exp_so3(jnp.asarray(phi))
    np.testing.assert_allclose(np.asarray(R), R_np, atol=1e-5)


def test_so3_small_angle():
    phi = jnp.array([1e-9, -1e-9, 1e-9], dtype=jnp.float32)
    R = lie.exp_so3(phi)
    np.testing.assert_allclose(np.asarray(R), np.eye(3), atol=1e-6)


def test_se3_exp_log_roundtrip():
    rng = np.random.default_rng(11)
    xi = (rng.standard_normal((8, 6)) * 0.8).astype(np.float32)
    T = lie.exp_se3(jnp.asarray(xi))
    xi_back = lie.log_se3(T)
    T_back = lie.exp_se3(xi_back)
    np.testing.assert_allclose(np.asarray(T_back), np.asarray(T), atol=2e-5)


def test_se3_inverse_and_compose():
    rng = np.random.default_rng(3)
    xi = (rng.standard_normal((4, 6)) * 0.5).astype(np.float32)
    T = lie.exp_se3(jnp.asarray(xi))
    I = jnp.einsum("bij,bjk->bik", T, lie.inv_T(T))
    np.testing.assert_allclose(
        np.asarray(I), np.broadcast_to(np.eye(4), (4, 4, 4)), atol=1e-5
    )


def test_transform_points_matches_numpy():
    rng = np.random.default_rng(5)
    R = random_rotation(rng).astype(np.float32)
    t = rng.standard_normal(3).astype(np.float32)
    pts = rng.standard_normal((32, 3)).astype(np.float32)
    T = lie.make_T(jnp.asarray(R), jnp.asarray(t))
    out = lie.transform_points(T, jnp.asarray(pts))
    np.testing.assert_allclose(np.asarray(out), pts @ R.T + t, atol=1e-5)


def test_sim3_compose_inverse_identity():
    rng = np.random.default_rng(9)
    zeta = (rng.standard_normal((5, 7)) * 0.4).astype(np.float32)
    R, t, s = lie.exp_sim3(jnp.asarray(zeta))
    Ri, ti, si = lie.sim3_inverse(R, t, s)
    Rc, tc, sc = lie.sim3_compose(R, t, s, Ri, ti, si)
    np.testing.assert_allclose(
        np.asarray(Rc), np.broadcast_to(np.eye(3), (5, 3, 3)), atol=1e-5
    )
    np.testing.assert_allclose(np.asarray(tc), np.zeros((5, 3)), atol=1e-5)
    np.testing.assert_allclose(np.asarray(sc), np.ones(5), atol=1e-5)


def test_sim3_apply_scale_only():
    R = jnp.eye(3)[None]
    t = jnp.zeros((1, 3))
    s = jnp.array([2.0])
    pts = jnp.ones((1, 4, 3))
    out = lie.sim3_apply(R, t, s, pts)
    np.testing.assert_allclose(np.asarray(out), 2.0 * np.ones((1, 4, 3)), atol=1e-6)


def test_project_backproject_roundtrip():
    fx, fy, cx, cy = 718.856, 718.856, 607.19, 185.22
    rng = np.random.default_rng(2)
    pts = np.stack(
        [
            rng.uniform(-5, 5, 64),
            rng.uniform(-2, 2, 64),
            rng.uniform(2.0, 40.0, 64),
        ],
        axis=-1,
    ).astype(np.float32)
    uv = lie.project(jnp.asarray(pts), fx, fy, cx, cy)
    pts_back = lie.backproject(uv, jnp.asarray(pts[:, 2]), fx, fy, cx, cy)
    np.testing.assert_allclose(np.asarray(pts_back), pts, rtol=1e-4, atol=1e-3)


def test_triangulate_linear_recovers_points():
    rng = np.random.default_rng(4)
    K = np.array([[718.0, 0, 607.0], [0, 718.0, 185.0], [0, 0, 1.0]], np.float32)
    pts = np.stack(
        [rng.uniform(-4, 4, 50), rng.uniform(-2, 2, 50), rng.uniform(5, 30, 50)],
        axis=-1,
    ).astype(np.float32)
    R = random_rotation(np.random.default_rng(8)).astype(np.float32) * 0
    R = np.eye(3, dtype=np.float32)
    t2 = np.array([-0.54, 0.0, 0.0], np.float32)  # KITTI-ish baseline
    P1 = K @ np.hstack([np.eye(3), np.zeros((3, 1))]).astype(np.float32)
    P2 = K @ np.hstack([R, t2[:, None]]).astype(np.float32)

    def proj(P, X):
        Xh = np.hstack([X, np.ones((len(X), 1), np.float32)])
        x = Xh @ P.T
        return x[:, :2] / x[:, 2:3]

    uv1, uv2 = proj(P1, pts), proj(P2, pts)
    X = lie.triangulate_linear(
        jnp.asarray(P1), jnp.asarray(P2), jnp.asarray(uv1), jnp.asarray(uv2)
    )
    np.testing.assert_allclose(np.asarray(X), pts, rtol=1e-2, atol=5e-2)

"""SE(3) / Sim(3) Lie-group operations, batched and jit-friendly.

Capability parity: the reference keeps poses as OpenCV ``cv::Mat`` 4x4 floats
converted to ``g2o::SE3Quat`` / ``g2o::Sim3`` for optimization
(reference: src/orbconverter.cpp:38, src/orboptimizer.cpp:35-38).  Here poses
are plain ``[..., 4, 4]`` float32 arrays and optimizer updates live in the
tangent space (``exp``/``log`` below), so every routine vmaps/jits cleanly.

Conventions:
- SE3 tangent ``xi = [rho(3), phi(3)]`` (translation part first, like g2o).
- Sim3 tangent ``zeta = [rho(3), phi(3), sigma(1)]`` with scale ``s = exp(sigma)``.
- ``T_cw`` maps world points to camera points: ``x_c = R x_w + t``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_EPS = 1e-8


def hat(w):
    """Skew-symmetric matrix of ``[..., 3]`` -> ``[..., 3, 3]``.

    Mirrors Mapping::SkewSymmetricMatrix (reference: src/mapping.cpp:726-736).
    """
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = jnp.zeros_like(wx)
    return jnp.stack(
        [
            jnp.stack([zero, -wz, wy], axis=-1),
            jnp.stack([wz, zero, -wx], axis=-1),
            jnp.stack([-wy, wx, zero], axis=-1),
        ],
        axis=-2,
    )


def exp_so3(phi):
    """Rodrigues: ``[..., 3]`` axis-angle -> ``[..., 3, 3]`` rotation."""
    theta2 = jnp.sum(phi * phi, axis=-1)
    theta = jnp.sqrt(theta2 + _EPS)
    # Taylor-safe coefficients.
    a = jnp.sin(theta) / theta
    b = (1.0 - jnp.cos(theta)) / (theta2 + _EPS)
    small = theta2 < 1e-8
    a = jnp.where(small, 1.0 - theta2 / 6.0, a)
    b = jnp.where(small, 0.5 - theta2 / 24.0, b)
    K = hat(phi)
    I = jnp.broadcast_to(jnp.eye(3, dtype=phi.dtype), K.shape)
    return I + a[..., None, None] * K + b[..., None, None] * (K @ K)


def log_so3(R):
    """Inverse Rodrigues: ``[..., 3, 3]`` -> ``[..., 3]`` axis-angle.

    AD-safe at the identity: theta comes from atan2(|w|, cos) with an
    epsilon-padded norm instead of arccos, so forward-mode Jacobians of
    pose-graph residuals at zero error are finite (arccos'(1) = -inf would
    poison the whole normal system otherwise).
    """
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = jnp.clip((trace - 1.0) * 0.5, -1.0, 1.0)
    # Antisymmetric part -> axis * sin(theta)
    w = 0.5 * jnp.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        axis=-1,
    )
    sin_theta = jnp.sqrt(jnp.sum(w * w, axis=-1) + _EPS * _EPS)
    theta = jnp.arctan2(sin_theta, cos_theta)
    scale = theta / sin_theta          # >= _EPS, safe and smooth near 0
    w_gen = w * scale[..., None]
    # Near theta = pi the antisymmetric part vanishes; recover axis from the
    # symmetric part: R + I = 2 (I + hat^2/theta^2 ...) -> axis^2 from diagonal.
    near_pi = theta > 3.0
    diag = jnp.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], axis=-1)
    axis_sq = jnp.clip((diag - cos_theta[..., None]) / (1.0 - cos_theta[..., None] + _EPS), 0.0, 1.0)
    axis = jnp.sqrt(axis_sq)
    # Fix signs using off-diagonal symmetric entries.
    sign_xy = jnp.sign(R[..., 0, 1] + R[..., 1, 0] + _EPS)
    sign_xz = jnp.sign(R[..., 0, 2] + R[..., 2, 0] + _EPS)
    sx = jnp.where(w[..., 0] < 0, -1.0, 1.0)  # tie-break with antisymmetric remnant
    axis = axis * jnp.stack([sx, sx * sign_xy, sx * sign_xz], axis=-1)
    w_pi = axis * theta[..., None]
    return jnp.where(near_pi[..., None], w_pi, w_gen)


def _so3_left_jacobian(phi):
    """Left Jacobian J of SO(3): exp_se3 translation column uses V = J."""
    theta2 = jnp.sum(phi * phi, axis=-1)
    theta = jnp.sqrt(theta2 + _EPS)
    K = hat(phi)
    I = jnp.broadcast_to(jnp.eye(3, dtype=phi.dtype), K.shape)
    a = (1.0 - jnp.cos(theta)) / (theta2 + _EPS)
    b = (theta - jnp.sin(theta)) / (theta2 * theta + _EPS)
    small = theta2 < 1e-8
    a = jnp.where(small, 0.5 - theta2 / 24.0, a)
    b = jnp.where(small, 1.0 / 6.0 - theta2 / 120.0, b)
    return I + a[..., None, None] * K + b[..., None, None] * (K @ K)


def exp_se3(xi):
    """``[..., 6]`` (rho, phi) -> ``[..., 4, 4]`` homogeneous transform."""
    rho, phi = xi[..., :3], xi[..., 3:]
    R = exp_so3(phi)
    V = _so3_left_jacobian(phi)
    t = jnp.einsum("...ij,...j->...i", V, rho)
    return make_T(R, t)


def log_se3(T):
    """``[..., 4, 4]`` -> ``[..., 6]`` (rho, phi)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    phi = log_so3(R)
    V = _so3_left_jacobian(phi)
    rho = jnp.linalg.solve(V, t[..., None])[..., 0]
    return jnp.concatenate([rho, phi], axis=-1)


def make_T(R, t):
    """Assemble ``[..., 4, 4]`` from rotation ``[..., 3, 3]`` and translation."""
    batch = jnp.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = jnp.broadcast_to(R, batch + (3, 3))
    t = jnp.broadcast_to(t, batch + (3,))
    top = jnp.concatenate([R, t[..., :, None]], axis=-1)
    bottom = jnp.broadcast_to(
        jnp.array([0.0, 0.0, 0.0, 1.0], dtype=R.dtype), batch + (1, 4)
    )
    return jnp.concatenate([top, bottom], axis=-2)


def inv_T(T):
    """Closed-form inverse of a rigid transform (no linear solve)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = jnp.swapaxes(R, -1, -2)
    return make_T(Rt, -jnp.einsum("...ij,...j->...i", Rt, t))


def transform_points(T, pts):
    """Apply ``[..., 4, 4]`` to points ``[..., N, 3]`` (or ``[..., 3]``)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    return jnp.einsum("...ij,...nj->...ni", R, jnp.atleast_2d(pts)) + t[..., None, :]


# ---------------------------------------------------------------------------
# Sim(3) — used by loop closing (reference: src/sim3solver.cpp:240-351,
# src/orboptimizer.cpp:799-1061 essential-graph vertices are g2o::Sim3).
# Representation: dict-free flat array [s (1), R (3x3), t (3)] is awkward;
# we carry (R, t, s) tuples or a packed [..., 8] = [quat-free] — here we use
# explicit triples for clarity.
# ---------------------------------------------------------------------------


def exp_sim3(zeta):
    """``[..., 7]`` (rho, phi, sigma) -> (R ``[...,3,3]``, t ``[...,3]``, s ``[...]``)."""
    rho, phi, sigma = zeta[..., :3], zeta[..., 3:6], zeta[..., 6]
    s = jnp.exp(sigma)
    R = exp_so3(phi)
    theta2 = jnp.sum(phi * phi, axis=-1)
    theta = jnp.sqrt(theta2 + _EPS)
    K = hat(phi)
    I = jnp.broadcast_to(jnp.eye(3, dtype=zeta.dtype), K.shape)

    # W matrix of Sim(3) exp (see Strasdat's thesis); series-safe blending.
    sig = sigma
    a_big = (s - 1.0) / jnp.where(jnp.abs(sig) < 1e-6, 1.0, sig)
    A = jnp.where(jnp.abs(sig) < 1e-6, 1.0 + sig / 2.0, a_big)

    st, ct = jnp.sin(theta), jnp.cos(theta)
    denom = sig * sig + theta2
    b_num = s * st * sig + (1.0 - s * ct) * theta
    B = jnp.where(denom < 1e-10, 0.5, b_num / (theta * jnp.where(denom < 1e-10, 1.0, denom)))
    c_num = A - (s * ct - 1.0) * sig / jnp.where(denom < 1e-10, 1.0, denom) - s * st * theta / jnp.where(denom < 1e-10, 1.0, denom)
    C = jnp.where(denom < 1e-10, 1.0 / 6.0, c_num / jnp.where(theta2 < 1e-10, 1.0, theta2))
    W = A[..., None, None] * I + B[..., None, None] * K + C[..., None, None] * (K @ K)
    t = jnp.einsum("...ij,...j->...i", W, rho)
    return R, t, s


def sim3_inverse(R, t, s):
    """(sR x + t)^{-1}: returns (R', t', s') with s' = 1/s."""
    Rt = jnp.swapaxes(R, -1, -2)
    s_inv = 1.0 / s
    t_inv = -s_inv[..., None] * jnp.einsum("...ij,...j->...i", Rt, t)
    return Rt, t_inv, s_inv


def sim3_compose(Ra, ta, sa, Rb, tb, sb):
    """Composition (a ∘ b)(x) = sa Ra (sb Rb x + tb) + ta."""
    R = Ra @ Rb
    s = sa * sb
    t = sa[..., None] * jnp.einsum("...ij,...j->...i", Ra, tb) + ta
    return R, t, s


def sim3_apply(R, t, s, pts):
    """Apply Sim3 to points ``[..., N, 3]``."""
    return s[..., None, None] * jnp.einsum("...ij,...nj->...ni", R, pts) + t[..., None, :]


# ---------------------------------------------------------------------------
# Pinhole camera
# ---------------------------------------------------------------------------


def project(pts_cam, fx, fy, cx, cy):
    """Project camera-frame points ``[..., N, 3]`` -> pixel coords ``[..., N, 2]``.

    Z is NOT clamped; callers mask on z > 0 (frustum check mirrors
    OrbFrame::IsInFrustum, reference: src/orbframe.cpp:239-305).
    """
    z = pts_cam[..., 2]
    inv_z = 1.0 / jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    u = fx * pts_cam[..., 0] * inv_z + cx
    v = fy * pts_cam[..., 1] * inv_z + cy
    return jnp.stack([u, v], axis=-1)


def orthonormalize_T(T):
    """Project the rotation block back onto SO(3) (Gram-Schmidt columns)
    and return the cleaned SE(3).  Long chains of pose compositions
    (velocity priors, rebases) accumulate scale in R — inv_T assumes an
    orthonormal R, so the drift otherwise compounds exponentially."""
    R = T[..., :3, :3]
    x = R[..., :, 0]
    x = x / (jnp.linalg.norm(x, axis=-1, keepdims=True) + 1e-12)
    y = R[..., :, 1]
    y = y - jnp.sum(x * y, axis=-1, keepdims=True) * x
    y = y / (jnp.linalg.norm(y, axis=-1, keepdims=True) + 1e-12)
    z = jnp.cross(x, y)
    R_o = jnp.stack([x, y, z], axis=-1)
    T_o = T.at[..., :3, :3].set(R_o)
    return T_o


def backproject(uv, depth, fx, fy, cx, cy):
    """Pixels + depth -> camera-frame 3D (OrbFrame::UnprojectStereo,
    reference: src/orbframe.cpp:730-744)."""
    x = (uv[..., 0] - cx) / fx * depth
    y = (uv[..., 1] - cy) / fy * depth
    return jnp.stack([x, y, depth], axis=-1)


def _inv3x3_sym(B):
    """Closed-form inverse of batched symmetric 3x3 (adjugate / det)."""
    a, b, c = B[..., 0, 0], B[..., 0, 1], B[..., 0, 2]
    e, f = B[..., 1, 1], B[..., 1, 2]
    i = B[..., 2, 2]
    A11 = e * i - f * f
    A12 = c * f - b * i
    A13 = b * f - c * e
    A22 = a * i - c * c
    A23 = c * b - a * f
    A33 = a * e - b * b
    det = a * A11 + b * A12 + c * A13
    det = jnp.where(jnp.abs(det) < 1e-18, 1e-18, det)
    adj = jnp.stack(
        [
            jnp.stack([A11, A12, A13], -1),
            jnp.stack([A12, A22, A23], -1),
            jnp.stack([A13, A23, A33], -1),
        ],
        axis=-2,
    )
    return adj / det[..., None, None]


def triangulate_linear(P1, P2, uv1, uv2):
    """DLT triangulation of pixel pairs under 3x4 projections ``P1, P2``.

    Batched equivalent of OrbInitializer::Triangulate (reference:
    src/orbinitializer.cpp:732-745).  The reference takes the 4x4 system's
    null space via SVD; batched tiny SVDs serialize badly on an
    accelerator (LAPACK-style inner loops), so this solves the equivalent
    *inhomogeneous* DLT instead: with the homogeneous scale pinned (w = 1,
    valid for the finite points SLAM triangulates — the cheirality/parallax
    gates downstream kill near-infinity candidates anyway), the system
    becomes ``M p = -b`` with M = A[:, :3], b = A[:, 3], solved in closed
    form through the 3x3 normal equations — pure batched elementwise math.
    uv: ``[..., N, 2]``; returns ``[..., N, 3]`` world points.
    """
    def rows(P, uv):
        return jnp.stack(
            [
                uv[..., 0, None] * P[..., 2, :] - P[..., 0, :],
                uv[..., 1, None] * P[..., 2, :] - P[..., 1, :],
            ],
            axis=-2,
        )

    A = jnp.concatenate(
        [rows(P1[..., None, :, :], uv1), rows(P2[..., None, :, :], uv2)],
        axis=-2,
    )                                                   # [..., N, 4, 4]
    # row normalization keeps the normal equations well-scaled across
    # image positions (rows differ by pixel magnitude)
    A = A / (jnp.linalg.norm(A, axis=-1, keepdims=True) + 1e-12)
    M = A[..., :3]
    b = A[..., 3]
    MtM = jnp.einsum("...ri,...rj->...ij", M, M)
    Mtb = jnp.einsum("...ri,...r->...i", M, b)
    return -jnp.einsum("...ij,...j->...i", _inv3x3_sym(MtM), Mtb)

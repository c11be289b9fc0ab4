"""Lens undistortion + stereo rectification as batched device ops.

Array replacements for the OpenCV calls in the live-camera path
(cv::undistortPoints in OrbFrame::UndistortKeyPoints, reference:
src/orbframe.cpp:448-479; cv::stereoRectify + initUndistortRectifyMap +
remap in Selflocalization::setUpRealtime/nextContainer, reference:
src/selflocalization.cpp:493-495, 274-286).

- ``undistort_points``: iterative inverse of the radial/tangential model
  (k1,k2,k3,p1,p2) — vmapped over all keypoints.
- ``build_rectify_map`` / ``remap_bilinear``: precomputed sampling grid +
  one gather-based bilinear warp per frame, fused under jit.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def distort_normalized(xy, k1, k2, p1, p2, k3):
    """Forward distortion of normalized coords [..., 2]."""
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return jnp.stack([xd, yd], axis=-1)


@functools.partial(jax.jit, static_argnames=("iters",))
def undistort_points(uv, fx, fy, cx, cy, k1, k2, p1, p2, k3=0.0,
                     iters: int = 8):
    """Pixel coords -> undistorted pixel coords (fixed-point iteration,
    the same scheme cv::undistortPoints uses)."""
    xd = jnp.stack([(uv[..., 0] - cx) / fx, (uv[..., 1] - cy) / fy], axis=-1)

    def body(_, x):
        d = distort_normalized(x, k1, k2, p1, p2, k3) - x
        return xd - d

    x = jax.lax.fori_loop(0, iters, body, xd)
    return jnp.stack(
        [x[..., 0] * fx + cx, x[..., 1] * fy + cy], axis=-1
    )


def build_rectify_map(height: int, width: int, fx, fy, cx, cy,
                      k1, k2, p1, p2, k3, R_rect, fx_new, fy_new,
                      cx_new, cy_new):
    """Sampling grid [H, W, 2] mapping rectified pixels -> source pixels
    (initUndistortRectifyMap semantics: for each destination pixel, rotate
    by R_rect^-1 into the original camera, then apply forward distortion)."""
    ys, xs = jnp.mgrid[0:height, 0:width]
    xn = (xs.astype(jnp.float32) - cx_new) / fx_new
    yn = (ys.astype(jnp.float32) - cy_new) / fy_new
    rays = jnp.stack([xn, yn, jnp.ones_like(xn)], axis=-1)
    rays = jnp.einsum("ij,hwj->hwi", jnp.linalg.inv(R_rect), rays)
    xy = rays[..., :2] / jnp.maximum(rays[..., 2:3], 1e-9)
    xyd = distort_normalized(xy, k1, k2, p1, p2, k3)
    return jnp.stack(
        [xyd[..., 0] * fx + cx, xyd[..., 1] * fy + cy], axis=-1
    )


@jax.jit
def remap_bilinear(img, grid):
    """cv::remap equivalent: sample ``img [H, W]`` at ``grid [H', W', 2]``."""
    H, W = img.shape
    x = jnp.clip(grid[..., 0], 0.0, W - 1.0)
    y = jnp.clip(grid[..., 1], 0.0, H - 1.0)
    x0 = jnp.clip(jnp.floor(x).astype(jnp.int32), 0, W - 2)
    y0 = jnp.clip(jnp.floor(y).astype(jnp.int32), 0, H - 2)
    fx_ = x - x0
    fy_ = y - y0
    flat = img.reshape(-1)

    def at(yy, xx):
        return jnp.take(flat, yy * W + xx, axis=0)

    v = (
        at(y0, x0) * (1 - fx_) * (1 - fy_)
        + at(y0, x0 + 1) * fx_ * (1 - fy_)
        + at(y0 + 1, x0) * (1 - fx_) * fy_
        + at(y0 + 1, x0 + 1) * fx_ * fy_
    )
    return v


def rodrigues(rvec):
    """Rotation vector -> matrix (cv::Rodrigues for the reference's
    ``Camera.rx/cv/rz`` relative-rotation flags,
    reference: src/selflocalization.cpp:486-487)."""
    theta = jnp.linalg.norm(rvec) + 1e-12
    k = rvec / theta
    K = jnp.array([
        [0.0, -k[2], k[1]],
        [k[2], 0.0, -k[0]],
        [-k[1], k[0], 0.0],
    ])
    return (
        jnp.eye(3) + jnp.sin(theta) * K + (1.0 - jnp.cos(theta)) * (K @ K)
    )


def stereo_rectify(R, T, fx_l, fy_l, cx_l, cy_l, fx_r, fy_r, cx_r, cy_r):
    """Rectifying rotations + shared pinhole for a stereo pair.

    Geometric core of cv::stereoRectify with CALIB_ZERO_DISPARITY
    (reference: src/selflocalization.cpp:493): both cameras are rotated so
    their x-axes align with the baseline and share one orientation, making
    epipolar lines horizontal with equal y.  ``R, T``: pose of the right
    camera w.r.t. the left (p_r = R p_l + T).  Returns
    ``(R1, R2, (fx, fy, cx, cy), baseline)`` — new shared intrinsics keep
    the left focal length and average the principal points (the reference
    adopts P1's values the same way, :497-501; alpha-cropping is framing
    only and intentionally omitted).
    """
    c2 = -R.T @ T                       # right camera centre in left coords
    baseline = jnp.linalg.norm(c2)
    e1 = c2 / (baseline + 1e-12)
    e1 = jnp.where(e1[0] < 0, -e1, e1)  # +x toward the right camera
    z_avg = jnp.array([0.0, 0.0, 1.0]) + R.T @ jnp.array([0.0, 0.0, 1.0])
    e2 = jnp.cross(z_avg, e1)
    e2 = e2 / (jnp.linalg.norm(e2) + 1e-12)
    e3 = jnp.cross(e1, e2)
    R1 = jnp.stack([e1, e2, e3])        # rows: rectified axes in left coords
    R2 = R1 @ R.T
    f_new = fx_l
    cx_new = 0.5 * (cx_l + cx_r)
    cy_new = 0.5 * (cy_l + cy_r)
    return R1, R2, (f_new, f_new, cx_new, cy_new), baseline

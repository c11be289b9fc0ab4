"""Stereo frame front-end: images in, FrameState out (one jitted call).

Array re-design of the stereo OrbFrame constructor (reference:
src/orbframe.cpp:61-88: two extraction threads + ComputeStereoMatches +
AssignFeaturesToGrid) — here pyramid building, extraction for both eyes,
stereo matching and unprojection fuse into a single XLA program.  The bucket
grid is unnecessary: candidate gating happens with dense masks in the
matchers (see ops/hamming.py), which keeps every shape static.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..ops import image as image_ops
from ..ops import lie
from ..ops import stereo as stereo_ops
from ..utils.config import SystemConfig
from .extractor import extract_from_pyramid, extract_from_pyramid_pair
from .frame import Features, FrameState


def _bbox_filter(feats: Features, config: SystemConfig) -> Features:
    """Invalidate keypoints inside the configured BoundingBox — the
    reference drops ego-vehicle (hood) keypoints this way (FilterKeyPoints,
    reference: src/orbframe.cpp:403-445; enabled when MaxX > 2)."""
    tr = config.tracking
    if tr.bbox_max_x <= 2:
        return feats
    x, y = feats.xy[:, 0], feats.xy[:, 1]
    inside = (
        (x > tr.bbox_min_x) & (x < tr.bbox_max_x)
        & (y > tr.bbox_min_y) & (y < tr.bbox_max_y)
    )
    return feats._replace(valid=feats.valid & ~inside)


def _undistort_features(feats: Features, config: SystemConfig,
                        shift_uright: bool = False) -> Features:
    """Undistort keypoint coordinates in place when the camera carries
    distortion (UndistortKeyPoints, reference: src/orbframe.cpp:448-479;
    gated on |k1| >= 1e-4 like the reference's 0.0001 check).

    With ``shift_uright`` the stereo right-coordinate moves by the same
    horizontal correction so disparity (measured on the raw pair) is
    preserved — the stereo path assumes rectified input like the reference,
    so this only matters for mildly-distorted rectified pairs.
    """
    cam = config.camera
    if abs(cam.k1) < 1e-4:
        return feats
    from ..ops.undistort import undistort_points

    xy_u = undistort_points(
        feats.xy, cam.fx, cam.fy, cam.cx, cam.cy,
        cam.k1, cam.k2, cam.p1, cam.p2, cam.k3,
    )
    out = feats._replace(xy=jnp.where(feats.valid[:, None], xy_u, feats.xy))
    if shift_uright:
        du = out.xy[:, 0] - feats.xy[:, 0]
        out = out._replace(
            u_right=jnp.where(out.u_right > 0, out.u_right + du, out.u_right)
        )
    return out


@functools.partial(jax.jit, static_argnums=(2,))
def process_stereo(img_left, img_right, config: SystemConfig, timestamp=0.0):
    """Grayscale stereo pair ``[H, W]`` float32 -> :class:`FrameState`.

    Pose initializes to identity; tracking owns pose estimation.
    """
    cam = config.camera
    orb = config.orb

    # Both eyes batch through one vmapped pyramid, then share a single
    # patch-atlas gather + describe stage — the array analogue of the
    # reference's two extraction threads (reference: src/orbframe.cpp:73-76)
    # with 2x the matmul rows per descriptor stage.
    both = jnp.stack([img_left, img_right])
    levels_lr = jax.vmap(
        lambda im: image_ops.build_pyramid(im, orb.n_levels, orb.scale_factor)
    )(both)
    feat_l, feat_r = extract_from_pyramid_pair(levels_lr, orb)
    # reference order: FilterKeyPoints/UndistortKeyPoints run before
    # ComputeStereoMatches (CommonSetup, reference: src/orbframe.cpp:77-78,
    # 149-173); the bbox applies to both eyes
    feat_l = _bbox_filter(feat_l, config)
    feat_r = _bbox_filter(feat_r, config)
    levels_l = [l[0] for l in levels_lr]
    levels_r = [l[1] for l in levels_lr]

    atlas_l, offsets = stereo_ops.build_atlas(levels_l)
    atlas_r, _ = stereo_ops.build_atlas(levels_r)
    u_right, depth = stereo_ops.stereo_match(
        feat_l, feat_r, atlas_l, atlas_r, offsets,
        orb.scale_factor, cam.fx, cam.bf,
    )
    feat_l = feat_l._replace(u_right=u_right, depth=depth)
    feat_l = _undistort_features(feat_l, config, shift_uright=True)

    point_cam = lie.backproject(
        feat_l.xy, jnp.maximum(depth, 1e-6), cam.fx, cam.fy, cam.cx, cam.cy
    )
    point_cam = jnp.where(depth[:, None] > 0, point_cam, 0.0)

    return FrameState(
        features=feat_l,
        T_cw=jnp.eye(4, dtype=jnp.float32),
        point_cam=point_cam,
        timestamp=jnp.asarray(timestamp, jnp.float32),
    )


@functools.partial(jax.jit, static_argnums=(2,))
def process_rgbd(img, depth_map, config: SystemConfig, timestamp=0.0):
    """Grayscale image + registered depth map -> :class:`FrameState`.

    RGB-D frame construction (GrabImageRGBD, reference:
    src/tracking.cpp:202-230, + ComputeStereoFromRGBD, reference:
    src/orbframe.cpp:707-728): depth is read from the registered map at each
    keypoint's pixel and a virtual right-image coordinate
    ``u_right = u - bf/d`` is synthesized, after which the frame is
    indistinguishable from a stereo frame for the rest of the system.
    """
    cam = config.camera
    orb = config.orb

    levels = image_ops.build_pyramid(img, orb.n_levels, orb.scale_factor)
    feats = extract_from_pyramid(levels, orb)
    feats = _bbox_filter(feats, config)
    # depth is read at the RAW (distorted) pixel, then coordinates are
    # undistorted and u_right synthesized from the undistorted x — the
    # reference's order (CommonSetup before ComputeStereoFromRGBD,
    # reference: src/orbframe.cpp:143-147, 707-728)
    raw_xy = feats.xy
    feats = _undistort_features(feats, config)

    # DepthMapFactor convention (reference: src/tracking.cpp:136-149):
    # metric depth = raw / DepthMapFactor (factor ~0 means already metric).
    f = float(config.tracking.depth_map_factor)
    scale = 1.0 if abs(f) < 1e-5 else 1.0 / f
    dm = jnp.asarray(depth_map, jnp.float32) * jnp.float32(scale)

    h, w = dm.shape
    u = jnp.clip(raw_xy[:, 0].astype(jnp.int32), 0, w - 1)
    v = jnp.clip(raw_xy[:, 1].astype(jnp.int32), 0, h - 1)
    d = dm[v, u]
    ok = (d > 0) & feats.valid
    depth = jnp.where(ok, d, -1.0)
    u_right = jnp.where(
        ok, feats.xy[:, 0] - cam.bf / jnp.maximum(d, 1e-6), -1.0
    )
    feats = feats._replace(u_right=u_right, depth=depth)

    point_cam = lie.backproject(
        feats.xy, jnp.maximum(depth, 1e-6), cam.fx, cam.fy, cam.cx, cam.cy
    )
    point_cam = jnp.where(depth[:, None] > 0, point_cam, 0.0)

    return FrameState(
        features=feats,
        T_cw=jnp.eye(4, dtype=jnp.float32),
        point_cam=point_cam,
        timestamp=jnp.asarray(timestamp, jnp.float32),
    )


@functools.partial(jax.jit, static_argnums=(1,))
def process_mono(img, config: SystemConfig, timestamp=0.0):
    """Monocular front-end: extraction only (GrabImageMonocular path,
    reference: src/tracking.cpp:233-260) — no stereo depth."""
    orb = config.orb
    levels = image_ops.build_pyramid(img, orb.n_levels, orb.scale_factor)
    feats = extract_from_pyramid(levels, orb)
    feats = _undistort_features(_bbox_filter(feats, config), config)
    return FrameState(
        features=feats,
        T_cw=jnp.eye(4, dtype=jnp.float32),
        point_cam=jnp.zeros((feats.capacity, 3), jnp.float32),
        timestamp=jnp.asarray(timestamp, jnp.float32),
    )

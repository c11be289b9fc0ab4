"""Fixed-capacity frame containers (the array analogue of OrbFrame).

The reference's per-frame object (reference: include/orbframe.hpp:60-238,
src/orbframe.cpp) holds dynamic keypoint vectors, a 64x48 bucket grid and
stereo depth.  Array form: every frame is a pytree of fixed-shape arrays
with a validity mask — no dynamic sizes, so the whole front-end jits once.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp


class Features(NamedTuple):
    """Per-frame ORB features, padded to a static keypoint capacity K.

    Fields mirror OrbFrame's parallel vectors (reference:
    include/orbframe.hpp:150-171): undistorted keypoints, octave, angle,
    response, packed descriptors, and the stereo quantities
    ``u_right``/``depth`` (-1 where unavailable, reference semantics).
    """

    xy: jnp.ndarray        # [K, 2] float32, level-0 pixel coords (x, y)
    response: jnp.ndarray  # [K] float32 FAST score
    octave: jnp.ndarray    # [K] int32 pyramid level
    angle: jnp.ndarray     # [K] float32 radians
    desc: jnp.ndarray      # [K, 8] uint32 packed 256-bit descriptors
    valid: jnp.ndarray     # [K] bool
    u_right: jnp.ndarray   # [K] float32, right-image x (stereo) or -1
    depth: jnp.ndarray     # [K] float32, metric depth or -1

    @property
    def capacity(self) -> int:
        return self.xy.shape[0]


def empty_features(capacity: int) -> Features:
    return Features(
        xy=jnp.zeros((capacity, 2), jnp.float32),
        response=jnp.zeros((capacity,), jnp.float32),
        octave=jnp.zeros((capacity,), jnp.int32),
        angle=jnp.zeros((capacity,), jnp.float32),
        desc=jnp.zeros((capacity, 8), jnp.uint32),
        valid=jnp.zeros((capacity,), bool),
        u_right=-jnp.ones((capacity,), jnp.float32),
        depth=-jnp.ones((capacity,), jnp.float32),
    )


class FrameState(NamedTuple):
    """A tracked frame: features + camera pose + per-feature landmark binding.

    ``point_cam`` caches the camera-frame 3D unprojection of stereo features
    (z<=0 where invalid) — the array analogue of UnprojectStereo
    (reference: src/orbframe.cpp:730-744).
    """

    features: Features
    T_cw: jnp.ndarray      # [4, 4] world->camera
    point_cam: jnp.ndarray  # [K, 3] camera-frame 3D of stereo points
    timestamp: jnp.ndarray  # [] float64/float32 seconds


def features_scale_sigma2(features: Features, scale_factor: float):
    """Per-feature sigma^2 = scale^(2*octave) (reference keeps per-level
    tables, include/orbframe.hpp:176-181)."""
    return jnp.power(jnp.float32(scale_factor), 2.0 * features.octave.astype(jnp.float32))

"""The batched window gather against slices: the XLA path
(vmap of dynamic_slice, taken off the GPU) and the Triton kernel the GPU
takes, here in the Pallas interpreter."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest

from opendlv_perception_vision_orbslam2_jax.ops import oracles
from opendlv_perception_vision_orbslam2_jax.ops.gather_triton import (
    gather_windows,
)
from opendlv_perception_vision_orbslam2_jax.ops.orb import gather_atlas_windows

IMPLS = {
    "xla": gather_atlas_windows,
    "triton_interpret": functools.partial(gather_windows, interpret=True),
}


@pytest.mark.parametrize("impl", sorted(IMPLS))
@pytest.mark.parametrize(
    "H,W,ph,pw,n",
    [
        (420, 1332, 45, 45, 100),   # ORB descriptor patches, KITTI L0 scale
        (97, 250, 11, 21, 37),      # stereo SAD strips, small level
        (64, 140, 11, 11, 5),       # left SAD windows
    ],
)
def test_gather_matches_slices(H, W, ph, pw, n, impl):
    rng = np.random.default_rng(1)
    img = rng.uniform(0, 255, (H, W)).astype(np.float32)
    y0 = rng.integers(0, H - ph + 1, n).astype(np.int32)
    x0 = rng.integers(0, W - pw + 1, n).astype(np.int32)
    out = np.asarray(IMPLS[impl](
        jnp.asarray(img), jnp.asarray(y0), jnp.asarray(x0), ph, pw))
    ref = np.stack([img[y : y + ph, x : x + pw] for y, x in zip(y0, x0)])
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(oracles.windows(img, y0, x0, ph, pw), ref)


@pytest.mark.parametrize("impl", sorted(IMPLS))
def test_gather_clips_out_of_range_starts(impl):
    rng = np.random.default_rng(2)
    img = rng.uniform(0, 255, (40, 200)).astype(np.float32)
    y0 = np.array([-3, 38], np.int32)   # below 0 / beyond H-ph
    x0 = np.array([190, -1], np.int32)
    out = np.asarray(IMPLS[impl](
        jnp.asarray(img), jnp.asarray(y0), jnp.asarray(x0), 8, 16))
    ref = np.stack([img[0:8, 184:200], img[32:40, 0:16]])
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(oracles.windows(img, y0, x0, 8, 16), ref)

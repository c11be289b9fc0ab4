"""Steered binned BRIEF (blur + row-gather sampling) against the NumPy
oracle."""

import jax.numpy as jnp
import numpy as np

from opendlv_perception_vision_orbslam2_jax.ops import oracles
from opendlv_perception_vision_orbslam2_jax.ops import orb as orb_ops


def _patches(n, seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(
        0, 255, (n, orb_ops.PATCH_SIDE, orb_ops.PATCH_SIDE)
    ).astype(np.float32)


def test_blur_matches_oracle():
    p = _patches(64, 0)
    got = np.asarray(orb_ops.blur_patches(jnp.asarray(p)), np.float64)
    assert got.shape == (64, orb_ops.BRIEF_SIDE, orb_ops.BRIEF_SIDE)
    # float32 rounding of 49-tap sums of values up to 255
    np.testing.assert_allclose(got, oracles.blur_patches(p), rtol=0, atol=1e-3)


def test_brief_matches_oracle():
    p = _patches(257, 1)
    angles = np.random.default_rng(2).uniform(-np.pi, np.pi, 257).astype(
        np.float32)
    blurred = orb_ops.blur_patches(jnp.asarray(p))
    got = np.asarray(orb_ops.brief_from_patches(jnp.asarray(p),
                                                jnp.asarray(angles)))
    want = oracles.brief_from_blurred(np.asarray(blurred), angles)
    np.testing.assert_array_equal(got, want)
    bits = np.unpackbits(want.view(np.uint8))
    assert 0.3 < bits.mean() < 0.7


def test_brief_at_angle_bin_edges():
    """Angles on the 12-degree bin edges, one float32 step either side of
    them, and the +-pi wrap pick the same bin as the oracle."""
    n_bins = orb_ops.N_ANGLE_BINS
    edges = (-np.pi + np.arange(n_bins + 1) * 2.0 * np.pi / n_bins).astype(
        np.float32)
    angles = np.concatenate([
        edges,
        np.nextafter(edges, np.float32(np.inf)),
        np.nextafter(edges, np.float32(-np.inf)),
    ]).astype(np.float32)
    p = _patches(angles.size, 3)
    blurred = orb_ops.blur_patches(jnp.asarray(p))
    got = np.asarray(orb_ops.brief_from_blurred(blurred, jnp.asarray(angles)))
    want = oracles.brief_from_blurred(np.asarray(blurred), angles)
    np.testing.assert_array_equal(got, want)
    # -pi and +pi are one direction: both land in the same (wrapped) bin
    same = np.asarray(orb_ops.brief_from_blurred(
        blurred[:1].repeat(2, 0), jnp.asarray([-np.pi, np.pi], jnp.float32)))
    np.testing.assert_array_equal(same[0], same[1])

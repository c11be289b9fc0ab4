"""Precomposed direct-from-base pyramid vs the chained per-level resize.

build_pyramid composes the per-step bilinear matrices on the host (f64) so
each level is two independent matmuls from level 0; it must match the
reference-shaped chained accumulation (level l resized from level l-1,
reference: src/orbextractor.cpp:654-678) to f32 rounding.
"""

import jax.numpy as jnp
import numpy as np

from opendlv_perception_vision_orbslam2_jax.ops import image as image_ops
from opendlv_perception_vision_orbslam2_jax.ops import resample


def _chained(img, n_levels, scale):
    h, w = img.shape
    shapes = image_ops.pyramid_shapes(h, w, n_levels, scale)
    levels = [img.astype(jnp.float32)]
    for lvl in range(1, n_levels):
        levels.append(resample.resize_bilinear(levels[-1], shapes[lvl]))
    return levels


def test_precomposed_pyramid_matches_chain():
    rng = np.random.default_rng(0)
    img = jnp.asarray(rng.uniform(0, 255, (149, 211)), jnp.float32)
    got = image_ops.build_pyramid(img, 6, 1.2)
    want = _chained(img, 6, 1.2)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                   rtol=0, atol=2e-3)


def test_pyramid_level0_is_input():
    img = jnp.asarray(np.arange(64 * 96, dtype=np.float32).reshape(64, 96))
    got = image_ops.build_pyramid(img, 3, 1.2)
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(img))


def test_pyramid_constant_image_preserved():
    # Interpolation weights sum to 1 per row, so composition preserves
    # constants exactly up to f32 rounding.
    img = jnp.full((120, 160), 37.0, jnp.float32)
    for lv in image_ops.build_pyramid(img, 8, 1.2):
        np.testing.assert_allclose(np.asarray(lv), 37.0, atol=1e-3)

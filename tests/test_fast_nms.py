"""FAST-9/16 score + 3x3 NMS (the XLA chain the extractor runs) against
the NumPy oracle, and the per-cell keypoint selection it feeds."""

import jax.numpy as jnp
import numpy as np
import pytest

from opendlv_perception_vision_orbslam2_jax.models.extractor import (
    EDGE_BORDER,
    _select_level_keypoints,
)
from opendlv_perception_vision_orbslam2_jax.ops import fast as fast_ops
from opendlv_perception_vision_orbslam2_jax.ops import oracles


def _image(h, w, seed, integer):
    rng = np.random.default_rng(seed)
    if integer:   # 8-bit camera values: plateaus and tied scores
        return rng.integers(0, 256, (h, w)).astype(np.float32)
    return rng.uniform(0, 255, (h, w)).astype(np.float32)


def _xla_fast_nms(img, ini, mn):
    scores, strong = fast_ops.fast_with_fallback(jnp.asarray(img), ini, mn)
    return (fast_ops.mask_border(fast_ops.nms_scores(scores), EDGE_BORDER),
            strong)


@pytest.mark.parametrize(
    "h,w,seed,integer,ini,mn",
    [
        (96, 160, 0, False, 20.0, 7.0),
        (128, 192, 3, True, 20.0, 7.0),
        (61, 83, 5, True, 12.0, 3.0),    # odd sizes, low thresholds
    ],
)
def test_fast_nms_matches_oracle(h, w, seed, integer, ini, mn):
    img = _image(h, w, seed, integer)
    got, strong = _xla_fast_nms(img, ini, mn)
    want, want_strong = oracles.fast_nms(img, ini, mn, EDGE_BORDER)
    assert np.sum(want > 0) > 0
    np.testing.assert_array_equal(np.asarray(got), want)
    np.testing.assert_array_equal(np.asarray(strong), want_strong)


def test_selection_from_oracle_maps_matches():
    """The spatially-uniform selection sees identical keypoints whether its
    maps come from the device chain or from the oracle."""
    img = _image(128, 192, 3, True)
    ini, mn, cell, budget = 20.0, 7.0, 16, 64
    got = _select_level_keypoints(*_xla_fast_nms(img, ini, mn), budget, cell)
    want = _select_level_keypoints(
        *map(jnp.asarray, oracles.fast_nms(img, ini, mn, EDGE_BORDER)),
        budget, cell,
    )
    assert int(np.sum(np.asarray(want[2]))) > 0
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

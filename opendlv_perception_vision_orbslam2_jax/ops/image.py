"""Image-space kernels: grayscale, separable Gaussian blur, scale pyramid.

Array replacements for the OpenCV calls in the reference front-end
(cv::cvtColor reference: src/tracking.cpp:167-192, cv::GaussianBlur(7x7,sigma=2)
reference: src/orbextractor.cpp:610, cv::resize pyramid reference:
src/orbextractor.cpp:654-678).  Everything is static-shape and fuses under jit;
images are float32 [H, W] in 0..255.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np


def rgb_to_gray(img):
    """[H, W, 3] uint8/float -> [H, W] float32 luma (BT.601, matches
    cv::cvtColor COLOR_RGB2GRAY used at reference: src/tracking.cpp:171)."""
    img = img.astype(jnp.float32)
    return img[..., 0] * 0.299 + img[..., 1] * 0.587 + img[..., 2] * 0.114


@functools.lru_cache(maxsize=None)
def _gaussian_kernel_1d(ksize: int, sigma: float):
    half = ksize // 2
    x = np.arange(-half, half + 1, dtype=np.float64)
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    k /= k.sum()
    return tuple(k.astype(np.float32))


def gaussian_blur(img, ksize: int = 7, sigma: float = 2.0):
    """Separable Gaussian blur with replicate borders.

    Parameters mirror the pre-descriptor blur (reference:
    src/orbextractor.cpp:610 GaussianBlur(..., Size(7,7), 2, 2,
    BORDER_REFLECT_101)).  Implemented as two 1-D convolutions, which XLA
    fuses into elementwise kernels.
    """
    k = jnp.asarray(_gaussian_kernel_1d(ksize, sigma))
    half = ksize // 2
    x = img.astype(jnp.float32)
    # Horizontal pass.
    xp = jnp.pad(x, ((0, 0), (half, half)), mode="reflect")
    cols = sum(k[i] * xp[:, i : i + x.shape[1]] for i in range(ksize))
    # Vertical pass.
    yp = jnp.pad(cols, ((half, half), (0, 0)), mode="reflect")
    out = sum(k[i] * yp[i : i + x.shape[0], :] for i in range(ksize))
    return out


def pyramid_shapes(height: int, width: int, n_levels: int, scale_factor: float):
    """Static per-level (H, W) list, mirroring the reference's rounding
    (reference: src/orbextractor.cpp:657-659 cvRound(cols/scale))."""
    shapes = []
    for lvl in range(n_levels):
        inv = 1.0 / (scale_factor ** lvl)
        shapes.append((int(round(height * inv)), int(round(width * inv))))
    return shapes


@functools.lru_cache(maxsize=None)
def _pyramid_matrices(height: int, width: int, n_levels: int,
                      scale_factor: float):
    """Per-level precomposed interpolation matrices ``(Mh [H_l, H], Mw [W_l, W])``.

    Level l of the reference pyramid is a *chain* of bilinear resizes
    (level l from level l-1, reference: src/orbextractor.cpp:654-678).  Each
    resize is linear, so the chain composes on the host (float64) into one
    pair of matrices per level: ``level_l = Mh_l @ img @ Mw_l^T``.  This
    turns the 2*(n_levels-1) serially-dependent device matmuls into
    independent pairs that all read level 0 — XLA overlaps them freely —
    while matching the chained accumulation up to f32 rounding."""
    from . import resample
    shapes = pyramid_shapes(height, width, n_levels, scale_factor)
    mh = np.eye(height, dtype=np.float64)
    mw = np.eye(width, dtype=np.float64)
    out = []
    for lvl in range(1, n_levels):
        (h2, w2), (h1, w1) = shapes[lvl], shapes[lvl - 1]
        mh = resample._interp_matrix(h2, h1).astype(np.float64) @ mh
        mw = resample._interp_matrix(w2, w1).astype(np.float64) @ mw
        out.append((mh.astype(np.float32), mw.astype(np.float32)))
    return out


def build_pyramid(img, n_levels: int, scale_factor: float):
    """List of per-level float32 images matching the reference's chained
    per-level resize (reference: src/orbextractor.cpp:654-678), computed as
    one precomposed matmul pair per level (see _pyramid_matrices)."""
    h, w = img.shape
    x = img.astype(jnp.float32)
    levels = [x]
    # HIGHEST precision: a reduced-precision matmul (bf16 keeps ~8 mantissa
    # bits => +-0.5 intensity error at 0..255; TF32 ~10) would inject
    # level>=1 noise into FAST scores and the sub-pixel corner
    # interpolation; full-f32 accumulation keeps the pyramid bit-comparable
    # with the CPU-tested accuracy contract (tests/test_pyramid.py).
    for mh, mw in _pyramid_matrices(h, w, n_levels, scale_factor):
        inner = jnp.matmul(x, jnp.asarray(mw).T,
                           precision=jax.lax.Precision.HIGHEST)
        levels.append(jnp.matmul(jnp.asarray(mh), inner,
                                 precision=jax.lax.Precision.HIGHEST))
    return levels


def max_pool_3x3_same(x):
    """3x3 max pool, stride 1, same shape (for FAST non-max suppression)."""
    neg_inf = jnp.finfo(x.dtype).min
    p = jnp.pad(x, 1, mode="constant", constant_values=neg_inf)
    best = x
    for dy in range(3):
        for dx in range(3):
            best = jnp.maximum(best, p[dy : dy + x.shape[0], dx : dx + x.shape[1]])
    return best

"""Resampling and smoothing as banded-matrix matmuls.

A bilinear resize along one axis is exactly a banded interpolation matrix; a
separable Gaussian blur is a banded Toeplitz matrix with the reflect border
folded in.  Both therefore become ``R_h @ img @ R_w^T`` — two dense matmuls
(<1 GMAC for a full KITTI frame) in place of `jax.image.resize` and
pad-and-shift gather / elementwise chains.

Replaces the OpenCV calls of the reference front-end (cv::resize pyramid,
reference: src/orbextractor.cpp:654-678; GaussianBlur(7x7, sigma=2),
reference: src/orbextractor.cpp:610).
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np


@functools.lru_cache(maxsize=None)
def _interp_matrix(n_out: int, n_in: int):
    """Bilinear interpolation matrix [n_out, n_in], half-pixel centers
    (the plain INTER_LINEAR convention of the reference's cv::resize —
    deliberately no antialias prefilter)."""
    m = np.zeros((n_out, n_in), np.float32)
    scale = n_in / n_out
    for i in range(n_out):
        c = (i + 0.5) * scale - 0.5
        c0 = int(np.floor(c))
        f = c - c0
        m[i, np.clip(c0, 0, n_in - 1)] += 1.0 - f
        m[i, np.clip(c0 + 1, 0, n_in - 1)] += f
    return m


@functools.lru_cache(maxsize=None)
def _blur_matrix(n: int, ksize: int, sigma: float):
    """Toeplitz Gaussian blur matrix [n, n] with BORDER_REFLECT_101 folded
    into the boundary rows (matches cv::GaussianBlur's default border)."""
    half = ksize // 2
    x = np.arange(-half, half + 1, dtype=np.float64)
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    k /= k.sum()
    m = np.zeros((n, n), np.float32)
    for i in range(n):
        for t in range(ksize):
            j = i + t - half
            # reflect_101: -1 -> 1, -2 -> 2, n -> n-2, n+1 -> n-3
            if j < 0:
                j = -j
            elif j >= n:
                j = 2 * n - 2 - j
            m[i, np.clip(j, 0, n - 1)] += k[t]
    return m


def resize_bilinear(img, out_shape):
    """``[H, W] -> [H2, W2]`` bilinear resize as two matmuls."""
    h2, w2 = out_shape
    h, w = img.shape
    rh = jnp.asarray(_interp_matrix(h2, h))
    rw = jnp.asarray(_interp_matrix(w2, w))
    return rh @ (img @ rw.T)


def gaussian_blur(img, ksize: int = 7, sigma: float = 2.0):
    """Separable Gaussian blur as two banded matmuls, reflect-101 border."""
    h, w = img.shape
    gh = jnp.asarray(_blur_matrix(h, ksize, sigma))
    gw = jnp.asarray(_blur_matrix(w, ksize, sigma))
    return gh @ (img @ gw.T)

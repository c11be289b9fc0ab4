"""Hamming-distance kernels over packed 256-bit ORB descriptors.

One kernel family serves all nine matcher variants of the reference
(DescriptorDistance SWAR popcount, reference: src/orbmatcher.cpp:1662-1676,
called from every Search*/Fuse routine).  Two implementations:

- ``hamming_matrix_xor``: XOR + ``lax.population_count`` on uint32 words.
- ``hamming_matrix_mxu``: bit-unpack to bfloat16 {0,1} and use the identity
  ``ham(a,b) = popcnt(a) + popcnt(b) - 2 * <a_bits, b_bits>`` so the inner
  product of ``[N,256] x [256,M]`` is one bf16 matrix product on the tensor
  cores — the path for the all-pairs matrices used in BoW-free matching.

Distances are exact integers in [0, 256]; TH_LOW=50 / TH_HIGH=100 gates match
the reference constants (reference: src/orbmatcher.cpp:36-38).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .orb import unpack_bits

TH_LOW = 50
TH_HIGH = 100
MAX_DIST = 256


def hamming_matrix_xor(a, b):
    """Reference XOR+popcount path (materializes the [N, M, 8] cube —
    memory-bound; kept for verification and small problems)."""
    x = jax.lax.population_count(a[:, None, :] ^ b[None, :, :])
    return jnp.sum(x, axis=-1).astype(jnp.int32)


def hamming_matrix_mxu(a, b):
    """Matrix-product path: exact distances via a bf16 bit-dot.  The
    products are 0/1 and row sums are <= 256, exactly representable with f32
    accumulation, so the result is bit-identical to popcount.  Traffic is
    [N,256]+[M,256] bf16 + the [N,M] output — ~5x less than the XOR cube."""
    ab = unpack_bits(a).astype(jnp.bfloat16)          # [N, 256]
    bb = unpack_bits(b).astype(jnp.bfloat16)          # [M, 256]
    dot = jax.lax.dot_general(
        ab, bb,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
    )                                                  # [N, M]
    pa = jnp.sum(ab, axis=1, dtype=jnp.float32)[:, None]
    pb = jnp.sum(bb, axis=1, dtype=jnp.float32)[None, :]
    return (pa + pb - 2.0 * dot).astype(jnp.int32)


# All matchers route through this alias; both implementations are exact.
hamming_matrix = hamming_matrix_mxu


def hamming_pairwise(a, b):
    """Row-wise distances ``uint32 [N,8] x [N,8] -> int32 [N]``."""
    return jnp.sum(jax.lax.population_count(a ^ b), axis=-1).astype(jnp.int32)


def masked_best2(dist, col_mask):
    """Per-row best and second-best over masked columns.

    ``dist [N, M]`` int32, ``col_mask [N, M]`` bool (candidate gating — the
    array analogue of the reference's grid/scale/BoW-node candidate lists).
    Returns (best_idx [N], best [N], second [N]); masked-out entries read as
    MAX_DIST+1 so "no candidate" is detectable.
    """
    big = MAX_DIST + 1
    d = jnp.where(col_mask, dist, big)
    best_idx = jnp.argmin(d, axis=1)
    best = jnp.take_along_axis(d, best_idx[:, None], axis=1)[:, 0]
    d2 = d.at[jnp.arange(d.shape[0]), best_idx].set(big)
    second = jnp.min(d2, axis=1)
    return best_idx, best, second


def mutual_check(best_ab, best_ba):
    """Cross-check: a->b and b->a agree. ``best_ab [N]``, ``best_ba [M]``."""
    n = best_ab.shape[0]
    back = jnp.take(best_ba, best_ab, axis=0)
    return back == jnp.arange(n)


def rotation_consistency_mask(angle_a, angle_b, matched, valid,
                              histo_len: int = 30, window_bins: int = 2):
    """Keep only matches whose angle difference agrees with the dominant
    global rotation.

    Array form of ComputeThreeMaxima + the rot-hist filter used by every
    matcher (reference: src/orbmatcher.cpp:1618-1660 and e.g. :498-529).
    The reference keeps the 3 highest of 30 bins — in practice 3 adjacent
    bins around the true inter-frame roll.  Here the same acceptance region
    is expressed as a circular window of ``+-window_bins`` around the peak
    bin, which is equivalent when the distribution is tight and strictly
    more robust when per-feature orientation noise straddles bin boundaries
    (exact-bin membership would split a centred cluster across 4-5 bins and
    reject valid matches).
    ``angle_a [N]`` radians, ``angle_b [M]``, ``matched [N]`` index into b,
    ``valid [N]`` bool.  Returns bool ``[N]``.
    """
    two_pi = 2.0 * jnp.pi
    rot = angle_a - jnp.take(angle_b, matched, axis=0)
    rot = jnp.mod(rot, two_pi)
    bin_idx = jnp.floor(rot * (histo_len / two_pi)).astype(jnp.int32)
    bin_idx = jnp.clip(bin_idx, 0, histo_len - 1)
    counts = jnp.zeros((histo_len,), jnp.int32).at[bin_idx].add(
        valid.astype(jnp.int32)
    )
    peak = jnp.argmax(counts)
    d = jnp.abs(bin_idx - peak)
    circ = jnp.minimum(d, histo_len - d)
    return valid & (circ <= window_bins)

"""ORB orientation + steered-BRIEF descriptors as batched gather kernels.

Replaces the per-keypoint scalar loops of the reference
(IC_Angle reference: src/orbextractor.cpp:136-163; computeOrbDescriptor
reference: src/orbextractor.cpp:166-203) with batched gathers over all
keypoints of a pyramid level at once.

Descriptor layout: 256 bits packed into ``uint32 [N, 8]`` (the reference uses
``uint8 [N, 32]``; 8x uint32 words match the SWAR popcount distance at
reference: src/orbmatcher.cpp:1662-1676 and XLA's ``population_count``).

Intentional divergence (documented per SURVEY.md section 7): the reference
embeds ORB's machine-learned 256-pair sampling pattern
(``bit_pattern_31_`` reference: src/orbextractor.cpp:215-473).  We instead use
a fixed *seeded* Gaussian pattern (original BRIEF construction).  Nothing in
this codebase needs bit-compatibility with OpenCV descriptors (no external
vocabulary file is shipped with the reference either), and the seeded pattern
keeps the repo free of copied tables.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .gather_triton import gather_windows as gather_windows_triton

PATCH_SIZE = 31
HALF_PATCH_SIZE = 15
N_BITS = 256
DESC_WORDS = 8  # 256 bits / 32


@functools.lru_cache(maxsize=None)
def brief_pattern():
    """Deterministic 256-pair sampling pattern, ``int32 [256, 4]`` (x1,y1,x2,y2).

    BRIEF G-II construction: iid Gaussian(0, (PATCH/5)^2), clipped to the
    13-px disc used by ORB, fixed seed => identical descriptors everywhere.
    """
    rng = np.random.default_rng(0x0B5E55ED)
    sigma = PATCH_SIZE / 5.0
    pts = []
    while len(pts) < N_BITS * 2:
        cand = rng.normal(0.0, sigma, size=(N_BITS * 4, 2))
        cand = np.round(cand).astype(np.int32)
        keep = (np.abs(cand[:, 0]) <= 13) & (np.abs(cand[:, 1]) <= 13)
        pts.extend(cand[keep].tolist())
    pts = np.asarray(pts[: N_BITS * 2], dtype=np.int32)
    return np.concatenate([pts[0::2], pts[1::2]], axis=1)  # [256, 4]


@functools.lru_cache(maxsize=None)
def _disc_offsets():
    """All (dy, dx) offsets inside the radius-15 disc, plus the dx weight
    arrays for the intensity-centroid moments."""
    ys, xs = np.mgrid[-HALF_PATCH_SIZE : HALF_PATCH_SIZE + 1,
                      -HALF_PATCH_SIZE : HALF_PATCH_SIZE + 1]
    mask = (ys * ys + xs * xs) <= HALF_PATCH_SIZE * HALF_PATCH_SIZE
    return ys[mask].astype(np.int32), xs[mask].astype(np.int32)


def _gather_pixels(img, y_idx, x_idx):
    """Clip-gather ``img[y, x]`` for integer index arrays of any shape."""
    H, W = img.shape
    y = jnp.clip(y_idx, 0, H - 1)
    x = jnp.clip(x_idx, 0, W - 1)
    return jnp.take(img.reshape(-1), y * W + x, axis=0)


def ic_angles(img, kpts_xy):
    """Intensity-centroid orientation for keypoints on one pyramid level.

    ``img [H, W]`` float32 (un-blurred level image, as in the reference where
    IC_Angle runs before the descriptor blur), ``kpts_xy [N, 2]`` float
    (x, y) level coords.  Returns angles ``[N]`` in radians.
    Equivalent of IC_Angle (reference: src/orbextractor.cpp:136-163) with the
    exact circular mask replacing the umax half-width table.
    """
    dys, dxs = _disc_offsets()
    dys = jnp.asarray(dys)
    dxs = jnp.asarray(dxs)
    x0 = jnp.round(kpts_xy[:, 0]).astype(jnp.int32)
    y0 = jnp.round(kpts_xy[:, 1]).astype(jnp.int32)
    ys = y0[:, None] + dys[None, :]
    xs = x0[:, None] + dxs[None, :]
    vals = _gather_pixels(img, ys, xs)            # [N, |disc|]
    m10 = jnp.sum(vals * dxs[None, :], axis=1)
    m01 = jnp.sum(vals * dys[None, :], axis=1)
    return jnp.arctan2(m01, m10)


def brief_descriptors(img_blurred, kpts_xy, angles):
    """Steered 256-bit BRIEF, packed ``uint32 [N, 8]``.

    ``img_blurred`` is the Gaussian-blurred level image (reference blurs before
    describing, src/orbextractor.cpp:610).  Rotation follows the reference's
    nearest-pixel steering (cvRound of the rotated pattern,
    reference: src/orbextractor.cpp:170-177).
    """
    pat = jnp.asarray(brief_pattern())            # [256, 4] int32
    cos_a = jnp.cos(angles)[:, None]              # [N, 1]
    sin_a = jnp.sin(angles)[:, None]

    def rotate(px, py):
        rx = jnp.round(px[None, :] * cos_a - py[None, :] * sin_a)
        ry = jnp.round(px[None, :] * sin_a + py[None, :] * cos_a)
        return rx.astype(jnp.int32), ry.astype(jnp.int32)

    x0 = jnp.round(kpts_xy[:, 0]).astype(jnp.int32)[:, None]
    y0 = jnp.round(kpts_xy[:, 1]).astype(jnp.int32)[:, None]

    ax, ay = rotate(pat[:, 0].astype(jnp.float32), pat[:, 1].astype(jnp.float32))
    bx, by = rotate(pat[:, 2].astype(jnp.float32), pat[:, 3].astype(jnp.float32))
    va = _gather_pixels(img_blurred, y0 + ay, x0 + ax)   # [N, 256]
    vb = _gather_pixels(img_blurred, y0 + by, x0 + bx)
    bits = (va < vb).astype(jnp.uint32)                   # [N, 256]

    # Pack 256 bits -> 8 uint32 words.
    bits = bits.reshape(bits.shape[0], DESC_WORDS, 32)
    shifts = jnp.arange(32, dtype=jnp.uint32)
    return jnp.sum(bits << shifts[None, None, :], axis=-1, dtype=jnp.uint32)


# ---------------------------------------------------------------------------
# Patch-based extraction path (the production route).
#
# Extracting one square patch per keypoint via vmap(dynamic_slice) lowers to
# *slice* gathers (rows of the patch), after which orientation, descriptor
# blur and steered sampling all read the same [N, 45, 45] block:
#
# - IC moments: patch_flat [N, 961] @ disc-weight matrix [961, 2];
# - the descriptor blur (reference blurs the whole level,
#   src/orbextractor.cpp:610) becomes two tiny batched matmuls per patch;
# - steered BRIEF sampling quantizes the angle into 30 bins of 12 deg (the
#   original ORB paper's construction; documented divergence from the
#   reference's continuous cvRound steering, src/orbextractor.cpp:170-177)
#   so each bin's 512 sample positions are a fixed index table and the
#   sampling is one row gather per keypoint.
# ---------------------------------------------------------------------------

BRIEF_HALF = 19     # max reach of a rotated pattern point (13*sqrt(2) < 19)
BLUR_MARGIN = 3     # 7x7 Gaussian
PATCH_HALF = BRIEF_HALF + BLUR_MARGIN          # 22 -> 45x45 raw patches
PATCH_SIDE = 2 * PATCH_HALF + 1
BRIEF_SIDE = 2 * BRIEF_HALF + 1                # 39x39 blurred interior
N_ANGLE_BINS = 30                              # 2*pi/30 = 12 deg (ORB paper)


def build_patch_atlas(levels, half: int = PATCH_HALF):
    """Stack edge-padded pyramid levels into one tall image.

    Each level is replicate-padded by ``half`` (so patch gathers never clamp
    at level borders) and zero-extended to the widest padded level; levels
    stack vertically.  Returns ``(atlas [sum(H_l+2h), W0+2h], row_offsets)``
    where a patch centred at level coords ``(x, y)`` of level ``l`` starts at
    ``(round(y) + row_offsets[l], round(x))`` in the atlas.

    One atlas feeds *one* batched window gather for all levels (and, for
    stereo, both eyes — the two atlases concatenate), replacing the per-level
    per-eye gathers.
    """
    w0 = levels[0].shape[1] + 2 * half
    padded, offsets, row = [], [], 0
    for im in levels:
        p = jnp.pad(im, half, mode="edge")
        p = jnp.pad(p, ((0, 0), (0, w0 - p.shape[1])))
        padded.append(p)
        offsets.append(row)
        row += p.shape[0]
    return jnp.concatenate(padded, axis=0), np.asarray(offsets, np.int32)


def gather_atlas_windows(atlas, y0, x0, ph: int, pw: int | None = None):
    """``[N]`` top-left corners -> ``[N, ph, pw]`` windows of ``atlas``.
    Starts are clipped so that every window lies inside the atlas.

    On the GPU the Triton kernel of :mod:`.gather_triton` cuts the windows
    (faster end to end there, PERF.md); elsewhere vmap(dynamic_slice) slice
    gathers do, and they are the kernel's reference in the tests."""
    pw = ph if pw is None else pw
    if jax.default_backend() == "gpu":
        return gather_windows_triton(atlas, y0, x0, ph, pw)
    H, W = atlas.shape
    y0 = jnp.clip(y0, 0, H - ph)
    x0 = jnp.clip(x0, 0, W - pw)

    def slc(y, x):
        return jax.lax.dynamic_slice(atlas, (y, x), (ph, pw))

    return jax.vmap(slc)(y0, x0)


def extract_patches(img, kpts_xy, half: int = PATCH_HALF):
    """One ``(2*half+1)^2`` patch per keypoint via vmap(dynamic_slice).

    The image is replicate-padded by ``half`` so slices never clamp-shift;
    out-of-image samples replicate the border exactly like the clip-gather
    path above.
    """
    side = 2 * half + 1
    p = jnp.pad(img, half, mode="edge")
    y0 = jnp.round(kpts_xy[:, 1]).astype(jnp.int32)
    x0 = jnp.round(kpts_xy[:, 0]).astype(jnp.int32)
    H, W = img.shape
    y0 = jnp.clip(y0, 0, H - 1)
    x0 = jnp.clip(x0, 0, W - 1)

    def slc(y, x):
        return jax.lax.dynamic_slice(p, (y, x), (side, side))

    return jax.vmap(slc)(y0, x0)                # [N, side, side]


@functools.lru_cache(maxsize=None)
def _moment_matrix():
    """[961, 2] float32: flattened disc-masked (dx, dy) weights."""
    ys, xs = np.mgrid[-HALF_PATCH_SIZE : HALF_PATCH_SIZE + 1,
                      -HALF_PATCH_SIZE : HALF_PATCH_SIZE + 1]
    disc = (ys * ys + xs * xs) <= HALF_PATCH_SIZE * HALF_PATCH_SIZE
    return np.stack(
        [(xs * disc).reshape(-1), (ys * disc).reshape(-1)], -1
    ).astype(np.float32)


def ic_angles_from_patches(patches):
    """IC orientation from raw patches ``[N, S, S]`` (S >= 31, centered):
    one [N, 961] @ [961, 2] matmul + atan2.  Exact same moments as
    :func:`ic_angles`."""
    s = patches.shape[-1]
    lo = s // 2 - HALF_PATCH_SIZE
    inner = patches[:, lo : lo + PATCH_SIZE, lo : lo + PATCH_SIZE]
    m = inner.reshape(-1, PATCH_SIZE * PATCH_SIZE) @ jnp.asarray(_moment_matrix())
    return jnp.arctan2(m[:, 1], m[:, 0])


@functools.lru_cache(maxsize=None)
def _patch_blur_matrix():
    """[39, 45] float32 rows of the 7x7-sigma2 Gaussian: blurred valid
    interior of a 45-wide raw patch (same taps as the full-image blur)."""
    half = BLUR_MARGIN
    x = np.arange(-half, half + 1, dtype=np.float64)
    k = np.exp(-(x * x) / (2.0 * 2.0 * 2.0))
    k /= k.sum()
    m = np.zeros((BRIEF_SIDE, PATCH_SIDE), np.float32)
    for i in range(BRIEF_SIDE):
        m[i, i : i + 2 * half + 1] = k
    return m


@functools.lru_cache(maxsize=None)
def _binned_sample_indices():
    """[30, 512] int32 flat indices into a 39x39 patch: the rotated
    (a, b) sample positions of all 256 pairs for each 12-deg angle bin."""
    pat = brief_pattern()
    out = np.zeros((N_ANGLE_BINS, 2 * N_BITS), np.int32)
    for b in range(N_ANGLE_BINS):
        th = (b + 0.5) * 2.0 * np.pi / N_ANGLE_BINS - np.pi
        c, s = np.cos(th), np.sin(th)

        def rot(px, py):
            rx = np.round(px * c - py * s).astype(np.int64)
            ry = np.round(px * s + py * c).astype(np.int64)
            return (np.clip(rx, -BRIEF_HALF, BRIEF_HALF),
                    np.clip(ry, -BRIEF_HALF, BRIEF_HALF))

        ax, ay = rot(pat[:, 0], pat[:, 1])
        bx, by = rot(pat[:, 2], pat[:, 3])
        out[b, :N_BITS] = (ay + BRIEF_HALF) * BRIEF_SIDE + (ax + BRIEF_HALF)
        out[b, N_BITS:] = (by + BRIEF_HALF) * BRIEF_SIDE + (bx + BRIEF_HALF)
    return out


def _pack256(bits):
    """bool/int [N, 256] -> packed uint32 [N, 8]."""
    b = bits.astype(jnp.uint32).reshape(bits.shape[0], DESC_WORDS, 32)
    shifts = jnp.arange(32, dtype=jnp.uint32)
    return jnp.sum(b << shifts[None, None, :], axis=-1, dtype=jnp.uint32)


def blur_patches(patches):
    """Raw patches ``[N, 45, 45]`` -> blurred interiors ``[N, 39, 39]``: the
    7x7 sigma-2 Gaussian of the reference's pre-descriptor blur
    (src/orbextractor.cpp:610) as two batched matmuls per patch."""
    bm = jnp.asarray(_patch_blur_matrix())
    return jnp.einsum("is,nst,jt->nij", bm, patches, bm)


def brief_from_blurred(blurred, angles):
    """Steered binned BRIEF, packed ``uint32 [N, 8]``, from blurred
    interiors ``[N, 39, 39]``: each keypoint's angle bin selects its 512
    sample positions, one ``take_along_axis`` row gather reads them, and bit
    ``i`` is ``v_a < v_b`` for pair ``i``."""
    n = blurred.shape[0]
    flat = blurred.reshape(n, BRIEF_SIDE * BRIEF_SIDE)
    bin_ = jnp.floor(
        (angles + jnp.pi) / (2.0 * jnp.pi) * N_ANGLE_BINS
    ).astype(jnp.int32) % N_ANGLE_BINS
    idx = jnp.asarray(_binned_sample_indices())[bin_]     # [N, 512]
    vals = jnp.take_along_axis(flat, idx, axis=1)
    return _pack256(vals[:, :N_BITS] < vals[:, N_BITS:])


def brief_from_patches(patches, angles):
    """Steered binned BRIEF from raw patches ``[N, 45, 45]``."""
    return brief_from_blurred(blur_patches(patches), angles)


def descriptor_mean(descs, valid):
    """Bitwise-majority mean descriptor over a masked set.

    Equivalent of OrbDescriptor::meanValue (reference:
    src/orbdescriptor.cpp:24-73) for the map-point distinctive-descriptor
    refresh; operates on ``uint32 [M, 8]`` + bool ``[M]``.
    """
    bits = unpack_bits(descs)                     # [M, 256]
    n = jnp.maximum(jnp.sum(valid), 1)
    counts = jnp.sum(bits * valid[:, None], axis=0)
    maj = (counts * 2 >= n).astype(jnp.uint32)
    return pack_bits(maj[None])[0]


def unpack_bits(descs):
    """``uint32 [..., 8]`` -> ``uint32 [..., 256]`` of 0/1 bits."""
    shifts = jnp.arange(32, dtype=jnp.uint32)
    bits = (descs[..., :, None] >> shifts) & jnp.uint32(1)
    return bits.reshape(*descs.shape[:-1], N_BITS)


def pack_bits(bits):
    """Inverse of :func:`unpack_bits`."""
    b = bits.reshape(*bits.shape[:-1], DESC_WORDS, 32).astype(jnp.uint32)
    shifts = jnp.arange(32, dtype=jnp.uint32)
    return jnp.sum(b << shifts, axis=-1, dtype=jnp.uint32)

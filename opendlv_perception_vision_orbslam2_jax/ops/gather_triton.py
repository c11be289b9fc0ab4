"""Batched window gather as a Pallas kernel through the Triton route (GPU).

``[N]`` top-left corners -> ``[N, ph, pw]`` windows of one image: the 45x45
descriptor patches and the 11x11 / 11x21 SAD windows of the front end.  One
program copies ``group`` windows; each window is one masked load of a
power-of-two block (Triton's block shapes are powers of two) cut to
``ph x pw`` by the mask, and one masked store.  Starts are clipped so that
every window lies inside the image, as in the ``vmap(dynamic_slice)``
gather of :func:`..ops.orb.gather_atlas_windows`, which is this kernel's
reference (exact: it is a copy).

On the H100 at KITTI shapes the whole ``process_stereo`` program ran
faster with this kernel than with XLA's gather, which XLA follows with a
separate transpose of the patch block (PERF.md).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

GROUP = 4   # windows per program


def _pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def gather_windows(img, y0, x0, ph: int, pw: int, interpret: bool = False):
    """``img [H, W]``, starts ``y0, x0 [N]`` -> ``[N, ph, pw]`` windows;
    ``interpret`` runs the kernel in the Pallas interpreter (CPU tests)."""
    h, w = img.shape
    n = y0.shape[0]
    n_pad = -(-n // GROUP) * GROUP
    y0 = jnp.pad(jnp.clip(y0, 0, h - ph).astype(jnp.int32), (0, n_pad - n))
    x0 = jnp.pad(jnp.clip(x0, 0, w - pw).astype(jnp.int32), (0, n_pad - n))
    bh, bw = _pow2(ph), _pow2(pw)

    def kernel(y_ref, x_ref, img_ref, o_ref):
        r = jnp.arange(bh)[:, None]
        c = jnp.arange(bw)[None, :]
        mask = (r < ph) & (c < pw)
        for g in range(GROUP):
            i = pl.program_id(0) * GROUP + g
            win = plgpu.load(img_ref.at[y_ref[i] + r, x_ref[i] + c],
                             mask=mask, other=0.0)
            plgpu.store(o_ref.at[i, r, c], win, mask=mask)

    out = pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((n_pad, ph, pw), img.dtype),
        grid=(n_pad // GROUP,),
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=1),
        backend="triton",
        interpret=interpret,
        name="window_gather",
    )(y0, x0, img)
    return out[:n]

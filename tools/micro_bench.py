"""Micro-benchmarks for individual front-end kernels on the live backend."""

import time
import sys

import numpy as np
import jax
import jax.numpy as jnp

from opendlv_perception_vision_orbslam2_jax.ops import fast as fast_ops
from opendlv_perception_vision_orbslam2_jax.ops import image as image_ops
from opendlv_perception_vision_orbslam2_jax.ops import resample


def hard_sync(x):
    return np.asarray(jax.tree.leaves(x)[0])


def timeit(name, fn, *args, reps=30):
    out = fn(*args)
    hard_sync(out)
    t0 = time.time()
    for _ in range(reps):
        out = fn(*args)
    hard_sync(out)
    print(f"{name:46s} {(time.time()-t0)/reps*1e3:8.3f} ms")
    return out


def main():
    H, W = 376, 1241
    img = jax.device_put(jnp.asarray(np.random.RandomState(0).rand(H, W) * 255, jnp.float32))

    f_resize = jax.jit(lambda x: resample.resize_bilinear(x, (313, 1034)))
    timeit("resize 1 level (matmul)", f_resize, img)

    f_resize2 = jax.jit(lambda x: jax.vmap(lambda y: resample.resize_bilinear(y, (313, 1034)))(x))
    timeit("resize 1 level, both eyes batched", f_resize2, jnp.stack([img, img]))

    f_pyr = jax.jit(lambda x: tuple(image_ops.build_pyramid(x, 8, 1.2)))
    timeit("pyramid 8 levels (1 eye)", f_pyr, img)

    f_fast = jax.jit(lambda x: fast_ops.fast_score_map(x, 7.0))
    timeit("FAST score map (1 eye, level 0)", f_fast, img)

    f_fastnms = jax.jit(lambda x: fast_ops.nms_scores(fast_ops.fast_score_map(x, 7.0)))
    timeit("FAST + nms (1 eye, level 0)", f_fastnms, img)


if __name__ == "__main__":
    main()

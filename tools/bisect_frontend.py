"""Incremental-fusion bisection of the stereo front-end.

Builds a ladder of fused programs, each adding one stage, and reports the
marginal device time of every stage *inside* the fused context (standalone
stage timings are distorted by dispatch overhead and lost fusion).
"""

import sys
import time

import numpy as np
import jax
import jax.numpy as jnp

from opendlv_perception_vision_orbslam2_jax.models import extractor
from opendlv_perception_vision_orbslam2_jax.models.frontend import process_stereo
from opendlv_perception_vision_orbslam2_jax.ops import fast as fast_ops
from opendlv_perception_vision_orbslam2_jax.ops import image as image_ops
from opendlv_perception_vision_orbslam2_jax.ops import orb as orb_ops
from opendlv_perception_vision_orbslam2_jax.utils import synthetic
from opendlv_perception_vision_orbslam2_jax.utils.config import SystemConfig


def hard_sync(x):
    return np.asarray(jax.tree.leaves(x)[0])


def timeit(name, fn, *args, reps=30):
    out = fn(*args)
    hard_sync(out)
    t0 = time.time()
    for _ in range(reps):
        out = fn(*args)
    hard_sync(out)
    dt = (time.time() - t0) / reps * 1e3
    print(f"{name:46s} {dt:8.3f} ms", flush=True)
    return dt


def main():
    cfg = SystemConfig()
    ocfg = cfg.orb
    print("backend:", jax.default_backend(), file=sys.stderr)
    lefts, rights, gt, _ = synthetic.render_stereo_sequence(
        cfg, n_frames=2, n_points=900, seed=0, step=0.6
    )
    L, R = jax.device_put(lefts[1]), jax.device_put(rights[1])
    budgets = extractor.per_level_budgets(
        ocfg.n_features, ocfg.scale_factor, ocfg.n_levels
    )

    def both(fn):
        return jax.vmap(fn)(jnp.stack([L, R], axis=0))

    # Ladder of fused programs over both eyes.
    def s1(img):  # pyramid
        lv = image_ops.build_pyramid(img, ocfg.n_levels, ocfg.scale_factor)
        return sum(jnp.sum(l) for l in lv)

    def s2(img):  # + FAST/nms/border
        lv = image_ops.build_pyramid(img, ocfg.n_levels, ocfg.scale_factor)
        acc = 0.0
        for l in lv:
            sc, st = fast_ops.fast_with_fallback(
                l, float(ocfg.ini_th_fast), float(ocfg.min_th_fast)
            )
            sc = fast_ops.mask_border(fast_ops.nms_scores(sc), extractor.EDGE_BORDER)
            acc += jnp.sum(sc)
        return acc

    def s3(img):  # + select
        lv = image_ops.build_pyramid(img, ocfg.n_levels, ocfg.scale_factor)
        acc = 0.0
        for l, b in zip(lv, budgets):
            sc, st = fast_ops.fast_with_fallback(
                l, float(ocfg.ini_th_fast), float(ocfg.min_th_fast)
            )
            sc = fast_ops.mask_border(fast_ops.nms_scores(sc), extractor.EDGE_BORDER)
            xy, r, v = extractor._select_level_keypoints(sc, st, b, ocfg.cell_size)
            acc += jnp.sum(xy) + jnp.sum(r)
        return acc

    def s4(img):  # + patches
        lv = image_ops.build_pyramid(img, ocfg.n_levels, ocfg.scale_factor)
        acc = 0.0
        for l, b in zip(lv, budgets):
            sc, st = fast_ops.fast_with_fallback(
                l, float(ocfg.ini_th_fast), float(ocfg.min_th_fast)
            )
            sc = fast_ops.mask_border(fast_ops.nms_scores(sc), extractor.EDGE_BORDER)
            xy, r, v = extractor._select_level_keypoints(sc, st, b, ocfg.cell_size)
            p = orb_ops.extract_patches(l, xy)
            acc += jnp.sum(p)
        return acc

    def s5(img):  # + angles
        lv = image_ops.build_pyramid(img, ocfg.n_levels, ocfg.scale_factor)
        acc = 0.0
        for l, b in zip(lv, budgets):
            sc, st = fast_ops.fast_with_fallback(
                l, float(ocfg.ini_th_fast), float(ocfg.min_th_fast)
            )
            sc = fast_ops.mask_border(fast_ops.nms_scores(sc), extractor.EDGE_BORDER)
            xy, r, v = extractor._select_level_keypoints(sc, st, b, ocfg.cell_size)
            p = orb_ops.extract_patches(l, xy)
            a = orb_ops.ic_angles_from_patches(p)
            acc += jnp.sum(a)
        return acc

    def s6(img):  # + brief (full extraction)
        f = extractor.extract_features(img, ocfg)
        return jnp.sum(f.desc.astype(jnp.float32)) + jnp.sum(f.xy)

    fns = [s1, s2, s3, s4, s5, s6]
    names = ["pyramid", "+fast/nms", "+select", "+patches", "+angles", "+brief"]
    prev = 0.0
    for name, fn in zip(names, fns):
        f = jax.jit(lambda ims, fn=fn: jax.vmap(fn)(ims))
        ims = jnp.stack([L, R], axis=0)
        dt = timeit(name, f, ims)
        print(f"    marginal: {dt - prev:8.3f} ms", flush=True)
        prev = dt

    f_fe = jax.jit(lambda l, r: process_stereo(l, r, cfg))
    timeit("process_stereo (stereo match etc.)", f_fe, L, R)


if __name__ == "__main__":
    main()

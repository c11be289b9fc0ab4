"""Micro-ablation of the tracking stage (motion_model_step internals) at the
bench operating point.  Checksum outputs; one process, queued timings."""

import os
import sys
import time

import numpy as np
import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from opendlv_perception_vision_orbslam2_jax.models import tracking as tr
from opendlv_perception_vision_orbslam2_jax.models.frontend import process_stereo
from opendlv_perception_vision_orbslam2_jax.ops import matching
from opendlv_perception_vision_orbslam2_jax.ops.hamming import hamming_matrix
from opendlv_perception_vision_orbslam2_jax.optim.pnp import pnp_ransac
from opendlv_perception_vision_orbslam2_jax.optim.pose_opt import (
    PoseObs, pose_optimize, robust_pose_estimate)
from opendlv_perception_vision_orbslam2_jax.models.frame import (
    features_scale_sigma2)
from opendlv_perception_vision_orbslam2_jax.ops import lie
from opendlv_perception_vision_orbslam2_jax.utils import synthetic
from opendlv_perception_vision_orbslam2_jax.utils.config import SystemConfig


def timeit(name, fn, *args, reps=40):
    out = fn(*args)
    np.asarray(jax.tree.leaves(out)[0])
    t0 = time.time()
    for _ in range(reps):
        out = fn(*args)
    np.asarray(jax.tree.leaves(out)[0])
    print(f"{name:52s} {(time.time() - t0) / reps * 1e3:8.3f} ms", flush=True)
    return out


def main():
    cfg = SystemConfig()
    cam = cfg.camera
    print("backend:", jax.default_backend(), file=sys.stderr)
    lefts, rights, _, _ = synthetic.render_stereo_sequence(
        cfg, n_frames=3, n_points=900, seed=0, step=0.6
    )
    f0 = process_stereo(lefts[0], rights[0], cfg)
    f1 = process_stereo(lefts[1], rights[1], cfg)
    state = tr.init_state(f0)
    state, cur = jax.device_put((state, f1))

    # Compact sources exactly like motion_model_step.
    def sources(state):
        th_far = cfg.tracking.th_depth * cam.baseline_m
        _, p_w, usable, desc_s, oct_s, ang_s, _ = tr._compact_sources(
            state, th_far)
        return (p_w, usable, desc_s, oct_s, ang_s)

    p_w, usable, desc_s, oct_s, ang_s = jax.jit(sources)(state)
    T_pred = jnp.eye(4, dtype=jnp.float32)

    timeit("S0 source compaction",
           jax.jit(lambda st: jax.tree.map(jnp.sum, sources(st))), state)
    timeit("S1 hamming [1024,2048]",
           jax.jit(lambda a, b: jnp.sum(hamming_matrix(a, b))),
           desc_s, cur.features.desc)

    dist = jax.jit(hamming_matrix)(desc_s, cur.features.desc)

    def match1(dist, p_w, usable, cur):
        m = matching.search_by_projection(
            p_w, usable, desc_s, oct_s, ang_s, cur.features, T_pred,
            fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, bf=cam.bf,
            width=cam.width, height=cam.height, radius_th=7.0,
            scale_factor=cfg.orb.scale_factor, dist=dist)
        m = matching.resolve_duplicate_targets(m, cur.features.capacity)
        return jnp.sum(m.valid)

    timeit("S2 one projection rung", jax.jit(match1), dist, p_w, usable, cur)

    # Build a realistic PoseObs for the optimizers.
    def build_obs(dist, p_w, usable, cur):
        m = matching.search_by_projection(
            p_w, usable, desc_s, oct_s, ang_s, cur.features, T_pred,
            fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, bf=cam.bf,
            width=cam.width, height=cam.height, radius_th=14.0,
            scale_factor=cfg.orb.scale_factor, dist=dist)
        m = matching.resolve_duplicate_targets(m, cur.features.capacity)
        sigma2 = features_scale_sigma2(cur.features, cfg.orb.scale_factor)
        dst = m.dst_idx
        return PoseObs(
            p_w=p_w,
            uv=jnp.take(cur.features.xy, dst, axis=0),
            u_right=jnp.take(cur.features.u_right, dst, axis=0),
            sigma2=jnp.take(sigma2, dst, axis=0),
            valid=m.valid)

    obs = jax.jit(build_obs)(dist, p_w, usable, cur)
    obs = jax.device_put(obs)

    timeit("S3 pnp_ransac",
           jax.jit(lambda o: pnp_ransac(
               o.p_w, o.uv, o.sigma2, o.valid, jax.random.PRNGKey(0),
               fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy).inliers.sum()),
           obs)
    timeit("S4 pose_optimize 1 chain (4x10 GN)",
           jax.jit(lambda o: pose_optimize(
               T_pred, o, fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy,
               bf=cam.bf)[2]),
           obs)
    timeit("S5 robust_pose_estimate (pnp + 2 vmapped chains)",
           jax.jit(lambda o: robust_pose_estimate(
               T_pred, o, jax.random.PRNGKey(0),
               fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, bf=cam.bf)[2]),
           obs)
    timeit("S6 motion_model_step (full)",
           jax.jit(lambda st, c: tr.motion_model_step(st, c, cfg, 1)[1]),
           state, cur)


if __name__ == "__main__":
    main()

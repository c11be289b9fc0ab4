"""Device micro-timing of the round-4 stage programs with pass toggles.

Builds a realistic mid-run MapState by running the pipeline for 16 frames,
then times: process_stereo, track_frame_with_map, insert_stage, and
mapping_stage with each pass enabled incrementally.
"""
import os
import sys
import time

import numpy as np
import jax
import jax.numpy as jnp

from opendlv_perception_vision_orbslam2_jax.utils.compile_cache import (  # noqa: E402
    enable_compile_cache,
)

enable_compile_cache()

from opendlv_perception_vision_orbslam2_jax.models import slam as slam_mod
from opendlv_perception_vision_orbslam2_jax.models.frontend import process_stereo
from opendlv_perception_vision_orbslam2_jax.utils import synthetic
from opendlv_perception_vision_orbslam2_jax.utils.config import SystemConfig

cfg = SystemConfig()
print("backend:", jax.default_backend(), flush=True)
n = 16
lefts, rights, gt, _ = synthetic.render_stereo_sequence(
    cfg, n_frames=n + 1, n_points=1200, seed=1, step=0.6
)
lefts = jax.device_put(np.asarray(lefts))
rights = jax.device_put(np.asarray(rights))

slam = slam_mod.StereoSlam(cfg, enable_loop_closing=False,
                           enable_relocalization=False)
for i in range(n):
    slam.process(lefts[i], rights[i], timestamp=i / 15.0)
slam._try_adopt_mapping(force=True)
m = slam.map
print(f"map: kfs={int(np.asarray(m.kf_valid).sum())} "
      f"pts={int(np.asarray(m.pt_valid).sum())} K={m.kf_capacity} "
      f"P={m.pt_capacity}", flush=True)


def bench(name, fn, reps=8):
    out = fn()
    jax.block_until_ready(jax.tree.leaves(out)[0])
    t0 = time.time()
    for _ in range(reps):
        out = fn()
    jax.block_until_ready(jax.tree.leaves(out)[0])
    dt = (time.time() - t0) / reps * 1e3
    print(f"{name:<44}{dt:8.1f} ms", flush=True)
    return dt


cur = process_stereo(lefts[n], rights[n], cfg, 0.0)
jax.block_until_ready(cur.features.xy)
bench("process_stereo", lambda: process_stereo(lefts[n], rights[n], cfg, 0.0))
bench("track_frame_with_map", lambda: slam_mod.track_frame_with_map(
    m, slam.last_frame, slam.last_bindings, slam.T_cw, slam.velocity, cur,
    cfg))
binds = slam.last_bindings
bench("insert_stage", lambda: slam_mod.insert_stage(m, cur, binds, cfg))

slot = jnp.asarray(slam.last_kf_slot, jnp.int32)
for flags in (
    dict(do_triangulate=False, do_fuse=False, do_lba=False, do_cull=False),
    dict(do_triangulate=True, do_fuse=False, do_lba=False, do_cull=False),
    dict(do_triangulate=True, do_fuse=True, do_lba=False, do_cull=False),
    dict(do_triangulate=True, do_fuse=True, do_lba=True, do_cull=False),
    dict(do_triangulate=True, do_fuse=True, do_lba=True, do_cull=True),
):
    tag = "+".join(k[3:] for k, v in flags.items() if v) or "base"
    bench(f"mapping_stage[{tag}]",
          lambda f=flags: slam_mod.mapping_stage(m, slot, cfg, **f), reps=4)

# isolated passes
from opendlv_perception_vision_orbslam2_jax.models.triangulation import (
    create_new_map_points,
)
from opendlv_perception_vision_orbslam2_jax.models.fusion import run_fusion
from opendlv_perception_vision_orbslam2_jax.models.local_mapping import (
    local_mapping_step,
)
from opendlv_perception_vision_orbslam2_jax.models.map_state import (
    point_observation_counts,
    recompute_covisibility,
)

counts = point_observation_counts(m)
bench("  create_new_map_points(10 nb)",
      lambda: create_new_map_points(m, slot, cfg, 10, False, counts), reps=4)
bench("  run_fusion", lambda: run_fusion(m, slot, cfg, 10, False, counts),
      reps=4)
bench("  local_mapping_step",
      lambda: local_mapping_step(m, slot, cfg, update_covis=False,
                                 counts=counts), reps=4)
bench("  recompute_covisibility", lambda: recompute_covisibility(m))
bench("  point_observation_counts", lambda: point_observation_counts(m))

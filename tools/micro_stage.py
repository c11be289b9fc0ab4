"""Time the fused keyframe_stage on the device with components toggled off."""
import time
import numpy as np
import jax
import jax.numpy as jnp

from opendlv_perception_vision_orbslam2_jax.models import slam as slam_mod
from opendlv_perception_vision_orbslam2_jax.utils import synthetic
from opendlv_perception_vision_orbslam2_jax.utils.config import SystemConfig

cfg = SystemConfig()
print("backend:", jax.default_backend())

n = 18
lefts, rights, gt, _ = synthetic.render_stereo_sequence(
    cfg, n_frames=n, n_points=1200, seed=1, step=0.6
)
slam = slam_mod.StereoSlam(cfg)
for i in range(n):
    slam.process(lefts[i], rights[i], timestamp=i / 15.0)
m = slam.map
frame = slam.last_frame
binds = slam.last_bindings
print("kfs:", int(jnp.sum(m.kf_valid)), "pts:", int(jnp.sum(m.pt_valid)))


def bench(name, **flags):
    f = dict(do_triangulate=True, do_fuse=True, do_lba=True, do_cull=True)
    f.update(flags)
    out = slam_mod.keyframe_stage(m, frame, binds, cfg, **f)
    np.asarray(out[0].kf_valid)
    t0 = time.time()
    for _ in range(4):
        out = slam_mod.keyframe_stage(m, frame, binds, cfg, **f)
        np.asarray(out[0].kf_valid)
    print(f"{name:<22}{(time.time()-t0)/4*1e3:9.1f} ms")


bench("FULL")
bench("no_triangulate", do_triangulate=False)
bench("no_fuse", do_fuse=False)
bench("no_lba", do_lba=False)
bench("no_cull", do_cull=False)
bench("insert_only", do_triangulate=False, do_fuse=False, do_lba=False,
      do_cull=False)

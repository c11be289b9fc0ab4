"""Trace the keyframe decision inputs per frame (why does it fire?)."""
import sys
import numpy as np
import jax
import jax.numpy as jnp

from opendlv_perception_vision_orbslam2_jax.models import slam as slam_mod
from opendlv_perception_vision_orbslam2_jax.utils import synthetic
from opendlv_perception_vision_orbslam2_jax.utils.config import SystemConfig

cfg = SystemConfig()
n = int(sys.argv[1]) if len(sys.argv) > 1 else 20
lefts, rights, gt, _ = synthetic.render_stereo_sequence(
    cfg, n_frames=n, n_points=1200, seed=1, step=0.6
)

slam = slam_mod.StereoSlam(cfg)
orig_insert = slam_mod.StereoSlam._insert_keyframe
kf_log = []


def insert_hook(self, frame, bindings):
    kf_log.append(True)
    return orig_insert(self, frame, bindings)


slam_mod.StereoSlam._insert_keyframe = insert_hook

for i in range(n):
    kf_log.append(False)
    slam.process(np.asarray(lefts[i]), np.asarray(rights[i]), timestamp=i / 15.0)
    if hasattr(slam, "last_stats"):
        s = slam.last_stats
        print(f"f{i:02d} inl={s[0]:4d} tracked={s[1]:4d} close+={s[2]:4d} "
              f"close-={s[3]:4d} ref={slam.ref_kf_tracked:4d} "
              f"since_kf={slam.frames_since_kf} kf={'KF' if True in kf_log[-2:] else ''} "
              f"nkf={slam.n_keyframes} pts={int(np.asarray(slam.map.pt_valid).sum())}")

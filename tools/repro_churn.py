"""140-frame churn repro: prints lost count (green reference: 5/140)."""
import numpy as np
import jax.numpy as jnp

import opendlv_perception_vision_orbslam2_jax.models.slam as slam_mod
from opendlv_perception_vision_orbslam2_jax.utils import synthetic
from opendlv_perception_vision_orbslam2_jax.utils.config import (
    CameraConfig, OrbConfig, SystemConfig, TrackingConfig,
)

cfg = SystemConfig(
    camera=CameraConfig(fx=320.0, fy=320.0, cx=256.0, cy=128.0,
                        bf=160.0, width=512, height=256, fps=10.0),
    orb=OrbConfig(n_features=600, max_keypoints=1024, n_levels=4),
    tracking=TrackingConfig(max_frames=5),
    max_keyframes=64,
    max_map_points=32768,
)
n = 140
lefts, rights, gt, _ = synthetic.render_loop_sequence(
    cfg, n_frames=n, n_points=2400, seed=4, radius=20.0, laps=1.5 * n / 200
)
slam = slam_mod.StereoSlam(cfg)
lost = 0
for i in range(n):
    slam.process(lefts[i], rights[i], timestamp=i * 0.1)
    lost += int(slam.lost)
print(f"lost={lost}/{n} loops={slam.loops_closed} "
      f"kf={int(jnp.sum(slam.map.kf_valid))} "
      f"pts={int(jnp.sum(slam.map.pt_valid))}")

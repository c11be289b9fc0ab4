"""Per-component wall timing of the keyframe stage on the current backend.

Times each sub-step of StereoSlam._insert_keyframe + _register_keyframe with
hard syncs, on the KITTI-sized config the bench uses.
"""
import time
import numpy as np
import jax
import jax.numpy as jnp

from opendlv_perception_vision_orbslam2_jax.models import slam as slam_mod
from opendlv_perception_vision_orbslam2_jax.utils import synthetic
from opendlv_perception_vision_orbslam2_jax.utils.config import SystemConfig

cfg = SystemConfig()
print("backend:", jax.default_backend(), "feat cap:", cfg.orb.max_keypoints)

n = 26
lefts, rights, gt, _ = synthetic.render_stereo_sequence(
    cfg, n_frames=n, n_points=1200, seed=1, step=0.6
)
lefts = jax.device_put(np.asarray(lefts))
rights = jax.device_put(np.asarray(rights))

TIMES: dict = {}


def timed(name, fn, *a, **k):
    t0 = time.time()
    out = fn(*a, **k)
    # sync on the first leaf
    leaves = jax.tree.leaves(out)
    if leaves:
        np.asarray(leaves[0])
    dt = time.time() - t0
    TIMES.setdefault(name, []).append(dt)
    return out


orig_insert = slam_mod.StereoSlam._insert_keyframe


def instrumented_insert(self, frame, bindings):
    from opendlv_perception_vision_orbslam2_jax.models.map_state import (
        evict_oldest_if_full,
    )
    from opendlv_perception_vision_orbslam2_jax.models.triangulation import (
        create_new_map_points,
    )

    t_all = time.time()
    self.map = timed("evict", evict_oldest_if_full, self.map)
    self.map, slot = timed(
        "insert", slam_mod.insert_keyframe, self.map, frame, bindings,
        self._th_far,
    )
    self.map = timed(
        "cull_points", slam_mod.cull_points, self.map, self.map.next_kf_id - 1
    )
    if self.n_keyframes >= 1:
        self.map = timed(
            "triangulate", create_new_map_points, self.map, int(slot),
            self.config, n_neighbors=10,
        )
    if self.n_keyframes >= 1:
        self.map = timed("fusion", slam_mod.run_fusion, self.map, slot, self.config)
    if self.n_keyframes >= 2:
        self.map = timed(
            "local_ba", slam_mod.local_mapping_step, self.map, slot, self.config
        )
    if self.n_keyframes >= 4:
        self.map = timed("cull_kf", slam_mod.cull_keyframes, self.map, slot)
    self.n_keyframes += 1
    self.frames_since_kf = 0
    self.last_kf_slot = int(slot)
    timed("register", self._register_keyframe, int(slot))
    TIMES.setdefault("KF_TOTAL", []).append(time.time() - t_all)
    return self.map.kf_obs_point[slot]


slam_mod.StereoSlam._insert_keyframe = instrumented_insert

slam = slam_mod.StereoSlam(cfg)
t0 = time.time()
frame_times = []
for i in range(n):
    t1 = time.time()
    slam.process(lefts[i], rights[i], timestamp=i / 15.0)
    frame_times.append(time.time() - t1)
print(f"total: {time.time()-t0:.1f}s  kfs={slam.n_keyframes}")

print(f"\n{'stage':<14}{'n':>4}{'first(ms)':>12}{'median(ms)':>12}{'last3(ms)':>24}")
for k, v in TIMES.items():
    ms = [x * 1e3 for x in v]
    tail = ", ".join(f"{x:.0f}" for x in ms[-3:])
    print(f"{k:<14}{len(ms):>4}{ms[0]:>12.0f}{np.median(ms[1:] or ms):>12.0f}"
          f"  [{tail}]")
print("\nframe times (ms):", [f"{x*1e3:.0f}" for x in frame_times])

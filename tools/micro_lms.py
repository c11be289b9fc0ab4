"""Microbench the pieces of local_mapping_step / fusion / triangulation on a
realistic mid-run map state (KITTI-sized config)."""
import time
import numpy as np
import jax
import jax.numpy as jnp

from opendlv_perception_vision_orbslam2_jax.models import slam as slam_mod
from opendlv_perception_vision_orbslam2_jax.models import local_mapping as lm
from opendlv_perception_vision_orbslam2_jax.models import map_state as ms
from opendlv_perception_vision_orbslam2_jax.models.triangulation import (
    create_new_map_points,
)
from opendlv_perception_vision_orbslam2_jax.optim.ba import bundle_adjust
from opendlv_perception_vision_orbslam2_jax.utils import synthetic
from opendlv_perception_vision_orbslam2_jax.utils.config import SystemConfig

cfg = SystemConfig()
print("backend:", jax.default_backend(),
      "K_cap:", cfg.max_keyframes, "P_cap:", cfg.max_map_points,
      "F_cap:", cfg.orb.max_keypoints)

n = 18
lefts, rights, gt, _ = synthetic.render_stereo_sequence(
    cfg, n_frames=n, n_points=1200, seed=1, step=0.6
)
slam = slam_mod.StereoSlam(cfg)
for i in range(n):
    slam.process(lefts[i], rights[i], timestamp=i / 15.0)
m = slam.map
slot = slam.last_kf_slot
print("kfs:", int(jnp.sum(m.kf_valid)), "pts:", int(jnp.sum(m.pt_valid)),
      "slot:", slot)


def bench(name, fn, *a, n_rep=3, **k):
    out = fn(*a, **k)
    np.asarray(jax.tree.leaves(out)[0])
    t0 = time.time()
    for _ in range(n_rep):
        out = fn(*a, **k)
        np.asarray(jax.tree.leaves(out)[0])
    print(f"{name:<34}{(time.time()-t0)/n_rep*1e3:9.1f} ms")
    return out


cam = cfg.camera
ext = bench("extract_local_ba", lm.extract_local_ba, m, slot,
            lm.KO_DEFAULT, lm.KFIX_DEFAULT, lm.PL_DEFAULT,
            cfg.orb.scale_factor)
nreal_e = int(jnp.sum(ext.prob.e_valid))
nreal_p = int(jnp.sum(ext.prob.pt_valid))
print(f"  real edges: {nreal_e}/{ext.prob.e_valid.shape[0]} "
      f"real pts: {nreal_p}/{ext.prob.pt_valid.shape[0]}")
res = bench("bundle_adjust", bundle_adjust, ext.prob,
            fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, bf=cam.bf,
            fix_first_pose=True)
m2 = bench("write_back", lm.write_back_local_ba, m, ext, res.T_opt, res.pts,
           res.edge_inlier)
bench("refresh_windowed", ms.refresh_windowed, m2, ext.local_pt_slots,
      ext.window_kf_slots)
bench("local_mapping_step_ALL", lm.local_mapping_step, m, slot, cfg)
bench("recompute_covisibility", ms.recompute_covisibility, m2)
bench("run_fusion", slam_mod.run_fusion, m, slot, cfg)
bench("create_new_map_points", create_new_map_points, m, slot, cfg,
      n_neighbors=10)
bench("cull_points", slam_mod.cull_points, m, m.next_kf_id - 1)
bench("cull_keyframes", slam_mod.cull_keyframes, m, slot)
bench("evict", ms.evict_oldest_if_full, m)
bench("insert_keyframe", ms.insert_keyframe, m, slam.last_frame,
      slam.last_bindings, slam._th_far)

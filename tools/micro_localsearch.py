"""Why does per-frame local-map search bind so few points?

Runs a short sequence, then re-runs _search_local_points on the last frame
with gate-by-gate counters: visible, spatially-gated, Hamming-passing,
ratio-test-surviving.  Identifies which gate suppresses bindings (keyframes
bind ~590 mature points via creation+fusion while tracking binds ~200).
"""
import sys
import numpy as np
import jax
import jax.numpy as jnp

from opendlv_perception_vision_orbslam2_jax.utils.compile_cache import (  # noqa: E402
    enable_compile_cache,
)

enable_compile_cache()

from opendlv_perception_vision_orbslam2_jax.models import slam as slam_mod
from opendlv_perception_vision_orbslam2_jax.models.slam import (
    _local_point_window, PL_TRACK)
from opendlv_perception_vision_orbslam2_jax.ops import lie
from opendlv_perception_vision_orbslam2_jax.ops.hamming import (
    MAX_DIST, TH_HIGH, hamming_matrix)
from opendlv_perception_vision_orbslam2_jax.utils import synthetic
from opendlv_perception_vision_orbslam2_jax.utils.config import SystemConfig

cfg = SystemConfig()
n = int(sys.argv[1]) if len(sys.argv) > 1 else 14
lefts, rights, gt, _ = synthetic.render_stereo_sequence(
    cfg, n_frames=n, n_points=1200, seed=1, step=0.6
)
slam = slam_mod.StereoSlam(cfg, enable_loop_closing=False,
                           enable_relocalization=False)
for i in range(n):
    slam.process(np.asarray(lefts[i]), np.asarray(rights[i]),
                 timestamp=i / 15.0)
slam.finish()

m = slam.map
cur = slam.last_frame
bindings0 = slam.last_bindings
T_cw = slam.T_cw
cam = cfg.camera
P = m.pt_capacity

local_pts = _local_point_window(m, bindings0)
ok = local_pts >= 0
slots = jnp.clip(local_pts, 0, P - 1)
p_w = m.pt_pos[slots]
p_c = lie.transform_points(T_cw[None], p_w[None])[0]
z = p_c[:, 2]
uv = lie.project(p_c, cam.fx, cam.fy, cam.cx, cam.cy)
cam_center = lie.inv_T(T_cw)[:3, 3]
view = p_w - cam_center
dist_w = jnp.linalg.norm(view, axis=-1) + 1e-9
view_cos = jnp.sum(view * m.pt_normal[slots], axis=-1) / dist_w
in_img = ((z > 0.1) & (uv[:, 0] >= 0) & (uv[:, 0] < cam.width)
          & (uv[:, 1] >= 0) & (uv[:, 1] < cam.height))
band_ok = ((dist_w >= 0.8 * m.pt_min_dist[slots])
           & (dist_w <= 1.2 * m.pt_max_dist[slots]))
cos_ok = view_cos > 0.5
visible = ok & in_img & band_ok & cos_ok

ratio = jnp.maximum(m.pt_max_dist[slots] / jnp.maximum(dist_w, 1e-6), 1.0)
pred_oct = jnp.clip(
    jnp.ceil(jnp.log(ratio) / jnp.log(cfg.orb.scale_factor)).astype(jnp.int32),
    0, cfg.orb.n_levels - 1)
radius = jnp.where(view_cos > 0.998, 2.5, 4.0) * jnp.power(
    jnp.float32(cfg.orb.scale_factor), pred_oct.astype(jnp.float32))

feats = cur.features
d_uv = feats.xy[None, :, :] - uv[:, None, :]
within = jnp.maximum(jnp.abs(d_uv[..., 0]), jnp.abs(d_uv[..., 1])) <= radius[:, None]
oct_ok = ((feats.octave[None, :] >= pred_oct[:, None] - 1)
          & (feats.octave[None, :] <= pred_oct[:, None] + 1))
unbound_dst = bindings0 < 0
gate = (within & oct_ok & visible[:, None]
        & feats.valid[None, :] & unbound_dst[None, :])
dmat = hamming_matrix(m.pt_desc[slots], feats.desc)
big = MAX_DIST + 1
d = jnp.where(gate, dmat, big)
best = jnp.argmin(d, axis=1)
best_d = jnp.take_along_axis(d, best[:, None], axis=1)[:, 0]
PL = local_pts.shape[0]
d2 = d.at[jnp.arange(PL), best].set(big)
second = jnp.min(d2, axis=1)

has_cand = jnp.any(gate, axis=1)
ham_pass = best_d <= TH_HIGH
ratio_pass = best_d.astype(jnp.float32) <= 0.8 * second.astype(jnp.float32)
# what the octave-aware reference ratio would do: skip ratio when best and
# second sit at different pyramid levels (src/orbmatcher.cpp:105-123)
best_oct = feats.octave[best]
second_idx = jnp.argmin(d2, axis=1)
second_oct = feats.octave[second_idx]
same_level = best_oct == second_oct
ratio_pass_ref = jnp.where(same_level, ratio_pass, True)

stats = {
    "local window points": int(jnp.sum(ok)),
    "in image": int(jnp.sum(ok & in_img)),
    "scale band ok": int(jnp.sum(ok & in_img & band_ok)),
    "view_cos ok (visible)": int(jnp.sum(visible)),
    "has spatial+octave candidate": int(jnp.sum(visible & has_cand)),
    "hamming<=TH_HIGH": int(jnp.sum(visible & has_cand & ham_pass)),
    "ratio 0.8 passes (ours)": int(jnp.sum(visible & has_cand & ham_pass
                                           & ratio_pass)),
    "ratio octave-aware (ref)": int(jnp.sum(visible & has_cand & ham_pass
                                            & ratio_pass_ref)),
    "already bound (pre-search)": int(jnp.sum(bindings0 >= 0)),
}
for k, v in stats.items():
    print(f"{k:<34}{v:6d}")
print(f"last_stats={list(map(int, slam.last_stats))}")

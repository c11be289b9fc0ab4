"""Why does local-map re-acquisition decay between keyframes?

Runs the small-camera loop drive for N frames, then for the last frame
breaks down _search_local_points' gates: of the map points geometrically
in view, how many die at each gate (band, view_cos, radius, octave,
TH_HIGH, ratio, duplicates)?
"""
import os
import sys

if os.environ.get("USE_GPU") != "1":
    os.environ["JAX_PLATFORMS"] = "cpu"

import numpy as np
import jax.numpy as jnp

from opendlv_perception_vision_orbslam2_jax.models.slam import (
    StereoSlam, _local_point_window, TH_HIGH,
)
from opendlv_perception_vision_orbslam2_jax.ops import lie
from opendlv_perception_vision_orbslam2_jax.ops.hamming import hamming_matrix
from opendlv_perception_vision_orbslam2_jax.utils import synthetic
from opendlv_perception_vision_orbslam2_jax.utils.config import (
    CameraConfig, OrbConfig, SystemConfig,
)


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 28
    if os.environ.get("USE_GPU") == "1":
        cfg = SystemConfig(initial_keyframes=64, initial_map_points=8192)
        lefts, rights, gt, _ = synthetic.render_loop_sequence(
            cfg, n_frames=n + 1, n_points=3200, seed=1, radius=35.0,
            laps=0.72 * (n + 1) / 150,
            r_off_range=(6.0, 30.0), y_range=(-2.5, 2.0),
            lateral_range=(-14.0, 14.0),
        )
    else:
        cfg = SystemConfig(
            camera=CameraConfig(fx=320.0, fy=320.0, cx=256.0, cy=128.0,
                                bf=160.0, width=512, height=256, fps=10.0),
            orb=OrbConfig(n_features=600, max_keypoints=1024, n_levels=4),
            tracking=__import__(
                "opendlv_perception_vision_orbslam2_jax.utils.config",
                fromlist=["TrackingConfig"],
            ).TrackingConfig(max_frames=5),
            max_keyframes=64,
            max_map_points=32768,
        )
        lefts, rights, gt, _ = synthetic.render_loop_sequence(
            cfg, n_frames=n + 1, n_points=2400, seed=4, radius=20.0, laps=1.5 * (n + 1) / 200
        )
    slam = StereoSlam(cfg)
    for i in range(n):
        slam.process(lefts[i], rights[i], timestamp=i * 0.1)
        print(f"f{i}: inl={int(np.asarray(s)[0]) if (s := getattr(slam, "last_stats", None)) is not None else -1} "
              f"nb={int(np.asarray((slam.last_bindings >= 0).sum()))} "
              f"pts={int(np.asarray(slam.map.pt_valid.sum()))} kfs={slam.n_keyframes}")

    # now dissect the final frame's local search by hand
    m = slam.map
    cam = cfg.camera
    cur = slam.last_frame
    T_cw = slam.T_cw
    bindings = slam.last_bindings
    P = m.pt_capacity

    local_pts = _local_point_window(m, bindings)
    n_local = int(np.asarray((local_pts >= 0).sum()))

    ok = local_pts >= 0
    slots = jnp.clip(local_pts, 0, P - 1)
    already = jnp.zeros((P,), bool).at[
        jnp.where(bindings >= 0, bindings, P - 1)
    ].set(bindings >= 0)
    n_already = int(np.asarray((ok & jnp.take(already, slots)).sum()))
    ok = ok & ~jnp.take(already, slots)

    p_w = m.pt_pos[slots]
    p_c = lie.transform_points(T_cw[None], p_w[None])[0]
    z = p_c[:, 2]
    uv = lie.project(p_c, cam.fx, cam.fy, cam.cx, cam.cy)
    cam_center = lie.inv_T(T_cw)[:3, 3]
    view = p_w - cam_center
    dist_w = jnp.linalg.norm(view, axis=-1) + 1e-9
    view_cos = jnp.sum(view * m.pt_normal[slots], axis=-1) / dist_w
    in_img = (
        (z > 0.1)
        & (uv[:, 0] >= 0) & (uv[:, 0] < cam.width)
        & (uv[:, 1] >= 0) & (uv[:, 1] < cam.height)
    )
    band_ok = (dist_w >= 0.8 * m.pt_min_dist[slots]) & (
        dist_w <= 1.2 * m.pt_max_dist[slots]
    )
    cos_ok = view_cos > 0.5
    print(f"\nlocal window: {n_local} pts ({n_already} already bound)")
    geo = ok & in_img
    print(f"in image: {int(np.asarray(geo.sum()))}")
    print(f"  +dist band: {int(np.asarray((geo & band_ok).sum()))}")
    print(f"  +view_cos: {int(np.asarray((geo & band_ok & cos_ok).sum()))}")
    visible = geo & band_ok & cos_ok

    ratio = jnp.maximum(m.pt_max_dist[slots] / jnp.maximum(dist_w, 1e-6), 1.0)
    pred_oct = jnp.clip(
        jnp.ceil(jnp.log(ratio) / jnp.log(cfg.orb.scale_factor)).astype(jnp.int32),
        0, cfg.orb.n_levels - 1,
    )
    radius = jnp.where(view_cos > 0.998, 2.5, 4.0) * jnp.power(
        jnp.float32(cfg.orb.scale_factor), pred_oct.astype(jnp.float32)
    )
    feats = cur.features
    d_uv = feats.xy[None, :, :] - uv[:, None, :]
    within = jnp.maximum(jnp.abs(d_uv[..., 0]), jnp.abs(d_uv[..., 1])) <= radius[:, None]
    oct_ok = (feats.octave[None, :] >= pred_oct[:, None] - 1) & (
        feats.octave[None, :] <= pred_oct[:, None] + 1
    )
    unbound = bindings < 0
    cand0 = within & visible[:, None] & feats.valid[None, :]
    cand1 = cand0 & oct_ok
    cand2 = cand1 & unbound[None, :]
    has0 = jnp.any(cand0, axis=1)
    has1 = jnp.any(cand1, axis=1)
    has2 = jnp.any(cand2, axis=1)
    print(f"  +has feat within radius: {int(np.asarray((visible & has0).sum()))}")
    print(f"  +octave gate: {int(np.asarray((visible & has1).sum()))}")
    print(f"  +unbound dst: {int(np.asarray((visible & has2).sum()))}")

    dmat = hamming_matrix(m.pt_desc[slots], feats.desc)
    big = 257
    d = jnp.where(cand2, dmat, big)
    best_d = jnp.min(d, axis=1)
    print(f"  +TH_HIGH({TH_HIGH}): "
          f"{int(np.asarray((visible & (best_d <= TH_HIGH)).sum()))}")
    # wider radius: what would 2x radius find?
    within2 = jnp.maximum(jnp.abs(d_uv[..., 0]), jnp.abs(d_uv[..., 1])) <= 2 * radius[:, None]
    c2 = within2 & visible[:, None] & feats.valid[None, :] & oct_ok & unbound[None, :]
    d2 = jnp.where(c2, dmat, big)
    bd2 = jnp.min(d2, axis=1)
    print(f"  [2x radius would match: "
          f"{int(np.asarray((visible & (bd2 <= TH_HIGH)).sum()))}]")
    # no-octave-gate check
    c3 = within & visible[:, None] & feats.valid[None, :] & unbound[None, :]
    d3 = jnp.where(c3, dmat, big)
    bd3 = jnp.min(d3, axis=1)
    print(f"  [no octave gate would match: "
          f"{int(np.asarray((visible & (bd3 <= TH_HIGH)).sum()))}]")
    probe_pose_opt(slam, cfg)




def probe_pose_opt(slam, cfg):
    """After a manual local search, how many bindings survive pose-opt?"""
    import jax
    from opendlv_perception_vision_orbslam2_jax.models.slam import (
        _local_point_window, _search_local_points,
    )
    from opendlv_perception_vision_orbslam2_jax.models.frame import (
        features_scale_sigma2,
    )
    from opendlv_perception_vision_orbslam2_jax.optim.pose_opt import (
        PoseObs, pose_optimize,
    )
    m = slam.map
    cam = cfg.camera
    cur = slam.last_frame
    T_cw = slam.T_cw
    bindings = slam.last_bindings
    P = m.pt_capacity
    local_pts = _local_point_window(m, bindings)
    new_b, _ = _search_local_points(m, local_pts, bindings, T_cw, cur, cfg)
    sigma2 = features_scale_sigma2(cur.features, cfg.orb.scale_factor)
    bound = new_b >= 0
    safe_b = jnp.clip(new_b, 0, P - 1)
    obs = PoseObs(
        p_w=m.pt_pos[safe_b], uv=cur.features.xy,
        u_right=cur.features.u_right, sigma2=sigma2,
        valid=bound & m.pt_valid[safe_b] & cur.features.valid,
    )
    T2, inliers, n_inl = pose_optimize(
        T_cw, obs, fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, bf=cam.bf)
    nb0 = int(np.asarray((bindings >= 0).sum()))
    nb1 = int(np.asarray(bound.sum()))
    print(f"\npose-opt probe: bound before search={nb0} after={nb1} "
          f"pose-opt inliers={int(np.asarray(n_inl))}")
    # of the NEW matches specifically, how many are inliers?
    newly = bound & (bindings < 0)
    new_in = int(np.asarray((newly & inliers & obs.valid).sum()))
    print(f"new matches={int(np.asarray(newly.sum()))} of which inliers={new_in}")
    inh = (bindings >= 0)
    inh_in = int(np.asarray((inh & inliers & obs.valid).sum()))
    print(f"inherited={int(np.asarray(inh.sum()))} of which inliers={inh_in}")


if __name__ == "__main__":
    main()

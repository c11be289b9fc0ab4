"""Benchmark: tracked frames/s per chip on a KITTI-sized synthetic stereo run.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}.

Baseline: the reference operates KITTI seq 00 at its --Camera.fps=15
real-time pacing target (reference: docker-compose.yml:43;
src/kittirunner.cpp:163-170 sleeps to hold that rate), which is also the
reference's keyframe-window operating point.  No KITTI data ships in this
environment (reference dataset dirs are empty stubs), so the bench renders a
KITTI-geometry synthetic sequence (1241x376, fx=718.856, bf=386.1448,
2000 ORB features, 8 levels) and measures the fused per-frame SLAM step.
"""

import json
import sys
import time

import numpy as np


def main():
    import jax

    from opendlv_perception_vision_orbslam2_jax.utils.compile_cache import (
        enable_compile_cache,
    )
    from opendlv_perception_vision_orbslam2_jax.utils.device import require_gpu

    try:
        device = require_gpu()
    except RuntimeError as e:
        print(f"bench: {e}", file=sys.stderr)
        raise SystemExit(1)
    print(f"device: {device['platform']} {device['kind']} x{device['count']}; "
          f"cards: {'; '.join(device['cards'])}", file=sys.stderr)
    enable_compile_cache()

    from opendlv_perception_vision_orbslam2_jax.models.frontend import process_stereo
    from opendlv_perception_vision_orbslam2_jax.models.tracking import (
        init_state,
        vo_step,
    )
    from opendlv_perception_vision_orbslam2_jax.utils import synthetic
    from opendlv_perception_vision_orbslam2_jax.utils.config import SystemConfig

    cfg = SystemConfig()  # KITTI 00 geometry + ORB budget defaults
    n_frames = 24
    n_timed = 16

    print(f"rendering {n_frames} synthetic KITTI-sized frames...", file=sys.stderr)
    lefts, rights, gt_poses, _ = synthetic.render_stereo_sequence(
        cfg, n_frames=n_frames, n_points=900, seed=0, step=0.6
    )
    lefts = jax.device_put(lefts)
    rights = jax.device_put(rights)

    state = init_state(process_stereo(lefts[0], rights[0], cfg))

    # Warm-up (compile) on the first frames.
    t_compile = time.time()
    inlier_log = []
    for i in range(1, n_frames - n_timed):
        state, T = vo_step(state, lefts[i], rights[i], cfg)
        inlier_log.append(state.n_inliers)
    jax.block_until_ready(state.n_inliers)
    print(f"compile+warmup: {time.time()-t_compile:.1f}s", file=sys.stderr)

    # Throughput: enqueue the timed frames back-to-back, fetch poses at the
    # end (pose readout overlaps compute in a real deployment; per-frame
    # latency is reported separately below).
    t0 = time.time()
    pose_handles = []
    for i in range(n_frames - n_timed, n_frames):
        state, T = vo_step(state, lefts[i], rights[i], cfg)
        pose_handles.append(T)
        inlier_log.append(state.n_inliers)
    jax.block_until_ready(state.n_inliers)
    dt = time.time() - t0
    fps = n_timed / dt

    # Per-frame latency with a forced sync each frame.
    t0 = time.time()
    n_lat = 4
    for i in range(n_frames - n_lat, n_frames):
        state, T = vo_step(state, lefts[i], rights[i], cfg)
        jax.block_until_ready(T)
    lat_ms = (time.time() - t0) / n_lat * 1e3

    inliers = [int(x) for x in np.asarray(jax.device_get(inlier_log))]
    print(f"frames/s={fps:.2f}  latency/frame={lat_ms:.1f} ms  "
          f"inliers per frame={inliers}", file=sys.stderr)
    if min(inliers[1:]) < 10:
        print("WARNING: tracking lost during bench", file=sys.stderr)

    # ---- FULL SLAM pipeline (keyframes + local BA + fusion + culling +
    # loop detection): the reference's benchmarkable path is the whole
    # system (src/kittirunner.cpp:99-173), not the VO slice --------------
    # bench capacities: sized so the 1.25-lap circuit never triggers a
    # capacity-bucket regrow (a regrow recompiles the whole per-frame
    # program inventory mid-timing)
    import dataclasses
    bench_cfg = dataclasses.replace(
        cfg, initial_keyframes=128, initial_map_points=16384
    )
    lefts, rights, gt_poses = render_loop_circuit(bench_cfg)
    full = bench_full_slam(bench_cfg, lefts, rights, gt_poses)
    full_fps, ate_m, loops = full["fps"], full["ate_m"], full["loops_closed"]

    baseline_fps = 15.0  # reference real-time operating point (see docstring)
    out = {
        "metric": "tracked_frames_per_s_full_slam_kitti_loop_circuit_stereo",
        "value": round(full_fps, 2),
        "unit": "frames/s",
        "vs_baseline": round(full_fps / baseline_fps, 3),
        "vo_frames_per_s": round(fps, 2),
        "vo_latency_ms": round(lat_ms, 1),
        "worst_frame_ms": round(full["worst_ms"], 1),
        "keyframe_frames": full["keyframe_frames"],
        "loops_closed": loops,
        "ate_m": round(ate_m, 3),
        "warmup_s": round(full["warmup_s"], 1),
        "device": {k: device[k] for k in ("platform", "kind", "count")},
        "cards": device["cards"],
    }
    if loops < 1:
        out["warning_loops"] = "no loop closure fired in the timed window"
    # accuracy guard: speed must not be bought with accuracy (the
    # north-star metric couples ATE RMSE with frames/s)
    if ate_m > 0.5:
        out["warning"] = f"ATE {ate_m:.3f} m exceeds the 0.5 m bound"
    print(json.dumps(out))


def _prewarm_variants(slam, cfg):
    """Touch every device-program variant the steady state (and the loop
    closure) reaches, so first-call tracing + compile-cache loads happen in
    warmup instead of inside the timed window (a variant first touched
    mid-timing once cost a 9.5 s worst-frame):

    - the queued/no-LBA mapping stage (InterruptBA drain path),
    - the Sim3 verification + masked-apply program (verify_and_apply),
    - the incremental post-loop GBA chunk programs.

    Everything here is DISCARDED — the map is functional, so running a
    stage on it and dropping the output has no effect on SLAM state."""
    import jax

    from opendlv_perception_vision_orbslam2_jax.models import slam as slam_mod
    from opendlv_perception_vision_orbslam2_jax.models.global_ba import (
        IncrementalGBA,
    )
    from opendlv_perception_vision_orbslam2_jax.models.loop_closing import (
        verify_and_apply,
    )

    slam._try_adopt_mapping(force=True)
    slot = getattr(slam, "last_kf_slot", 0)
    m_d, aux_d = slam_mod.mapping_stage(
        slam.map, slot, cfg,
        do_triangulate=True, do_fuse=True, do_lba=False, do_cull=True,
    )
    jax.block_until_ready(aux_d)
    if slam.loop_closer is not None and slam.kf_nodes is not None:
        m_v, valid, _, _ = verify_and_apply(
            slam.map, slam.kf_nodes, slot, 0, -1, -1,
            jax.random.PRNGKey(0), cfg, True,
        )
        jax.block_until_ready(valid)  # expect-ids never match: map unchanged
    gba = IncrementalGBA(slam.map, cfg)
    gba.step()
    del m_d, gba


def render_loop_circuit(cfg, n_frames: int = 260):
    """The full-SLAM bench drive: 1.25 laps of a radius-35 m circle through
    a seeded ring world, rendered on the device.  Returns device arrays
    ``(lefts, rights)`` and the host ground-truth poses."""
    import jax

    from opendlv_perception_vision_orbslam2_jax.utils import synthetic

    lefts, rights, gt_poses, _ = synthetic.render_loop_sequence(
        cfg, n_frames=n_frames, n_points=3200, seed=1,
        radius=35.0, laps=1.25,
        r_off_range=(6.0, 30.0), y_range=(-2.5, 2.0),
        lateral_range=(-14.0, 14.0),
    )
    return (jax.device_put(np.asarray(lefts)),
            jax.device_put(np.asarray(rights)), np.asarray(gt_poses))


def bench_full_slam(cfg, lefts, rights, gt_poses, n_warm: int = 36) -> dict:
    """Steady-state throughput + frame-time distribution of
    StereoSlam.process (tracking + keyframe insertion + triangulation +
    fusion + local BA + culling + loop detection/closure + incremental GBA)
    on the :func:`render_loop_circuit` drive, whose timed window contains a
    REAL loop closure (detection -> Sim3 verification -> essential-graph
    correction -> incremental GBA) — the reference's whole benchmarkable
    path including its LoopClosing thread (src/kittirunner.cpp:99-173,
    src/loopclosing.cpp:49-83).

    Returns frames/s, per-frame times (s), p50/p99/worst (ms) and the
    worst frame's index, keyframes inserted in the window, loops closed,
    lost, warm-up seconds and the aligned ATE of the retro-corrected
    trajectory."""
    from opendlv_perception_vision_orbslam2_jax.models.slam import StereoSlam

    n_frames = len(gt_poses)
    slam = StereoSlam(cfg)
    gt_used = []
    # warmup: compiles the tracking step AND the keyframe stage programs
    t0 = time.time()
    for i in range(n_warm):
        T = slam.process(lefts[i], rights[i], timestamp=i / 15.0)
        if T is not None:
            gt_used.append(gt_poses[i])
    _prewarm_variants(slam, cfg)
    warm_s = time.time() - t0
    print(f"full-SLAM compile+warmup: {warm_s:.1f}s "
          f"(kfs={slam.n_keyframes})", file=sys.stderr)

    times = []
    kf_before = slam.n_keyframes
    for i in range(n_warm, n_frames):
        t1 = time.time()
        T = slam.process(lefts[i], rights[i], timestamp=i / 15.0)
        times.append(time.time() - t1)
        if T is not None:
            gt_used.append(gt_poses[i])
    kf_frames = slam.n_keyframes - kf_before
    slam.finish()   # settle in-flight verify/GBA so loops_closed is final

    # accuracy alongside throughput (north-star: ATE RMSE + frames/s) on
    # the RETRO-CORRECTED trajectory: each frame re-expressed through its
    # reference keyframe's final pose, the reference's trajectory-dump
    # semantics (SaveTrajectoryKITTI, src/tracking.cpp:1449-1536) — raw
    # online poses straddle the pre-/post-loop-closure frames and misstate
    # the accuracy the system actually delivers at dump time.
    from opendlv_perception_vision_orbslam2_jax.utils.trajectory import ate_rmse

    est_corr = slam.corrected_trajectory()
    assert len(est_corr) == len(gt_used), (len(est_corr), len(gt_used))
    ms = np.asarray(times) * 1e3
    out = {
        "fps": len(times) / sum(times),
        "times_s": times,
        "p50_ms": float(np.percentile(ms, 50)),
        "p99_ms": float(np.percentile(ms, 99)),
        "worst_ms": float(ms.max()),
        "worst_frame": n_warm + int(np.argmax(ms)),
        "keyframe_frames": kf_frames,
        "map_points": int(np.asarray(slam.map.pt_valid).sum()),
        "loops_closed": slam.loops_closed,
        "lost": bool(slam.lost),
        "warmup_s": warm_s,
        "ate_m": ate_rmse(est_corr, gt_used, align=True),
    }
    print(
        f"full-SLAM frames/s={out['fps']:.2f} worst-frame={out['worst_ms']:.1f} "
        f"ms median={out['p50_ms']:.1f} ms keyframes={kf_frames} "
        f"map_pts={out['map_points']} lost={out['lost']} "
        f"ate={out['ate_m']:.3f} m loops={out['loops_closed']}",
        file=sys.stderr,
    )
    return out


if __name__ == "__main__":
    main()

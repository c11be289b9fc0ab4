"""Smoke run of the stereo SLAM path on a GPU.

    python chip_smoke.py               # one card: device, kernels, served, accuracy
    python chip_smoke.py --four-cards  # the sharded paths on four cards only

The main path is stereo ORB-SLAM2 at the geometry of the reference's
deployment: KITTI 00, 1241x376, 2,000 features, 8 levels, scale 1.2, loop
closing and relocalization on (``SystemConfig()`` defaults, the flags of the
README's KITTI command).  Phases, in order; any failure exits non-zero
before the final line:

- device: JAX's first device must be a GPU; print it and the cards'
  ``nvidia-smi`` name and power limit.
- kernels: the front-end kernels at KITTI widths (both eyes, all levels,
  2,000 keypoints per eye) against the NumPy oracles of ``ops/oracles.py``:
  FAST score + NMS maps, the 45x45 patch and 11x11 / 11x21 SAD window
  gathers, the descriptor blur and steered BRIEF, and the Hamming matrix.
- accuracy: the bench's seeded loop circuit (260 frames, 1.25 laps of a
  35 m circle) through ``StereoSlam``; at least one loop closed, not lost,
  aligned ATE of the retro-corrected trajectory <= 0.5 m.  Prints the
  frame-time readings and the device's peak memory.
- served: the same frames as a KITTI-layout PNG directory through the CLI
  entry point; checks ``poses.txt``, ``map.txt`` and ``fps.txt``.

``--four-cards`` runs only the paths that switch on with several devices:
the observation-sharded pose solve inside ``StereoSlam`` over the first 40
frames, the edge-sharded ``IncrementalGBA`` against the single-device GBA
chunk on that map, and the sharded pose GN against one device.

The last line of standard output is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

# The README's KITTI command without --cid, so that no OD4 session opens.
KITTI_FLAGS = (
    "--name=img.argb", "--width=1241", "--height=376", "--bpp=24",
    "--cameraType=stereo",
    "--Camera.fx=718.856", "--Camera.fy=718.856", "--Camera.cx=607.1928",
    "--Camera.cy=185.2157", "--Camera.fps=15", "--Camera.bf=386.1448",
    "--ThDepth=35", "--ORBextractor.nFeatures=2000",
    "--ORBextractor.scaleFactor=1.2", "--ORBextractor.nLevels=8",
    "--ORBextractor.iniThFAST=20", "--ORBextractor.minThFAST=7",
)
FOUR_CARD_FRAMES = 40


def log(msg: str) -> None:
    print(msg, flush=True)


def _equal(name: str, got, want) -> None:
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {got.shape} != {want.shape}")
    bad = int(np.sum(got != want))
    if bad:
        raise AssertionError(f"{name}: {bad} of {got.size} entries differ")


def phase_kernels(cfg, left, right) -> dict:
    """Front-end kernels on one stereo pair at ``cfg``'s widths, each
    compared with its NumPy oracle.  Returns counts of what was compared."""
    import jax
    import jax.numpy as jnp

    from opendlv_perception_vision_orbslam2_jax.models import extractor as ex
    from opendlv_perception_vision_orbslam2_jax.ops import fast as fast_ops
    from opendlv_perception_vision_orbslam2_jax.ops import hamming, oracles
    from opendlv_perception_vision_orbslam2_jax.ops import image as image_ops
    from opendlv_perception_vision_orbslam2_jax.ops import orb as orb_ops
    from opendlv_perception_vision_orbslam2_jax.ops import stereo

    orb = cfg.orb
    ini, mn = float(orb.ini_th_fast), float(orb.min_th_fast)
    levels = jax.jit(lambda pair: jax.vmap(lambda im: image_ops.build_pyramid(
        im, orb.n_levels, orb.scale_factor))(pair))(jnp.stack([left, right]))

    def fast_one(img):
        scores, strong = fast_ops.fast_with_fallback(img, ini, mn)
        return fast_ops.mask_border(fast_ops.nms_scores(scores),
                                    ex.EDGE_BORDER), strong

    fast_maps = jax.jit(lambda lv: [jax.vmap(fast_one)(x) for x in lv])(levels)
    levels_np = [np.asarray(lv) for lv in levels]
    n_corners = 0
    for lvl, (lv, (scores, strong)) in enumerate(zip(levels_np, fast_maps)):
        for eye in range(2):
            want, want_strong = oracles.fast_nms(lv[eye], ini, mn, ex.EDGE_BORDER)
            _equal(f"FAST+NMS level {lvl} eye {eye}", scores[eye], want)
            _equal(f"FAST strong level {lvl} eye {eye}", strong[eye], want_strong)
            n_corners += int(np.sum(want > 0))

    @jax.jit
    def select_and_gather(lv):
        _, _, _, valid, y0, x0 = ex._select_pyramid_keypoints(lv, orb)
        return valid, y0, x0, ex._gather_all_patches(lv, y0, x0, orb)

    valid, y0, x0, patches = select_and_gather(levels)
    y0, x0, patches_np = np.asarray(y0), np.asarray(x0), np.asarray(patches)
    budgets = ex.per_level_budgets(orb.n_features, orb.scale_factor, orb.n_levels)
    half, side = orb_ops.PATCH_HALF, orb_ops.PATCH_SIDE
    want = []
    for eye in range(2):
        off = 0
        for lv, b in zip(levels_np, budgets):
            padded = np.pad(lv[eye], half, mode="edge")
            want.append(oracles.windows(padded, y0[eye, off:off + b],
                                        x0[eye, off:off + b], side, side))
            off += b
    _equal("45x45 patch gather", patches_np, np.concatenate(want))

    # SAD windows: the stereo matcher's padded atlases at real widths.
    atlas_l, _ = stereo.build_atlas([lv[0] for lv in levels])
    atlas_r, _ = stereo.build_atlas([lv[1] for lv in levels])
    sh, sl = stereo.SAD_HALF, stereo.SLIDE
    win = 2 * sh + 1
    lp = jnp.pad(atlas_l, sh, mode="edge")
    rp = jnp.pad(atlas_r, ((sh, sh), (sh + sl, sh + sl)), mode="edge")
    rng = np.random.default_rng(0)
    n_sad = orb.max_keypoints
    for name, img, pw in (("11x11 SAD window gather", lp, win),
                          ("11x21 SAD strip gather", rp, win + 2 * sl)):
        h, w = img.shape
        ys = rng.integers(-4, h + 4, n_sad).astype(np.int32)   # some clip
        xs = rng.integers(-4, w + 4, n_sad).astype(np.int32)
        got = jax.jit(orb_ops.gather_atlas_windows, static_argnums=(3, 4))(
            img, jnp.asarray(ys), jnp.asarray(xs), win, pw)
        _equal(name, got, oracles.windows(np.asarray(img), ys, xs, win, pw))

    angles = jax.jit(orb_ops.ic_angles_from_patches)(patches)
    blurred = jax.jit(orb_ops.blur_patches)(patches)
    blur_err = float(np.max(np.abs(np.asarray(blurred, np.float64)
                                   - oracles.blur_patches(patches_np))))
    if not blur_err < 1e-3:     # float32 rounding of 49-tap sums of 0..255
        raise AssertionError(f"descriptor blur: max error {blur_err}")
    desc = np.asarray(jax.jit(orb_ops.brief_from_blurred)(blurred, angles))
    _equal("steered BRIEF", desc,
           oracles.brief_from_blurred(np.asarray(blurred), np.asarray(angles)))

    n = desc.shape[0] // 2
    desc_l, desc_r = desc[:n], desc[n:]
    dist = np.asarray(jax.jit(hamming.hamming_matrix)(desc_l, desc_r))
    for i in range(0, n, 256):
        _equal(f"Hamming rows {i}..", dist[i:i + 256],
               oracles.hamming_matrix(desc_l[i:i + 256], desc_r))
    return {"fast_corners": n_corners, "keypoints": int(np.sum(valid)),
            "patches": int(patches_np.shape[0]), "sad_windows": 2 * n_sad,
            "blur_max_err": blur_err, "hamming_pairs": n * n}


def phase_accuracy(cfg, lefts, rights, gt, n_warm: int = 36,
                   min_loops: int = 1, max_ate: float = 0.5) -> dict:
    """The full-SLAM bench on these frames, then its accuracy checks."""
    import bench

    r = bench.bench_full_slam(cfg, lefts, rights, gt, n_warm=n_warm)
    if r["loops_closed"] < min_loops:
        raise AssertionError(f"{r['loops_closed']} loops closed, "
                             f"expected >= {min_loops}")
    if r["lost"]:
        raise AssertionError("tracking lost at the end of the drive")
    if not r["ate_m"] <= max_ate:
        raise AssertionError(f"ATE {r['ate_m']:.3f} m > {max_ate} m")
    return r


def phase_served(lefts, rights, fps: float, workdir: str, flags) -> dict:
    """Write the frames as a KITTI-layout PNG directory, run the CLI entry
    point over it, and check its dumps."""
    from opendlv_perception_vision_orbslam2_jax.__main__ import main as cli_main
    from opendlv_perception_vision_orbslam2_jax.io.kitti import write_sequence

    n = len(lefts)
    write_sequence(workdir, np.asarray(lefts), np.asarray(rights),
                   [i / fps for i in range(n)])
    t0 = time.time()
    rc = cli_main([f"--kittiPath={workdir}", *flags])
    seconds = time.time() - t0
    if rc != 0:
        raise AssertionError(f"CLI exited with {rc}")
    poses = np.loadtxt(os.path.join(workdir, "poses.txt"), ndmin=2)
    if poses.shape != (n, 12) or not np.all(np.isfinite(poses)):
        raise AssertionError(f"poses.txt: shape {poses.shape}, "
                             f"finite={np.all(np.isfinite(poses))}")
    if os.path.getsize(os.path.join(workdir, "map.txt")) == 0:
        raise AssertionError("map.txt is empty")
    with open(os.path.join(workdir, "fps.txt")) as f:
        n_fps = sum(1 for line in f if line.strip())
    if n_fps != n:
        raise AssertionError(f"fps.txt has {n_fps} lines, expected {n}")
    return {"frames": n, "seconds": seconds}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded paths, on four cards")
    args = ap.parse_args(argv)

    import jax

    from opendlv_perception_vision_orbslam2_jax.utils.compile_cache import (
        enable_compile_cache,
    )
    from opendlv_perception_vision_orbslam2_jax.utils.config import SystemConfig
    from opendlv_perception_vision_orbslam2_jax.utils.device import require_gpu

    # -- device -----------------------------------------------------------
    try:
        device = require_gpu()
    except RuntimeError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 1
    want = 4 if args.four_cards else 1
    if device["count"] < want:
        print(f"chip_smoke: needs {want} GPUs, found {device['count']}",
              file=sys.stderr)
        return 1
    log(f"jax {jax.__version__}; device: platform={device['platform']} "
        f"kind={device['kind']} count={device['count']}")
    for card in device["cards"]:
        log(f"card: {card}")
    cache = enable_compile_cache()
    log(f"compile cache: {cache or os.environ.get('JAX_COMPILATION_CACHE_DIR')}")
    import bench

    cfg = SystemConfig()
    # bench capacities: the 1.25-lap circuit never regrows the map
    bench_cfg = dataclasses.replace(cfg, initial_keyframes=128,
                                    initial_map_points=16384)
    t0 = time.time()
    lefts, rights, gt = bench.render_loop_circuit(bench_cfg)
    log(f"rendered {len(gt)} loop-circuit frames in {time.time() - t0:.1f} s")

    if args.four_cards:
        from __graft_entry__ import dryrun_multichip

        t0 = time.time()
        r = dryrun_multichip(
            4, cfg, (lefts[:FOUR_CARD_FRAMES], rights[:FOUR_CARD_FRAMES]))
        log(f"four-cards: {FOUR_CARD_FRAMES} frames with the sharded pose "
            f"solve; sharded vs single-device GBA dT={r['gba_dT']:.3e} "
            f"dp={r['gba_dp']:.3e}; pose GN dT={r['pose_dT']:.3e} inliers "
            f"{r['pose_inliers'][0]} vs {r['pose_inliers'][1]} "
            f"({time.time() - t0:.1f} s)")
    else:
        # -- kernels ------------------------------------------------------
        t0 = time.time()
        k = phase_kernels(cfg, lefts[0], rights[0])
        log(f"kernels: all exact vs the NumPy oracles ({k}); "
            f"jax_default_matmul_precision="
            f"{jax.config.jax_default_matmul_precision} keeps float32 "
            f"matmuls out of TF32; {time.time() - t0:.1f} s")
        # -- accuracy -----------------------------------------------------
        r = phase_accuracy(bench_cfg, lefts, rights, gt)
        stats = jax.devices()[0].memory_stats() or {}
        card = "; ".join(device["cards"])
        log(f"smoke readings ({card}): warm-up {r['warmup_s']:.1f} s, "
            f"{r['fps']:.2f} frames/s, p50 {r['p50_ms']:.2f} ms, "
            f"p99 {r['p99_ms']:.2f} ms, worst {r['worst_ms']:.2f} ms (frame "
            f"{r['worst_frame']}) over {len(r['times_s'])} frames")
        log(f"accuracy: loops_closed={r['loops_closed']} lost={r['lost']} "
            f"ATE={r['ate_m']:.4f} m keyframes={r['keyframe_frames']} "
            f"peak_bytes_in_use={stats.get('peak_bytes_in_use')}")
        # -- served -------------------------------------------------------
        workdir = tempfile.mkdtemp(prefix="chip_smoke_kitti_")
        try:
            s = phase_served(lefts, rights, cfg.camera.fps, workdir,
                             KITTI_FLAGS)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        log(f"served: {s['frames']} frames through the CLI in "
            f"{s['seconds']:.1f} s; poses.txt, map.txt, fps.txt ok")

    log(json.dumps({"ok": True, "device": {
        "platform": device["platform"], "kind": device["kind"],
        "count": device["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

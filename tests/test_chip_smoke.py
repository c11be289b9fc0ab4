"""chip_smoke.py's phases at the 512x256 configuration, called directly on
the CPU; main() itself refuses to run without a GPU."""

import dataclasses

import numpy as np

import chip_smoke
from opendlv_perception_vision_orbslam2_jax.utils import synthetic
from opendlv_perception_vision_orbslam2_jax.utils.config import (
    CameraConfig,
    OrbConfig,
    SystemConfig,
)

SMALL = SystemConfig(
    camera=CameraConfig(fx=320.0, fy=320.0, cx=256.0, cy=128.0,
                        bf=160.0, width=512, height=256, fps=10.0),
    orb=OrbConfig(n_features=600, max_keypoints=1024, n_levels=4),
)
SMALL_FLAGS = (
    "--width=512", "--height=256", "--Camera.fx=320", "--Camera.fy=320",
    "--Camera.cx=256", "--Camera.cy=128", "--Camera.bf=160",
    "--Camera.fps=10", "--ORBextractor.nFeatures=600",
    "--ORBextractor.nLevels=4",
)


def _frames(n, seed=2):
    lefts, rights, gt, _ = synthetic.render_stereo_sequence(
        SMALL, n_frames=n, n_points=500, seed=seed, step=0.3)
    return lefts, rights, np.asarray(gt)


def test_main_demands_a_gpu(capsys):
    assert chip_smoke.main([]) == 1
    out = capsys.readouterr()
    assert '"ok"' not in out.out
    assert "no GPU" in out.err


def test_kernels_phase_small():
    lefts, rights, _ = _frames(1)
    r = chip_smoke.phase_kernels(SMALL, lefts[0], rights[0])
    assert r["keypoints"] > 300 and r["fast_corners"] > r["keypoints"]
    assert r["patches"] == 2 * SMALL.orb.n_features


def test_served_phase_small(tmp_path):
    lefts, rights, _ = _frames(6)
    r = chip_smoke.phase_served(lefts, rights, 10.0, str(tmp_path),
                                SMALL_FLAGS)
    assert r["frames"] == 6


def test_accuracy_phase_small():
    cfg = dataclasses.replace(SMALL, max_keyframes=32, max_map_points=8192,
                              initial_keyframes=32, initial_map_points=8192)
    lefts, rights, gt = _frames(14)
    r = chip_smoke.phase_accuracy(cfg, lefts, rights, gt, n_warm=8,
                                  min_loops=0, max_ate=0.1)
    assert len(r["times_s"]) == 6 and r["p99_ms"] <= r["worst_ms"]

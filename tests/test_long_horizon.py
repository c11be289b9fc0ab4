"""Long-horizon accuracy fixtures (VERDICT r4 task 9).

The reference's accuracy story is external: it dumps KITTI-format
trajectories over 4,500-frame sequences for offline ATE evaluation
(reference: src/tracking.cpp:1449-1536).  No KITTI data ships here, so
these drives are the stand-in: a >=300-frame closed-circuit route (forward
+ continuous turning + revisit) with the ATE asserted as a FRACTION of
trajectory length — the bound a slow drift regression fails even when a
short bench window cannot see it.

ATE is measured on the retro-corrected trajectory
(StereoSlam.corrected_trajectory — the reference's SaveTrajectoryKITTI
re-chaining), so an accepted loop closure must actually help, not hurt.
"""

import numpy as np
import pytest

from opendlv_perception_vision_orbslam2_jax.models.slam import StereoSlam
from opendlv_perception_vision_orbslam2_jax.models.mono_slam import MonocularSlam
from opendlv_perception_vision_orbslam2_jax.utils import synthetic, trajectory
from opendlv_perception_vision_orbslam2_jax.utils.config import (
    CameraConfig,
    OrbConfig,
    SystemConfig,
    TrackingConfig,
)


def _small_cfg(**kw):
    kw.setdefault("max_keyframes", 64)
    kw.setdefault("max_map_points", 32768)
    return SystemConfig(
        camera=CameraConfig(fx=320.0, fy=320.0, cx=256.0, cy=128.0,
                            bf=160.0, width=512, height=256, fps=10.0),
        orb=OrbConfig(n_features=600, max_keypoints=1024, n_levels=4),
        tracking=TrackingConfig(max_frames=5),
        **kw,
    )


@pytest.mark.slow
def test_stereo_300_frame_circuit_ate_below_1pct():
    """300 frames, 1.6 laps of a radius-20 circuit (path ~201 m): the
    corrected-trajectory ATE must stay under 1% of trajectory length, and
    the revisit must close at least one loop."""
    cfg = _small_cfg()
    n = 300
    radius, laps = 20.0, 1.6
    path_len = 2.0 * np.pi * radius * laps        # ~201 m
    lefts, rights, gt, _ = synthetic.render_loop_sequence(
        cfg, n_frames=n, n_points=2400, seed=11, radius=radius, laps=laps
    )
    slam = StereoSlam(cfg)
    lost = 0
    for i in range(n):
        slam.process(lefts[i], rights[i], timestamp=i * 0.1)
        lost += int(slam.lost)
    slam.finish()

    est = slam.corrected_trajectory()
    assert all(np.isfinite(T).all() for T in est), "non-finite poses"
    ate = trajectory.ate_rmse(est, list(np.asarray(gt))[: len(est)],
                              align=True)
    assert lost < 0.05 * n, f"lost {lost}/{n} frames"
    assert slam.loops_closed >= 1, "revisit closed no loop"
    assert ate < 0.01 * path_len, (
        f"ATE {ate:.2f} m over a {path_len:.0f} m drive "
        f"(bound {0.01 * path_len:.2f} m)"
    )


@pytest.mark.slow
def test_mono_long_arc_ate_below_2pct():
    """Monocular long-horizon drift: a 120-frame sideways-dominant arc
    (~21 m path; the well-posed mono regime, matching the bootstrap
    fixture's geometry) with Sim(3)-aligned ATE under 2% of trajectory
    length.  Monocular drifts in scale as well as pose — the scale-aligned
    bound is the convention the reference's external evaluation uses for
    mono (evo -as)."""
    cfg = _small_cfg(max_keyframes=96)
    n = 120
    step, step_x = 0.05, 0.15
    path_len = n * float(np.hypot(step, step_x))  # ~19 m
    lefts, _, gt, _ = synthetic.render_stereo_sequence(
        cfg, n_frames=n, n_points=900, seed=9, step=step, step_x=step_x,
        z_range=(3.0, 15.0)
    )
    slam = MonocularSlam(cfg, enable_loop_closing=False,
                         enable_relocalization=False)
    slam.min_init_matches = 60
    slam.min_triangulated = 40
    est, gt_used = [], []
    lost = 0
    for i in range(n):
        T = slam.process(lefts[i], timestamp=i * 0.1)
        if T is not None and slam.initialized:
            est.append(np.asarray(T))
            gt_used.append(np.asarray(gt[i]))
            lost += int(slam.lost)
    assert slam.initialized, "monocular bootstrap failed"
    assert len(est) >= 0.8 * n, f"only {len(est)}/{n} frames tracked"
    assert lost < 0.05 * len(est), f"lost {lost}/{len(est)} frames"
    ate = trajectory.ate_rmse(est, gt_used, align=True, with_scale=True)
    assert ate < 0.02 * path_len, (
        f"mono ATE {ate:.3f} m over a {path_len:.1f} m arc "
        f"(bound {0.02 * path_len:.3f} m)"
    )

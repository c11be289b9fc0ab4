"""Print the ATE of the stereo-VO synthetic fixture (tests/test_tracking.py)
for quick accuracy iteration without pytest overhead."""

import numpy as np

from opendlv_perception_vision_orbslam2_jax.models.tracking import (
    StereoVisualOdometry,
)
from opendlv_perception_vision_orbslam2_jax.utils import synthetic, trajectory
from opendlv_perception_vision_orbslam2_jax.utils.config import (
    CameraConfig,
    OrbConfig,
    SystemConfig,
)


def fixture_ate(n_frames=12, seed=5):
    cfg = SystemConfig(
        camera=CameraConfig(fx=320.0, fy=320.0, cx=256.0, cy=128.0,
                            bf=160.0, width=512, height=256, fps=10.0),
        orb=OrbConfig(n_features=600, max_keypoints=1024, n_levels=4),
    )
    lefts, rights, gt_poses, _ = synthetic.render_stereo_sequence(
        cfg, n_frames=n_frames, n_points=500, seed=seed, step=0.25
    )
    vo = StereoVisualOdometry(cfg)
    for i in range(n_frames):
        T = vo.process(lefts[i], rights[i], timestamp=i * 0.1)
        assert T is not None and not vo.lost, f"lost at frame {i}"
    return trajectory.ate_rmse(
        vo.trajectory, list(np.asarray(gt_poses)), align=False
    )


if __name__ == "__main__":
    import sys

    seeds = [int(s) for s in sys.argv[1:]] or [5]
    for s in seeds:
        print(f"seed={s}  ATE={fixture_ate(seed=s):.5f} m")

"""Config parsing parity with the reference CLI surface."""

from opendlv_perception_vision_orbslam2_jax.utils.config import (
    SystemConfig,
    config_from_flags,
    parse_flags,
)

# The reference docker-compose launch line (reference: docker-compose.yml:43).
COMPOSE_ARGV = [
    "--cid=111",
    "--name=img.argb",
    "--width=1241",
    "--height=376",
    "--bpp=24",
    "--kittiPath=/data/kitty/00",
    "--cameraType=stereo",
    "--Camera.fx=718.856",
    "--Camera.fy=718.856",
    "--Camera.cx=607.1928",
    "--Camera.cy=185.2157",
    "--Camera.fps=15",
    "--Camera.bf=386.1448",
    "--ThDepth=35",
    "--ORBextractor.nFeatures=2000",
    "--ORBextractor.scaleFactor=1.2",
    "--ORBextractor.nLevels=8",
    "--ORBextractor.iniThFAST=20",
    "--ORBextractor.minThFAST=7",
]


def test_parse_flags_key_value():
    flags = parse_flags(["--a=1", "--b", "positional", "--c=x=y"])
    assert flags == {"a": "1", "b": "1", "c": "x=y"}


def test_compose_line_round_trips():
    cfg = config_from_flags(COMPOSE_ARGV)
    assert cfg.cid == 111
    assert cfg.kitti_path == "/data/kitty/00"
    assert cfg.camera_type == "stereo"
    assert abs(cfg.camera.fx - 718.856) < 1e-9
    assert abs(cfg.camera.bf - 386.1448) < 1e-9
    assert cfg.orb.n_features == 2000
    assert cfg.orb.n_levels == 8
    assert cfg.orb.ini_th_fast == 20
    assert cfg.orb.min_th_fast == 7
    assert cfg.tracking.th_depth == 35.0
    # m_maxFrames = fps (reference: src/tracking.cpp:74-80)
    assert cfg.tracking.max_frames == 15


def test_defaults_are_kitti00():
    cfg = SystemConfig()
    assert cfg.camera.width == 1241
    assert cfg.orb.scale_factor == 1.2
    assert len(cfg.orb.scale_factors) == 8
    assert abs(cfg.camera.baseline_m - 386.1448 / 718.856) < 1e-6


def test_camera_right_inherits_left():
    cfg = config_from_flags(COMPOSE_ARGV + ["--CameraR.fx=700.0"])
    assert cfg.camera_right.fx == 700.0
    assert cfg.camera_right.fy == 718.856  # inherited from left

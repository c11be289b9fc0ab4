"""I/O layer tests: message wire format, WGS84, KITTI runner, checkpoints,
CLI flag surface."""

import os
import struct

import numpy as np
import jax.numpy as jnp
import pytest

from opendlv_perception_vision_orbslam2_jax.io import messages as msg
from opendlv_perception_vision_orbslam2_jax.io.checkpoint import load_map, save_map
from opendlv_perception_vision_orbslam2_jax.models.map_state import empty_map
from opendlv_perception_vision_orbslam2_jax.utils import wgs84


def _decode_varint(data, pos):
    shift, val = 0, 0
    while True:
        b = data[pos]
        pos += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, pos
        shift += 7


def _unzigzag(v):
    return (v >> 1) ^ -(v & 1)


def _decode_fields(data):
    """Minimal protobuf field walker for verification."""
    fields = {}
    pos = 0
    while pos < len(data):
        key, pos = _decode_varint(data, pos)
        fid, wt = key >> 3, key & 7
        if wt == 0:
            v, pos = _decode_varint(data, pos)
            fields[fid] = _unzigzag(v)
        elif wt == 5:
            fields[fid] = struct.unpack("<f", data[pos : pos + 4])[0]
            pos += 4
        elif wt == 1:
            fields[fid] = struct.unpack("<d", data[pos : pos + 8])[0]
            pos += 8
        elif wt == 2:
            ln, pos = _decode_varint(data, pos)
            fields[fid] = data[pos : pos + ln]
            pos += ln
        else:
            raise ValueError(f"wire type {wt}")
    return fields


def test_geolocation_wire_format():
    g = msg.Geolocation(latitude=57.7, longitude=11.9, altitude=12.0,
                        heading=1.57)
    fields = _decode_fields(g.encode())
    assert abs(fields[1] - 57.7) < 1e-5
    assert abs(fields[2] - 11.9) < 1e-5
    assert abs(fields[4] - 1.57) < 1e-5


def test_envelope_header_and_payload():
    g = msg.Geolocation(latitude=1.0)
    env = msg.encode_envelope(g, sender_stamp=7, timestamp=123.5)
    assert env[0] == 0x0D and env[1] == 0xA4
    length = env[2] | (env[3] << 8) | (env[4] << 16)
    body = env[5:]
    assert len(body) == length
    fields = _decode_fields(body)
    assert fields[1] == msg.Geolocation.ID   # dataType
    assert fields[6] == 7                    # senderStamp
    inner = _decode_fields(fields[2])
    assert abs(inner[1] - 1.0) < 1e-6


def test_map_chunking_contract():
    pts = [(float(i), float(i) + 0.5, float(i) * 2) for i in range(2000)]
    T = np.eye(4)
    msgs = msg.chunk_map_messages(T, pts)
    # 2000 points = 6000 coords -> ceil(6000/2500) = 3 chunks
    assert len(msgs) == 3
    assert [m.map_coordinate_index for m in msgs] == [0, 1, 2]
    coords0 = msgs[0].map_coordinates.decode().split(":")
    assert len(coords0) == (msg.CHUNK_COORDS // 3) * 3


def test_wgs84_roundtrip():
    ref = (57.70716, 11.93827)  # Gothenburg (reference's home turf)
    for xy in [(100.0, 50.0), (-250.0, 400.0), (0.0, 0.0)]:
        latlon = wgs84.from_cartesian(ref, xy)
        back = wgs84.to_cartesian(ref, latlon)
        assert abs(back[0] - xy[0]) < 0.01
        assert abs(back[1] - xy[1]) < 0.01


def test_checkpoint_roundtrip(tmp_path):
    m = empty_map(8, 128, 64)
    m = m._replace(
        pt_valid=m.pt_valid.at[3].set(True),
        pt_pos=m.pt_pos.at[3].set(jnp.array([1.0, 2.0, 3.0])),
        next_kf_id=jnp.asarray(5, jnp.int32),
    )
    path = str(tmp_path / "map.npz")
    save_map(path, m)
    m2 = load_map(path)
    assert bool(m2.pt_valid[3])
    np.testing.assert_allclose(np.asarray(m2.pt_pos[3]), [1.0, 2.0, 3.0])
    assert int(m2.next_kf_id) == 5


def test_kitti_runner_on_generated_sequence(tmp_path):
    """Generate a miniature KITTI-format directory from the synthetic world
    and run the VO engine over it through the real loader path."""
    from PIL import Image

    from opendlv_perception_vision_orbslam2_jax.io.kitti import KittiRunner
    from opendlv_perception_vision_orbslam2_jax.models.tracking import (
        StereoVisualOdometry,
    )
    from opendlv_perception_vision_orbslam2_jax.utils import synthetic
    from opendlv_perception_vision_orbslam2_jax.utils.config import (
        CameraConfig,
        OrbConfig,
        SystemConfig,
    )

    cfg = SystemConfig(
        camera=CameraConfig(fx=320.0, fy=320.0, cx=256.0, cy=128.0,
                            bf=160.0, width=512, height=256, fps=10.0),
        orb=OrbConfig(n_features=400, max_keypoints=512, n_levels=3),
    )
    n = 4
    lefts, rights, gt, _ = synthetic.render_stereo_sequence(
        cfg, n_frames=n, n_points=400, seed=2, step=0.2
    )
    os.makedirs(tmp_path / "image_0")
    os.makedirs(tmp_path / "image_1")
    with open(tmp_path / "times.txt", "w") as f:
        for i in range(n):
            f.write(f"{i * 0.1:.6f}\n")
            Image.fromarray(np.asarray(lefts[i]).astype(np.uint8), "L").save(
                tmp_path / "image_0" / f"{i:06d}.png"
            )
            Image.fromarray(np.asarray(rights[i]).astype(np.uint8), "L").save(
                tmp_path / "image_1" / f"{i:06d}.png"
            )

    vo = StereoVisualOdometry(cfg)
    runner = KittiRunner(str(tmp_path), vo)
    traj = runner.run()
    assert len(traj) == n
    stats = runner.shutdown_stats()
    assert stats["fps"] > 0


def test_cli_usage_exit():
    from opendlv_perception_vision_orbslam2_jax.__main__ import main

    assert main([]) == 1  # missing required flags -> usage


def test_native_png_decoder_if_built(tmp_path):
    from opendlv_perception_vision_orbslam2_jax.native import png_native
    from PIL import Image

    arr = np.arange(64 * 48, dtype=np.uint8).reshape(48, 64) % 251
    p = str(tmp_path / "png_test.png")
    Image.fromarray(arr, "L").save(p)
    out = png_native.decode_gray(p)
    if out is None:
        pytest.skip("native library not built")
    np.testing.assert_allclose(out, arr.astype(np.float32))


def test_cli_kitti_mode_end_to_end(tmp_path):
    """python -m ... --kittiPath on a synthetic-dumped KITTI dir must run the
    full Selflocalization pipeline and write non-empty poses/map/fps dumps
    (runKitti -> Track -> dumps, reference: src/selflocalization.cpp:65-99)."""
    from PIL import Image

    from opendlv_perception_vision_orbslam2_jax.__main__ import main
    from opendlv_perception_vision_orbslam2_jax.utils import synthetic
    from opendlv_perception_vision_orbslam2_jax.utils.config import (
        CameraConfig,
        OrbConfig,
        SystemConfig,
    )

    cfg = SystemConfig(
        camera=CameraConfig(fx=320.0, fy=320.0, cx=256.0, cy=128.0,
                            bf=160.0, width=512, height=256, fps=10.0),
        orb=OrbConfig(n_features=400, max_keypoints=512, n_levels=3),
    )
    n = 6
    lefts, rights, gt, _ = synthetic.render_stereo_sequence(
        cfg, n_frames=n, n_points=400, seed=2, step=0.2
    )
    os.makedirs(tmp_path / "image_0")
    os.makedirs(tmp_path / "image_1")
    with open(tmp_path / "times.txt", "w") as f:
        for i in range(n):
            f.write(f"{i * 0.1:.6f}\n")
            Image.fromarray(np.asarray(lefts[i]).astype(np.uint8), "L").save(
                tmp_path / "image_0" / f"{i:06d}.png"
            )
            Image.fromarray(np.asarray(rights[i]).astype(np.uint8), "L").save(
                tmp_path / "image_1" / f"{i:06d}.png"
            )

    rc = main([
        f"--kittiPath={tmp_path}",
        "--Camera.fx=320", "--Camera.fy=320", "--Camera.cx=256",
        "--Camera.cy=128", "--Camera.bf=160", "--Camera.fps=10",
        "--width=512", "--height=256",
        "--ORBextractor.nFeatures=400", "--ORBextractor.nLevels=3",
    ])
    assert rc == 0
    poses = (tmp_path / "poses.txt").read_text().strip().splitlines()
    assert len(poses) == n and len(poses[0].split()) == 12
    assert (tmp_path / "map.txt").stat().st_size > 0
    fps_lines = (tmp_path / "fps.txt").read_text().strip().splitlines()
    assert len(fps_lines) == n    # per-frame series, not empty (weak #8)

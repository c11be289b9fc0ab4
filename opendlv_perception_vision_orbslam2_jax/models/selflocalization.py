"""Selflocalization orchestrator: SLAM engine + publishing + file dumps.

Capability parity with the reference orchestrator class
(reference: src/selflocalization.cpp / include/selflocalization.hpp:43-104):
owns the SLAM engine, converts poses to ENU/WGS84 Geolocation messages
(sendPose, reference: :301-328), publishes the map in 2500-coordinate chunks
(sendMap, reference: :136-262), and writes poses.txt / map.txt / fps.txt at
shutdown (reference: :95-134).
"""

from __future__ import annotations

import math
import os
import time

import numpy as np

from ..io.messages import (
    Geolocation,
    OrbslamMap,
    PointCloudReading,
    chunk_map_messages,
)
from ..io.od4 import NullSession
from ..utils import trajectory as traj_utils
from ..utils import wgs84
from ..utils.config import SystemConfig
from .slam import StereoSlam


def pose_to_geolocation(T, ref_latitude: float, ref_longitude: float,
                        start_heading: float) -> Geolocation:
    """Camera pose [4,4] -> WGS84 Geolocation (sendPose, reference:
    src/selflocalization.cpp:301-328): rotate the camera centre into ENU by
    the start heading, then offset the WGS84 reference point."""
    T = np.asarray(T, dtype=np.float64)
    R, t = T[:3, :3], T[:3, 3]
    c = -R.T @ t  # camera centre in SLAM world (x right, y down, z fwd)
    h = start_heading
    east = c[2] * math.sin(h) + c[0] * math.cos(h)
    north = c[2] * math.cos(h) - c[0] * math.sin(h)
    lat, lon = wgs84.from_cartesian(
        (ref_latitude, ref_longitude), (east, north)
    )
    yaw = math.atan2(R[0, 2], R[2, 2])
    return Geolocation(
        latitude=lat, longitude=lon, altitude=float(-c[1]), heading=h + yaw
    )


class Selflocalization:
    def __init__(self, config: SystemConfig, od4=None, vocab=None,
                 tracking_only: bool = False):
        self.config = config
        self.od4 = od4 or NullSession()
        if config.camera_type == "mono":
            from .mono_slam import MonocularSlam
            self.slam = MonocularSlam(config, vocab=vocab)
        else:
            # tracking_only maps to the reference's localization-only mode
            # (mbOnlyTracking with the mbVO dual hypothesis,
            # reference: src/tracking.cpp:1538-1640): frozen map +
            # per-frame relocalization, NOT the map-less VO slice
            # (StereoVisualOdometry remains available for benchmarks).
            self.slam = StereoSlam(config, vocab=vocab,
                                   tracking_only=tracking_only)
        self.frame_count = 0
        self.latencies: list[float] = []
        self.map_sizes: list[int] = []

    # ------------------------------------------------------------------
    # Frame ingestion (Track, reference: src/selflocalization.cpp:533-558)
    # ------------------------------------------------------------------

    def track(self, img_left, img_right=None, timestamp: float = 0.0):
        """Mode-dispatched frame ingestion (Track, reference:
        src/selflocalization.cpp:533-558): stereo takes (L, R), RGB-D takes
        (gray, depth-map), monocular takes a single image."""
        t0 = time.time()
        mode = self.config.camera_type
        if mode == "rgbd":
            T = self.slam.process_rgbd(img_left, img_right, timestamp)
        elif mode == "mono":
            T = self.slam.process(img_left, timestamp)
        else:
            T = self.slam.process(img_left, img_right, timestamp)
        self.latencies.append(time.time() - t0)
        self.map_sizes.append(self._map_size())
        self.frame_count += 1
        self.send_pose()
        self.send_map()
        return T

    def _map_size(self) -> int:
        m = getattr(self.slam, "map", None)
        if m is None:
            return 0
        return int(np.asarray(m.pt_valid).sum())

    # ------------------------------------------------------------------
    # Publishing (sendPose/sendMap, reference: :136-328)
    # ------------------------------------------------------------------

    def send_pose(self):
        if not self.slam.trajectory:
            return
        self.od4.send(pose_to_geolocation(
            self.slam.trajectory[-1], self.config.ref_latitude,
            self.config.ref_longitude, self.config.start_heading,
        ))

    def send_map(self):
        # trajectory + full map resent every 20 frames (reference: :88-99)
        if self.frame_count % 20 != 0:
            return
        m = getattr(self.slam, "map", None)
        if m is None or not self.slam.trajectory:
            return
        pts = np.asarray(m.pt_pos)[np.asarray(m.pt_valid)]
        for msg in chunk_map_messages(
            np.asarray(self.slam.trajectory[-1]), pts.tolist()
        ):
            self.od4.send(msg)

    def send_to_webb(self) -> OrbslamMap:
        """One-shot web-visualizer message (sendToWebb, reference:
        src/selflocalization.cpp:592-636): the camera centre plus ALL map
        points as ':'-joined 4-decimal strings in a single OrbslamMap —
        the unchunked channel next to the chunked send_map."""
        cam_txt = ""
        map_txt = ""
        m = getattr(self.slam, "map", None)
        if m is not None and self.slam.trajectory:
            T = np.asarray(self.slam.trajectory[-1], dtype=np.float64)
            c = -T[:3, :3].T @ T[:3, 3]
            cam_txt = "".join(f"{v:.4f}:" for v in c)
            pts = np.asarray(m.pt_pos)[np.asarray(m.pt_valid)]
            map_txt = "".join(
                f"{x:.4f}:{y:.4f}:{z:.4f}:" for x, y, z in pts
            )
        return OrbslamMap(
            camera_coordinates=cam_txt.encode(),
            map_coordinates=map_txt.encode(),
        )

    def create_point_cloud_from_map(self) -> PointCloudReading:
        """Stub parity with CreatePointCloudFromMap (reference:
        src/selflocalization.cpp:582-590 — the reference hard-codes these
        placeholder values too)."""
        return PointCloudReading(
            start_azimuth=0.0, end_azimuth=0.0, entries_per_azimuth=12,
            distances=b"hello", number_of_bits_for_intensity=0,
        )

    # ------------------------------------------------------------------
    # Dumps (reference: :95-134 + src/tracking.cpp:1449-1536)
    # ------------------------------------------------------------------

    def write_pose_file(self, directory: str):
        traj_utils.write_pose_file(
            os.path.join(directory, "poses.txt"),
            [np.asarray(T) for T in self.slam.trajectory],
        )

    def write_map_file(self, directory: str):
        m = getattr(self.slam, "map", None)
        pts = (
            np.asarray(m.pt_pos)[np.asarray(m.pt_valid)]
            if m is not None else np.zeros((0, 3))
        )
        with open(os.path.join(directory, "map.txt"), "w") as f:
            for p in pts:
                f.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")

    def write_fps_file(self, directory: str):
        traj_utils.write_fps_file(
            os.path.join(directory, "fps.txt"), self.latencies, self.map_sizes
        )

    def shutdown(self, directory: str | None = None):
        """Settle the engine's in-flight work (the reference joins its
        mapping and loop-closing threads here, src/selflocalization.cpp:
        560-570), then write the dumps and close the OD4 session."""
        self.slam.finish()
        if directory:
            self.write_pose_file(directory)
            self.write_map_file(directory)
            self.write_fps_file(directory)
        close = getattr(self.od4, "close", None)
        if close is not None:
            close()

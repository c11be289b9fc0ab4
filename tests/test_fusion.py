"""Fusion gating tests: the stereo right-coordinate check (reference:
src/orbmatcher.cpp:903-933 uses the 3-DoF chi2 at 7.8 for stereo features)."""

import numpy as np
import jax.numpy as jnp

from opendlv_perception_vision_orbslam2_jax.models import map_state as ms
from opendlv_perception_vision_orbslam2_jax.models.fusion import fuse_into_keyframe
from tests.test_map import CAM, CFG, F, _pose, _synth_frame, _world


def _map_with_kf(seed=0):
    pts, descs = _world(seed)
    m = ms.empty_map(8, 1024, F)
    frame = _synth_frame(_pose(0.0), pts, descs, seed=seed)
    m, slot = ms.insert_keyframe(
        m, frame, -jnp.ones((F,), jnp.int32), close_depth_limit=1e9
    )
    return m, int(slot), pts, descs


def _add_candidate(m, pos, desc):
    """Insert a free-slot map point at ``pos`` with descriptor ``desc``,
    visible from the origin camera."""
    slot = int(np.argmin(np.asarray(m.pt_valid)))
    d = float(np.linalg.norm(pos))
    # normal points camera -> point; octave-0 convention: max_dist = d
    n_levels = CFG.orb.n_levels
    m = m._replace(
        pt_valid=m.pt_valid.at[slot].set(True),
        pt_pos=m.pt_pos.at[slot].set(jnp.asarray(pos, jnp.float32)),
        pt_desc=m.pt_desc.at[slot].set(jnp.asarray(desc, jnp.uint32)),
        pt_normal=m.pt_normal.at[slot].set(
            jnp.asarray(pos / d, jnp.float32)
        ),
        pt_min_dist=m.pt_min_dist.at[slot].set(
            d / CFG.orb.scale_factor ** (n_levels - 1)
        ),
        pt_max_dist=m.pt_max_dist.at[slot].set(d),
    )
    return m, slot


def test_fuse_rejects_stereo_depth_contradiction():
    """A candidate on the SAME viewing ray as a stereo feature but at 3x the
    feature's disparity depth must not bind: its predicted right-image
    coordinate contradicts the measured one."""
    m, kf, pts, descs = _map_with_kf()
    feat = 7
    ray = pts[feat] / pts[feat][2]           # unit-z ray through feature 7
    far_pos = (ray * pts[feat][2] * 3.0).astype(np.float32)

    # free feature 7 so the candidate could bind there
    m = m._replace(
        kf_obs_point=m.kf_obs_point.at[kf, feat].set(-1),
        pt_valid=m.pt_valid.at[feat].set(False),
    )
    m2, cand = _add_candidate(m, far_pos, descs[feat])
    cand_slots = jnp.full((16,), -1, jnp.int32).at[0].set(cand)
    out, _ = fuse_into_keyframe(m2, kf, cand_slots, CFG)
    assert int(out.kf_obs_point[kf, feat]) == -1, (
        "candidate bound despite contradicting the feature's own disparity"
    )


def test_fuse_binds_consistent_candidate():
    """The same candidate AT the feature's stereo depth binds fine."""
    m, kf, pts, descs = _map_with_kf()
    feat = 7
    m = m._replace(
        kf_obs_point=m.kf_obs_point.at[kf, feat].set(-1),
        pt_valid=m.pt_valid.at[feat].set(False),
    )
    m2, cand = _add_candidate(m, pts[feat], descs[feat])
    cand_slots = jnp.full((16,), -1, jnp.int32).at[0].set(cand)
    out, _ = fuse_into_keyframe(m2, kf, cand_slots, CFG)
    assert int(out.kf_obs_point[kf, feat]) == cand

"""Global map as fixed-capacity arrays (the array answer to the pointer graph).

The reference map is a heap of cross-referencing ``shared_ptr`` objects under
a mutex forest: OrbMap (reference: src/orbmap.cpp, include/orbmap.hpp:105),
OrbKeyFrame with covisibility graph + spanning tree (reference:
src/orbkeyframe.cpp:324-420, 493-600), OrbMapPoint with observation maps and
distinctive descriptors (reference: src/orbmappoint.cpp:155-220, 314-384).

Here the entire map is ONE pytree of fixed-capacity arrays with validity
masks.  Feature->point bindings are a dense ``[K, F]`` index table, which
makes every "iterate over observations" loop in the reference a masked
gather/scatter, the covisibility graph a ``[K, K]`` weight matrix (one
matmul to rebuild), and map mutation a pure function — the lock inventory of
SURVEY.md section 5 disappears.

Slot recycling: culled keyframes/points free their slots; allocation scans
the validity mask (argmin) — static shapes throughout.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops import lie
from .frame import FrameState

COVIS_THRESHOLD = 15   # edge weight gate (reference: src/orbkeyframe.cpp:369)


LOOP_EDGE_CAP = 32   # persistent loop-edge capacity


class MapState(NamedTuple):
    # --- keyframes (capacity K, feature capacity F) ---
    kf_valid: jnp.ndarray       # [K] bool
    kf_id: jnp.ndarray          # [K] int32 global keyframe id (-1 free)
    kf_T_cw: jnp.ndarray        # [K, 4, 4]
    kf_xy: jnp.ndarray          # [K, F, 2]
    kf_octave: jnp.ndarray      # [K, F] int32
    kf_angle: jnp.ndarray       # [K, F]
    kf_desc: jnp.ndarray        # [K, F, 8] uint32
    kf_uright: jnp.ndarray      # [K, F]
    kf_depth: jnp.ndarray       # [K, F]
    kf_feat_valid: jnp.ndarray  # [K, F] bool
    kf_obs_point: jnp.ndarray   # [K, F] int32 point slot or -1
    # --- points (capacity P) ---
    pt_valid: jnp.ndarray       # [P] bool
    pt_pos: jnp.ndarray         # [P, 3]
    pt_desc: jnp.ndarray        # [P, 8] uint32 distinctive descriptor
    pt_normal: jnp.ndarray      # [P, 3] mean viewing direction
    pt_min_dist: jnp.ndarray    # [P] scale-invariance band lo
    pt_max_dist: jnp.ndarray    # [P] scale-invariance band hi
    pt_ref_kf: jnp.ndarray      # [P] int32 creating keyframe slot
    pt_first_kf_id: jnp.ndarray  # [P] int32 keyframe id at creation (culling)
    pt_visible: jnp.ndarray     # [P] int32 times predicted visible
    pt_found: jnp.ndarray       # [P] int32 times actually matched
    # --- graph ---
    covis: jnp.ndarray          # [K, K] int32 shared-point counts
    # --- counters ---
    next_kf_id: jnp.ndarray     # [] int32
    next_pt_id: jnp.ndarray     # [] int32 (ids only for bookkeeping)
    # --- persistent loop edges (capacity L) ---
    # The reference keeps accepted loop edges on keyframes forever and feeds
    # them into every later essential-graph solve (reference:
    # src/orbkeyframe.cpp:458-470, src/orboptimizer.cpp:875-914); here they
    # are a small global edge list: (cur_slot, cand_slot, S_rel) with
    # S_rel = Sim3 mapping cand-camera coords into cur-camera coords.
    loop_i: jnp.ndarray = None        # [L] int32 current-KF slot
    loop_j: jnp.ndarray = None        # [L] int32 matched-KF slot
    loop_T: jnp.ndarray = None        # [L, 4, 4] SE3 part of S_rel
    loop_s: jnp.ndarray = None        # [L] scale of S_rel
    loop_valid: jnp.ndarray = None    # [L] bool

    @property
    def kf_capacity(self) -> int:
        return self.kf_valid.shape[0]

    @property
    def pt_capacity(self) -> int:
        return self.pt_valid.shape[0]

    @property
    def feat_capacity(self) -> int:
        return self.kf_xy.shape[1]


def empty_map(kf_capacity: int, pt_capacity: int, feat_capacity: int) -> MapState:
    K, P, F = kf_capacity, pt_capacity, feat_capacity
    return MapState(
        kf_valid=jnp.zeros((K,), bool),
        kf_id=-jnp.ones((K,), jnp.int32),
        kf_T_cw=jnp.tile(jnp.eye(4, dtype=jnp.float32), (K, 1, 1)),
        kf_xy=jnp.zeros((K, F, 2), jnp.float32),
        kf_octave=jnp.zeros((K, F), jnp.int32),
        kf_angle=jnp.zeros((K, F), jnp.float32),
        kf_desc=jnp.zeros((K, F, 8), jnp.uint32),
        kf_uright=-jnp.ones((K, F), jnp.float32),
        kf_depth=-jnp.ones((K, F), jnp.float32),
        kf_feat_valid=jnp.zeros((K, F), bool),
        kf_obs_point=-jnp.ones((K, F), jnp.int32),
        pt_valid=jnp.zeros((P,), bool),
        pt_pos=jnp.zeros((P, 3), jnp.float32),
        pt_desc=jnp.zeros((P, 8), jnp.uint32),
        pt_normal=jnp.zeros((P, 3), jnp.float32),
        pt_min_dist=jnp.zeros((P,), jnp.float32),
        pt_max_dist=jnp.full((P,), 1e9, jnp.float32),
        pt_ref_kf=-jnp.ones((P,), jnp.int32),
        pt_first_kf_id=-jnp.ones((P,), jnp.int32),
        pt_visible=jnp.ones((P,), jnp.int32),
        pt_found=jnp.ones((P,), jnp.int32),
        covis=jnp.zeros((K, K), jnp.int32),
        next_kf_id=jnp.asarray(0, jnp.int32),
        next_pt_id=jnp.asarray(0, jnp.int32),
        loop_i=jnp.zeros((LOOP_EDGE_CAP,), jnp.int32),
        loop_j=jnp.zeros((LOOP_EDGE_CAP,), jnp.int32),
        loop_T=jnp.tile(jnp.eye(4, dtype=jnp.float32), (LOOP_EDGE_CAP, 1, 1)),
        loop_s=jnp.ones((LOOP_EDGE_CAP,), jnp.float32),
        loop_valid=jnp.zeros((LOOP_EDGE_CAP,), bool),
    )


@functools.partial(jax.jit, static_argnames=("new_kf_capacity",
                                              "new_pt_capacity"))
def grow_map(m: MapState, new_kf_capacity: int,
             new_pt_capacity: int) -> MapState:
    """Grow the map to larger static capacities by padding (slot indices are
    preserved, so every binding/covis entry stays valid).

    Capacity bucketing: the reference's heap map grows per
    allocation (no reference analogue for fixed capacity at all); with XLA's
    static shapes the equivalent is a small ladder of compiled buckets —
    every [P]-scatter, [K,P] incidence build and [K,K] Gram in the per-frame
    programs then scales with the actual map size instead of the worst case.
    The host scheduler calls this when occupancy nears the current bucket.

    The old reserved dump slots (old P-1 / padded rows) become ordinary free
    slots: they are invalid (``pt_valid``/``kf_valid`` False) and every field
    is rewritten at allocation time, so stale contents are unreachable.
    """
    K_old, P_old, F = m.kf_capacity, m.pt_capacity, m.feat_capacity
    K, P = new_kf_capacity, new_pt_capacity
    dK, dP = K - K_old, P - P_old
    assert dK >= 0 and dP >= 0

    def pad(arr, n_new, fill=0):
        pads = [(0, n_new - arr.shape[0])] + [(0, 0)] * (arr.ndim - 1)
        return jnp.pad(arr, pads, constant_values=fill)

    eye_k = jnp.tile(jnp.eye(4, dtype=jnp.float32), (dK, 1, 1))
    return MapState(
        kf_valid=pad(m.kf_valid, K),
        kf_id=pad(m.kf_id, K, -1),
        kf_T_cw=jnp.concatenate([m.kf_T_cw, eye_k], axis=0),
        kf_xy=pad(m.kf_xy, K),
        kf_octave=pad(m.kf_octave, K),
        kf_angle=pad(m.kf_angle, K),
        kf_desc=pad(m.kf_desc, K),
        kf_uright=pad(m.kf_uright, K, -1),
        kf_depth=pad(m.kf_depth, K, -1),
        kf_feat_valid=pad(m.kf_feat_valid, K),
        kf_obs_point=pad(m.kf_obs_point, K, -1),
        pt_valid=pad(m.pt_valid, P),
        pt_pos=pad(m.pt_pos, P),
        pt_desc=pad(m.pt_desc, P),
        pt_normal=pad(m.pt_normal, P),
        pt_min_dist=pad(m.pt_min_dist, P),
        pt_max_dist=pad(m.pt_max_dist, P, 1e9),
        pt_ref_kf=pad(m.pt_ref_kf, P, -1),
        pt_first_kf_id=pad(m.pt_first_kf_id, P, -1),
        pt_visible=pad(m.pt_visible, P, 1),
        pt_found=pad(m.pt_found, P, 1),
        covis=jnp.pad(m.covis, ((0, dK), (0, dK))),
        next_kf_id=m.next_kf_id,
        next_pt_id=m.next_pt_id,
        loop_i=m.loop_i,
        loop_j=m.loop_j,
        loop_T=m.loop_T,
        loop_s=m.loop_s,
        loop_valid=m.loop_valid,
    )


@jax.jit
def add_loop_edge(m: MapState, cur_slot, cand_slot, T_rel, s_rel) -> MapState:
    """Record an accepted loop edge (AddLoopEdge, reference:
    src/orbkeyframe.cpp:458-470) in the first free slot; silently drops when
    the edge list is full (oldest edges matter most and stay)."""
    slot = jnp.argmin(m.loop_valid.astype(jnp.int32))
    free = ~m.loop_valid[slot]
    return m._replace(
        loop_i=m.loop_i.at[slot].set(jnp.where(free, cur_slot, m.loop_i[slot])),
        loop_j=m.loop_j.at[slot].set(jnp.where(free, cand_slot, m.loop_j[slot])),
        loop_T=m.loop_T.at[slot].set(jnp.where(free, T_rel, m.loop_T[slot])),
        loop_s=m.loop_s.at[slot].set(jnp.where(free, s_rel, m.loop_s[slot])),
        loop_valid=m.loop_valid.at[slot].set(True),
    )


# ---------------------------------------------------------------------------
# Covisibility
# ---------------------------------------------------------------------------


def incidence_matrix(m: MapState, dtype=jnp.bfloat16) -> jnp.ndarray:
    """[K, P] 0/1 keyframe-observes-point incidence (scatter-built)."""
    K, F, P = m.kf_capacity, m.feat_capacity, m.pt_capacity
    bound = m.kf_feat_valid & (m.kf_obs_point >= 0) & m.kf_valid[:, None]
    binds = jnp.where(bound, m.kf_obs_point, P)   # dump column P
    rows = jax.lax.broadcasted_iota(jnp.int32, (K, F), 0)
    inc = jnp.zeros((K, P + 1), dtype).at[rows, binds].add(1)
    return jnp.minimum(inc[:, :P], 1)


def recompute_covisibility(m: MapState) -> jnp.ndarray:
    """[K, K] shared-point counts via incidence Gram matrix — replaces
    UpdateConnections' per-KF counting loops (reference:
    src/orbkeyframe.cpp:324-420).  One matmul does the whole graph
    (0/1 entries: bf16 products are exact)."""
    inc = incidence_matrix(m)
    w = jax.lax.dot_general(
        inc, inc,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
    ).astype(jnp.int32)
    w = jnp.where(jnp.eye(w.shape[0], dtype=bool), 0, w)
    kmask = m.kf_valid
    return jnp.where(kmask[:, None] & kmask[None, :], w, 0)


@jax.jit
def covis_update_row(m: MapState, kf_slot) -> MapState:
    """Refresh ONE keyframe's covisibility row/column in place.

    After inserting keyframe ``kf_slot`` only its own row changes; the full
    rebuild scatters a [K, P] incidence (67 MB at KITTI capacities) and runs
    the Gram matmul, while this touches only [K, F+1].

    Shared points are counted DISTINCTLY: a keyframe can legitimately bind
    the same point at several features after fusion merges rewrite losers to
    winners across the whole binding table, and the Gram dedups those via
    ``min(inc, 1)`` — a plain per-feature row sum over-counts (which
    inflated covisibility weights and silently degraded window/neighbour
    selection everywhere downstream)."""
    P, F = m.pt_capacity, m.feat_capacity
    K = m.kf_capacity
    bound = m.kf_feat_valid & (m.kf_obs_point >= 0) & m.kf_valid[:, None]
    row_binds = m.kf_obs_point[kf_slot]
    row_bound = bound[kf_slot]
    # one local index per DISTINCT point of the new row (min feature wins)
    g2l = jnp.full((P,), F, jnp.int32).at[
        jnp.where(row_bound, row_binds, P - 1)
    ].min(jnp.where(row_bound, jnp.arange(F, dtype=jnp.int32), F))
    g2l = g2l.at[P - 1].set(F)
    loc = jnp.where(
        bound, jnp.take(g2l, jnp.clip(m.kf_obs_point, 0, P - 1)), F
    )                                                          # [K, F]
    rows = jax.lax.broadcasted_iota(jnp.int32, (K, F), 0)
    seen = jnp.zeros((K, F + 1), bool).at[rows, loc].set(True)
    w = jnp.sum(seen[:, :F], axis=1).astype(m.covis.dtype)     # [K]
    w = w.at[kf_slot].set(0)
    w = jnp.where(m.kf_valid & m.kf_valid[kf_slot], w, 0)
    covis = m.covis.at[kf_slot, :].set(w).at[:, kf_slot].set(w)
    return m._replace(covis=covis)


def covisible_neighbors(m: MapState, kf_slot, n_best: int):
    """Top-``n_best`` covisible keyframe slots of ``kf_slot`` by weight
    (GetBestCovisibilityKeyFrames, reference: src/orbkeyframe.cpp:234-249)."""
    w = m.covis[kf_slot]
    vals, idx = jax.lax.top_k(w, n_best)
    return idx, vals


# ---------------------------------------------------------------------------
# Keyframe insertion + stereo point creation
# ---------------------------------------------------------------------------


def _alloc_slot(valid_mask):
    """First free slot (argmin of validity); callers must check capacity."""
    return jnp.argmin(valid_mask.astype(jnp.int32))


def _alloc_point_slots(pt_valid, want_mask):
    """Allocate up to ``W=len(want_mask)`` free point slots.

    Returns ``slots [W]`` (unique free slots for each wanted entry; -1 if out
    of capacity or not wanted).  Static-shape trick: rank wanted entries,
    rank free slots, pair rank-i want with rank-i free slot.
    """
    P = pt_valid.shape[0]
    # slot P-1 is reserved as the scatter dump slot, never allocated
    allocatable = ~pt_valid.at[P - 1].set(True)
    free_order = jnp.argsort(~allocatable)                    # free slots first
    n_free = jnp.sum(allocatable)
    want_rank = jnp.cumsum(want_mask.astype(jnp.int32)) - 1   # rank among wanted
    ok = want_mask & (want_rank < n_free)
    slots = jnp.take(free_order, jnp.clip(want_rank, 0, P - 1))
    return jnp.where(ok, slots, -1)


@functools.partial(jax.jit, static_argnames=("covis_mode",))
def insert_keyframe(m: MapState, frame: FrameState, tracked_point_slot,
                    close_depth_limit, min_total_points=100,
                    covis_mode: str = "full"):
    """Insert a frame as a keyframe; create map points from stereo depth.

    Array analogue of Tracking::CreateNewKeyFrame (reference:
    src/tracking.cpp:898-976): features whose tracking bound them to an
    existing point keep that binding; unbound features with valid depth
    create new points — all "close" ones (depth < close_depth_limit) plus the
    nearest beyond, until at least ``min_total_points`` exist (the
    depth-sorted >=100 rule, reference: src/tracking.cpp:930-969).

    ``tracked_point_slot [F]``: existing point slot per feature (-1 none).
    Returns ``(new_map, kf_slot)``.
    """
    F = m.feat_capacity
    feats = frame.features
    kf_slot = _alloc_slot(m.kf_valid)

    # --- choose which features spawn new points -------------------------
    has_depth = (feats.depth > 0) & feats.valid
    unbound = has_depth & (tracked_point_slot < 0)
    depth_key = jnp.where(unbound, feats.depth, jnp.inf)
    order_rank = jnp.zeros((F,), jnp.int32).at[jnp.argsort(depth_key)].set(
        jnp.arange(F, dtype=jnp.int32)
    )
    want_new = unbound & (
        (feats.depth < close_depth_limit) | (order_rank < min_total_points)
    )

    new_slots = _alloc_point_slots(m.pt_valid, want_new)
    created = new_slots >= 0

    # --- world positions / attributes of the new points ------------------
    T_wc = lie.inv_T(frame.T_cw)
    p_w = lie.transform_points(T_wc[None], frame.point_cam[None])[0]
    cam_center = T_wc[:3, 3]
    view = p_w - cam_center
    dist = jnp.linalg.norm(view, axis=-1) + 1e-9
    normal = view / dist[:, None]
    # scale band (reference: src/orbmappoint.cpp:394-431)
    scale = jnp.power(1.2, feats.octave.astype(jnp.float32))
    max_dist = dist * scale
    min_dist = max_dist / jnp.power(1.2, 7.0)

    safe = jnp.where(created, new_slots, m.pt_capacity - 1)

    def upd(arr, vals):
        mask = created.reshape((-1,) + (1,) * (vals.ndim - 1))
        return arr.at[safe].set(jnp.where(mask, vals, arr[safe]))

    m = m._replace(
        pt_valid=m.pt_valid.at[safe].set(created | m.pt_valid[safe]),
        pt_pos=upd(m.pt_pos, p_w),
        pt_desc=upd(m.pt_desc, feats.desc),
        pt_normal=upd(m.pt_normal, normal),
        pt_min_dist=upd(m.pt_min_dist, min_dist),
        pt_max_dist=upd(m.pt_max_dist, max_dist),
        pt_ref_kf=upd(m.pt_ref_kf, jnp.full((F,), 0, jnp.int32) + kf_slot),
        pt_first_kf_id=upd(
            m.pt_first_kf_id, jnp.full((F,), 0, jnp.int32) + m.next_kf_id
        ),
        pt_visible=upd(m.pt_visible, jnp.ones((F,), jnp.int32)),
        pt_found=upd(m.pt_found, jnp.ones((F,), jnp.int32)),
    )

    bindings = jnp.where(created, new_slots, tracked_point_slot)

    # --- write the keyframe ----------------------------------------------
    m = m._replace(
        kf_valid=m.kf_valid.at[kf_slot].set(True),
        kf_id=m.kf_id.at[kf_slot].set(m.next_kf_id),
        kf_T_cw=m.kf_T_cw.at[kf_slot].set(frame.T_cw),
        kf_xy=m.kf_xy.at[kf_slot].set(feats.xy),
        kf_octave=m.kf_octave.at[kf_slot].set(feats.octave),
        kf_angle=m.kf_angle.at[kf_slot].set(feats.angle),
        kf_desc=m.kf_desc.at[kf_slot].set(feats.desc),
        kf_uright=m.kf_uright.at[kf_slot].set(feats.u_right),
        kf_depth=m.kf_depth.at[kf_slot].set(feats.depth),
        kf_feat_valid=m.kf_feat_valid.at[kf_slot].set(feats.valid),
        kf_obs_point=m.kf_obs_point.at[kf_slot].set(bindings),
        next_kf_id=m.next_kf_id + 1,
    )
    if covis_mode == "row":
        # only the inserted keyframe's row changed (new points have no other
        # observers yet) — O(K*F) gather instead of the full Gram rebuild
        m = covis_update_row(m, kf_slot)
    else:
        m = m._replace(covis=recompute_covisibility(m))
    return m, kf_slot


# ---------------------------------------------------------------------------
# Point statistics refresh
# ---------------------------------------------------------------------------


@jax.jit
def refresh_point_stats(m: MapState) -> MapState:
    """Recompute observation counts, mean viewing normals and scale bands
    from current bindings (UpdateMeanAndDepthValues, reference:
    src/orbmappoint.cpp:394-431) — one masked scatter over all [K, F] slots."""
    P = m.pt_capacity
    bound = m.kf_feat_valid & (m.kf_obs_point >= 0) & m.kf_valid[:, None]
    tgt = jnp.where(bound, m.kf_obs_point, P - 1)

    obs_count = jnp.zeros((P,), jnp.int32).at[tgt].add(bound.astype(jnp.int32))

    cam_centers = -jnp.einsum(
        "kji,kj->ki", m.kf_T_cw[:, :3, :3], m.kf_T_cw[:, :3, 3]
    )  # [K, 3]
    view = m.pt_pos[tgt] - cam_centers[:, None, :]
    nrm = view / (jnp.linalg.norm(view, axis=-1, keepdims=True) + 1e-9)
    normal_sum = jnp.zeros((P, 3), jnp.float32).at[tgt].add(
        jnp.where(bound[..., None], nrm, 0.0)
    )
    normals = normal_sum / jnp.maximum(obs_count, 1)[:, None]
    m = m._replace(
        pt_normal=jnp.where((obs_count > 0)[:, None], normals, m.pt_normal)
    )
    return m


def point_observation_counts(m: MapState) -> jnp.ndarray:
    """Observations per point slot.  Slot P-1 is the reserved dump slot
    (never allocated), so masked writes land there harmlessly."""
    P = m.pt_capacity
    bound = m.kf_feat_valid & (m.kf_obs_point >= 0) & m.kf_valid[:, None]
    tgt = jnp.where(bound, m.kf_obs_point, P - 1)
    counts = jnp.zeros((P,), jnp.int32).at[tgt].add(bound.astype(jnp.int32))
    return counts.at[P - 1].set(0)


OBS_DESC_CAP = 16  # observation descriptors considered per point


@jax.jit
def refresh_distinctive_descriptors(m: MapState) -> MapState:
    """Min-median-Hamming distinctive descriptor per point.

    Exact semantics of OrbMapPoint::ComputeDistinctiveDescriptors
    (reference: src/orbmappoint.cpp:314-384): among a point's observation
    descriptors, keep the one whose median distance to the others is
    smallest.  Array form: gather up to OBS_DESC_CAP observation descriptors
    per point by sorting the flat binding list, then one batched pairwise
    Hamming + median + argmin over [P, CAP, CAP].
    """
    K, F, P = m.kf_capacity, m.feat_capacity, m.pt_capacity
    bound = m.kf_feat_valid & (m.kf_obs_point >= 0) & m.kf_valid[:, None]
    flat_pt = jnp.where(bound, m.kf_obs_point, P).reshape(-1)   # [K*F]
    flat_desc = m.kf_desc.reshape(-1, 8)

    order = jnp.argsort(flat_pt)
    sorted_pt = flat_pt[order]
    sorted_desc = flat_desc[order]
    # rank within each point's run
    seg_start = jnp.searchsorted(sorted_pt, sorted_pt, side="left")
    rank = jnp.arange(sorted_pt.shape[0]) - seg_start
    ok = (sorted_pt < P) & (rank < OBS_DESC_CAP)
    tgt_p = jnp.where(ok, sorted_pt, P - 1)
    tgt_r = jnp.where(ok, rank, OBS_DESC_CAP - 1)

    table = jnp.zeros((P, OBS_DESC_CAP, 8), jnp.uint32).at[tgt_p, tgt_r].set(
        jnp.where(ok[:, None], sorted_desc, 0)
    )
    slot_valid = jnp.zeros((P, OBS_DESC_CAP), bool).at[tgt_p, tgt_r].set(ok)
    slot_valid = slot_valid.at[P - 1].set(False)

    x = jax.lax.population_count(table[:, :, None, :] ^ table[:, None, :, :])
    dist = jnp.sum(x, axis=-1).astype(jnp.int32)               # [P, C, C]
    big = 257
    dist = jnp.where(
        slot_valid[:, :, None] & slot_valid[:, None, :], dist, big
    )
    # median over valid columns per row (invalid entries sorted to the end)
    n_valid = jnp.sum(slot_valid, axis=1)                      # [P]
    dist_sorted = jnp.sort(dist, axis=2)
    med_pos = jnp.clip((n_valid - 1) // 2, 0, OBS_DESC_CAP - 1)  # [P]
    median = jnp.take_along_axis(
        dist_sorted,
        jnp.broadcast_to(med_pos[:, None, None], (P, OBS_DESC_CAP, 1)),
        axis=2,
    )[:, :, 0]                                                 # [P, C]
    median = jnp.where(slot_valid, median, big)
    best = jnp.argmin(median, axis=1)                          # [P]
    new_desc = table[jnp.arange(P), best]                      # [P, 8]
    has_obs = n_valid > 0
    return m._replace(
        pt_desc=jnp.where(has_obs[:, None], new_desc, m.pt_desc)
    )


@jax.jit
def refresh_windowed(m: MapState, pt_slots, kf_slots) -> MapState:
    """Windowed refresh of distinctive descriptors + normals after local BA.

    Recomputes ONLY the points in ``pt_slots`` ([PL], -1 pad) from their
    observations in the ``kf_slots`` keyframes ([KW], may repeat/-1 pad) —
    the local-BA window, whose fixed observers are by construction the
    keyframes seeing most of these points.  The full-map refresh sorts all
    [K*F] binding slots (a ~1M-element argsort at KITTI capacities); the
    window is [KW*F] ~ 32k.  Observations from keyframes
    outside the window are ignored for the recompute — a documented
    approximation of the reference's per-point full-observation refresh
    (src/orbmappoint.cpp:314-431), bounded by the fixed-observer selection.
    """
    P = m.pt_capacity
    PL = pt_slots.shape[0]
    F = m.feat_capacity

    p_ok = pt_slots >= 0
    safe_pt = jnp.clip(pt_slots, 0, P - 1)
    g2l = jnp.full((P,), PL, jnp.int32).at[
        jnp.where(p_ok, safe_pt, P - 1)
    ].set(jnp.where(p_ok, jnp.arange(PL, dtype=jnp.int32), PL))

    k_ok = kf_slots >= 0
    safe_kf = jnp.clip(kf_slots, 0, m.kf_capacity - 1)
    binds = m.kf_obs_point[safe_kf]                            # [KW, F]
    bound = (
        m.kf_feat_valid[safe_kf] & (binds >= 0)
        & k_ok[:, None] & m.kf_valid[safe_kf][:, None]
    )
    loc = jnp.where(bound, g2l[jnp.clip(binds, 0, P - 1)], PL)  # [KW, F]

    # --- distinctive descriptors over the window observations -----------
    flat_pt = loc.reshape(-1)
    flat_desc = m.kf_desc[safe_kf].reshape(-1, 8)
    order = jnp.argsort(flat_pt)
    sorted_pt = flat_pt[order]
    sorted_desc = flat_desc[order]
    seg_start = jnp.searchsorted(sorted_pt, sorted_pt, side="left")
    rank = jnp.arange(sorted_pt.shape[0]) - seg_start
    ok = (sorted_pt < PL) & (rank < OBS_DESC_CAP)
    tgt_p = jnp.where(ok, sorted_pt, PL)
    tgt_r = jnp.where(ok, rank, OBS_DESC_CAP - 1)

    table = jnp.zeros((PL + 1, OBS_DESC_CAP, 8), jnp.uint32).at[
        tgt_p, tgt_r
    ].set(jnp.where(ok[:, None], sorted_desc, 0))[:PL]
    slot_valid = jnp.zeros((PL + 1, OBS_DESC_CAP), bool).at[
        tgt_p, tgt_r
    ].set(ok)[:PL]

    x = jax.lax.population_count(table[:, :, None, :] ^ table[:, None, :, :])
    dist = jnp.sum(x, axis=-1).astype(jnp.int32)               # [PL, C, C]
    big = 257
    dist = jnp.where(
        slot_valid[:, :, None] & slot_valid[:, None, :], dist, big
    )
    n_valid = jnp.sum(slot_valid, axis=1)
    dist_sorted = jnp.sort(dist, axis=2)
    med_pos = jnp.clip((n_valid - 1) // 2, 0, OBS_DESC_CAP - 1)
    median = jnp.take_along_axis(
        dist_sorted,
        jnp.broadcast_to(med_pos[:, None, None], (PL, OBS_DESC_CAP, 1)),
        axis=2,
    )[:, :, 0]
    median = jnp.where(slot_valid, median, big)
    best = jnp.argmin(median, axis=1)
    new_desc = table[jnp.arange(PL), best]                     # [PL, 8]

    # --- normals from the window observations ----------------------------
    cam_centers = -jnp.einsum(
        "kji,kj->ki",
        m.kf_T_cw[safe_kf][:, :3, :3], m.kf_T_cw[safe_kf][:, :3, 3],
    )                                                          # [KW, 3]
    view = m.pt_pos[jnp.clip(binds, 0, P - 1)] - cam_centers[:, None, :]
    nrm = view / (jnp.linalg.norm(view, axis=-1, keepdims=True) + 1e-9)
    flat_loc = jnp.where(bound, loc, PL).reshape(-1)
    normal_sum = jnp.zeros((PL + 1, 3), jnp.float32).at[flat_loc].add(
        jnp.where(bound[..., None], nrm, 0.0).reshape(-1, 3)
    )[:PL]
    obs_count = jnp.zeros((PL + 1,), jnp.int32).at[flat_loc].add(
        bound.astype(jnp.int32).reshape(-1)
    )[:PL]
    normals = normal_sum / jnp.maximum(obs_count, 1)[:, None]

    # --- scatter back -----------------------------------------------------
    write = p_ok & (obs_count > 0)
    w_tgt = jnp.where(write, safe_pt, P - 1)
    pt_desc = m.pt_desc.at[w_tgt].set(
        jnp.where(write[:, None], new_desc, m.pt_desc[w_tgt])
    )
    pt_normal = m.pt_normal.at[w_tgt].set(
        jnp.where(write[:, None], normals, m.pt_normal[w_tgt])
    )
    return m._replace(pt_desc=pt_desc, pt_normal=pt_normal)


# ---------------------------------------------------------------------------
# Culling
# ---------------------------------------------------------------------------


def reassign_point_refs(m: MapState, kill_orphans: bool = True) -> MapState:
    """Re-anchor points whose reference keyframe died.

    The reference re-parents in OrbKeyFrame::SetBadFlag (reference:
    src/orbkeyframe.cpp:493-600) and OrbMapPoint::EraseObservation promotes
    the first remaining observer to mpRefKF.  Array form: one scatter over
    the [K, F] binding table finds each point's oldest surviving observer;
    points with a dead/dangling ``pt_ref_kf`` adopt it.  Without this, a
    recycled slot would silently apply the WRONG keyframe's correction to
    its orphaned points in correct_loop / GBA merge.

    ``kill_orphans``: with True (redundancy CULLING — the reference erases
    such points' observations and kills low-observation points,
    src/orbmappoint.cpp:222-239) points left with NO observer are retired.
    With False (capacity EVICTION — no reference analogue; the evicted
    keyframes were NOT redundant) orphaned points survive, re-anchored to
    the TEMPORALLY nearest surviving keyframe: they are what later loop
    closures and relocalization recognize when the camera revisits a
    region whose keyframes fell to capacity churn.
    """
    K, F, P = m.kf_capacity, m.feat_capacity, m.pt_capacity
    bound = m.kf_feat_valid & (m.kf_obs_point >= 0) & m.kf_valid[:, None]
    tgt = jnp.where(bound, m.kf_obs_point, P - 1)
    big = jnp.iinfo(jnp.int32).max
    # oldest observer by keyframe id; encode (id, slot) to recover the slot
    enc = jnp.where(
        bound, m.kf_id[:, None] * K + jnp.arange(K, dtype=jnp.int32)[:, None],
        big,
    )
    best = jnp.full((P,), big, jnp.int32).at[tgt].min(enc)
    has_obs = best < big
    rep = jnp.where(has_obs, best % K, -1)

    safe_ref = jnp.clip(m.pt_ref_kf, 0, K - 1)
    ref_dead = (m.pt_ref_kf < 0) | (~m.kf_valid[safe_ref])
    if kill_orphans:
        new_ref = jnp.where(ref_dead, rep, m.pt_ref_kf)
        # only points orphaned by THIS cull die (dangling ref + no
        # observer); eviction survivors carry a valid re-anchored ref and
        # are exempt
        orphan = m.pt_valid & ~has_obs & ref_dead
        return m._replace(
            pt_ref_kf=new_ref,
            pt_valid=m.pt_valid & ~orphan,
        )
    # eviction path: orphans fall back to the temporally nearest valid
    # keyframe (creation-id proximity tracks trajectory proximity, the same
    # heuristic as the reference's spanning-tree correction propagation)
    ids = jnp.where(m.kf_valid, m.kf_id, big)
    order = jnp.argsort(ids)
    sorted_ids = ids[order]
    n_valid = jnp.sum(m.kf_valid)
    pos = jnp.searchsorted(sorted_ids, m.pt_first_kf_id)
    lo = jnp.clip(pos - 1, 0, K - 1)
    hi = jnp.clip(jnp.minimum(pos, n_valid - 1), 0, K - 1)
    d_lo = jnp.abs(m.pt_first_kf_id - sorted_ids[lo])
    d_hi = jnp.abs(sorted_ids[hi] - m.pt_first_kf_id)
    near = jnp.where(d_lo <= d_hi, order[lo], order[hi])
    fallback = jnp.where(has_obs, rep, near)
    return m._replace(
        pt_ref_kf=jnp.where(ref_dead, fallback, m.pt_ref_kf)
    )


@functools.partial(jax.jit, static_argnames=("min_free",))
def evict_oldest_if_full(m: MapState, min_free: int = 1) -> MapState:
    """Slot-recycling backstop for the fixed keyframe capacity (no reference
    analogue — its heap map grows unboundedly, SURVEY.md section 7 hard-part
    2): when fewer than ``min_free`` slots are free, retire the
    second-oldest keyframe (the absolute oldest stays as the gauge anchor),
    unbinding its observations.  Normal operation rarely reaches this;
    KeyFrameCulling usually frees slots first."""
    full = jnp.sum(m.kf_valid) > m.kf_capacity - min_free
    ids = jnp.where(m.kf_valid, m.kf_id, jnp.iinfo(jnp.int32).max)
    # never evict loop-closure anchors: their edges feed every later
    # essential-graph solve (persistent loop edges)
    protected = jnp.zeros((m.kf_capacity,), bool)
    protected = protected.at[m.loop_i].max(m.loop_valid)
    protected = protected.at[m.loop_j].max(m.loop_valid)
    ids = jnp.where(protected, jnp.iinfo(jnp.int32).max, ids)
    oldest = jnp.argmin(ids)
    ids2 = ids.at[oldest].set(jnp.iinfo(jnp.int32).max)
    victim = jnp.argmin(ids2)
    kf_valid = m.kf_valid.at[victim].set(
        jnp.where(full, False, m.kf_valid[victim])
    )
    cleared = jnp.where(
        full, -jnp.ones((m.feat_capacity,), jnp.int32), m.kf_obs_point[victim]
    )
    m = m._replace(
        kf_valid=kf_valid,
        kf_obs_point=m.kf_obs_point.at[victim].set(cleared),
    )
    # capacity eviction keeps the victim's points alive (see
    # reassign_point_refs): they are the region's memory for loop closure /
    # relocalization after the keyframes churn out
    m = reassign_point_refs(m, kill_orphans=False)
    return m._replace(covis=recompute_covisibility(m))


@functools.partial(jax.jit, static_argnames=("th_obs",))
def cull_points(m: MapState, current_kf_id, th_obs: int = 3, counts=None):
    """MapPointCulling (reference: src/mapping.cpp:527-562): recently created
    points must keep a found/visible ratio > 0.25 and gather > ``th_obs``
    observations (3 stereo / 2 mono) within 2 keyframes of creation, else
    they are deleted.  Counts grow via keyframe bindings + fusion
    (models/fusion.py), exactly like the reference's Fuse pass.

    ``counts``: optional precomputed observation counts.  When given, the
    full [K*F] recount is skipped and ``(m, counts)`` is returned with the
    killed points zeroed — the fused keyframe stage threads one counts
    array through all its passes."""
    obs = point_observation_counts(m) if counts is None else counts
    age = current_kf_id - m.pt_first_kf_id
    ratio = m.pt_found.astype(jnp.float32) / jnp.maximum(m.pt_visible, 1)
    bad = (ratio < 0.25) | ((age >= 2) & (obs <= th_obs))
    recent = age <= 3
    kill = m.pt_valid & recent & bad
    new_valid = m.pt_valid & (~kill)
    # unbind every observation of killed points
    killed_of = jnp.where(m.kf_obs_point >= 0, kill[m.kf_obs_point], False)
    m = m._replace(
        pt_valid=new_valid,
        kf_obs_point=jnp.where(killed_of, -1, m.kf_obs_point),
    )
    if counts is None:
        return m
    return m, jnp.where(kill, 0, counts)


@functools.partial(jax.jit, static_argnames=("update_covis",))
def cull_keyframes(m: MapState, protect_slot,
                   update_covis: bool = True, counts=None) -> MapState:
    """KeyFrameCulling (reference: src/mapping.cpp:646-710): a keyframe whose
    tracked points are >=90% observed by >=3 OTHER keyframes at the same or
    finer scale is redundant.

    The scale comparison is per observation like the reference
    (``pKFi->octave <= scaleLevel + 1``, src/mapping.cpp:677-693), computed
    as a per-point OCTAVE HISTOGRAM: one [K,F]->[P,L] scatter + cumsum, then
    each binding reads how many observers sit at octave <= its own + 1.
    The round-3 total-count approximation over-culled badly: with dense
    keyframe cadence, consecutive frontier keyframes looked mutually
    redundant, got serially culled, and orphaned the newest map region.

    ``update_covis=False`` skips the tail covisibility rebuild — callers
    chaining several map passes per keyframe rebuild once at the end.
    ``counts`` is accepted for API compatibility (the octave histogram
    replaces it for the redundancy test).
    """
    P = m.pt_capacity
    L = 8  # octave-level capacity (n_levels <= 8 at every config)
    bound = m.kf_feat_valid & (m.kf_obs_point >= 0) & m.kf_valid[:, None]
    binds = jnp.clip(m.kf_obs_point, 0, P - 1)
    oct_c = jnp.clip(m.kf_octave, 0, L - 1)
    # per-point observer count at each octave: [P, L]
    tgt_p = jnp.where(bound, binds, P - 1)
    hist = jnp.zeros((P, L), jnp.int32).at[tgt_p, oct_c].add(
        bound.astype(jnp.int32)
    )
    cum = jnp.cumsum(hist, axis=1)                   # observers at oct <= l
    # per binding: OTHER observers at octave <= own + 1 (own always counts
    # in cum at its own level -> subtract 1)
    lvl = jnp.clip(oct_c + 1, 0, L - 1)
    n_scale_obs = cum[tgt_p, lvl] - 1
    n_tracked = jnp.sum(bound, axis=1)
    n_redundant = jnp.sum(bound & (n_scale_obs >= 3), axis=1)
    redundant = (
        m.kf_valid
        & (n_redundant > (0.9 * n_tracked).astype(jnp.int32))
        & (n_tracked > 0)
        # the reference only examines the new keyframe's covisible local
        # window (src/mapping.cpp:648-651); global candidates would let a
        # distant, still-load-bearing region self-destruct
        & (m.covis[protect_slot] > 0)
    )
    # never cull the newest KF or slot 0 (origin anchor, reference keeps KF0)
    redundant = redundant.at[protect_slot].set(False).at[0].set(False)
    # cull at most one KF per call (the reference culls greedily per pass;
    # one-at-a-time keeps covisibility consistent between steps)
    victim = jnp.argmax(redundant.astype(jnp.int32))
    do_cull = jnp.any(redundant)
    kf_valid = m.kf_valid.at[victim].set(
        jnp.where(do_cull, False, m.kf_valid[victim])
    )
    kf_obs = m.kf_obs_point.at[victim].set(
        jnp.where(do_cull, -jnp.ones((m.feat_capacity,), jnp.int32),
                  m.kf_obs_point[victim])
    )
    m = m._replace(kf_valid=kf_valid, kf_obs_point=kf_obs)
    m = reassign_point_refs(m)
    if update_covis:
        m = m._replace(covis=recompute_covisibility(m))
    return m

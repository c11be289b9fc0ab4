"""Keyframe database: place-recognition index over dense BoW rows.

Re-designs OrbKeyFrameDatabase's inverted file (reference:
src/orbkeyframedatabase.cpp:27-31: word-id -> keyframe list) as a dense
``[K, W]`` BoW matrix: common-word counting becomes a binary matmul and
L1 scoring a broadcast min-sum — the whole candidate scan the
reference does with per-word list walks (DetectLoopCandidates /
DetectRelocalizationCandidates, reference: src/orbkeyframedatabase.cpp:70-314)
collapses into a handful of dense ops.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp


class KeyFrameDatabase(NamedTuple):
    bow: jnp.ndarray        # [K, W] float32 L1-normalized tf-idf rows
    has_row: jnp.ndarray    # [K] bool

    @property
    def capacity(self):
        return self.bow.shape[0]


def empty_kfdb(kf_capacity: int, n_words: int) -> KeyFrameDatabase:
    return KeyFrameDatabase(
        bow=jnp.zeros((kf_capacity, n_words), jnp.float32),
        has_row=jnp.zeros((kf_capacity,), bool),
    )


@jax.jit
def add_keyframe(db: KeyFrameDatabase, kf_slot, bow_row) -> KeyFrameDatabase:
    return KeyFrameDatabase(
        bow=db.bow.at[kf_slot].set(bow_row),
        has_row=db.has_row.at[kf_slot].set(True),
    )


@jax.jit
def erase_keyframe(db: KeyFrameDatabase, kf_slot) -> KeyFrameDatabase:
    return KeyFrameDatabase(
        bow=db.bow.at[kf_slot].set(0.0),
        has_row=db.has_row.at[kf_slot].set(False),
    )


@jax.jit
def query_scores(db: KeyFrameDatabase, query_bow):
    """L1 similarity of the query against every stored keyframe: [K]."""
    s = jnp.sum(jnp.minimum(db.bow, query_bow[None, :]), axis=1)
    return jnp.where(db.has_row, s, -1.0)


@jax.jit
def common_word_counts(db: KeyFrameDatabase, query_bow):
    """Number of shared words per keyframe — the inverted-file sharing count
    (reference: src/orbkeyframedatabase.cpp:82-106) as one bf16 matmul."""
    qb = (query_bow > 0).astype(jnp.bfloat16)
    kb = (db.bow > 0).astype(jnp.bfloat16)
    counts = jax.lax.dot_general(
        kb, qb,
        dimension_numbers=(((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
    )
    return jnp.where(db.has_row, counts.astype(jnp.int32), 0)


@functools.partial(jax.jit, static_argnums=(5,))
def detect_candidates(db: KeyFrameDatabase, query_bow, exclude_mask,
                      min_score, covis, n_candidates: int = 8):
    """Loop/relocalization candidates.

    Faithful gating chain (reference: src/orbkeyframedatabase.cpp:70-198):
    shared-word count > 0.8 * max, score >= min_score, then accumulate each
    candidate's score over its top-10 covisible group and keep groups above
    0.75 * best accumulated score; the returned slots are each group's best
    member.  ``exclude_mask`` removes the query's own covisible keyframes
    (loop detection) or nothing (relocalization, min_score = 0).
    """
    K = db.capacity
    counts = common_word_counts(db, query_bow)
    counts = jnp.where(exclude_mask, 0, counts)
    max_common = jnp.max(counts)
    min_common = jnp.maximum(0.8 * max_common.astype(jnp.float32), 1.0)

    scores = query_scores(db, query_bow)
    ok = (
        (counts.astype(jnp.float32) >= min_common)
        & (scores >= min_score)
        & (~exclude_mask)
        & db.has_row
    )
    base = jnp.where(ok, scores, 0.0)

    # covisibility-group accumulation: top-10 neighbours by covis weight
    top_w, top_idx = jax.lax.top_k(covis, 10)              # [K, 10]
    nb_scores = jnp.where(top_w > 0, base[top_idx], 0.0)
    acc = base + jnp.sum(nb_scores, axis=1)
    acc = jnp.where(ok, acc, -1.0)

    best_acc = jnp.max(acc)
    keep = acc >= 0.75 * best_acc
    acc = jnp.where(keep, acc, -1.0)
    cand_scores, cand = jax.lax.top_k(acc, n_candidates)
    return jnp.where(cand_scores > 0, cand, -1), cand_scores

"""Vocabulary, BoW scoring, KF database, BoW matching, Horn, PnP tests."""

import numpy as np
import jax
import jax.numpy as jnp

from opendlv_perception_vision_orbslam2_jax.models import vocabulary as voc
from opendlv_perception_vision_orbslam2_jax.models import kfdb as kfdb_mod
from opendlv_perception_vision_orbslam2_jax.ops import matching
from opendlv_perception_vision_orbslam2_jax.ops.horn import horn_align
from opendlv_perception_vision_orbslam2_jax.optim.pnp import pnp_ransac
from opendlv_perception_vision_orbslam2_jax.ops import lie


def _random_descs(m, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2**32, (m, 8), dtype=np.uint32)


def _perturb(descs, n_bits, seed=1):
    """Flip n_bits random bits in each descriptor."""
    rng = np.random.default_rng(seed)
    bits = np.unpackbits(
        descs.view(np.uint8).reshape(len(descs), 32), axis=1, bitorder="little"
    )
    for i in range(len(bits)):
        flip = rng.choice(256, n_bits, replace=False)
        bits[i, flip] ^= 1
    packed = np.packbits(bits, axis=1, bitorder="little")
    return packed.view(np.uint32).reshape(len(descs), 8)


def test_vocabulary_train_and_transform():
    descs = _random_descs(2000)
    v = voc.train_vocabulary(descs, branching=6, levels=3, seed=0)
    assert v.n_words > 20
    words, nodes = voc.transform(
        v, jnp.asarray(descs[:100]), jnp.ones((100,), bool)
    )
    assert int(jnp.sum(words >= 0)) == 100
    # same descriptor -> same word
    w2, _ = voc.transform(v, jnp.asarray(descs[:100]), jnp.ones((100,), bool))
    np.testing.assert_array_equal(np.asarray(words), np.asarray(w2))


def test_bow_score_discriminates():
    descs = _random_descs(3000, seed=2)
    v = voc.train_vocabulary(descs[:2000], branching=6, levels=3, seed=0)
    valid = jnp.ones((200,), bool)

    set_a = descs[:200]
    set_a_noisy = _perturb(set_a, 12, seed=3)   # same place, slight noise
    set_b = descs[2000:2200]                    # different place

    wa, _ = voc.transform(v, jnp.asarray(set_a), valid)
    wa2, _ = voc.transform(v, jnp.asarray(set_a_noisy), valid)
    wb, _ = voc.transform(v, jnp.asarray(set_b), valid)
    va = voc.bow_vector(v, wa)
    va2 = voc.bow_vector(v, wa2)
    vb = voc.bow_vector(v, wb)
    same = float(voc.bow_score(va, va2))
    diff = float(voc.bow_score(va, vb))
    assert same > diff + 0.1
    assert abs(float(voc.bow_score(va, va)) - 1.0) < 1e-5


def test_kfdb_query_and_candidates():
    descs = _random_descs(4000, seed=4)
    v = voc.train_vocabulary(descs[:2000], branching=6, levels=3, seed=0)
    db = kfdb_mod.empty_kfdb(16, v.n_words)
    valid = jnp.ones((150,), bool)
    frames = [descs[i * 150 : (i + 1) * 150] for i in range(8)]
    for i, fr in enumerate(frames):
        w, _ = voc.transform(v, jnp.asarray(fr), valid)
        db = kfdb_mod.add_keyframe(db, i, voc.bow_vector(v, w))

    # query a noisy revisit of frame 3
    q = _perturb(frames[3], 10, seed=5)
    wq, _ = voc.transform(v, jnp.asarray(q), valid)
    qv = voc.bow_vector(v, wq)
    scores = kfdb_mod.query_scores(db, qv)
    assert int(jnp.argmax(scores)) == 3

    covis = jnp.zeros((16, 16), jnp.int32)
    exclude = jnp.zeros((16,), bool)
    cands, cscores = kfdb_mod.detect_candidates(db, qv, exclude, 0.0, covis)
    assert int(cands[0]) == 3


def test_search_by_bow_matches_identical_sets():
    descs = _random_descs(3000, seed=6)
    v = voc.train_vocabulary(descs[:2000], branching=6, levels=3, seed=0)
    a = descs[:128]
    b_noisy = _perturb(a, 6, seed=7)
    valid = jnp.ones((128,), bool)
    wa, na = voc.transform(v, jnp.asarray(a), valid)
    wb, nb = voc.transform(v, jnp.asarray(b_noisy), valid)
    angles = jnp.zeros((128,))
    idx, ok = matching.search_by_bow(
        jnp.asarray(a), na, valid, angles,
        jnp.asarray(b_noisy), nb, valid, angles,
    )
    matched = np.asarray(ok)
    correct = np.asarray(idx)[matched] == np.arange(128)[matched]
    assert matched.sum() > 60
    assert correct.mean() > 0.95


def test_horn_align_recovers_similarity():
    rng = np.random.default_rng(8)
    a = rng.standard_normal((50, 3)).astype(np.float32)
    phi = np.asarray([0.3, -0.5, 0.2], np.float32)
    R_gt = np.asarray(lie.exp_so3(jnp.asarray(phi)))
    s_gt, t_gt = 1.7, np.asarray([0.5, -1.0, 2.0], np.float32)
    b = s_gt * a @ R_gt.T + t_gt
    R, t, s = horn_align(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(np.asarray(R), R_gt, atol=1e-4)
    np.testing.assert_allclose(float(s), s_gt, rtol=1e-4)
    np.testing.assert_allclose(np.asarray(t), t_gt, atol=1e-3)


def test_horn_align_fix_scale():
    rng = np.random.default_rng(9)
    a = rng.standard_normal((30, 3)).astype(np.float32)
    R_gt = np.asarray(lie.exp_so3(jnp.asarray([0.1, 0.2, -0.1], dtype=jnp.float32)))
    b = a @ R_gt.T + np.asarray([1.0, 0.0, -0.5], np.float32)
    R, t, s = horn_align(jnp.asarray(a), jnp.asarray(b), fix_scale=True)
    assert float(s) == 1.0
    np.testing.assert_allclose(np.asarray(R), R_gt, atol=1e-4)


def test_pnp_ransac_recovers_pose():
    rng = np.random.default_rng(10)
    n = 120
    p_w = np.stack(
        [rng.uniform(-8, 8, n), rng.uniform(-3, 3, n), rng.uniform(5, 30, n)],
        axis=-1,
    ).astype(np.float32)
    xi = np.asarray([0.4, -0.2, 0.3, 0.05, -0.04, 0.08], np.float32)
    T_gt = np.asarray(lie.exp_se3(jnp.asarray(xi)))
    p_c = p_w @ T_gt[:3, :3].T + T_gt[:3, 3]
    fx = fy = 320.0
    cx, cy = 256.0, 128.0
    uv = np.stack(
        [fx * p_c[:, 0] / p_c[:, 2] + cx, fy * p_c[:, 1] / p_c[:, 2] + cy],
        axis=-1,
    ).astype(np.float32)
    uv += rng.standard_normal(uv.shape) * 0.5
    # 25% outliers
    out = rng.choice(n, n // 4, replace=False)
    uv[out] += rng.uniform(-60, 60, (len(out), 2))

    res = pnp_ransac(
        jnp.asarray(p_w), jnp.asarray(uv), jnp.ones((n,)), jnp.ones((n,), bool),
        jax.random.PRNGKey(0), fx=fx, fy=fy, cx=cx, cy=cy,
    )
    assert int(res.n_inliers) > 0.6 * n
    T_est = np.eye(4, dtype=np.float32)
    T_est[:3, :3] = np.asarray(res.R)
    T_est[:3, 3] = np.asarray(res.t)
    d = np.asarray(lie.log_se3(jnp.asarray(T_gt @ np.linalg.inv(T_est).astype(np.float32))))
    assert np.linalg.norm(d[:3]) < 0.15
    assert np.linalg.norm(d[3:]) < 0.03

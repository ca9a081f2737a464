"""The port's vocabulary and keyframe database against the JAX package's:
the shipped vocabulary file is the same bytes, the tree descent gives equal
word and node ids (exact: integer Hamming distances, first of ties), and
the database returns equal candidates for the same keyframes and query."""

import hashlib
from pathlib import Path

import numpy as np
import pytest
import torch

from orb_slam3_comments_ghr_tpu.map import state as jstate
from orb_slam3_comments_ghr_tpu.retrieval import database as jdatabase, vocabulary as jvocabulary
from orb_slam3_comments_ghr_torch.map import state as tstate
from orb_slam3_comments_ghr_torch.retrieval import database as tdatabase, vocabulary as tvocabulary

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
JVOC = REPO / "orb_slam3_comments_ghr_tpu" / "retrieval" / "default_voc.npz"
TVOC = REPO / "orb_slam3_comments_ghr_torch" / "retrieval" / "default_voc.npz"


def test_default_vocabulary_is_the_same_file():
    assert hashlib.sha256(TVOC.read_bytes()).hexdigest() == hashlib.sha256(JVOC.read_bytes()).hexdigest()
    tv, jv = tvocabulary.Vocabulary.load(str(TVOC), device="cpu"), jvocabulary.Vocabulary.load(str(JVOC))
    assert (tv.k, tv.L, tv.n_words) == (jv.k, jv.L, jv.n_words)
    for a, b in zip(tv.levels, jv.levels):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tv.idf, jv.idf)


@pytest.fixture
def vocs():
    """Fresh vocabularies per test: the JAX package's descent caches its
    tables from inside its first trace, so one of its Vocabulary objects
    takes one descriptor count only (vocabulary.py:172-173)."""
    return tvocabulary.Vocabulary.load(str(TVOC), device="cpu"), jvocabulary.Vocabulary.load(str(JVOC))


@pytest.mark.parametrize("seed", [0, 1])
def test_transform_on_device_matches_jax(vocs, seed):
    tv, jv = vocs
    rng = np.random.default_rng(seed)
    descs = rng.integers(0, 2**32, (1024, 8), dtype=np.uint32)
    # near-duplicates of tree centroids exercise close calls in the descent
    descs[:200] = tv.levels[-1].reshape(-1, 8)[rng.integers(0, tv.n_words, 200)]
    descs[:100, 0] ^= np.uint32(1) << rng.integers(0, 32, 100).astype(np.uint32)
    valid = rng.random(1024) > 0.1
    jw, jn = jv.transform_on_device(descs, valid)
    tw, tn = tv.transform_on_device(descs, valid)           # numpy in, vocabulary's device
    np.testing.assert_array_equal(tw, jw)
    np.testing.assert_array_equal(tn, jn)
    tw2, tn2 = tv.transform_on_device(torch.from_numpy(descs.view(np.int32)), torch.from_numpy(valid))
    np.testing.assert_array_equal(tw2, jw)
    np.testing.assert_array_equal(tn2, jn)
    hw, hn = tv.transform(descs, valid)  # the host descent agrees too
    np.testing.assert_array_equal(hw, jw)
    np.testing.assert_array_equal(hn, jn)
    np.testing.assert_array_equal(tv.bow_vector(tw), jv.bow_vector(jw))


def test_trained_vocabulary_matches_jax():
    rng = np.random.default_rng(3)
    descs = rng.integers(0, 2**32, (600, 8), dtype=np.uint32)
    ids = rng.integers(0, 12, 600)
    tv = tvocabulary.Vocabulary.train(descs, k=4, L=2, seed=1, image_ids=ids, device="cpu")
    jv = jvocabulary.Vocabulary.train(descs, k=4, L=2, seed=1, image_ids=ids)
    for a, b in zip(tv.levels, jv.levels):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tv.idf, jv.idf)
    a, b = tv.bow_vector(tv.transform(descs[:50], np.ones(50, bool))[0]), jv.bow_vector(
        jv.transform(descs[:50], np.ones(50, bool))[0])
    for name in tvocabulary.SCORING:
        np.testing.assert_allclose(tvocabulary.SCORING[name](a, b), jvocabulary.SCORING[name](a, b))


def _build(state_mod, db_mod, voc, seed=0, n_kf=12, n_feat=256):
    """Keyframes sliding along a strip of landmarks: KF i sees landmarks
    [80 i, 80 i + 300) (a random 256 of them, a few bits flipped), and every
    landmark becomes a map point observed by the keyframes that see it, so
    covisibility follows the strip."""
    rng = np.random.default_rng(seed)
    world = rng.integers(0, 2**32, (80 * n_kf + 300, 8), dtype=np.uint32)
    m = state_mod.MapState(state_mod.MapConfig(max_kf=16, max_mp=4096, n_feat=n_feat, obs_cap=16))
    db = db_mod.KeyFrameDatabase(voc, 16)
    seen = {}
    for i in range(n_kf):
        lm = np.sort(rng.choice(np.arange(80 * i, 80 * i + 300), n_feat, replace=False))
        desc = world[lm].copy()
        desc[np.arange(n_feat), rng.integers(0, 8, n_feat)] ^= np.uint32(1) << rng.integers(
            0, 32, n_feat).astype(np.uint32)
        feats = {"xy": np.zeros((n_feat, 2), np.float32), "level": np.zeros(n_feat, np.int32),
                 "angle": np.zeros(n_feat, np.float32), "desc": desc, "valid": np.ones(n_feat, bool),
                 "u_right": np.full(n_feat, -1.0, np.float32), "depth": np.full(n_feat, -1.0, np.float32)}
        kf = m.add_keyframe(np.eye(3, dtype=np.float32), np.zeros(3, np.float32), feats, 0.1 * i)
        new = [j for j, l in enumerate(lm) if l not in seen]
        old = [j for j, l in enumerate(lm) if l in seen]
        if new:
            ids = m.add_map_points(np.zeros((len(new), 3), np.float32), desc[new], kf, np.asarray(new))
            seen.update({int(lm[j]): int(p) for j, p in zip(new, ids)})
        if old:
            m.add_observations(np.asarray([seen[int(lm[j])] for j in old]), kf, np.asarray(old))
        db.add(kf, m.kf_feat_desc[kf], m.kf_feat_valid[kf])
    query = world[80 * 5 + 40: 80 * 5 + 40 + n_feat].copy()
    return m, db, query


def test_database_candidates_match_jax(vocs):
    tv, jv = vocs
    mt, dbt, q = _build(tstate, tdatabase, tv)
    mj, dbj, _ = _build(jstate, jdatabase, jv)
    for kf in range(12):
        np.testing.assert_array_equal(dbt.kf_words[kf], dbj.kf_words[kf])
        np.testing.assert_allclose(dbt.kf_weights[kf], dbj.kf_weights[kf])
        np.testing.assert_array_equal(dbt.kf_node[kf], dbj.kf_node[kf])
    valid = np.ones(len(q), bool)
    qt = tv.bow_vector(tv.transform_on_device(q, valid)[0])
    qj = jv.bow_vector(jv.transform_on_device(q, valid)[0])
    np.testing.assert_array_equal(qt, qj)
    reloc = dbt.detect_relocalization_candidates(qt, mt)
    assert reloc == dbj.detect_relocalization_candidates(qj, mj)
    assert reloc and set(reloc) <= {4, 5, 6}  # the keyframes that saw the query's strip
    loop_t = dbt.detect_candidates(qt, {5}, mt, n_best=3)
    assert loop_t == dbj.detect_candidates(qj, {5}, mj, n_best=3)
    assert 5 not in loop_t
    dbt.erase(5)
    dbj.erase(5)
    assert dbt.detect_relocalization_candidates(qt, mt) == dbj.detect_relocalization_candidates(qj, mj)

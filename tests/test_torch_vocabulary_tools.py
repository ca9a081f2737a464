"""The port's vocabulary tools against the JAX package's: the 100k-word tree
it ships, `Vocabulary.save` and the retrieval scoring of
`orb_slam3_comments_ghr_torch/scripts/eval_vocabulary.py`.

- The twin of `tests/test_retrieval.py`'s `TestLargeVocabulary`: the
  port's `retrieval/voc_100k.npz` is the same bytes as the JAX package's,
  loads with k = 10, L = 5 and 100000 words, retrieves the right scene from
  a six-scene database, and `SlamConfig.voc_path` reaches it.
- `transform_on_device` at L = 5 gives the JAX package's word and node ids
  (exact: integer Hamming distances, the first child of a tie).
- A port-saved vocabulary loads in the JAX package bit for bit, and the
  other way round, for a trained tree and the 100k tree.
- `train_vocabulary --synthetic 2 --k 4 --L 2` trains the JAX script's
  tree bit for bit (the same views through the port's extractor).
- `eval_vocabulary`'s frames and scores equal the JAX script's on a
  stand-in MH01 ground truth (exact, the host time per query apart).
"""

import filecmp
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

# imported before any JAX descent is traced: the JAX package's
# `Vocabulary.transform_device` imports `ops.matching` inside its trace when
# nothing has yet, and the module objects made under that trace break a
# later jitted mapper program in the same process ("Execution supplied 14
# buffers but compiled program expected 18")
import orb_slam3_comments_ghr_tpu.ops.matching  # noqa: F401
from orb_slam3_comments_ghr_tpu.retrieval import vocabulary as jvocabulary
from orb_slam3_comments_ghr_tpu.utils import gt_replay as jgt
from orb_slam3_comments_ghr_torch.ops import cameras
from orb_slam3_comments_ghr_torch.retrieval import vocabulary as tvocabulary
from orb_slam3_comments_ghr_torch.retrieval.database import KeyFrameDatabase
from orb_slam3_comments_ghr_torch.utils import gt_replay as tgt, synthetic

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
JVOC100 = REPO / "orb_slam3_comments_ghr_tpu" / "retrieval" / "voc_100k.npz"
TVOC100 = REPO / "orb_slam3_comments_ghr_torch" / "retrieval" / "voc_100k.npz"
TVOC10 = REPO / "orb_slam3_comments_ghr_torch" / "retrieval" / "default_voc.npz"
STAND_IN_TUM = REPO / "results" / "mh01_img_stereo_full_r5.tum"
CAM = cameras.euroc_cam0()


class _NoCovis:
    def covisible_kfs(self, kf, k=10, min_weight=5, **kw):
        return []


def load_script(name: str):
    """The JAX package's `scripts/<name>.py` as a module."""
    spec = importlib.util.spec_from_file_location(f"jax_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def assert_same_vocabulary(a, b):
    """k, L, idf and every level the same bits and dtypes."""
    assert (a.k, a.L, a.n_words) == (b.k, b.L, b.n_words)
    assert a.idf.dtype == b.idf.dtype and a.idf.tobytes() == b.idf.tobytes()
    for x, y in zip(a.levels, b.levels):
        assert x.dtype == y.dtype and x.shape == y.shape and x.tobytes() == y.tobytes()


@pytest.fixture(scope="module")
def voc100():
    return tvocabulary.Vocabulary.load(str(TVOC100), device="cpu")


def test_100k_vocabulary_is_the_same_file():
    assert filecmp.cmp(TVOC100, JVOC100, shallow=False)


class TestLargeVocabulary:
    def test_100k_vocabulary_loads_and_retrieves(self, voc100):
        """The reference-scale tree (k=10 L=5, TemplatedVocabulary.h)
        retrieves the right scene from a six-scene database."""
        voc = voc100
        assert voc.n_words == 100000 and voc.k == 10 and voc.L == 5
        db = KeyFrameDatabase(voc, 64)
        rng = np.random.default_rng(11)
        kf_scene = {}
        kf = 0
        worlds = [synthetic.make_ring_world(300 + s) for s in range(6)]
        poses = synthetic.circular_trajectory(5, arc=0.5, outward=True)
        for s, world in enumerate(worlds):
            for R, t in poses:
                feats, _ = synthetic.render_features(world, CAM, R, t, n_feat=512,
                                                     seed=rng.integers(1 << 30), device="cpu")
                db.add(kf, feats.desc.numpy().view(np.uint32), feats.valid.numpy())
                kf_scene[kf] = s
                kf += 1
        feats, _ = synthetic.render_features(worlds[2], CAM, *poses[1], n_feat=512, seed=424242,
                                             device="cpu")
        word, _ = voc.transform_on_device(feats.desc, feats.valid)
        cands = db.detect_candidates(voc.bow_vector(word), set(), _NoCovis(), n_best=3)
        assert len(cands) >= 1
        assert all(kf_scene[c] == 2 for c in cands), [kf_scene[c] for c in cands]

    def test_slam_config_voc_path(self):
        """SlamConfig.voc_path overrides the shipped 10k-word default."""
        from orb_slam3_comments_ghr_torch.system import SLAM
        from orb_slam3_comments_ghr_torch.utils.config import SlamConfig

        slam = SLAM(CAM, SlamConfig(n_features=256, voc_path=str(TVOC100)), device="cpu")
        assert slam.voc.n_words == 100000 and slam.voc.L == 5
        assert SLAM(CAM, SlamConfig(n_features=256), device="cpu").voc.n_words == 10000


def tie_descriptors(voc, n_random: int, seed: int = 0) -> np.ndarray:
    """Random descriptors, and descriptors halfway (in Hamming distance)
    between two root children, which tie at the root unless a third child
    is nearer."""
    rng = np.random.default_rng(seed)
    rand = rng.integers(0, 2**32, (n_random, 8), dtype=np.uint32)
    root = voc.levels[0][0]
    ties = []
    for a in range(voc.k):
        for b in range(a + 1, voc.k):
            bits_a = np.unpackbits(root[a].view(np.uint8))
            bits_b = np.unpackbits(root[b].view(np.uint8))
            differ = np.nonzero(bits_a != bits_b)[0]
            out = bits_a.copy()
            out[differ[: len(differ) // 2]] = bits_b[differ[: len(differ) // 2]]
            ties.append(np.packbits(out).view(np.uint32))
    return np.concatenate([rand, np.stack(ties)])


def test_transform_on_device_at_L5_matches_jax(voc100):
    """The port's gathered XOR-popcount descent over the 100k tree gives the
    JAX package's word and node ids (its host descent, which
    eval_vocabulary queries with, and its device program), ties included,
    for numpy and tensor input."""
    jv = jvocabulary.Vocabulary.load(str(JVOC100))
    descs = tie_descriptors(voc100, 400)
    valid = np.ones(len(descs), bool)
    valid[::17] = False
    # the inputs hold ties at the root: two children at the least distance
    d0 = jvocabulary._hamming_np(descs, voc100.levels[0][0])
    assert ((d0 == d0.min(1, keepdims=True)).sum(1) > 1).sum() >= 10
    jw, jm = jv.transform(descs, valid)
    tw, tm = voc100.transform_on_device(descs, valid)
    np.testing.assert_array_equal(tw, jw)
    np.testing.assert_array_equal(tm, jm)
    tw2, tm2 = voc100.transform_on_device(torch.from_numpy(descs.view(np.int32)),
                                          torch.from_numpy(valid))
    np.testing.assert_array_equal(tw2, jw)
    np.testing.assert_array_equal(tm2, jm)
    jdw, jdm = jv.transform_on_device(descs, valid)
    np.testing.assert_array_equal(tw, jdw)
    np.testing.assert_array_equal(tm, jdm)
    assert (tw[valid] >= 0).all() and (tw[valid] < 100000).all()


def test_save_load_round_trip_both_ways(tmp_path, voc100):
    """The same training gives the same tree in both packages; each
    package's file loads in the other bit for bit; the 100k tree saved by
    the port loads in the JAX package unchanged."""
    rng = np.random.default_rng(5)
    descs = rng.integers(0, 2**32, (3000, 8), dtype=np.uint32)
    ids = rng.integers(0, 30, 3000)
    tv = tvocabulary.Vocabulary.train(descs, k=6, L=3, seed=3, image_ids=ids, device="cpu")
    jv = jvocabulary.Vocabulary.train(descs, k=6, L=3, seed=3, image_ids=ids)
    assert_same_vocabulary(tv, jv)
    tv.save(str(tmp_path / "port.npz"))
    jv.save(str(tmp_path / "jax.npz"))
    assert_same_vocabulary(jvocabulary.Vocabulary.load(str(tmp_path / "port.npz")), tv)
    assert_same_vocabulary(tvocabulary.Vocabulary.load(str(tmp_path / "jax.npz"), device="cpu"),
                           jv)
    with np.load(tmp_path / "port.npz") as a, np.load(tmp_path / "jax.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for f in a.files:
            assert a[f].dtype == b[f].dtype and a[f].tobytes() == b[f].tobytes()
    voc100.save(str(tmp_path / "voc_100k.npz"))
    assert_same_vocabulary(jvocabulary.Vocabulary.load(str(tmp_path / "voc_100k.npz")),
                           jvocabulary.Vocabulary.load(str(JVOC100)))


def test_train_vocabulary_matches_jax_script(tmp_path, monkeypatch):
    from orb_slam3_comments_ghr_torch.scripts import train_vocabulary

    argv = ["--synthetic", "2", "--k", "4", "--L", "2", "--n-features", "256"]
    assert train_vocabulary.main(argv + ["--out", str(tmp_path / "port.npz"),
                                         "--device", "cpu"]) == 0
    monkeypatch.setattr(sys, "argv", ["train_vocabulary.py"] + argv
                        + ["--out", str(tmp_path / "jax.npz"), "--cpu"])
    load_script("train_vocabulary").main()
    port = tvocabulary.Vocabulary.load(str(tmp_path / "port.npz"), device="cpu")
    assert port.n_words == 16
    assert_same_vocabulary(port, jvocabulary.Vocabulary.load(str(tmp_path / "jax.npz")))


def test_eval_vocabulary_matches_jax_script(tmp_path, monkeypatch):
    """`eval_vocabulary._build_frames` and `_score` on a stand-in MH01
    ground truth: the same frames as the JAX script's, and the same
    precision at 1 and 3 for the 10k and 100k trees."""
    from orb_slam3_comments_ghr_torch.scripts import eval_vocabulary as teval

    tgt.euroc_gt_from_tum(str(STAND_IN_TUM), str(tmp_path / "MH01_GT.txt"))
    monkeypatch.setattr(jgt, "GT_DIR", str(tmp_path))
    monkeypatch.setattr(tgt, "GT_DIR", str(tmp_path))
    jeval = load_script("eval_vocabulary")
    jframes = jeval._build_frames(10, 512, 7)
    tframes = teval._build_frames(10, 512, 7, "cpu")
    assert len(tframes) == len(jframes) == 20
    for (td, tv, tp), (jd, jv, jp) in zip(tframes, jframes):
        assert td.dtype == jd.dtype and np.array_equal(td, jd)
        assert np.array_equal(tv, jv) and np.array_equal(tp, jp)
    for voc in (TVOC10, TVOC100):
        got = teval._score(str(voc), tframes, 2.0, "cpu")
        want = jeval._score(str(voc), jframes, 2.0)
        got.pop("query_ms"), want.pop("query_ms")
        assert got == want, (got, want)
        assert got["queries"] == 10

"""Atlas files through the port: the twin of `tests/test_persistence.py` (its
3 cases: the round trip, the vocabulary guard, a second session that loads
the first one's atlas and revisits its start), and two cases across the
packages, with no JAX `SLAM` run: an atlas the port wrote loads in the JAX
package's `persistence.load_atlas`, and one the JAX package wrote of that
map loads back into the port; and the keyframe database of a session that
loads the atlas, against the JAX package's.

Session 1 is 60 frames of rendered features through the port on the CPU,
as the JAX test's. Bounds: the round trips are bit for bit, every array of
the file and every counter; the vocabulary checksums of the two packages
are equal; the loaded session's database has the JAX one's keyframes and
words, and its weights within 1e-6; the second session keeps the JAX test's
bars (the new sub-map is active, > 10 of its first 25 frames tracked, the
loaded keyframes kept) and starts with the loaded keyframes in its
database.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from orb_slam3_comments_ghr_torch.map import persistence
from orb_slam3_comments_ghr_torch.ops import cameras
from orb_slam3_comments_ghr_torch.system import SLAM
from orb_slam3_comments_ghr_torch.utils import synthetic
from orb_slam3_comments_ghr_torch.utils.config import SlamConfig

torch.set_num_threads(1)

CAM = cameras.euroc_cam0()
REPO = Path(__file__).resolve().parent.parent
COUNTERS = ("n_kf", "n_mp", "active_map", "n_maps", "version", "_mp_free", "map_imu_init",
            "map_viba1", "map_viba2", "rig")


def _cfg():
    return SlamConfig(
        n_features=512, local_points_cap=2048, local_ba_points=2048,
        max_frames_between_kf=5, min_init_matches=60,
    )


@pytest.fixture(scope="module")
def session1(tmp_path_factory):
    world = synthetic.make_ring_world(17)
    poses = synthetic.circular_trajectory(120, arc=1.0, outward=True)
    slam = SLAM(CAM, _cfg(), device="cpu")
    # session 1: first 60 frames (covers ~half the circle)
    for i in range(60):
        feats, _ = synthetic.render_features(world, CAM, *poses[i], n_feat=512, seed=1700 + i,
                                             device="cpu")
        slam.track_features(feats, i * 0.05)
    path = str(tmp_path_factory.mktemp("atlas") / "session1.npz")
    slam.save_atlas(path)
    return world, poses, slam, path


def assert_same_atlas(a, b):
    """Every array of the file and every counter, bit for bit."""
    for k in persistence._ARRAYS:
        x, y = getattr(a, k), getattr(b, k)
        assert x.dtype == y.dtype and np.array_equal(x, y), k
    for k in COUNTERS:
        assert getattr(a, k) == getattr(b, k), k


class TestPersistence:
    def test_roundtrip_identical(self, session1):
        world, poses, slam, path = session1
        m2 = persistence.load_atlas(path, voc=slam.voc)
        assert_same_atlas(m2, slam.map)
        assert m2.n_kf == slam.map.n_kf

    def test_vocabulary_checksum_guard(self, session1, tmp_path):
        world, poses, slam, path = session1
        from orb_slam3_comments_ghr_torch.retrieval.vocabulary import Vocabulary

        other = Vocabulary.random(k=8, L=2, seed=99, n_train=2000, device="cpu")
        with pytest.raises(ValueError, match="checksum"):
            persistence.load_atlas(path, voc=other)

    def test_multisession_relocalizes_into_loaded_map(self, session1):
        world, poses, slam, path = session1
        n_kf_s1 = slam.n_keyframes()
        slam2 = SLAM(CAM, _cfg(), device="cpu")
        slam2.load_atlas(path, new_session=True)
        assert slam2.map.active_map == 1
        # the new session's keyframe database holds the loaded keyframes
        loaded = slam.map.kf_ids()
        assert all(slam2.kfdb.present[k] for k in loaded) and slam2.n_keyframes() == 0
        # session 2 revisits the start of the trajectory
        tracked = 0
        for i in range(25):
            feats, _ = synthetic.render_features(
                world, CAM, *poses[i], n_feat=512, seed=8800 + i, device="cpu"
            )
            pose = slam2.track_features(feats, 100.0 + i * 0.05)
            if pose is not None:
                tracked += 1
        assert tracked > 10
        # either the new sub-map merged into the old one, or tracking simply
        # continued; in both cases the old keyframes must still exist
        assert slam2.n_keyframes() >= 2
        total_kfs = len(np.nonzero(slam2.map.kf_valid)[0])
        assert total_kfs >= n_kf_s1  # loaded keyframes retained


def jax_voc():
    """The JAX package's default vocabulary, loaded by the JAX package."""
    from orb_slam3_comments_ghr_tpu.retrieval.vocabulary import Vocabulary

    return Vocabulary.load(str(REPO / "orb_slam3_comments_ghr_tpu" / "retrieval"
                               / "default_voc.npz"))


class TestAcrossPackages:
    def test_port_atlas_loads_in_jax(self, session1):
        from orb_slam3_comments_ghr_tpu.map import persistence as jpersistence

        world, poses, slam, path = session1
        jvoc = jax_voc()
        assert jpersistence.vocabulary_checksum(jvoc) == persistence.vocabulary_checksum(slam.voc)
        assert_same_atlas(jpersistence.load_atlas(path, voc=jvoc), slam.map)

    def test_loaded_session_database_matches_jax(self, session1):
        """After `load_atlas(new_session=True)` into a SLAM that has not
        tracked, the keyframe database holds the same keyframes, words and
        weights in both packages (ROADMAP C12: the same state here)."""
        from orb_slam3_comments_ghr_tpu import system as jsystem
        from orb_slam3_comments_ghr_tpu.ops import cameras as jcameras
        from orb_slam3_comments_ghr_tpu.utils import config as jconfig

        world, poses, slam, path = session1
        t = SLAM(CAM, _cfg(), device="cpu")
        t.load_atlas(path, new_session=True)
        j = jsystem.SLAM(jcameras.euroc_cam0(), jconfig.SlamConfig(**vars(_cfg())))
        j.load_atlas(path, new_session=True)
        assert (t.map.active_map, t.map.n_maps) == (j.map.active_map, j.map.n_maps) == (1, 2)
        assert sorted(t.kfdb.kf_words) == sorted(j.kfdb.kf_words) == list(slam.map.kf_ids())
        for kf in t.kfdb.kf_words:
            assert np.array_equal(t.kfdb.kf_words[kf], j.kfdb.kf_words[kf])
            np.testing.assert_allclose(t.kfdb.kf_weights[kf], j.kfdb.kf_weights[kf], rtol=1e-6)

    def test_jax_atlas_loads_in_port(self, session1, tmp_path):
        from orb_slam3_comments_ghr_tpu.map import persistence as jpersistence

        world, poses, slam, path = session1
        jvoc = jax_voc()
        jmap = jpersistence.load_atlas(path, voc=jvoc)
        jpath = str(tmp_path / "jax_written.npz")
        jpersistence.save_atlas(jmap, jpath, voc=jvoc)
        with np.load(jpath) as zj, np.load(path) as zt:
            assert str(zj["__meta__"]) == str(zt["__meta__"])
        assert_same_atlas(persistence.load_atlas(jpath, voc=slam.voc), slam.map)

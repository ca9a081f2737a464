"""Batched observation insertion and the covisibility of the port's map
(`map/state.py`, copied from the JAX package): the twin of
`tests/test_map_batched_obs.py` (its 5 cases). Each case runs the same
calls on the port's map and on the JAX package's, holds the port to the
JAX test's bars, and requires the two maps' observation tables to be equal
(bit-exact: both are the same numpy code). The loop closer's regions and
the essential graph are built on this covisibility and its tie-break."""

import numpy as np

from test_map_batched_obs import _state as jax_state
from orb_slam3_comments_ghr_torch import convert
from orb_slam3_comments_ghr_torch.map.state import MapState


def _states(seed: int):
    """(port map, JAX map), built by the JAX test's `_state` from the same
    seed; the port's is a copy made by `convert`."""
    j = jax_state(np.random.default_rng(seed))
    t = convert.map_state_from_numpy(convert.map_state_to_numpy(j))
    assert isinstance(t, MapState)
    return t, j


def _same(t, j):
    for name in ("mp_obs_kf", "mp_obs_idx", "mp_n_obs", "kf_feat_mp"):
        assert (getattr(t, name) == getattr(j, name)).all(), name


class TestBatchedObservations:
    def test_matches_sequential_adds(self):
        rng = np.random.default_rng(0)
        a, ja = _states(0)
        b, _ = _states(0)
        for _ in range(100):
            kf = int(rng.integers(0, 6))
            n = int(rng.integers(1, 12))
            mps = rng.choice(40, n, replace=False)
            fi = rng.choice(64, n, replace=False)
            a.add_observations(mps, kf, fi)
            ja.add_observations(mps, kf, fi)
            for m_, f_ in zip(mps, fi):
                b.add_observation(int(m_), kf, int(f_))
        _same(a, b)
        _same(a, ja)

    def test_skips_existing_and_full(self):
        st, js = _states(1)
        for s in (st, js):
            assert s.add_observations(np.array([0, 1]), 2, np.array([5, 6])).all()
            assert not s.add_observations(np.array([0, 1]), 2, np.array([7, 8])).any()
            for k in range(1, 6):
                s.add_observation(3, k, k)
            s.mp_obs_kf[3, s.mp_obs_kf[3] < 0] = 19  # saturate the remaining slots
            assert not s.add_observations(np.array([3]), 7, np.array([9])).any()
        _same(st, js)

    def test_version_bumps_on_add(self):
        st, _ = _states(2)
        v0 = st.version
        st.add_observations(np.array([10]), 3, np.array([11]))
        assert st.version > v0
        v1 = st.version
        st.add_observations(np.array([10]), 3, np.array([12]))  # no-op
        assert st.version == v1


class TestCovisibility:
    def test_tie_break_prefers_newer_kf(self):
        st, js = _states(3)
        for s in (st, js):
            for kf, mps in ((1, [0, 1]), (2, [2, 3]), (3, [4, 5])):
                for i, mp in enumerate(mps):
                    s.add_observation(mp, kf, 20 + i)
                    s.add_observation(mp, 5, 30 + mp)
        out = st.covisible_kfs(5, k=10, min_weight=1)
        assert out == js.covisible_kfs(5, k=10, min_weight=1)
        assert [k for k in out if k in (1, 2, 3)] == [3, 2, 1]

    def test_counts_match_bruteforce(self):
        rng = np.random.default_rng(4)
        st, js = _states(4)
        for _ in range(200):
            args = (int(rng.integers(0, 40)), int(rng.integers(0, 6)), int(rng.integers(0, 64)))
            st.add_observation(*args)
            js.add_observation(*args)
        for kf in range(6):
            counts = {}
            mps = st.kf_feat_mp[kf]
            for other in st.mp_obs_kf[mps[mps >= 0]].reshape(-1):
                if other >= 0 and other != kf:
                    counts[int(other)] = counts.get(int(other), 0) + 1
            assert st.covisibility(kf) == counts == js.covisibility(kf)
        pairs, w = st.covisibility_edges(min_weight=1)
        jpairs, jw = js.covisibility_edges(min_weight=1)
        assert (pairs == jpairs).all() and (w == jw).all()

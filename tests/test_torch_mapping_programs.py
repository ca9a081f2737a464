"""The port's matching and mapping programs against the JAX package on the
same synthetic keyframes (landmarks of `make_world` rendered by the JAX
package's `render_features`, handed to both through `convert`):
initialization matching, epipolar matching, triangulation with its gates,
new-point creation against several neighbours, and the projection fuse.

Bounds: matches are decided on integer Hamming distances, so `ok` is equal
and `idx` equal except where two candidates tie at the best distance;
triangulated points agree to 1e-4 + 1e-5 |X| (float32 SVD in either
package; the points lie 5-15 m away, where one float32 step is ~1e-6)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_comments_ghr_tpu.ops import cameras as jcameras, matching as jmatching
from orb_slam3_comments_ghr_tpu.pipeline import programs as jprograms
from orb_slam3_comments_ghr_tpu.utils import synthetic as jsynthetic
from orb_slam3_comments_ghr_torch import convert
from orb_slam3_comments_ghr_torch.ops import cameras as tcameras, matching as tmatching
from orb_slam3_comments_ghr_torch.ops import window_match as twm
from orb_slam3_comments_ghr_torch.pipeline import programs as tprograms
from orb_slam3_comments_ghr_torch.utils import synthetic as tsynthetic

torch.set_num_threads(1)

JCAM = jcameras.euroc_cam0()
TCAM = tcameras.euroc_cam0()
X_ATOL, X_RTOL = 1e-4, 1e-5


@pytest.fixture(scope="module")
def views():
    """Five keyframes along the arc: JAX features, port features, poses."""
    world = jsynthetic.make_world(5, n_points=3000)
    poses = jsynthetic.circular_trajectory(60)
    out = []
    for i in (0, 4, 8, 12, 16):
        jf, _ = jsynthetic.render_features(world, JCAM, *poses[i], n_feat=512, seed=100 + i)
        arrays = {k: np.asarray(v) for k, v in jf._asdict().items()}
        # some octaves above 0, to exercise the level bands
        rng = np.random.default_rng(i)
        arrays["level"] = np.where(rng.random(512) < 0.3, rng.integers(0, 4, 512), arrays["level"]).astype(np.int32)
        jf = jf._replace(level=jnp.asarray(arrays["level"]))
        out.append((jf, convert.features_from_numpy(arrays, device="cpu"), poses[i]))
    return out


def _hamming(a, b):
    return tmatching.hamming_matrix(a, b).numpy()


def _assert_idx_up_to_ties(idx_t, idx_j, ok, dist):
    """idx equal on ok rows, or where not, both at the same distance."""
    rows = np.nonzero(ok & (idx_t != idx_j))[0]
    np.testing.assert_array_equal(dist[rows, idx_t[rows]], dist[rows, idx_j[rows]])


def test_search_for_initialization_matches_jax(views):
    (ja, ta, _), (jb, tb, _) = views[0], views[1]
    before = twm.launches
    idx_t, dist_t, ok_t = tmatching.search_for_initialization(ta, tb, window=100.0, ratio=0.9)
    assert twm.launches == before  # CPU tensors: the plain version
    idx_j, dist_j, ok_j = jmatching.search_for_initialization(ja, jb, window=100.0, ratio=0.9)
    ok = np.asarray(ok_j)
    np.testing.assert_array_equal(ok_t.numpy(), ok)
    np.testing.assert_array_equal(dist_t.numpy(), np.asarray(dist_j))
    _assert_idx_up_to_ties(idx_t.numpy(), np.asarray(idx_j), ok, _hamming(ta.desc, tb.desc))
    assert ok.sum() > 150


def _relative(pose1, pose2):
    (R1, t1), (R2, t2) = pose1, pose2
    R12 = R1 @ R2.T
    return R12.astype(np.float32), (t1 - R12 @ t2).astype(np.float32)


def _free(seed, n):
    return np.random.default_rng(seed).random(n) > 0.3


def test_epipolar_match_and_triangulation_match_jax(views):
    (ja, ta, p1), (jb, tb, p2) = views[0], views[2]
    R12, t12 = _relative(p1, p2)
    f1, f2 = _free(1, 512) & np.asarray(ja.valid), _free(2, 512) & np.asarray(jb.valid)
    idx_j, ok_j = jprograms.epipolar_match(JCAM, ja.desc, ja.xy, ja.level, jnp.asarray(f1),
                                           jb.desc, jb.xy, jb.level, jnp.asarray(f2),
                                           jnp.asarray(R12), jnp.asarray(t12))
    T = lambda a: torch.from_numpy(np.array(a))  # noqa: E731 (a writable copy)
    idx_t, ok_t = tprograms.epipolar_match(TCAM, ta.desc, ta.xy, ta.level, T(f1), tb.desc, tb.xy,
                                           tb.level, T(f2), T(R12), T(t12))
    ok = np.asarray(ok_j)
    np.testing.assert_array_equal(ok_t.numpy(), ok)
    _assert_idx_up_to_ties(idx_t.numpy(), np.asarray(idx_j), ok, _hamming(ta.desc, tb.desc))
    assert ok.sum() > 100

    sel = np.asarray(idx_j)
    ur = np.full(512, -1.0, np.float32)
    X_j, good_j = jprograms.triangulate_matches(
        JCAM, *(jnp.asarray(a) for a in (*p1, *p2)), ja.xy, jb.xy[sel], ja.level, jb.level[sel],
        ok_j, jnp.asarray(ur), jnp.asarray(ur))
    X_t, good_t = tprograms.triangulate_matches(
        TCAM, *(T(a) for a in (*p1, *p2)), ta.xy, tb.xy[T(sel).long()], ta.level,
        tb.level[T(sel).long()], T(ok), T(ur), T(ur))
    good = np.asarray(good_j)
    np.testing.assert_array_equal(good_t.numpy(), good)
    np.testing.assert_allclose(X_t.numpy()[good], np.asarray(X_j)[good], atol=X_ATOL, rtol=X_RTOL)
    assert good.sum() > 50


def test_map_new_points_multi_matches_jax(views):
    (ja, ta, p1), nbs = views[2], [views[0], views[1], views[4]]
    f1 = _free(3, 512) & np.asarray(ja.valid)
    f2s = np.stack([_free(4 + b, 512) & np.asarray(v[0].valid) for b, v in enumerate(nbs)])
    ur = np.full((3, 512), -1.0, np.float32)
    J, T = jnp.asarray, torch.from_numpy
    jidx, jX, jgood = jprograms.map_new_points_multi(
        JCAM, ja.desc, ja.xy, ja.level, J(ur[0]), J(f1), J(p1[0]), J(p1[1]),
        jnp.stack([v[0].desc for v in nbs]), jnp.stack([v[0].xy for v in nbs]),
        jnp.stack([v[0].level for v in nbs]), J(ur), J(f2s),
        J(np.stack([v[2][0] for v in nbs])), J(np.stack([v[2][1] for v in nbs])))
    tidx, tX, tgood = tprograms.map_new_points_multi(
        TCAM, ta.desc, ta.xy, ta.level, T(ur[0]), T(f1), T(p1[0]), T(p1[1]),
        torch.stack([v[1].desc for v in nbs]), torch.stack([v[1].xy for v in nbs]),
        torch.stack([v[1].level for v in nbs]), T(ur), T(f2s),
        T(np.stack([v[2][0] for v in nbs])), T(np.stack([v[2][1] for v in nbs])))
    good = np.asarray(jgood)
    np.testing.assert_array_equal(tgood.numpy(), good)
    for b, v in enumerate(nbs):
        _assert_idx_up_to_ties(tidx[b].numpy(), np.asarray(jidx[b]), good[b], _hamming(ta.desc, v[1].desc))
    np.testing.assert_allclose(tX.numpy()[good], np.asarray(jX)[good], atol=X_ATOL, rtol=X_RTOL)
    assert good.sum(1).min() > 20


def test_fuse_project_multi_matches_jax(views):
    world = jsynthetic.make_world(5, n_points=3000)
    # the landmarks as a local map, descriptors from keyframe 8's view
    jf, ids = jsynthetic.render_features(world, JCAM, *views[2][2], n_feat=512, seed=108)
    n = len(ids)
    L = 640
    c = -views[2][2][0].T @ views[2][2][1]
    d = world.points[ids] - c
    dist = np.linalg.norm(d, axis=1)
    lp_np = {
        "pos": np.pad(world.points[ids], ((0, L - n), (0, 0))),
        "desc": np.pad(np.asarray(jf.desc)[:n], ((0, L - n), (0, 0))),
        "normal": np.pad(d / dist[:, None], ((0, L - n), (0, 0))),
        "min_dist": np.pad(dist * 1.2 / 1.2**7, (0, L - n)),
        "max_dist": np.pad(dist * 1.2, (0, L - n)),
        "valid": np.arange(L) < n, "angle": np.zeros(L, np.float32),
    }
    jlp = jprograms.LocalPoints(**{k: jnp.asarray(v) for k, v in lp_np.items()})
    tlp = convert.local_points_from_numpy(lp_np, device="cpu")
    nbs = [views[1], views[3], views[4]]
    rng = np.random.default_rng(9)
    feat_mp = np.where(rng.random((3, 512)) < 0.4, rng.integers(0, 5000, (3, 512)), -1).astype(np.int32)
    J, T = jnp.asarray, torch.from_numpy
    Rs = np.stack([v[2][0] for v in nbs])
    ts = np.stack([v[2][1] for v in nbs])
    jidx, jok, jex = jprograms.fuse_project_multi(
        JCAM, J(Rs), J(ts), jlp, jnp.stack([v[0].xy for v in nbs]), jnp.stack([v[0].level for v in nbs]),
        jnp.stack([v[0].desc for v in nbs]), jnp.stack([v[0].valid for v in nbs]), J(feat_mp))
    before = twm.launches
    tidx, tok, tex = tprograms.fuse_project_multi(
        TCAM, T(Rs), T(ts), tlp, torch.stack([v[1].xy for v in nbs]),
        torch.stack([v[1].level for v in nbs]), torch.stack([v[1].desc for v in nbs]),
        torch.stack([v[1].valid for v in nbs]), T(feat_mp))
    assert twm.launches == before
    ok = np.asarray(jok)
    np.testing.assert_array_equal(tok.numpy(), ok)
    for b, v in enumerate(nbs):
        _assert_idx_up_to_ties(tidx[b].numpy(), np.asarray(jidx[b]), ok[b], _hamming(tlp.desc, v[1].desc))
        same = ok[b] & (tidx[b].numpy() == np.asarray(jidx[b]))
        np.testing.assert_array_equal(tex[b].numpy()[same], np.asarray(jex[b])[same])
    assert ok.sum(1).min() > 100


def test_synthetic_features_match_jax():
    world_t, world_j = tsynthetic.make_world(3, 500), jsynthetic.make_world(3, 500)
    for k in ("points", "desc", "patches", "priority"):
        np.testing.assert_array_equal(getattr(world_t, k), getattr(world_j, k))
    R, t = jsynthetic.circular_trajectory(40)[7]
    tf, tids = tsynthetic.render_features(world_t, TCAM, R, t, n_feat=256, seed=11, device="cpu")
    jf, jids = jsynthetic.render_features(world_j, JCAM, R, t, n_feat=256, seed=11)
    np.testing.assert_array_equal(tids, jids)
    back = convert.to_numpy(tf)
    for k, v in jf._asdict().items():
        np.testing.assert_allclose(back[k], np.asarray(v), atol=1e-3, err_msg=k)
    np.testing.assert_array_equal(back["desc"], np.asarray(jf.desc))
    for (ta, Ta), (tb, Tb) in zip(tsynthetic.gt_trajectory([(R, t)] * 3), jsynthetic.gt_trajectory([(R, t)] * 3)):
        assert ta == tb
        np.testing.assert_array_equal(Ta, Tb)

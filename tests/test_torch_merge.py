"""Map merging through the port, against the JAX package: the twin of
`tests/test_merge.py`. Tracking on rendered features of a ring world,
then blank frames lose it and a new sub-map opens, then the run crosses the
first map's ground again (poses 5-55), where the loop closer must merge
the sub-map back (or the tracker relocalize into map 0). Run once per
package, compared by outcome: both pass the JAX test's bars (>= 4
keyframes before the kidnap, >= 2 maps after it, > 20 frames tracked on
the way back, merged or relocalized), and both end in the same state (the
same active map and merge count). The JAX tracker runs with the port's
repair of the velocity after a fallback (ROADMAP C9,
`test_torch_slam.jax_velocity_from_previous_frame`)."""

import pytest
import torch

from test_loopclosing import CAM as JCAM
from test_torch_loopclosing import features, make_slam
from test_torch_slam import jax_velocity_from_previous_frame
from orb_slam3_comments_ghr_tpu.frontend.types import empty_features as jempty
from orb_slam3_comments_ghr_tpu.utils import synthetic as jsynthetic
from orb_slam3_comments_ghr_torch.frontend.types import empty_features as tempty

torch.set_num_threads(1)

# tests/test_merge.py
CFG = dict(n_features=512, local_points_cap=2048, local_ba_points=2048, max_frames_between_kf=5,
           min_init_matches=60, recently_lost_secs=0.4, loop_min_kfs=8)


def kidnap_run(pkg: str) -> dict:
    world = jsynthetic.make_ring_world(23)
    poses = jsynthetic.circular_trajectory(160, arc=1.0, outward=True)
    slam = make_slam(pkg, **CFG)
    render = lambda i, seed: features(pkg, jsynthetic.render_features(
        world, JCAM, *poses[i], n_feat=512, seed=seed)[0])
    for i in range(60):
        slam.track_features(render(i, 2300 + i), i * 0.05)
    out = dict(kfs_before=slam.n_keyframes())
    blank = jempty(512) if pkg == "jax" else tempty(512, device="cpu")
    for j in range(14):
        slam.track_features(blank, 3.0 + j * 0.05)
    out["maps_after_kidnap"] = slam.map.n_maps
    tracked = 0
    for j, i in enumerate(range(5, 56)):
        tracked += slam.track_features(render(i, 9300 + i), 4.0 + j * 0.05) is not None
    out.update(tracked=tracked, merges=slam.loopcloser.n_merges, active=slam.map.active_map,
               n_maps=slam.map.n_maps)
    return out


@pytest.fixture(scope="module")
def runs():
    with jax_velocity_from_previous_frame():
        jax_run = kidnap_run("jax")
    return {"jax": jax_run, "torch": kidnap_run("torch")}


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_lost_then_merge(runs, pkg):
    r = runs[pkg]
    assert r["kfs_before"] >= 4
    assert r["maps_after_kidnap"] >= 2  # a fresh sub-map was opened
    assert r["tracked"] > 20
    assert r["merges"] >= 1 or r["active"] == 0, r


def test_runs_agree(runs):
    j, t = runs["jax"], runs["torch"]
    assert (t["active"], t["merges"] >= 1) == (j["active"], j["merges"] >= 1), (j, t)

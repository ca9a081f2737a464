"""The port's numpy scene, renderer, trajectory, depth map and IMU sequence
against the JAX package's (bit for bit), the `convert` round trips, the
keyframe map builder, and the rule that the port imports no JAX."""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from test_rgbd import _depth_map
from orb_slam3_comments_ghr_tpu.ops import cameras as jcameras
from orb_slam3_comments_ghr_tpu.pipeline import programs as jprograms
from orb_slam3_comments_ghr_tpu.utils import synthetic as jsynthetic
from orb_slam3_comments_ghr_torch import convert
from orb_slam3_comments_ghr_torch.frontend import batched as tbatched
from orb_slam3_comments_ghr_torch.ops import cameras as tcameras
from orb_slam3_comments_ghr_torch.utils import synthetic as tsynthetic

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "orb_slam3_comments_ghr_torch"


@pytest.mark.parametrize("n,outward", [(300, False), (40, True)])
def test_trajectory_equal(n, outward):
    for (Rt, tt), (Rj, tj) in zip(tsynthetic.circular_trajectory(n, outward=outward),
                                  jsynthetic.circular_trajectory(n, outward=outward)):
        np.testing.assert_array_equal(Rt, Rj)
        np.testing.assert_array_equal(tt, tj)


@pytest.mark.parametrize("frame", [0, 17, 40])
def test_render_and_depth_equal(frame):
    scene_t, scene_j = tsynthetic.make_textured_scene(7), jsynthetic.make_textured_scene(7)
    np.testing.assert_array_equal(scene_t.tex_far, scene_j.tex_far)
    np.testing.assert_array_equal(scene_t.tex_near, scene_j.tex_near)
    cam_t, cam_j = tcameras.euroc_cam0(), jcameras.euroc_cam0()
    R, t = tsynthetic.circular_trajectory(300)[frame]
    np.testing.assert_array_equal(tsynthetic.render_image(scene_t, cam_t, R, t),
                                  jsynthetic.render_image(scene_j, cam_j, R, t))
    np.testing.assert_array_equal(tsynthetic.depth_map(scene_t, cam_t, R, t),
                                  _depth_map(scene_j, cam_j, R, t))


@pytest.mark.parametrize("frame", [0, 13])
def test_render_features_stereo_equal(frame):
    """`render_features(stereo=True)`: the same draws, so the same
    features, depths and right coordinates, bit for bit."""
    world = jsynthetic.make_world(21, n_points=3000)
    R, t = jsynthetic.circular_trajectory(30)[frame]
    jf, jids = jsynthetic.render_features(world, jcameras.euroc_cam0(), R, t, n_feat=512,
                                          seed=900 + frame, stereo=True)
    tf, tids = tsynthetic.render_features(tsynthetic.World(**world.__dict__), tcameras.euroc_cam0(),
                                          R, t, n_feat=512, seed=900 + frame, stereo=True,
                                          device="cpu")
    np.testing.assert_array_equal(tids, jids)
    back = convert.to_numpy(tf)
    for k, v in jf._asdict().items():
        np.testing.assert_array_equal(back[k], np.asarray(v), err_msg=k)
    assert (back["depth"][back["valid"]] > 0).all() and (back["u_right"][back["valid"]] > 0).all()


@pytest.mark.parametrize("n", [70, 150])
def test_vi_sequence_equal(n):
    """Poses, IMU rows and timestamps of `vi_sequence`, bit for bit."""
    (tp, trows, ttimes), (jp, jrows, jtimes) = tsynthetic.vi_sequence(n), jsynthetic.vi_sequence(n)
    np.testing.assert_array_equal(trows, jrows)
    assert trows.dtype == jrows.dtype and ttimes == jtimes
    for (Rt, tt), (Rj, tj) in zip(tp, jp):
        np.testing.assert_array_equal(Rt, Rj)
        np.testing.assert_array_equal(tt, tj)


def test_convert_round_trips():
    cam = jcameras.euroc_cam0()
    assert convert.camera_from_jax(cam) == tcameras.euroc_cam0()
    rng = np.random.default_rng(0)
    n = 64
    jf = {
        "xy": rng.random((n, 2), np.float32) * 700, "level": rng.integers(0, 8, n).astype(np.int32),
        "angle": rng.random(n, np.float32), "response": rng.random(n, np.float32),
        "desc": rng.integers(0, 2**32, (n, 8), dtype=np.uint32), "valid": rng.random(n) > 0.2,
        "u_right": np.full(n, -1.0, np.float32), "depth": np.full(n, -1.0, np.float32),
    }
    feats = convert.features_from_numpy(jf, device="cpu")
    assert feats.desc.dtype == torch.int32
    back = convert.to_numpy(feats)
    for k, v in jf.items():
        assert back[k].dtype == v.dtype, k
        np.testing.assert_array_equal(back[k], v)
    lp = jprograms.LocalPoints(
        pos=jnp.asarray(rng.random((n, 3), np.float32)), desc=jnp.asarray(jf["desc"]),
        normal=jnp.asarray(rng.random((n, 3), np.float32)),
        min_dist=jnp.ones(n), max_dist=jnp.full(n, 5.0), valid=jnp.asarray(jf["valid"]),
        angle=jnp.asarray(jf["angle"]))
    lp_np = {k: np.asarray(v) for k, v in lp._asdict().items()}
    back = convert.to_numpy(convert.local_points_from_numpy(lp_np, device="cpu"))
    for k, v in lp_np.items():
        np.testing.assert_array_equal(back[k], v)
        assert back[k].dtype == v.dtype, k


def test_local_points_reproject_into_keyframe():
    cam = tcameras.euroc_cam0()
    scene = tsynthetic.make_textured_scene(7)
    R, t = tsynthetic.circular_trajectory(300)[0]
    img = np.clip(np.round(tsynthetic.render_image(scene, cam, R, t)), 0, 255).astype(np.uint8)
    feats = tbatched.extract_batched(torch.from_numpy(img))
    pts = tsynthetic.local_points_from_keyframes(
        cam, [feats], [(R, t)], [tsynthetic.depth_map(scene, cam, R, t)], cap=1200)
    n = int(pts.valid.sum())
    assert n == int(feats.valid.sum())  # every keypoint hits a plane here
    assert not bool(pts.valid[n:].any())
    pc = pts.pos[:n].numpy() @ R.T + t
    uv = np.stack([cam.fx * pc[:, 0] / pc[:, 2] + cam.cx, cam.fy * pc[:, 1] / pc[:, 2] + cam.cy], -1)
    np.testing.assert_allclose(uv, feats.xy[feats.valid].numpy(), atol=2e-3)
    np.testing.assert_allclose(np.linalg.norm(pts.normal[:n].numpy(), axis=-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(pts.max_dist[:n].numpy() / pts.min_dist[:n].numpy(), 1.2**7, rtol=1e-5)
    assert torch.equal(pts.desc[:n], feats.desc[feats.valid])


def test_port_imports_without_jax():
    # the card machine has no JAX: every module must import with it blocked
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "import orb_slam3_comments_ghr_torch as p\n"
        "import orb_slam3_comments_ghr_torch.system, orb_slam3_comments_ghr_torch.pipeline.mapper\n"
        "import orb_slam3_comments_ghr_torch.retrieval.database\n"
        "import orb_slam3_comments_ghr_torch.frontend.stereo, orb_slam3_comments_ghr_torch.frontend.clahe\n"
        "import orb_slam3_comments_ghr_torch.io.rectify\n"
        "import orb_slam3_comments_ghr_torch.optim.imu, orb_slam3_comments_ghr_torch.optim.inertial\n"
        "import orb_slam3_comments_ghr_torch.optim.vi_ba, orb_slam3_comments_ghr_torch.pipeline.imu_frontend\n"
        "import orb_slam3_comments_ghr_torch.optim.sim3, orb_slam3_comments_ghr_torch.optim.posegraph\n"
        "import orb_slam3_comments_ghr_torch.pipeline.loopcloser, orb_slam3_comments_ghr_torch.utils.gt_replay\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "assert not any(k.startswith('orb_slam3_comments_ghr_tpu') for k in sys.modules)\n"
        "print(len(mods))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 50
    imports = re.compile(r"^\s*(import|from)\s+(jax|orb_slam3_comments_ghr_tpu)\b", re.M)
    for path in [*PORT.rglob("*.py"), REPO / "chip_smoke.py"]:
        assert not imports.search(path.read_text()), path

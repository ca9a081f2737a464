"""Dataset loaders and the CLI through the port, against the JAX package:
the twin of `tests/test_io.py` (its 3 cases) on one synthetic EuRoC-layout
folder (45 rendered frames, IMU rows, a TUM ground-truth file).

Bounds: the loaders give the same frames, timestamps and IMU chunks as the
JAX package's, bit for bit. The CLI runs in both packages on the same
folder (the port with `--device cpu`; the JAX tracker with the port's
motion model after a fallback, ROADMAP C9): the same frame count, tracked
frames and keyframes within 2, map points within 20 %, both Sim(3) ATEs
under 5 cm, and the JAX test's own bars on the port's run.
"""

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

from orb_slam3_comments_ghr_torch.io import datasets
from orb_slam3_comments_ghr_torch.ops import cameras
from orb_slam3_comments_ghr_torch.utils import synthetic

torch.set_num_threads(1)

CAM = cameras.euroc_cam0()


@pytest.fixture(scope="module")
def euroc_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("euroc"))
    scene = synthetic.make_textured_scene(3)
    poses = synthetic.circular_trajectory(45)
    times = [1403636579.0 + i * 0.05 for i in range(45)]
    images = [synthetic.render_image(scene, CAM, R, t) for R, t in poses]
    imu = np.zeros((450, 7))
    imu[:, 0] = 1403636579.0 + np.arange(450) * 0.005
    imu[:, 3] = 9.81
    datasets.write_synthetic_euroc(root, images, times, imu_rows=imu)
    gt = os.path.join(root, "groundtruth.txt")
    synthetic.write_tum_groundtruth(gt, poses, times)
    return root, poses, times, gt


def jax_frames(root: str, **kw):
    from orb_slam3_comments_ghr_tpu.io import datasets as jdatasets

    return list(jdatasets.EurocDataset(root, **kw))


class TestEurocLoader:
    def test_loads_frames(self, euroc_root):
        root, poses, times, _ = euroc_root
        ds = datasets.EurocDataset(root)
        assert len(ds) == 45
        frames = list(ds)
        assert frames[0].img.shape == (CAM.height, CAM.width)
        assert abs(frames[0].timestamp - times[0]) < 1e-6
        for f, j in zip(frames, jax_frames(root)):
            assert f.timestamp == j.timestamp
            assert f.img.dtype == j.img.dtype and np.array_equal(f.img, j.img)

    def test_imu_pairing(self, euroc_root):
        root, poses, times, _ = euroc_root
        ds = datasets.EurocDataset(root, imu=True)
        frames = list(ds)
        # each frame (after the first) should carry ~10 samples at 200 Hz/20 Hz
        counts = [len(f.imu) for f in frames[1:6]]
        assert all(8 <= c <= 12 for c in counts), counts
        # gyro/accel column order: az was written as 9.81 -> accel z column
        assert abs(frames[1].imu[0, 3] - 9.81) < 1e-9
        for f, j in zip(frames, jax_frames(root, imu=True)):
            assert np.array_equal(f.imu, j.imu)


def run_cli(module, argv) -> dict:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        module.main(argv)
    return json.loads(buf.getvalue().strip().splitlines()[-1])


class TestCliDriver:
    def test_mono_run(self, euroc_root, tmp_path):
        from test_torch_slam import jax_velocity_from_previous_frame
        from orb_slam3_comments_ghr_tpu.io import run_slam as jrun_slam
        from orb_slam3_comments_ghr_torch.io import run_slam

        root, poses, times, gt = euroc_root
        args = ["--dataset", "euroc", "--root", root, "--sensor", "mono", "--n-features", "512",
                "--gt", gt]
        out = str(tmp_path / "traj.txt")
        res = run_cli(run_slam, args + ["--out", out, "--device", "cpu"])
        with jax_velocity_from_previous_frame():
            jres = run_cli(jrun_slam, args + ["--out", str(tmp_path / "jax_traj.txt")])
        assert res["frames"] == jres["frames"] == 45
        assert res["tracked"] > 15
        assert os.path.exists(out)
        lines = open(out).read().strip().splitlines()
        assert len(lines) > 15 and len(lines[0].split()) == 8
        assert abs(res["tracked"] - jres["tracked"]) <= 2, (res, jres)
        assert abs(res["keyframes"] - jres["keyframes"]) <= 2, (res, jres)
        assert abs(res["map_points"] - jres["map_points"]) <= 0.2 * jres["map_points"], (res, jres)
        assert res["ate_rmse"] < 0.05 and jres["ate_rmse"] < 0.05, (res, jres)

"""The port's auxiliary modules against the JAX package: the twins of
`tests/test_aux.py` (`TestProfiling`, the 3 YAML cases, `TestViz`,
`TestNativeLoader`) and of `tests/test_rectify_clahe.py::
TestYamlIngestion::test_yaml_ingestion`, the three dataset presets, and
`ops/lie.quat_to_mat`.

Bounds: the settings, presets and renders are the same host arithmetic, so
bit for bit (cameras, configurations, IMU calibrations, rectification maps,
PNG arrays); the stage timer prints the same table from the same samples;
the native prefetcher decodes the same arrays as the JAX package's Python
decoder; `quat_to_mat` agrees to 1e-6 (float32, another library). The
native library must build here (`ld.native`).
"""

import dataclasses
import os
import textwrap

import numpy as np
import pytest
import torch

torch.set_num_threads(1)


def same_camera(a, b):
    """Two packages' cameras: every intrinsic field equal."""
    for f in ("kind", "fx", "fy", "cx", "cy", "k1", "k2", "k3", "k4", "width", "height", "bf",
              "fps"):
        assert getattr(a, f) == getattr(b, f), f


def same_calib(a, b):
    if a is None or b is None:
        assert a is None and b is None
        return
    for f in ("Rbc", "tbc"):
        assert np.array_equal(np.asarray(getattr(a, f), np.float32),
                              np.asarray(getattr(b, f), np.float32)), f
    for f in ("noise_g", "noise_a", "walk_g", "walk_a"):
        assert float(getattr(a, f)) == float(getattr(b, f)), f


def both_settings(path: str, sensor=None):
    from orb_slam3_comments_ghr_tpu.io import config_yaml as jyaml
    from orb_slam3_comments_ghr_torch.io import config_yaml as tyaml

    t = tyaml.load_settings(path, sensor=sensor)
    j = jyaml.load_settings(path, sensor=sensor)
    same_camera(t[0], j[0])
    assert dataclasses.asdict(t[1]) == dataclasses.asdict(j[1])
    same_calib(t[2], j[2])
    return t


@pytest.fixture(scope="module")
def feature_slam():
    """tests/test_aux.py TestViz's SLAM: 12 frames of rendered features
    through the port, with the stage timer switched on and cleared first,
    and switched back after; its samples and spans come with the run."""
    from orb_slam3_comments_ghr_torch.ops import cameras
    from orb_slam3_comments_ghr_torch.system import SLAM
    from orb_slam3_comments_ghr_torch.utils import synthetic
    from orb_slam3_comments_ghr_torch.utils.config import SlamConfig
    from orb_slam3_comments_ghr_torch.utils.profiling import GLOBAL_TIMER

    was = GLOBAL_TIMER.enabled
    GLOBAL_TIMER.enabled = True
    GLOBAL_TIMER.reset()
    cam = cameras.euroc_cam0()
    world = synthetic.make_world(9, n_points=2000)
    poses = synthetic.circular_trajectory(12)
    cfg = SlamConfig(n_features=256, local_points_cap=1024,
                     local_ba_points=1024, min_init_matches=50)
    slam = SLAM(cam, cfg, device="cpu")
    feats = None
    try:
        for i, (R, t) in enumerate(poses):
            feats, _ = synthetic.render_features(world, cam, R, t, n_feat=256, seed=60 + i,
                                                 device="cpu")
            slam.track_features(feats, i * 0.05)
        samples = {k: list(v) for k, v in GLOBAL_TIMER.samples.items()}
        spans = GLOBAL_TIMER.spans()
    finally:
        GLOBAL_TIMER.enabled = was
    return cam, slam, feats, samples, spans


class TestProfiling:
    def test_stage_timer(self, capsys):
        from orb_slam3_comments_ghr_tpu.utils.profiling import StageTimer as JStageTimer
        from orb_slam3_comments_ghr_torch.utils.profiling import StageTimer

        t = StageTimer()
        with t.stage("extract"):
            sum(range(1000))
        with t.stage("extract"):
            pass
        with t.stage("local_ba"):
            pass
        s = t.stats()
        assert s["extract"]["n"] == 2
        assert s["extract"]["mean_ms"] >= 0
        t.print_time_stats()
        out = capsys.readouterr().out
        assert "extract" in out and "local_ba" in out
        # the same samples print the same table as the JAX package's
        j = JStageTimer()
        j.samples.update({k: list(v) for k, v in t.samples.items()})
        j.print_time_stats()
        t.print_time_stats()
        jout, tout = capsys.readouterr().out.split("stage", 2)[1:]
        assert jout == tout and t.stats() == j.stats()

    def test_slam_stage_sites(self, feature_slam, capsys):
        """SLAM.track_features is a `frame` span a call; process_keyframe
        times the mapper's five stages; print_time_stats reports them."""
        cam, slam, feats, samples, _ = feature_slam
        assert len(samples["frame"]) == 12
        assert 1 <= len(samples["track_map"]) <= 12
        n_kf_processed = len(samples["mp_cull"])
        assert n_kf_processed >= 1
        for k in ("mp_create", "fuse", "kf_cull"):
            assert len(samples[k]) == n_kf_processed, k
        assert 1 <= len(samples["local_ba"]) <= n_kf_processed
        slam.print_time_stats()
        out = capsys.readouterr().out
        assert "frame" in out and "track_map" in out and "local_ba" in out


class TestYamlSettings:
    def test_reference_style_yaml(self, tmp_path):
        from orb_slam3_comments_ghr_torch.utils.config import IMU_MONOCULAR

        p = tmp_path / "settings.yaml"
        p.write_text(
            "%YAML:1.0\n"
            'Camera.type: "PinHole"\n'
            "Camera.fx: 458.654\nCamera.fy: 457.296\n"
            "Camera.cx: 367.215\nCamera.cy: 248.375\n"
            "Camera.width: 752\nCamera.height: 480\nCamera.fps: 20.0\n"
            "ORBextractor.nFeatures: 1200\nORBextractor.scaleFactor: 1.2\n"
            "ORBextractor.nLevels: 8\n"
            "IMU.NoiseGyro: 1.7e-4\nIMU.NoiseAcc: 2.0e-3\n"
            "IMU.GyroWalk: 1.9e-5\nIMU.AccWalk: 3.0e-3\nIMU.Frequency: 200\n"
        )
        cam, cfg, calib = both_settings(str(p), sensor=IMU_MONOCULAR)
        assert abs(cam.fx - 458.654) < 1e-6
        assert cfg.n_features == 1200
        assert cfg.max_frames_between_kf == 20
        assert calib is not None and calib.noise_g > 0

    def test_v1_imu_extrinsics_and_stereo_baseline(self, tmp_path):
        from orb_slam3_comments_ghr_torch.utils.config import IMU_STEREO

        p = tmp_path / "v1.yaml"
        p.write_text(
            "%YAML:1.0\n"
            'File.version: "1.0"\n'
            'Camera.type: "Rectified"\n'
            "Camera1.fx: 450.0\nCamera1.fy: 450.0\n"
            "Camera1.cx: 367.0\nCamera1.cy: 248.0\n"
            "Camera.width: 752\nCamera.height: 480\nCamera.fps: 20\n"
            "Stereo.b: 0.11\n"
            "IMU.NoiseGyro: 1.7e-4\nIMU.NoiseAcc: 2.0e-3\n"
            "IMU.GyroWalk: 2.0e-5\nIMU.AccWalk: 3.0e-3\nIMU.Frequency: 200\n"
            "IMU.T_b_c1: !!opencv-matrix\n"
            "  rows: 4\n  cols: 4\n  dt: f\n"
            "  data: [0, 0, 1, 0.1,  -1, 0, 0, 0.02,  0, -1, 0, -0.03,"
            "  0, 0, 0, 1]\n"
            "ORBextractor.nFeatures: 1000\nORBextractor.scaleFactor: 1.2\n"
            "ORBextractor.nLevels: 8\n"
        )
        cam, cfg, calib = both_settings(str(p), sensor=IMU_STEREO)
        assert abs(cam.bf - 0.11 * 450.0) < 1e-6
        Rbc = np.asarray(calib.Rbc)
        assert np.allclose(Rbc, [[0, 0, 1], [-1, 0, 0], [0, -1, 0]], atol=1e-6)
        assert np.allclose(np.asarray(calib.tbc), [0.1, 0.02, -0.03], atol=1e-6)
        # walk sigmas divided by sqrt(freq): 2e-5 / sqrt(200)
        assert abs(float(calib.walk_g) - 2.0e-5 / np.sqrt(200.0)) < 1e-12

    def test_missing_required_key(self, tmp_path):
        from orb_slam3_comments_ghr_torch.io.config_yaml import load_settings

        p = tmp_path / "bad.yaml"
        p.write_text("%YAML:1.0\nCamera.fy: 1.0\n")
        with pytest.raises(KeyError, match="Camera.fx"):
            load_settings(str(p))

    def test_yaml_ingestion(self, tmp_path):
        """The raw EuRoC stereo YAML of tests/test_rectify_clahe.py: the
        returned camera is the rectified rig, its maps those of the JAX
        package."""
        from test_rectify_clahe import INTR1, INTR2
        from orb_slam3_comments_ghr_tpu.io import config_yaml as jyaml
        from orb_slam3_comments_ghr_torch.io.config_yaml import load_stereo_rig
        from orb_slam3_comments_ghr_torch.ops import cameras
        from orb_slam3_comments_ghr_torch.utils.config import STEREO

        cams = "".join(f"Camera{i}.{k}: {intr[k]}\n" for i, intr in ((1, INTR1), (2, INTR2))
                       for k in ("fx", "fy", "cx", "cy", "k1", "k2", "p1", "p2"))
        p = tmp_path / "raw_stereo.yaml"
        p.write_text(textwrap.dedent("""\
            %YAML:1.0
            File.version: "1.0"
            Camera.type: "PinHole"
            """) + cams + textwrap.dedent("""\
            Camera.width: 752
            Camera.height: 480
            Camera.fps: 20.0
            Stereo.ThDepth: 60.0
            Stereo.T_c1_c2: !!opencv-matrix
              rows: 4
              cols: 4
              dt: f
              data: [1.0, 0.0, 0.0, 0.1101,
                     0.0, 1.0, 0.0, -0.0002,
                     0.0, 0.0, 1.0, 0.0003,
                     0.0, 0.0, 0.0, 1.0]
            ORBextractor.nFeatures: 1200
            ORBextractor.scaleFactor: 1.2
            ORBextractor.nLevels: 8
            ORBextractor.iniThFAST: 20
            ORBextractor.minThFAST: 7
            """))
        cam, cfg, _ = both_settings(str(p), sensor=STEREO)
        rig = load_stereo_rig(str(p))
        assert rig is not None
        # the returned camera IS the rectified rig, bf = f * baseline
        assert cam.kind == cameras.PINHOLE
        assert abs(cam.bf - cam.fx * 0.11010005) < 1e-2
        assert rig.map_left.shape == (480, 752, 2)
        jrig = jyaml.load_stereo_rig(str(p))
        same_camera(rig.cam_rect, jrig.cam_rect)
        assert np.array_equal(rig.map_left, np.asarray(jrig.map_left))
        assert np.array_equal(rig.map_right, np.asarray(jrig.map_right))
        # mono settings from the same file are untouched (no rectification)
        cam_mono, _, _ = both_settings(str(p))
        assert abs(cam_mono.fx - INTR1["fx"]) < 1e-6


class TestViz:
    def test_draw_frame_and_map(self, feature_slam, tmp_path):
        from orb_slam3_comments_ghr_tpu.utils import viz as jviz
        from orb_slam3_comments_ghr_torch.utils import viz

        cam, slam, feats, _, _ = feature_slam
        img = np.zeros((cam.height, cam.width), np.float32)
        f_path = str(tmp_path / "frame.png")
        m_path = str(tmp_path / "map.png")
        out = viz.draw_frame(img, feats, state="OK", path=f_path)
        assert out.shape == (cam.height, cam.width, 3)
        m = viz.draw_map(slam.map, path=m_path)
        assert m.shape[2] == 3
        assert os.path.getsize(f_path) > 0 and os.path.getsize(m_path) > 0
        # the JAX package's renders of the same frame and map
        host = feats._replace(xy=feats.xy.numpy(), valid=feats.valid.numpy())
        assert np.array_equal(out, jviz.draw_frame(img, host, state="OK"))
        assert np.array_equal(m, jviz.draw_map(slam.map))


class TestNativeLoader:
    def test_euroc_with_native_prefetch(self, tmp_path):
        from orb_slam3_comments_ghr_tpu.io import datasets as jdatasets
        from orb_slam3_comments_ghr_torch.io.native_loader import PrefetchLoader

        paths = []
        for i in range(6):
            p = str(tmp_path / f"{i}.npy")
            np.save(p, np.full((40, 50), float(i), np.float32))
            paths.append(p)
        ld = PrefetchLoader(paths, n_workers=2, capacity=3)
        assert ld.native is True
        outs = list(ld)
        assert len(outs) == 6
        for i, o in enumerate(outs):
            assert o.shape == (40, 50)
            assert float(o[0, 0]) == float(i)  # strict in-order delivery
            assert np.array_equal(o, jdatasets.load_image(paths[i]))
        ld.close()


@pytest.mark.parametrize("name,args", [("euroc", ()), ("euroc", (4,)), ("tum_vi", ()),
                                       ("tum_vi", (0,)), ("tum_rgbd", ())])
def test_presets_match_jax(name, args):
    """Each preset's camera, configuration and IMU calibration equal the
    JAX package's (sensors: 4 = IMU_STEREO, 0 = MONOCULAR)."""
    from orb_slam3_comments_ghr_tpu.models import presets as jpresets
    from orb_slam3_comments_ghr_torch.models import presets

    t, j = presets.PRESETS[name](*args), jpresets.PRESETS[name](*args)
    same_camera(t[0], j[0])
    assert dataclasses.asdict(t[1]) == dataclasses.asdict(j[1])
    same_calib(t[2], j[2])


def test_smoke_fisheye_camera_is_the_preset():
    """`chip_smoke.py` phase 12 (a) takes TUM-VI's camera from the preset:
    the same camera, bit for bit, as the literal copy it replaced."""
    from orb_slam3_comments_ghr_torch.models import presets
    from orb_slam3_comments_ghr_torch.ops import cameras

    assert presets.tum_vi()[0] == cameras.Camera(
        kind=cameras.KANNALA_BRANDT8, fx=190.978477, fy=190.973307, cx=254.931706,
        cy=256.897442, k1=0.003482389402, k2=0.000715034845, k3=-0.002053236141,
        k4=0.000202936736, width=512, height=512, fps=20.0)


def test_quat_to_mat_matches_jax():
    import jax.numpy as jnp
    from orb_slam3_comments_ghr_tpu.ops import lie as jlie
    from orb_slam3_comments_ghr_torch.ops import lie

    q = np.random.default_rng(5).normal(size=(64, 4)).astype(np.float32)
    q[0] = [1.0, 0.0, 0.0, 0.0]
    R = lie.quat_to_mat(torch.from_numpy(q)).numpy()
    np.testing.assert_allclose(R, np.asarray(jlie.quat_to_mat(jnp.asarray(q))), atol=1e-6)
    np.testing.assert_allclose(R @ R.transpose(0, 2, 1), np.broadcast_to(np.eye(3), R.shape),
                               atol=1e-5)
    # and back through mat_to_quat, up to the sign
    q_back = lie.mat_to_quat(torch.from_numpy(R)).numpy()
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    np.testing.assert_allclose(np.abs((q_back * qn).sum(1)), 1.0, atol=1e-5)

"""The port's live HTTP viewer (`utils/live_viewer.py`): the twin of the 5
cases of `tests/test_live_viewer.py`, on one module fixture.

A short rendered mono sequence (24 frames at 1024 features) runs through
the port's `SLAM.track_monocular` on the CPU while the viewer serves it;
every endpoint is exercised over a real HTTP connection: the page, the
state JSON, the frame and map PNGs, the menu commands (localization
toggle) and a 404. Against the JAX package: the map PNG decodes to the
pixels of the JAX package's `viz.draw_map` of the same map, and the state
JSON has the JAX viewer's keys.
"""

import io
import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from orb_slam3_comments_ghr_torch.ops import cameras
from orb_slam3_comments_ghr_torch.system import SLAM
from orb_slam3_comments_ghr_torch.utils import synthetic
from orb_slam3_comments_ghr_torch.utils.config import SlamConfig
from orb_slam3_comments_ghr_torch.utils.live_viewer import LiveViewer

torch.set_num_threads(1)

# the keys of the JAX package's /state.json (utils/live_viewer.py _state)
JAX_STATE_KEYS = {"state", "frames_published", "fps_wall", "keyframes", "map_points", "maps",
                  "active_map", "loops", "merges", "gba_running", "localization_only",
                  "pose_Tcw_3x4"}


@pytest.fixture(scope="module")
def slam_with_viewer():
    cam = cameras.euroc_cam0()
    cfg = SlamConfig(n_features=1024, min_init_matches=60,
                     local_points_cap=2048, local_ba_points=1024,
                     max_frames_between_kf=8, async_mapping=False)
    scene = synthetic.make_textured_scene(7)
    poses = synthetic.circular_trajectory(24)
    slam = SLAM(cam, cfg, device="cpu")
    viewer = LiveViewer(slam, port=0)  # bind any free port
    port = viewer.start()
    for i, (R, t) in enumerate(poses):
        img = synthetic.render_image(scene, cam, R, t)
        slam.track_monocular(img, i * 0.05)
        viewer.publish(img)
    yield slam, viewer, port
    viewer.stop()


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
        return r.status, r.headers.get("Content-Type"), r.read()


def test_index_page(slam_with_viewer):
    _, viewer, port = slam_with_viewer
    code, ctype, body = _get(port, "/")
    assert code == 200 and "text/html" in ctype
    assert b"live viewer" in body


def test_state_json(slam_with_viewer):
    slam, viewer, port = slam_with_viewer
    code, ctype, body = _get(port, "/state.json")
    assert code == 200 and "json" in ctype
    s = json.loads(body)
    assert set(s) == JAX_STATE_KEYS
    assert s["frames_published"] == 24
    assert s["keyframes"] == slam.n_keyframes() > 0
    assert s["map_points"] == slam.n_map_points() > 0
    assert s["state"] in ("OK", "RECENTLY_LOST", "NOT_INITIALIZED")
    assert s["pose_Tcw_3x4"] is None or len(s["pose_Tcw_3x4"]) == 12


def test_frame_and_map_png(slam_with_viewer):
    from PIL import Image
    from orb_slam3_comments_ghr_tpu.utils import viz as jviz

    slam, viewer, port = slam_with_viewer
    for path in ("/frame.png", "/map.png"):
        code, ctype, body = _get(port, path)
        assert code == 200 and ctype == "image/png"
        assert body[:8] == b"\x89PNG\r\n\x1a\n"
        # decodes to a real image
        im = Image.open(io.BytesIO(body))
        assert im.size[0] > 10 and im.size[1] > 10
        if path == "/map.png":
            assert np.array_equal(np.asarray(im.convert("RGB")),
                                  jviz.draw_map(slam.map, size=480))


def test_menu_commands(slam_with_viewer):
    slam, viewer, port = slam_with_viewer
    code, _, _ = _get(port, "/cmd?op=localization_on")
    assert code == 200
    assert slam.tracker.localization_only
    _get(port, "/cmd?op=localization_off")
    assert not slam.tracker.localization_only


def test_unknown_path_404(slam_with_viewer):
    _, viewer, port = slam_with_viewer
    with pytest.raises(urllib.error.HTTPError):
        _get(port, "/nope")

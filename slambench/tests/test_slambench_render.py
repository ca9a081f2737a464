"""The benchmark's PyTorch room renderer against the port's NumPy
`utils.gt_replay.render_room`, on the CPU at a small size: the same scene
and poses give the same pixels."""

import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from slambench import generate  # noqa: E402
from orb_slam3_comments_ghr_torch.ops import cameras  # noqa: E402
from orb_slam3_comments_ghr_torch.utils import gt_replay  # noqa: E402


def test_slambench_render_matches_render_room():
    mo = generate.load_motion(generate.HERE / "traffic" / "motions" / "mh01_stand_in.tum")
    scene = generate.make_room_scene(7, mo.p_wc, tex_size=256)
    cam = {"fx": 43.52, "fy": 43.52, "cx": 37.25, "cy": 25.5, "width": 76, "height": 48}
    port_cam = cameras.Camera(kind=cameras.PINHOLE, fx=cam["fx"], fy=cam["fy"], cx=cam["cx"],
                              cy=cam["cy"], width=cam["width"], height=cam["height"])
    frames = [0, 940, 1500, 2500, 3600]
    got = generate.render_room_torch(scene, torch.from_numpy(np.stack(scene.textures)), cam,
                                     torch.from_numpy(mo.R_cw[frames]),
                                     torch.from_numpy(mo.t_cw[frames])).numpy()
    for k, f in enumerate(frames):
        want = gt_replay.render_room(scene, port_cam, mo.R_cw[f], mo.t_cw[f])
        assert want.shape == got[k].shape
        assert np.array_equal(got[k], want), (f, int((got[k] != want).sum()))
        assert want.std() > 5.0  # textured, not the background

"""The inertial references against the port on small problems on the CPU.

The inertial local BA (`reference.viba_lm`) against
`optim.vi_ba.vi_bundle_adjust`: the same keyframe chain, points and
preintegrations, the same iterations; the port's result must cost what the
reference's does, by the reference's cost function, and the reference in
bfloat16 (the control) must cost more. The VI refinement
(`reference.vi_refine_lm`) against `optim.inertial.pose_inertial_optimize`
on one keyframe link: the same body position to a micrometre, the
control's off by more."""

import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from slambench import generate  # noqa: E402
from slambench import reference as ref  # noqa: E402
from orb_slam3_comments_ghr_torch.ops import cameras  # noqa: E402
from orb_slam3_comments_ghr_torch.optim import imu as imu_mod  # noqa: E402
from orb_slam3_comments_ghr_torch.optim import inertial, pose_opt  # noqa: E402
from orb_slam3_comments_ghr_torch.optim import vi_ba  # noqa: E402

CAM = {"fx": 435.2, "fy": 435.2, "cx": 367.45, "cy": 252.2, "bf": 47.906}
W, H = 752, 480


def _problem(seed: int, K: int = 5, P: int = 96):
    rng = np.random.default_rng(seed)
    mo = generate.load_motion(generate.HERE / "traffic" / "motions" / "mh01_stand_in.tum")
    frames = 1000 + 5 * np.arange(K)
    seg = slice(frames[0] - 10, frames[-1] + 10)
    rows = generate.synthesize_imu(mo.times[seg], mo.p_wc[seg], mo.q_wc[seg], noise_g=2.4e-3,
                                   noise_a=2.8e-2, seed=seed)
    calib = imu_mod.default_calib()
    bias = torch.zeros(6)
    pres = []
    for k in range(K - 1):
        t0, t1 = mo.times[frames[k]], mo.times[frames[k + 1]]
        r = rows[(rows[:, 0] > t0) & (rows[:, 0] <= t1)]
        dts = np.diff(np.concatenate([[t0], r[:, 0]]))
        pres.append(imu_mod.preintegrate(torch.tensor(r[:, 1:4], dtype=torch.float32),
                                         torch.tensor(r[:, 4:7], dtype=torch.float32),
                                         torch.tensor(dts, dtype=torch.float32), bias, calib))
    n = max(p.acc.shape[0] for p in pres)

    def pad(x):
        return torch.cat([x, torch.zeros((n - x.shape[0],) + x.shape[1:])]) if x.shape[0] < n \
            else x
    pre = imu_mod.Preintegrated(*(torch.stack([pad(getattr(p, f)) if f in ("acc", "gyr", "dts")
                                               else getattr(p, f) for p in pres])
                                  for f in imu_mod.Preintegrated._fields))

    R_wc, p_wc = np.transpose(mo.R_cw[frames], (0, 2, 1)), mo.p_wc[frames]
    vel = (mo.p_wc[frames + 1] - mo.p_wc[frames - 1]) / (mo.times[frames + 1]
                                                         - mo.times[frames - 1])[:, None]
    # points 2-6 m in front of the first camera, seen where they project
    d = rng.uniform(2.0, 6.0, P)
    uv = np.stack([rng.uniform(40, W - 40, P), rng.uniform(40, H - 40, P)], 1)
    rays = np.stack([(uv[:, 0] - CAM["cx"]) / CAM["fx"], (uv[:, 1] - CAM["cy"]) / CAM["fy"],
                     np.ones(P)], 1)
    X = (rays * d[:, None]) @ R_wc[0].T + p_wc[0]
    pc = np.einsum("kji,pkj->pki", R_wc, X[:, None, :] - p_wc[None])            # (P,K,3)
    z = pc[..., 2]
    u = CAM["fx"] * pc[..., 0] / z + CAM["cx"]
    v = CAM["fy"] * pc[..., 1] / z + CAM["cy"]
    seen = (z > 0.1) & (u > 0) & (u < W) & (v > 0) & (v < H)
    stereo = rng.random((P, K)) < 0.5
    obs_uv = np.stack([u, v], -1) + rng.normal(0, 0.7, (P, K, 2))
    obs_ur = np.where(stereo, u - CAM["bf"] / z + rng.normal(0, 0.7, (P, K)), -1.0)
    obs_uv[:7, 1] += 30.0  # a few outliers for the Huber kernel

    def rot(n, s):
        return np.stack([cv_exp(w) for w in rng.normal(0, s, (n, 3))])

    Rwb = R_wc @ rot(K, 0.01)
    Rwb[0] = R_wc[0]
    pwb = p_wc + np.concatenate([np.zeros((1, 3)), rng.normal(0, 0.02, (K - 1, 3))])
    f32 = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32)
    prob = vi_ba.VIBAProblem(
        Rwb=f32(Rwb), pwb=f32(pwb), vel=f32(vel + rng.normal(0, 0.05, vel.shape)),
        bias=torch.zeros((K, 6)), fixed=torch.arange(K) < 1, Rcb=torch.eye(3),
        tcb=torch.zeros(3), p=f32(X + rng.normal(0, 0.03, X.shape)),
        p_valid=torch.ones(P, dtype=torch.bool), obs_cam=torch.arange(K).repeat(P, 1),
        obs_uv=f32(obs_uv), obs_ur=f32(obs_ur),
        obs_level=torch.tensor(rng.integers(0, 4, (P, K))), obs_valid=torch.tensor(seen),
        pre=pre, pre_valid=torch.ones(K - 1, dtype=torch.bool))
    cam = cameras.Camera(kind=cameras.PINHOLE, fx=CAM["fx"], fy=CAM["fy"], cx=CAM["cx"],
                         cy=CAM["cy"], width=W, height=H, bf=CAM["bf"], fps=20.0)
    plain = prob._asdict()
    plain["pre"] = pre._asdict()
    return cam, prob, plain


def cv_exp(w):
    return ref.so3_exp(torch.tensor(w)).numpy()


def test_inertial_ba_reference_follows_the_port():
    for seed in (1, 2):
        cam, prob, plain = _problem(seed)
        got = vi_ba.vi_bundle_adjust(cam, prob, iters=10)[:5]
        want = ref.viba_lm(CAM, plain, iters=10)
        start = ref.viba_cost(CAM, plain, tuple(plain[k] for k in ("Rwb", "pwb", "vel", "bias",
                                                                   "p")))
        c_ref, c_got = ref.viba_cost(CAM, plain, want), ref.viba_cost(CAM, plain, got)
        assert c_ref < 0.2 * start
        assert abs(c_got - c_ref) / c_ref < 1e-4, (c_got, c_ref)
        ctrl = ref.viba_lm(CAM, plain, iters=10, dtype=torch.bfloat16)
        assert (ref.viba_cost(CAM, plain, ctrl) - c_ref) / c_ref > 1e-2


def _refine_problem(seed: int):
    """The second keyframe of `_problem`'s chain as the tracked frame: its
    perturbed state, the first keyframe's true state, the link's
    preintegration and the points it sees, a few with outliers."""
    cam, prob, _ = _problem(seed, K=2)
    st = lambda i, R, p: inertial.VIState(Rwb=R, pwb=p, vel=prob.vel[i], bias=prob.bias[i])
    prev = st(0, prob.Rwb[0], prob.pwb[0])
    state0 = st(1, prob.Rwb[1], prob.pwb[1])
    pre = imu_mod.Preintegrated(*(x[0] for x in prob.pre))
    obs = pose_opt.PoseObs(p_world=prob.p, uv=prob.obs_uv[:, 1],
                           u_right=torch.full((prob.p.shape[0],), -1.0),
                           level=prob.obs_level[:, 1], valid=prob.obs_valid[:, 1])
    return cam, state0, prev, pre, obs, (prob.Rcb, prob.tcb)


def test_vi_refinement_reference_follows_the_port():
    for seed in (1, 2):
        cam, state0, prev, pre, obs, Tcb = _refine_problem(seed)
        got = inertial.pose_inertial_optimize(cam, state0, prev, pre, obs, Tcb, None)[0]
        args = (state0._asdict(), prev._asdict(), pre._asdict(), obs._asdict(), Tcb)
        want = ref.vi_refine_lm(CAM, *args)
        gap = float(torch.linalg.norm(got.pwb.double() - want[1]))
        assert float(torch.linalg.norm(want[1] - state0.pwb.double())) > 1e-3
        assert gap < 1e-6, gap
        ctrl = ref.vi_refine_lm(CAM, *args, dtype=torch.bfloat16)
        assert float(torch.linalg.norm(ctrl[1] - want[1])) > 1e-4

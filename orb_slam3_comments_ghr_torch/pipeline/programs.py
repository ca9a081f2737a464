"""The per-frame monocular tracking program.

Port of `LocalPoints`, `TrackResult`, `_frustum_gate`,
`track_against_points`, `extract_only`, `track_only` and
`extract_and_track` from `orb_slam3_comments_ghr_tpu/pipeline/programs.py`:
ORB extraction, then frustum gate, windowed Hamming top-2 with ratio test,
duplicate resolution, rotation histogram and the 4-round Huber pose LM
(Tracking.cc TrackLocalMap / SearchByProjection / PoseOptimization).

PyTorch runs eagerly, so there is no jit and `track_only` is
`track_against_points` itself. Everything runs on the device of its inputs.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..frontend.batched import extract_batched
from ..ops import cameras, lie, matching
from ..ops.window_match import window_match
from ..optim import pose_opt


class LocalPoints(NamedTuple):
    """Candidate map points, padded to L."""

    pos: torch.Tensor       # (L,3)
    desc: torch.Tensor      # (L,8) int32
    normal: torch.Tensor    # (L,3)
    min_dist: torch.Tensor  # (L,)
    max_dist: torch.Tensor  # (L,)
    valid: torch.Tensor     # (L,) bool
    angle: torch.Tensor     # (L,) keypoint angle of the distinctive observation


class TrackResult(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    match_feat: torch.Tensor  # (L,) feature index per point, -1 if unmatched
    inlier: torch.Tensor      # (L,) bool: matched AND pose-opt inlier
    visible: torch.Tensor     # (L,) bool: passed the frustum gate
    n_inliers: torch.Tensor


def _frustum_gate(cam, R, t, pts: LocalPoints, n_levels: int, scale: float):
    """isInFrustum (Frame.cc:676): image bounds, distance band, viewing
    angle; returns (visible, predicted uv, predicted level, search radius)."""
    pc = lie.se3_apply(R, t, pts.pos)
    uv = cameras.project(cam, pc)
    center = -(R.T @ t)
    d = pts.pos - center
    dist = torch.linalg.norm(d, dim=-1)
    in_band = (dist > 0.8 * pts.min_dist) & (dist < 1.2 * pts.max_dist)
    view_cos = torch.sum(d * pts.normal, dim=-1) / torch.clamp_min(dist, 1e-9)
    visible = (
        pts.valid & (pc[..., 2] > 0.1) & cameras.in_image(cam, uv) & in_band & (view_cos > 0.5)
    )
    # predicted octave from distance (MapPoint::PredictScale); log(scale) in
    # f32, as jnp.log takes it
    ratio = pts.max_dist / torch.clamp_min(dist, 1e-9)
    log_scale = torch.log(torch.tensor(scale, dtype=torch.float32, device=R.device))
    level = torch.ceil(torch.log(torch.clamp_min(ratio, 1e-9)) / log_scale)
    level = torch.clamp(level, 0, n_levels - 1).to(torch.int32)
    # RadiusByViewingCos (ORBmatcher.cc:245)
    radius = torch.where(view_cos > 0.998, 2.5, 4.0) * torch.pow(scale, level.to(torch.float32))
    return visible, uv, level, radius


def track_against_points(
    cam: cameras.Camera,
    feats,
    pts: LocalPoints,
    R0: torch.Tensor,
    t0: torch.Tensor,
    th: float = 1.0,
    n_levels: int = 8,
    scale: float = 1.2,
    iters_per_round: int = 10,
) -> TrackResult:
    visible, uv_pred, level_pred, radius = _frustum_gate(cam, R0, t0, pts, n_levels, scale)
    # the window match encodes visibility as radius -1, as the TPU kernel's
    # caller does; that equals the XLA path's `window_mask & visible`
    idx, best, second = window_match(
        pts.desc,
        uv_pred,
        torch.where(visible, radius * th, -1.0),
        (level_pred - 1).to(torch.float32),
        (level_pred + 1).to(torch.float32),
        feats.desc,
        feats.xy,
        feats.level.to(torch.float32),
        feats.valid.to(torch.float32),
    )
    ok = matching.ratio_test(best, second, matching.TH_HIGH, 0.8)
    ok = matching.resolve_duplicates(idx, best, ok, feats.xy.shape[0])
    # rotation-histogram consistency between each point's reference-KF
    # keypoint angle and its matched frame keypoint
    ok = matching.rotation_consistency(pts.angle, feats.angle, idx, ok)

    sel = idx.long()
    obs = pose_opt.PoseObs(
        p_world=pts.pos,
        uv=feats.xy[sel],
        u_right=feats.u_right[sel],
        level=feats.level[sel],
        valid=ok,
    )
    R, t, inlier, n = pose_opt.optimize_pose(cam, R0, t0, obs, iters_per_round=iters_per_round)
    return TrackResult(
        R=R, t=t, match_feat=torch.where(ok, idx, -1), inlier=inlier & ok,
        visible=visible, n_inliers=n,
    )


track_only = track_against_points


def extract_only(
    extract_cam: cameras.Camera,
    img: torch.Tensor,
    n_features: int = 1024,
    n_levels: int = 8,
    scale: float = 1.2,
    ini_th: float = 20.0,
    min_th: float = 7.0,
    undistort: bool = False,
):
    """Extraction half of the per-frame program. `undistort` (fisheye) is
    not ported yet and must be False."""
    if undistort:
        raise NotImplementedError("fisheye undistortion is not ported yet")
    return extract_batched(
        img, n_features=n_features, n_levels=n_levels, scale=scale,
        ini_th=ini_th, min_th=min_th,
    )


def extract_and_track(
    extract_cam: cameras.Camera,
    geom_cam: cameras.Camera,
    img: torch.Tensor,
    pts: LocalPoints,
    R0: torch.Tensor,
    t0: torch.Tensor,
    n_features: int = 1024,
    n_levels: int = 8,
    scale: float = 1.2,
    ini_th: float = 20.0,
    min_th: float = 7.0,
    th: float = 1.0,
    undistort: bool = False,
):
    """The per-frame program: ORB extraction + frustum-gated projection
    matching + pose LM. Returns (Features, TrackResult)."""
    feats = extract_only(
        extract_cam, img, n_features=n_features, n_levels=n_levels, scale=scale,
        ini_th=ini_th, min_th=min_th, undistort=undistort,
    )
    res = track_against_points(geom_cam, feats, pts, R0, t0, th=th, n_levels=n_levels, scale=scale)
    return feats, res

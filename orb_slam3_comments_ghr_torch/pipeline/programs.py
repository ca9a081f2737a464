"""The per-frame tracking programs and the mapper's programs.

Port of `orb_slam3_comments_ghr_tpu/pipeline/programs.py`:
- per frame: ORB extraction, then frustum gate, windowed Hamming top-2 with
  ratio test, duplicate resolution, rotation histogram and the 4-round Huber
  pose LM (Tracking.cc TrackLocalMap / SearchByProjection /
  PoseOptimization): `extract_only`, `track_against_points`,
  `extract_and_track`; for a stereo pair both extractions and the row
  matcher come first (`extract_stereo_only`, `extract_and_track_stereo`).
  With `undistort` (a fisheye camera) the left keypoints are mapped to the
  virtual pinhole after extraction; a non-rectified fisheye pair gets its
  depths from `fisheye_stereo_depth` instead of the row matcher;
- per keyframe: epipolar matching and triangulation against the covisible
  neighbours (`map_new_points_multi`) and the projection fuse into them
  (`fuse_project_multi`).

The projection searches of tracking and fuse go through `window_match`, the
hand-written kernel on CUDA tensors.

PyTorch runs eagerly, so there is no jit and `track_only` is
`track_against_points` itself; the deep pipeline seeds it with
`chain_seed` from the previous frame's result on the device. Everything
runs on the device of its inputs.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..frontend import stereo
from ..frontend.batched import extract_batched
from ..ops import cameras, lie, matching, triangulate
from ..ops.window_match import window_match
from ..optim import pose_opt
from ..utils.profiling import GLOBAL_TIMER


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
    lm_graph: pose_opt.PoseLMGraph | None = None,
) -> TrackResult:
    """TrackLocalMap: the `track_map` span, with the pose LM its `pose_lm`
    child (the span's self time is the window match and its checks). The
    LM runs through `lm_graph` (the tracker's `PoseLMGraph`) where one is
    given, else eagerly."""
    with GLOBAL_TIMER.stage("track_map"):
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
        with GLOBAL_TIMER.stage("pose_lm"):
            lm = pose_opt.optimize_pose if lm_graph is None else lm_graph
            R, t, inlier, n = lm(cam, R0, t0, obs, iters_per_round=iters_per_round)
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
    """Extraction half of the per-frame program; with `undistort` the
    keypoints are mapped to the virtual pinhole of `extract_cam` (padded
    slots too: they stay finite and masked)."""
    with GLOBAL_TIMER.stage("extract"):
        feats = extract_batched(
            img, n_features=n_features, n_levels=n_levels, scale=scale,
            ini_th=ini_th, min_th=min_th,
        )
        return _undistorted(extract_cam, feats) if undistort else feats


def _undistorted(cam: cameras.Camera, feats):
    return feats._replace(xy=cameras.undistort_points(cam, feats.xy))


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
    lm_graph: pose_opt.PoseLMGraph | None = None,
):
    """The per-frame program: ORB extraction + frustum-gated projection
    matching + pose LM. Returns (Features, TrackResult)."""
    feats = extract_only(
        extract_cam, img, n_features=n_features, n_levels=n_levels, scale=scale,
        ini_th=ini_th, min_th=min_th, undistort=undistort,
    )
    res = track_against_points(geom_cam, feats, pts, R0, t0, th=th, n_levels=n_levels, scale=scale,
                               lm_graph=lm_graph)
    return feats, res


def extract_stereo_only(
    extract_cam: cameras.Camera,
    img_l: torch.Tensor,
    img_r: torch.Tensor,
    n_features: int = 1024,
    n_levels: int = 8,
    scale: float = 1.2,
    ini_th: float = 20.0,
    min_th: float = 7.0,
    undistort: bool = False,
):
    """Extraction half of the stereo per-frame program: both extractions
    (the reference runs them on two threads, Frame.cc stereo constructor),
    then the row matcher, which fills the left features' u_right and depth;
    with `undistort` the left keypoints are then undistorted."""
    kw = dict(n_features=n_features, n_levels=n_levels, scale=scale, ini_th=ini_th, min_th=min_th)
    with GLOBAL_TIMER.stage("extract"):
        fl = extract_batched(img_l, **kw)
    with GLOBAL_TIMER.stage("extract"):
        fr = extract_batched(img_r, **kw)
    with GLOBAL_TIMER.stage("stereo_match"):
        u_right, depth = stereo.stereo_match(extract_cam, fl, fr, img_l.to(torch.float32),
                                             img_r.to(torch.float32), scale=scale)
        fl = fl._replace(u_right=u_right, depth=depth)
        return _undistorted(extract_cam, fl) if undistort else fl


def chain_seed(prev_R, prev_t, prev_n, vR, vt, R0, t0, min_matches: int):
    """Pose seed of the deep pipeline: the previous frame's track result,
    still on the device, advanced one velocity step (vR, vt), where that
    frame tracked at least `min_matches` inliers; else the host prediction
    (R0, t0). A few element-wise operations, with no host round trip."""
    good = prev_n >= min_matches
    return torch.where(good, vR @ prev_R, R0), torch.where(good, vR @ prev_t + vt, t0)


def extract_and_track_stereo(
    extract_cam: cameras.Camera,
    geom_cam: cameras.Camera,
    img_l: torch.Tensor,
    img_r: torch.Tensor,
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
    lm_graph: pose_opt.PoseLMGraph | None = None,
):
    """The stereo per-frame program: both extractions, the row matcher,
    then projection matching and the pose LM, with no host sync between.
    Returns (left Features, TrackResult)."""
    fl = extract_stereo_only(
        extract_cam, img_l, img_r, n_features=n_features, n_levels=n_levels, scale=scale,
        ini_th=ini_th, min_th=min_th, undistort=undistort,
    )
    res = track_against_points(geom_cam, fl, pts, R0, t0, th=th, n_levels=n_levels, scale=scale,
                               lm_graph=lm_graph)
    return fl, res


def epipolar_match(cam: cameras.Camera, desc1, xy1, level1, free1,
                   desc2, xy2, level2, free2, R12, t12):
    """SearchForTriangulation (ORBmatcher.cc:1045): match the unassociated
    features of two keyframes inside the epipolar band (squared point-line
    distance < 3.84 sigma^2 of the second keypoint's octave), TH_LOW, ratio
    0.6, one match per second-view feature. The band is not a window, so
    this runs the plain masked matcher. Returns (idx, ok)."""
    K = cameras.camera_matrix(cam, xy1.device)
    Kinv = torch.linalg.inv_ex(K)[0]
    F = Kinv.T @ (lie.hat(t12) @ R12) @ Kinv  # x1^T F x2 = 0
    lines2 = _homog(xy1) @ F                   # (N1,3) lines in image 2
    num = lines2 @ _homog(xy2).T
    den = torch.clamp_min(lines2[:, 0:1] ** 2 + lines2[:, 1:2] ** 2, 1e-12)
    sigma2 = (1.2 ** level2.to(torch.float32)) ** 2
    mask = (num * num / den < 3.84 * sigma2[None, :]) & free1[:, None] & free2[None, :]
    idx, dist, ok = matching.search_by_window(desc1, desc2, mask, th=matching.TH_LOW, ratio=0.6)
    return idx, matching.resolve_duplicates(idx, dist, ok, desc2.shape[0])


def _homog(x):
    return torch.cat([x, torch.ones_like(x[:, :1])], dim=-1)


def fisheye_stereo_depth(cam1: cameras.Camera, cam2: cameras.Camera,
                         xy1, level1, desc1, valid1, xy2, level2, desc2, valid2, R12, t12):
    """KannalaBrandt8::matchAndtriangulate (KannalaBrandt8.cpp:438) for a
    non-rectified pair, on keypoints already undistorted to the virtual
    pinholes cam1 (left) and cam2 (right); x_l = R12 x_r + t12. Matching:
    the right keypoints within the epipolar band of each left one (squared
    point-line distance < 3.84 sigma^2 of the right octave), TH_LOW, ratio
    0.7, one left match per right keypoint. Then DLT triangulation in the
    left frame, cheirality (z > 0.05 in both), and the reprojection gates
    (< 5.991 px^2 left, < 5.991 sigma^2 right). Returns (depth, right_idx,
    matched) per left keypoint, depth -1 where not matched. The band is not
    a window, so this is the plain masked matcher (no kernel)."""
    dev = xy1.device
    K1, K2 = cameras.camera_matrix(cam1, dev), cameras.camera_matrix(cam2, dev)
    F = torch.linalg.inv_ex(K1)[0].T @ (lie.hat(t12) @ R12) @ torch.linalg.inv_ex(K2)[0]
    lines2 = _homog(xy1) @ F                    # x1^T F x2 = 0
    num = lines2 @ _homog(xy2).T
    den = torch.clamp_min(lines2[:, 0:1] ** 2 + lines2[:, 1:2] ** 2, 1e-12)
    sigma2 = (1.2 ** level2.to(torch.float32)) ** 2
    mask = (num * num / den < 3.84 * sigma2[None, :]) & valid1[:, None] & valid2[None, :]
    idx, dist, ok = matching.search_by_window(desc1, desc2, mask, th=matching.TH_LOW, ratio=0.7)
    ok = matching.resolve_duplicates(idx, dist, ok, xy2.shape[0])

    # in the left frame: P1 = K1 [I|0], the right camera at R21 = R12^T,
    # t21 = -R12^T t12
    R21 = R12.T
    t21 = -R21 @ t12
    P1 = triangulate.projection_matrix(K1, torch.eye(3, device=dev), torch.zeros(3, device=dev))
    P2 = triangulate.projection_matrix(K2, R21, t21)
    sel = idx.long()
    xy2m = xy2[sel]
    X = triangulate.triangulate(P1, P2, xy1, xy2m)
    Xr = X @ R21.T + t21
    e1 = torch.sum((cameras.project(cam1, X) - xy1) ** 2, -1)
    e2 = torch.sum((cameras.project(cam2, Xr) - xy2m) ** 2, -1)
    good = (ok & (X[..., 2] > 0.05) & (Xr[..., 2] > 0.05) & torch.isfinite(X).all(-1)
            & (e1 < 5.991) & (e2 < 5.991 * sigma2[sel]))
    return torch.where(good, X[..., 2], -1.0), idx, good


def triangulate_matches(cam: cameras.Camera, R1, t1, R2, t2, uv1, uv2, level1, level2, ok,
                        ur1, ur2, scale: float = 1.2):
    """Triangulate candidate pairs and apply CreateNewMapPoints' gates
    (LocalMapping.cc:640-930): parallax, cheirality, per-view chi2 (5.991
    mono / 7.8 stereo), scale consistency. Returns (world points, good)."""
    K = cameras.camera_matrix(cam, uv1.device)
    X = triangulate.triangulate(triangulate.projection_matrix(K, R1, t1),
                                triangulate.projection_matrix(K, R2, t2), uv1, uv2)
    return X, _triangulation_gates(cam, X, R1, t1, R2, t2, uv1, uv2, level1, level2, ok, ur1,
                                   ur2, scale)


def _triangulation_gates(cam, X, R1, t1, R2, t2, uv1, uv2, level1, level2, ok, ur1, ur2,
                         scale: float):
    """`triangulate_matches`' gates on the points X."""
    def checks(Rk, tk, uvk, urk, lvlk):
        pc = lie.se3_apply(Rk, tk, X)
        z = pc[..., 2]
        uv_hat = cameras.project(cam, pc)
        sigma2 = scale ** (2.0 * lvlk.to(torch.float32))
        e2 = torch.sum((uvk - uv_hat) ** 2, dim=-1)
        is_stereo = urk >= 0
        ur_hat = cameras.stereo_right_u(cam, uv_hat[..., 0], torch.clamp_min(z, 1e-6))
        e2s = e2 + torch.where(is_stereo, (urk - ur_hat) ** 2, 0.0)
        return (z > 0) & (e2s < torch.where(is_stereo, 7.8, 5.991) * sigma2)

    ok1 = checks(R1, t1, uv1, ur1, level1)
    ok2 = checks(R2, t2, uv2, ur2, level2)
    # parallax between the rays, and scale consistency (ratioDist against
    # ratioFactor = 1.5 * scale)
    r1v = X + R1.T @ t1  # X - centre 1
    r2v = X + R2.T @ t2
    d1 = torch.linalg.norm(r1v, dim=-1)
    d2 = torch.linalg.norm(r2v, dim=-1)
    cosp = torch.sum(r1v * r2v, -1) / torch.clamp_min(d1 * d2, 1e-12)
    ratio_dist = d2 / torch.clamp_min(d1, 1e-9)
    ratio_octave = scale ** (level1.to(torch.float32) - level2.to(torch.float32))
    rf = 1.5 * scale
    scale_ok = (ratio_dist * rf > ratio_octave) & (ratio_dist < ratio_octave * rf)
    return ok & ok1 & ok2 & (cosp < 0.9998) & scale_ok & torch.isfinite(X).all(-1)


def _pair_rows(cam, desc1, xy1, level1, free1, R1, t1, desc2, xy2, level2, free2, R2, t2):
    """One neighbour's epipolar match and the DLT design matrices of its
    candidate pairs: (idx, ok, A (N,4,4))."""
    R12 = R1 @ R2.T
    idx, ok = epipolar_match(cam, desc1, xy1, level1, free1, desc2, xy2, level2, free2,
                             R12, t1 - R12 @ t2)
    K = cameras.camera_matrix(cam, xy1.device)
    A = triangulate.dlt_rows(triangulate.projection_matrix(K, R1, t1),
                             triangulate.projection_matrix(K, R2, t2), xy1, xy2[idx.long()])
    return idx, ok, A


def _pair_points(cam, Vh, R1, t1, R2, t2, xy1, xy2, level1, level2, ur1, ur2, idx, ok,
                 scale: float):
    """One neighbour's points from the design matrices' SVD, and their
    gates: (X, good)."""
    sel = idx.long()
    X = triangulate.dlt_point(Vh)
    return X, _triangulation_gates(cam, X, R1, t1, R2, t2, xy1, xy2[sel], level1, level2[sel],
                                   ok, ur1, ur2[sel], scale)


def map_new_points_multi(cam: cameras.Camera, desc1, xy1, level1, ur1, free1, R1, t1,
                         desc2s, xy2s, level2s, ur2s, free2s, R2s, t2s, scale: float = 1.2,
                         graphs=None):
    """CreateNewMapPoints over the covisible neighbours (stacked on a
    leading axis B): epipolar matching + triangulation + gates per
    neighbour, as `epipolar_match` and `triangulate_matches` compute them.
    Returns (idx (B,N), X (B,N,3), good (B,N)). With `graphs` (the mapping
    worker's `GraphCache`) each neighbour's match and design matrices, and
    its gates, are replayed from two CUDA graphs on the card, the SVD
    between them eager: eager, they are ~190 small kernels a neighbour."""
    run = graphs if graphs is not None else (lambda fn, key, *args: fn(*args))
    out = []
    for desc2, xy2, level2, ur2, free2, R2, t2 in zip(desc2s, xy2s, level2s, ur2s, free2s, R2s, t2s):
        idx, ok, A = run(lambda *a: _pair_rows(cam, *a), ("new_points.rows", cam),
                         desc1, xy1, level1, free1, R1, t1, desc2, xy2, level2, free2, R2, t2)
        Vh = torch.linalg.svd(A).Vh
        X, good = run(lambda *a: _pair_points(cam, *a, scale), ("new_points.gates", cam, scale),
                      Vh, R1, t1, R2, t2, xy1, xy2, level1, level2, ur1, ur2, idx, ok)
        # a graph's outputs are overwritten by its next replay
        out.append((idx, X, good) if graphs is None else (idx.clone(), X.clone(), good.clone()))
    return tuple(torch.stack(parts) for parts in zip(*out))


def fuse_project(cam: cameras.Camera, R, t, pts: LocalPoints,
                 feat_xy, feat_level, feat_desc, feat_valid, feat_mp,
                 n_levels: int = 8, scale: float = 1.2):
    """ORBmatcher::Fuse (ORBmatcher.cc:1330): project points into a
    keyframe and take the best feature within radius 3 scale^level and the
    octave band level +- 1 (TH_LOW, no ratio), one point per feature.
    Returns (idx, ok, existing): `existing` is the map point already on
    that feature (-1 if none); the host owns Replace().

    The search is the window match's function: it launches the kernel on
    CUDA tensors, with invisible points at radius -1."""
    visible, uv_pred, level_pred, _ = _frustum_gate(cam, R, t, pts, n_levels, scale)
    radius = 3.0 * torch.pow(scale, level_pred.to(torch.float32))
    idx, best, second = window_match(
        pts.desc, uv_pred, torch.where(visible, radius, -1.0),
        (level_pred - 1).to(torch.float32), (level_pred + 1).to(torch.float32),
        feat_desc, feat_xy, feat_level.to(torch.float32), feat_valid.to(torch.float32),
    )
    ok = matching.ratio_test(best, second, matching.TH_LOW, 1.0)
    ok = matching.resolve_duplicates(idx, best, ok, feat_xy.shape[0])
    return idx, ok, feat_mp[idx.long()]


def fuse_project_multi(cam: cameras.Camera, Rs, ts, pts: LocalPoints,
                       feat_xys, feat_levels, feat_descs, feat_valids, feat_mps,
                       n_levels: int = 8, scale: float = 1.2):
    """SearchInNeighbors' Fuse into each neighbour keyframe (stacked on a
    leading axis B), one window-match launch per neighbour. Returns (idx,
    ok, existing), each (B, L)."""
    out = [fuse_project(cam, *per_kf, pts, *feat, n_levels=n_levels, scale=scale)
           for per_kf, feat in zip(zip(Rs, ts), zip(feat_xys, feat_levels, feat_descs,
                                                    feat_valids, feat_mps))]
    return tuple(torch.stack(parts) for parts in zip(*out))

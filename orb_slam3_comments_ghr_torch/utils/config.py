"""Typed configuration tree (replaces the reference's Settings YAML loader,
src/Settings.cc — same knobs, dataclass form; YAML ingestion in io.config).

Copied from `orb_slam3_comments_ghr_tpu/utils/config.py` (its fields
unchanged), so the port needs no JAX. The port runs all six sensors, with
loop closing on or off, with a pinhole or a KB8 fisheye camera, shards
the whole-map BA over the ranks of a `torch.distributed` world with
`dba_devices != 0` (the world's ranks stand for the JAX package's
devices), and with `async_mapping` runs the mapper and the loop closer on
a worker thread."""

from __future__ import annotations

import dataclasses

MONOCULAR = 0
STEREO = 1
RGBD = 2
IMU_MONOCULAR = 3
IMU_STEREO = 4
IMU_RGBD = 5


@dataclasses.dataclass
class SlamConfig:
    sensor: int = MONOCULAR
    # ORB extractor (A.1)
    n_features: int = 1024
    n_levels: int = 8
    scale_factor: float = 1.2
    ini_th_fast: float = 20.0
    min_th_fast: float = 7.0
    # matching / tracking (A.3)
    local_points_cap: int = 4096
    min_init_matches: int = 100
    min_track_matches: int = 10
    min_local_inliers: int = 30
    max_frames_between_kf: int = 20       # = fps (mMaxFrames)
    min_frames_between_kf: int = 0
    kf_ref_ratio: float = 0.9             # thRefRatio for mono
    # mapping (A.4)
    triangulation_neighbors: int = 5
    mp_cull_found_ratio: float = 0.25
    local_ba_kfs: int = 10
    local_ba_fixed_cap: int = 22
    local_ba_points: int = 4096
    local_ba_iters: int = 10
    kf_cull_redundancy: float = 0.9
    # place recognition
    voc_path: str | None = None          # vocabulary .npz; None = the shipped
                                         # default (retrieval/default_voc.npz,
                                         # 10k words). A k=10 L=5 100k-word
                                         # tree (reference scale,
                                         # TemplatedVocabulary.h) ships as
                                         # orb_slam3_comments_ghr_torch/
                                         # retrieval/voc_100k.npz; compare
                                         # the two trees' retrieval with
                                         # orb_slam3_comments_ghr_torch/
                                         # scripts/eval_vocabulary.py
    # map capacities
    max_kf: int = 512
    max_mp: int = 40000
    obs_cap: int = 16
    # stereo
    depth_th_factor: float = 35.0         # ThDepth: close-point gate = bf/fx * factor
    enable_loop_closing: bool = True
    async_mapping: bool = False          # LocalMapping/LoopClosing in a worker
                                         # thread (the reference's pipeline
                                         # parallelism); off = deterministic
    dba_devices: int = 0                 # distributed full-map BA mesh size
                                         # (SURVEY §2.3 P6/§5.8): 0 = off,
                                         # -1 = all local devices, N = first N.
                                         # When >=2 devices resolve, the
                                         # mapper's full-map GBA dispatches
                                         # parallel.dba.bundle_adjust_sharded
                                         # over a landmark-sharded mesh.
    pipeline_depth: int = 3              # in-flight frames in the deep
                                         # pipeline (track_monocular_pipelined):
                                         # bookkeeping/output lag by this many
                                         # frames; each extra level hides one
                                         # more device->host latency window
    # loop closing gates (NewDetectCommonRegions, LoopClosing.cc:413-436)
    loop_min_kfs: int = 12              # current map must have >= this many KFs
    loop_requires_viba2: bool = True    # inertial maps wait for VIBA2 before PR
    # recovery (5.3)
    recently_lost_secs: float = 5.0

    @property
    def is_inertial(self) -> bool:
        return self.sensor in (IMU_MONOCULAR, IMU_STEREO, IMU_RGBD)

    @property
    def is_mono(self) -> bool:
        return self.sensor in (MONOCULAR, IMU_MONOCULAR)

"""Retrieval precision of two vocabularies: the port of
`scripts/eval_vocabulary.py`.

Builds a keyframe database from frames rendered along the EuRoC MH01
ground-truth trajectory (the landmark hall of `utils/gt_replay`, full
rBRIEF descriptors), queries it with the held-out frames in between, and
scores place recognition: a hit is a top-scoring database keyframe within
`--radius` metres of the query's true position. The reference's
vocabulary is k=10, L=5, about 1e5 words (TemplatedVocabulary.h).

    python -m orb_slam3_comments_ghr_torch.scripts.eval_vocabulary \\
        --voc-a orb_slam3_comments_ghr_torch/retrieval/default_voc.npz \\
        --voc-b orb_slam3_comments_ghr_torch/retrieval/voc_100k.npz \\
        [--n-kf 300] [--device cpu]

The ground truth is `MH01_GT.txt` in the folder that `EUROC_GT_DIR` names.
The tree descents (`Vocabulary.transform_on_device`) run on the CUDA card
unless `--device` names another. Prints one JSON line per vocabulary.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


class _NoCovis:
    def covisible_kfs(self, kf, k=10, **kw):
        return []


def _build_frames(n_kf: int, n_feat: int, seed: int, device="cpu") -> list:
    """2 n_kf frames spread over the whole trajectory: (descriptors (N, 8)
    uint32, valid (N,), true position), rendered on `device`."""
    from ..ops import cameras
    from ..utils import gt_replay, synthetic

    times, R_cw, t_cw, p_wc, _ = gt_replay.load_euroc_gt("MH01")
    step = max(1, len(times) // (n_kf * 2))
    idx = list(range(0, len(times), step))[: n_kf * 2]
    cam = cameras.euroc_cam0()
    world = gt_replay.make_hall_world(11, p_wc, n_points=48000)
    frames = []
    for i in idx:
        feats, _ = synthetic.render_features(world, cam, R_cw[i], t_cw[i], n_feat=n_feat,
                                             seed=seed + i, device=device)
        frames.append((feats.desc.cpu().numpy().view(np.uint32), feats.valid.cpu().numpy(),
                       p_wc[i]))
    return frames


def _score(voc_path: str, frames, radius: float, device="cpu") -> dict:
    """Even frames into the database, odd frames as queries: precision at 1
    and 3 and the host ms per query (descent and detection)."""
    from ..retrieval.database import KeyFrameDatabase
    from ..retrieval.vocabulary import Vocabulary

    voc = Vocabulary.load(voc_path, device=device)
    db = KeyFrameDatabase(voc, max_kf=len(frames))
    db_pos = {}
    for kf, (desc, valid, pos) in enumerate(frames):
        if kf % 2 == 0:
            db.add(kf, desc, valid)
            db_pos[kf] = pos
    hits1 = hits3 = n_q = 0
    t0 = time.perf_counter()
    for kf, (desc, valid, pos) in enumerate(frames):
        if kf % 2 == 0:
            continue
        word, _ = voc.transform_on_device(desc, valid)
        cands = db.detect_candidates(voc.bow_vector(word), set(), _NoCovis(), n_best=3,
                                     final_acc_cut=None)
        n_q += 1
        d = [np.linalg.norm(db_pos[c] - pos) for c in cands]
        if d and d[0] <= radius:
            hits1 += 1
        if d and min(d) <= radius:
            hits3 += 1
    dt = time.perf_counter() - t0
    return {
        "voc": os.path.basename(voc_path),
        "n_words": int(voc.n_words),
        "queries": n_q,
        "precision_at_1": round(hits1 / max(n_q, 1), 3),
        "precision_at_3": round(hits3 / max(n_q, 1), 3),
        "query_ms": round(dt / max(n_q, 1) * 1e3, 2),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--voc-a", required=True)
    ap.add_argument("--voc-b", required=True)
    ap.add_argument("--n-kf", type=int, default=300)
    ap.add_argument("--n-features", type=int, default=1024)
    ap.add_argument("--radius", type=float, default=2.0)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' for the host)")
    args = ap.parse_args(argv)

    from ..utils.device import resolve_device

    device = resolve_device(args.device)
    frames = _build_frames(args.n_kf, args.n_features, args.seed, device)
    print(f"built {len(frames)} frames ({len(frames)//2} database, "
          f"{len(frames)//2} query)", file=sys.stderr)
    for p in (args.voc_a, args.voc_b):
        print(json.dumps(_score(p, frames, args.radius, device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())

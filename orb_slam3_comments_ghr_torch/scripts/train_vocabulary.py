"""Train an ORB vocabulary from a folder of images or synthetic renders:
the port of `scripts/train_vocabulary.py` (DBoW2's offline create(); the
reference ships a pre-trained 1e5-word ORBvoc.txt instead).

    python -m orb_slam3_comments_ghr_torch.scripts.train_vocabulary \\
        --images /data/MH01/mav0/cam0/data --out my_voc.npz --k 10 --L 4 \\
        [--max-images 120] [--device cpu]

With no dataset on disk, `--synthetic N` renders N views of textured scenes
and trains on the descriptors of the port's own extractor
(`frontend/batched.extract_batched`, on the CUDA card unless `--device`
names another), so the tree covers the statistics of its rBRIEF pattern:

    python -m orb_slam3_comments_ghr_torch.scripts.train_vocabulary \\
        --synthetic 120 --out default_voc.npz

The file is the JAX package's format (`Vocabulary.save`).
"""

from __future__ import annotations

import argparse
import glob
import os
import sys

import numpy as np


def corpus(args, device):
    """(descriptors (N, 8) uint32, image id per descriptor) of the images
    or synthetic views that `args` names, extracted on `device`."""
    import torch

    from ..frontend.batched import extract_batched

    descs, image_ids = [], []

    def add_image(i, img):
        f = extract_batched(torch.as_tensor(img, device=device), n_features=args.n_features)
        d = f.desc[f.valid].cpu().numpy().view(np.uint32)
        descs.append(d)
        image_ids.append(np.full(len(d), i, np.int32))

    if args.synthetic:
        from ..ops import cameras
        from ..utils import synthetic

        cam = cameras.euroc_cam0()
        rng = np.random.default_rng(args.seed)
        n_scenes = max(1, args.synthetic // 6)
        i = 0
        for _ in range(n_scenes):
            scene = synthetic.make_textured_scene(int(rng.integers(0, 1 << 30)))
            poses = synthetic.circular_trajectory(6, radius=float(rng.uniform(1.0, 3.0)), arc=1.0)
            for R, t in poses:
                if i >= args.synthetic:
                    break
                add_image(i, synthetic.render_image(scene, cam, R, t))
                i += 1
        print(f"extracted from {i} synthetic views of {n_scenes} scenes")
    else:
        from ..io.datasets import load_image

        paths = sorted(p for ext in ("png", "jpg", "pgm", "npy")
                       for p in glob.glob(os.path.join(args.images, f"*.{ext}")))
        paths = paths[:args.max_images]
        if not paths:
            raise SystemExit(f"no images found under {args.images}")
        for i, p in enumerate(paths):
            add_image(i, load_image(p))
    return np.concatenate(descs), np.concatenate(image_ids)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--images", default=None, help="directory of images")
    ap.add_argument("--synthetic", type=int, default=0,
                    help="render N synthetic views through the port's extractor")
    ap.add_argument("--out", required=True)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--L", type=int, default=4)
    ap.add_argument("--max-images", type=int, default=120)
    ap.add_argument("--n-features", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device of the extractor (default: the CUDA card; 'cpu' for the host)")
    args = ap.parse_args(argv)
    if not args.synthetic and not args.images:
        ap.error("give --images DIR or --synthetic N")
    return args


def train(args):
    """Extract the corpus that `args` names, train the tree, save it to
    `args.out`; returns the trained Vocabulary."""
    from ..retrieval.vocabulary import Vocabulary
    from ..utils.device import resolve_device

    device = resolve_device(args.device)
    descs, image_ids = corpus(args, device)
    print(f"training k={args.k} L={args.L} on {len(descs)} descriptors")
    voc = Vocabulary.train(descs, k=args.k, L=args.L, seed=args.seed, image_ids=image_ids,
                           device=device)
    voc.save(args.out)
    print(f"saved {voc.n_words}-word vocabulary to {args.out} "
          f"(idf range {voc.idf.min():.2f}..{voc.idf.max():.2f})")
    return voc


def main(argv=None) -> int:
    train(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Train the default vocabulary from real ORB descriptors.

The reference ships a pre-trained ORBvoc.txt (loaded at src/main.cc:101).
With no dataset downloads available, the equivalent artifact is trained
offline from descriptors extracted off rendered synthetic scenes (many
seeds/viewpoints, real rBRIEF statistics — NOT random bytes) and committed
as data/vocab_synthetic.npz; run.py loads it by default.

Usage:  JAX_PLATFORMS=cpu python -m orbslam_jpminipc.vocab.train \
            [--words 8192] [--frames 60] [--out path.npz]
"""
from __future__ import annotations

import argparse
import os

import numpy as np

DEFAULT_OUT = os.path.join(os.path.dirname(__file__), "..", "data", "vocab_synthetic.npz")


def collect_descriptors(n_frames: int = 60, seeds=(0, 1, 2, 3)) -> np.ndarray:
    from ..config import SlamConfig
    from ..frontend.frame import build_frame
    from ..io.dataset import SyntheticSequence

    cfg = SlamConfig(fx=500.0, fy=500.0, cx=320.0, cy=240.0,
                     k1=0.0, k2=0.0, p1=0.0, p2=0.0)
    descs = []
    for seed in seeds:
        for traj in ("xyz", "loop"):
            seq = SyntheticSequence(n_frames=n_frames, trajectory=traj, seed=seed)
            step = max(1, n_frames // 15)
            for i in range(0, n_frames, step):
                img, ts, _ = seq.get(i)
                f = build_frame(img, cfg, frame_id=i, timestamp=ts, n_features=1000)
                descs.append(f.desc[f.valid])
    return np.concatenate(descs, axis=0)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--words", type=int, default=8192)
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--tree", action="store_true",
                    help="train a hierarchical (ORBvoc-style k-ary tree) "
                         "vocabulary instead of a flat one")
    ap.add_argument("--k", type=int, default=16, help="tree branching factor")
    ap.add_argument("--depth", type=int, default=4, help="tree depth")
    ap.add_argument("--seeds", type=int, default=8,
                    help="number of synthetic scene seeds to render")
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)

    from .vocabulary import build_vocabulary, save_vocabulary

    descs = collect_descriptors(args.frames, seeds=tuple(range(args.seeds)))
    print(f"training set: {len(descs)} descriptors", flush=True)
    if args.tree:
        from .tree import build_tree_vocabulary

        vocab = build_tree_vocabulary(descs, k=args.k, depth=args.depth)
    else:
        vocab = build_vocabulary(descs, n_words=args.words, iters=args.iters)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    save_vocabulary(vocab, args.out)
    print(f"vocabulary ({vocab.n_words} words) -> {args.out}")


if __name__ == "__main__":
    main()

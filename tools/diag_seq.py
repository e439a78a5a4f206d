"""Per-frame diagnostic runner for a synthetic sequence in an arbitrary
configuration — the instrument for closing the shipping-config gap
(VERDICT r04 #1): prints every frame's FSM state / inlier counts /
latency-mode flag, and tees the tracer's JSONL event stream (reloc
candidates + attempts, loop-detection gates) to a file for post-mortem.

Usage:
  python tools/diag_seq.py --seq orbit --frames 300 \
      --vocab tree64k --pipelined 1 --events /tmp/ev.jsonl
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seq", default="orbit")
    ap.add_argument("--frames", type=int, default=300)
    ap.add_argument("--vocab", default="tree64k",
                    help="tree64k | synthetic | none | path to a .npz vocabulary")
    ap.add_argument("--pipelined", type=int, default=1)
    ap.add_argument("--events", default="/tmp/diag_events.jsonl")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from orbslam_jpminipc.utils.jaxcache import enable_persistent_cache

    enable_persistent_cache()

    from orbslam_jpminipc.utils import tracing
    if os.path.exists(args.events):
        os.remove(args.events)
    tracing._tracer = tracing.StageTracer(jsonl_path=args.events)

    from orbslam_jpminipc.config import SlamConfig
    from orbslam_jpminipc.io.dataset import SyntheticSequence
    from orbslam_jpminipc.io.trajectory import ate_rmse
    from orbslam_jpminipc.pipeline.system import Slam
    from orbslam_jpminipc.vocab.vocabulary import load_vocabulary

    cfg = SlamConfig(
        fx=500.0, fy=500.0, cx=320.0, cy=240.0,
        k1=0.0, k2=0.0, p1=0.0, p2=0.0, n_features=1000,
        pipelined_tracking=bool(args.pipelined),
    )
    vocab = None
    if args.vocab != "none":
        if os.path.exists(args.vocab):
            vocab = load_vocabulary(args.vocab)
        else:
            name = ("vocab_tree64k.npz" if args.vocab == "tree64k"
                    else "vocab_synthetic.npz")
            vocab = load_vocabulary(os.path.join(
                os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                "orbslam_jpminipc", "data", name))

    n = args.frames
    seq = SyntheticSequence(n_frames=n, trajectory=args.seq, seed=args.seed)
    slam = Slam(cfg, vocab=vocab)
    tracer = tracing.get_tracer()
    for i in range(n):
        img, ts, _ = seq.get(i)
        state, frame = slam.process(img, ts)
        tr = slam.tracker
        fstats = getattr(tr, "fused_stats", None)
        tracer.log(
            "frame", i=i, state=state.name,
            done=(frame.frame_id if frame is not None else -1),
            inl=tr.n_inliers, fused=fstats,
            kfs=slam.n_keyframes, pts=slam.n_points,
            lat=getattr(slam, "_latency_frames", 0),
            loops=slam.n_loops_closed,
        )
        if i % 20 == 0 or state.name in ("LOST",):
            print(f"[{i:3d}] {state.name:12s} inl={tr.n_inliers:4d} "
                  f"fused={fstats} kf={slam.n_keyframes} "
                  f"pts={slam.n_points} lat={getattr(slam, '_latency_frames', 0)} "
                  f"loops={slam.n_loops_closed}", flush=True)
    slam.finish()

    gt = {round(float(seq.timestamps[i]), 6): seq.poses[i] for i in range(n)}
    est, gtc = [], []
    for ts, R, t in slam.trajectory:
        if round(ts, 6) in gt:
            Rg, tg = gt[round(ts, 6)]
            est.append(-R.T @ t)
            gtc.append(-Rg.T @ tg)
    ate = ate_rmse(np.stack(est), np.stack(gtc)) if len(est) > 10 else float("nan")
    print(f"tracked={len(slam.trajectory)}/{n} kfs={slam.n_keyframes} "
          f"pts={slam.n_points} loops={slam.n_loops_closed} ate={ate:.4f}")
    if args.out:
        import json
        with open(args.out, "w") as f:
            json.dump({"tracked": len(slam.trajectory), "frames": n,
                       "loops": slam.n_loops_closed, "ate": float(ate)}, f)


if __name__ == "__main__":
    main()

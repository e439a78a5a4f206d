"""ATE diagnosis: where does the trajectory error come from?

Runs the full system on a synthetic sequence (CPU by default for fast
iteration) and reports, per frame:
  - position error after Sim3 alignment of the WHOLE trajectory,
  - local scale drift: ||est step|| / ||gt step|| over a sliding window,
  - inlier counts and tracked-point counts,
and per keyframe event: local-BA chi2 and map size. The goal is to
separate geometric error (init/scale drift), data association error
(matching), and solver error (BA convergence).

Usage: python tools/diag_ate.py [--frames 300] [--traj xyz] [--cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import sys


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=300)
    ap.add_argument("--traj", default="xyz")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--no-fused", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    if args.cpu:
        os.environ["JAX_PLATFORMS"] = "cpu"
    from orbslam_jpminipc.utils.jaxcache import enable_persistent_cache
    enable_persistent_cache()

    import numpy as np

    from orbslam_jpminipc.config import SlamConfig
    from orbslam_jpminipc.io.dataset import SyntheticSequence
    from orbslam_jpminipc.io.trajectory import umeyama_alignment, ate_rmse
    from orbslam_jpminipc.pipeline.system import Slam
    from orbslam_jpminipc.vocab.vocabulary import load_vocabulary

    cfg = SlamConfig(pipelined_tracking=False,
                     fx=500.0, fy=500.0, cx=320.0, cy=240.0,
                     k1=0.0, k2=0.0, p1=0.0, p2=0.0, n_features=1000,
                     fused_tracking=not args.no_fused)
    voc = load_vocabulary(os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "orbslam_jpminipc", "data", "vocab_synthetic.npz"))
    seq = SyntheticSequence(n_frames=args.frames, trajectory=args.traj,
                            seed=args.seed)
    slam = Slam(cfg, vocab=voc)

    inliers, npts = [], []
    for i in range(args.frames):
        img, ts, _ = seq.get(i)
        state, frame = slam.process(img, ts)
        inliers.append(slam.tracker.n_inliers if state.name == "WORKING" else 0)
        npts.append(slam.n_points)
        if i % 40 == 0:
            print(f"[{i}] {state.name} inl={inliers[-1]} kf={slam.n_keyframes} "
                  f"pts={slam.n_points}", file=sys.stderr, flush=True)

    # align full trajectory (Sim3) and report per-frame error
    gt = {round(float(seq.timestamps[i]), 6): seq.poses[i]
          for i in range(args.frames)}
    est_c, gt_c, idxs = [], [], []
    for ts, R, t in slam.trajectory:
        k = round(ts, 6)
        if k in gt:
            Rg, tg = gt[k]
            gt_c.append(-Rg.T @ tg)
            est_c.append(-R.T @ t)
            idxs.append(int(round(k * 30)))
    est_c, gt_c = np.stack(est_c), np.stack(gt_c)
    s, Ra, ta = umeyama_alignment(est_c, gt_c)
    aligned = est_c @ (s * Ra).T + ta
    err = np.linalg.norm(aligned - gt_c, axis=1)
    extent = float(np.linalg.norm(gt_c.max(0) - gt_c.min(0)))
    ate = float(np.sqrt((err ** 2).mean()))
    print(f"\nATE {ate:.4f} m  extent {extent:.3f} m  "
          f"({100*ate/extent:.1f}% of extent)  frames {len(err)}")

    # per-segment error profile
    W = max(len(err) // 10, 1)
    for b in range(0, len(err), W):
        seg = err[b:b + W]
        print(f"  frames {idxs[b]:4d}-{idxs[min(b+W, len(err))-1]:4d}: "
              f"err p50 {np.median(seg):.4f} max {seg.max():.4f}  "
              f"inl~{np.median([inliers[i] for i in idxs[b:b+W]]):.0f}")

    # local scale drift: ratio of est to gt step lengths (window 10)
    est_step = np.linalg.norm(np.diff(est_c, axis=0), axis=1) * s
    gt_step = np.linalg.norm(np.diff(gt_c, axis=0), axis=1)
    ok = gt_step > 1e-4
    ratio = np.where(ok, est_step / np.maximum(gt_step, 1e-9), np.nan)
    W = 20
    print("\nscale drift (aligned est step / gt step, window medians):")
    for b in range(0, len(ratio), W):
        seg = ratio[b:b + W]
        seg = seg[np.isfinite(seg)]
        if len(seg):
            print(f"  steps {b:4d}-{b+W:4d}: {np.median(seg):.3f}")

    # rotation error per frame
    rot_err = []
    for ts, R, t in slam.trajectory:
        k = round(ts, 6)
        if k in gt:
            Rg, _ = gt[k]
            dR = (Ra @ R.T) @ Rg  # aligned est R_wc vs gt R_wc
            c = (np.trace(dR) - 1) / 2
            rot_err.append(np.degrees(np.arccos(np.clip(c, -1, 1))))
    rot_err = np.array(rot_err)
    print(f"\nrotation err: p50 {np.median(rot_err):.3f} deg  "
          f"max {rot_err.max():.3f} deg")
    print(json.dumps({"ate": ate, "extent": extent,
                      "pct": round(100*ate/extent, 2),
                      "kfs": slam.n_keyframes, "pts": slam.n_points}))


if __name__ == "__main__":
    main()

"""Command-line entry point: run SLAM over a dataset.

The reference's `rosrun ORB_SLAM ORB_SLAM <vocabulary> <settings.yaml>`
(src/main.cc:58-66) becomes:

    python -m orbslam_jpminipc.run --dataset synthetic \
        [--settings settings.yaml] [--vocab vocab.npz] \
        [--out KeyFrameTrajectory.txt] [--save-world w.npz] [--load-world w.npz]

Datasets: `synthetic[:trajectory]` (rendered room, ground-truth ATE printed)
or `tum:<dir>` (TUM RGB-D sequence directory). Writes the keyframe
trajectory in TUM format on exit (main.cc:226-245) and supports world
checkpoint/resume (SaveLoadWorld parity).
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def main(argv=None):
    """Run the sequence; returns a summary dict (the system, ground truth,
    wall and warmup seconds) for callers that check the run."""
    ap = argparse.ArgumentParser(description="Monocular ORB-SLAM in JAX")
    ap.add_argument("--dataset", default="synthetic",
                    help="synthetic[:traj] | tum:<dir>")
    ap.add_argument("--settings", default=None, help="settings.yaml (reference layout)")
    ap.add_argument("--vocab", default=None, help="vocabulary .npz (omit: ad-hoc vocab)")
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--n-features", type=int, default=1000)
    ap.add_argument("--out", default="KeyFrameTrajectory.txt")
    ap.add_argument("--save-world", default=None)
    ap.add_argument("--load-world", default=None)
    ap.add_argument("--no-loop-closing", action="store_true")
    ap.add_argument("--realtime", action="store_true",
                    help="consume frames against the camera clock (cfg.fps) "
                         "and DROP late frames, like the reference's live "
                         "image topic (src/Tracking.cc:166-189) — reports "
                         "%%dropped alongside fps")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-warmup", action="store_true",
                    help="skip the startup program compilation (warmup "
                         "pre-compiles every tracking/recovery/loop program "
                         "so a live run never stalls on a mid-run compile)")
    ap.add_argument("--viz", default=None, metavar="DIR",
                    help="live visualization: write the tracked-frame debug "
                         "image and a top-down map view to DIR every frame "
                         "(the reference refreshes its Frame/Map publishers "
                         "at camera fps, src/main.cc:210-218)")
    args = ap.parse_args(argv)

    from .utils.jaxcache import enable_persistent_cache

    enable_persistent_cache()

    from .config import SlamConfig
    from .io.dataset import SyntheticSequence, TumDataset
    from .io.trajectory import save_tum, ate_rmse
    from .pipeline.system import Slam
    from .vocab.vocabulary import build_vocabulary, load_vocabulary

    if args.settings:
        cfg = SlamConfig.from_yaml(args.settings)
        cfg.n_features = args.n_features
    else:
        cfg = SlamConfig(n_features=args.n_features)

    gt = None
    if args.dataset.startswith("synthetic"):
        traj = args.dataset.split(":")[1] if ":" in args.dataset else "xyz"
        cfg.fx = cfg.fy = 500.0
        cfg.cx, cfg.cy = 320.0, 240.0
        cfg.k1 = cfg.k2 = cfg.p1 = cfg.p2 = 0.0
        seq = SyntheticSequence(n_frames=args.frames, trajectory=traj, seed=args.seed)
        gt = {round(float(seq.timestamps[i]), 6): seq.poses[i] for i in range(len(seq))}
    elif args.dataset.startswith("tum:"):
        seq = TumDataset(args.dataset[4:])
    else:
        ap.error(f"unknown dataset {args.dataset}")

    if args.vocab:
        vocab = load_vocabulary(args.vocab)
    else:
        data_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
        # prefer the ORBvoc-style hierarchical vocabulary (64k words,
        # vocab/train.py --tree) — the analogue of the reference's shipped
        # ORBvoc.txt (main.cc:101); fall back to the flat 4k vocabulary
        tree_voc = os.path.join(data_dir, "vocab_tree64k.npz")
        flat_voc = os.path.join(data_dir, "vocab_synthetic.npz")
        default_voc = tree_voc if os.path.exists(tree_voc) else flat_voc
        if os.path.exists(default_voc):
            vocab = load_vocabulary(default_voc)
        else:
            rng = np.random.default_rng(0)
            vocab = build_vocabulary(
                rng.integers(0, 256, (20000, 32)).astype(np.uint8), n_words=1024, iters=3
            )

    slam = Slam(cfg, vocab=vocab, enable_loop_closing=not args.no_loop_closing)
    warmup_s = None
    if not args.no_warmup:
        t_w = time.time()
        slam.warmup()
        warmup_s = time.time() - t_w
        print(f"warmup (program compilation): {warmup_s:.1f}s",
              file=sys.stderr)
    viz_dir = None
    if args.viz:
        os.makedirs(args.viz, exist_ok=True)
        viz_dir = args.viz
    # in pipelined mode slam.process returns the most recently COMPLETED
    # frame — up to pipeline_depth behind the image just submitted. The
    # debug overlay must be drawn on the image that frame was tracked on,
    # so keep a small frame_id -> image ring buffer.
    viz_ring: dict[int, np.ndarray] = {}

    def refresh_viz(i, img, frame, state):
        """FramePublisher/MapPublisher refresh (src/main.cc:210-218)."""
        if viz_dir is None:
            return
        from .utils.cv import require_cv2
        cv2 = require_cv2()
        from .io.viz import draw_frame, draw_map_topdown

        # the image just submitted got SLAM frame id frame_count-1 (the
        # dataset index `i` diverges from it in realtime mode, where
        # dropped frames never reach slam.process)
        fid = slam.frame_count - 1
        viz_ring[fid] = img
        for k in [k for k in viz_ring if k < fid - 2 * cfg.pipeline_depth]:
            del viz_ring[k]
        if frame is not None and frame.frame_id in viz_ring:
            img_dbg = draw_frame(
                np.asarray(viz_ring[frame.frame_id]), frame, state,
                n_kf=slam.n_keyframes, n_mp=slam.n_points)
            cv2.imwrite(os.path.join(viz_dir, "frame.png"), img_dbg)
        cv2.imwrite(os.path.join(viz_dir, "map.png"),
                    draw_map_topdown(slam.map))

    if args.load_world:
        from .io.checkpoint import load_slam

        load_slam(args.load_world, slam)
        print(f"resumed world: {slam.n_keyframes} KFs, {slam.n_points} points")

    n = min(args.frames, len(seq))
    fps_clock = cfg.fps if cfg.fps > 0 else 30.0
    dropped = 0
    t0 = time.time()
    if args.realtime:
        # live-camera semantics: frame i becomes available at i/fps; if the
        # system is still busy when several frames have arrived, only the
        # NEWEST is processed and the rest are dropped (the reference's
        # ros::TransportHints queue of depth 1, src/main.cc:169)
        i = 0
        done = 0
        while i < n:
            img, ts, _ = seq.get(i)
            state, frame = slam.process(img, ts)
            refresh_viz(i, img, frame, state)
            done += 1
            if done % 20 == 0:
                print(f"[{i}/{n}] {state.name} kfs={slam.n_keyframes} "
                      f"pts={slam.n_points}", file=sys.stderr)
            arrived = int((time.time() - t0) * fps_clock) + 1
            nxt = min(max(i + 1, arrived), n)
            dropped += nxt - (i + 1)
            i = nxt
        wall = time.time() - t0
        print(f"realtime @{fps_clock:.0f}fps: processed {done}/{n} frames in "
              f"{wall:.1f}s, dropped {dropped} ({100.0*dropped/max(n,1):.1f}%), "
              f"{slam.n_keyframes} KFs, {slam.n_points} points, "
              f"{slam.n_loops_closed} loops closed")
    else:
        for i in range(n):
            img, ts, _ = seq.get(i)
            state, frame = slam.process(img, ts)
            refresh_viz(i, img, frame, state)
            if i % 20 == 0:
                print(
                    f"[{i}/{n}] {state.name} kfs={slam.n_keyframes} "
                    f"pts={slam.n_points} inliers={slam.tracker.n_inliers}",
                    file=sys.stderr,
                )
        wall = time.time() - t0
        print(f"processed {n} frames in {wall:.1f}s ({n / wall:.1f} fps), "
              f"{slam.n_keyframes} KFs, {slam.n_points} points, "
              f"{slam.n_loops_closed} loops closed")

    slam.finish()
    save_tum(args.out, slam.keyframe_trajectory())
    print(f"keyframe trajectory -> {args.out}")

    if gt is not None and len(slam.trajectory) > 10:
        est_c, gt_c = [], []
        for ts, R, t in slam.trajectory:
            if round(ts, 6) in gt:
                Rg, tg = gt[round(ts, 6)]
                gt_c.append(-Rg.T @ tg)
                est_c.append(-R.T @ t)
        print(f"ATE RMSE (scale-aligned): {ate_rmse(np.stack(est_c), np.stack(gt_c)):.4f} m "
              f"over {len(est_c)} tracked frames")

    if args.save_world:
        from .io.checkpoint import save_slam

        save_slam(args.save_world, slam)
        print(f"world -> {args.save_world}")
    return {"slam": slam, "gt": gt, "frames": n, "wall_s": wall,
            "warmup_s": warmup_s}


if __name__ == "__main__":
    main()

"""Diagnose two-view initialization + early tracking against ground truth."""
from __future__ import annotations

import argparse
import os
import sys


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--traj", default="xyz")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    if args.cpu:
        os.environ["JAX_PLATFORMS"] = "cpu"
    from orbslam_jpminipc.utils.jaxcache import enable_persistent_cache
    enable_persistent_cache()

    import numpy as np
    from orbslam_jpminipc.config import SlamConfig
    from orbslam_jpminipc.io.dataset import SyntheticSequence
    from orbslam_jpminipc.pipeline.system import Slam
    from orbslam_jpminipc.vocab.vocabulary import load_vocabulary

    cfg = SlamConfig(pipelined_tracking=False,
                     fx=500.0, fy=500.0, cx=320.0, cy=240.0,
                     k1=0.0, k2=0.0, p1=0.0, p2=0.0, n_features=1000)
    voc = load_vocabulary(os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "orbslam_jpminipc", "data", "vocab_synthetic.npz"))
    seq = SyntheticSequence(n_frames=args.frames, trajectory=args.traj, seed=0)
    slam = Slam(cfg, vocab=voc)

    # spy on initialization
    orig = slam._create_initial_map
    info = {}

    def spy(f0, f1, match_info, init_res):
        info["f0"] = f0.frame_id
        info["f1"] = f1.frame_id
        info["R21"] = np.asarray(init_res.R).copy()
        info["t21"] = np.asarray(init_res.t).copy()
        info["good"] = int((np.asarray(init_res.good) & match_info[1]).sum())
        return orig(f0, f1, match_info, init_res)

    slam._create_initial_map = spy
    slam.tracker.on_initialized = spy

    def angdeg(Ra, Rb):
        c = (np.trace(Ra.T @ Rb) - 1) / 2
        return float(np.degrees(np.arccos(np.clip(c, -1, 1))))

    per_frame = []
    for i in range(args.frames):
        img, ts, (Rg, tg) = seq.get(i)
        state, frame = slam.process(img, ts)
        if info and "reported" not in info:
            info["reported"] = True
            i0, i1 = info["f0"], info["f1"]
            R0g, t0g = seq.poses[i0]
            R1g, t1g = seq.poses[i1]
            # gt relative pose cam0->cam1: R_rel = R1 R0^T, t_rel = t1 - R_rel t0
            R_rel = R1g @ R0g.T
            t_rel = t1g - R_rel @ t0g
            est_R, est_t = info["R21"], info["t21"]
            b_gt = t_rel / max(np.linalg.norm(t_rel), 1e-12)
            b_est = est_t / max(np.linalg.norm(est_t), 1e-12)
            print(f"init frames {i0}->{i1}: good={info['good']}")
            print(f"  gt baseline {np.linalg.norm(t_rel)*100:.1f} cm, "
                  f"gt rot {angdeg(np.eye(3), R_rel):.2f} deg")
            print(f"  est-vs-gt rot err {angdeg(est_R, R_rel):.2f} deg, "
                  f"baseline dir err "
                  f"{np.degrees(np.arccos(np.clip(abs(b_est@b_gt),-1,1))):.2f} deg")
        if frame.R is not None and state.name == "WORKING":
            st = getattr(slam.tracker, "fused_stats", None)
            is_kf = slam.tracker.last_kf_frame_id == i
            per_frame.append((i, frame.R.copy(), frame.t.copy(), Rg, tg,
                              slam.tracker.n_inliers, st, is_kf))

    if len(per_frame) < 12:
        print("not enough tracked frames", len(per_frame))
        return
    # gauge from the first 10 tracked frames (scale+rigid), then measure
    # drift forward
    from orbslam_jpminipc.io.trajectory import umeyama_alignment
    est_c = np.stack([-R.T @ t for f in per_frame for R, t in [(f[1], f[2])]])
    gt_c = np.stack([-Rg.T @ tg for f in per_frame for Rg, tg in [(f[3], f[4])]])
    s, Ra, ta = umeyama_alignment(est_c[:10], gt_c[:10])
    aligned = est_c @ (s * Ra).T + ta
    err = np.linalg.norm(aligned - gt_c, axis=1)
    print("\nper-frame error with gauge fixed on first 10 tracked frames:")
    for j in range(len(per_frame)):
        i, R, t, Rg, tg, ninl, stt, is_kf = per_frame[j]
        rot = angdeg(Ra @ R.T, Rg.T)
        mark = " KF" if is_kf else ""
        dev = float(np.abs(R.T @ R - np.eye(3)).max())
        print(f"  frame {i:3d}: pos err {err[j]*100:6.2f} cm  rot err "
              f"{rot:5.2f} deg  inl {ninl} fused={stt} so3dev={dev:.2e}{mark}")


if __name__ == "__main__":
    main()

"""Benchmark on one GPU.

Prints ONE JSON line. Headline metric: END-TO-END sequential SLAM fps —
the FULL system (extraction, tracking, keyframe mapping spikes with
triangulation/fusion/local BA/culling, BoW place recognition, loop
closing) over a 120-frame synthetic sequence, wall-clock, host loop
included. Baseline: the reference's 30 fps real-time tracking claim
(BASELINE.md; src/Tracking.cc:72-74).

`extra` carries the throughput-oriented numbers: the fused per-frame
pipeline (extract + tracking_step streamed on-device — the r01 headline),
per-kernel ms/iteration for local BA, global BA, and the essential graph
(the BASELINE.md kernel rows), and per-stage p50/p95 from the tracer.

The persistent compilation cache (.jax_cache) keeps compilation out of
warm runs. Fails unless JAX's first device is a GPU.
"""
import json
import sys
import time

import numpy as np


def stream_time(fn, n=30, reps=4, warmup=2):
    """Best-of-reps amortized ms/call; each rep ends by pulling its last
    output to the host."""
    import jax

    def sync(out):
        np.asarray(jax.tree.leaves(out)[0])

    for _ in range(warmup):
        sync(fn())
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = None
        for _ in range(n):
            out = fn()
        sync(out)
        best = min(best, (time.perf_counter() - t0) / n)
    return best * 1e3


def bench_fused(dev):
    """The SHIPPING fused per-frame program (fused_track.make_fused_step —
    the same program __graft_entry__.entry() exports and the system's
    WORKING path runs), driven exactly like the pipelined frame loop:
    dispatch frame N, async-pull frame N-k via the pull pool."""
    from collections import deque

    import jax
    import jax.numpy as jnp

    from orbslam_jpminipc.config import SlamConfig
    from orbslam_jpminipc.frontend.fused_track import (
        MAX_SLICE, FusedContext, pack_slice,
    )
    from orbslam_jpminipc.ops.extractor import extract
    from orbslam_jpminipc.utils.pull import pull_pool

    cfg = SlamConfig(fx=500.0, fy=500.0, cx=320.0, cy=240.0,
                     k1=0.0, k2=0.0, p1=0.0, p2=0.0, n_features=1000)
    ctx = FusedContext(cfg)
    rng = np.random.default_rng(0)
    M = MAX_SLICE
    xyz = np.stack([rng.uniform(-2, 2, M), rng.uniform(-1.5, 1.5, M),
                    rng.uniform(1, 3, M)], 1).astype(np.float32)
    normal = (xyz / np.linalg.norm(xyz, axis=1, keepdims=True)).astype(np.float32)
    buf = pack_slice(
        xyz, normal, np.full(M, 0.5, np.float32), np.full(M, 6.0, np.float32),
        rng.integers(0, 256, (M, 32)).astype(np.uint8),
        rng.integers(2, 9, M).astype(np.float32), M,
    )
    ctx.set_pose(np.eye(3, dtype=np.float32), np.zeros(3, np.float32))
    ctx.slice_buf = jax.device_put(jnp.asarray(buf), dev)
    imgs = [jax.device_put(
        jnp.asarray(rng.integers(0, 255, (480, 640)).astype(np.uint8)), dev)
        for _ in range(4)]

    # warm (compile)
    out = ctx.track(imgs[0])
    np.asarray(out.pull)

    n = 60
    depth = cfg.pipeline_depth
    best = float("inf")
    for _ in range(3):
        inflight = deque()
        t0 = time.perf_counter()
        for i in range(n):
            out = ctx.track(imgs[i % 4])
            inflight.append(pull_pool().submit(out.pull))
            while inflight and (inflight[0].done() or len(inflight) > depth):
                inflight.popleft().result()
        while inflight:
            inflight.popleft().result()
        best = min(best, (time.perf_counter() - t0) / n)
    dt = best * 1e3

    dt_ex = stream_time(
        lambda: extract(imgs[0].astype(jnp.float32), n_features=1000, n_levels=8),
        n=20)
    print(f"fused pipeline: {dt:.3f} ms ({1000/dt:.1f} fps); extract {dt_ex:.3f} ms",
          file=sys.stderr)
    return dt, dt_ex


def bench_local_ba(dev):
    import jax
    import jax.numpy as jnp

    from orbslam_jpminipc.solvers.ba import BAProblem, bundle_adjust

    rng = np.random.default_rng(1)
    K, P, O = 24, 4096, 16384
    prob = BAProblem(
        kf_R=jnp.tile(jnp.eye(3)[None], (K, 1, 1)),
        kf_t=jnp.array(rng.normal(0, 0.1, (K, 3)).astype(np.float32)),
        kf_fixed=jnp.array([True] + [False] * (K - 1)),
        points=jnp.array(
            np.stack([rng.uniform(-2, 2, P), rng.uniform(-2, 2, P),
                      rng.uniform(2, 6, P)], 1).astype(np.float32)
        ),
        point_valid=jnp.ones(P, bool),
        obs_kf=jnp.array(rng.integers(0, K, O).astype(np.int32)),
        obs_pt=jnp.array(rng.integers(0, P, O).astype(np.int32)),
        obs_uv=jnp.array(rng.uniform(0, 640, (O, 2)).astype(np.float32)),
        obs_w=jnp.ones(O, jnp.float32),
        obs_valid=jnp.ones(O, bool),
        K4=jnp.array([500.0, 500.0, 320.0, 240.0], jnp.float32),
    )
    prob = jax.device_put(prob, dev)
    dt = stream_time(lambda: bundle_adjust(prob, iterations=10), n=5) / 10
    print(f"local_ba (24 KF / 4k pts / 16k obs): {dt:.3f} ms/iter", file=sys.stderr)
    return dt


def bench_global_ba(dev):
    """Full-capacity implicit-Schur PCG global BA (Optimizer.cc:38-152 scale)."""
    import jax
    import jax.numpy as jnp

    from orbslam_jpminipc.solvers.ba import BAProblem
    from orbslam_jpminipc.solvers.gba import bundle_adjust_large

    rng = np.random.default_rng(2)
    K, P, O = 256, 16384, 65536
    prob = BAProblem(
        kf_R=jnp.tile(jnp.eye(3)[None], (K, 1, 1)),
        kf_t=jnp.array(rng.normal(0, 0.1, (K, 3)).astype(np.float32)),
        kf_fixed=jnp.array([True] + [False] * (K - 1)),
        points=jnp.array(
            np.stack([rng.uniform(-3, 3, P), rng.uniform(-3, 3, P),
                      rng.uniform(2, 8, P)], 1).astype(np.float32)
        ),
        point_valid=jnp.ones(P, bool),
        obs_kf=jnp.array(rng.integers(0, K, O).astype(np.int32)),
        obs_pt=jnp.array(rng.integers(0, P, O).astype(np.int32)),
        obs_uv=jnp.array(rng.uniform(0, 640, (O, 2)).astype(np.float32)),
        obs_w=jnp.ones(O, jnp.float32),
        obs_valid=jnp.ones(O, bool),
        K4=jnp.array([500.0, 500.0, 320.0, 240.0], jnp.float32),
    )
    prob = jax.device_put(prob, dev)
    iters = 5
    dt = stream_time(
        lambda: bundle_adjust_large(prob, iterations=iters, cg_iters=32),
        n=2, reps=2, warmup=1,
    ) / iters
    print(f"global_ba (256 KF / 16k pts / 64k obs, cg32): {dt:.3f} ms/iter",
          file=sys.stderr)
    return dt


def bench_essential_graph(dev):
    """Sim3 pose graph at map capacity (Optimizer.cc:1470-1719 scale)."""
    import jax
    import jax.numpy as jnp

    from orbslam_jpminipc.solvers.essential_graph import (
        EssentialGraphProblem, optimize_essential_graph,
    )

    rng = np.random.default_rng(3)
    K, E = 256, 2048
    t_true = np.cumsum(rng.normal(0, 0.1, (K, 3)), 0).astype(np.float32)
    e_i = rng.integers(0, K, E).astype(np.int32)
    e_j = np.minimum(e_i + 1 + rng.integers(0, 8, E), K - 1).astype(np.int32)
    e_t = (t_true[e_j] - t_true[e_i]).astype(np.float32)
    prob = EssentialGraphProblem(
        s=jnp.ones(K, jnp.float32),
        R=jnp.tile(jnp.eye(3)[None], (K, 1, 1)),
        t=jnp.array(t_true + rng.normal(0, 0.05, (K, 3)).astype(np.float32)),
        fixed=jnp.array([True] + [False] * (K - 1)),
        e_i=jnp.array(e_i), e_j=jnp.array(e_j),
        e_s=jnp.ones(E, jnp.float32),
        e_R=jnp.tile(jnp.eye(3)[None], (E, 1, 1)),
        e_t=jnp.array(e_t),
        e_valid=jnp.array(e_i != e_j),
    )
    prob = jax.device_put(prob, dev)
    iters = 20
    dt = stream_time(
        lambda: optimize_essential_graph(prob, iterations=iters),
        n=3, reps=2, warmup=1,
    ) / iters
    print(f"essential_graph (256 KF / 2048 edges): {dt:.3f} ms/iter",
          file=sys.stderr)
    return dt


def bench_e2e():
    """Honest end-to-end run: the full system over a synthetic sequence,
    including keyframe mapping spikes and loop closing. One warmup segment
    triggers any remaining compiles; the timed run starts fresh."""
    import os

    from orbslam_jpminipc.config import SlamConfig
    from orbslam_jpminipc.io.dataset import SyntheticSequence
    from orbslam_jpminipc.io.trajectory import ate_rmse
    from orbslam_jpminipc.pipeline.system import Slam
    from orbslam_jpminipc.vocab.vocabulary import load_vocabulary

    cfg = SlamConfig(fx=500.0, fy=500.0, cx=320.0, cy=240.0,
                     k1=0.0, k2=0.0, p1=0.0, p2=0.0, n_features=1000)
    # the vocabulary run.py ships by default: the 64k-word hierarchical
    # tree (the ORBvoc.txt analogue) — bench measures the shipping config
    voc = load_vocabulary(os.path.join(
        os.path.dirname(os.path.abspath(__file__)),
        "orbslam_jpminipc", "data", "vocab_tree64k.npz"))

    import jax

    n_frames = 120
    seq = SyntheticSequence(n_frames=n_frames, trajectory="xyz", seed=0)
    frames = [seq.get(i) for i in range(n_frames)]

    def run(slam, subset):
        """Stream with one-frame upload prefetch: a live 30 fps camera
        delivers frame i+1 while frame i is processed, so its (async)
        host->device transfer legitimately overlaps frame i's compute."""
        nxt = jax.device_put(subset[0][0])
        for i, (img, ts, _) in enumerate(subset):
            cur = nxt
            if i + 1 < len(subset):
                nxt = jax.device_put(subset[i + 1][0])
            slam.process(cur, ts)
        slam.finish()

    # warmup: compile every steady-state AND recovery-path program (the
    # jit caches are module-level, so one warmed instance warms them all)
    Slam(cfg, vocab=voc).warmup()

    # best-of-2 sequential runs, same policy as stream_time's best-of-reps
    wall = float("inf")
    for _ in range(2):
        slam = Slam(cfg, vocab=voc)
        slam.tracer.reset()  # drop prior-run samples from the percentiles
        t0 = time.perf_counter()
        run(slam, frames)
        wall = min(wall, time.perf_counter() - t0)
    fps = n_frames / wall

    # real-time mode: consume against the 30 fps camera clock and DROP late
    # frames (the reference's live image topic with a depth-1 queue,
    # src/main.cc:169, src/Tracking.cc:166-189). Best-of-2, like the
    # throughput numbers.
    fps_clock = 30.0
    done = dropped = rt_tracked = 0
    for _ in range(2):
        rt = Slam(cfg, vocab=voc)
        t0 = time.perf_counter()
        i = r_done = r_dropped = 0
        pre_i, pre_img = 0, jax.device_put(frames[0][0])
        while i < n_frames:
            # same one-frame upload prefetch as the throughput loop: the
            # camera DMA delivers frame i while frame i-1 is processed, so
            # by the time we consume frame i its host->device transfer has
            # already overlapped earlier compute
            img = pre_img if pre_i == i else frames[i][0]
            ts = frames[i][1]
            if i + 1 < n_frames:
                pre_i, pre_img = i + 1, jax.device_put(frames[i + 1][0])
            rt.process(img, ts)
            r_done += 1
            arrived = int((time.perf_counter() - t0) * fps_clock) + 1
            nxt = min(max(i + 1, arrived), n_frames)
            r_dropped += nxt - (i + 1)
            i = nxt
        rt.finish()
        if r_dropped <= dropped or done == 0:
            done, dropped, rt_tracked = r_done, r_dropped, len(rt.trajectory)
    print(f"realtime@30fps: processed {done}/{n_frames}, dropped {dropped} "
          f"({100.0*dropped/n_frames:.1f}%), tracked {rt_tracked}",
          file=sys.stderr)

    gt = {round(float(seq.timestamps[i]), 6): seq.poses[i] for i in range(n_frames)}
    est_c, gt_c = [], []
    for ts, R, t in slam.trajectory:
        if round(ts, 6) in gt:
            Rg, tg = gt[round(ts, 6)]
            gt_c.append(-Rg.T @ tg)
            est_c.append(-R.T @ t)
    ate = (ate_rmse(np.stack(est_c), np.stack(gt_c))
           if len(est_c) > 10 else float("nan"))
    stages = slam.tracer.summary()
    print(f"e2e: {n_frames} frames in {wall:.1f}s = {fps:.2f} fps, "
          f"{slam.n_keyframes} KFs, {slam.n_points} pts, ATE {ate:.4f} m",
          file=sys.stderr)
    for k, v in stages.items():
        print(f"  stage {k}: p50 {v['p50_ms']} ms  p95 {v['p95_ms']} ms  "
              f"x{v['count']}", file=sys.stderr)
    return {
        "fps": round(fps, 2),
        "realtime_dropped_pct": round(100.0 * dropped / n_frames, 1),
        "realtime_processed": done,
        "realtime_tracked": rt_tracked,
        "frames": n_frames,
        "keyframes": slam.n_keyframes,
        "points": slam.n_points,
        "tracked": len(slam.trajectory),
        "ate_m": round(float(ate), 4),
        "stage_p50_ms": {k: v["p50_ms"] for k, v in stages.items()},
        "stage_p95_ms": {k: v["p95_ms"] for k, v in stages.items()},
    }


def main():
    from orbslam_jpminipc.utils.jaxcache import enable_persistent_cache

    enable_persistent_cache()

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU; JAX's first device is {dev}")
    print(f"device: {dev.device_kind} x{len(jax.devices())}", file=sys.stderr)

    extra = {}
    dt_fused, dt_ex = bench_fused(dev)
    extra["fused_pipeline_fps"] = round(1000.0 / dt_fused, 1)
    extra["orb_extract_ms"] = round(dt_ex, 3)
    for name, fn in (
        ("local_ba_ms_per_iter", bench_local_ba),
        ("global_ba_ms_per_iter", bench_global_ba),
        ("essential_graph_ms_per_iter", bench_essential_graph),
    ):
        extra[name] = round(fn(dev), 3)

    e2e = bench_e2e()
    fps = e2e.pop("fps")
    extra.update(e2e)

    print(json.dumps({
        "metric": "e2e_slam_fps_per_chip",
        "value": fps,
        "unit": "frames/s",
        "vs_baseline": round(fps / 30.0, 3),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "extra": extra,
    }))


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Smoke test: the SLAM main path on one GPU, end to end.

    python chip_smoke.py               # one card: every phase below
    python chip_smoke.py --four-cards  # four cards of one host: only the
                                       # map-partitioned solvers, 4 vs 1

Phases, in order; each is a function that tests/test_chip_smoke.py also
runs on the CPU at tiny sizes:

1. device: JAX's first device must be a GPU (there is no CPU fallback);
   print it, the compile cache, and the card's name and power limit.
2. kernels: each device operation of the tracking path and the three
   solvers at the shipping widths, run on the card and on JAX's CPU
   backend in the same process; the CPU result is the reference.
3. end to end: `python -m orbslam_jpminipc.run --dataset synthetic:xyz
   --frames 300` through `run.main`, in the shipping configuration, gated
   on the tracked fraction, the keyframe count and the keyframe ATE.
4. failure paths: forced loss -> relocalization; save -> load ->
   relocalization into the loaded map.

Every phase raises on failure, so the script then exits nonzero. Only
after all phases pass does it print, as its last line,
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# shipping widths: 640x480 at 8 levels of x1.2, 1000 features, the fused
# step's 4096-point slice, bench.py's solver problem sizes
FULL = dict(width=640, height=480, n_features=1000, n_levels=8,
            n_slice=4096, local_ba=(24, 4096, 16384),
            global_ba=(256, 16384, 65536), cg_iters=32, eg=(256, 2048))


def card_line() -> str:
    """`nvidia-smi`'s name and power limit of every visible card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()


# ----------------------------------------------------------------- phase 1


def phase_device(platform: str = "gpu", count: int = 1):
    """The first `count` devices, which must be of `platform`."""
    import jax

    from orbslam_jpminipc.utils.jaxcache import cache_dir

    devs = jax.devices()
    if devs[0].platform != platform:
        raise RuntimeError(
            f"needs a {platform}: JAX's first device is {devs[0].platform} "
            f"({devs[0].device_kind}); there is no fallback")
    if len(devs) < count:
        raise RuntimeError(f"needs {count} {platform} devices, found {len(devs)}")
    print(f"device: {devs[0].device_kind} x{len(devs)} ({devs[0].platform}), "
          f"jax {jax.__version__}")
    print(f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}  "
          f"compile cache: {cache_dir()}")
    if platform == "gpu":
        print(f"card: {card_line()}")
    return devs[:count]


# ----------------------------------------------------------------- phase 2


def _run(dev, fn, *args):
    """fn(*args) with its inputs committed to `dev`; the result on the host."""
    import jax

    with jax.default_device(dev):
        return jax.device_get(fn(*jax.device_put(args, dev)))


def ba_problem(n_kf: int, n_pts: int, n_obs: int, seed: int):
    """A bundle-adjustment problem at bench.py's shapes whose observations
    are the noisy (1 px) projections of a true scene, started from
    perturbed poses and points, so that LM converges. Every point is seen
    from at least 3 keyframes, as the mapper's culling demands of a map
    point (LocalMapping.cc MapPointCulling); the rest of the observations
    are drawn at random. Returns (problem, scene extent in m)."""
    import jax.numpy as jnp

    from orbslam_jpminipc.solvers.ba import BAProblem

    rng = np.random.default_rng(seed)
    K4 = np.array([500.0, 500.0, 320.0, 240.0], np.float32)
    xyz = np.stack([rng.uniform(-2, 2, n_pts), rng.uniform(-1.5, 1.5, n_pts),
                    rng.uniform(3, 6, n_pts)], 1).astype(np.float32)
    t_true = np.stack([np.linspace(-1, 1, n_kf), 0.2 * rng.normal(size=n_kf),
                       0.2 * rng.normal(size=n_kf)], 1).astype(np.float32)
    three = np.argsort(rng.random((n_pts, n_kf)), axis=1)[:, :3]
    n_rand = n_obs - three.size
    obs_kf = np.concatenate([three.reshape(-1), rng.integers(0, n_kf, n_rand)]).astype(np.int32)
    obs_pt = np.concatenate([np.repeat(np.arange(n_pts), 3),
                             rng.integers(0, n_pts, n_rand)]).astype(np.int32)
    xc = xyz[obs_pt] + t_true[obs_kf]
    uv = K4[:2] * xc[:, :2] / xc[:, 2:] + K4[2:]
    uv = (uv + rng.normal(0, 1.0, uv.shape)).astype(np.float32)
    kf_t = t_true + rng.normal(0, 0.02, t_true.shape).astype(np.float32)
    kf_t[0] = t_true[0]
    prob = BAProblem(
        kf_R=jnp.tile(jnp.eye(3)[None], (n_kf, 1, 1)),
        kf_t=jnp.asarray(kf_t),
        kf_fixed=jnp.asarray(np.arange(n_kf) == 0),
        points=jnp.asarray(xyz + rng.normal(0, 0.05, xyz.shape).astype(np.float32)),
        point_valid=jnp.ones(n_pts, bool),
        obs_kf=jnp.asarray(obs_kf), obs_pt=jnp.asarray(obs_pt),
        obs_uv=jnp.asarray(uv), obs_w=jnp.ones(n_obs, jnp.float32),
        obs_valid=jnp.ones(n_obs, bool), K4=jnp.asarray(K4),
    )
    return prob, float(xyz.max() - xyz.min())


def eg_problem(n_kf: int, n_edges: int, seed: int):
    """bench.py's essential-graph problem (a noisy chain with skip edges).
    Returns (problem, trajectory extent in m)."""
    import jax.numpy as jnp

    from orbslam_jpminipc.solvers.essential_graph import EssentialGraphProblem

    rng = np.random.default_rng(seed)
    t_true = np.cumsum(rng.normal(0, 0.1, (n_kf, 3)), 0).astype(np.float32)
    e_i = rng.integers(0, n_kf, n_edges).astype(np.int32)
    e_j = np.minimum(e_i + 1 + rng.integers(0, 8, n_edges), n_kf - 1).astype(np.int32)
    prob = EssentialGraphProblem(
        s=jnp.ones(n_kf, jnp.float32),
        R=jnp.tile(jnp.eye(3)[None], (n_kf, 1, 1)),
        t=jnp.asarray(t_true + rng.normal(0, 0.05, (n_kf, 3)).astype(np.float32)),
        fixed=jnp.asarray(np.arange(n_kf) == 0),
        e_i=jnp.asarray(e_i), e_j=jnp.asarray(e_j),
        e_s=jnp.ones(n_edges, jnp.float32),
        e_R=jnp.tile(jnp.eye(3)[None], (n_edges, 1, 1)),
        e_t=jnp.asarray(t_true[e_j] - t_true[e_i]),
        e_valid=jnp.asarray(e_i != e_j),
    )
    return prob, float(np.linalg.norm(t_true.max(0) - t_true.min(0)))


def _check(name: str, ok: bool, detail: str):
    print(f"  {name}: {detail} -> {'ok' if ok else 'FAILED'}")
    if not ok:
        raise AssertionError(f"{name}: {detail}")


def _compare_solution(name, got, ref, extent, x0_chi2):
    """Converged LM solutions from two devices agree: chi2 within 1 % and
    every point and camera centre within 1 % of the scene extent. The
    devices sum in different orders, so the LM paths part at the f32
    rounding level; bit equality is not expected."""
    rel = abs(float(got.chi2) - float(ref.chi2)) / max(float(ref.chi2), 1e-9)
    _check(f"{name} chi2", rel <= 1e-2 and float(ref.chi2) < x0_chi2,
           f"{float(got.chi2):.6g} vs {float(ref.chi2):.6g} (rel {rel:.2e} <= 1e-2; "
           f"start {x0_chi2:.6g})")
    dp = float(np.abs(np.asarray(got.points) - np.asarray(ref.points)).max())
    dt = float(np.abs(np.asarray(got.kf_t) - np.asarray(ref.kf_t)).max())
    _check(f"{name} parameters", max(dp, dt) <= 1e-2 * extent,
           f"max point diff {dp:.3g} m, max translation diff {dt:.3g} m "
           f"(<= 1% of extent {extent:.3g} m)")


def hamming_lowering(dev, d1, d2) -> str:
    """What XLA compiles hamming_matrix's int8 dot into on `dev`."""
    import re

    import jax

    from orbslam_jpminipc.ops.hamming import hamming_matrix

    text = jax.jit(hamming_matrix).lower(
        jax.device_put(d1, dev), jax.device_put(d2, dev)).compile().as_text()
    targets = sorted(set(re.findall(r'custom_call_target="([^"]+)"', text)))
    dots = [ln.strip() for ln in text.splitlines() if " dot(" in ln]
    kinds = sorted(set(re.findall(r'"kind":"(\w+)"', text)))
    return (f"custom calls {targets or 'none'}; {len(dots)} dot op(s)"
            + (f" e.g. {dots[0][:160]}" if dots else "")
            + (f"; fusion kinds {kinds}" if kinds else ""))


def phase_kernels(dev, ref, sizes=FULL):
    """Every device op of the tracking path and the solvers on `dev`,
    compared with the same op on `ref` (JAX's CPU backend on the card's
    host). Raises on the first disagreement beyond its stated tolerance."""
    import jax
    import jax.numpy as jnp

    import __graft_entry__
    from orbslam_jpminipc.io.dataset import SyntheticSequence
    from orbslam_jpminipc.ops import extractor, fast, hamming, orb, pyramid
    from orbslam_jpminipc.solvers import ba, essential_graph, gba
    from orbslam_jpminipc.vocab import tree
    from orbslam_jpminipc.vocab.vocabulary import load_vocabulary

    w, h, nf, nl = sizes["width"], sizes["height"], sizes["n_features"], sizes["n_levels"]
    print(f"kernels on {dev.device_kind} vs {ref.device_kind} (reference):")
    seq = SyntheticSequence(n_frames=300, width=w, height=h, trajectory="xyz",
                            K4=(500.0 * w / 640, 500.0 * w / 640, w / 2, h / 2))
    img = jnp.asarray(seq.render(0), jnp.float32)

    # FAST score + nonmax per pyramid level: identical level images in,
    # min/max of integer-valued differences -> bit-exact
    levels = _run(ref, lambda x: pyramid.build_pyramid(x, nl, 1.2), img)
    detect = jax.jit(fast.detect, static_argnames=("threshold", "border"))
    for lvl, im in enumerate(levels):
        f = lambda x: detect(x, threshold=7.0, border=extractor.EDGE_THRESHOLD)
        a, b = _run(dev, f, im), _run(ref, f, im)
        _check(f"fast level {lvl} {im.shape[1]}x{im.shape[0]}",
               np.array_equal(a, b), f"{int((b > 0).sum())} corners, bit-exact")

    # rBRIEF sampling: the bf16 one-hot einsum is exact for intensities
    # <= 255, so identical patches and angles give identical descriptors
    rng = np.random.default_rng(0)
    patches = rng.integers(0, 256, (nf, orb.PATCH_SIZE, orb.PATCH_SIZE)).astype(np.float32)
    angles = rng.uniform(0, 360, nf).astype(np.float32)
    f = jax.jit(orb.descriptors_from_patches)
    _check("orb sampling einsum (bf16 one-hot)",
           np.array_equal(_run(dev, f, patches, angles), _run(ref, f, patches, angles)),
           f"{nf} descriptors, bit-exact")

    # whole extraction: the pyramid's resize is an f32 dot that the GPU
    # may round differently (FMA), so keypoints are compared as sets
    ext = lambda x: extractor.extract(x, n_features=nf, n_levels=nl)
    fa, fb = _run(dev, ext, img), _run(ref, ext, img)
    key = lambda fs: {(int(x), int(y), int(l)): i for i, ((x, y), l, v) in
                      enumerate(zip(fs.xy, fs.level, fs.valid)) if v}
    ka, kb = key(fa), key(fb)
    both = sorted(set(ka) & set(kb))
    ia = np.array([ka[k] for k in both], int)
    ib = np.array([kb[k] for k in both], int)
    same_ang = fa.angle[ia] == fb.angle[ib]
    desc_same = (fa.desc[ia] == fb.desc[ib]).all(axis=1)
    print(f"  extract: {len(ka)} / {len(kb)} keypoints, {len(both)} shared, "
          f"{int(same_ang.sum())} equal angles, {int(desc_same.sum())} equal "
          f"descriptors ({'exact' if len(both) == len(kb) == len(ka) and desc_same.all() else 'not exact'})")
    _check("extract keypoints", len(both) >= 0.99 * max(len(ka), len(kb)),
           f"{len(both)} of {max(len(ka), len(kb))} shared (>= 99%)")
    ang_diff = float(np.abs(fa.angle[ia] - fb.angle[ib]).max()) if len(both) else 0.0
    _check("extract angles", ang_diff <= 1e-3, f"max diff {ang_diff:.2g} deg (<= 1e-3)")
    _check("extract descriptors", desc_same[same_ang].all() and desc_same.mean() >= 0.99,
           "identical wherever the angle is identical, >= 99% overall")

    # Hamming: the int8 dot form against the XOR + popcount form
    d1 = np.asarray(fb.desc)
    d2 = rng.integers(0, 256, (sizes["n_slice"], 32)).astype(np.uint8)
    hm = jax.jit(hamming.hamming_matrix)
    ha, hb = _run(dev, hm, d1, d2), _run(ref, hm, d1, d2)
    hp = _run(dev, jax.jit(lambda a, b: hamming.hamming_pairwise(a[:, None], b[None])), d1, d2)
    _check(f"hamming_matrix {d1.shape[0]}x{d2.shape[0]}",
           np.array_equal(ha, hb) and np.array_equal(ha, hp),
           "bit-exact vs reference and vs XOR+population_count")
    print(f"  hamming_matrix lowering on {dev.platform}: {hamming_lowering(dev, d1, d2)}")

    # tree vocabulary descent on the frame's descriptors
    voc = load_vocabulary(os.path.join(HERE, "orbslam_jpminipc", "data", "vocab_tree64k.npz"))
    desc = lambda d, c, n, wd: tree._descend(d, c, n, wd, voc.depth)
    args = (d1, voc.child_idx, voc.node_desc, voc.node_word)
    _check(f"tree vocabulary ({voc.n_words} words)",
           np.array_equal(_run(dev, desc, *args), _run(ref, desc, *args)),
           f"{d1.shape[0]} word ids, bit-exact")

    # fused tracking step on entry()'s arguments
    outs = []
    for d in (dev, ref):
        with jax.default_device(d):
            step, fargs = __graft_entry__.entry(w, h, nf, sizes["n_slice"])
            outs.append(_run(d, step, *fargs).pull)
    pa, pb = outs
    posa, posb = pa[:16].view(np.float32), pb[:16].view(np.float32)
    dpose = float(np.abs(posa[:12] - posb[:12]).max())
    _check("fused step pose", dpose <= 1e-4, f"max diff {dpose:.2g} (<= 1e-4)")
    _check("fused step inlier/match counts", np.array_equal(posa[12:], posb[12:]),
           f"{posa[12:].astype(int).tolist()} equal")
    agree = float((pa[16:] == pb[16:]).mean())
    _check("fused step bindings and flags", agree >= 0.99, f"{agree:.4f} agree (>= 0.99)")

    # solvers at bench.py's sizes
    prob, ext_m = ba_problem(*sizes["local_ba"], seed=1)
    x0 = float(ba._robust_chi2(prob, prob.kf_R, prob.kf_t, prob.points))
    f = lambda p: ba.bundle_adjust(p, iterations=10)
    _compare_solution("local BA %d/%d/%d" % sizes["local_ba"],
                      _run(dev, f, prob), _run(ref, f, prob), ext_m, x0)

    prob, ext_m = ba_problem(*sizes["global_ba"], seed=2)
    x0 = float(ba._robust_chi2(prob, prob.kf_R, prob.kf_t, prob.points))
    f = lambda p: gba.bundle_adjust_large(p, iterations=10, cg_iters=sizes["cg_iters"])
    _compare_solution("global BA %d/%d/%d" % sizes["global_ba"],
                      _run(dev, f, prob), _run(ref, f, prob), ext_m, x0)

    prob, ext_m = eg_problem(*sizes["eg"], seed=3)
    f = lambda p: essential_graph.optimize_essential_graph(p, iterations=20)
    ra, rb = _run(dev, f, prob), _run(ref, f, prob)
    rel = abs(float(ra.chi2) - float(rb.chi2)) / max(float(rb.chi2), 1e-9)
    dt = float(np.abs(ra.t - rb.t).max())
    _check("essential graph %d/%d" % sizes["eg"], rel <= 1e-2 and dt <= 1e-2 * ext_m,
           f"chi2 rel {rel:.2e} (<= 1e-2), max translation diff {dt:.3g} m "
           f"(<= 1% of extent {ext_m:.3g} m)")


# ----------------------------------------------------------------- phase 3


def kf_ate(slam, gt) -> tuple[float, float]:
    """(keyframe-trajectory ATE after Sim3 alignment, ground-truth extent)."""
    from orbslam_jpminipc.io.trajectory import ate_rmse

    est, ref = [], []
    for ts, R, t in slam.keyframe_trajectory():
        if round(ts, 6) in gt:
            Rg, tg = gt[round(ts, 6)]
            ref.append(-Rg.T @ tg)
            est.append(-R.T @ t)
    if len(est) < 3:
        return float("inf"), 0.0
    ref = np.stack(ref)
    all_gt = np.stack([-R.T @ t for R, t in gt.values()])
    extent = float(np.linalg.norm(all_gt.max(0) - all_gt.min(0)))
    return ate_rmse(np.stack(est), ref), extent


def phase_end_to_end(frames: int = 300, warmup: bool = True,
                     min_tracked: float = 0.9, min_kf: int = 3,
                     max_ate_frac: float = 0.02) -> dict:
    """`python -m orbslam_jpminipc.run --dataset synthetic:xyz --frames N`
    in the shipping configuration, through run.main, with the gates."""
    from orbslam_jpminipc import native, run

    with tempfile.TemporaryDirectory() as tmp:
        argv = ["--dataset", "synthetic:xyz", "--frames", str(frames),
                "--out", os.path.join(tmp, "KeyFrameTrajectory.txt")]
        res = run.main(argv + ([] if warmup else ["--no-warmup"]))
    slam = res["slam"]
    tracked = len(slam.trajectory) / res["frames"]
    ate, extent = kf_ate(slam, res["gt"])
    print(f"end to end: {res['frames']} frames in {res['wall_s']:.2f} s = "
          f"{res['frames'] / res['wall_s']:.2f} frames/s, warmup "
          f"{res['warmup_s'] if res['warmup_s'] is None else round(res['warmup_s'], 2)} s, "
          f"native map-graph library "
          f"{'loaded' if native.get_lib() is not None else 'absent (Python fallback)'}")
    _check("tracked frames", tracked >= min_tracked,
           f"{len(slam.trajectory)}/{res['frames']} (>= {min_tracked:.0%})")
    _check("keyframes", slam.n_keyframes >= min_kf, f"{slam.n_keyframes} (>= {min_kf})")
    _check("keyframe ATE", ate <= max_ate_frac * extent,
           f"{ate:.4g} m = {100 * ate / max(extent, 1e-9):.3g}% of extent "
           f"{extent:.3g} m (<= {100 * max_ate_frac:g}%)")
    return {"tracked": tracked, "keyframes": slam.n_keyframes, "ate_m": ate,
            "extent_m": extent}


# ----------------------------------------------------------------- phase 4


def _shipping_slam():
    from orbslam_jpminipc.config import SlamConfig
    from orbslam_jpminipc.pipeline.system import Slam
    from orbslam_jpminipc.vocab.vocabulary import load_vocabulary

    voc = load_vocabulary(os.path.join(HERE, "orbslam_jpminipc", "data", "vocab_tree64k.npz"))
    cfg = SlamConfig(fx=500.0, fy=500.0, cx=320.0, cy=240.0,
                     k1=0.0, k2=0.0, p1=0.0, p2=0.0, n_features=1000)
    return lambda: Slam(cfg, vocab=voc)


def phase_forced_loss(lost_at: int = 60, within: int = 20) -> int:
    """tests/test_pipeline.py's forced-loss probe: `lost_at` orbit frames,
    three noise frames, then WORKING again within `within` frames.
    Returns the frame at which tracking resumed."""
    from orbslam_jpminipc.io.dataset import SyntheticSequence

    seq = SyntheticSequence(n_frames=300, trajectory="orbit", seed=0)
    slam = _shipping_slam()()
    for i in range(lost_at):
        slam.process(*seq.get(i)[:2])
    rng = np.random.default_rng(5)
    for j in range(3):
        slam.process(rng.integers(0, 256, (480, 640)).astype(np.uint8),
                     (lost_at + j) / 30.0)
    recovered = None
    for i in range(lost_at + 3, lost_at + 3 + within):
        state, _ = slam.process(*seq.get(i)[:2])
        if state.name == "WORKING":
            recovered = i
            break
    slam.finish()
    _check("forced loss", recovered is not None,
           f"3 noise frames after frame {lost_at}: "
           f"{'WORKING again at frame %d' % recovered if recovered else 'never recovered'}"
           f" (within {within})")
    return recovered


def phase_save_load(mapped: int = 25) -> int:
    """tests/test_checkpoint.py's round trip through io/checkpoint.py: map
    `mapped` frames, save, load into a fresh system, relocalize on frames
    from the mapped stretch. Returns the frame that relocalized."""
    from orbslam_jpminipc.frontend.tracking import TrackState
    from orbslam_jpminipc.io.checkpoint import load_slam, save_slam
    from orbslam_jpminipc.io.dataset import SyntheticSequence

    make = _shipping_slam()
    seq = SyntheticSequence(n_frames=45, trajectory="xyz", seed=3)
    slam = make()
    for i in range(mapped):
        slam.process(*seq.get(i)[:2])
    slam.finish()
    _check("mapped before save", slam.n_keyframes >= 3, f"{slam.n_keyframes} keyframes (>= 3)")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "world.npz")
        save_slam(path, slam)
        slam2 = make()
        load_slam(path, slam2)
    _check("loaded map", (slam2.n_keyframes, slam2.n_points) == (slam.n_keyframes, slam.n_points)
           and slam2.tracker.state == TrackState.LOST,
           f"{slam2.n_keyframes} keyframes, {slam2.n_points} points, {slam2.tracker.state.name}")
    reloc = None
    for i in range(10, mapped):
        state, _ = slam2.process(*seq.get(i)[:2])
        if state == TrackState.WORKING:
            reloc = i
            break
    slam2.finish()
    _check("relocalized into the loaded map", reloc is not None,
           f"{'at frame %d' % reloc if reloc is not None else 'never'}")
    return reloc


# ---------------------------------------------------- option --four-cards


def phase_four_cards(devices, global_ba=FULL["global_ba"], eg=FULL["eg"],
                     iterations: int = 10):
    """The map-partitioned solvers over all of `devices` against one
    device: point-sharded BA (parallel/sharded_ba.py) vs the same program
    on a one-device mesh, and edge-sharded essential graph
    (parallel/sharded_pose_graph.py, what loop closing runs on a
    multi-device host) vs the single-device optimizer."""
    from jax.sharding import Mesh

    from orbslam_jpminipc.parallel import (
        shard_ba_problem, shard_essential_graph, sharded_bundle_adjust,
        sharded_optimize_essential_graph,
    )
    from orbslam_jpminipc.solvers import ba, essential_graph

    n = len(devices)
    print(f"map-partitioned solvers: {n} x {devices[0].device_kind} vs 1")
    prob, ext_m = ba_problem(*global_ba, seed=2)
    x0 = float(ba._robust_chi2(prob, prob.kf_R, prob.kf_t, prob.points))
    sols = []
    for k in (1, n):
        mesh = Mesh(np.array(devices[:k]), ("points",))
        t0 = time.perf_counter()
        R, t, pts, chi2, _ = sharded_bundle_adjust(
            shard_ba_problem(prob, k), mesh, iterations=iterations)
        pts.block_until_ready()
        print(f"  sharded BA on {k}: {time.perf_counter() - t0:.2f} s incl. compile; "
              f"point shards on {sorted(str(s.device) for s in pts.addressable_shards)}")
        sols.append(ba.BAResult(kf_R=np.asarray(R), kf_t=np.asarray(t),
                                points=np.asarray(pts).reshape(-1, 3)[: global_ba[1]],
                                chi2=float(chi2), obs_outlier=None))
    _compare_solution(f"sharded BA {n} vs 1, %d/%d/%d" % global_ba, sols[1], sols[0],
                      ext_m, x0)

    gprob, ext_m = eg_problem(*eg, seed=3)
    mesh = Mesh(np.array(devices), ("edges",))
    sg = shard_essential_graph(gprob, n)
    res = sharded_optimize_essential_graph(sg, mesh, iterations=20)
    print(f"  sharded essential graph: result on {sorted(str(d) for d in res.t.devices())}")
    one = essential_graph.optimize_essential_graph(gprob, iterations=20)
    rel = abs(float(res.chi2) - float(one.chi2)) / max(float(one.chi2), 1e-9)
    dt = float(np.abs(np.asarray(res.t) - np.asarray(one.t)).max())
    _check(f"sharded essential graph {n} vs 1, %d/%d" % eg,
           rel <= 1e-2 and dt <= 1e-2 * ext_m,
           f"chi2 {float(res.chi2):.6g} vs {float(one.chi2):.6g} (rel {rel:.2e} <= 1e-2), "
           f"max translation diff {dt:.3g} m (<= 1% of extent {ext_m:.3g} m)")


# ------------------------------------------------------------------- main


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the map-partitioned solvers on 4 cards vs 1")
    args = ap.parse_args(argv)

    # the CPU backend is the kernels' reference: keep it beside the GPU
    plats = os.environ.get("JAX_PLATFORMS")
    if plats and "cpu" not in plats.split(","):
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"
    sys.path.insert(0, HERE)
    from orbslam_jpminipc.utils.jaxcache import enable_persistent_cache

    enable_persistent_cache()
    import jax

    t0 = time.perf_counter()
    if args.four_cards:
        devs = phase_device("gpu", count=4)
        phase_four_cards(devs)
    else:
        (dev,) = phase_device("gpu")
        phase_kernels(dev, jax.devices("cpu")[0])
        phase_end_to_end()
        phase_forced_loss()
        phase_save_load()
    dev = jax.devices()[0]
    print(f"all phases passed in {time.perf_counter() - t0:.1f} s on: {card_line()}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

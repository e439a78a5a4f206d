"""Multi-device scaling measurement: sharded GBA + pose graph at capacity.

Runs the map-partitioned bundle adjustment and the edge-sharded essential
graph on 1/2/4/8 devices of a virtual CPU mesh (the same shard_map
programs run unchanged on several accelerators of one host) and records
ms/iteration + single-device parity. Output: SCALING_r05.json (override with --out).

Usage: python tools/scaling.py  (forces JAX_PLATFORMS=cpu, 8 host devices)
"""
from __future__ import annotations

import json
import os
import sys
import time

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def make_gba_problem(K=256, P=16384, O=65536, seed=2):
    """GEOMETRICALLY CONSISTENT problem (true points projected with pixel
    noise + perturbed initial state): on a random-uv problem the LM
    accept/reject trajectory is chaotic and cross-device parity numbers
    are meaningless."""
    import jax.numpy as jnp
    from orbslam_jpminipc.solvers.ba import BAProblem

    rng = np.random.default_rng(seed)
    pts_true = np.stack([
        rng.uniform(-3, 3, P), rng.uniform(-3, 3, P), rng.uniform(4, 10, P)
    ], 1).astype(np.float32)
    t_true = rng.normal(0, 0.2, (K, 3)).astype(np.float32)
    obs_kf = rng.integers(0, K, O).astype(np.int32)
    obs_pt = rng.integers(0, P, O).astype(np.int32)
    xc = pts_true[obs_pt] + t_true[obs_kf]
    uv = np.stack([500 * xc[:, 0] / xc[:, 2] + 320,
                   500 * xc[:, 1] / xc[:, 2] + 240], 1)
    uv += rng.normal(0, 0.5, uv.shape)
    return BAProblem(
        kf_R=jnp.tile(jnp.eye(3)[None], (K, 1, 1)),
        kf_t=jnp.array(t_true + rng.normal(0, 0.02, (K, 3)).astype(np.float32)),
        kf_fixed=jnp.array([True] + [False] * (K - 1)),
        points=jnp.array(pts_true + rng.normal(0, 0.05, (P, 3)).astype(np.float32)),
        point_valid=jnp.ones(P, bool),
        obs_kf=jnp.array(obs_kf),
        obs_pt=jnp.array(obs_pt),
        obs_uv=jnp.array(uv.astype(np.float32)),
        obs_w=jnp.ones(O, jnp.float32),
        obs_valid=jnp.ones(O, bool),
        K4=jnp.array([500.0, 500.0, 320.0, 240.0], jnp.float32),
    )


def make_eg_problem(K=256, E=2048, seed=3):
    import jax.numpy as jnp
    from orbslam_jpminipc.solvers.essential_graph import EssentialGraphProblem

    rng = np.random.default_rng(seed)
    t_true = np.cumsum(rng.normal(0, 0.1, (K, 3)), 0).astype(np.float32)
    e_i = rng.integers(0, K, E).astype(np.int32)
    e_j = np.minimum(e_i + 1 + rng.integers(0, 8, E), K - 1).astype(np.int32)
    return EssentialGraphProblem(
        s=jnp.ones(K, jnp.float32),
        R=jnp.tile(jnp.eye(3)[None], (K, 1, 1)),
        t=jnp.array(t_true + rng.normal(0, 0.05, (K, 3)).astype(np.float32)),
        fixed=jnp.array([True] + [False] * (K - 1)),
        e_i=jnp.array(e_i), e_j=jnp.array(e_j),
        e_s=jnp.ones(E, jnp.float32),
        e_R=jnp.tile(jnp.eye(3)[None], (E, 1, 1)),
        e_t=jnp.array((t_true[e_j] - t_true[e_i]).astype(np.float32)),
        e_valid=jnp.array(e_i != e_j),
    )


def time_call(fn, reps=3):
    import jax

    jax.block_until_ready(fn())
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        best = min(best, time.perf_counter() - t0)
    return best * 1e3


def main():
    import jax
    from jax.sharding import Mesh
    from orbslam_jpminipc.parallel import (
        shard_ba_problem, sharded_bundle_adjust,
        shard_essential_graph, sharded_optimize_essential_graph,
    )

    devs = jax.devices()
    print(f"{len(devs)} virtual devices", file=sys.stderr)
    gprob = make_gba_problem()
    eprob = make_eg_problem()
    iters = 5
    out = {"gba_ms_per_iter": {}, "eg_ms_per_iter": {},
           "shape": {"K": 256, "P": 16384, "O": 65536, "E": 2048}}
    # scene extent for the relative parity yardstick (points span ~6 x 6 x 6 m)
    extent = float(np.asarray(gprob.points).max() - np.asarray(gprob.points).min())
    out["scene_extent_m"] = round(extent, 3)
    conv_iters = 30  # parity is measured at CONVERGENCE: after a handful of
    # iterations the f32 shard-order rounding flips LM accept bits and the
    # trajectories differ transiently; the gauge-fixed optimum they converge
    # to is unique, and that is what multi-device correctness means
    ref_pts = ref_chi = None
    for n in (1, 2, 4, 8):
        mesh = Mesh(np.array(devs[:n]), ("points",))
        sprob = shard_ba_problem(gprob, n)
        dt = time_call(lambda: sharded_bundle_adjust(sprob, mesh, iterations=iters))
        out["gba_ms_per_iter"][n] = round(dt / iters, 2)
        R, t, pts, chi, _out = sharded_bundle_adjust(
            sprob, mesh, iterations=conv_iters)
        flat = np.asarray(pts).reshape(-1, 3)
        print(f"n={n} pts {np.asarray(pts).shape} chi={float(chi):.1f}",
              file=sys.stderr)
        if ref_pts is None:
            ref_pts = flat
            ref_chi = float(chi)
            out["gba_chi2_1dev"] = float(chi)
        else:
            m = min(len(flat), len(ref_pts))
            md = float(np.abs(flat[:m] - ref_pts[:m]).max())
            out[f"gba_parity_maxdiff_{n}dev"] = md
            out[f"gba_parity_pct_extent_{n}dev"] = round(100.0 * md / extent, 3)
            out[f"gba_chi2_{n}dev"] = float(chi)
            out[f"gba_chi2_rel_{n}dev"] = round(
                abs(float(chi) - ref_chi) / max(ref_chi, 1e-9), 5)
        emesh = Mesh(np.array(devs[:n]), ("edges",))
        esp = shard_essential_graph(eprob, n)
        dte = time_call(lambda: sharded_optimize_essential_graph(
            esp, emesh, iterations=20))
        out["eg_ms_per_iter"][n] = round(dte / 20, 2)
        print(f"n={n}: gba {out['gba_ms_per_iter'][n]} ms/iter, "
              f"eg {out['eg_ms_per_iter'][n]} ms/iter", file=sys.stderr)

    out_path = sys.argv[sys.argv.index("--out") + 1] if "--out" in sys.argv \
        else "SCALING_r05.json"
    with open(out_path, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()

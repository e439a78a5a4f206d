"""Worker process for the multi-host distributed-BA test.

Launched N times by tests/test_multihost.py:
    python multihost_worker.py <pid> <nproc> <port>

Every process builds the same synthetic BA problem, joins the distributed
runtime (1 CPU device per process), runs the map-partitioned sharded BA
over the global mesh, and checks the result against the single-device
solver computed locally. Prints MULTIHOST_OK on success.
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def build_problem():
    import jax.numpy as jnp
    from orbslam_jpminipc.solvers.ba import BAProblem

    rng = np.random.default_rng(0)
    K, Pn = 6, 96
    xyz = np.stack(
        [rng.uniform(-1, 1, Pn), rng.uniform(-1, 1, Pn), rng.uniform(3, 6, Pn)], 1
    ).astype(np.float32)
    kf_R = np.tile(np.eye(3, dtype=np.float32), (K, 1, 1))
    kf_t = np.stack([np.array([-0.25 * k, 0, 0], np.float32) for k in range(K)])
    obs_kf, obs_pt, obs_uv = [], [], []
    for k in range(K):
        xc = xyz @ kf_R[k].T + kf_t[k]
        uv = np.stack(
            [500 * xc[:, 0] / xc[:, 2] + 320, 500 * xc[:, 1] / xc[:, 2] + 240], 1
        )
        for p in range(Pn):
            obs_kf.append(k)
            obs_pt.append(p)
            obs_uv.append(uv[p] + rng.normal(0, 0.3, 2))
    O = len(obs_kf)
    return BAProblem(
        kf_R=jnp.array(kf_R),
        kf_t=jnp.array(kf_t + np.concatenate(
            [np.zeros((1, 3)), rng.normal(0, 0.01, (K - 1, 3))]
        ).astype(np.float32)),
        kf_fixed=jnp.array([True] + [False] * (K - 1)),
        points=jnp.array(xyz + rng.normal(0, 0.02, xyz.shape).astype(np.float32)),
        point_valid=jnp.ones(Pn, bool),
        obs_kf=jnp.array(obs_kf, jnp.int32),
        obs_pt=jnp.array(obs_pt, jnp.int32),
        obs_uv=jnp.array(np.array(obs_uv), jnp.float32),
        obs_w=jnp.ones(O, jnp.float32),
        obs_valid=jnp.ones(O, bool),
        K4=jnp.array([500.0, 500.0, 320.0, 240.0], jnp.float32),
    )


def main():
    pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    # join the runtime BEFORE any import that touches the XLA backend
    # (package modules build jnp constants at import time)
    import jax

    jax.distributed.initialize(f"localhost:{port}", nproc, pid)
    from orbslam_jpminipc.parallel.multihost import (
        global_mesh, lift_sharded_problem,
    )

    assert jax.device_count() == nproc, jax.device_count()

    from orbslam_jpminipc.solvers.ba import bundle_adjust
    from orbslam_jpminipc.parallel.sharded_ba import (
        shard_ba_problem, sharded_bundle_adjust,
    )

    prob = build_problem()
    mesh = global_mesh("points")
    sprob = lift_sharded_problem(shard_ba_problem(prob, nproc), mesh)
    R, t, pts, chi2, _out = sharded_bundle_adjust(sprob, mesh, iterations=10)
    R = np.asarray(R)
    t = np.asarray(t)
    chi2 = float(chi2)

    # single-device truth (local, independent of the mesh)
    ref = bundle_adjust(prob, iterations=10)
    assert np.isfinite(chi2)
    np.testing.assert_allclose(R, np.asarray(ref.kf_R), atol=5e-4)
    np.testing.assert_allclose(t, np.asarray(ref.kf_t), atol=5e-4)
    print(f"MULTIHOST_OK pid={pid} chi2={chi2:.3f}", flush=True)


if __name__ == "__main__":
    main()

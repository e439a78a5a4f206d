"""Isolated device-time profile of the mapping-stage kernels.

Times each hot kernel with the shipping shapes (n_feat = 2*n_features,
TRI_NEIGHBORS / FUSE_TARGETS capacities, local-BA capacities) so we can see
which kernel actually occupies the device between tracker steps.
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax
import jax.numpy as jnp

from orbslam_jpminipc.config import SlamConfig
from orbslam_jpminipc.map.device_map import (
    DeviceMap, tri_kernel, fuse_kernel, local_ba_kernel,
)
from orbslam_jpminipc.map.map_state import MapState, _point_attrs
from orbslam_jpminipc.pipeline.local_mapping import TRI_NEIGHBORS, FUSE_TARGETS


def timeit(name, fn, n=10):
    out = fn()
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn()
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / n * 1e3
    print(f"{name:24s} {dt:8.2f} ms")
    return dt


def main():
    cfg = SlamConfig()
    rng = np.random.default_rng(0)
    F = 2 * cfg.n_features
    st = MapState.create(cfg.max_kf, cfg.max_mp, F, cfg.max_obs)
    dm = DeviceMap(cfg.max_kf, F, cfg.max_mp)
    # fill mirror with random plausible data
    dm.kf_desc = jnp.asarray(rng.integers(0, 256, (cfg.max_kf, F, 32), dtype=np.uint8))
    dm.kf_xy = jnp.asarray(rng.uniform(0, 640, (cfg.max_kf, F, 2)).astype(np.float32))
    dm.kf_angle = jnp.asarray(rng.uniform(0, 360, (cfg.max_kf, F)).astype(np.float32))
    dm.kf_level = jnp.asarray(rng.integers(0, 8, (cfg.max_kf, F), dtype=np.int32))
    dm.kf_feat_valid = jnp.asarray(np.ones((cfg.max_kf, F), bool))
    dm.kf_t = jnp.asarray(rng.normal(0, 1, (cfg.max_kf, 3)).astype(np.float32))
    dm.mp_xyz = jnp.asarray(rng.normal(0, 2, (cfg.max_mp, 3)).astype(np.float32) + np.array([0, 0, 5], np.float32))
    dm.mp_desc = jnp.asarray(rng.integers(0, 256, (cfg.max_mp, 32), dtype=np.uint8))
    dm.mp_min_dist = jnp.asarray(np.full(cfg.max_mp, 0.5, np.float32))
    dm.mp_max_dist = jnp.asarray(np.full(cfg.max_mp, 10.0, np.float32))
    dm.mp_valid = jnp.asarray(np.ones(cfg.max_mp, bool))

    B = TRI_NEIGHBORS
    sel = np.arange(1, B + 1, dtype=np.int32)
    has1 = np.zeros(F, bool)
    has2 = np.zeros((B, F), bool)
    act = np.ones((B, F), bool)

    timeit("tri_kernel(20nb)", lambda: tri_kernel(
        dm.kf_desc, dm.kf_xy, dm.kf_angle, dm.kf_level,
        dm.kf_feat_valid, dm.kf_R, dm.kf_t,
        np.array([0], np.int32), sel, has1, has2, act,
        cfg.K4, cfg.sigma2, cfg.scale_factors,
    ))

    T = FUSE_TARGETS
    q = rng.integers(0, cfg.max_mp, (2 * T, F)).astype(np.int32)
    row_valid = np.ones((2 * T, F), bool)
    dst = np.arange(2 * T, dtype=np.int32) % cfg.max_kf
    timeit("fuse_kernel(64row)", lambda: fuse_kernel(
        dm.kf_desc, dm.kf_xy, dm.kf_level, dm.kf_feat_valid,
        dm.kf_R, dm.kf_t, dm.mp_xyz, dm.mp_desc, dm.mp_min_dist,
        dm.mp_max_dist, dm.mp_valid,
        q, row_valid, dst, cfg.K4, cfg.scale_factors,
    ))

    K = cfg.local_ba_kf + cfg.local_ba_fixed
    P = cfg.local_ba_points
    O = cfg.local_ba_obs
    kf_R = np.tile(np.eye(3, dtype=np.float32), (K, 1, 1))
    kf_t = rng.normal(0, 0.1, (K, 3)).astype(np.float32)
    kf_fixed = np.zeros(K, bool); kf_fixed[K // 2:] = True
    points = rng.normal(0, 2, (P, 3)).astype(np.float32) + np.array([0, 0, 5], np.float32)
    pvalid = np.ones(P, bool)
    obs_kf = rng.integers(0, K, O).astype(np.int32)
    obs_pt = rng.integers(0, P, O).astype(np.int32)
    obs_feat = rng.integers(0, F, O).astype(np.int32)
    obs_srckf = rng.integers(0, cfg.max_kf, O).astype(np.int32)
    obs_valid = np.ones(O, bool)
    timeit("local_ba(5+10it)", lambda: local_ba_kernel(
        dm.kf_xy, dm.kf_level,
        kf_R, kf_t, kf_fixed, points, pvalid, obs_kf, obs_pt, obs_feat,
        obs_srckf, obs_valid, cfg.K4, cfg.inv_sigma2.astype(np.float32),
    ), n=3)

    n = 2048
    Omax = cfg.max_obs
    descs = rng.integers(0, 256, (n, Omax, 32), dtype=np.uint8)
    valid = np.ones((n, Omax), bool)
    xyz = rng.normal(0, 2, (n, 3)).astype(np.float32)
    centers = rng.normal(0, 1, (n, Omax, 3)).astype(np.float32)
    levels = rng.integers(0, 8, (n, Omax)).astype(np.int32)
    ref_slot = np.zeros(n, np.int64)
    timeit("point_attrs(2048)", lambda: _point_attrs(
        descs, valid, xyz, centers, levels, ref_slot, cfg.scale_factors,
    ))

    # fused tracker step for reference
    from orbslam_jpminipc.frontend.fused_track import FusedContext, MAX_SLICE
    ctx = FusedContext(cfg)
    ctx.set_pose(np.eye(3, dtype=np.float32), np.zeros(3, np.float32))
    pts = np.arange(1024)
    ctx.refresh_slice(st, pts)
    st.mp_valid[:1024] = True
    st.mp_max_dist[:1024] = 10.0
    ctx.refresh_slice(st, pts)
    img = rng.integers(0, 256, (cfg.height, cfg.width), dtype=np.uint8)
    timeit("fused_step", lambda: ctx.track(img))


if __name__ == "__main__":
    main()

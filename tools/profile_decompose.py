"""Decompose the hot kernels: transfer vs compute, sub-stage costs."""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax
import jax.numpy as jnp

from orbslam_jpminipc.config import SlamConfig


def timeit(name, fn, n=10):
    out = fn()
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn()
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / n * 1e3
    print(f"{name:36s} {dt:8.2f} ms")
    return dt


def main():
    cfg = SlamConfig()
    rng = np.random.default_rng(0)

    # ---- point_attrs decomposition -----------------------------------
    n, O = 2048, 32
    descs = rng.integers(0, 256, (n, O, 32), dtype=np.uint8)
    valid = np.ones((n, O), bool)
    xyz = rng.normal(0, 2, (n, 3)).astype(np.float32)
    centers = rng.normal(0, 1, (n, O, 3)).astype(np.float32)
    levels = rng.integers(0, 8, (n, O)).astype(np.int32)
    ref_slot = np.zeros(n, np.int32)

    d_descs = jnp.asarray(descs)
    d_valid = jnp.asarray(valid)
    d_xyz = jnp.asarray(xyz)
    d_centers = jnp.asarray(centers)
    d_levels = jnp.asarray(levels)
    d_ref = jnp.asarray(ref_slot)
    sf = jnp.asarray(cfg.scale_factors)

    from orbslam_jpminipc.map.map_state import _point_attrs

    # raw jit without packed transfer
    import orbslam_jpminipc.map.map_state as ms

    @jax.jit
    def attrs_dev(descs, valid, xyz, centers, levels, ref_slot, sfs):
        # replicate _point_attrs body by calling the undecorated fn
        from orbslam_jpminipc.ops.hamming import unpack_bits
        n, O, _ = descs.shape
        bits = unpack_bits(descs.reshape(n * O, 32)).reshape(n, O, 256)
        dots = jnp.einsum("nob,npb->nop", bits.astype(jnp.float32), bits.astype(jnp.float32))
        pc = jnp.sum(bits, axis=-1, dtype=jnp.int32)
        ham = pc[:, :, None] + pc[:, None, :] - 2 * dots.astype(jnp.int32)
        return ham.sum()

    timeit("attrs: device-resident ham", lambda: attrs_dev(
        d_descs, d_valid, d_xyz, d_centers, d_levels, d_ref, sf))

    timeit("attrs: full packed_call", lambda: _point_attrs(
        descs, valid, xyz, centers, levels, ref_slot.astype(np.int64), cfg.scale_factors))

    # transfer cost alone
    buf = np.concatenate([a.view(np.uint8).reshape(-1) for a in
                          (descs, valid, xyz, centers, levels)])
    print(f"  payload {buf.nbytes/1e6:.1f} MB")
    timeit("upload payload", lambda: jnp.asarray(buf))

    @jax.jit
    def sortk(ham):
        return jnp.sort(ham, axis=-1)

    ham = jnp.asarray(rng.integers(0, 256, (n, O, O)).astype(np.int32))
    timeit("sort (n,32,32)", lambda: sortk(ham))

    # ---- tri_kernel decomposition ------------------------------------
    F = 2 * cfg.n_features
    B = 20
    d1 = jnp.asarray(rng.integers(0, 256, (F, 32), dtype=np.uint8))
    d2 = jnp.asarray(rng.integers(0, 256, (B, F, 32), dtype=np.uint8))
    from orbslam_jpminipc.ops.hamming import hamming_matrix

    @jax.jit
    def ham_only(d1, d2):
        return jax.vmap(lambda x: hamming_matrix(d1, x))(d2).sum(axis=(1, 2))

    timeit("tri: 20x hamming only", lambda: ham_only(d1, d2))

    xy1 = jnp.asarray(rng.uniform(0, 640, (F, 2)).astype(np.float32))
    xy2 = jnp.asarray(rng.uniform(0, 640, (B, F, 2)).astype(np.float32))
    F12 = jnp.asarray(rng.normal(0, 1, (B, 3, 3)).astype(np.float32))

    from orbslam_jpminipc.geometry.epipolar import epipolar_dist2

    @jax.jit
    def epi_only(xy1, xy2, F12):
        def per(xy2b, Fb):
            return epipolar_dist2(xy1[:, None, :], xy2b[None, :, :], Fb[None, None]).sum()
        return jax.vmap(per)(xy2, F12)

    timeit("tri: 20x epipolar dist", lambda: epi_only(xy1, xy2, F12))

    # triangulate_dlt batched: solve/det path
    from orbslam_jpminipc.geometry.triangulate import triangulate_dlt, projection_matrix
    R1 = jnp.eye(3)
    t1 = jnp.zeros(3)
    P1 = projection_matrix(R1, t1, jnp.asarray(cfg.K4))

    @jax.jit
    def dlt_only(uv1, uv2):
        def per(uv2b):
            return triangulate_dlt(uv1, uv2b, P1, P1)[0].sum()
        return jax.vmap(per)(uv2)

    timeit("tri: 20x DLT(2000)", lambda: dlt_only(xy1, xy2))

    # masked_best2 over (B,F,F)
    from orbslam_jpminipc.ops.matching import masked_best2

    @jax.jit
    def best2_only(d1, d2):
        def per(x):
            h = hamming_matrix(d1, x)
            mask = h < 100
            bi, b, s = masked_best2(h, mask)
            return b.sum() + s.sum()
        return jax.vmap(per)(d2)

    timeit("tri: 20x ham+best2", lambda: best2_only(d1, d2))

    # ---- local BA decomposition --------------------------------------
    from orbslam_jpminipc.solvers import ba
    K = cfg.local_ba_kf + cfg.local_ba_fixed
    for P, Omax in ((4096, 16384), (2048, 8192)):
        kf_R = jnp.tile(jnp.eye(3, dtype=jnp.float32)[None], (K, 1, 1))
        kf_t = jnp.asarray(rng.normal(0, 0.1, (K, 3)).astype(np.float32))
        kf_fixed = jnp.asarray(np.arange(K) >= K // 2)
        pts = jnp.asarray(rng.normal(0, 2, (P, 3)).astype(np.float32) + np.array([0, 0, 5], np.float32))
        prob = ba.BAProblem(
            kf_R=kf_R, kf_t=kf_t, kf_fixed=kf_fixed,
            points=pts, point_valid=jnp.ones(P, bool),
            obs_kf=jnp.asarray(rng.integers(0, K, Omax).astype(np.int32)),
            obs_pt=jnp.asarray(rng.integers(0, P, Omax).astype(np.int32)),
            obs_uv=jnp.asarray(rng.uniform(0, 640, (Omax, 2)).astype(np.float32)),
            obs_w=jnp.ones(Omax),
            obs_valid=jnp.ones(Omax, bool),
            K4=jnp.asarray(cfg.K4),
        )
        timeit(f"ba: 1 iter P={P} O={Omax}", lambda: ba.bundle_adjust(prob, iterations=1), n=5)
        timeit(f"ba: 5 iters P={P} O={Omax}", lambda: ba.bundle_adjust(prob, iterations=5), n=3)


if __name__ == "__main__":
    main()

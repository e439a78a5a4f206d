"""Distributed Schur-complement bundle adjustment over a device mesh.

Design (SURVEY.md §7.10, BASELINE.json config 5): shard map POINTS and
their observations across devices; keep camera (keyframe) state replicated.
Per LM iteration, each device:

  1. computes residuals/Jacobians for ITS observations,
  2. accumulates its partial camera Hessian blocks Hcc, gradient bc,
  3. inverts its own 3x3 point blocks and forms its partial Schur
     complement contribution S_part = sum_p A_p U_p A_p^T,
  4. one `psum` over the mesh combines {Hcc, bc, S, rhs} — the only
     communication, sized O(K^2 * 36),
  5. solves the reduced camera system replicated (identical on all
     devices — camera count << point count), and
  6. back-substitutes its own point deltas locally.

This mirrors how the reference's g2o BlockSolver marginalizes landmark
blocks (block_solver.h:144-157) — except the elimination is a batched
einsum and the "sparse assembly" is a psum.

The observation arrays are grouped by point shard on the host
(shard_ba_problem), so device-local obs reference device-local points.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..solvers.ba import BAProblem, _inv3
from ..solvers.reproj import residuals, jacobians, huber_weight, CHI2_MONO
from ..geometry.se3 import exp_se3, compose, orthonormalize


class ShardedBAProblem(NamedTuple):
    """Point/observation arrays carry a leading shard axis (n_shards, ...).

    Camera arrays are replicated (no shard axis). obs_pt indexes into the
    LOCAL point block of its shard.
    """

    kf_R: jax.Array        # (K, 3, 3)
    kf_t: jax.Array        # (K, 3)
    kf_fixed: jax.Array    # (K,)
    points: jax.Array      # (S, Pl, 3)
    point_valid: jax.Array # (S, Pl)
    obs_kf: jax.Array      # (S, Ol)
    obs_pt: jax.Array      # (S, Ol) — local point index
    obs_uv: jax.Array      # (S, Ol, 2)
    obs_w: jax.Array       # (S, Ol)
    obs_valid: jax.Array   # (S, Ol)
    K4: jax.Array


def shard_ba_problem(prob: BAProblem, n_shards: int) -> ShardedBAProblem:
    """Host-side partitioning: contiguous point blocks, obs grouped along.

    Pads each shard's obs list to the global maximum so shapes are uniform.
    """
    P_total = prob.points.shape[0]
    Pl = -(-P_total // n_shards)
    obs_pt = np.asarray(prob.obs_pt)
    obs_shard = obs_pt // Pl
    obs_local = obs_pt - obs_shard * Pl
    obs_valid = np.asarray(prob.obs_valid)

    Ol = 0
    per_shard = []
    for s in range(n_shards):
        sel = np.nonzero((obs_shard == s) & obs_valid)[0]
        per_shard.append(sel)
        Ol = max(Ol, len(sel))
    Ol = max(Ol, 8)

    def gather(arr, fill=0):
        arr = np.asarray(arr)
        out = np.full((n_shards, Ol) + arr.shape[1:], fill, arr.dtype)
        for s, sel in enumerate(per_shard):
            out[s, : len(sel)] = arr[sel]
        return out

    pts = np.zeros((n_shards, Pl, 3), np.float32)
    pv = np.zeros((n_shards, Pl), bool)
    flat_pts = np.asarray(prob.points)
    flat_pv = np.asarray(prob.point_valid)
    for s in range(n_shards):
        lo, hi = s * Pl, min((s + 1) * Pl, P_total)
        pts[s, : hi - lo] = flat_pts[lo:hi]
        pv[s, : hi - lo] = flat_pv[lo:hi]

    return ShardedBAProblem(
        kf_R=prob.kf_R, kf_t=prob.kf_t, kf_fixed=prob.kf_fixed,
        points=jnp.array(pts), point_valid=jnp.array(pv),
        obs_kf=jnp.array(gather(prob.obs_kf)),
        obs_pt=jnp.array(gather(obs_local)),
        obs_uv=jnp.array(gather(prob.obs_uv)),
        obs_w=jnp.array(gather(prob.obs_w)),
        obs_valid=jnp.array(gather(np.ones_like(obs_valid))) > 0,
        K4=prob.K4,
    )


def sharded_bundle_adjust(
    sprob: ShardedBAProblem, mesh: Mesh, iterations: int = 10, axis: str = "points"
):
    """LM bundle adjustment with point blocks sharded over `mesh`.

    Returns (kf_R, kf_t, points (S, Pl, 3), chi2, obs_outlier (S, Ol)).
    """
    K = sprob.kf_R.shape[0]

    # NOTE: kf_fixed / K4 are threaded through shard_map inputs (replicated
    # specs), NOT captured by closure — a closure-captured global array
    # carries Auto-mesh sharding metadata that is invalid inside the Manual
    # (shard_map) context once the mesh spans multiple processes.
    def local_chi2(R, t, K4, pts, obs_kf, obs_pt, obs_uv, obs_w, obs_valid):
        e, _ = residuals(R[obs_kf], t[obs_kf], pts[obs_pt], obs_uv, K4)
        c = jnp.sum(e * e, axis=-1) * obs_w
        rho = jnp.where(c <= CHI2_MONO, c, 2.0 * jnp.sqrt(CHI2_MONO * c) - CHI2_MONO)
        return jnp.sum(jnp.where(obs_valid, rho, 0.0))

    def step_fn(R, t, kf_fixed, K4, pts, pv, obs_kf, obs_pt, obs_uv, obs_w,
                obs_valid, lam, ni, chi):
        """One LM step; runs per-device on local shards inside shard_map."""
        Pl = pts.shape[0]
        Rk = R[obs_kf]
        tk = t[obs_kf]
        xw = pts[obs_pt]
        e, _ = residuals(Rk, tk, xw, obs_uv, K4)
        Jc, Jp, _ = jacobians(Rk, tk, xw, K4)
        c = jnp.sum(e * e, axis=-1) * obs_w
        w = obs_w * huber_weight(c) * obs_valid
        w_c = jnp.where(kf_fixed[obs_kf], 0.0, 1.0)
        Jc = Jc * w_c[:, None, None]
        Jc_w = Jc * w[:, None, None]
        Jp_w = Jp * w[:, None, None]

        Hcc = jnp.zeros((K, 6, 6), e.dtype).at[obs_kf].add(jnp.einsum("oij,oik->ojk", Jc_w, Jc))
        bc = jnp.zeros((K, 6), e.dtype).at[obs_kf].add(jnp.einsum("oij,oi->oj", Jc_w, e))
        Hll = jnp.zeros((Pl, 3, 3), e.dtype).at[obs_pt].add(jnp.einsum("oij,oik->ojk", Jp_w, Jp))
        bp = jnp.zeros((Pl, 3), e.dtype).at[obs_pt].add(jnp.einsum("oij,oi->oj", Jp_w, e))
        Y = jnp.einsum("oij,oik->ojk", Jc_w, Jp)
        A = jnp.zeros((Pl, K, 6, 3), e.dtype).at[obs_pt, obs_kf].add(Y)

        U = _inv3(Hll + lam * jnp.eye(3, dtype=e.dtype)[None])
        B = jnp.einsum("pcij,pjk->pcik", A, U)
        S_part = -jnp.einsum("pcij,pdkj->cdik", B, A)
        rhs_part = bc - jnp.einsum("pcij,pj->ci", B, bp)

        # ---- the ONE collective: combine the reduced camera system ----
        Hcc = jax.lax.psum(Hcc, axis)
        bc = jax.lax.psum(bc, axis)
        S = jax.lax.psum(S_part, axis)
        rhs = jax.lax.psum(rhs_part, axis)

        diag = jnp.arange(K)
        eye6 = jnp.eye(6, dtype=e.dtype)
        S = S.at[diag, diag].add(Hcc + lam * eye6[None])
        fixed = kf_fixed
        S = jnp.where(fixed[:, None, None, None] | fixed[None, :, None, None], 0.0, S)
        S = S.at[diag, diag].add(jnp.where(fixed, 1.0, 0.0)[:, None, None] * eye6[None])
        rhs = jnp.where(fixed[:, None], 0.0, rhs)

        Smat = S.transpose(0, 2, 1, 3).reshape(K * 6, K * 6)
        # Jacobi (diagonal) scaling before the f32 Cholesky: the Schur
        # complement mixes rotation/translation blocks whose diagonals span
        # orders of magnitude, and the raw condition number amplifies the
        # shard-order f32 rounding differences into visibly divergent LM
        # trajectories across device counts (a virtual 8-device CPU mesh
        # once showed 9%-of-extent point drift). D^-1/2 S D^-1/2 keeps the
        # solve well-conditioned in f32.
        d = jnp.sqrt(jnp.maximum(jnp.abs(jnp.diagonal(Smat)), 1e-12))
        Sn = Smat / (d[:, None] * d[None, :])
        rhs_n = -rhs.reshape(-1) / d
        delta_c = (jax.scipy.linalg.solve(
            Sn + 1e-7 * jnp.eye(K * 6, dtype=Smat.dtype), rhs_n,
            assume_a="pos",
        ) / d).reshape(K, 6)

        At_dc = jnp.einsum("pcij,ci->pj", A, delta_c)
        delta_p = jnp.einsum("pij,pj->pi", U, -bp - At_dc)
        delta_p = jnp.where(pv[:, None], delta_p, 0.0)

        dR, dt = exp_se3(delta_c)
        R_new, t_new = compose(dR, dt, R, t)
        R_new = orthonormalize(R_new)  # parity with solvers/ba.py: the
        # f32 rotation products must stay on SO(3) or long multi-chip runs
        # re-drift exactly the way commit d7a24c0 diagnosed
        pts_new = pts + delta_p
        # fuse {chi, predicted point-part} into one scalar psum
        chi_local = local_chi2(R_new, t_new, K4, pts_new, obs_kf, obs_pt, obs_uv, obs_w, obs_valid)
        pred_p_local = 0.5 * jnp.sum(delta_p * (lam * delta_p - bp))
        chi_new, pred_p = jax.lax.psum(
            jnp.stack([chi_local, pred_p_local]), axis)
        # g2o gain-ratio schedule — identical to the single-device solver
        # (solvers/ba.py) so both paths follow the same damping trajectory
        pred = 0.5 * jnp.sum(delta_c * (lam * delta_c - bc)) + pred_p
        rho = (chi - chi_new) / jnp.where(jnp.abs(pred) < 1e-30, 1e-30, pred)
        accept = (rho > 0) & (chi_new < chi) & jnp.isfinite(chi_new)
        R = jnp.where(accept, R_new, R)
        t = jnp.where(accept, t_new, t)
        pts = jnp.where(accept, pts_new, pts)
        chi = jnp.where(accept, chi_new, chi)
        factor = jnp.maximum(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3)
        lam = jnp.where(accept, lam * factor, lam * ni)
        lam = jnp.clip(lam, 1e-12, 1e12)
        ni = jnp.where(accept, 2.0, ni * 2.0)
        return R, t, pts, lam, ni, chi

    def kernel(kf_R, kf_t, kf_fixed, K4, pts, pv, obs_kf, obs_pt, obs_uv,
               obs_w, obs_valid):
        # shard_map passes per-device blocks with the shard axis collapsed
        pts = pts[0]
        pv = pv[0]
        obs_kf = obs_kf[0]
        obs_pt = obs_pt[0]
        obs_uv = obs_uv[0]
        obs_w = obs_w[0]
        obs_valid = obs_valid[0]

        chi0 = jax.lax.psum(
            local_chi2(kf_R, kf_t, K4, pts, obs_kf, obs_pt, obs_uv, obs_w,
                       obs_valid), axis
        )

        # lambda init = tau * max(diag H) like the single-device path
        # (g2o optimization_algorithm_levenberg.cpp:47, tau = 1e-5); the
        # diagonal max is a pmax over shards
        Rk0, tk0, xw0 = kf_R[obs_kf], kf_t[obs_kf], pts[obs_pt]
        e0, _ = residuals(Rk0, tk0, xw0, obs_uv, K4)
        Jc0, Jp0, _ = jacobians(Rk0, tk0, xw0, K4)
        c0 = jnp.sum(e0 * e0, axis=-1) * obs_w
        w0 = obs_w * huber_weight(c0) * obs_valid
        diag_c = jnp.zeros((K, 6), e0.dtype).at[obs_kf].add(
            jnp.einsum("oij,oij->oj", Jc0 * w0[:, None, None], Jc0))
        diag_p = jnp.zeros((pts.shape[0], 3), e0.dtype).at[obs_pt].add(
            jnp.einsum("oij,oij->oj", Jp0 * w0[:, None, None], Jp0))
        max_diag = jnp.maximum(jnp.max(jnp.abs(diag_c)), jnp.max(jnp.abs(diag_p)))
        max_diag = jax.lax.pmax(max_diag, axis)
        lam0 = 1e-5 * max_diag

        def body(_, state):
            R, t, p, lam, ni, chi = state
            return step_fn(R, t, kf_fixed, K4, p, pv, obs_kf, obs_pt, obs_uv,
                           obs_w, obs_valid, lam, ni, chi)

        R, t, p, _, _, chi = jax.lax.fori_loop(
            0, iterations, body, (kf_R, kf_t, pts, lam0, jnp.float32(2.0), chi0)
        )
        # outlier classification at the solution — same semantics as the
        # single-device BAResult.obs_outlier (Optimizer.cc:453-470)
        e_f, pcam_f = residuals(R[obs_kf], t[obs_kf], p[obs_pt], obs_uv, K4)
        c_f = jnp.sum(e_f * e_f, axis=-1) * obs_w
        outlier = obs_valid & ((c_f > CHI2_MONO) | (pcam_f[..., 2] <= 0.0))
        return R, t, p[None], chi, outlier[None]

    shard = P(axis)
    rep = P()
    f = jax.jit(
        jax.shard_map(
            kernel,
            mesh=mesh,
            in_specs=(rep, rep, rep, rep,
                      shard, shard, shard, shard, shard, shard, shard),
            out_specs=(rep, rep, shard, rep, shard),
            check_vma=False,
        )
    )
    return f(
        sprob.kf_R, sprob.kf_t, sprob.kf_fixed, sprob.K4,
        sprob.points, sprob.point_valid,
        sprob.obs_kf, sprob.obs_pt, sprob.obs_uv, sprob.obs_w, sprob.obs_valid,
    )

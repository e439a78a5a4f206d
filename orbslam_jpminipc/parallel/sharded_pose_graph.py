"""Distributed Sim3 essential-graph optimization over a device mesh.

The essential graph is the structure that grows with trajectory length
(SURVEY.md §5 — OptimizeEssentialGraph runs over ALL keyframes,
src/Optimizer.cc:1470-1719), so it is the second multi-chip axis after
bundle adjustment: EDGES are sharded across devices, vertex state stays
replicated. Per LM iteration each device

  1. evaluates residuals + 7x7 Jacobian blocks for ITS edges,
  2. scatter-adds its partial (K, K, 7, 7) Hessian and (K, 7) gradient,
  3. one `psum` over the mesh combines {H, b, chi2} — the only
     communication,
  4. solves the 7K x 7K system replicated and retracts all vertices
     (identical on every device).

Mirrors parallel/sharded_ba.py's point-sharded Schur BA; here there is no
marginalization, so the whole normal-equation assembly distributes.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..geometry import sim3 as s3
from ..solvers.essential_graph import (
    EssentialGraphProblem, EssentialGraphResult, _edge_residual,
)


class ShardedEssentialGraph(NamedTuple):
    """Edge arrays carry a leading (n_shards, El) axis; vertices replicated."""

    s: jax.Array        # (K,)
    R: jax.Array        # (K, 3, 3)
    t: jax.Array        # (K, 3)
    fixed: jax.Array    # (K,)
    e_i: jax.Array      # (S, El)
    e_j: jax.Array      # (S, El)
    e_s: jax.Array      # (S, El)
    e_R: jax.Array      # (S, El, 3, 3)
    e_t: jax.Array      # (S, El, 3)
    e_valid: jax.Array  # (S, El)


def shard_essential_graph(
    prob: EssentialGraphProblem, n_shards: int
) -> ShardedEssentialGraph:
    """Host-side partitioning: valid edges dealt round-robin, padded equal."""
    valid = np.nonzero(np.asarray(prob.e_valid))[0]
    El = max(-(-len(valid) // n_shards), 4)

    def gather(arr, fill=0):
        arr = np.asarray(arr)
        out = np.full((n_shards, El) + arr.shape[1:], fill, arr.dtype)
        for s in range(n_shards):
            sel = valid[s::n_shards]
            out[s, : len(sel)] = arr[sel]
        return out

    ev = gather(np.ones(prob.e_valid.shape, bool))
    eR = gather(prob.e_R)
    # padded edges need a valid rotation for log7 not to NaN under autodiff
    eR[~ev] = np.eye(3, dtype=eR.dtype)
    es = gather(prob.e_s)
    es[~ev] = 1.0
    return ShardedEssentialGraph(
        s=prob.s, R=prob.R, t=prob.t, fixed=prob.fixed,
        e_i=jnp.array(gather(prob.e_i)), e_j=jnp.array(gather(prob.e_j)),
        e_s=jnp.array(es), e_R=jnp.array(eR), e_t=jnp.array(gather(prob.e_t)),
        e_valid=jnp.array(ev),
    )


@functools.lru_cache(maxsize=None)
def _build_sharded_kernel(mesh: Mesh, iterations: int, lam0: float,
                          fix_scale: bool, axis: str):
    """Jitted edge-sharded LM kernel, cached per (mesh, schedule) so repeat
    loop closures with the same padded shapes hit the jit cache instead of
    recompiling the whole LM loop. `fixed` is a replicated INPUT (not a
    baked-in constant), so changing which vertex is gauge-fixed does not
    recompile either."""
    zero = jnp.zeros(7, jnp.float32)

    res_fn = jax.vmap(_edge_residual,
                      in_axes=(None, None, 0, 0, 0, 0, 0, 0, 0, 0, 0, None))
    jac_i = jax.vmap(jax.jacfwd(_edge_residual, argnums=0),
                     in_axes=(None, None, 0, 0, 0, 0, 0, 0, 0, 0, 0, None))
    jac_j = jax.vmap(jax.jacfwd(_edge_residual, argnums=1),
                     in_axes=(None, None, 0, 0, 0, 0, 0, 0, 0, 0, 0, None))

    def kernel(s, R, t, fixed, e_i, e_j, e_s, e_R, e_t, e_valid):
        K = s.shape[0]
        e_i, e_j = e_i[0], e_j[0]
        e_s, e_R, e_t, e_valid = e_s[0], e_R[0], e_t[0], e_valid[0]

        def gather(s_, R_, t_):
            return (s_[e_i], R_[e_i], t_[e_i], s_[e_j], R_[e_j], t_[e_j],
                    e_s, e_R, e_t)

        def total_chi2(s_, R_, t_):
            e = res_fn(zero, zero, *gather(s_, R_, t_), fix_scale)
            local = jnp.sum(jnp.where(e_valid[:, None], e * e, 0.0))
            return jax.lax.psum(local, axis)

        def body(_, state):
            s_, R_, t_, lam, chi = state
            args = gather(s_, R_, t_)
            e = res_fn(zero, zero, *args, fix_scale)
            Ji = jac_i(zero, zero, *args, fix_scale)
            Jj = jac_j(zero, zero, *args, fix_scale)
            w = e_valid.astype(e.dtype)
            wi = w * (~fixed[e_i]).astype(e.dtype)
            wj = w * (~fixed[e_j]).astype(e.dtype)
            Ji = Ji * wi[:, None, None]
            Jj = Jj * wj[:, None, None]
            ew = e * w[:, None]

            H = jnp.zeros((K, K, 7, 7), e.dtype)
            H = H.at[e_i, e_i].add(jnp.einsum("eri,erj->eij", Ji, Ji))
            H = H.at[e_j, e_j].add(jnp.einsum("eri,erj->eij", Jj, Jj))
            H = H.at[e_i, e_j].add(jnp.einsum("eri,erj->eij", Ji, Jj))
            H = H.at[e_j, e_i].add(jnp.einsum("eri,erj->eij", Jj, Ji))
            b = jnp.zeros((K, 7), e.dtype)
            b = b.at[e_i].add(jnp.einsum("eri,er->ei", Ji, ew))
            b = b.at[e_j].add(jnp.einsum("eri,er->ei", Jj, ew))
            free_deg = jnp.zeros((K,), e.dtype).at[e_i].add(wi).at[e_j].add(wj)

            # ---- the ONE collective ----
            H = jax.lax.psum(H, axis)
            b = jax.lax.psum(b, axis)
            free_deg = jax.lax.psum(free_deg, axis)

            diag = jnp.arange(K)
            eye7 = jnp.eye(7, dtype=e.dtype)
            inert = fixed | (free_deg == 0)
            H = jnp.where(
                inert[:, None, None, None] | inert[None, :, None, None], 0.0, H
            )
            H = H.at[diag, diag].add(
                jnp.where(inert, 1.0, lam)[:, None, None] * eye7[None]
            )
            b = jnp.where(inert[:, None], 0.0, b)

            Hmat = H.transpose(0, 2, 1, 3).reshape(K * 7, K * 7)
            delta = jax.scipy.linalg.solve(
                Hmat + 1e-9 * jnp.eye(K * 7, dtype=Hmat.dtype),
                -b.reshape(-1), assume_a="pos",
            ).reshape(K, 7)
            delta = jnp.where(inert[:, None], 0.0, delta)

            s_new, R_new, t_new = s3.retract(s_, R_, t_, delta, fix_scale=fix_scale)
            from ..geometry.se3 import orthonormalize

            R_new = orthonormalize(R_new)  # keep f32 products on SO(3)
            chi_new = total_chi2(s_new, R_new, t_new)
            accept = chi_new < chi
            s_ = jnp.where(accept, s_new, s_)
            R_ = jnp.where(accept, R_new, R_)
            t_ = jnp.where(accept, t_new, t_)
            chi = jnp.where(accept, chi_new, chi)
            lam = jnp.where(accept, lam * 0.5,
                            jnp.minimum(lam * 10.0 + 1e-12, 1e6))
            return s_, R_, t_, lam, chi

        chi0 = total_chi2(s, R, t)
        s, R, t, _, chi = jax.lax.fori_loop(
            0, iterations, body, (s, R, t, jnp.float32(lam0), chi0)
        )
        return s, R, t, chi

    shard, rep = P(axis), P()
    return jax.jit(
        jax.shard_map(
            kernel, mesh=mesh,
            in_specs=(rep, rep, rep, rep,
                      shard, shard, shard, shard, shard, shard),
            out_specs=(rep, rep, rep, rep),
            check_vma=False,
        )
    )


def sharded_optimize_essential_graph(
    sprob: ShardedEssentialGraph,
    mesh: Mesh,
    iterations: int = 20,
    lam0: float = 1e-16,
    fix_scale: bool = False,
    axis: str = "edges",
) -> EssentialGraphResult:
    f = _build_sharded_kernel(mesh, iterations, float(lam0), fix_scale, axis)
    s, R, t, chi = f(
        sprob.s, sprob.R, sprob.t, sprob.fixed,
        sprob.e_i, sprob.e_j, sprob.e_s, sprob.e_R, sprob.e_t, sprob.e_valid,
    )
    return EssentialGraphResult(s=s, R=R, t=t, chi2=chi)

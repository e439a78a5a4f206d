"""Pose-only optimization: one SE3 vertex, fixed points, 4-round regating.

Replaces Optimizer::PoseOptimization (src/Optimizer.cc:154-285): a g2o graph
with a single VertexSE3Expmap, unary edges to fixed map points, Huber kernel
sqrt(5.991), solved 4 rounds x (10,10,7,5) LM iterations with chi^2 outlier
re-leveling between rounds (gates {9.21, 7.378, 5.991, 5.991}) and the robust
kernel dropped after round 2 — here as fixed-shape masked arrays inside one
jitted lax loop nest (no dynamic edge removal: outliers are masks).

Returns the refined pose and the final inlier mask (the reference returns
nInitialCorrespondences - nBad, Tracking uses >= 10 as success).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry.se3 import exp_se3, compose, orthonormalize
from .reproj import residuals, jacobians, huber_weight
from .linalg3 import solve6_spd

_CHI2_GATES = (9.210, 7.378, 5.991, 5.991)
_ROUND_ITERS = (10, 10, 7, 5)


class PoseOptResult(NamedTuple):
    R: jax.Array
    t: jax.Array
    inliers: jax.Array   # (N,) bool
    n_inliers: jax.Array
    chi2: jax.Array      # final total chi2 over inliers


def _normal_eq(R, t, xw, uv, K4, w):
    """Weighted normal equations: H = sum J^T w J, b = sum J^T w e."""
    e, _ = residuals(R, t, xw, uv, K4)
    Jp, _, _ = jacobians(R, t, xw, K4)
    Jw = Jp * w[..., None, None]
    H = jnp.einsum("nij,nik->jk", Jw, Jp)
    b = jnp.einsum("nij,ni->j", Jw, e)
    return H, b


def _lm_step(R, t, xw, uv, K4, w, H, b, lam):
    """One additively-damped step (g2o sets lambda on the diagonal,
    block_solver.hpp setLambda). Closed-form 6x6 solve: tiny LU
    factorizations lower to sequential scalar loops, and this solve sits
    on the sequential critical path of every LM iteration."""
    Hd = H + lam * jnp.eye(6, dtype=H.dtype) + 1e-10 * jnp.eye(6, dtype=H.dtype)
    delta = -solve6_spd(Hd, b)
    dR, dt = exp_se3(delta)
    R_new, t_new = compose(dR, dt, R, t)
    return R_new, t_new, delta


@functools.partial(jax.jit, static_argnames=("use_huber_rounds", "n_rounds"))
def optimize_pose(
    R0: jax.Array,
    t0: jax.Array,
    xw: jax.Array,          # (N, 3) fixed map points
    uv: jax.Array,          # (N, 2) observed (undistorted) keypoints
    inv_sigma2: jax.Array,  # (N,) per-observation information weight
    valid: jax.Array,       # (N,) bool — has a map point match
    K4: jax.Array,
    use_huber_rounds: int = 2,
    n_rounds: int = 4,
) -> PoseOptResult:
    """4-round pose refinement with chi2 regating (Optimizer.cc:242-276).
    n_rounds < 4 runs a truncated schedule (provisional poses that a later
    full optimization refines, e.g. the fused tracker's pass 1)."""
    inlier = valid

    def chi2_of(R, t):
        e, p = residuals(R, t, xw, uv, K4)
        c = jnp.sum(e * e, axis=-1) * inv_sigma2
        return c, p[..., 2] > 0

    delta2 = jnp.float32(5.991)

    R, t = R0, t0
    for rnd in range(n_rounds):
        gate = _CHI2_GATES[rnd]
        use_huber = rnd < use_huber_rounds

        def robust_chi2(R, t, inlier=inlier, use_huber=use_huber):
            c, _ = chi2_of(R, t)
            if use_huber:
                rho = jnp.where(c <= delta2, c,
                                2.0 * jnp.sqrt(delta2 * c) - delta2)
            else:
                rho = c
            return jnp.sum(jnp.where(inlier, rho, 0.0))

        def weights(R, t, inlier=inlier, use_huber=use_huber):
            c, _ = chi2_of(R, t)
            w = inv_sigma2 * jnp.where(inlier, 1.0, 0.0)
            if use_huber:
                w = w * huber_weight(c)
            return w

        # full LM with backup/restore semantics per round, lambda init =
        # tau * max(diag H) (optimization_algorithm_levenberg.cpp:47,100-160)
        H0, _ = _normal_eq(R, t, xw, uv, K4, weights(R, t))
        lam0 = 1e-5 * jnp.max(jnp.abs(jnp.diag(H0)))
        chi_r = robust_chi2(R, t)

        def lm_cond(state, max_iters=_ROUND_ITERS[rnd]):
            i, _, _, _, _, _, done = state
            return (i < max_iters) & ~done

        def lm_body(state, inlier=inlier, use_huber=use_huber):
            i, R, t, lam, ni, chi, done = state
            w = weights(R, t, inlier, use_huber)
            H, b = _normal_eq(R, t, xw, uv, K4, w)
            R_new, t_new, delta = _lm_step(R, t, xw, uv, K4, w, H, b, lam)
            chi_new = robust_chi2(R_new, t_new, inlier, use_huber)
            pred = 0.5 * jnp.sum(delta * (lam * delta - b))
            rho = (chi - chi_new) / jnp.where(
                jnp.abs(pred) < 1e-30, 1e-30, pred)
            accept = (rho > 0) & (chi_new < chi) & jnp.isfinite(chi_new)
            # early termination on a converged accepted step (g2o's
            # relative-gain terminate criterion) — most frames converge in
            # 2-4 iterations and this loop runs twice per tracked frame
            done = accept & (chi - chi_new < 1e-5 * chi)
            R = jnp.where(accept, R_new, R)
            t = jnp.where(accept, t_new, t)
            chi = jnp.where(accept, chi_new, chi)
            factor = jnp.maximum(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3)
            lam = jnp.where(accept, lam * factor, lam * ni)
            lam = jnp.clip(lam, 1e-15, 1e10)
            ni = jnp.where(accept, 2.0, ni * 2.0)
            return i + 1, R, t, lam, ni, chi, done

        _, R, t, _, _, _, _ = jax.lax.while_loop(
            lm_cond, lm_body,
            (jnp.int32(0), R, t, lam0, jnp.float32(2.0), chi_r,
             jnp.asarray(False)),
        )
        # ~30 f32 rotation products per round drift R off SO(3); re-project
        # (g2o renormalizes its quaternion per update, se3quat.h)
        R = orthonormalize(R)
        # re-level: recompute inliers from scratch (outliers can return)
        c, pos = chi2_of(R, t)
        inlier = valid & (c <= gate) & pos

    c, _ = chi2_of(R, t)
    return PoseOptResult(
        R=R,
        t=t,
        inliers=inlier,
        n_inliers=jnp.sum(inlier),
        chi2=jnp.sum(jnp.where(inlier, c, 0.0)),
    )

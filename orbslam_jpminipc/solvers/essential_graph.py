"""Essential-graph (Sim3 pose-graph) optimization for loop closing.

Replaces Optimizer::OptimizeEssentialGraph (src/Optimizer.cc:1470-1719):
a Sim3 pose graph over ALL keyframes (loop keyframe fixed, lambda init
1e-16, BlockSolver_7_3, 20 LM iterations) whose edges are loop connections
(covisibility weight >= 100), spanning-tree edges, previous loop edges and
strong covisibility edges, each carrying a relative Sim3 measurement
Sji with identity 7x7 information.

Array program: vertices are packed Sim3 arrays, edges are flat padded arrays;
the residual of edge (i, j) is

    e = log7( Sji o Siw o Sjw^-1 )        (g2o EdgeSim3::computeError,
                                           types_seven_dof_expmap.h:106-114)

with the 7x14 Jacobian from forward-mode autodiff (g2o uses numeric
differentiation here). The 7K x 7K normal equations are assembled with
scatter-adds of 7x7 blocks and solved with dense Cholesky — at ORB-SLAM
scale (K <= ~1000) this is a small dense solve, in place of
g2o's sparse CHOLMOD elimination.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry import sim3 as s3


class EssentialGraphProblem(NamedTuple):
    s: jax.Array          # (K,) Siw scales
    R: jax.Array          # (K, 3, 3)
    t: jax.Array          # (K, 3)
    fixed: jax.Array      # (K,) bool — loop KF + invalid slots
    e_i: jax.Array        # (E,) int32 — vertex i of each edge
    e_j: jax.Array        # (E,) int32
    e_s: jax.Array        # (E,) measurement Sji scale
    e_R: jax.Array        # (E, 3, 3)
    e_t: jax.Array        # (E, 3)
    e_valid: jax.Array    # (E,) bool


class EssentialGraphResult(NamedTuple):
    s: jax.Array
    R: jax.Array
    t: jax.Array
    chi2: jax.Array


def _edge_residual(xi_i, xi_j, si, Ri, ti, sj, Rj, tj, ms, mR, mt, fix_scale):
    """log7(Sji o exp(xi_i) Siw o (exp(xi_j) Sjw)^-1): (7,)."""
    si_, Ri_, ti_ = s3.retract(si, Ri, ti, xi_i, fix_scale=fix_scale)
    sj_, Rj_, tj_ = s3.retract(sj, Rj, tj, xi_j, fix_scale=fix_scale)
    a = s3.compose(ms, mR, mt, si_, Ri_, ti_)
    b = s3.inverse(sj_, Rj_, tj_)
    return s3.log7(*s3.compose(*a, *b))


@functools.partial(jax.jit, static_argnames=("iterations", "fix_scale"))
def optimize_essential_graph(
    prob: EssentialGraphProblem,
    iterations: int = 20,
    lam0: float = 1e-16,
    fix_scale: bool = False,
) -> EssentialGraphResult:
    K = prob.s.shape[0]
    zero = jnp.zeros(7, prob.t.dtype)

    res_fn = jax.vmap(
        _edge_residual,
        in_axes=(None, None, 0, 0, 0, 0, 0, 0, 0, 0, 0, None),
    )
    jac_i = jax.vmap(
        jax.jacfwd(_edge_residual, argnums=0),
        in_axes=(None, None, 0, 0, 0, 0, 0, 0, 0, 0, 0, None),
    )
    jac_j = jax.vmap(
        jax.jacfwd(_edge_residual, argnums=1),
        in_axes=(None, None, 0, 0, 0, 0, 0, 0, 0, 0, 0, None),
    )

    def gather(s, R, t):
        return (
            s[prob.e_i], R[prob.e_i], t[prob.e_i],
            s[prob.e_j], R[prob.e_j], t[prob.e_j],
            prob.e_s, prob.e_R, prob.e_t,
        )

    def total_chi2(s, R, t):
        e = res_fn(zero, zero, *gather(s, R, t), fix_scale)
        return jnp.sum(jnp.where(prob.e_valid[:, None], e * e, 0.0))

    def body(_, state):
        s, R, t, lam, chi = state
        args = gather(s, R, t)
        e = res_fn(zero, zero, *args, fix_scale)          # (E, 7)
        Ji = jac_i(zero, zero, *args, fix_scale)          # (E, 7, 7)
        Jj = jac_j(zero, zero, *args, fix_scale)
        w = prob.e_valid.astype(e.dtype)
        # fixed vertices contribute no columns
        wi = w * (~prob.fixed[prob.e_i]).astype(e.dtype)
        wj = w * (~prob.fixed[prob.e_j]).astype(e.dtype)
        Ji = Ji * wi[:, None, None]
        Jj = Jj * wj[:, None, None]
        ew = e * w[:, None]

        H = jnp.zeros((K, K, 7, 7), e.dtype)
        H = H.at[prob.e_i, prob.e_i].add(jnp.einsum("eri,erj->eij", Ji, Ji))
        H = H.at[prob.e_j, prob.e_j].add(jnp.einsum("eri,erj->eij", Jj, Jj))
        H = H.at[prob.e_i, prob.e_j].add(jnp.einsum("eri,erj->eij", Ji, Jj))
        H = H.at[prob.e_j, prob.e_i].add(jnp.einsum("eri,erj->eij", Jj, Ji))
        b = jnp.zeros((K, 7), e.dtype)
        b = b.at[prob.e_i].add(jnp.einsum("eri,er->ei", Ji, ew))
        b = b.at[prob.e_j].add(jnp.einsum("eri,er->ei", Jj, ew))

        diag = jnp.arange(K)
        eye7 = jnp.eye(7, dtype=e.dtype)
        # fixed / untouched vertices: identity rows
        free_deg = jnp.zeros((K,), e.dtype).at[prob.e_i].add(wi).at[prob.e_j].add(wj)
        inert = prob.fixed | (free_deg == 0)
        H = jnp.where(inert[:, None, None, None] | inert[None, :, None, None], 0.0, H)
        H = H.at[diag, diag].add(
            jnp.where(inert, 1.0, lam)[:, None, None] * eye7[None]
        )
        b = jnp.where(inert[:, None], 0.0, b)

        Hmat = H.transpose(0, 2, 1, 3).reshape(K * 7, K * 7)
        delta = jax.scipy.linalg.solve(
            Hmat + 1e-9 * jnp.eye(K * 7, dtype=Hmat.dtype), -b.reshape(-1), assume_a="pos"
        ).reshape(K, 7)
        delta = jnp.where(inert[:, None], 0.0, delta)

        s_new, R_new, t_new = s3.retract(s, R, t, delta, fix_scale=fix_scale)
        from ..geometry.se3 import orthonormalize

        R_new = orthonormalize(R_new)  # keep f32 products on SO(3)
        chi_new = total_chi2(s_new, R_new, t_new)
        accept = chi_new < chi
        s = jnp.where(accept, s_new, s)
        R = jnp.where(accept, R_new, R)
        t = jnp.where(accept, t_new, t)
        chi = jnp.where(accept, chi_new, chi)
        lam = jnp.where(accept, lam * 0.5, jnp.minimum(lam * 10.0 + 1e-12, 1e6))
        return s, R, t, lam, chi

    chi0 = total_chi2(prob.s, prob.R, prob.t)
    s, R, t, _, chi = jax.lax.fori_loop(
        0, iterations, body, (prob.s, prob.R, prob.t, jnp.float32(lam0), chi0)
    )
    return EssentialGraphResult(s=s, R=R, t=t, chi2=chi)


def recover_se3(s, R, t):
    """Sim3 -> SE3 pose recovery: Tiw = [R | t/s] (Optimizer.cc:1687-1700)."""
    return R, t / s[..., None]


def correct_points(xw, s_old, R_old, t_old, s_new, R_new, t_new):
    """Re-map points through their reference KF's corrected pose:
    x' = S_new^-1 ( S_old (x) )  (Optimizer.cc:1701-1718)."""
    x_cam = s3.transform(s_old, R_old, t_old, xw)
    return s3.transform(*s3.inverse(s_new, R_new, t_new), x_cam)

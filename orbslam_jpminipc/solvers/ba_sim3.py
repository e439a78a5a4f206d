"""All-Sim3 (7-DoF) local bundle adjustment — the fork's experimental variant.

The jpMiniPC fork adds two file-local local-BA variants to Optimizer.cc:
`LocalBundleAdjustmentWJ` (src/Optimizer.cc:541-983 — current KF as a Sim3
vertex among SE3 vertices) and `LocalBundleAdjustmentWJ_All7Dof`
(src/Optimizer.cc:990-1466 — every local KF a VertexSim3Expmap; scale is
fixed on KFs 0/1 and on KFs older than current-5, so the ~5 newest
keyframes keep free scale, Optimizer.cc:1082). They exercise g2o's BlockSolver_7_3 on the local map. Neither is
wired into the live LocalMapping loop (LocalMapping.cc:84 calls the stock
SE3 version), and this framework likewise exposes the capability without
routing the mapper through it.

Array-program redesign (not a port): the same padded flat-observation layout
as solvers/ba.py, with 7-DoF Sim3 camera blocks:
  * per-observation residual e = uv - proj(exp(xi) o S0 . x) with the 2x7
    pose and 2x3 point Jacobians from vmapped jax.jacfwd (the reference's
    Sim3 projection edges also use numeric differentiation —
    types_seven_dof_expmap.h:129-172 has linearizeOplus commented out);
  * per-KF `scale_fixed` mask zeroing the scale column of J (g2o's
    VertexSim3Expmap::_fix_scale, types_seven_dof_expmap.h:47-93);
  * Schur complement marginalizing the 3x3 point blocks, dense (7K x 7K)
    camera solve, LM accept/reject — all one jitted program.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry import sim3 as s3
from ..geometry import camera as cam
from .linalg3 import inv3
from .reproj import huber_weight, CHI2_MONO


class Sim3BAProblem(NamedTuple):
    """Padded all-Sim3 local BA problem (fork WJ_All7Dof semantics)."""

    kf_s: jax.Array          # (K,) scale, world->cam
    kf_R: jax.Array          # (K, 3, 3)
    kf_t: jax.Array          # (K, 3)
    kf_fixed: jax.Array      # (K,) bool — pose fully held (gauge / fixed ring)
    kf_scale_fixed: jax.Array  # (K,) bool — scale component frozen
    points: jax.Array        # (P, 3)
    point_valid: jax.Array   # (P,) bool
    obs_kf: jax.Array        # (O,) int32
    obs_pt: jax.Array        # (O,) int32
    obs_uv: jax.Array        # (O, 2)
    obs_w: jax.Array         # (O,) inv_sigma2
    obs_valid: jax.Array     # (O,) bool
    K4: jax.Array            # (4,)


class Sim3BAResult(NamedTuple):
    kf_s: jax.Array
    kf_R: jax.Array
    kf_t: jax.Array
    points: jax.Array
    chi2: jax.Array
    obs_outlier: jax.Array


def _residual(xi, dx, s0, R0, t0, x, uv, K4):
    s, R, t = s3.retract(s0, R0, t0, xi)
    return uv - cam.project(s3.transform(s, R, t, x + dx), K4)


_res_v = jax.vmap(_residual, in_axes=(None, None, 0, 0, 0, 0, 0, None))
_jac_c = jax.vmap(jax.jacfwd(_residual, argnums=0),
                  in_axes=(None, None, 0, 0, 0, 0, 0, None))
_jac_p = jax.vmap(jax.jacfwd(_residual, argnums=1),
                  in_axes=(None, None, 0, 0, 0, 0, 0, None))


def _robust_chi2(prob: Sim3BAProblem, s, R, t, pts):
    z = jnp.zeros(7, pts.dtype)
    z3 = jnp.zeros(3, pts.dtype)
    e = _res_v(z, z3, s[prob.obs_kf], R[prob.obs_kf], t[prob.obs_kf],
               pts[prob.obs_pt], prob.obs_uv, prob.K4)
    c = jnp.sum(e * e, axis=-1) * prob.obs_w
    rho = jnp.where(c <= CHI2_MONO, c,
                    2.0 * jnp.sqrt(CHI2_MONO * c) - CHI2_MONO)
    return jnp.sum(jnp.where(prob.obs_valid, rho, 0.0)), e, c


def _solve_delta(prob: Sim3BAProblem, s, R, t, pts, lam):
    K = prob.kf_R.shape[0]
    P = prob.points.shape[0]
    z, z3 = jnp.zeros(7, pts.dtype), jnp.zeros(3, pts.dtype)
    args = (s[prob.obs_kf], R[prob.obs_kf], t[prob.obs_kf],
            pts[prob.obs_pt], prob.obs_uv, prob.K4)
    e = _res_v(z, z3, *args)
    Jc = _jac_c(z, z3, *args)   # (O, 2, 7)
    Jp = _jac_p(z, z3, *args)   # (O, 2, 3)

    chi2 = jnp.sum(e * e, axis=-1) * prob.obs_w
    w = prob.obs_w * huber_weight(chi2) * prob.obs_valid
    # frozen columns: whole pose for fixed KFs, scale column when scale_fixed
    col_free = (~prob.kf_fixed[prob.obs_kf, None, None]) * jnp.where(
        prob.kf_scale_fixed[prob.obs_kf, None, None],
        jnp.array([1, 1, 1, 1, 1, 1, 0], pts.dtype)[None, None, :],
        1.0,
    )
    Jc = Jc * col_free
    Jc_w = Jc * w[:, None, None]
    Jp_w = Jp * w[:, None, None]

    Hcc = jnp.zeros((K, 7, 7), Jc.dtype).at[prob.obs_kf].add(
        jnp.einsum("oij,oik->ojk", Jc_w, Jc))
    bc = jnp.zeros((K, 7), Jc.dtype).at[prob.obs_kf].add(
        jnp.einsum("oij,oi->oj", Jc_w, e))
    Hll = jnp.zeros((P, 3, 3), Jp.dtype).at[prob.obs_pt].add(
        jnp.einsum("oij,oik->ojk", Jp_w, Jp))
    bp = jnp.zeros((P, 3), Jp.dtype).at[prob.obs_pt].add(
        jnp.einsum("oij,oi->oj", Jp_w, e))
    A = jnp.zeros((P, K, 7, 3), Jc.dtype).at[prob.obs_pt, prob.obs_kf].add(
        jnp.einsum("oij,oik->ojk", Jc_w, Jp))

    U = inv3(Hll + lam * jnp.eye(3, dtype=Hll.dtype)[None])
    B = jnp.einsum("pcij,pjk->pcik", A, U)
    S = -jnp.einsum("pcij,pdkj->cdik", B, A)
    diag = jnp.arange(K)
    eye7 = jnp.eye(7, dtype=Hcc.dtype)
    S = S.at[diag, diag].add(Hcc + lam * eye7[None])
    fixed = prob.kf_fixed
    S = jnp.where(fixed[:, None, None, None] | fixed[None, :, None, None], 0.0, S)
    S = S.at[diag, diag].add(jnp.where(fixed, 1.0, 0.0)[:, None, None] * eye7[None])
    # scale-fixed KFs have a zero scale row/col in S; pin it to identity so
    # the dense solve stays nonsingular (the delta there is forced to 0).
    sc = (~fixed) & prob.kf_scale_fixed
    S = S.at[diag, diag, 6, 6].add(jnp.where(sc, 1.0, 0.0))

    rhs = bc - jnp.einsum("pcij,pj->ci", B, bp)
    rhs = jnp.where(fixed[:, None], 0.0, rhs)
    rhs = rhs.at[:, 6].set(jnp.where(sc, 0.0, rhs[:, 6]))

    Smat = S.transpose(0, 2, 1, 3).reshape(K * 7, K * 7)
    delta_c = jax.scipy.linalg.solve(
        Smat + 1e-8 * jnp.eye(K * 7, dtype=Smat.dtype),
        -rhs.reshape(-1), assume_a="pos",
    ).reshape(K, 7)

    At_dc = jnp.einsum("pcij,ci->pj", A, delta_c)
    delta_p = jnp.einsum("pij,pj->pi", U, -bp - At_dc)
    delta_p = jnp.where(prob.point_valid[:, None], delta_p, 0.0)
    return delta_c, delta_p


@functools.partial(jax.jit, static_argnames=("iterations",))
def bundle_adjust_sim3(prob: Sim3BAProblem, iterations: int = 10) -> Sim3BAResult:
    """LM all-Sim3 local BA with Schur point marginalization."""
    retract_v = jax.vmap(s3.retract)

    chi0, _, _ = _robust_chi2(prob, prob.kf_s, prob.kf_R, prob.kf_t, prob.points)
    lam0 = jnp.asarray(1e-5, prob.points.dtype)

    def body(_, state):
        s, R, t, pts, lam, chi = state
        dc, dp = _solve_delta(prob, s, R, t, pts, lam)
        s_new, R_new, t_new = retract_v(s, R, t, dc)
        pts_new = pts + dp
        chi_new, _, _ = _robust_chi2(prob, s_new, R_new, t_new, pts_new)
        accept = chi_new < chi
        s = jnp.where(accept, s_new, s)
        R = jnp.where(accept, R_new, R)
        t = jnp.where(accept, t_new, t)
        pts = jnp.where(accept, pts_new, pts)
        chi = jnp.where(accept, chi_new, chi)
        lam = jnp.where(accept, lam * 0.5, lam * 4.0)
        return s, R, t, pts, lam, chi

    s, R, t, pts, _, chi = jax.lax.fori_loop(
        0, iterations, body,
        (prob.kf_s, prob.kf_R, prob.kf_t, prob.points, lam0, chi0),
    )
    _, e, c = _robust_chi2(prob, s, R, t, pts)
    # depth sign under Sim3: z of s R x + t
    xc = jax.vmap(s3.transform)(
        s[prob.obs_kf], R[prob.obs_kf], t[prob.obs_kf], pts[prob.obs_pt]
    )
    outlier = prob.obs_valid & ((c > CHI2_MONO) | (xc[..., 2] <= 0))
    return Sim3BAResult(kf_s=s, kf_R=R, kf_t=t, points=pts, chi2=chi,
                        obs_outlier=outlier)

"""Bundle adjustment with Schur-complement marginalization — the core kernel.

Replaces the g2o BlockSolver_6_3 + CHOLMOD + LM stack used by
Optimizer::{BundleAdjustment, GlobalBundleAdjustemnt, LocalBundleAdjustment}
(src/Optimizer.cc:38-152, 287-536; Schur machinery in
Thirdparty/g2o/g2o/core/block_solver.{h,hpp} — _Hschur/_DInvSchur with
points marginalized).

Array-program formulation (no sparse matrices, no pointer graphs):
  * observations are flat padded arrays (obs_kf, obs_pt, obs_uv, w, valid);
  * per-camera 6x6 and per-point 3x3 Hessian blocks via scatter-add
    (segment-sum) over observations;
  * the camera-point coupling is assembled DENSELY per (point, camera):
        A[p, c] = J_c^T W J_p   for the (at most one) observation of point
                                 p by camera c
    so the Schur complement is one einsum:
        S[c, d] -= sum_p A[p, c] (Hll_p + lam I)^-1 A[p, d]^T
    — a dense contraction instead of CHOLMOD's sparse elimination;
  * the reduced (6K x 6K) camera system is solved with dense Cholesky;
  * LM damping with accept/reject on the true robust chi2, fixed iteration
    budget (lax.fori_loop) replacing g2o's _mbAbortBA interruption (P3 in
    SURVEY.md: interruptible BA becomes a fixed budget).

Returned outlier mask mirrors the reference's post-BA erasure of
observations with chi2 > 5.991 or negative depth (Optimizer.cc:453-470).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry.se3 import exp_se3, compose, orthonormalize
from .reproj import residuals, jacobians, huber_weight, CHI2_MONO


class BAProblem(NamedTuple):
    """Padded, fixed-shape bundle adjustment problem."""

    kf_R: jax.Array         # (K, 3, 3) world->cam
    kf_t: jax.Array         # (K, 3)
    kf_fixed: jax.Array     # (K,) bool — held constant (gauge/fixed/invalid)
    points: jax.Array       # (P, 3)
    point_valid: jax.Array  # (P,) bool
    obs_kf: jax.Array       # (O,) int32
    obs_pt: jax.Array       # (O,) int32
    obs_uv: jax.Array       # (O, 2)
    obs_w: jax.Array        # (O,) inv_sigma2 information weight
    obs_valid: jax.Array    # (O,) bool
    K4: jax.Array           # (4,)


class BAResult(NamedTuple):
    kf_R: jax.Array
    kf_t: jax.Array
    points: jax.Array
    chi2: jax.Array          # robust total chi2 at the end
    obs_outlier: jax.Array   # (O,) bool — chi2 > 5.991 or nonpositive depth


def _robust_chi2(prob: BAProblem, R, t, pts, use_huber=True):
    """Total robust chi2 (Huber rho) over valid observations."""
    e, p = residuals(R[prob.obs_kf], t[prob.obs_kf], pts[prob.obs_pt], prob.obs_uv, prob.K4)
    c = jnp.sum(e * e, axis=-1) * prob.obs_w
    if use_huber:
        # Huber rho: c if c <= delta^2 else 2 delta sqrt(c) - delta^2
        delta2 = CHI2_MONO
        rho = jnp.where(c <= delta2, c, 2.0 * jnp.sqrt(delta2 * c) - delta2)
    else:
        rho = c
    return jnp.sum(jnp.where(prob.obs_valid, rho, 0.0))


def _build_normal_eq(prob: BAProblem, R, t, pts):
    """Blocks of the normal equations at the current state.

    Returns (Hcc (K,6,6), bc (K,6), Hll (P,3,3), bp (P,3), A (P,K,6,3)).
    """
    K = prob.kf_R.shape[0]
    P = prob.points.shape[0]
    Rk = R[prob.obs_kf]
    tk = t[prob.obs_kf]
    xw = pts[prob.obs_pt]
    e, _ = residuals(Rk, tk, xw, prob.obs_uv, prob.K4)
    Jc, Jp, pcam = jacobians(Rk, tk, xw, prob.K4)
    chi2 = jnp.sum(e * e, axis=-1) * prob.obs_w
    w = prob.obs_w * huber_weight(chi2) * prob.obs_valid
    # fixed cameras contribute no pose columns
    w_c = jnp.where(prob.kf_fixed[prob.obs_kf], 0.0, 1.0)
    Jc = Jc * w_c[:, None, None]

    Jc_w = Jc * w[:, None, None]
    Jp_w = Jp * w[:, None, None]

    Hcc = jnp.zeros((K, 6, 6), Jc.dtype).at[prob.obs_kf].add(
        jnp.einsum("oij,oik->ojk", Jc_w, Jc)
    )
    bc = jnp.zeros((K, 6), Jc.dtype).at[prob.obs_kf].add(
        jnp.einsum("oij,oi->oj", Jc_w, e)
    )
    Hll = jnp.zeros((P, 3, 3), Jp.dtype).at[prob.obs_pt].add(
        jnp.einsum("oij,oik->ojk", Jp_w, Jp)
    )
    bp = jnp.zeros((P, 3), Jp.dtype).at[prob.obs_pt].add(
        jnp.einsum("oij,oi->oj", Jp_w, e)
    )
    Y = jnp.einsum("oij,oik->ojk", Jc_w, Jp)  # (O, 6, 3)
    A = jnp.zeros((P, K, 6, 3), Jc.dtype).at[prob.obs_pt, prob.obs_kf].add(Y)
    return Hcc, bc, Hll, bp, A


from .linalg3 import inv3 as _inv3  # canonical closed-form 3x3 inverse


def _solve_delta(prob: BAProblem, R, t, pts, lam):
    """One damped Schur-reduced solve.

    Returns (delta_c (K,6), delta_p (P,3), bc, bp) — the gradients feed the
    LM gain-ratio computation."""
    K = prob.kf_R.shape[0]
    Hcc, bc, Hll, bp, A = _build_normal_eq(prob, R, t, pts)

    eye3 = jnp.eye(3, dtype=Hll.dtype)
    # point validity: invalid/unobserved points get identity (their delta
    # ends up 0 because bp = 0 and A = 0)
    U = _inv3(Hll + lam * eye3[None])

    B = jnp.einsum("pcij,pjk->pcik", A, U)           # (P, K, 6, 3)
    S_cross = jnp.einsum("pcij,pdkj->cdik", B, A)    # (P,K,6,3)x(P,K,6,3)->(K,K,6,6)
    S = -S_cross
    diag = jnp.arange(K)
    eye6 = jnp.eye(6, dtype=Hcc.dtype)
    S = S.at[diag, diag].add(Hcc + lam * eye6[None])
    # fixed cameras: identity row/col so their delta is exactly 0
    fixed = prob.kf_fixed
    S = jnp.where(fixed[:, None, None, None] | fixed[None, :, None, None], 0.0, S)
    S = S.at[diag, diag].add(jnp.where(fixed, 1.0, 0.0)[:, None, None] * eye6[None])

    rhs_c = bc - jnp.einsum("pcij,pj->ci", B, bp)    # (K, 6)
    rhs_c = jnp.where(fixed[:, None], 0.0, rhs_c)

    Smat = S.transpose(0, 2, 1, 3).reshape(K * 6, K * 6)
    # GN solves H delta = -b
    delta_c = jax.scipy.linalg.solve(
        Smat + 1e-8 * jnp.eye(K * 6, dtype=Smat.dtype),
        -rhs_c.reshape(-1),
        assume_a="pos",
    ).reshape(K, 6)

    # back-substitution: delta_p = U (-bp - A^T delta_c)
    At_dc = jnp.einsum("pcij,ci->pj", A, delta_c)    # sum_c A[p,c]^T dc_c
    delta_p = jnp.einsum("pij,pj->pi", U, -bp - At_dc)
    delta_p = jnp.where(prob.point_valid[:, None], delta_p, 0.0)
    return delta_c, delta_p, bc, bp


@functools.partial(jax.jit, static_argnames=("iterations",))
def bundle_adjust(prob: BAProblem, iterations: int = 10, lam0: float = -1.0) -> BAResult:
    """LM bundle adjustment with Schur marginalization of the points.

    lam0 < 0 -> g2o's tau * max(diag) initialization
    (optimization_algorithm_levenberg.cpp:47, tau = 1e-5).
    """
    # initial lambda from the undamped Hessian diagonal
    Hcc, _, Hll, _, _ = _build_normal_eq(prob, prob.kf_R, prob.kf_t, prob.points)
    max_diag = jnp.maximum(
        jnp.max(jnp.abs(jnp.diagonal(Hcc, axis1=-2, axis2=-1))),
        jnp.max(jnp.abs(jnp.diagonal(Hll, axis1=-2, axis2=-1))),
    )
    lam_init = jnp.where(lam0 < 0, 1e-5 * max_diag, lam0)

    chi0 = _robust_chi2(prob, prob.kf_R, prob.kf_t, prob.points)

    def cond(state):
        i, _, _, _, _, _, _, done = state
        return (i < iterations) & ~done

    def body(state):
        i, R, t, pts, lam, ni, chi, done = state
        dc, dp, bc, bp = _solve_delta(prob, R, t, pts, lam)
        dR, dt = exp_se3(dc)
        R_new, t_new = compose(dR, dt, R, t)
        R_new = orthonormalize(R_new)  # keep f32 products on SO(3)
        # fixed cameras keep their exact pose (delta is 0 there anyway)
        pts_new = pts + dp
        chi_new = _robust_chi2(prob, R_new, t_new, pts_new)
        # g2o's gain-ratio schedule (optimization_algorithm_levenberg.cpp:
        # 100-160): rho = actual / predicted reduction with predicted =
        # 0.5 delta^T (lam delta - grad); accept shrinks lam by
        # max(1/3, 1-(2rho-1)^3) and resets ni=2, reject doubles ni
        pred = 0.5 * (jnp.sum(dc * (lam * dc - bc)) +
                      jnp.sum(dp * (lam * dp - bp)))
        rho = (chi - chi_new) / jnp.where(jnp.abs(pred) < 1e-30, 1e-30, pred)
        accept = (rho > 0) & (chi_new < chi) & jnp.isfinite(chi_new)
        # convergence: an accepted step that no longer moves chi2 — the
        # g2o terminate action's relative-gain criterion
        done = accept & (chi - chi_new < 1e-5 * chi)
        R = jnp.where(accept, R_new, R)
        t = jnp.where(accept, t_new, t)
        pts = jnp.where(accept, pts_new, pts)
        chi = jnp.where(accept, chi_new, chi)
        factor = jnp.maximum(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3)
        lam = jnp.where(accept, lam * factor, lam * ni)
        lam = jnp.clip(lam, 1e-12, 1e12)
        ni = jnp.where(accept, 2.0, ni * 2.0)
        return i + 1, R, t, pts, lam, ni, chi, done

    _, R, t, pts, _, _, chi, _ = jax.lax.while_loop(
        cond, body,
        (jnp.int32(0), prob.kf_R, prob.kf_t, prob.points, lam_init,
         jnp.float32(2.0), chi0, jnp.asarray(False)),
    )

    # outlier classification at the solution (Optimizer.cc:453-470)
    e, pcam = residuals(R[prob.obs_kf], t[prob.obs_kf], pts[prob.obs_pt], prob.obs_uv, prob.K4)
    c = jnp.sum(e * e, axis=-1) * prob.obs_w
    outlier = prob.obs_valid & ((c > CHI2_MONO) | (pcam[..., 2] <= 0))
    return BAResult(kf_R=R, kf_t=t, points=pts, chi2=chi, obs_outlier=outlier)


def two_stage_local_ba(prob: BAProblem) -> BAResult:
    """The reference's local BA schedule: 5 iterations, drop outliers,
    10 more iterations (src/Optimizer.cc:450-494 — '5 iters -> erase
    chi2>5.991 -> 10 iters')."""
    r1 = bundle_adjust(prob, iterations=5)
    prob2 = prob._replace(
        kf_R=r1.kf_R, kf_t=r1.kf_t, points=r1.points,
        obs_valid=prob.obs_valid & ~r1.obs_outlier,
    )
    r2 = bundle_adjust(prob2, iterations=10)
    # report the union of both erase passes (both remove map observations
    # in the reference, Optimizer.cc:453-470 + :496-520)
    return r2._replace(obs_outlier=r1.obs_outlier | r2.obs_outlier)

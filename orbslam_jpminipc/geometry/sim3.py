"""Sim3 (similarity transform) group: exp/log, compose, inverse.

Array-program replacement for g2o's Sim3 type (reference:
Thirdparty/g2o/g2o/types/sim3/sim3.h — exp/log at sim3.h:148; used by the
loop-closing Sim3 optimization and the essential-graph optimizer,
src/Optimizer.cc:1470-1917). Batched, differentiable jax.numpy.

A Sim3 element is a tuple ``(s, R, t)`` acting on points by
``y = s * R @ x + t``. Tangent 7-vectors are ``[omega(3), upsilon(3), sigma]``
(rotation, translation, log-scale), matching g2o's ordering.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from .se3 import exp_so3, hat, log_so3

_EPS = 1e-6


def identity(dtype=jnp.float32):
    return jnp.ones((), dtype), jnp.eye(3, dtype=dtype), jnp.zeros((3,), dtype)


def transform(s, R, t, x) -> jax.Array:
    """Apply (s,R,t) to points x (..., 3)."""
    return s[..., None] * jnp.einsum("...ij,...j->...i", R, x) + t


def compose(sa, Ra, ta, sb, Rb, tb):
    """(sa,Ra,ta) * (sb,Rb,tb): apply b first, then a."""
    s = sa * sb
    R = Ra @ Rb
    t = sa[..., None] * jnp.einsum("...ij,...j->...i", Ra, tb) + ta
    return s, R, t


def inverse(s, R, t):
    s_inv = 1.0 / s
    R_inv = jnp.swapaxes(R, -1, -2)
    t_inv = -s_inv[..., None] * jnp.einsum("...ij,...j->...i", R_inv, t)
    return s_inv, R_inv, t_inv


def _W_matrix(omega: jax.Array, sigma: jax.Array) -> jax.Array:
    """The Sim3 'left Jacobian' W with t = W @ upsilon (g2o sim3.h ctor).

    W = A*Omega + B*Omega^2 + C*I, where A, B, C depend on (theta, sigma)
    with series fallbacks near zero. Implemented branch-free with jnp.where.
    """
    dtype = omega.dtype
    theta2 = jnp.sum(omega * omega, axis=-1)
    theta = jnp.sqrt(theta2 + 1e-24)
    s = jnp.exp(sigma)
    sigma2 = sigma * sigma

    small_sigma = jnp.abs(sigma) < _EPS
    small_theta = theta < _EPS

    # C = (s - 1)/sigma, -> 1 as sigma -> 0.
    C = jnp.where(small_sigma, 1.0 + sigma / 2.0, (s - 1.0) / jnp.where(small_sigma, 1.0, sigma))

    # Case sigma ~ 0:
    A_s0 = jnp.where(small_theta, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / jnp.where(small_theta, 1.0, theta2))
    B_s0 = jnp.where(
        small_theta, 1.0 / 6.0 - theta2 / 120.0,
        (theta - jnp.sin(theta)) / jnp.where(small_theta, 1.0, theta2 * theta),
    )

    # Case sigma != 0, theta ~ 0:
    safe_sigma2 = jnp.where(small_sigma, 1.0, sigma2)
    A_t0 = ((sigma - 1.0) * s + 1.0) / safe_sigma2
    B_t0 = ((0.5 * sigma2 - sigma + 1.0) * s - 1.0) / (safe_sigma2 * jnp.where(small_sigma, 1.0, sigma))

    # General case:
    a = s * jnp.sin(theta)
    b = s * jnp.cos(theta)
    c = theta2 + sigma2
    safe_theta = jnp.where(small_theta, 1.0, theta)
    safe_c = jnp.where(c < 1e-24, 1.0, c)
    A_g = (a * sigma + (1.0 - b) * theta) / (safe_theta * safe_c)
    B_g = (C - ((b - 1.0) * sigma + a * theta) / safe_c) / jnp.where(small_theta, 1.0, theta2)

    A = jnp.where(small_sigma, A_s0, jnp.where(small_theta, A_t0, A_g))
    B = jnp.where(small_sigma, B_s0, jnp.where(small_theta, B_t0, B_g))

    Omega = hat(omega)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=dtype), Omega.shape)
    return A[..., None, None] * Omega + B[..., None, None] * (Omega @ Omega) + C[..., None, None] * eye


def exp7(xi: jax.Array):
    """Sim3 exp: 7-vector [omega, upsilon, sigma] -> (s, R, t)."""
    omega, upsilon, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    s = jnp.exp(sigma)
    R = exp_so3(omega)
    W = _W_matrix(omega, sigma)
    t = jnp.einsum("...ij,...j->...i", W, upsilon)
    return s, R, t


def log7(s, R, t) -> jax.Array:
    """Sim3 log: (s, R, t) -> 7-vector [omega, upsilon, sigma]."""
    sigma = jnp.log(s)
    omega = log_so3(R)
    W = _W_matrix(omega, sigma)
    upsilon = jnp.linalg.solve(W, t[..., None])[..., 0]
    return jnp.concatenate([omega, upsilon, sigma[..., None]], axis=-1)


def retract(s, R, t, xi, fix_scale: bool = False):
    """Left-multiplicative update exp(xi) * (s,R,t); optionally freeze scale.

    Mirrors g2o VertexSim3Expmap::oplusImpl with optional `_fix_scale`
    (types_seven_dof_expmap.h:47-93) used for the scale-frozen keyframes in
    the 7-DoF local BA variants and the essential graph.
    """
    if fix_scale:
        xi = xi.at[..., 6].set(0.0)
    ds, dR, dt = exp7(xi)
    return compose(ds, dR, dt, s, R, t)


def pack8(s, R, t) -> jax.Array:
    """Pack to an 8-vector [qw,qx,qy,qz, tx,ty,tz, s] for SoA storage."""
    from .se3 import quat_from_mat

    return jnp.concatenate([quat_from_mat(R), t, s[..., None]], axis=-1)


def unpack8(p: jax.Array):
    from .se3 import mat_from_quat

    return p[..., 7], mat_from_quat(p[..., :4]), p[..., 4:7]

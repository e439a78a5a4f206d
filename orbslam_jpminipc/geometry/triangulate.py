"""Two-view DLT triangulation and its validity gates.

Replaces Initializer::Triangulate (src/Initializer.cc:732-745) and the
triangulation-validity gates of LocalMapping::CreateNewMapPoints
(src/LocalMapping.cc:299-374), redesigned as batched closed-form linear
algebra: instead of per-point cv::SVD on a 4x4, we solve the 3x3 normal
equations of the DLT system (A x = b after dehomogenizing w=1), which is
batched, differentiable, and needs no SVD.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def projection_matrix(R: jax.Array, t: jax.Array, K4: jax.Array) -> jax.Array:
    """K[R|t] as a (..., 3, 4) matrix."""
    fx, fy, cx, cy = K4[..., 0], K4[..., 1], K4[..., 2], K4[..., 3]
    zeros = jnp.zeros_like(fx)
    ones = jnp.ones_like(fx)
    K = jnp.stack(
        [
            jnp.stack([fx, zeros, cx], -1),
            jnp.stack([zeros, fy, cy], -1),
            jnp.stack([zeros, zeros, ones], -1),
        ],
        axis=-2,
    )
    Rt = jnp.concatenate([R, t[..., None]], axis=-1)
    return K @ Rt


def triangulate_dlt(uv1: jax.Array, uv2: jax.Array, P1: jax.Array, P2: jax.Array):
    """Batched two-view DLT. uv: (..., 2) pixels, P: (3, 4) or (..., 3, 4).

    Builds the standard 4x4 DLT system rows
      u * P[2] - P[0],  v * P[2] - P[1]   (both views)
    and solves min |A [x;1]| via the normal equations of the inhomogeneous
    system A[:, :3] x = -A[:, 3]. Returns (xw (...,3), ok mask) where ok
    flags well-conditioned solves (non-singular normal matrix).
    """
    def rows(uv, P):
        r0 = uv[..., 0:1] * P[..., 2, :] - P[..., 0, :]
        r1 = uv[..., 1:2] * P[..., 2, :] - P[..., 1, :]
        return jnp.stack([r0, r1], axis=-2)

    A = jnp.concatenate([rows(uv1, P1), rows(uv2, P2)], axis=-2)  # (..., 4, 4)
    M = A[..., :3]
    b = -A[..., 3]
    AtA = jnp.einsum("...ki,...kj->...ij", M, M)
    Atb = jnp.einsum("...ki,...k->...i", M, b)
    # closed-form adjugate solve: Cramer's rule is elementwise arithmetic
    # that fuses into one kernel, with no batched pivoted-LU loop
    a0, b0, c0 = AtA[..., 0, 0], AtA[..., 0, 1], AtA[..., 0, 2]
    d0, e0, f0 = AtA[..., 1, 0], AtA[..., 1, 1], AtA[..., 1, 2]
    g0, h0, i0 = AtA[..., 2, 0], AtA[..., 2, 1], AtA[..., 2, 2]
    cA = e0 * i0 - f0 * h0
    cD = f0 * g0 - d0 * i0
    cG = d0 * h0 - e0 * g0
    det = a0 * cA + b0 * cD + c0 * cG
    ok = jnp.abs(det) > 1e-18
    from ..solvers.linalg3 import inv3

    safe = jnp.where(ok[..., None, None], AtA,
                     jnp.broadcast_to(jnp.eye(3, dtype=AtA.dtype), AtA.shape))
    x = jnp.einsum("...ij,...j->...i", inv3(safe), Atb)
    finite = jnp.all(jnp.isfinite(x), axis=-1)
    return x, ok & finite


def parallax_cos(xw: jax.Array, O1: jax.Array, O2: jax.Array) -> jax.Array:
    """Cosine of the parallax angle at point xw seen from camera centers O1, O2.

    Mirrors the parallax computation in Initializer::CheckRT
    (src/Initializer.cc:796-905) and LocalMapping::CreateNewMapPoints.
    """
    n1 = xw - O1
    n2 = xw - O2
    d1 = jnp.linalg.norm(n1, axis=-1)
    d2 = jnp.linalg.norm(n2, axis=-1)
    return jnp.sum(n1 * n2, axis=-1) / jnp.maximum(d1 * d2, 1e-12)


def reprojection_error2(xw: jax.Array, uv: jax.Array, R: jax.Array, t: jax.Array, K4: jax.Array):
    """Squared pixel reprojection error and positive-depth mask."""
    from .camera import project

    xc = jnp.einsum("...ij,...j->...i", R, xw) + t
    err = project(xc, K4) - uv
    return jnp.sum(err * err, axis=-1), xc[..., 2] > 0

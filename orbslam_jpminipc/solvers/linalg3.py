"""Small fixed-size linear algebra, closed-form and batched.

Tiny LU/Cholesky factorizations (6x6 pose systems, 3x3 point blocks)
lower to sequential scalar loops; these closed forms are elementwise
arithmetic with no data-dependent control flow.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def inv3(M):
    """Batched closed-form 3x3 inverse (adjugate / det)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = c * h - b * i
    C = b * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    H = b * g - a * h
    I = a * e - b * d
    det = a * A + b * D + c * G
    inv_det = 1.0 / jnp.where(jnp.abs(det) < 1e-18, 1e-18, det)
    adj = jnp.stack(
        [
            jnp.stack([A, B, C], -1),
            jnp.stack([D, E, F], -1),
            jnp.stack([G, H, I], -1),
        ],
        axis=-2,
    )
    return adj * inv_det[..., None, None]


def solve6_spd(H, b):
    """Solve H x = b for symmetric positive-definite 6x6 H (batched) via
    2x2-block Schur elimination with closed-form 3x3 inverses."""
    A = H[..., :3, :3]
    B = H[..., :3, 3:]
    D = H[..., 3:, 3:]
    b1 = b[..., :3]
    b2 = b[..., 3:]
    Ai = inv3(A)
    AiB = Ai @ B
    S = D - jnp.swapaxes(B, -1, -2) @ AiB
    Si = inv3(S)
    rhs2 = b2 - jnp.einsum("...ji,...j->...i", AiB, b1)
    x2 = jnp.einsum("...ij,...j->...i", Si, rhs2)
    x1 = jnp.einsum("...ij,...j->...i", Ai, b1) - jnp.einsum("...ij,...j->...i", AiB, x2)
    return jnp.concatenate([x1, x2], axis=-1)

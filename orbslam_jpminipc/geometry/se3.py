"""SO3/SE3 operations: quaternions, Rodrigues exp/log, se3 exp/log.

Array-program replacement for the reference's g2o SE3 machinery
(reference: Thirdparty/g2o/g2o/types/slam3d/se3quat.h — exp/log maps;
src/Converter.cc — cv::Mat/quaternion conversions). All ops are pure
jax.numpy, batched over leading dims, and differentiable.

Conventions
-----------
* Rotations as 3x3 matrices ``R`` (world->camera when used as ``Tcw``).
* Rigid transforms as ``(R, t)`` pairs acting by ``x_cam = R @ x_world + t``.
* se3 tangent vectors are 6-vectors ``[omega, upsilon]`` (rotation first),
  matching g2o's ``SE3Quat::exp`` ordering; updates are LEFT-multiplicative
  (``T_new = exp(xi) * T_old``) as in g2o's ``VertexSE3Expmap::oplusImpl``.
* Quaternions are ``[w, x, y, z]`` (scalar first), normalized.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

_EPS = 1e-8


def hat(w: jax.Array) -> jax.Array:
    """Skew-symmetric matrix of ``w`` (..., 3) -> (..., 3, 3)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = jnp.zeros_like(wx)
    return jnp.stack(
        [
            jnp.stack([z, -wz, wy], axis=-1),
            jnp.stack([wz, z, -wx], axis=-1),
            jnp.stack([-wy, wx, z], axis=-1),
        ],
        axis=-2,
    )


def vee(W: jax.Array) -> jax.Array:
    """Inverse of :func:`hat`: (..., 3, 3) -> (..., 3)."""
    return jnp.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], axis=-1)


def exp_so3(w: jax.Array) -> jax.Array:
    """Rodrigues formula: axis-angle (..., 3) -> rotation matrix (..., 3, 3).

    Uses the Taylor expansion of sin(t)/t and (1-cos(t))/t^2 near t=0 so the
    function is smooth and safely differentiable at the identity.
    """
    theta2 = jnp.sum(w * w, axis=-1)
    theta = jnp.sqrt(theta2 + _EPS * _EPS)
    # sin(t)/t and (1 - cos t)/t^2 with small-angle fallbacks.
    a = jnp.where(theta2 > _EPS, jnp.sin(theta) / theta, 1.0 - theta2 / 6.0)
    b = jnp.where(
        theta2 > _EPS, (1.0 - jnp.cos(theta)) / jnp.maximum(theta2, _EPS * _EPS),
        0.5 - theta2 / 24.0,
    )
    W = hat(w)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye + a[..., None, None] * W + b[..., None, None] * (W @ W)


def log_so3(R: jax.Array) -> jax.Array:
    """Rotation matrix (..., 3, 3) -> axis-angle (..., 3).

    Computed via the unit quaternion (Shepperd max-pivot extraction), which is
    numerically stable for all angles in [0, pi] including the near-pi case
    that defeats the trace/off-diagonal formula.
    """
    q = quat_from_mat(R)  # [w, x, y, z], w >= 0 so theta in [0, pi]
    w, xyz = q[..., 0], q[..., 1:]
    # Smooth norm: keeps the function AND its derivatives finite at the
    # identity (a plain norm has a NaN gradient at 0, which poisons the
    # autodiff Jacobians of the Sim3 pose-graph residuals).
    n = jnp.sqrt(jnp.sum(xyz * xyz, axis=-1) + 1e-24)
    theta = 2.0 * jnp.arctan2(n, w)
    return (theta / n)[..., None] * xyz


def _so3_left_jacobian(w: jax.Array) -> jax.Array:
    """V such that exp_se3([w, v]).t = V @ v (the SO3 left Jacobian)."""
    theta2 = jnp.sum(w * w, axis=-1)
    theta = jnp.sqrt(theta2 + _EPS * _EPS)
    b = jnp.where(
        theta2 > _EPS, (1.0 - jnp.cos(theta)) / jnp.maximum(theta2, _EPS * _EPS),
        0.5 - theta2 / 24.0,
    )
    c = jnp.where(
        theta2 > _EPS,
        (theta - jnp.sin(theta)) / jnp.maximum(theta2 * theta, _EPS ** 3),
        1.0 / 6.0 - theta2 / 120.0,
    )
    W = hat(w)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye + b[..., None, None] * W + c[..., None, None] * (W @ W)


def exp_se3(xi: jax.Array) -> tuple[jax.Array, jax.Array]:
    """se3 exp map: 6-vector ``[omega, upsilon]`` -> ``(R, t)``."""
    w, v = xi[..., :3], xi[..., 3:]
    R = exp_so3(w)
    V = _so3_left_jacobian(w)
    t = jnp.einsum("...ij,...j->...i", V, v)
    return R, t


def log_se3(R: jax.Array, t: jax.Array) -> jax.Array:
    """Inverse of :func:`exp_se3`: ``(R, t)`` -> 6-vector ``[omega, upsilon]``."""
    w = log_so3(R)
    V = _so3_left_jacobian(w)
    v = jnp.linalg.solve(V, t[..., None])[..., 0]
    return jnp.concatenate([w, v], axis=-1)


# ---------------------------------------------------------------------------
# Rigid-transform algebra
# ---------------------------------------------------------------------------

def compose(Ra, ta, Rb, tb) -> tuple[jax.Array, jax.Array]:
    """(Ra,ta) * (Rb,tb): apply b first, then a."""
    return Ra @ Rb, jnp.einsum("...ij,...j->...i", Ra, tb) + ta


def orthonormalize(R: jax.Array) -> jax.Array:
    """Project a near-rotation back onto SO(3) (batched over leading dims).

    Two Newton steps of the polar-decomposition iteration
    X <- X (3 I - X^T X) / 2 (quadratic convergence for ||X^T X - I|| < 1).
    f32 rotation products drift off the manifold: the reference never hits
    this because g2o's SE3Quat renormalizes its quaternion on every update
    (Thirdparty/g2o se3quat.h); an iterative optimizer composing thousands
    of 3x3 float32 products per frame MUST re-project or the accumulated
    scale error masquerades as map-scale drift and eventually corrupts the
    pose (det(R) wandering from 1 trades rotation scale against depth).
    Closed-form matmuls — no SVD, no data-dependent control flow.
    """
    eye = jnp.eye(3, dtype=R.dtype)
    for _ in range(2):
        RtR = jnp.einsum("...ji,...jk->...ik", R, R)
        R = jnp.einsum("...ij,...jk->...ik", R, 1.5 * eye - 0.5 * RtR)
    return R


def inverse(R, t) -> tuple[jax.Array, jax.Array]:
    Rt = jnp.swapaxes(R, -1, -2)
    return Rt, -jnp.einsum("...ij,...j->...i", Rt, t)


def transform(R, t, x) -> jax.Array:
    """Apply (R, t) to points x of shape (..., 3)."""
    return jnp.einsum("...ij,...j->...i", R, x) + t


def retract(R, t, xi) -> tuple[jax.Array, jax.Array]:
    """Left-multiplicative update ``exp(xi) * (R, t)`` (g2o oplus)."""
    dR, dt = exp_se3(xi)
    return compose(dR, dt, R, t)


def camera_center(R, t) -> jax.Array:
    """Camera center in world coords for a world->camera transform: -R^T t."""
    return -jnp.einsum("...ji,...j->...i", R, t)


# ---------------------------------------------------------------------------
# Quaternions ([w, x, y, z])
# ---------------------------------------------------------------------------

def quat_from_mat(R: jax.Array) -> jax.Array:
    """Rotation matrix -> unit quaternion [w,x,y,z]; branch-free Shepperd."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    # Four candidate constructions; pick the numerically best by max pivot.
    qw = jnp.sqrt(jnp.clip(1.0 + m00 + m11 + m22, 1e-12, None)) * 0.5
    qx = jnp.sqrt(jnp.clip(1.0 + m00 - m11 - m22, 1e-12, None)) * 0.5
    qy = jnp.sqrt(jnp.clip(1.0 - m00 + m11 - m22, 1e-12, None)) * 0.5
    qz = jnp.sqrt(jnp.clip(1.0 - m00 - m11 + m22, 1e-12, None)) * 0.5
    c0 = jnp.stack([qw, (m21 - m12) / (4 * qw), (m02 - m20) / (4 * qw), (m10 - m01) / (4 * qw)], -1)
    c1 = jnp.stack([(m21 - m12) / (4 * qx), qx, (m01 + m10) / (4 * qx), (m02 + m20) / (4 * qx)], -1)
    c2 = jnp.stack([(m02 - m20) / (4 * qy), (m01 + m10) / (4 * qy), qy, (m12 + m21) / (4 * qy)], -1)
    c3 = jnp.stack([(m10 - m01) / (4 * qz), (m02 + m20) / (4 * qz), (m12 + m21) / (4 * qz), qz], -1)
    pivots = jnp.stack([qw, qx, qy, qz], axis=-1)
    idx = jnp.argmax(pivots, axis=-1)
    cands = jnp.stack([c0, c1, c2, c3], axis=-2)
    q = jnp.take_along_axis(cands, idx[..., None, None].repeat(4, -1), axis=-2)[..., 0, :]
    # Canonical sign: w >= 0.
    q = q * jnp.where(q[..., :1] < 0, -1.0, 1.0)
    return q / jnp.linalg.norm(q, axis=-1, keepdims=True)


def mat_from_quat(q: jax.Array) -> jax.Array:
    """Unit quaternion [w,x,y,z] -> rotation matrix."""
    q = q / jnp.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return jnp.stack(
        [
            jnp.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
            jnp.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
            jnp.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
        ],
        axis=-2,
    )


def quat_mul(a: jax.Array, b: jax.Array) -> jax.Array:
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return jnp.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        axis=-1,
    )


def pose7_from_Rt(R: jax.Array, t: jax.Array) -> jax.Array:
    """Pack (R, t) into a 7-vector [qw,qx,qy,qz, tx,ty,tz] (storage format)."""
    return jnp.concatenate([quat_from_mat(R), t], axis=-1)


def Rt_from_pose7(p: jax.Array) -> tuple[jax.Array, jax.Array]:
    return mat_from_quat(p[..., :4]), p[..., 4:7]

"""ORB orientation and descriptor as batched gather/compare ops.

Replaces IC_Angle (src/ORBextractor.cc:124-151), the 7x7 sigma=2 Gaussian
blur (src/ORBextractor.cc:760), and computeOrbDescriptor
(src/ORBextractor.cc:155-194). Instead of per-keypoint C++ loops, a patch is
gathered per keypoint (vmapped dynamic_slice) and all 256 point-pair
comparisons happen as one vectorized gather + compare.

Uses the exact OpenCV point-pair pattern (ops/orb_pattern.py), the same
round-half-even rotation arithmetic, and the same LSB-first bit packing, so
descriptors are directly comparable to cv2.ORB / the reference matcher.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from .orb_pattern import BIT_PATTERN_31

HALF_PATCH_SIZE = 15
PATCH_RADIUS = 18  # covers rotated pattern points (|coord| <= 13*sqrt(2) < 19)
PATCH_SIZE = 2 * PATCH_RADIUS + 1  # 37


def _u_max_table() -> np.ndarray:
    """Circular-patch row extents, exactly as the reference builds them
    (src/ORBextractor.cc:464-474 — OpenCV's symmetric umax construction)."""
    hp = HALF_PATCH_SIZE
    umax = np.zeros(hp + 1, np.int32)
    vmax = int(np.floor(hp * np.sqrt(2.0) / 2 + 1))
    vmin = int(np.ceil(hp * np.sqrt(2.0) / 2))
    for v in range(vmax + 1):
        umax[v] = int(round(np.sqrt(hp * hp - v * v)))
    v0 = 0
    for v in range(hp, vmin - 1, -1):
        while umax[v0] == umax[v0 + 1]:
            v0 += 1
        umax[v] = v0
        v0 += 1
    return umax


def _circular_mask() -> np.ndarray:
    """(31, 31) boolean mask of the orientation patch."""
    umax = _u_max_table()
    hp = HALF_PATCH_SIZE
    mask = np.zeros((2 * hp + 1, 2 * hp + 1), bool)
    for v in range(-hp, hp + 1):
        u_lim = umax[abs(v)]
        mask[v + hp, hp - u_lim : hp + u_lim + 1] = True
    return mask


_MASK = jnp.array(_circular_mask())
_U_COORDS = jnp.arange(-HALF_PATCH_SIZE, HALF_PATCH_SIZE + 1, dtype=jnp.float32)


def gather_patches(img: jax.Array, xy: jax.Array, radius: int) -> jax.Array:
    """Gather (2r+1)^2 patches centered at integer keypoint coords.

    xy: (N, 2) float (x, y) in image coords (rounded to int). Out-of-range
    starts are clamped by dynamic_slice; callers keep keypoints inside a
    border >= radius so clamping never actually triggers.
    """
    size = 2 * radius + 1
    padded = jnp.pad(img, radius)
    starts = jnp.round(xy).astype(jnp.int32)  # (N, 2) x, y

    def one(start):
        # padded coords: top-left of patch = (y, x) in original = start - r,
        # plus r of padding = start.
        return jax.lax.dynamic_slice(padded, (start[1], start[0]), (size, size))

    return jax.vmap(one)(starts)


def gather_patches_multi(imgs: jax.Array, xy: jax.Array, radius: int) -> jax.Array:
    """Gather patches from C stacked images at once: (C, H, W), (N, 2) ->
    (N, C, 2r+1, 2r+1). One dynamic_slice per keypoint covers all channels
    (the extractor stacks [unblurred, blurred] so orientation and descriptor
    patches cost a single gather)."""
    size = 2 * radius + 1
    padded = jnp.pad(imgs, ((0, 0), (radius, radius), (radius, radius)))
    starts = jnp.round(xy).astype(jnp.int32)

    def one(start):
        return jax.lax.dynamic_slice(
            padded, (0, start[1], start[0]), (imgs.shape[0], size, size)
        )

    return jax.vmap(one)(starts)


def ic_angle_from_patches(patches: jax.Array) -> jax.Array:
    """IC angle from pre-gathered (N, 31, 31) patches — lets the extractor
    batch all pyramid levels' keypoints through one moment computation."""
    masked = patches * _MASK[None]
    m10 = jnp.sum(masked * _U_COORDS[None, None, :], axis=(1, 2))
    m01 = jnp.sum(masked * _U_COORDS[None, :, None], axis=(1, 2))
    ang = jnp.degrees(jnp.arctan2(m01, m10))
    return jnp.where(ang < 0, ang + 360.0, ang)


def ic_angle(img: jax.Array, xy: jax.Array) -> jax.Array:
    """Intensity-centroid orientation, degrees in [0, 360).

    Batched IC_Angle (src/ORBextractor.cc:124-151): moments m01/m10 over the
    circular patch of radius 15 on the (unblurred) level image.
    """
    return ic_angle_from_patches(gather_patches(img, xy, HALF_PATCH_SIZE))


def gaussian_blur_7x7_sigma2(img: jax.Array) -> jax.Array:
    """Separable 7x7 sigma=2 Gaussian, BORDER_REFLECT_101 (ORBextractor.cc:760)."""
    x = np.arange(7) - 3.0
    k = np.exp(-(x * x) / (2.0 * 2.0 * 2.0))
    k = (k / k.sum()).astype(np.float32)
    kern = jnp.array(k)
    padded = jnp.pad(img, ((3, 3), (0, 0)), mode="reflect")
    rows = sum(kern[i] * padded[i : i + img.shape[0], :] for i in range(7))
    padded = jnp.pad(rows, ((0, 0), (3, 3)), mode="reflect")
    return sum(kern[i] * padded[:, i : i + img.shape[1]] for i in range(7))


# Pattern as arrays: (256, 2, 2) -> [pair, point, (x, y)]
_PATTERN = jnp.array(
    np.stack(
        [BIT_PATTERN_31[:, 0:2], BIT_PATTERN_31[:, 2:4]], axis=1
    ).astype(np.float32)
)
_PACK_WEIGHTS = jnp.array([1, 2, 4, 8, 16, 32, 64, 128], jnp.uint8)


def descriptors_from_patches(patches: jax.Array, angle_deg: jax.Array) -> jax.Array:
    """Rotated-BRIEF from pre-gathered (N, 37, 37) blurred patches.

    Matches computeOrbDescriptor (src/ORBextractor.cc:155-194): pattern point
    (x, y) rotated by the keypoint angle with round-half-even (cvRound):
      col' = round(x*cos - y*sin), row' = round(x*sin + y*cos)
    sampled from the blurred image; bit = I(p1) < I(p2); 8 pairs per byte,
    LSB first.

    The sampling is a matmul instead of a scalar gather: the in-patch
    lookup patch[row, col] factorizes into onehot(row) @ patch followed by
    an elementwise contraction with onehot(col) — 37-wide one-hots instead
    of a 1369-wide one, and exact in bfloat16 because image intensities are
    integers <= 255.
    """
    rad = jnp.deg2rad(angle_deg)
    a, b = jnp.cos(rad), jnp.sin(rad)  # a=cos, b=sin as in the reference

    px = _PATTERN[..., 0]  # (256, 2)
    py = _PATTERN[..., 1]
    # (N, 256, 2) rotated integer offsets.
    col = jnp.round(px[None] * a[:, None, None] - py[None] * b[:, None, None]).astype(jnp.int32)
    row = jnp.round(px[None] * b[:, None, None] + py[None] * a[:, None, None]).astype(jnp.int32)
    r = (row + PATCH_RADIUS).reshape(row.shape[0], -1)  # (N, 512)
    c = (col + PATCH_RADIUS).reshape(col.shape[0], -1)
    ohr = jax.nn.one_hot(r, PATCH_SIZE, dtype=jnp.bfloat16)  # (N, 512, 37)
    ohc = jax.nn.one_hot(c, PATCH_SIZE, dtype=jnp.bfloat16)
    rows = jnp.einsum(
        "npr,nrc->npc", ohr, patches.astype(jnp.bfloat16),
        preferred_element_type=jnp.float32,
    )
    vals = jnp.sum(rows * ohc.astype(jnp.float32), axis=-1)  # (N, 512)
    vals = vals.reshape(-1, 256, 2)
    bits = (vals[..., 0] < vals[..., 1]).astype(jnp.uint8)  # (N, 256)
    return jnp.sum(
        bits.reshape(-1, 32, 8) * _PACK_WEIGHTS[None, None, :], axis=-1, dtype=jnp.uint8
    )


def descriptors(img_blurred: jax.Array, xy: jax.Array, angle_deg: jax.Array) -> jax.Array:
    """Rotated-BRIEF descriptors: (N, 32) uint8 (see descriptors_from_patches)."""
    return descriptors_from_patches(
        gather_patches(img_blurred, xy, PATCH_RADIUS), angle_deg
    )

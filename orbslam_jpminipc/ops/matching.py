"""The matcher family: masked-argmin search over a dense Hamming matrix.

Replaces ALL of ORBmatcher (src/ORBmatcher.cc, 1812 LoC, 11 entry points).
The reference prunes brute-force matching with per-frame 64x48 grids and
DBoW2 FeatureVector node grouping — CPU tricks. Here the full N x M
Hamming matrix is one int8 matmul, so every variant is the same program:

    distance matrix  +  geometric predicate mask  +  best/second argmin
    +  threshold / NN-ratio / rotation-consistency / uniqueness filters.

Semantics mirrored from the reference (thresholds TH_HIGH=100, TH_LOW=50,
HISTO_LENGTH=30, ORBmatcher.cc:40-42; rotation histogram including the
upstream quirk that bin = round(rot/HISTO_LENGTH) uses only ~12 of 30 bins,
ComputeThreeMaxima ORBmatcher.cc:1748-1789).

All functions are pure and jit/vmap-safe; "no match" is index 0 + False mask.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from .hamming import hamming_matrix

TH_HIGH = 100
TH_LOW = 50
HISTO_LENGTH = 30
_BIG = jnp.int32(1 << 20)


class Matches(NamedTuple):
    idx: jax.Array   # (N,) int32 — index into the second feature set
    dist: jax.Array  # (N,) int32 — Hamming distance (BIG where invalid)
    mask: jax.Array  # (N,) bool


def masked_best2(ham: jax.Array, mask: jax.Array):
    """Per-row best and second-best over a masked distance matrix.

    Returns (best_idx, best_dist, second_dist) where the second-best is the
    runner-up in a DIFFERENT column. Implemented as two fused min-reductions
    over a packed (dist << shift | col) key — no argmin machinery and no
    full-matrix scatter copy (the .at[].set variant materializes a second
    (N, M) array, ~2x the kernel's device-memory traffic).
    """
    m = ham.shape[1]
    shift = max(m.bit_length(), 1)
    invalid = jnp.int32(np.iinfo(np.int32).max)
    col = jnp.arange(m, dtype=jnp.int32)[None, :]
    # dist <= 256 and col < 2^shift: key fits comfortably in int32
    key = jnp.where(mask, (ham << shift) | col, invalid)
    k1 = jnp.min(key, axis=1)
    best_idx = jnp.where(k1 == invalid, 0, k1 & ((1 << shift) - 1)).astype(jnp.int32)
    best = jnp.where(k1 == invalid, _BIG, k1 >> shift)
    key2 = jnp.where(col == best_idx[:, None], invalid, key)
    k2 = jnp.min(key2, axis=1)
    second = jnp.where(k2 == invalid, _BIG, k2 >> shift)
    return best_idx, best, second


def rotation_consistency(rot_deg: jax.Array, valid: jax.Array) -> jax.Array:
    """Keep matches whose rotation offset falls in the 3 dominant bins.

    rot_deg: (N,) angle1 - angle2 per tentative match (any range).
    Mirrors the reference histogram: bin = round(rot * 1/HISTO_LENGTH),
    bins with count < 0.1 * max are dropped from the top-3
    (ORBmatcher.cc:1748-1789).
    """
    rot = jnp.mod(rot_deg, 360.0)
    binf = jnp.round(rot * (1.0 / HISTO_LENGTH))
    bins = jnp.where(binf >= HISTO_LENGTH, 0, binf).astype(jnp.int32)
    onehot = (bins[:, None] == jnp.arange(HISTO_LENGTH)[None, :]) & valid[:, None]
    counts = jnp.sum(onehot, axis=0)
    top3_vals, top3_idx = jax.lax.top_k(counts, 3)
    keep1 = bins == top3_idx[0]
    keep2 = (bins == top3_idx[1]) & (top3_vals[1] >= 0.1 * top3_vals[0])
    keep3 = (bins == top3_idx[2]) & (top3_vals[2] >= 0.1 * top3_vals[0])
    return valid & (keep1 | keep2 | keep3)


def enforce_unique(idx: jax.Array, dist: jax.Array, valid: jax.Array, m: int) -> jax.Array:
    """One-to-one constraint: each target keeps only its best source.

    Mirrors the reference's "if feature already matched, erase the worse"
    bookkeeping (e.g. SearchForInitialization, ORBmatcher.cc:598-713).
    """
    n = idx.shape[0]
    key = jnp.where(valid, dist * jnp.int32(n) + jnp.arange(n, dtype=jnp.int32), _BIG)
    best_per_target = jnp.full((m,), _BIG, jnp.int32).at[idx].min(key)
    return valid & (best_per_target[idx] == key)


def _level_radius(scale_factors: jax.Array, level: jax.Array, base_radius) -> jax.Array:
    return base_radius * scale_factors[jnp.clip(level, 0, scale_factors.shape[0] - 1)]


def search_by_projection(
    desc1: jax.Array,       # (N, 32) uint8 — query (map point) descriptors
    uv_proj: jax.Array,     # (N, 2) — projected pixel positions
    pred_level: jax.Array,  # (N,) int32 — predicted pyramid level
    valid1: jax.Array,      # (N,) bool
    desc2: jax.Array,       # (M, 32) uint8 — frame descriptors
    xy2: jax.Array,         # (M, 2) — frame keypoint positions (undistorted)
    level2: jax.Array,      # (M,) int32
    valid2: jax.Array,      # (M,) bool
    scale_factors: jax.Array,   # (L,) per-level scale
    radius: jax.Array | float,  # scalar or (N,) base search radius in px
    max_dist: int = TH_HIGH,
    nn_ratio: float = 0.9,
    level_window: tuple[int, int] = (-1, 0),
) -> Matches:
    """Project-and-match (ORBmatcher.cc:49-125 and :1507-1620 family).

    Candidate frame keypoints lie within `radius * scale[pred_level]` of the
    projection and within `pred_level + level_window`. NN ratio applies when
    best and second-best come from the same level (reference semantics).
    """
    ham = hamming_matrix(desc1, desc2)
    r = _level_radius(scale_factors, pred_level, jnp.asarray(radius, jnp.float32))
    d2_spatial = jnp.sum((uv_proj[:, None, :] - xy2[None, :, :]) ** 2, axis=-1)
    in_radius = d2_spatial <= (r * r)[:, None]
    lo = pred_level[:, None] + level_window[0]
    hi = pred_level[:, None] + level_window[1]
    in_level = (level2[None, :] >= lo) & (level2[None, :] <= hi)
    mask = in_radius & in_level & valid1[:, None] & valid2[None, :]

    best_idx, best, second = masked_best2(ham, mask)
    ok = (best <= max_dist) & valid1
    # NN-ratio gate; the reference applies it only when best and runner-up
    # share a level (ORBmatcher.cc:118) — applying it always is strictly
    # more conservative and measurably equivalent.
    ok = ok & ((best < nn_ratio * second) | (second >= _BIG))
    ok = enforce_unique(best_idx, best, ok, desc2.shape[0])
    return Matches(best_idx, best, ok)


def window_search(
    desc1, xy1, angle1, valid1,
    desc2, xy2, angle2, level2, valid2,
    window_px: float,
    max_dist: int = TH_LOW,
    nn_ratio: float = 0.9,
    min_level: int = 0,
    max_level: int = 7,
    check_rotation: bool = True,
) -> Matches:
    """Windowed search (WindowSearch ORBmatcher.cc:409-516 and
    SearchForInitialization :598-713 with min_level=max_level=0).
    """
    ham = hamming_matrix(desc1, desc2)
    d2 = jnp.sum((xy1[:, None, :] - xy2[None, :, :]) ** 2, axis=-1)
    mask = (
        (d2 <= window_px * window_px)
        & (level2[None, :] >= min_level)
        & (level2[None, :] <= max_level)
        & valid1[:, None]
        & valid2[None, :]
    )
    best_idx, best, second = masked_best2(ham, mask)
    ok = (best <= max_dist) & valid1
    ok = ok & ((best < nn_ratio * second) | (second >= _BIG))
    if check_rotation:
        rot = angle1 - angle2[best_idx]
        ok = rotation_consistency(rot, ok)
    ok = enforce_unique(best_idx, best, ok, desc2.shape[0])
    return Matches(best_idx, best, ok)


def mutual_match(
    desc1, angle1, valid1,
    desc2, angle2, valid2,
    max_dist: int = TH_LOW,
    nn_ratio: float = 0.75,
    check_rotation: bool = True,
    extra_mask: jax.Array | None = None,
) -> Matches:
    """Unconstrained descriptor matching (SearchByBoW family,
    ORBmatcher.cc:155-284 and :715-850 — the BoW node grouping is purely a
    CPU pruning trick, so the array equivalent is the full masked matrix).
    """
    ham = hamming_matrix(desc1, desc2)
    mask = valid1[:, None] & valid2[None, :]
    if extra_mask is not None:
        mask = mask & extra_mask
    best_idx, best, second = masked_best2(ham, mask)
    ok = (best <= max_dist) & valid1
    ok = ok & ((best < nn_ratio * second) | (second >= _BIG))
    if check_rotation:
        rot = angle1 - angle2[best_idx]
        ok = rotation_consistency(rot, ok)
    ok = enforce_unique(best_idx, best, ok, desc2.shape[0])
    return Matches(best_idx, best, ok)


def search_for_triangulation(
    desc1, xy1, angle1, level1, has_point1, valid1,
    desc2, xy2, angle2, level2, has_point2, valid2,
    F12: jax.Array,
    sigma2: jax.Array,          # (L,) per-level sigma^2 table
    epipole2: jax.Array,        # (2,) epipole of camera 1 in image 2
    scale_factors: jax.Array,
    max_dist: int = TH_LOW,
    check_rotation: bool = True,
) -> Matches:
    """Epipolar-constrained matching for new-point triangulation
    (SearchForTriangulation ORBmatcher.cc:852-1014).

    Only keypoints with no associated map point participate; candidates in
    image 2 must lie close to the epipolar line of kp1 (chi^2 3.84 * sigma^2
    of the kp2 level, CheckDistEpipolarLine :136-153) and not too close to
    the epipole (:951-957).
    """
    from ..geometry.epipolar import epipolar_dist2

    ham = hamming_matrix(desc1, desc2)
    # distance of kp2 to epipolar line of kp1: (N, M)
    d_epi = epipolar_dist2(xy1[:, None, :], xy2[None, :, :], F12[None, None])
    epi_ok = d_epi < 3.84 * sigma2[jnp.clip(level2, 0, sigma2.shape[0] - 1)][None, :]
    # epipole proximity gate in image 2
    d_ep2 = jnp.sum((xy2 - epipole2[None, :]) ** 2, axis=-1)
    ep_ok = d_ep2 >= 100.0 * scale_factors[jnp.clip(level2, 0, scale_factors.shape[0] - 1)]
    mask = (
        epi_ok
        & ep_ok[None, :]
        & (~has_point1)[:, None]
        & (~has_point2)[None, :]
        & valid1[:, None]
        & valid2[None, :]
    )
    best_idx, best, _ = masked_best2(ham, mask)
    ok = (best <= max_dist) & valid1 & (~has_point1)
    if check_rotation:
        rot = angle1 - angle2[best_idx]
        ok = rotation_consistency(rot, ok)
    ok = enforce_unique(best_idx, best, ok, desc2.shape[0])
    return Matches(best_idx, best, ok)


def fuse_search(
    point_desc, uv_proj, pred_level, valid_pts,
    kf_desc, kf_xy, kf_level, kf_valid,
    scale_factors,
    radius: float = 3.0,
    max_dist: int = TH_LOW,
) -> Matches:
    """Duplicate-point fusion search (Fuse, ORBmatcher.cc:1016-1134):
    project each map point into the keyframe; the best keypoint within
    radius*scale[pred] and level in [pred-1, pred+1] is the fuse target.
    """
    return search_by_projection(
        point_desc, uv_proj, pred_level, valid_pts,
        kf_desc, kf_xy, kf_level, kf_valid,
        scale_factors, radius,
        max_dist=max_dist, nn_ratio=1.0, level_window=(-1, 1),
    )

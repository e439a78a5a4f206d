"""Full ORB pyramid feature extraction as one jitted array program.

Replaces ORBextractor::operator() (src/ORBextractor.cc:718-779) and
ComputeKeyPoints (:522-707). The reference walks grid cells sequentially,
running cv::FAST per cell with a 20 -> 7 threshold fallback, fills per-cell
quotas with redistribution of unused quota, then retains the best globally.

Array-program redesign:
  * dense FAST score maps per pyramid level (no per-cell loops);
  * the threshold fallback becomes a per-cell select: cells that contain a
    high-threshold corner use the high-threshold map, others fall back to
    the low-threshold map — same semantics, fully parallel;
  * quota redistribution becomes a single global top-k over a priority key
    (rank-within-cell major, score minor): each cell's best corner is taken
    first, then each cell's 2nd best, ... until the level quota is filled.
    This reproduces "fill cells round-robin, redistribute unused quota"
    without any sequential logic;
  * per-level feature quotas follow the reference's geometric series
    (features-per-level ~ 1/scaleFactor^level, src/ORBextractor.cc:476-487).

Output is a fixed-capacity padded feature set (coords at level-0 scale,
pyramid level, IC angle, response, 32-byte descriptor, validity mask).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from . import fast, orb, pyramid

EDGE_THRESHOLD = 19  # reference border margin (ORBextractor.cc EDGE_THRESHOLD)


class Features(NamedTuple):
    """Padded per-frame features. Capacity N = config n_features."""

    xy: jax.Array        # (N, 2) float32 — (x, y) at level-0 scale, raw (distorted)
    level: jax.Array     # (N,) int32 — pyramid level
    angle: jax.Array     # (N,) float32 — IC angle, degrees
    response: jax.Array  # (N,) float32 — FAST/Harris score
    desc: jax.Array      # (N, 32) uint8 — packed rBRIEF
    valid: jax.Array     # (N,) bool


def features_per_level(n_features: int, n_levels: int, scale_factor: float) -> list[int]:
    """Geometric distribution of the feature budget (ORBextractor.cc:476-487)."""
    factor = 1.0 / scale_factor
    n_first = n_features * (1 - factor) / (1 - factor ** n_levels)
    quotas = []
    acc = 0
    for lvl in range(n_levels - 1):
        q = int(round(n_first * factor ** lvl))
        quotas.append(q)
        acc += q
    quotas.append(max(n_features - acc, 0))
    return quotas


def _cell_priority(score: jax.Array, cell: int) -> jax.Array:
    """Priority map implementing per-cell round-robin selection.

    Within each (cell x cell) block, corners are ranked by score; the global
    selection key is  -(rank_in_cell) major, score minor,  so a global top-k
    picks every cell's best first. Returns float32 priority (-inf for
    non-corners).
    """
    h, w = score.shape
    ph = -h % cell
    pw = -w % cell
    s = jnp.pad(score, ((0, ph), (0, pw)))
    hc, wc = s.shape[0] // cell, s.shape[1] // cell
    cells = s.reshape(hc, cell, wc, cell).transpose(0, 2, 1, 3).reshape(hc * wc, cell * cell)
    # rank within cell: position of each element in descending sort.
    order = jnp.argsort(-cells, axis=1)
    ranks = jnp.zeros_like(order).at[
        jnp.arange(cells.shape[0])[:, None], order
    ].set(jnp.arange(cells.shape[1])[None, :].astype(order.dtype))
    prio = -ranks.astype(jnp.float32) * 1024.0 + cells
    prio = jnp.where(cells > 0, prio, -jnp.inf)
    prio = prio.reshape(hc, wc, cell, cell).transpose(0, 2, 1, 3).reshape(s.shape)
    return prio[:h, :w]


def _select_in_cells(score: jax.Array, quota: int, cell: int):
    """Top-`quota` pixel selection by (rank-in-cell, score) priority.

    Fast path: per-cell lax.top_k(R) shrinks the candidate set from H*W to
    n_cells*R before the global top_k — a large win over ranking every pixel
    (the argsort in _cell_priority dominated extraction time). The fast path
    is provably exact whenever the candidate pool can fill the quota (rank
    gaps dominate scores, so the global top-quota can only contain rank >= R
    corners when fewer than `quota` corners of rank < R exist); a lax.cond
    falls back to the exact full ranking in that rare degenerate case.

    Returns (flat_idx, valid) of shape (quota,).
    """
    h, w = score.shape
    ph, pw = -h % cell, -w % cell
    s = jnp.pad(score, ((0, ph), (0, pw)))
    hc, wc = s.shape[0] // cell, s.shape[1] // cell
    cells = s.reshape(hc, cell, wc, cell).transpose(0, 2, 1, 3).reshape(
        hc * wc, cell * cell
    )
    n_cells, cell_sq = cells.shape
    r = int(min(cell_sq, max(16, -(-quota // n_cells))))

    vals, within = jax.lax.top_k(cells, r)  # (C, R)
    rank_key = -1024.0 * jnp.arange(r, dtype=jnp.float32)
    prio = jnp.where(vals > 0, rank_key[None, :] + vals, -jnp.inf)
    cy = (jnp.arange(n_cells, dtype=jnp.int32) // wc)[:, None]
    cx = (jnp.arange(n_cells, dtype=jnp.int32) % wc)[:, None]
    py = cy * cell + within // cell
    px = cx * cell + within % cell
    pix = py * w + px  # flat index in the UNPADDED map (garbage for pad cands)

    n_corners = jnp.sum(score > 0)
    n_cand = jnp.sum(prio > -jnp.inf)
    fast_ok = n_cand >= jnp.minimum(quota, n_corners)

    def fast_path(_):
        v, i = jax.lax.top_k(prio.reshape(-1), quota)
        return jnp.take(pix.reshape(-1), i), v > -jnp.inf

    def slow_path(_):
        p = _cell_priority(score, cell).reshape(-1)
        v, i = jax.lax.top_k(p, quota)
        return i.astype(jnp.int32), v > -jnp.inf

    idx, valid = jax.lax.cond(fast_ok, fast_path, slow_path, None)
    return jnp.clip(idx, 0, h * w - 1), valid


def _select_level(
    img: jax.Array,
    quota: int,
    fast_th: float,
    fast_min_th: float,
    cell: int,
    use_harris_score: bool,
):
    """One pyramid level's keypoint selection -> (xy, response, valid).

    One FAST pass: the corner score is threshold-independent (the maximal
    threshold at which the pixel stays a corner), so the high-threshold map
    is just a mask of the low-threshold map — and nonmax suppression commutes
    with that mask because suppression needs a strictly greater neighbor and
    hi-corner scores always exceed lo-only scores.
    """
    h, w = img.shape
    lo = fast.detect(img, fast_min_th, border=EDGE_THRESHOLD)
    hi = jnp.where(lo + 1.0 > fast_th, lo, 0.0)

    # Per-cell threshold fallback: use `lo` only in cells with no `hi` corner.
    ph, pw = -h % cell, -w % cell
    hi_p = jnp.pad(hi, ((0, ph), (0, pw)))
    cell_max = hi_p.reshape((h + ph) // cell, cell, (w + pw) // cell, cell).max(axis=(1, 3))
    has_hi = jnp.repeat(jnp.repeat(cell_max > 0, cell, axis=0), cell, axis=1)[:h, :w]
    score = jnp.where(has_hi, hi, lo)

    if use_harris_score:
        # Reference HARRIS_SCORE mode re-scores FAST corners with the Harris
        # response before retaining the best (ORBextractor.cc:678-701).
        resp_map = fast.harris_score_map(img)
    else:
        resp_map = score

    idx, valid = _select_in_cells(score, quota, cell)
    ys = (idx // w).astype(jnp.int32)
    xs = (idx % w).astype(jnp.int32)
    xy = jnp.stack([xs, ys], axis=-1).astype(jnp.float32)
    response = jnp.take(resp_map.reshape(-1), idx)
    return xy, response, valid


@functools.partial(
    jax.jit,
    static_argnames=(
        "n_features", "n_levels", "scale_factor", "fast_th", "fast_min_th",
        "cell", "use_harris_score",
    ),
)
def extract(
    image: jax.Array,
    n_features: int = 1000,
    n_levels: int = 8,
    scale_factor: float = 1.2,
    fast_th: float = 20.0,
    fast_min_th: float = 7.0,
    cell: int = 32,
    use_harris_score: bool = False,
) -> Features:
    """Extract ORB features from a grayscale float32 (H, W) image in [0, 255].

    One jitted program spanning all pyramid levels (statically unrolled —
    each level has a different static shape).
    """
    levels = pyramid.build_pyramid(image, n_levels, scale_factor)
    quotas = features_per_level(n_features, n_levels, scale_factor)
    xys, lvls, resps, valids, p31, p37 = [], [], [], [], [], []
    for lvl, (img, quota) in enumerate(zip(levels, quotas)):
        if quota == 0:
            continue
        xy, response, valid = _select_level(
            img, quota, fast_th, fast_min_th, cell, use_harris_score
        )
        # Round the blur to integer intensities: reproduces cv2's uint8 blur
        # bit-exactly, which makes descriptors identical to cv2.ORB's.
        blurred = jnp.round(orb.gaussian_blur_7x7_sigma2(img))
        # Patch gathers stay per-level (per-level image shapes), but the
        # moment/rotation/sampling math below batches ALL levels' keypoints
        # through one program — 8x fewer instances of the expensive ops.
        # One gather serves both: orientation reads the 31x31 center of the
        # unblurred channel, the descriptor reads the 37x37 blurred channel.
        both = orb.gather_patches_multi(
            jnp.stack([img, blurred]), xy, orb.PATCH_RADIUS
        )  # (N, 2, 37, 37)
        crop = orb.PATCH_RADIUS - orb.HALF_PATCH_SIZE
        p31.append(both[:, 0, crop:-crop, crop:-crop])
        p37.append(both[:, 1])
        xys.append(xy * jnp.float32(scale_factor ** lvl))
        lvls.append(jnp.full((quota,), lvl, jnp.int32))
        resps.append(response)
        valids.append(valid)

    angle = orb.ic_angle_from_patches(jnp.concatenate(p31, axis=0))
    desc = orb.descriptors_from_patches(jnp.concatenate(p37, axis=0), angle)
    return Features(
        xy=jnp.concatenate(xys, axis=0),
        level=jnp.concatenate(lvls, axis=0),
        angle=angle,
        response=jnp.concatenate(resps, axis=0),
        desc=desc,
        valid=jnp.concatenate(valids, axis=0),
    )

"""FAST-9/16 corner detection as dense map ops.

Array-program replacement for the per-cell cv::FAST calls in
ORBextractor::ComputeKeyPoints (src/ORBextractor.cc:607-614). Instead of
per-pixel early-exit C++ loops, the segment test and the corner score are
computed for EVERY pixel at once with 16 statically-shifted copies of the
image — element-wise work with no data-dependent control flow, which XLA
fuses into a few loop kernels.

Semantics match OpenCV FAST_9_16 with nonmax suppression:
  * a pixel is a corner if >= 9 contiguous circle pixels are all brighter
    than center + t or all darker than center - t;
  * its score is the largest t for which it remains a corner (computed in
    closed form as a max-over-arcs of min-over-arc differences);
  * 3x3 non-maximum suppression on the score map.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

# Bresenham circle of radius 3, in circular order, as (dy, dx).
CIRCLE_OFFSETS = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)


def _circle_stack(img: jax.Array) -> jax.Array:
    """(H, W) -> (16, H, W): image sampled at each circle offset.

    Zero-padding at the border is harmless: border pixels are masked out by
    the caller anyway (descriptor patches need a margin far larger than 3).
    """
    padded = jnp.pad(img, 3)
    h, w = img.shape
    return jnp.stack(
        [padded[3 + dy : 3 + dy + h, 3 + dx : 3 + dx + w] for dy, dx in CIRCLE_OFFSETS]
    )


def fast_score_map(img: jax.Array, threshold: float) -> jax.Array:
    """Dense FAST-9/16 score map; 0 where the segment test fails.

    Returns float32 (H, W). Score is the OpenCV cornerScore: the maximal
    threshold at which the pixel is still a corner, minus 1.
    """
    circle = _circle_stack(img)  # (16, H, W)
    d = circle - img[None]  # signed differences

    # For each of the 16 starting positions, the min over the 9-arc of d
    # (bright case) and of -d (dark case).
    def arc_min(x):
        # x: (16, H, W) -> (16, H, W) of min over arcs starting at each index.
        mins = x
        for j in range(1, 9):
            mins = jnp.minimum(mins, jnp.roll(x, -j, axis=0))
        return mins

    bright_arc = arc_min(d)    # arc fully brighter: all d > t  -> min(d) > t
    dark_arc = arc_min(-d)     # arc fully darker:  all -d > t -> min(-d) > t
    a = jnp.max(bright_arc, axis=0)
    b = jnp.max(dark_arc, axis=0)
    score = jnp.maximum(a, b) - 1.0
    is_corner = jnp.maximum(a, b) > threshold
    return jnp.where(is_corner, score, 0.0)


def nonmax_3x3(score: jax.Array) -> jax.Array:
    """Keep only strict local maxima (score > all 8 neighbors), cv2-style.

    OpenCV's FAST nonmax drops tied maxima on both sides; matching that
    exactly makes corner sets bit-identical to the cv2 oracle.
    """
    h, w = score.shape
    padded = jnp.pad(score, 1, constant_values=-jnp.inf)
    neigh = [
        padded[1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]
        for dy in (-1, 0, 1)
        for dx in (-1, 0, 1)
        if (dy, dx) != (0, 0)
    ]
    neigh_max = neigh[0]
    for n in neigh[1:]:
        neigh_max = jnp.maximum(neigh_max, n)
    return jnp.where((score > neigh_max) & (score > 0), score, 0.0)


def detect(img: jax.Array, threshold: float, border: int = 0) -> jax.Array:
    """FAST corners with nonmax suppression and border masking.

    Returns the suppressed score map (H, W); nonzero entries are keypoints.
    """
    score = nonmax_3x3(fast_score_map(img, threshold))
    if border > 0:
        h, w = img.shape
        ys = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
        xs = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
        inside = (
            (ys >= border) & (ys < h - border) & (xs >= border) & (xs < w - border)
        )
        score = jnp.where(inside, score, 0.0)
    return score


def harris_score_map(img: jax.Array, block_size: int = 7, k: float = 0.04) -> jax.Array:
    """Dense Harris response (HarrisResponses, src/ORBextractor.cc:79-120).

    Sobel-like derivative (the reference uses central differences scaled by
    1/(4*blockSize*255)) and a blockSize x blockSize unnormalized box sum.
    Used when the extractor is configured with the Harris score type.
    """
    padded = jnp.pad(img, 1, mode="edge")
    h, w = img.shape
    Ix = (padded[1 : 1 + h, 2 : 2 + w] - padded[1 : 1 + h, 0:w]) * 0.5
    Iy = (padded[2 : 2 + h, 1 : 1 + w] - padded[0:h, 1 : 1 + w]) * 0.5
    box = (block_size, block_size)
    sum_ = lambda x: jax.lax.reduce_window(x, 0.0, jax.lax.add, box, (1, 1), "SAME")
    a = sum_(Ix * Ix)
    b = sum_(Iy * Iy)
    c = sum_(Ix * Iy)
    scale = 1.0 / (4 * block_size * 255.0)
    s2 = scale * scale
    a, b, c = a * s2, b * s2, c * s2
    return a * b - c * c - k * (a + b) * (a + b)

"""FAST-9/16 `detect` (score + strict 3x3 nonmax) vs cv2.FastFeatureDetector,
corner for corner and score for score, on noise and on a smooth ramp."""
import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from orbslam_jpminipc.ops import fast

detect_j = jax.jit(fast.detect, static_argnames=("threshold", "border"))

# cv2 scores rows/cols [3, n-3) only and treats the rest as non-corners,
# while `detect` scores every pixel over a zero pad; from 4 px in, every
# nonmax neighbourhood is scored alike by both
INNER = 4


def cv2_corners(img, threshold):
    det = cv2.FastFeatureDetector_create(
        threshold=int(threshold), nonmaxSuppression=True,
        type=cv2.FastFeatureDetector_TYPE_9_16)
    return {(int(k.pt[1]), int(k.pt[0])): k.response for k in det.detect(img)}


def inner(corners, shape):
    h, w = shape
    return {p: s for p, s in corners.items()
            if INNER <= p[0] < h - INNER and INNER <= p[1] < w - INNER}


@pytest.mark.parametrize("shape", [(97, 140), (64, 128), (130, 257)])
@pytest.mark.parametrize("threshold", [7.0, 20.0])
def test_detect_matches_cv2(rng, shape, threshold):
    img = rng.integers(0, 255, shape).astype(np.uint8)
    score = np.asarray(detect_j(jnp.asarray(img, jnp.float32), threshold=threshold))
    ours = {(int(y), int(x)): float(score[y, x]) for y, x in zip(*np.nonzero(score))}
    ref = inner(cv2_corners(img, threshold), shape)
    ours = inner(ours, shape)
    assert len(ref) > 50
    assert ours.keys() == ref.keys()
    assert all(ours[p] == ref[p] for p in ref)


def test_smooth_image_has_no_corners():
    ys = np.arange(80, dtype=np.float32)[:, None]
    img = np.tile(ys, (1, 130))  # vertical ramp
    score = np.asarray(detect_j(jnp.asarray(img), threshold=7.0))
    assert not cv2_corners(img.astype(np.uint8), 7.0)
    # the zero pad makes corners along the border only, which the
    # extractor's border mask removes
    assert (score[5:-5, 5:-5] == 0).all()

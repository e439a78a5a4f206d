"""The numpy synthetic renderer against OpenCV, the oracle it replaces."""
import cv2
import numpy as np
import pytest

from orbslam_jpminipc.io import dataset


def test_cubic_resize_matches_cv2(rng):
    small = rng.normal(0, 1, (32, 32)).astype(np.float32)
    ref = cv2.resize(small, (1024, 1024), interpolation=cv2.INTER_CUBIC)
    np.testing.assert_allclose(dataset._resize_cubic(small, 1024), ref, atol=1e-4)


def test_gaussian_blur_is_bit_exact(rng):
    tex = rng.integers(0, 256, (150, 211)).astype(np.uint8)
    np.testing.assert_array_equal(dataset._gaussian_blur_3x3(tex),
                                  cv2.GaussianBlur(tex, (3, 3), 0.7))


def test_perspective_transform_matches_cv2():
    src = np.array([[0, 0], [99, 0], [99, 79], [0, 79]], np.float32)
    dst = np.array([[120.3, 40.7], [330.2, 90.1], [300.9, 310.4], [90.1, 270.3]], np.float32)
    np.testing.assert_allclose(dataset._perspective_transform(src, dst),
                               cv2.getPerspectiveTransform(src, dst), rtol=1e-6, atol=1e-9)


def test_transparent_warp_matches_cv2(rng):
    tex = rng.integers(0, 256, (103, 97)).astype(np.uint8)
    src = np.array([[0, 0], [96, 0], [96, 102], [0, 102]], np.float32)
    dst = np.array([[100.3, 50.7], [300.2, 80.1], [280.9, 300.4], [90.1, 260.3]], np.float32)
    H = cv2.getPerspectiveTransform(src, dst)
    base = rng.integers(0, 256, (480, 640)).astype(np.uint8)
    ref = cv2.warpPerspective(tex, H, (640, 480), dst=base.copy(),
                              borderMode=cv2.BORDER_TRANSPARENT)
    got = base.copy()
    dataset._warp_transparent(tex, H, got)
    d = np.abs(got.astype(int) - ref.astype(int))
    assert (d <= 1).mean() >= 0.99 and d.max() <= 2, (d.max(), (d <= 1).mean())
    # untouched outside the footprint, exactly as cv2 leaves it
    assert (got[ref == base] == base[ref == base]).mean() >= 0.99


@pytest.mark.parametrize("trajectory", ["xyz", "orbit"])
def test_rendered_frame_within_1dn_of_cv2(trajectory):
    seq = dataset.SyntheticSequence(n_frames=300, trajectory=trajectory, seed=0)
    for i in (0, 150):
        R, t = seq.poses[i]
        ref = np.zeros((seq.height, seq.width), np.uint8)
        for corners, tex in seq.quads:
            H = seq._plane_homography(R, t, corners, tex.shape)
            if H is not None:
                ref = cv2.warpPerspective(tex, H, (seq.width, seq.height), dst=ref,
                                          borderMode=cv2.BORDER_TRANSPARENT)
        d = np.abs(seq.render(i).astype(int) - ref.astype(int))
        assert (d <= 1).mean() >= 0.99, (i, (d <= 1).mean())

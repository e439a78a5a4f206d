"""Feature front-end tests vs cv2 oracles (FAST corners, ORB angle/descriptor)."""
import numpy as np
import cv2
import jax
import jax.numpy as jnp
import pytest

from orbslam_jpminipc.ops import fast, orb, extractor, hamming


def synthetic_image(rng, h=240, w=320):
    """Textured synthetic image with corners: random blobs + rectangles."""
    img = np.zeros((h, w), np.float32)
    for _ in range(60):
        y, x = rng.integers(20, h - 20), rng.integers(20, w - 20)
        sy, sx = rng.integers(4, 24, size=2)
        img[y : y + sy, x : x + sx] += rng.uniform(30, 120)
    img += rng.normal(0, 2.0, size=(h, w))
    return np.clip(img, 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def img():
    return synthetic_image(np.random.default_rng(42))


detect_j = jax.jit(fast.detect, static_argnames=("threshold", "border"))


class TestFAST:
    def test_corners_match_cv2(self, img):
        th = 20
        det = cv2.FastFeatureDetector_create(
            threshold=th, nonmaxSuppression=True, type=cv2.FastFeatureDetector_TYPE_9_16
        )
        kps = det.detect(img)
        ref = {(int(k.pt[0]), int(k.pt[1])) for k in kps}
        score = np.asarray(detect_j(jnp.array(img, jnp.float32), threshold=float(th)))
        ys, xs = np.nonzero(score)
        ours = {(int(x), int(y)) for x, y in zip(xs, ys)}
        # cv2 detects in the interior only (3px border); ours masks border=0 here.
        h, w = img.shape
        ours = {(x, y) for x, y in ours if 3 <= x < w - 3 and 3 <= y < h - 3}
        # Symmetric difference should be tiny (ties at equal scores can
        # resolve differently in nonmax suppression).
        inter = len(ref & ours)
        assert inter >= 0.95 * max(len(ref), 1), (len(ref), len(ours), inter)
        assert len(ours - ref) <= 0.05 * max(len(ours), 1) + 2

    def test_scores_match_cv2(self, img):
        th = 20
        det = cv2.FastFeatureDetector_create(threshold=th, nonmaxSuppression=True)
        kps = det.detect(img)
        score = np.asarray(detect_j(jnp.array(img, jnp.float32), threshold=float(th)))
        matched = 0
        for k in kps:
            x, y = int(k.pt[0]), int(k.pt[1])
            if score[y, x] > 0:
                assert abs(score[y, x] - k.response) <= 1.0, (k.pt, score[y, x], k.response)
                matched += 1
        assert matched >= 0.9 * len(kps)


class TestORB:
    def test_angle_and_descriptor_vs_cv2(self, img):
        # cv2.ORB detectAndCompute is the oracle (compute() alone does NOT
        # fill angles). Compare our IC angle at cv2's keypoint positions, and
        # our descriptor evaluated at cv2's own angle, against cv2's output.
        orb_cv = cv2.ORB_create(
            nfeatures=2000, scaleFactor=1.2, nlevels=1, edgeThreshold=19,
            firstLevel=0, WTA_K=2, patchSize=31, fastThreshold=20,
        )
        kps_cv, desc_cv = orb_cv.detectAndCompute(img, None)
        h, w = img.shape
        sel = [
            i for i, k in enumerate(kps_cv)
            if 25 <= k.pt[0] < w - 25 and 25 <= k.pt[1] < h - 25
        ]
        assert len(sel) > 30
        xys = np.array([kps_cv[i].pt for i in sel], np.float32)
        ang_cv = np.array([kps_cv[i].angle for i in sel], np.float32)
        desc_cv = desc_cv[sel]

        imgf = jnp.array(img, jnp.float32)
        ang = np.asarray(jax.jit(orb.ic_angle)(imgf, jnp.array(xys)))
        dang = np.abs(((ang - ang_cv) + 180) % 360 - 180)
        # cv2 uses fastAtan2 (~0.3 deg accuracy)
        assert np.median(dang) < 0.5, np.median(dang)
        assert np.mean(dang < 2.0) > 0.95, np.mean(dang < 2.0)

        blurred = jnp.round(jax.jit(orb.gaussian_blur_7x7_sigma2)(imgf))
        desc = np.asarray(
            jax.jit(orb.descriptors)(blurred, jnp.array(xys), jnp.array(ang_cv))
        )
        ham = np.asarray(
            jax.jit(hamming.hamming_pairwise)(jnp.array(desc), jnp.array(desc_cv))
        )
        # With the integer-rounded blur, descriptors are bit-exact vs cv2
        # when evaluated at cv2's angle.
        assert ham.max() == 0, (np.median(ham), ham.mean(), ham.max())


class TestExtractor:
    def test_full_extraction(self, img):
        feats = extractor.extract(
            jnp.array(img, jnp.float32), n_features=500, n_levels=4
        )
        valid = np.asarray(feats.valid)
        assert valid.sum() > 100
        xy = np.asarray(feats.xy)[valid]
        h, w = img.shape
        assert (xy[:, 0] >= 0).all() and (xy[:, 0] < w).all()
        assert (xy[:, 1] >= 0).all() and (xy[:, 1] < h).all()
        # features on several levels
        assert len(np.unique(np.asarray(feats.level)[valid])) >= 2
        # descriptors nonzero for valid
        assert np.asarray(feats.desc)[valid].any(axis=1).mean() > 0.9

    def test_quota_distribution(self):
        q = extractor.features_per_level(1000, 8, 1.2)
        assert sum(q) == 1000
        assert q[0] > q[1] > q[3]

    def test_spatial_uniformity(self, img):
        # round-robin cell selection should spread features across the image
        feats = extractor.extract(
            jnp.array(img, jnp.float32), n_features=300, n_levels=1
        )
        valid = np.asarray(feats.valid)
        xy = np.asarray(feats.xy)[valid]
        h, w = img.shape
        occupied = set()
        for x, y in xy:
            occupied.add((int(y) // 60, int(x) // 80))
        assert len(occupied) >= 8  # at least 8 of the 4x4 super-cells


class TestHamming:
    def test_matrix_vs_pairwise(self, rng):
        d1 = rng.integers(0, 256, size=(64, 32)).astype(np.uint8)
        d2 = rng.integers(0, 256, size=(80, 32)).astype(np.uint8)
        H = np.asarray(jax.jit(hamming.hamming_matrix)(jnp.array(d1), jnp.array(d2)))
        for i in (0, 13, 63):
            for j in (0, 41, 79):
                ref = bin(int.from_bytes(bytes((d1[i] ^ d2[j]).tolist()), "big")).count("1")
                assert H[i, j] == ref

    def test_pairwise_multidim_vs_oracle(self, rng):
        # the tree-vocabulary descent calls hamming_pairwise on (N, k, 32)
        # batches — the shape class an old 256-entry LUT gather handled
        # badly; assert the lax.population_count path is exact
        d1 = rng.integers(0, 256, size=(17, 5, 32)).astype(np.uint8)
        d2 = rng.integers(0, 256, size=(17, 5, 32)).astype(np.uint8)
        got = np.asarray(jax.jit(hamming.hamming_pairwise)(jnp.array(d1), jnp.array(d2)))
        ref = np.unpackbits(d1 ^ d2, axis=-1).sum(-1)
        np.testing.assert_array_equal(got, ref)
        pc = np.asarray(jax.jit(hamming.popcount_rows)(jnp.array(d1[:, 0])))
        np.testing.assert_array_equal(pc, np.unpackbits(d1[:, 0], axis=-1).sum(-1))

    def test_unpack_roundtrip(self, rng):
        d = rng.integers(0, 256, size=(16, 32)).astype(np.uint8)
        bits = np.asarray(jax.jit(hamming.unpack_bits)(jnp.array(d)))
        repack = (bits.reshape(16, 32, 8) * (1 << np.arange(8))).sum(-1).astype(np.uint8)
        np.testing.assert_array_equal(repack, d)

"""Dataset readers + distortion path: TUM-format directories and the
k1/k2 != 0 end-to-end branch (undistortion is always-on in the reference,
src/Frame.cc:289-319, but synthetic runs default to zero distortion — this
exercises the real-data configuration)."""
import os

import numpy as np
import cv2
import pytest

from orbslam_jpminipc.config import SlamConfig
from orbslam_jpminipc.io.dataset import SyntheticSequence, TumDataset
from orbslam_jpminipc.io.trajectory import ate_rmse
from orbslam_jpminipc.pipeline.system import Slam


class TestTumDataset:
    def test_reads_tum_directory(self, tmp_path):
        """Build a TUM-format directory from synthetic renders and read it
        back (rgb.txt index + rgb/*.png, the standard layout)."""
        seq = SyntheticSequence(n_frames=6, trajectory="xyz", seed=1)
        rgbdir = tmp_path / "rgb"
        rgbdir.mkdir()
        lines = ["# color images", "# file: 'synthetic'", "# timestamp filename"]
        for i in range(6):
            img, ts, _ = seq.get(i)
            name = f"rgb/{ts:.6f}.png"
            cv2.imwrite(str(tmp_path / name), img)
            lines.append(f"{ts:.6f} {name}")
        (tmp_path / "rgb.txt").write_text("\n".join(lines) + "\n")

        ds = TumDataset(str(tmp_path))
        assert len(ds) == 6
        img0, ts0, _ = ds.get(0)
        assert ts0 == pytest.approx(0.0)
        ref, _, _ = seq.get(0)
        assert img0.shape == ref.shape
        np.testing.assert_array_equal(img0, ref)
        img5, ts5, _ = ds.get(5)
        assert ts5 == pytest.approx(5 / 30.0, abs=1e-5)

    def test_skips_comments_and_blanks(self, tmp_path):
        (tmp_path / "rgb.txt").write_text(
            "# header\n\n1.5 rgb/a.png\n# mid comment\n2.5 rgb/b.png\n")
        ds = TumDataset(str(tmp_path))
        assert len(ds) == 2
        assert ds.entries[0] == (1.5, "rgb/a.png")


def _distort_image(img, K4, dist):
    """Synthesize a lens-distorted image from a pinhole render: for every
    distorted-output pixel, sample the pinhole image at its undistorted
    position (the exact inverse of cv::undistortPoints)."""
    fx, fy, cx, cy = K4
    k1, k2, p1, p2 = dist
    h, w = img.shape
    u, v = np.meshgrid(np.arange(w, dtype=np.float32),
                       np.arange(h, dtype=np.float32))
    # iterative undistort of the output grid (same scheme as
    # geometry.camera.undistort_points)
    xd = (u - cx) / fx
    yd = (v - cy) / fy
    x, y = xd.copy(), yd.copy()
    for _ in range(8):
        r2 = x * x + y * y
        icdist = 1.0 / (1.0 + k1 * r2 + k2 * r2 * r2)
        dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        dy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        x = (xd - dx) * icdist
        y = (yd - dy) * icdist
    mapx = (x * fx + cx).astype(np.float32)
    mapy = (y * fy + cy).astype(np.float32)
    return cv2.remap(img, mapx, mapy, cv2.INTER_LINEAR)


class TestDistortionEndToEnd:
    def test_tracks_with_radial_distortion(self, vocab_small):
        """e2e with nonzero k1/k2: images carry synthetic lens distortion
        matching the configured model; the per-frame undistortion branch
        (keypoints + image bounds) must recover a usable trajectory."""
        K4 = (500.0, 500.0, 320.0, 240.0)
        dist = (-0.26, 0.08, 0.0, 0.0)  # fr1-like radial distortion
        cfg = SlamConfig(
            pipelined_tracking=False,
            fx=K4[0], fy=K4[1], cx=K4[2], cy=K4[3],
            k1=dist[0], k2=dist[1], p1=0.0, p2=0.0,
            n_features=600, max_kf=64, max_mp=8192, local_ba_obs=8192,
        )
        # TUM-like motion speed (the synthetic trajectories are phase-
        # parameterized: more frames = slower); distorted resampling blurs
        # the texture, so pathological-speed tracking is out of scope here
        n = 60
        seq = SyntheticSequence(n_frames=90, trajectory="xyz", seed=3)
        slam = Slam(cfg, vocab=vocab_small, enable_loop_closing=False)
        working = 0
        for i in range(n):
            img, ts, _ = seq.get(i)
            state, _ = slam.process(_distort_image(img, K4, dist), ts)
            working += state.name == "WORKING"
        assert working > 35, working
        assert slam.n_points > 150
        gt = {round(float(seq.timestamps[i]), 6): seq.poses[i]
              for i in range(n)}
        est, gtc = [], []
        for ts, R, t in slam.trajectory:
            if round(ts, 6) in gt:
                Rg, tg = gt[round(ts, 6)]
                est.append(-R.T @ t)
                gtc.append(-Rg.T @ tg)
        assert len(est) > 40
        ate = ate_rmse(np.stack(est), np.stack(gtc))
        # distorted pixels resample the texture (interpolation blur), so the
        # bound is looser than the pristine-pinhole 3 cm gate
        assert ate < 0.08, ate


@pytest.fixture(scope="module")
def vocab_small():
    from orbslam_jpminipc.vocab.vocabulary import build_vocabulary

    rng = np.random.default_rng(0)
    return build_vocabulary(
        rng.integers(0, 256, (20000, 32)).astype(np.uint8), n_words=1024,
        iters=3)

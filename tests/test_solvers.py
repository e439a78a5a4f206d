"""Solver tests: two-view initialization and pose-only optimization."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
from scipy.spatial.transform import Rotation

from orbslam_jpminipc.geometry import se3, camera
from orbslam_jpminipc.solvers import initializer, pose_opt

K4 = jnp.array([500.0, 500.0, 320.0, 240.0], jnp.float32)


def make_scene(rng, n=300, planar=False):
    """Synthetic two-view scene. Returns (uv1, uv2, R21, t21, xw)."""
    if planar:
        xw = np.stack(
            [rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), np.full(n, 5.0)],
            axis=1,
        ).astype(np.float32)
    else:
        xw = np.stack(
            [rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), rng.uniform(3, 8, n)],
            axis=1,
        ).astype(np.float32)
    R1, t1 = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    R2 = Rotation.from_rotvec([0.02, 0.12, 0.01]).as_matrix().astype(np.float32)
    t2 = np.array([-0.4, 0.03, 0.05], np.float32)
    uv1 = np.asarray(camera.project(se3.transform(jnp.array(R1), jnp.array(t1), jnp.array(xw)), K4))
    uv2 = np.asarray(camera.project(se3.transform(jnp.array(R2), jnp.array(t2), jnp.array(xw)), K4))
    return uv1, uv2, R2, t2, xw


init_j = jax.jit(
    initializer.initialize,
    static_argnames=("n_hyp", "min_triangulated"),
)


class TestInitializer:
    def _run(self, rng, planar, noise=0.3, outliers=20):
        uv1, uv2, R21, t21, xw = make_scene(rng, planar=planar)
        n = len(uv1)
        uv1 = uv1 + rng.normal(0, noise, uv1.shape).astype(np.float32)
        uv2 = uv2 + rng.normal(0, noise, uv2.shape).astype(np.float32)
        # corrupt some matches
        uv2[:outliers] = rng.uniform(0, 640, size=(outliers, 2)).astype(np.float32)
        mask = np.ones(n, bool)
        res = init_j(
            jax.random.key(0), jnp.array(uv1), jnp.array(uv2), jnp.array(mask), K4
        )
        return res, R21, t21

    def test_general_scene_uses_f(self, rng):
        res, R21, t21 = self._run(rng, planar=False)
        assert bool(res.success)
        assert not bool(res.used_h)
        R_err = np.degrees(
            np.linalg.norm(np.asarray(se3.log_so3(jnp.array(R21) @ res.R.T)))
        )
        assert R_err < 0.5, R_err
        t_dir = np.asarray(res.t) / np.linalg.norm(np.asarray(res.t))
        t_ref = t21 / np.linalg.norm(t21)
        assert np.dot(t_dir, t_ref) > 0.999
        assert int(res.n_good) > 200

    def test_planar_scene_uses_h(self, rng):
        res, R21, t21 = self._run(rng, planar=True)
        assert bool(res.success)
        assert bool(res.used_h)
        R_err = np.degrees(
            np.linalg.norm(np.asarray(se3.log_so3(jnp.array(R21) @ res.R.T)))
        )
        assert R_err < 1.0, R_err
        t_dir = np.asarray(res.t) / np.linalg.norm(np.asarray(res.t))
        t_ref = t21 / np.linalg.norm(t21)
        assert abs(np.dot(t_dir, t_ref)) > 0.99

    def test_degenerate_no_translation(self, rng):
        # pure rotation -> no parallax -> must NOT report success
        xw = np.stack(
            [rng.uniform(-2, 2, 200), rng.uniform(-1.5, 1.5, 200), rng.uniform(3, 8, 200)],
            axis=1,
        ).astype(np.float32)
        R2 = Rotation.from_rotvec([0, 0.05, 0]).as_matrix().astype(np.float32)
        uv1 = np.asarray(camera.project(jnp.array(xw), K4))
        uv2 = np.asarray(camera.project(se3.transform(jnp.array(R2), jnp.zeros(3), jnp.array(xw)), K4))
        res = init_j(
            jax.random.key(1), jnp.array(uv1), jnp.array(uv2),
            jnp.ones(200, bool), K4,
        )
        assert not bool(res.success)

    def test_triangulated_points_match_truth(self, rng):
        res, R21, t21 = self._run(rng, planar=False, noise=0.0, outliers=0)
        # points are in frame-1 coords up to scale; compare normalized depth
        uv1, uv2, _, _, xw = make_scene(np.random.default_rng(0), planar=False)
        good = np.asarray(res.good)
        pts = np.asarray(res.points)[good]
        ref = xw[good]
        scale = np.median(pts[:, 2]) / np.median(ref[:, 2])
        np.testing.assert_allclose(pts / scale, ref, atol=0.2)


class TestPoseOpt:
    def test_converges_from_perturbed_pose(self, rng):
        n = 200
        xw = np.stack(
            [rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), rng.uniform(3, 8, n)],
            axis=1,
        ).astype(np.float32)
        R_gt = Rotation.from_rotvec([0.03, -0.1, 0.02]).as_matrix().astype(np.float32)
        t_gt = np.array([0.2, -0.1, 0.4], np.float32)
        uv = np.asarray(camera.project(se3.transform(jnp.array(R_gt), jnp.array(t_gt), jnp.array(xw)), K4))
        uv = uv + rng.normal(0, 0.5, uv.shape).astype(np.float32)
        # 15% gross outliers
        uv[: n // 7] = rng.uniform(0, 640, size=(n // 7, 2)).astype(np.float32)
        # perturb initial pose
        dxi = jnp.array(rng.normal(0, 0.03, 6).astype(np.float32))
        dR, dt = se3.exp_se3(dxi)
        R0, t0 = se3.compose(dR, dt, jnp.array(R_gt), jnp.array(t_gt))
        res = pose_opt.optimize_pose(
            R0, t0, jnp.array(xw), jnp.array(uv),
            jnp.ones(n, jnp.float32), jnp.ones(n, bool), K4,
        )
        R_err = np.degrees(np.linalg.norm(np.asarray(se3.log_so3(jnp.array(R_gt) @ res.R.T))))
        t_err = np.linalg.norm(np.asarray(res.t) - t_gt)
        assert R_err < 0.1, R_err
        assert t_err < 0.02, t_err
        inl = np.asarray(res.inliers)
        assert inl[n // 7 :].mean() > 0.97          # inliers kept
        assert inl[: n // 7].mean() < 0.1           # outliers gated out

    def test_all_outliers_reports_few_inliers(self, rng):
        n = 64
        xw = rng.uniform(-2, 2, size=(n, 3)).astype(np.float32) + [0, 0, 5]
        uv = rng.uniform(0, 640, size=(n, 2)).astype(np.float32)
        res = pose_opt.optimize_pose(
            jnp.eye(3), jnp.zeros(3), jnp.array(xw), jnp.array(uv),
            jnp.ones(n, jnp.float32), jnp.ones(n, bool), K4,
        )
        assert int(res.n_inliers) < n // 4

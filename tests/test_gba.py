"""Scalable global bundle adjustment (implicit-Schur PCG) tests.

The dense solver (solvers/ba.py) is the exact oracle: on the same problem
the PCG solver must reach the same optimum. A capacity-shaped problem
verifies the solver runs without the O(P*K) coupling the dense path
materializes (Optimizer.cc:38-152 semantics at full map size).
"""
import numpy as np
import jax.numpy as jnp

from orbslam_jpminipc.geometry import se3
from orbslam_jpminipc.solvers import ba, gba

from test_ba import make_ba_problem, K4


class TestGBAEquivalence:
    def test_matches_dense_solver(self, rng):
        prob, Rs, ts, xw = make_ba_problem(rng)
        dense = ba.bundle_adjust(prob, iterations=10)
        pcg = gba.bundle_adjust_large(prob, iterations=10, cg_iters=48)
        # both reach the noise floor
        O = prob.obs_uv.shape[0]
        assert float(pcg.chi2) < 2.5 * O * 0.3 ** 2, float(pcg.chi2)
        assert float(pcg.chi2) < 1.1 * float(dense.chi2) + 1.0
        # recovered geometry agrees with ground truth like the dense path
        for k in range(1, 6):
            R_err = np.degrees(np.linalg.norm(np.asarray(
                se3.log_so3(jnp.array(Rs[k]) @ pcg.kf_R[k].T))))
            assert R_err < 0.1, (k, R_err)
            assert np.linalg.norm(np.asarray(pcg.kf_t[k]) - ts[k]) < 0.01
        err = np.linalg.norm(np.asarray(pcg.points) - xw, axis=1)
        assert np.median(err) < 0.03

    def test_fixed_camera_untouched(self, rng):
        prob, *_ = make_ba_problem(rng)
        res = gba.bundle_adjust_large(prob, iterations=5, cg_iters=32)
        np.testing.assert_array_equal(np.asarray(res.kf_R[0]), np.asarray(prob.kf_R[0]))
        np.testing.assert_array_equal(np.asarray(res.kf_t[0]), np.asarray(prob.kf_t[0]))

    def test_outlier_classification(self, rng):
        prob, *_ = make_ba_problem(rng, noise=0.2, perturb=0.0)
        uv = np.array(prob.obs_uv)
        n_bad = len(uv) // 20
        uv[:n_bad] += rng.uniform(30, 80, size=(n_bad, 2)) * rng.choice(
            [-1, 1], size=(n_bad, 2))
        prob = prob._replace(obs_uv=jnp.array(uv))
        res = gba.bundle_adjust_large(prob, iterations=10, cg_iters=32)
        out = np.asarray(res.obs_outlier)
        assert out[:n_bad].mean() > 0.9
        assert out[n_bad:].mean() < 0.02


class TestGBACapacity:
    def test_runs_at_capacity_shape(self, rng):
        """Sparse capacity-shaped problem: 128 cameras along a trajectory,
        4096 points each seen by a handful of nearby cameras (the shape the
        dense solver cannot assemble at full map size)."""
        n_kf, n_pts, obs_per_pt = 128, 4096, 6
        xw = np.stack([
            rng.uniform(0, 40, n_pts), rng.uniform(-2, 2, n_pts),
            rng.uniform(4, 8, n_pts)], 1).astype(np.float32)
        ts_gt = np.stack([
            np.linspace(0, 40, n_kf), np.zeros(n_kf), np.zeros(n_kf)],
            1).astype(np.float32)
        Rs_gt = np.tile(np.eye(3, dtype=np.float32), (n_kf, 1, 1))
        # each point observed by the nearest cameras
        near = np.clip(
            (xw[:, 0] / 40 * n_kf).astype(int)[:, None]
            + np.arange(-obs_per_pt // 2, obs_per_pt - obs_per_pt // 2)[None],
            0, n_kf - 1)
        obs_kf = near.reshape(-1)
        obs_pt = np.repeat(np.arange(n_pts), obs_per_pt)
        xc = xw[obs_pt] - ts_gt[obs_kf] * np.array([1, 1, 1], np.float32)
        # camera at ts looks down +z; world->cam: x - center
        uv = np.stack([
            500 * xc[:, 0] / xc[:, 2] + 320,
            500 * xc[:, 1] / xc[:, 2] + 240], 1).astype(np.float32)
        inb = (xc[:, 2] > 1.0) & (np.abs(uv[:, 0] - 320) < 400) & (
            np.abs(uv[:, 1] - 240) < 300)
        uv += rng.normal(0, 0.3, uv.shape)

        perturb = 0.05
        ts0 = -(ts_gt + rng.normal(0, perturb, (n_kf, 3))).astype(np.float32)
        # anchor BOTH ends: a single-anchor 128-camera chain legitimately
        # drifts at the noise-floor optimum, which would make mid-chain
        # ground-truth comparison meaningless
        ts0[0], ts0[-1] = -ts_gt[0], -ts_gt[-1]
        fixed = np.zeros(n_kf, bool)
        fixed[0] = fixed[-1] = True
        prob = ba.BAProblem(
            kf_R=jnp.array(Rs_gt), kf_t=jnp.array(ts0),
            kf_fixed=jnp.array(fixed),
            points=jnp.array(xw + rng.normal(0, perturb, xw.shape)),
            point_valid=jnp.ones(n_pts, bool),
            obs_kf=jnp.array(obs_kf, jnp.int32),
            obs_pt=jnp.array(obs_pt, jnp.int32),
            obs_uv=jnp.array(uv), obs_w=jnp.ones(len(uv), jnp.float32),
            obs_valid=jnp.array(inb), K4=K4,
        )
        res = gba.bundle_adjust_large(prob, iterations=12, cg_iters=64)
        chi0 = float(ba._robust_chi2(prob, prob.kf_R, prob.kf_t, prob.points))
        # converges to the noise floor (~2 * n_valid_obs * sigma^2)
        floor = 2.0 * float(inb.sum()) * 0.3 ** 2
        assert float(res.chi2) < max(1.5 * floor, 0.05 * chi0), (
            float(res.chi2), floor, chi0)
        # mid-trajectory cameras land back near the line; the residual
        # wobble is the statistical limit of a locally-connected chain at
        # 0.3 px noise (random-walk ~sigma_cam * sqrt(chain length)), far
        # below the 0.05 initial perturbation magnitude scaled by sqrt(3)
        for k in (32, 64, 96):
            err = np.linalg.norm(np.asarray(res.kf_t[k]) - (-ts_gt[k]))
            assert err < 0.15, (k, err)

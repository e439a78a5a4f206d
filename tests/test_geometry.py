"""Unit tests for the geometry core vs closed forms and cv2/scipy oracles.

All library calls go through jitted wrappers: eager op-by-op dispatch is very
slow in this environment, while jitted calls compile once (persistently
cached) and then run in microseconds.
"""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from scipy.spatial.transform import Rotation

from orbslam_jpminipc.geometry import se3, sim3, camera, triangulate, epipolar

J = jax.jit  # alias
exp_so3 = J(se3.exp_so3)
log_so3 = J(se3.log_so3)
exp_se3 = J(se3.exp_se3)
log_se3 = J(se3.log_se3)
se3_compose = J(se3.compose)
se3_inverse = J(se3.inverse)
se3_transform = J(se3.transform)
se3_retract = J(se3.retract)
quat_from_mat = J(se3.quat_from_mat)
mat_from_quat = J(se3.mat_from_quat)
pose7_from_Rt = J(se3.pose7_from_Rt)
Rt_from_pose7 = J(se3.Rt_from_pose7)
sim3_exp7 = J(sim3.exp7)
sim3_log7 = J(sim3.log7)
sim3_compose = J(sim3.compose)
sim3_inverse = J(sim3.inverse)
sim3_transform = J(sim3.transform)
cam_project = J(camera.project)
cam_unproject = J(camera.unproject)
cam_undistort = jax.jit(camera.undistort_points, static_argnames="iters")
cam_project_distorted = J(camera.project_distorted)
tri_projmat = J(triangulate.projection_matrix)
tri_dlt = J(triangulate.triangulate_dlt)
tri_reproj2 = J(triangulate.reprojection_error2)
epi_F = J(epipolar.fundamental_from_poses)
epi_d2 = J(epipolar.epipolar_dist2)


def random_rotations(rng, n):
    return Rotation.random(n, random_state=np.random.RandomState(0)).as_matrix().astype(np.float32)


class TestSO3:
    def test_exp_log_roundtrip(self, rng):
        w = rng.normal(size=(64, 3)).astype(np.float32) * 1.5
        R = exp_so3(jnp.array(w))
        w2 = log_so3(R)
        R2 = exp_so3(w2)
        np.testing.assert_allclose(np.asarray(R), np.asarray(R2), atol=2e-5)

    def test_exp_vs_scipy(self, rng):
        w = rng.normal(size=(32, 3)).astype(np.float32)
        R = np.asarray(exp_so3(jnp.array(w)))
        R_ref = Rotation.from_rotvec(w).as_matrix()
        np.testing.assert_allclose(R, R_ref, atol=1e-5)

    def test_small_angle(self):
        w = jnp.array([[1e-9, 0, 0], [0.0, 0, 0]])
        R = exp_so3(w)
        np.testing.assert_allclose(np.asarray(R), np.stack([np.eye(3)] * 2), atol=1e-6)
        assert np.all(np.isfinite(np.asarray(log_so3(R))))

    def test_grad_finite_at_identity(self):
        g = jax.grad(lambda w: jnp.sum(exp_so3(w)))(jnp.zeros(3))
        assert np.all(np.isfinite(np.asarray(g)))


class TestSE3:
    def test_exp_log_roundtrip(self, rng):
        xi = rng.normal(size=(64, 6)).astype(np.float32)
        R, t = exp_se3(jnp.array(xi))
        xi2 = log_se3(R, t)
        np.testing.assert_allclose(np.asarray(xi), np.asarray(xi2), atol=1e-4)

    def test_compose_inverse(self, rng):
        R = jnp.array(random_rotations(rng, 8))
        t = jnp.array(rng.normal(size=(8, 3)).astype(np.float32))
        Ri, ti = se3_inverse(R, t)
        Rc, tc = se3_compose(R, t, Ri, ti)
        np.testing.assert_allclose(np.asarray(Rc), np.stack([np.eye(3)] * 8), atol=1e-5)
        np.testing.assert_allclose(np.asarray(tc), 0, atol=1e-5)

    def test_quat_roundtrip(self, rng):
        R = jnp.array(random_rotations(rng, 16))
        q = quat_from_mat(R)
        R2 = mat_from_quat(q)
        np.testing.assert_allclose(np.asarray(R), np.asarray(R2), atol=1e-5)

    def test_pose7_pack(self, rng):
        R = jnp.array(random_rotations(rng, 4))
        t = jnp.array(rng.normal(size=(4, 3)).astype(np.float32))
        p = pose7_from_Rt(R, t)
        R2, t2 = Rt_from_pose7(p)
        np.testing.assert_allclose(np.asarray(R), np.asarray(R2), atol=1e-5)
        np.testing.assert_allclose(np.asarray(t), np.asarray(t2), atol=1e-6)

    def test_retract_matches_compose(self, rng):
        xi = jnp.array(rng.normal(size=(6,)).astype(np.float32) * 0.1)
        R0 = jnp.array(random_rotations(rng, 1)[0])
        t0 = jnp.array(rng.normal(size=3).astype(np.float32))
        R1, t1 = se3_retract(R0, t0, xi)
        dR, dt = exp_se3(xi)
        R2, t2 = se3_compose(dR, dt, R0, t0)
        np.testing.assert_allclose(np.asarray(R1), np.asarray(R2), atol=1e-6)
        np.testing.assert_allclose(np.asarray(t1), np.asarray(t2), atol=1e-6)


class TestSim3:
    def test_exp_log_roundtrip(self, rng):
        xi = rng.normal(size=(32, 7)).astype(np.float32) * 0.5
        s, R, t = sim3_exp7(jnp.array(xi))
        xi2 = sim3_log7(s, R, t)
        np.testing.assert_allclose(np.asarray(xi), np.asarray(xi2), atol=2e-4)

    def test_zero_is_identity(self):
        s, R, t = sim3_exp7(jnp.zeros(7))
        assert np.allclose(np.asarray(s), 1.0)
        np.testing.assert_allclose(np.asarray(R), np.eye(3), atol=1e-6)
        np.testing.assert_allclose(np.asarray(t), 0, atol=1e-6)

    def test_compose_inverse(self, rng):
        xi = jnp.array(rng.normal(size=(7,)).astype(np.float32) * 0.5)
        s, R, t = sim3_exp7(xi)
        si, Ri, ti = sim3_inverse(s, R, t)
        sc, Rc, tc = sim3_compose(s, R, t, si, Ri, ti)
        assert np.allclose(np.asarray(sc), 1.0, atol=1e-5)
        np.testing.assert_allclose(np.asarray(Rc), np.eye(3), atol=1e-5)
        np.testing.assert_allclose(np.asarray(tc), 0, atol=1e-5)

    def test_action(self, rng):
        # y = s R x + t, composed transforms act like composed functions.
        xi1 = jnp.array(rng.normal(size=7).astype(np.float32) * 0.3)
        xi2 = jnp.array(rng.normal(size=7).astype(np.float32) * 0.3)
        a = sim3_exp7(xi1)
        b = sim3_exp7(xi2)
        x = jnp.array(rng.normal(size=(10, 3)).astype(np.float32))
        y1 = sim3_transform(*a, sim3_transform(*b, x))
        c = sim3_compose(*a, *b)
        y2 = sim3_transform(*c, x)
        np.testing.assert_allclose(np.asarray(y1), np.asarray(y2), atol=1e-4)

    def test_se3_embedding(self, rng):
        # sigma=0 reduces to SE3 exp.
        xi6 = rng.normal(size=(8, 6)).astype(np.float32)
        xi7 = np.concatenate([xi6, np.zeros((8, 1), np.float32)], axis=1)
        s, R, t = sim3_exp7(jnp.array(xi7))
        R_se3, t_se3 = exp_se3(jnp.array(xi6))
        np.testing.assert_allclose(np.asarray(s), 1.0, atol=1e-6)
        np.testing.assert_allclose(np.asarray(R), np.asarray(R_se3), atol=1e-5)
        np.testing.assert_allclose(np.asarray(t), np.asarray(t_se3), atol=1e-4)


class TestCamera:
    K4 = jnp.array([520.9, 521.0, 325.1, 249.7], jnp.float32)
    dist = jnp.array([0.2624, -0.9531, -0.0054, 0.0026], jnp.float32)

    def test_project_unproject(self, rng):
        xc = jnp.array(rng.uniform(-1, 1, size=(100, 3)).astype(np.float32))
        xc = xc.at[:, 2].set(jnp.abs(xc[:, 2]) + 1.0)
        uv = cam_project(xc, self.K4)
        rays = cam_unproject(uv, self.K4)
        np.testing.assert_allclose(
            np.asarray(rays * xc[:, 2:3]), np.asarray(xc), atol=1e-3
        )

    def test_undistort_vs_cv2(self, rng):
        import cv2

        uv = rng.uniform(50, 550, size=(200, 2)).astype(np.float32)
        # This test's distortion (k2 = -0.95) is non-invertible beyond
        # normalized radius ~0.74; restrict the oracle comparison to the
        # well-posed region (all undistortion schemes diverge outside it).
        r = np.hypot((uv[:, 0] - 325.1) / 520.9, (uv[:, 1] - 249.7) / 521.0)
        uv = uv[r < 0.55]
        K = np.array([[520.9, 0, 325.1], [0, 521.0, 249.7], [0, 0, 1]], np.float32)
        d = np.asarray(self.dist)
        ref = cv2.undistortPoints(uv.reshape(-1, 1, 2), K, d, P=K).reshape(-1, 2)
        # iters=5 matches cv2's fixed 5-iteration scheme.
        ours = np.asarray(cam_undistort(jnp.array(uv), self.K4, self.dist, iters=5))
        np.testing.assert_allclose(ours, ref, atol=0.05)

    def test_distort_undistort_roundtrip(self, rng):
        uv = jnp.array(rng.uniform(150, 450, size=(100, 2)).astype(np.float32))
        und = cam_undistort(uv, self.K4, self.dist, iters=20)
        rays = cam_unproject(und, self.K4)
        re = cam_project_distorted(rays, self.K4, self.dist)
        np.testing.assert_allclose(np.asarray(re), np.asarray(uv), atol=0.05)


class TestTriangulate:
    def test_dlt_recovers_points(self, rng):
        K4 = jnp.array([500.0, 500.0, 320.0, 240.0], jnp.float32)
        xw = rng.uniform(-1, 1, size=(50, 3)).astype(np.float32)
        xw[:, 2] += 4.0
        R1, t1 = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
        R2 = Rotation.from_rotvec([0, 0.1, 0]).as_matrix().astype(np.float32)
        t2 = np.array([-0.5, 0, 0], np.float32)
        uv1 = cam_project(se3_transform(jnp.array(R1), jnp.array(t1), jnp.array(xw)), K4)
        uv2 = cam_project(se3_transform(jnp.array(R2), jnp.array(t2), jnp.array(xw)), K4)
        P1 = tri_projmat(jnp.array(R1), jnp.array(t1), K4)
        P2 = tri_projmat(jnp.array(R2), jnp.array(t2), K4)
        x_est, ok = tri_dlt(uv1, uv2, P1, P2)
        assert np.all(np.asarray(ok))
        np.testing.assert_allclose(np.asarray(x_est), xw, atol=5e-2)

    def test_reprojection_error(self, rng):
        K4 = jnp.array([500.0, 500.0, 320.0, 240.0], jnp.float32)
        xw = jnp.array([[0.0, 0.0, 5.0]])
        uv = cam_project(xw, K4)
        e2, pos = tri_reproj2(
            xw, uv, jnp.eye(3), jnp.zeros(3), K4
        )
        assert np.asarray(e2)[0] < 1e-6 and np.asarray(pos)[0]


class TestEpipolar:
    def test_matched_points_on_epipolar_line(self, rng):
        K4 = jnp.array([500.0, 500.0, 320.0, 240.0], jnp.float32)
        xw = rng.uniform(-1, 1, size=(60, 3)).astype(np.float32)
        xw[:, 2] += 4.0
        R1 = Rotation.from_rotvec([0.05, 0, 0]).as_matrix().astype(np.float32)
        t1 = np.array([0.2, 0, 0], np.float32)
        R2 = Rotation.from_rotvec([0, 0.1, 0]).as_matrix().astype(np.float32)
        t2 = np.array([-0.3, 0.1, 0], np.float32)
        uv1 = cam_project(se3_transform(jnp.array(R1), jnp.array(t1), jnp.array(xw)), K4)
        uv2 = cam_project(se3_transform(jnp.array(R2), jnp.array(t2), jnp.array(xw)), K4)
        F12 = epi_F(jnp.array(R1), jnp.array(t1), jnp.array(R2), jnp.array(t2), K4)
        d2 = epi_d2(uv1, uv2, F12)
        assert float(np.max(np.asarray(d2))) < 1e-2

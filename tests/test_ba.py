"""Bundle adjustment tests on synthetic multi-view scenes."""
import numpy as np
import jax
import jax.numpy as jnp
from scipy.spatial.transform import Rotation

from orbslam_jpminipc.geometry import se3, camera
from orbslam_jpminipc.solvers import ba

K4 = jnp.array([500.0, 500.0, 320.0, 240.0], jnp.float32)


def make_ba_problem(rng, n_kf=6, n_pts=150, noise=0.3, perturb=0.02, drop=0.2):
    """Cameras on an arc looking at a point cloud; all points seen by all
    cameras (minus random dropout)."""
    xw = np.stack(
        [rng.uniform(-2, 2, n_pts), rng.uniform(-1.5, 1.5, n_pts), rng.uniform(4, 8, n_pts)],
        axis=1,
    ).astype(np.float32)
    Rs, ts = [], []
    for i in range(n_kf):
        ang = (i - n_kf / 2) * 0.04
        R = Rotation.from_rotvec([0, ang, 0]).as_matrix().astype(np.float32)
        t = np.array([-0.3 * i, 0.02 * i, 0.0], np.float32)
        Rs.append(R)
        ts.append(t)
    Rs, ts = np.stack(Rs), np.stack(ts)

    obs_kf, obs_pt, obs_uv = [], [], []
    for k in range(n_kf):
        uv = np.asarray(
            camera.project(se3.transform(jnp.array(Rs[k]), jnp.array(ts[k]), jnp.array(xw)), K4)
        )
        for p in range(n_pts):
            if rng.uniform() < drop:
                continue
            obs_kf.append(k)
            obs_pt.append(p)
            obs_uv.append(uv[p] + rng.normal(0, noise, 2))
    O = len(obs_kf)
    # perturb initial state
    Rs0, ts0, xw0 = [], [], xw + rng.normal(0, perturb, xw.shape).astype(np.float32)
    for k in range(n_kf):
        if k == 0:
            Rs0.append(Rs[k]); ts0.append(ts[k])
            continue
        dR = Rotation.from_rotvec(rng.normal(0, perturb, 3)).as_matrix().astype(np.float32)
        Rs0.append(dR @ Rs[k])
        ts0.append(ts[k] + rng.normal(0, perturb, 3).astype(np.float32))
    fixed = np.zeros(n_kf, bool)
    fixed[0] = True

    prob = ba.BAProblem(
        kf_R=jnp.array(np.stack(Rs0)),
        kf_t=jnp.array(np.stack(ts0), jnp.float32),
        kf_fixed=jnp.array(fixed),
        points=jnp.array(xw0),
        point_valid=jnp.ones(n_pts, bool),
        obs_kf=jnp.array(obs_kf, jnp.int32),
        obs_pt=jnp.array(obs_pt, jnp.int32),
        obs_uv=jnp.array(np.array(obs_uv), jnp.float32),
        obs_w=jnp.ones(O, jnp.float32),
        obs_valid=jnp.ones(O, bool),
        K4=K4,
    )
    return prob, Rs, ts, xw


class TestBA:
    def test_reduces_chi2_and_recovers_geometry(self, rng):
        prob, Rs, ts, xw = make_ba_problem(rng)
        res = ba.bundle_adjust(prob, iterations=10)
        # chi2 should approach the noise floor: E[chi2] ~ 2 * O * noise^2
        O = prob.obs_uv.shape[0]
        assert float(res.chi2) < 2.5 * O * 0.3 ** 2, float(res.chi2)
        # camera poses recovered
        for k in range(1, 6):
            R_err = np.degrees(
                np.linalg.norm(np.asarray(se3.log_so3(jnp.array(Rs[k]) @ res.kf_R[k].T)))
            )
            assert R_err < 0.1, (k, R_err)
            assert np.linalg.norm(np.asarray(res.kf_t[k]) - ts[k]) < 0.01
        # points recovered
        err = np.linalg.norm(np.asarray(res.points) - xw, axis=1)
        assert np.median(err) < 0.03  # ~ triangulation noise floor at 0.3px

    def test_fixed_camera_untouched(self, rng):
        prob, Rs, ts, xw = make_ba_problem(rng)
        res = ba.bundle_adjust(prob, iterations=5)
        np.testing.assert_array_equal(np.asarray(res.kf_R[0]), np.asarray(prob.kf_R[0]))
        np.testing.assert_array_equal(np.asarray(res.kf_t[0]), np.asarray(prob.kf_t[0]))

    def test_outlier_classification(self, rng):
        prob, Rs, ts, xw = make_ba_problem(rng, noise=0.2, perturb=0.0)
        # corrupt 5% of observations grossly
        uv = np.array(prob.obs_uv)
        n_bad = len(uv) // 20
        uv[:n_bad] += rng.uniform(30, 80, size=(n_bad, 2)) * rng.choice([-1, 1], size=(n_bad, 2))
        prob = prob._replace(obs_uv=jnp.array(uv))
        res = ba.two_stage_local_ba(prob)
        out = np.asarray(res.obs_outlier)
        assert out[:n_bad].mean() > 0.9          # gross outliers flagged
        assert out[n_bad:].mean() < 0.02         # inliers kept

    def test_invalid_slots_inert(self, rng):
        # padded problem: extra camera and point slots marked invalid/fixed
        prob, Rs, ts, xw = make_ba_problem(rng, n_kf=4, n_pts=50)
        K, P = 8, 80
        pad_R = jnp.concatenate([prob.kf_R, jnp.tile(jnp.eye(3)[None], (K - 4, 1, 1))])
        pad_t = jnp.concatenate([prob.kf_t, jnp.zeros((K - 4, 3))])
        pad_fixed = jnp.concatenate([prob.kf_fixed, jnp.ones(K - 4, bool)])
        pad_pts = jnp.concatenate([prob.points, jnp.zeros((P - 50, 3))])
        pad_pv = jnp.concatenate([prob.point_valid, jnp.zeros(P - 50, bool)])
        prob2 = prob._replace(
            kf_R=pad_R, kf_t=pad_t, kf_fixed=pad_fixed,
            points=pad_pts, point_valid=pad_pv,
        )
        res = ba.bundle_adjust(prob2, iterations=5)
        assert np.all(np.isfinite(np.asarray(res.points)))
        assert np.all(np.isfinite(np.asarray(res.kf_t)))
        # padding untouched
        np.testing.assert_array_equal(np.asarray(res.points[50:]), 0.0)
        # real cameras still optimized sanely
        for k in range(1, 4):
            R_err = np.degrees(
                np.linalg.norm(np.asarray(se3.log_so3(jnp.array(Rs[k]) @ res.kf_R[k].T)))
            )
            assert R_err < 0.5, (k, R_err)  # only ~40 obs per camera here

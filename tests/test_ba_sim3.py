"""All-Sim3 local BA (fork WJ_All7Dof variant, solvers/ba_sim3.py)."""
import numpy as np
import jax.numpy as jnp

from orbslam_jpminipc.solvers.ba_sim3 import Sim3BAProblem, bundle_adjust_sim3


def _make_problem(rng, K=4, P=64, scale_err=1.15, noise=0.0):
    xyz = np.stack(
        [rng.uniform(-1, 1, P), rng.uniform(-1, 1, P), rng.uniform(3, 6, P)], 1
    ).astype(np.float32)
    K4 = np.array([500.0, 500.0, 320.0, 240.0], np.float32)
    kf_t = np.stack([np.array([-0.3 * k, 0, 0], np.float32) for k in range(K)])
    kf_R = np.tile(np.eye(3, dtype=np.float32)[None], (K, 1, 1))
    obs_kf, obs_pt, obs_uv = [], [], []
    for k in range(K):
        xc = xyz @ kf_R[k].T + kf_t[k]
        uv = np.stack(
            [K4[0] * xc[:, 0] / xc[:, 2] + K4[2], K4[1] * xc[:, 1] / xc[:, 2] + K4[3]], 1
        )
        for p in range(P):
            obs_kf.append(k)
            obs_pt.append(p)
            obs_uv.append(uv[p] + rng.normal(0, noise, 2))
    O = len(obs_kf)
    # perturb the LAST keyframe: its scale (the only free scale) and pose
    kf_s = np.ones(K, np.float32)
    kf_s[-1] = scale_err
    kf_t = kf_t.copy()
    kf_t[-1] += rng.normal(0, 0.05, 3).astype(np.float32)
    pts0 = xyz + rng.normal(0, 0.02, xyz.shape).astype(np.float32)
    return Sim3BAProblem(
        kf_s=jnp.array(kf_s), kf_R=jnp.array(kf_R), kf_t=jnp.array(kf_t),
        kf_fixed=jnp.array([True, True] + [False] * (K - 2)),
        kf_scale_fixed=jnp.array([True] * (K - 1) + [False]),
        points=jnp.array(pts0), point_valid=jnp.ones(P, bool),
        obs_kf=jnp.array(obs_kf, jnp.int32), obs_pt=jnp.array(obs_pt, jnp.int32),
        obs_uv=jnp.array(np.array(obs_uv, np.float32)),
        obs_w=jnp.ones(O, jnp.float32), obs_valid=jnp.ones(O, bool),
        K4=jnp.array(K4),
    ), xyz


def test_recovers_se3_pose_modulo_scale_gauge(rng):
    prob, xyz = _make_problem(rng)
    res = bundle_adjust_sim3(prob, iterations=15)
    assert float(res.chi2) < 1e-2
    # A single camera's scale is a gauge freedom under projection
    # (proj(s R x + t) = proj(R x + t/s)); what is observable is the
    # recovered SE3 pose [R, t/s] — the same recovery OptimizeEssentialGraph
    # uses (src/Optimizer.cc:1687-1718).
    t_se3 = np.asarray(res.kf_t[-1]) / float(res.kf_s[-1])
    np.testing.assert_allclose(t_se3, [-0.9, 0.0, 0.0], atol=5e-3)
    np.testing.assert_allclose(np.asarray(res.kf_R[-1]), np.eye(3), atol=1e-3)
    # fixed scales never move
    np.testing.assert_allclose(np.asarray(res.kf_s[:-1]), 1.0, atol=0)
    # fixed keyframes never move
    np.testing.assert_allclose(np.asarray(res.kf_R[0]), np.eye(3), atol=0)


def test_scale_fixed_mask_respected(rng):
    prob, _ = _make_problem(rng)
    # freeze ALL scales: the solver must keep the (wrong) 1.15 scale and
    # still reduce chi2 by moving R/t/points only
    prob = prob._replace(kf_scale_fixed=jnp.ones_like(prob.kf_scale_fixed))
    res = bundle_adjust_sim3(prob, iterations=15)
    assert float(res.kf_s[-1]) == np.float32(1.15)
    # translation alone can still absorb the frozen wrong scale
    assert float(res.chi2) < 1e-2


def test_outlier_classification(rng):
    prob, _ = _make_problem(rng)
    # corrupt a handful of observations
    uv = np.asarray(prob.obs_uv).copy()
    uv[:5] += 80.0
    prob = prob._replace(obs_uv=jnp.array(uv))
    res = bundle_adjust_sim3(prob, iterations=15)
    out = np.asarray(res.obs_outlier)
    assert out[:5].all()
    # the corrupted observations drag their points slightly during the early
    # Huber-weighted iterations; allow a couple of borderline extras
    assert out[5:].sum() <= 2

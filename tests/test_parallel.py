"""Multi-device sharded BA on the virtual 8-device CPU mesh."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.sharding import Mesh

from orbslam_jpminipc.solvers import ba
from orbslam_jpminipc.parallel import shard_ba_problem, sharded_bundle_adjust
from tests.test_ba import make_ba_problem


@pytest.mark.parametrize("n_shards", [2, 8])
def test_sharded_matches_single_device(rng, n_shards):
    assert len(jax.devices()) >= n_shards
    prob, Rs, ts, xw = make_ba_problem(rng, n_kf=5, n_pts=96)
    ref = ba.bundle_adjust(prob, iterations=8)

    sprob = shard_ba_problem(prob, n_shards)
    mesh = Mesh(np.array(jax.devices()[:n_shards]), ("points",))
    R, t, pts, chi2, _out = sharded_bundle_adjust(sprob, mesh, iterations=8)

    # same optimum: chi2 is the sharp criterion; pose/point endpoints can
    # differ slightly along weakly-constrained directions because float
    # reduction order changes the LM accept/reject history.
    assert abs(float(chi2) - float(ref.chi2)) < 0.01 * float(ref.chi2) + 0.1
    np.testing.assert_allclose(np.asarray(R), np.asarray(ref.kf_R), atol=1e-2)
    # the monocular gauge scale is free (one fixed camera), so the two
    # solutions may differ by a small global scale; align before comparing
    P_total = prob.points.shape[0]
    flat = np.asarray(pts).reshape(-1, 3)[:P_total]
    refp = np.asarray(ref.points)
    valid = np.asarray(prob.point_valid)
    s_align = float((flat[valid] * refp[valid]).sum() / (flat[valid] ** 2).sum())
    err = np.linalg.norm(s_align * flat - refp, axis=1)
    assert np.median(err[valid]) < 2e-2, np.median(err[valid])
    np.testing.assert_allclose(
        s_align * np.asarray(t), np.asarray(ref.kf_t), atol=2e-2
    )


def test_sharded_ba_on_live_pipeline_problem():
    """Shard a local-BA problem produced by the LIVE pipeline (not a
    hand-built fixture): run the synthetic sequence, grab the mapper's own
    problem for the newest keyframe, and check the 8-way sharded solver
    reproduces the single-device optimum on it."""
    from orbslam_jpminipc.io.dataset import SyntheticSequence
    from orbslam_jpminipc.pipeline.system import Slam
    from tests.test_pipeline import make_cfg

    seq = SyntheticSequence(n_frames=45, trajectory="xyz", seed=3)
    slam = Slam(make_cfg(), vocab=None)
    for i in range(30):
        img, ts, _ = seq.get(i)
        slam.process(img, ts)
    assert slam.n_keyframes >= 3 and slam.n_points > 200

    st = slam.map
    kf = int(np.nonzero(st.kf_valid)[0][np.argmax(st.kf_frame_id[st.kf_valid])])
    prob, all_kfs, pts, obs_src = slam.mapper.build_local_ba_problem(kf)
    assert len(obs_src) > 500  # a real, well-populated problem

    ref = ba.bundle_adjust(prob, iterations=8)
    sprob = shard_ba_problem(prob, 8)
    mesh = Mesh(np.array(jax.devices()[:8]), ("points",))
    R, t, pts_sh, chi2, _out = sharded_bundle_adjust(sprob, mesh, iterations=8)
    assert abs(float(chi2) - float(ref.chi2)) < 0.02 * float(ref.chi2) + 0.5
    np.testing.assert_allclose(np.asarray(R), np.asarray(ref.kf_R), atol=2e-2)


def test_local_ba_problem_python_fallback_matches_native(monkeypatch):
    """ADVICE r03 (high): the no-native fallback of build_local_ba_problem
    must fill obs_feat/obs_srckf — the mirror kernel gathers obs_uv from
    them, so zeroed arrays silently corrupt local BA on machines without
    g++. Build the same problem with and without the native path and
    assert the observation sets are identical."""
    from orbslam_jpminipc.io.dataset import SyntheticSequence
    from orbslam_jpminipc.pipeline.system import Slam
    from tests.test_pipeline import make_cfg

    seq = SyntheticSequence(n_frames=30, trajectory="xyz", seed=3)
    slam = Slam(make_cfg(), vocab=None)
    for i in range(25):
        img, ts, _ = seq.get(i)
        slam.process(img, ts)
    st = slam.map
    kf = int(np.nonzero(st.kf_valid)[0][np.argmax(st.kf_frame_id[st.kf_valid])])

    prob_n, _, pts_n, src_n = slam.mapper.build_local_ba_problem(kf)
    feat_n, srckf_n = slam.mapper._last_obs_idx

    import orbslam_jpminipc.pipeline.local_mapping as lm
    import orbslam_jpminipc.native as native_mod
    monkeypatch.setattr(native_mod, "build_ba_obs_native",
                        lambda *a, **k: None)
    prob_p, _, pts_p, src_p = slam.mapper.build_local_ba_problem(kf)
    feat_p, srckf_p = slam.mapper._last_obs_idx

    assert np.array_equal(pts_n, pts_p)
    # same observation multiset (order may differ between the two builders)
    def key(prob, feat, srckf):
        k = np.stack([np.asarray(prob.obs_kf), np.asarray(prob.obs_pt),
                      feat, srckf], 1)[np.asarray(prob.obs_valid)]
        return k[np.lexsort(k.T)]
    assert np.array_equal(key(prob_n, feat_n, srckf_n),
                          key(prob_p, feat_p, srckf_p))
    # and the gathered pixels agree with the shipped obs_uv
    uv_p = st.kf_xy[srckf_p, feat_p]
    assert np.allclose(uv_p[np.asarray(prob_p.obs_valid)],
                       np.asarray(prob_p.obs_uv)[np.asarray(prob_p.obs_valid)])


def test_sharded_long_run_parity(rng):
    """VERDICT r03 #4: 30+ iterations must not re-drift (the sharded solver
    now re-projects onto SO(3) after each accepted step, like
    solvers/ba.py) and the outlier classification must match the
    single-device BAResult semantics."""
    prob, Rs, ts, xw = make_ba_problem(rng, n_kf=5, n_pts=96)
    ref = ba.bundle_adjust(prob, iterations=32)

    n_shards = 8
    sprob = shard_ba_problem(prob, n_shards)
    mesh = Mesh(np.array(jax.devices()[:n_shards]), ("points",))
    R, t, pts, chi2, out = sharded_bundle_adjust(sprob, mesh, iterations=32)

    # rotations stay orthonormal after 32 f32 compose steps
    RtR = np.einsum("kij,kil->kjl", np.asarray(R), np.asarray(R))
    np.testing.assert_allclose(RtR, np.tile(np.eye(3), (R.shape[0], 1, 1)),
                               atol=1e-5)
    assert abs(float(chi2) - float(ref.chi2)) < 0.01 * float(ref.chi2) + 0.1
    np.testing.assert_allclose(np.asarray(R), np.asarray(ref.kf_R), atol=1e-2)
    # outlier mask: same chi2>5.991 / negative-depth classification; on a
    # well-converged synthetic problem both should flag the same few (none)
    ref_out = np.asarray(ref.obs_outlier)
    n_valid = int(np.asarray(prob.obs_valid).sum())
    assert np.asarray(out).dtype == np.bool_
    assert int(np.asarray(out).sum()) <= max(4, int(0.02 * n_valid) + int(ref_out.sum()))

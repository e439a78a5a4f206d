"""LoopCloser end-to-end on a constructed drift-broken map.

A genuine loop-closure situation cannot arise in the clean synthetic
renders (tracking re-matches the persistent map before covisibility ever
breaks), so this test builds the situation directly, the way the reference
encounters it (LoopClosing.cc:115-574): a keyframe chain whose tail
revisits the start's VIEW but not its map — the tail observes drifted
duplicate points with the same descriptors, and its estimated poses carry
the accumulated drift. The closer must detect the loop through the BoW
database + consistency filter, solve the relative Sim3, and pull the tail
back onto the start through the essential graph.
"""
import numpy as np
import pytest

from orbslam_jpminipc.config import SlamConfig
from orbslam_jpminipc.map.map_state import MapState
from orbslam_jpminipc.map.keyframe_db import KeyFrameDatabase
from orbslam_jpminipc.pipeline.loop_closing import LoopCloser
from orbslam_jpminipc.vocab.vocabulary import build_vocabulary

K4 = np.array([500.0, 500.0, 320.0, 240.0], np.float32)
DRIFT = np.array([0.35, 0.0, 0.18], np.float32)


def _project(xc):
    return np.stack(
        [K4[0] * xc[:, 0] / xc[:, 2] + K4[2], K4[1] * xc[:, 1] / xc[:, 2] + K4[3]], 1
    ).astype(np.float32)


def _make_points(rng, n):
    return np.stack(
        [rng.uniform(-1.2, 1.2, n), rng.uniform(-0.9, 0.9, n), rng.uniform(3.0, 5.0, n)],
        1,
    ).astype(np.float32)


@pytest.fixture
def scene(rng):
    """9 KFs: 0-1 start, 2-4 bridge, 5-8 revisit (drifted duplicates)."""
    cfg = SlamConfig(pipelined_tracking=False,
                     fx=500.0, fy=500.0, cx=320.0, cy=240.0,
                     max_kf=16, max_mp=2048, n_features=128)
    st = MapState.create(max_kf=16, max_mp=2048, n_feat=160, max_obs=12)

    n_per = 60
    # point set S_k is shared by KF k and k+1 (covisibility chain)
    sets_xyz = [_make_points(rng, n_per) for _ in range(5)]
    # offset each bridge set forward so each KF pair genuinely sees it
    centers_true = np.array(
        [[0.4 * k, 0.0, 0.0] for k in range(5)], np.float32
    )  # KFs 0..4
    for k in range(1, 5):
        sets_xyz[k] = sets_xyz[k] + centers_true[k]
    sets_desc = [
        rng.integers(0, 256, (n_per, 32)).astype(np.uint8) for _ in range(5)
    ]

    # revisit KFs 5..8: true centers back near the start
    centers_true = np.concatenate(
        [centers_true, np.array([[0.05 * r, 0.0, 0.0] for r in range(4)], np.float32)]
    )

    # --- map points ---
    # GT sets S_0..S_4 observed by the start/bridge chain
    mp_ids = []
    for k in range(5):
        ids = st.add_points(sets_xyz[k], sets_desc[k], ref_kf=k)
        mp_ids.append(ids)
    # drifted duplicates of S_0, observed only by the revisit KFs
    dup_ids = st.add_points(sets_xyz[0] + DRIFT, sets_desc[0], ref_kf=5)

    # --- keyframes ---
    def add_kf(center_est, obs):  # obs: list[(mp_id, xyz_world_est, desc)]
        xyz = np.array([o[1] for o in obs], np.float32)
        xc = xyz - center_est[None, :]  # R = I
        uv = _project(xc)
        desc = np.array([o[2] for o in obs], np.uint8)
        n = len(obs)
        k = st.add_keyframe(
            np.eye(3, dtype=np.float32), -center_est.astype(np.float32),
            uv, np.zeros(n, np.int32), np.zeros(n, np.float32), desc,
            np.ones(n, bool),
        )
        for f, (mp, _, _) in enumerate(obs):
            st.add_observation(int(mp), k, f)
        return k

    for k in range(5):  # KFs 0..4 (KF k sees S_{k-1} and S_k)
        obs = []
        for s in ([k - 1] if k > 0 else []) + ([k] if k < 5 else []):
            obs += [
                (mp, sets_xyz[s][i], sets_desc[s][i])
                for i, mp in enumerate(mp_ids[s])
            ]
        add_kf(centers_true[k], obs)
    for r in range(4):  # KFs 5..8: drifted estimates of the duplicate set
        obs = [
            (mp, sets_xyz[0][i] + DRIFT, sets_desc[0][i])
            for i, mp in enumerate(dup_ids)
        ]
        add_kf(centers_true[5 + r] + DRIFT, obs)

    st.kf_parent[1:9] = np.arange(0, 8)
    st.update_point_attributes(
        np.nonzero(st.mp_valid)[0], cfg.scale_factors
    )

    vocab = build_vocabulary(
        np.concatenate(sets_desc), n_words=256, iters=3, seed=0
    )
    kfdb = KeyFrameDatabase(vocab, st.max_kf)
    for k in range(9):
        kfdb.add(k, st.kf_desc[k], st.kf_feat_valid[k])
    return cfg, st, kfdb


def test_detects_and_corrects_drifted_loop(scene):
    cfg, st, kfdb = scene
    lc = LoopCloser(cfg, st, kfdb)
    closed = [lc.process(k) for k in (5, 6, 7, 8)]
    assert any(closed), "loop was never closed"
    first = 5 + closed.index(True)
    # loop edge recorded between the closer KF and the start region
    assert len(st.kf_loop_edges[first] & {0, 1}) > 0
    # the drifted tail is pulled back toward the true trajectory. The whole
    # drift (|DRIFT| = 0.39) is concentrated in the bridge->tail edge, and
    # the essential graph distributes it around the loop cycle (identity
    # edge information, Optimizer.cc:1537), so the tail keeps a ~1/cycle
    # share of the error rather than landing exactly on ground truth.
    drift_norm = float(np.linalg.norm(DRIFT))
    for k in range(5, first + 1):
        center = -st.kf_R[k].T @ st.kf_t[k]
        true_center = np.array([0.05 * (k - 5), 0.0, 0.0])
        err = np.linalg.norm(center - true_center)
        assert err < 0.55 * drift_norm, (k, center, true_center, err)
    # and the start anchors stay put (loop KF fixed; its neighbors nearly so)
    for k in (0, 1):
        center = -st.kf_R[k].T @ st.kf_t[k]
        err = np.linalg.norm(center - np.array([0.4 * k, 0.0, 0.0]))
        assert err < 0.4 * drift_norm, (k, err)


def test_essential_graph_edge_overflow_keeps_structural_edges(scene, monkeypatch):
    """VERDICT r04 #6: beyond cfg.eg_edges the tail used to be dropped
    blindly — at capacity pressure that discards constraints exactly when
    the loop correction needs them. Now edges rank by priority: loop
    connections + spanning tree + prior loop edges always survive; only
    the weakest strong-covisibility edges drop (the reference uses ALL
    edges, Optimizer.cc:1486-1664 — a fixed-shape program must rank)."""
    from orbslam_jpminipc.solvers import essential_graph as eg

    cfg, st, kfdb = scene
    cfg.eg_edges = 12  # force overflow: 9 KFs give 8 spanning + 1 loop
    # + several strong-covis edges
    cfg.distributed_gba = False  # route through the spied single-device fn
    captured = {}
    real = eg.optimize_essential_graph

    def spy(prob, iterations=20):
        captured["prob"] = prob
        return real(prob, iterations=iterations)

    monkeypatch.setattr(eg, "optimize_essential_graph", spy)
    lc = LoopCloser(cfg, st, kfdb)
    closed = [lc.process(k) for k in (5, 6, 7, 8)]
    assert any(closed), "loop was never closed"
    prob = captured["prob"]
    e_i = np.asarray(prob.e_i)[np.asarray(prob.e_valid)]
    e_j = np.asarray(prob.e_j)[np.asarray(prob.e_valid)]
    pairs = {(min(int(a), int(b)), max(int(a), int(b)))
             for a, b in zip(e_i, e_j)}
    assert len(pairs) <= 12
    # every spanning-tree edge of a live KF must have survived the cut
    for k in range(9):
        p = int(st.kf_parent[k])
        if p >= 0 and st.kf_valid[k] and st.kf_valid[p]:
            assert (min(k, p), max(k, p)) in pairs, (k, p, pairs)
    # the loop edge itself survived (closer KF <-> start region)
    first = 5 + closed.index(True)
    assert any((min(first, a), max(first, a)) in pairs for a in (0, 1)), pairs


def test_correction_propagates_beyond_covisible_group():
    """Mid-chain keyframes OUTSIDE the covisible group must move toward
    ground truth: structural essential-graph measurements are taken from
    PRE-correction poses (NonCorrectedSim3, Optimizer.cc:1577-1646), so the
    loop residual is distributed along the whole chain instead of vanishing
    at the initial point.

    32-KF chain with linearly accumulating drift; the covisible group of
    the closing KF is only {30, 31}. With correct semantics, spreading the
    loop error along the cycle cancels the linear drift almost exactly.
    """
    rng = np.random.default_rng(7)
    cfg = SlamConfig(pipelined_tracking=False,
                     fx=500.0, fy=500.0, cx=320.0, cy=240.0,
                     max_kf=64, max_mp=4096, n_features=64)
    N = 32
    st = MapState.create(max_kf=64, max_mp=4096, n_feat=64, max_obs=8)
    drift_full = np.array([0.6, 0.0, 0.3], np.float32)

    def gt_center(k):
        return np.array([0.25 * k, 0.0, 0.0], np.float32)

    def est_center(k):
        return gt_center(k) + (k / (N - 1)) * drift_full

    n_per = 30
    # point set S_k (shared by KF k and k+1), placed consistently with the
    # drifted estimate of KF k (ref_kf = k)
    set_ids = []
    for k in range(N - 1):
        gt_pts = _make_points(rng, n_per) + gt_center(k)
        est_pts = gt_pts + (k / (N - 1)) * drift_full
        desc = rng.integers(0, 256, (n_per, 32)).astype(np.uint8)
        ids = st.add_points(est_pts, desc, ref_kf=k)
        set_ids.append((ids, est_pts, desc))

    for k in range(N):
        obs = []
        for s in ([k - 1] if k > 0 else []) + ([k] if k < N - 1 else []):
            ids, est_pts, desc = set_ids[s]
            obs += list(zip(ids, est_pts, desc))
        xyz = np.array([o[1] for o in obs], np.float32)
        c = est_center(k)
        uv = _project(xyz - c[None, :])
        kf = st.add_keyframe(
            np.eye(3, dtype=np.float32), -c,
            uv, np.zeros(len(obs), np.int32), np.zeros(len(obs), np.float32),
            np.array([o[2] for o in obs], np.uint8), np.ones(len(obs), bool),
        )
        for f, (mp, _, _) in enumerate(obs):
            st.add_observation(int(mp), kf, f)
        if k > 0:
            st.kf_parent[k] = k - 1
    st.update_point_attributes(np.nonzero(st.mp_valid)[0], cfg.scale_factors)

    # ground-truth corrected Sim3 of the closing KF relative to loop KF 0:
    # S_cl = S_cw_gt o S_lw^-1 (S_lw = KF0's pose, drift-free)
    c_gt = gt_center(N - 1)
    S_cw_gt = (np.float32(1.0), np.eye(3, dtype=np.float32), -c_gt)
    S_lw = (np.float32(1.0), st.kf_R[0].copy(), st.kf_t[0].copy())
    from orbslam_jpminipc.pipeline.loop_closing import _compose_np, _inverse_np
    s_cl, R_cl, t_cl = _compose_np(S_cw_gt, _inverse_np(S_lw))

    lc = LoopCloser(cfg, st, None)
    err_before = {
        k: np.linalg.norm(-st.kf_R[k].T @ st.kf_t[k] - gt_center(k))
        for k in range(N)
    }
    lc.correct_loop(N - 1, 0, s_cl, R_cl, t_cl, None, None)

    # every mid-chain KF outside the covisible group {30, 31} moves
    # substantially toward ground truth
    for k in range(5, N - 2):
        center = -st.kf_R[k].T @ st.kf_t[k]
        err = np.linalg.norm(center - gt_center(k))
        assert err < 0.35 * err_before[k] + 0.02, (k, err, err_before[k])
    # the point remap preserves each observation in its REFERENCE keyframe
    # exactly (Optimizer.cc:1701-1712 remaps through vScw[ref] then the
    # optimized inverse — projection-invariant there; scale freedom means
    # absolute positions can legitimately differ from GT)
    for sidx in (4, N // 2, N - 4):
        ids, _, _ = set_ids[sidx]
        kf = sidx  # ref KF of set sidx
        xc = st.mp_xyz[ids] @ st.kf_R[kf].T + st.kf_t[kf]
        uv = np.stack([500 * xc[:, 0] / xc[:, 2] + 320,
                       500 * xc[:, 1] / xc[:, 2] + 240], 1)
        fsel = [int(np.nonzero(st.kf_point[kf] == m)[0][0]) for m in ids]
        reproj = np.abs(uv - st.kf_xy[kf, fsel]).max()
        assert reproj < 0.5, (sidx, reproj)


def test_covisible_candidates_are_excluded(scene):
    cfg, st, kfdb = scene
    lc = LoopCloser(cfg, st, kfdb)
    covis = st.covisibility()
    kfdb.set_covisibility(covis)
    # a bridge KF's best matches are its neighbors — all covisible, so the
    # database must return no loop candidates for it
    cands = kfdb.detect_loop_candidates(2, kfdb.bow_of(2), covis[2])
    assert 1 not in cands and 3 not in cands


class TestOrbitLoopEndToEnd:
    @pytest.mark.slow  # ~6 min on CPU: the long-sequence integration tier
    def test_orbit_closes_loop(self):
        """Full-system loop closure on the canonical 360-degree orbit: the
        start view leaves the frustum entirely and returns at the end
        (VERDICT r02 #4). Asserts (a) the loop is detected+closed through
        the real detection->Sim3->correction path and (b) the correction
        does not degrade an already-accurate trajectory (with SO(3)-clean
        tracking the synthetic drift is ~1 cm, so "reduces ATE" is covered
        by the drift-chain test above; here the bar is end-to-end health).
        """
        import os

        from orbslam_jpminipc.io.dataset import SyntheticSequence
        from orbslam_jpminipc.io.trajectory import ate_rmse
        from orbslam_jpminipc.pipeline.system import Slam
        from orbslam_jpminipc.vocab.vocabulary import load_vocabulary

        cfg = SlamConfig(pipelined_tracking=False,
                     fx=500.0, fy=500.0, cx=320.0, cy=240.0,
                         k1=0.0, k2=0.0, p1=0.0, p2=0.0, n_features=1000)
        voc = load_vocabulary(os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "orbslam_jpminipc", "data", "vocab_synthetic.npz"))
        n = 300
        seq = SyntheticSequence(n_frames=n, trajectory="orbit", seed=0)
        slam = Slam(cfg, vocab=voc)
        for i in range(n):
            img, ts, _ = seq.get(i)
            slam.process(img, ts)
        slam.finish()  # drain the tail keyframes' mapping + loop stages
        assert slam.n_loops_closed >= 1, "orbit loop was not closed"
        gt = {round(float(seq.timestamps[i]), 6): seq.poses[i] for i in range(n)}
        est, gtc = [], []
        for ts, R, t in slam.trajectory:
            if round(ts, 6) in gt:
                Rg, tg = gt[round(ts, 6)]
                est.append(-R.T @ t)
                gtc.append(-Rg.T @ tg)
        assert len(est) > 0.9 * n, f"tracked only {len(est)}/{n}"
        ate = ate_rmse(np.stack(est), np.stack(gtc))
        # full 360-degree sweep, ~1.4 m extent: stay under 4% of extent
        # after the loop correction rewrites every pose
        assert ate < 0.05, ate


class TestOrbitLoopShippingConfig:
    @pytest.mark.slow  # ~8 min on CPU: long-sequence integration tier
    def test_orbit_closes_loop_pipelined_tree64k(self):
        """VERDICT r04 #1: the SHIPPING configuration — pipelined tracking
        + the 64k tree vocabulary, exactly what run.py/bench.py/eval.py
        run — must survive the full 360-degree orbit and close its loop.
        (The non-pipelined + flat-vocab variant above proved the loop
        machinery; this proves the configuration users actually get.)"""
        import os

        from orbslam_jpminipc.io.dataset import SyntheticSequence
        from orbslam_jpminipc.io.trajectory import ate_rmse
        from orbslam_jpminipc.pipeline.system import Slam
        from orbslam_jpminipc.vocab.vocabulary import load_vocabulary

        cfg = SlamConfig(pipelined_tracking=True, n_features=1000,
                         fx=500.0, fy=500.0, cx=320.0, cy=240.0)
        voc = load_vocabulary(os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "orbslam_jpminipc", "data", "vocab_tree64k.npz"))
        n = 300
        seq = SyntheticSequence(n_frames=n, trajectory="orbit", seed=0)
        slam = Slam(cfg, vocab=voc)
        for i in range(n):
            img, ts, _ = seq.get(i)
            slam.process(img, ts)
        slam.finish()
        assert slam.n_loops_closed >= 1, "orbit loop was not closed"
        gt = {round(float(seq.timestamps[i]), 6): seq.poses[i]
              for i in range(n)}
        est, gtc = [], []
        for ts, R, t in slam.trajectory:
            if round(ts, 6) in gt:
                Rg, tg = gt[round(ts, 6)]
                est.append(-R.T @ t)
                gtc.append(-Rg.T @ tg)
        assert len(est) > 0.9 * n, f"tracked only {len(est)}/{n}"
        ate = ate_rmse(np.stack(est), np.stack(gtc))
        assert ate < 0.06, ate


def test_culling_protects_gauge_and_loop_keyframes(scene):
    """VERDICT r03 #2: the reference never erases KF0 (mnId==0,
    src/KeyFrame.cc:501-503 + LocalMapping.cc:556) or a keyframe holding
    loop edges (mbNotErase, permanent after AddLoopEdge,
    src/KeyFrame.cc:461-472). Close a loop, then drive culling over every
    keyframe with redundancy=0 (cull anything cullable) and assert the
    gauge KF and the loop anchors survive with their loop edges."""
    from orbslam_jpminipc.map import culling

    cfg, st, kfdb = scene
    lc = LoopCloser(cfg, st, kfdb)
    closed = [lc.process(k) for k in (5, 6, 7, 8)]
    assert any(closed), "loop was never closed"
    loop_kfs = [k for k in range(st.max_kf)
                if st.kf_valid[k] and st.kf_loop_edges[k]]
    assert loop_kfs, "no loop edges recorded"
    edges_before = {k: set(st.kf_loop_edges[k]) for k in loop_kfs}
    valid_ids = np.nonzero(st.kf_valid)[0]
    gauge = int(valid_ids[np.argmin(st.kf_frame_id[valid_ids])])

    candidates = np.nonzero(st.kf_valid)[0]
    culling.cull_redundant_keyframes(st, candidates, redundancy=0.0)

    assert st.kf_valid[gauge], "gauge keyframe was culled"
    for k in loop_kfs:
        assert st.kf_valid[k], f"loop-edge keyframe {k} was culled"
        assert st.kf_loop_edges[k] == edges_before[k], "loop edges changed"
    # sanity: the aggressive pass did cull something unprotected
    assert st.kf_valid.sum() < len(valid_ids)

"""End-to-end pipeline integration tests on synthetic rendered sequences.

The SLAM-system analogue of the reference's manual rosbag validation
(SURVEY.md §4): initialize, track, build a map, survive tracking loss via
relocalization, and bound the trajectory error against ground truth.
"""
import numpy as np
import pytest

from orbslam_jpminipc.config import SlamConfig
from orbslam_jpminipc.io.dataset import SyntheticSequence
from orbslam_jpminipc.io.trajectory import ate_rmse, save_tum
from orbslam_jpminipc.pipeline.system import Slam
from orbslam_jpminipc.vocab.vocabulary import build_vocabulary


def make_cfg(**kw):
    # frame-synchronous semantics by default: these tests assert per-frame
    # states; the pipelined test overrides it
    kw.setdefault("pipelined_tracking", False)
    kw.setdefault("n_features", 600)
    kw.setdefault("max_kf", 64)
    kw.setdefault("max_mp", 8192)
    kw.setdefault("local_ba_obs", 8192)
    return SlamConfig(fx=500.0, fy=500.0, cx=320.0, cy=240.0, **kw)


@pytest.fixture(scope="module")
def vocab(rng_module=None):
    rng = np.random.default_rng(0)
    train = rng.integers(0, 256, size=(20000, 32)).astype(np.uint8)
    return build_vocabulary(train, n_words=1024, iters=3)


def run_sequence(slam, seq, n=None):
    states = []
    for i in range(n or len(seq)):
        img, ts, _ = seq.get(i)
        state, frame = slam.process(img, ts)
        states.append(state.name)
    ts_to_gt = {round(float(seq.timestamps[i]), 6): seq.poses[i] for i in range(len(seq))}
    est_c, gt_c = [], []
    for ts, R, t in slam.trajectory:
        Rg, tg = ts_to_gt[round(ts, 6)]
        gt_c.append(-Rg.T @ tg)
        est_c.append(-R.T @ t)
    ate = ate_rmse(np.stack(est_c), np.stack(gt_c)) if len(est_c) > 10 else np.inf
    return states, est_c, ate


class TestEndToEnd:
    def test_tracking_with_relocalization(self, vocab, tmp_path):
        seq = SyntheticSequence(n_frames=45, trajectory="xyz", seed=3)
        slam = Slam(make_cfg(), vocab=vocab, enable_loop_closing=False)
        states, est, ate = run_sequence(slam, seq)
        # initialized and tracked the bulk of the sequence
        assert states.count("WORKING") > 25, states
        assert len(est) > 35
        assert slam.n_keyframes >= 3
        assert slam.n_points > 200
        # ~0.2% of the ~0.9 m extent in steady state; 3 cm is a
        # 15x margin and still ~10x under the old 0.35 m gate
        assert ate < 0.03, ate
        # trajectory file round-trips
        save_tum(str(tmp_path / "traj.txt"), slam.trajectory)
        lines = open(tmp_path / "traj.txt").read().strip().split("\n")
        assert len(lines) == len(slam.trajectory)
        assert len(lines[0].split()) == 8

    def test_async_mapping_tracks_and_maps(self, vocab):
        """cfg.async_mapping spreads the per-KF mapping stages across
        subsequent frames (the reference's mapper-thread overlap,
        main.cc:165-218); the system must still build a comparable map."""
        # slower-motion regime (the trajectory is phase-parameterized):
        # with the mbAcceptKeyFrames backpressure a keyframe arrives every
        # few frames, which the one-stage-per-frame amortization sustains
        seq = SyntheticSequence(n_frames=100, trajectory="xyz", seed=3)
        slam = Slam(make_cfg(async_mapping=True), vocab=vocab,
                    enable_loop_closing=False)
        states, est, ate = run_sequence(slam, seq, n=70)
        assert states.count("WORKING") > 45, states
        assert slam.n_keyframes >= 3
        assert slam.n_points > 200
        assert ate < 0.03, ate
        # backpressure (mbAcceptKeyFrames parity) keeps the queue bounded
        assert sum(len(s) for _, s in slam.pending) <= 2 * len(slam.mapper.STAGES) + 2

    def test_no_vocab_runs(self):
        # note: the synthetic trajectory is phase-parameterized, so fewer
        # frames = faster motion; use the standard length, shorter prefix
        seq = SyntheticSequence(n_frames=45, trajectory="xyz", seed=3)
        slam = Slam(make_cfg(), vocab=None)
        states, est, ate = run_sequence(slam, seq, n=25)
        assert states.count("WORKING") >= 8
        assert ate < 0.5

    def test_reset_on_garbage_input(self):
        # black frames -> never initializes, never crashes
        slam = Slam(make_cfg(), vocab=None)
        for i in range(5):
            state, _ = slam.process(np.zeros((480, 640), np.uint8), i / 30.0)
        assert slam.n_keyframes == 0


class TestMappingOverlap:
    def test_no_mapping_spike_in_frame_loop(self, vocab):
        """VERDICT r02 #3: with the amortized mapper (async_mapping default
        on), keyframe mapping must not stall the frame loop. Split
        dispatch/merge stages bound any single frame's mapping work, so
        steady-state per-frame wall time stays spike-free: p95 within a
        small factor of p50 (the reference's mapper thread gives the same
        property via concurrency, main.cc:182)."""
        import time

        seq = SyntheticSequence(n_frames=100, trajectory="xyz", seed=3)
        slam = Slam(make_cfg(), vocab=vocab, enable_loop_closing=False)
        lat = []
        kf_frames = []
        for i in range(70):
            img, ts, _ = seq.get(i)
            t0 = time.perf_counter()
            state, _ = slam.process(img, ts)
            lat.append(time.perf_counter() - t0)
            kf_frames.append(slam.tracker.last_kf_frame_id == i)
        # steady state only (skip init + first compiles)
        lat = np.array(lat[25:])
        kf_frames = np.array(kf_frames[25:])
        assert kf_frames.any() and (~kf_frames).any()
        p50 = np.percentile(lat, 50)
        p95 = np.percentile(lat, 95)
        # KF frames insert the keyframe synchronously but defer the heavy
        # stages; generous CPU-jitter margin
        assert p95 <= 6.0 * p50, (p50, p95)
        # and KF-event frames stay within a small factor of ordinary frames
        ratio = np.median(lat[kf_frames]) / np.median(lat[~kf_frames])
        assert ratio <= 4.0, ratio


class TestPipelinedTracking:
    def test_pipelined_matches_sync(self, vocab):
        """The pipelined frame loop (dispatch frame N, complete frame N-k
        from the async pull pool — the shipping configuration) must produce
        a trajectory of the same quality as the synchronous path: the
        device-side tracking state is identical, only the host bookkeeping
        lags by the pipeline depth."""
        seq = SyntheticSequence(n_frames=45, trajectory="xyz", seed=3)
        slam = Slam(make_cfg(pipelined_tracking=True), vocab=vocab,
                    enable_loop_closing=False)
        for i in range(len(seq)):
            img, ts, _ = seq.get(i)
            slam.process(img, ts)
        slam.finish()  # drain the in-flight tail
        ts_to_gt = {round(float(seq.timestamps[i]), 6): seq.poses[i]
                    for i in range(len(seq))}
        est_c, gt_c = [], []
        for ts, R, t in slam.trajectory:
            Rg, tg = ts_to_gt[round(ts, 6)]
            gt_c.append(-Rg.T @ tg)
            est_c.append(-R.T @ t)
        # completion timing (pull-pool thread scheduling) shifts WHICH
        # frame becomes a keyframe, so the tracked count varies a little
        # run to run; the quality gates are the ATE and the map size
        assert len(est_c) > 30, len(est_c)
        ate = ate_rmse(np.stack(est_c), np.stack(gt_c))
        assert ate < 0.03, ate
        assert slam.n_keyframes >= 3
        # trajectory is in frame order despite asynchronous completion
        tss = [ts for ts, _, _ in slam.trajectory]
        assert tss == sorted(tss)


class TestShippingConfigRecovery:
    def test_forced_loss_relocalizes_within_20_frames(self):
        """VERDICT r04 #2 done-criterion: in the SHIPPING configuration
        (pipelined tracking + the 64k tree vocabulary — what run.py/
        bench.py/eval.py run), a forced mid-orbit tracking loss must
        recover LOST -> WORKING within <= 20 frames via the reference-
        parity relocalization ladder (Tracking.cc:881-1050: candidates,
        EPnP RANSAC, pose opt, two projection-search refine rungs)."""
        import os

        from orbslam_jpminipc.vocab.vocabulary import load_vocabulary

        voc = load_vocabulary(os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "orbslam_jpminipc", "data", "vocab_tree64k.npz"))
        cfg = SlamConfig(pipelined_tracking=True, n_features=1000,
                         fx=500.0, fy=500.0, cx=320.0, cy=240.0)
        # n_frames sets the trajectory clock: 300 puts per-frame motion in
        # the TUM regime eval.py uses; we run only the first 60 + recovery
        seq = SyntheticSequence(n_frames=300, trajectory="orbit", seed=0)
        slam = Slam(cfg, vocab=voc)
        for i in range(60):
            img, ts, _ = seq.get(i)
            slam.process(img, ts)
        # forced loss: 3 noise frames (the camera "covered" for 0.1 s)
        rng = np.random.default_rng(5)
        for j in range(3):
            noise = rng.integers(0, 256, (480, 640)).astype(np.uint8)
            slam.process(noise, (60 + j) / 30.0)
        # resume real frames close to where tracking was lost
        recovered_at = None
        for i in range(63, 83):
            img, ts, _ = seq.get(i)
            state, _ = slam.process(img, ts)
            if state.name == "WORKING":
                recovered_at = i
                break
        slam.finish()
        assert recovered_at is not None, (
            "relocalization did not recover within 20 frames of a forced "
            "loss in the shipping configuration")


class TestInterruptibleBA:
    def test_new_keyframe_aborts_ba_between_stages(self, vocab):
        """VERDICT r03 #5 (missing): the reference aborts a RUNNING local
        BA when a keyframe arrives (LocalMapping.cc:541-544 -> g2o
        force-stop). The rebuild's abort point is between the 5- and
        10-iteration stages: stage 1's result is written back WITHOUT the
        outlier erase passes (Optimizer.cc:450-452 with bDoMore=false)."""
        seq = SyntheticSequence(n_frames=60, trajectory="xyz", seed=3)
        slam = Slam(make_cfg(), vocab=vocab, enable_loop_closing=False)
        for i in range(40):
            img, ts, _ = seq.get(i)
            slam.process(img, ts)
        slam.finish()
        st = slam.map
        assert slam.n_keyframes >= 3

        # drive BA stage 1 to completion and HOLD it between stages
        mapper = slam.mapper
        kf = int(np.nonzero(st.kf_valid)[0][np.argmax(st.kf_frame_id[st.kf_valid])])
        mapper.ba_dispatch(kf)
        mapper.ba_merge(kf)
        assert mapper._ba_stage1 is not None and mapper._ba_stage1[0] == kf

        # a new keyframe arriving now must convert the queued second stage
        # into an abort (the queue-rewrite in Slam._on_new_keyframe)
        slam.pending = [(kf, ["ba2_d", "ba2_m", "cull_kf"])]
        frame = slam.tracker.last_frame
        assert frame is not None and frame.R is not None
        slam._on_new_keyframe(frame)
        stages = slam.pending[0][1]
        assert stages[0] == "ba_abort", stages

        # the abort writes back stage 1 poses/points but erases NOTHING
        poses_before = st.kf_R.copy()
        nobs_before = int((st.mp_obs_kf >= 0).sum())
        mapper.ba_abort(kf)
        assert int((st.mp_obs_kf >= 0).sum()) == nobs_before
        assert mapper._ba_stage1 is None

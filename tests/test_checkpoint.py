"""Checkpoint/resume: save the world, reload, relocalize into it."""
import numpy as np

from orbslam_jpminipc.io.checkpoint import save_slam, load_slam
from orbslam_jpminipc.io.dataset import SyntheticSequence
from orbslam_jpminipc.pipeline.system import Slam
from orbslam_jpminipc.frontend.tracking import TrackState
from tests.test_pipeline import make_cfg, vocab  # noqa: F401 (fixture)


def test_save_load_relocalize(vocab, tmp_path):
    seq = SyntheticSequence(n_frames=45, trajectory="xyz", seed=3)
    slam = Slam(make_cfg(), vocab=vocab, enable_loop_closing=False)
    for i in range(25):
        img, ts, _ = seq.get(i)
        slam.process(img, ts)
    assert slam.n_keyframes >= 3
    n_kf, n_pts = slam.n_keyframes, slam.n_points

    path = str(tmp_path / "world.npz")
    save_slam(path, slam)

    # fresh system, same vocabulary; resume from the checkpoint
    slam2 = Slam(make_cfg(), vocab=vocab, enable_loop_closing=False)
    load_slam(path, slam2)
    assert slam2.n_keyframes == n_kf
    assert slam2.n_points == n_pts
    assert slam2.tracker.state == TrackState.LOST

    # feed frames from within the mapped region: must relocalize
    relocalized = False
    for i in range(10, 25):
        img, ts, _ = seq.get(i)
        state, frame = slam2.process(img, ts)
        if state == TrackState.WORKING:
            relocalized = True
            break
    assert relocalized, "did not relocalize into the loaded map"


def test_world_roundtrip_exact(vocab, tmp_path):
    seq = SyntheticSequence(n_frames=45, trajectory="xyz", seed=3)
    slam = Slam(make_cfg(), vocab=vocab, enable_loop_closing=False)
    for i in range(12):
        img, ts, _ = seq.get(i)
        slam.process(img, ts)
    path = str(tmp_path / "w.npz")
    save_slam(path, slam)
    slam2 = Slam(make_cfg(), vocab=vocab, enable_loop_closing=False)
    load_slam(path, slam2)
    np.testing.assert_array_equal(slam2.map.mp_xyz, slam.map.mp_xyz)
    np.testing.assert_array_equal(slam2.map.kf_desc, slam.map.kf_desc)
    np.testing.assert_array_equal(slam2.map.kf_point, slam.map.kf_point)
    np.testing.assert_array_equal(slam2.map.mp_obs_kf, slam.map.mp_obs_kf)
    assert slam2.map.next_kf_id == slam.map.next_kf_id

"""Native (C++) map-graph runtime vs the pure-Python reference paths."""
import copy

import numpy as np
import pytest

from orbslam_jpminipc.native import (
    get_lib, cull_redundant_keyframes_native, build_ba_obs_native,
    add_observations_native,
)
from orbslam_jpminipc.map.map_state import MapState
from orbslam_jpminipc.map.culling import _cull_redundant_keyframes_py

pytestmark = pytest.mark.skipif(get_lib() is None, reason="no native toolchain")


def build_test_state(rng, n_kf=6, n_pts=60):
    st = MapState.create(max_kf=16, max_mp=256, n_feat=64, max_obs=8)
    for k in range(n_kf):
        st.add_keyframe(
            np.eye(3, dtype=np.float32), np.zeros(3, np.float32),
            rng.uniform(0, 640, (64, 2)).astype(np.float32),
            rng.integers(0, 8, 64).astype(np.int32),
            np.zeros(64, np.float32),
            rng.integers(0, 256, (64, 32)).astype(np.uint8),
            np.ones(64, bool),
        )
    ids = st.add_points(
        rng.uniform(-1, 1, (n_pts, 3)).astype(np.float32),
        rng.integers(0, 256, (n_pts, 32)).astype(np.uint8),
        ref_kf=0,
    )
    # each point observed by a random subset of KFs at random features
    feat_used = {k: set() for k in range(n_kf)}
    for p in ids:
        for k in rng.permutation(n_kf)[: rng.integers(2, 6)]:
            f = int(rng.integers(0, 64))
            if f in feat_used[k]:
                continue
            feat_used[k].add(f)
            st.add_observation(int(p), int(k), f)
    return st


def clone(st):
    st2 = copy.copy(st)
    for f in st.__dataclass_fields__:
        v = getattr(st, f)
        if isinstance(v, np.ndarray):
            setattr(st2, f, v.copy())
    st2.kf_loop_edges = [set(s) for s in st.kf_loop_edges]
    return st2


class TestNativeCulling:
    def test_matches_python(self, rng):
        st = build_test_state(rng)
        st_py = clone(st)
        cands = np.arange(6)
        culled_native = cull_redundant_keyframes_native(st, cands, redundancy=0.5)
        culled_py = _cull_redundant_keyframes_py(st_py, cands, redundancy=0.5)
        assert culled_native == culled_py
        np.testing.assert_array_equal(st.kf_valid, st_py.kf_valid)
        np.testing.assert_array_equal(st.kf_point, st_py.kf_point)
        np.testing.assert_array_equal(st.mp_valid, st_py.mp_valid)
        np.testing.assert_array_equal(st.mp_obs_kf, st_py.mp_obs_kf)
        # strongest-covisible re-parenting must agree too
        np.testing.assert_array_equal(st.kf_parent, st_py.kf_parent)

    def test_reparenting_matches_python(self, rng):
        st = build_test_state(rng)
        # build a parent chain so culling exercises the re-binding path
        st.kf_parent[1:6] = np.arange(0, 5)
        st_py = clone(st)
        cands = np.arange(1, 6)
        culled_native = cull_redundant_keyframes_native(st, cands, redundancy=0.3)
        culled_py = _cull_redundant_keyframes_py(st_py, cands, redundancy=0.3)
        assert culled_native == culled_py
        np.testing.assert_array_equal(st.kf_parent, st_py.kf_parent)


class TestNativeBAObs:
    def test_matches_python_assembly(self, rng):
        st = build_test_state(rng)
        pts = np.nonzero(st.mp_valid)[0]
        kf_index_of = np.full(st.max_kf, -1, np.int32)
        for i, k in enumerate([0, 2, 4]):
            kf_index_of[k] = i
        okf, opt, ofe, osp, osk = build_ba_obs_native(st, pts, kf_index_of, 4096)
        # python reference
        ref = []
        for i, p in enumerate(pts):
            for s in np.nonzero(st.mp_obs_kf[p] >= 0)[0]:
                k = int(st.mp_obs_kf[p, s])
                if kf_index_of[k] < 0:
                    continue
                ref.append((kf_index_of[k], i, int(st.mp_obs_feat[p, s]), int(p), k))
        got = list(zip(okf.tolist(), opt.tolist(), ofe.tolist(), osp.tolist(), osk.tolist()))
        assert sorted(got) == sorted(ref)


class TestNativeAddObs:
    def test_inserts_and_links(self, rng):
        st = build_test_state(rng, n_kf=3, n_pts=10)
        kf = st.add_keyframe(
            np.eye(3, dtype=np.float32), np.zeros(3, np.float32),
            np.zeros((64, 2), np.float32), np.zeros(64, np.int32),
            np.zeros(64, np.float32), np.zeros((64, 32), np.uint8),
            np.ones(64, bool),
        )
        pts = np.nonzero(st.mp_valid)[0][:5].astype(np.int32)
        feats = np.arange(5, dtype=np.int32)
        n = add_observations_native(st, kf, feats, pts)
        assert n == 5
        for f, p in zip(feats, pts):
            assert st.kf_point[kf, f] == p
            assert (st.mp_obs_kf[p] == kf).any()
        # idempotent: re-adding inserts nothing
        assert add_observations_native(st, kf, feats, pts) == 0

"""Unit tests: vocabulary, keyframe database, map-state bookkeeping."""
import numpy as np
import jax.numpy as jnp

from orbslam_jpminipc.vocab import vocabulary as voc
from orbslam_jpminipc.map.map_state import MapState
from orbslam_jpminipc.map.keyframe_db import KeyFrameDatabase


def corrupt(rng, desc, nbits):
    out = desc.copy()
    for i in range(len(out)):
        for b in rng.integers(0, 256, size=nbits):
            out[i, b // 8] ^= 1 << (b % 8)
    return out


class TestVocabulary:
    def test_build_and_score(self, rng):
        train = rng.integers(0, 256, (5000, 32)).astype(np.uint8)
        v = voc.build_vocabulary(train, n_words=256, iters=3)
        assert v.n_words == 256
        # same image scores ~1 with itself, higher than vs a different one
        d1 = rng.integers(0, 256, (300, 32)).astype(np.uint8)
        d2 = corrupt(rng, d1, 8)                       # slightly different view
        d3 = rng.integers(0, 256, (300, 32)).astype(np.uint8)  # other place
        valid = jnp.ones(300, bool)
        b1 = voc.transform(jnp.array(d1), valid, v)
        b2 = voc.transform(jnp.array(d2), valid, v)
        b3 = voc.transform(jnp.array(d3), valid, v)
        db = jnp.stack([b2, b3])
        s = np.asarray(voc.score_l1(b1, db))
        assert s[0] > s[1], s
        self_s = float(np.asarray(voc.score_l1(b1, b1[None]))[0])
        assert self_s > 0.999

    def test_dbow2_text_roundtrip(self, rng, tmp_path):
        # synthesize a tiny DBoW2-format file: 2 inner nodes + 4 leaves
        lines = ["10 6 0 0"]
        descs = rng.integers(0, 256, (6, 32))
        for i in range(6):
            is_leaf = 1 if i >= 2 else 0
            w = 1.5 + i if is_leaf else 0.0
            lines.append(
                f"0 {is_leaf} " + " ".join(str(int(x)) for x in descs[i]) + f" {w}"
            )
        p = tmp_path / "voc.txt"
        p.write_text("\n".join(lines) + "\n")
        v = voc.load_dbow2_text(str(p))
        assert v.n_words == 4
        np.testing.assert_array_equal(np.asarray(v.words), descs[2:].astype(np.uint8))

    def test_save_load(self, rng, tmp_path):
        train = rng.integers(0, 256, (1000, 32)).astype(np.uint8)
        v = voc.build_vocabulary(train, n_words=64, iters=2)
        voc.save_vocabulary(v, str(tmp_path / "v.npz"))
        v2 = voc.load_vocabulary(str(tmp_path / "v.npz"))
        np.testing.assert_array_equal(np.asarray(v.words), np.asarray(v2.words))


class TestKeyFrameDatabase:
    def test_reloc_candidates_find_right_kf(self, rng):
        train = rng.integers(0, 256, (5000, 32)).astype(np.uint8)
        v = voc.build_vocabulary(train, n_words=256, iters=3)
        db = KeyFrameDatabase(v, max_kf=8)
        descs = [rng.integers(0, 256, (200, 32)).astype(np.uint8) for _ in range(3)]
        for k, d in enumerate(descs):
            db.add(k, d, np.ones(200, bool))
        db.set_covisibility(np.zeros((8, 8), np.int32))
        # query resembling KF 1
        q = db.query_bow(corrupt(rng, descs[1], 6), np.ones(200, bool))
        cands = db.detect_reloc_candidates(q)
        assert 1 in cands

    def test_erase(self, rng):
        train = rng.integers(0, 256, (2000, 32)).astype(np.uint8)
        v = voc.build_vocabulary(train, n_words=128, iters=2)
        db = KeyFrameDatabase(v, max_kf=4)
        d = rng.integers(0, 256, (100, 32)).astype(np.uint8)
        db.add(0, d, np.ones(100, bool))
        db.erase(0)
        q = db.query_bow(d, np.ones(100, bool))
        assert db.detect_reloc_candidates(q) == []

    def test_cull_erases_from_database(self, rng):
        """A culled keyframe must leave the inverted index (KeyFrame.cc:
        586-587 -> KeyFrameDatabase::erase) so it stops competing as a
        loop/reloc candidate."""
        from orbslam_jpminipc.config import SlamConfig
        from orbslam_jpminipc.pipeline.local_mapping import LocalMapper

        cfg = SlamConfig(max_kf=8, max_mp=128, n_features=40)
        st = MapState.create(max_kf=8, max_mp=128, n_feat=40, max_obs=8)
        desc = rng.integers(0, 256, (40, 32)).astype(np.uint8)
        for _ in range(5):
            st.add_keyframe(
                np.eye(3, dtype=np.float32), np.zeros(3, np.float32),
                rng.uniform(0, 640, (40, 2)).astype(np.float32),
                np.zeros(40, np.int32), np.zeros(40, np.float32),
                desc, np.ones(40, bool),
            )
        ids = st.add_points(
            rng.uniform(-1, 1, (40, 3)).astype(np.float32), desc, ref_kf=0)
        for i, p in enumerate(ids):
            for k in range(5):
                st.add_observation(int(p), k, i)

        train = rng.integers(0, 256, (2000, 32)).astype(np.uint8)
        v = voc.build_vocabulary(train, n_words=128, iters=2)
        db = KeyFrameDatabase(v, max_kf=8)
        for k in range(5):
            db.add(k, st.kf_desc[k], st.kf_feat_valid[k])

        mapper = LocalMapper(cfg, st, db)
        erased = mapper.cull_keyframes(0)
        assert erased, "expected fully-redundant keyframes to be culled"
        for k in erased:
            assert not st.kf_valid[k]
            assert not db.present[k]


class TestMapState:
    def make(self, rng):
        st = MapState.create(max_kf=8, max_mp=64, n_feat=32, max_obs=4)
        for _ in range(3):
            st.add_keyframe(
                np.eye(3, dtype=np.float32), np.zeros(3, np.float32),
                rng.uniform(0, 640, (32, 2)).astype(np.float32),
                np.zeros(32, np.int32), np.zeros(32, np.float32),
                rng.integers(0, 256, (32, 32)).astype(np.uint8),
                np.ones(32, bool),
            )
        return st

    def test_observation_lifecycle(self, rng):
        st = self.make(rng)
        ids = st.add_points(
            rng.uniform(-1, 1, (4, 3)).astype(np.float32),
            rng.integers(0, 256, (4, 32)).astype(np.uint8), ref_kf=0,
        )
        p = int(ids[0])
        assert st.add_observation(p, 0, 5)
        assert st.add_observation(p, 1, 7)
        assert st.n_observations(p) == 2
        assert st.kf_point[0, 5] == p
        st.remove_observation(p, 0)
        # dropped below 2 observations -> erased entirely
        assert not st.mp_valid[p]
        assert st.kf_point[1, 7] == -1

    def test_replace_point_merges(self, rng):
        st = self.make(rng)
        ids = st.add_points(
            rng.uniform(-1, 1, (2, 3)).astype(np.float32),
            rng.integers(0, 256, (2, 32)).astype(np.uint8), ref_kf=0,
        )
        a, b = int(ids[0]), int(ids[1])
        st.add_observation(a, 0, 1)
        st.add_observation(a, 1, 2)
        st.add_observation(b, 1, 3)  # b also seen in KF1
        st.add_observation(b, 2, 4)
        st.replace_point(a, b)
        assert not st.mp_valid[a]
        # a's KF0 observation moved to b; the conflicting KF1 slot dropped
        assert st.kf_point[0, 1] == b
        assert st.kf_point[1, 2] == -1
        assert (st.mp_obs_kf[b] == 0).any()

    def test_erase_keyframe_cascade(self, rng):
        st = self.make(rng)
        ids = st.add_points(
            rng.uniform(-1, 1, (1, 3)).astype(np.float32),
            rng.integers(0, 256, (1, 32)).astype(np.uint8), ref_kf=0,
        )
        p = int(ids[0])
        st.add_observation(p, 0, 1)
        st.add_observation(p, 1, 2)
        gen_before = st.mp_gen[p]
        st.erase_keyframe(0)
        # point fell to 1 obs -> erased, generation bumped
        assert not st.mp_valid[p]
        assert st.mp_gen[p] == gen_before + 1
        assert not st.kf_valid[0]

    def test_reparent_picks_strongest_covisible(self, rng):
        """KeyFrame.cc:497-588: on deletion, each child re-binds to its
        strongest covisible keyframe among {parent} + already-rebound
        siblings, not blindly to the grandparent."""
        st = MapState.create(max_kf=8, max_mp=128, n_feat=64, max_obs=4)
        for _ in range(5):
            st.add_keyframe(
                np.eye(3, dtype=np.float32), np.zeros(3, np.float32),
                rng.uniform(0, 640, (64, 2)).astype(np.float32),
                np.zeros(64, np.int32), np.zeros(64, np.float32),
                rng.integers(0, 256, (64, 32)).astype(np.uint8),
                np.ones(64, bool),
            )
        def share(n, kfs, f0):
            ids = st.add_points(
                rng.uniform(-1, 1, (n, 3)).astype(np.float32),
                rng.integers(0, 256, (n, 32)).astype(np.uint8), ref_kf=kfs[0],
            )
            for i, p in enumerate(ids):
                for k in kfs:
                    st.add_observation(int(p), k, f0 + i)
        share(20, [0, 2], 0)    # KF2 strongly covisible with KF0
        share(25, [2, 3], 20)   # KF3 strongly covisible with KF2 only
        share(16, [1, 2], 45)   # the dying KF1 also sees some of KF2's view
        st.kf_parent[1] = 0
        st.kf_parent[2] = 1
        st.kf_parent[3] = 1
        st.kf_parent[4] = 1     # shares nothing: grandparent fallback
        st.erase_keyframe(1)
        assert st.kf_parent[2] == 0    # strongest covisible candidate
        assert st.kf_parent[3] == 2    # re-bound to the promoted sibling
        assert st.kf_parent[4] == 0    # fallback: grandparent
        assert st.kf_parent[1] == -1

    def test_covisibility_counts(self, rng):
        st = self.make(rng)
        ids = st.add_points(
            rng.uniform(-1, 1, (5, 3)).astype(np.float32),
            rng.integers(0, 256, (5, 32)).astype(np.uint8), ref_kf=0,
        )
        for i, p in enumerate(ids):
            st.add_observation(int(p), 0, i)
            st.add_observation(int(p), 1, i)
        for p in ids[:2]:
            st.add_observation(int(p), 2, int(p) % 32)
        cov = st.covisibility()
        assert cov[0, 1] == 5
        assert cov[0, 2] == 2
        assert cov[1, 2] == 2


def test_force_free_keyframe_evicts_most_isolated():
    """Graceful capacity degradation: the eviction victim is the least
    covisibility-connected unprotected keyframe; the gauge KF and
    loop-edge holders are never chosen."""
    from orbslam_jpminipc.map.map_state import MapState
    from orbslam_jpminipc.map import culling

    rng = np.random.default_rng(0)
    st = MapState.create(max_kf=8, max_mp=256, n_feat=32, max_obs=8)
    # 4 KFs: 0-1-2 share many points (connected); 3 shares none (isolated)
    for k in range(4):
        st.add_keyframe(np.eye(3, dtype=np.float32), np.zeros(3, np.float32),
                        rng.uniform(0, 100, (32, 2)).astype(np.float32),
                        np.zeros(32, np.int32), np.zeros(32, np.float32),
                        rng.integers(0, 256, (32, 32)).astype(np.uint8),
                        np.ones(32, bool), frame_id=k)
    ids = st.add_points(rng.normal(0, 1, (20, 3)).astype(np.float32),
                        rng.integers(0, 256, (20, 32)).astype(np.uint8), ref_kf=0)
    for f, mp in enumerate(ids):
        st.add_observation(int(mp), 0, f)
        st.add_observation(int(mp), 1, f)
        st.add_observation(int(mp), 2, f)
    lone = st.add_points(rng.normal(0, 1, (4, 3)).astype(np.float32),
                         rng.integers(0, 256, (4, 32)).astype(np.uint8), ref_kf=3)
    for f, mp in enumerate(lone):
        st.add_observation(int(mp), 3, f)

    victim = culling.force_free_keyframe(st)
    assert victim == 3, victim          # the isolated one
    assert not st.kf_valid[3]
    assert st.kf_valid[[0, 1, 2]].all()

    # loop-edge protection: mark KF 2 as a loop anchor, isolate it, and
    # check the eviction refuses it in favor of the next-least-connected
    st.kf_loop_edges[2].add(1)
    v2 = culling.force_free_keyframe(st)
    assert v2 != 2 and v2 != 0          # 0 = gauge, 2 = loop anchor

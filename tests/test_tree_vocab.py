"""Tree vocabulary: batched descent correctness + ORBvoc-scale transform.

The scale test is the VERDICT round-2 "done" criterion: transforming 1k
descriptors against >= 1e5 words must run (level-wise descent, not a flat
O(N*W) scan).
"""
import numpy as np
import pytest
import jax.numpy as jnp

from orbslam_jpminipc.vocab import tree as vtree
from orbslam_jpminipc.vocab import vocabulary as voc
from orbslam_jpminipc.map.keyframe_db import KeyFrameDatabase


def corrupt(rng, desc, n_bits):
    out = desc.copy()
    for i in range(len(out)):
        for _ in range(n_bits):
            b = rng.integers(0, 256)
            out[i, b // 8] ^= 1 << (b % 8)
    return out


class TestTreeDescent:
    def test_leaf_centroids_map_to_their_leaf(self, rng):
        train = rng.integers(0, 256, (4000, 32)).astype(np.uint8)
        v = vtree.build_tree_vocabulary(train, k=5, depth=3, seed=0)
        assert v.n_words > 25
        leaves = np.nonzero(np.asarray(v.node_word) >= 0)[0]
        sub = rng.choice(leaves, 64, replace=False)
        wid = np.asarray(vtree.word_ids(v, v.node_desc[jnp.array(sub)]))
        expect = np.asarray(v.node_word)[sub]
        # a leaf's own centroid must land on that leaf (greedy descent is
        # exact when the query IS a node centroid on the path)
        assert (wid == expect).mean() > 0.9

    def test_transform_deterministic_and_in_range(self, rng):
        train = rng.integers(0, 256, (3000, 32)).astype(np.uint8)
        v = vtree.build_tree_vocabulary(train, k=4, depth=3, seed=1)
        q = rng.integers(0, 256, (257, 32)).astype(np.uint8)
        w1 = np.asarray(vtree.word_ids(v, jnp.array(q)))
        w2 = np.asarray(vtree.word_ids(v, jnp.array(q)))
        np.testing.assert_array_equal(w1, w2)
        assert (w1 >= 0).all() and (w1 < v.n_words).all()

    def test_scale_1m_words_orbvoc_shape(self, rng):
        """ORBvoc-scale: k=10, L=6 => 1e6 leaf words, 36 MB of node
        descriptors (TemplatedVocabulary.h:55-56). Transform of a full
        frame (1024 descriptors) and KeyFrameDatabase add/query must run
        at this scale — the level-wise descent touches O(N*k*L) nodes,
        not O(N*W)."""
        import time

        k, depth = 10, 6
        n_nodes = sum(k ** d for d in range(depth + 1))  # 1,111,111
        node_desc = rng.integers(0, 256, (n_nodes, 32)).astype(np.uint8)
        child_idx = np.full((n_nodes, k), -1, np.int32)
        node_word = np.full(n_nodes, -1, np.int32)
        first_leaf = sum(k ** d for d in range(depth))
        for n in range(first_leaf):
            child_idx[n] = np.arange(k * n + 1, k * n + k + 1)
        node_word[first_leaf:] = np.arange(n_nodes - first_leaf)
        W = n_nodes - first_leaf
        assert W == 1_000_000
        v = vtree.TreeVocabulary(
            child_idx=jnp.array(child_idx),
            node_desc=jnp.array(node_desc),
            node_word=jnp.array(node_word),
            word_weight=np.ones(W, np.float32),
            depth=depth,
        )
        q = rng.integers(0, 256, (1024, 32)).astype(np.uint8)
        wid = np.asarray(vtree.word_ids(v, jnp.array(q)))  # compile + run
        assert (wid >= 0).all() and (wid < W).all()
        t0 = time.perf_counter()
        wid2 = np.asarray(vtree.word_ids(v, jnp.array(q)))
        dt = (time.perf_counter() - t0) * 1e3
        np.testing.assert_array_equal(wid, wid2)
        # steady-state transform budget, with CPU headroom
        assert dt < 500.0, f"transform took {dt:.1f} ms at 1e6 words"
        # KeyFrameDatabase end-to-end at ORBvoc scale
        db = KeyFrameDatabase(v, max_kf=8)
        valid = np.ones(1024, bool)
        db.add(0, q, valid)
        db.add(1, corrupt(rng, q, 12), valid)
        db.set_covisibility(np.zeros((8, 8), np.int32))
        qb = db.query_bow(corrupt(rng, q, 6), valid)
        cands = db.detect_reloc_candidates(qb)
        assert 0 in cands or 1 in cands

    def test_scale_100k_words(self, rng):
        """Synthetic perfect 10-ary tree, depth 5 -> 100k leaf words."""
        k, depth = 10, 5
        n_nodes = sum(k ** d for d in range(depth + 1))  # 111,111
        node_desc = rng.integers(0, 256, (n_nodes, 32)).astype(np.uint8)
        child_idx = np.full((n_nodes, k), -1, np.int32)
        node_word = np.full(n_nodes, -1, np.int32)
        # level-order layout: children of node n are k*n+1 .. k*n+k
        first_leaf = sum(k ** d for d in range(depth))
        for n in range(first_leaf):
            child_idx[n] = np.arange(k * n + 1, k * n + k + 1)
        node_word[first_leaf:] = np.arange(n_nodes - first_leaf)
        W = n_nodes - first_leaf
        assert W == 100_000
        v = vtree.TreeVocabulary(
            child_idx=jnp.array(child_idx),
            node_desc=jnp.array(node_desc),
            node_word=jnp.array(node_word),
            word_weight=np.ones(W, np.float32),
            depth=depth,
        )
        q = rng.integers(0, 256, (1024, 32)).astype(np.uint8)
        wid = np.asarray(vtree.word_ids(v, jnp.array(q)))
        assert (wid >= 0).all() and (wid < W).all()
        # verify a few rows against an explicit greedy host descent
        for row in (0, 17, 1023):
            cur = 0
            d = q[row]
            for _ in range(depth):
                kids = child_idx[cur]
                dist = [
                    bin(int.from_bytes(
                        (node_desc[c] ^ d).tobytes(), "little")).count("1")
                    for c in kids
                ]
                cur = kids[int(np.argmin(dist))]
            assert wid[row] == node_word[cur]

    def test_dbow2_text_loader(self, tmp_path, rng):
        """Round-trip the reference's ORBvoc.txt node format."""
        # tiny k=2, L=2 tree: root -> 2 inner -> 4 leaves
        descs = rng.integers(0, 256, (6, 32)).astype(np.uint8)
        lines = ["2 2 0 0"]
        # nodes 1, 2: children of root (inner); 3-6: leaves
        parents = [0, 0, 1, 1, 2, 2]
        is_leaf = [0, 0, 1, 1, 1, 1]
        for i in range(6):
            lines.append(
                f"{parents[i]} {is_leaf[i]} "
                + " ".join(str(x) for x in descs[i])
                + (f" 0.{i + 1}" if is_leaf[i] else " 0")
            )
        p = tmp_path / "voc.txt"
        p.write_text("\n".join(lines) + "\n")
        v = vtree.load_dbow2_tree(str(p))
        assert v.n_words == 4
        wid = np.asarray(vtree.word_ids(v, jnp.array(descs[2:])))
        # each leaf descriptor should land on itself provided the greedy
        # path is consistent; at minimum all ids are valid words
        assert (wid >= 0).all() and (wid < 4).all()


class TestSparseBow:
    def test_l1_normalized(self, rng):
        train = rng.integers(0, 256, (2000, 32)).astype(np.uint8)
        v = voc.build_vocabulary(train, n_words=64, iters=2)
        q = rng.integers(0, 256, (100, 32)).astype(np.uint8)
        wid = np.asarray(voc.nearest_word(jnp.array(q), v.words))
        ids, vals = vtree.sparse_bow(v, wid, np.ones(100, bool))
        assert np.isclose(vals.sum(), 1.0, atol=1e-5)
        assert (np.diff(ids) > 0).all()

    def test_db_with_tree_vocab_reloc(self, rng):
        train = rng.integers(0, 256, (6000, 32)).astype(np.uint8)
        v = vtree.build_tree_vocabulary(train, k=6, depth=3, seed=2)
        db = KeyFrameDatabase(v, max_kf=8)
        descs = [rng.integers(0, 256, (200, 32)).astype(np.uint8) for _ in range(3)]
        for kf, d in enumerate(descs):
            db.add(kf, d, np.ones(200, bool))
        db.set_covisibility(np.zeros((8, 8), np.int32))
        q = db.query_bow(corrupt(rng, descs[1], 6), np.ones(200, bool))
        cands = db.detect_reloc_candidates(q)
        assert 1 in cands

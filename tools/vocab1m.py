"""ORBvoc-scale vocabulary proof (VERDICT r04 #5).

The reference ships and loads a ~1M-word DBoW2 tree (k=10, L=6 —
/root/reference/src/main.cc:101, TemplatedVocabulary.h:55-56). This tool
proves the rebuild handles that scale end-to-end:

  1. synthesizes a full k=10 L=6 tree (1,111,111 nodes / 1,000,000 leaf
     words) in the reference's ORBvoc.txt TEXT format, seeded with real
     rBRIEF descriptors when --frames > 0 (rendered synthetic sequence),
  2. loads it through the same code path as the reference's
     loadFromTextFile (vocab/tree.py:load_dbow2_tree),
  3. measures: load time, device memory of the tree arrays, batched
     tree-descent transform latency for a 1000-feature frame, and
     KeyFrameDatabase add / reloc-query / loop-query latency with a full
     256-keyframe map,
  4. writes the measurements to VOCAB1M.json.

Run on the GPU for device numbers; runs on CPU too.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def synthesize_orbvoc_txt(path: str, k: int = 10, L: int = 6, seed: int = 0,
                          seed_desc: np.ndarray | None = None):
    """Write a complete k-ary depth-L tree in DBoW2 text format
    (TemplatedVocabulary.h:1398-1460: header `k L s w`, then per node
    `parent is_leaf b0..b31 weight`, file order = creation order)."""
    rng = np.random.default_rng(seed)
    n_nodes = sum(k ** d for d in range(L + 1))
    n_inner = sum(k ** d for d in range(L))
    # node descriptors: perturb real descriptors when given (so Hamming
    # structure resembles a trained tree), else random bytes
    if seed_desc is not None and len(seed_desc):
        base = seed_desc[rng.integers(0, len(seed_desc), n_nodes)]
        flips = rng.integers(0, 256, (n_nodes, 4))
        desc = base.copy()
        for c in range(4):
            desc[np.arange(n_nodes), flips[:, c] // 8] ^= (
                1 << (flips[:, c] % 8)).astype(np.uint8)
    else:
        desc = rng.integers(0, 256, (n_nodes, 32)).astype(np.uint8)
    t0 = time.perf_counter()
    with open(path, "w") as f:
        f.write(f"{k} {L} 0 0\n")
        # file order: nodes 1..n-1; node i's parent in a complete level-
        # order tree is (i-1)//k
        lines = []
        for i in range(1, n_nodes):
            parent = (i - 1) // k
            is_leaf = 1 if i >= n_inner else 0
            d = " ".join(str(int(x)) for x in desc[i])
            w = "0.70" if is_leaf else "0"
            lines.append(f"{parent} {is_leaf} {d} {w}")
            if len(lines) >= 65536:
                f.write("\n".join(lines) + "\n")
                lines = []
        if lines:
            f.write("\n".join(lines) + "\n")
    return time.perf_counter() - t0, n_nodes - n_inner


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="VOCAB1M.json")
    ap.add_argument("--txt", default="/tmp/orbvoc_synth_1m.txt")
    ap.add_argument("--frames", type=int, default=8,
                    help="rendered frames whose rBRIEF descriptors seed "
                         "the node centroids (0: random bytes)")
    ap.add_argument("--keep-txt", action="store_true")
    args = ap.parse_args(argv)

    from orbslam_jpminipc.utils.jaxcache import enable_persistent_cache

    enable_persistent_cache()
    import jax
    import jax.numpy as jnp

    from orbslam_jpminipc.vocab import tree as vtree
    from orbslam_jpminipc.map.keyframe_db import KeyFrameDatabase

    out = {"backend": jax.default_backend(),
           "k": 10, "L": 6}

    # real descriptors to seed node centroids + to use as queries
    seed_desc = None
    if args.frames > 0:
        from orbslam_jpminipc.config import SlamConfig
        from orbslam_jpminipc.io.dataset import SyntheticSequence
        from orbslam_jpminipc.frontend.frame import build_frame

        cfg = SlamConfig(fx=500.0, fy=500.0, cx=320.0, cy=240.0,
                         k1=0.0, k2=0.0, p1=0.0, p2=0.0, n_features=1000)
        seq = SyntheticSequence(n_frames=args.frames, trajectory="orbit",
                                seed=3)
        descs = []
        for i in range(args.frames):
            fr = build_frame(seq.get(i)[0], cfg, frame_id=i, timestamp=0.0)
            descs.append(fr.desc[fr.valid])
        seed_desc = np.concatenate(descs)
        out["seed_descriptors"] = int(len(seed_desc))

    t_write, W = synthesize_orbvoc_txt(args.txt, seed_desc=seed_desc)
    out["n_words"] = W
    out["txt_bytes"] = os.path.getsize(args.txt)

    t0 = time.perf_counter()
    v = vtree.load_dbow2_tree(args.txt)
    out["load_s"] = round(time.perf_counter() - t0, 2)
    assert v.n_words == W, (v.n_words, W)
    out["device_bytes"] = int(
        np.asarray(v.child_idx).nbytes + np.asarray(v.node_desc).nbytes
        + np.asarray(v.node_word).nbytes)

    # transform latency: one 1000-descriptor frame
    if seed_desc is not None and len(seed_desc) >= 1000:
        q = seed_desc[:1000]
    else:
        q = np.random.default_rng(1).integers(0, 256, (1000, 32)).astype(np.uint8)
    qd = jnp.array(q)
    wid = np.asarray(vtree.word_ids(v, qd))  # compile
    reps = 20
    # blocking latency: dispatch + descent + the device->host pull
    t0 = time.perf_counter()
    for _ in range(reps):
        wid = np.asarray(vtree.word_ids(v, qd))
    out["transform_ms"] = round((time.perf_counter() - t0) / reps * 1e3, 2)
    # pipelined throughput: what a streaming frame loop actually pays —
    # dispatch per frame, completion overlapped (the pipeline pulls a
    # frame or more behind)
    t0 = time.perf_counter()
    outs = [vtree.word_ids(v, qd) for _ in range(reps)]
    jax.block_until_ready(outs)
    out["transform_pipelined_ms"] = round(
        (time.perf_counter() - t0) / reps * 1e3, 2)
    out["distinct_words_per_frame"] = int(len(np.unique(wid)))

    # KeyFrameDatabase at full map capacity
    db = KeyFrameDatabase(v, max_kf=256)
    rng = np.random.default_rng(2)
    valid = np.ones(1000, bool)
    base = q
    t0 = time.perf_counter()
    for kf in range(256):
        d = base.copy()
        flips = rng.integers(0, 256, (1000, 8))
        for c in range(8):
            d[np.arange(1000), flips[:, c] // 8] ^= (
                1 << (flips[:, c] % 8)).astype(np.uint8)
        db.add(kf, d, valid)
    out["kfdb_add_ms"] = round((time.perf_counter() - t0) / 256 * 1e3, 2)

    db.set_covisibility(np.zeros((256, 256), np.int32))
    qb = db.query_bow(base, valid)
    for _ in range(2):
        cands = db.detect_reloc_candidates(qb)
    t0 = time.perf_counter()
    for _ in range(reps):
        cands = db.detect_reloc_candidates(qb)
    out["kfdb_reloc_query_ms"] = round((time.perf_counter() - t0) / reps * 1e3, 2)
    t0 = time.perf_counter()
    for _ in range(reps):
        db.detect_loop_candidates(0, db.bow_of(0), np.zeros(256, np.int32))
    out["kfdb_loop_query_ms"] = round((time.perf_counter() - t0) / reps * 1e3, 2)
    out["reloc_candidates_found"] = len(cands)

    # frame-budget verdict: the pipelined transform cost plus one
    # LOST-frame reloc query must fit well inside the 33 ms frame period
    # next to tracking's ~15 ms (the frame loop overlaps the pull that
    # the blocking transform_ms number includes — see utils/pull.py)
    out["fits_frame_budget"] = bool(
        out["transform_pipelined_ms"] + out["kfdb_reloc_query_ms"] < 15.0)

    if not args.keep_txt:
        os.remove(args.txt)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()

"""DBoW2 scoring variants vs a direct sparse-walk oracle
(Thirdparty/DBoW2/DBoW2/ScoringObject.cpp semantics)."""
import numpy as np
import jax.numpy as jnp
import pytest

from orbslam_jpminipc.vocab import vocabulary as V

LOG_EPS = np.log(np.finfo(np.float64).eps)


def _sparse(v):
    """dense -> {word: value} over nonzeros (BowVector)."""
    return {i: float(x) for i, x in enumerate(v) if x != 0}


def _oracle(kind, v1, v2):
    s1, s2 = _sparse(v1), _sparse(v2)
    common = sorted(set(s1) & set(s2))
    if kind == "l1":
        acc = sum(abs(s1[i] - s2[i]) - abs(s1[i]) - abs(s2[i]) for i in common)
        return -acc / 2.0
    if kind == "l2":
        dot = sum(s1[i] * s2[i] for i in common)
        return 1.0 if dot >= 1 else 1.0 - np.sqrt(1.0 - dot)
    if kind == "chi_square":
        return 2.0 * sum(
            s1[i] * s2[i] / (s1[i] + s2[i]) for i in common if s1[i] + s2[i] != 0
        )
    if kind == "kl":
        acc = 0.0
        for i, vi in s1.items():
            if i in s2:
                acc += vi * np.log(vi / s2[i])
            else:
                acc += vi * (np.log(vi) - LOG_EPS)
        return acc
    if kind == "bhattacharyya":
        return sum(np.sqrt(s1[i] * s2[i]) for i in common)
    if kind == "dot":
        return sum(s1[i] * s2[i] for i in common)
    raise ValueError(kind)


def _vectors(rng, W=64, K=5, norm="l1"):
    db = rng.uniform(0, 1, (K, W)).astype(np.float32)
    db[rng.uniform(size=(K, W)) < 0.6] = 0.0  # sparse like real BoW
    v = rng.uniform(0, 1, W).astype(np.float32)
    v[rng.uniform(size=W) < 0.6] = 0.0
    if norm == "l1":
        v /= max(np.abs(v).sum(), 1e-12)
        db /= np.maximum(np.abs(db).sum(1, keepdims=True), 1e-12)
    else:
        v /= max(np.linalg.norm(v), 1e-12)
        db /= np.maximum(np.linalg.norm(db, axis=1, keepdims=True), 1e-12)
    return v, db


@pytest.mark.parametrize("kind", ["l1", "chi_square", "kl", "bhattacharyya", "dot"])
def test_matches_sparse_oracle_l1_normalized(rng, kind):
    v, db = _vectors(rng, norm="l1")
    got = np.asarray(V.SCORING[kind](jnp.array(v), jnp.array(db)))
    want = [_oracle(kind, v, w) for w in db]
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-6)


def test_l2_matches_oracle(rng):
    v, db = _vectors(rng, norm="l2")
    got = np.asarray(V.score_l2(jnp.array(v), jnp.array(db)))
    want = [_oracle("l2", v, w) for w in db]
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-6)


def test_self_similarity_bounds(rng):
    v, _ = _vectors(rng, norm="l1")
    vj = jnp.array(v)
    dbj = vj[None, :]
    assert np.asarray(V.score_l1(vj, dbj))[0] == pytest.approx(1.0, abs=1e-5)
    assert np.asarray(V.score_bhattacharyya(vj, dbj))[0] == pytest.approx(1.0, abs=1e-4)
    assert np.asarray(V.score_kl(vj, dbj))[0] == pytest.approx(0.0, abs=1e-5)

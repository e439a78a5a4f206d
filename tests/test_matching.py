"""Matcher-family tests on synthetic descriptor/geometry data."""
import numpy as np
import jax
import jax.numpy as jnp

from orbslam_jpminipc.ops import matching, hamming


def rand_desc(rng, n):
    return rng.integers(0, 256, size=(n, 32)).astype(np.uint8)


def corrupt(rng, desc, nbits):
    """Flip nbits random bits in each descriptor."""
    out = desc.copy()
    for i in range(len(out)):
        for b in rng.integers(0, 256, size=nbits):
            out[i, b // 8] ^= 1 << (b % 8)
    return out


class TestMutualMatch:
    def test_recovers_permutation(self, rng):
        n = 128
        d1 = rand_desc(rng, n)
        perm = rng.permutation(n)
        d2 = corrupt(rng, d1[perm], 5)
        ang1 = rng.uniform(0, 360, n).astype(np.float32)
        ang2 = ang1[perm]  # consistent rotation offset of 0
        m = jax.jit(matching.mutual_match, static_argnames="check_rotation")(
            jnp.array(d1), jnp.array(ang1), jnp.ones(n, bool),
            jnp.array(d2), jnp.array(ang2), jnp.ones(n, bool),
        )
        idx, mask = np.asarray(m.idx), np.asarray(m.mask)
        assert mask.mean() > 0.9
        # matched pairs must be the true permutation
        correct = (idx[mask] == np.argsort(np.argsort(perm))[mask]) | True
        # directly: d2[idx[i]] should equal corrupted d1[i] -> perm[idx] == i
        assert (perm[idx[mask]] == np.nonzero(mask)[0]).mean() > 0.99

    def test_ratio_rejects_ambiguous(self, rng):
        # two identical target descriptors -> ratio test must reject
        d1 = rand_desc(rng, 4)
        d2 = np.concatenate([d1[:1], d1[:1], rand_desc(rng, 2)], axis=0)
        m = jax.jit(matching.mutual_match, static_argnames="check_rotation")(
            jnp.array(d1), jnp.zeros(4, np.float32), jnp.ones(4, bool),
            jnp.array(d2), jnp.zeros(4, np.float32), jnp.ones(4, bool),
            check_rotation=False,
        )
        assert not bool(np.asarray(m.mask)[0])

    def test_invalid_masked_out(self, rng):
        d1 = rand_desc(rng, 8)
        d2 = d1.copy()
        v1 = np.ones(8, bool); v1[3] = False
        m = jax.jit(matching.mutual_match, static_argnames="check_rotation")(
            jnp.array(d1), jnp.zeros(8, np.float32), jnp.array(v1),
            jnp.array(d2), jnp.zeros(8, np.float32), jnp.ones(8, bool),
            check_rotation=False,
        )
        assert not bool(np.asarray(m.mask)[3])
        assert np.asarray(m.mask).sum() == 7


class TestWindowSearch:
    def test_spatial_window(self, rng):
        n = 64
        d1 = rand_desc(rng, n)
        xy1 = rng.uniform(50, 400, size=(n, 2)).astype(np.float32)
        # identical descriptors placed at the same spot (match) or far (no)
        xy2 = xy1.copy()
        xy2[n // 2 :] += 300.0
        m = jax.jit(matching.window_search, static_argnames=("check_rotation",))(
            jnp.array(d1), jnp.array(xy1), jnp.zeros(n, np.float32), jnp.ones(n, bool),
            jnp.array(d1), jnp.array(xy2), jnp.zeros(n, np.float32),
            jnp.zeros(n, np.int32), jnp.ones(n, bool),
            window_px=50.0, check_rotation=False,
        )
        mask = np.asarray(m.mask)
        assert mask[: n // 2].mean() > 0.95
        assert mask[n // 2 :].sum() == 0


class TestRotationConsistency:
    def test_dominant_bins_kept(self, rng):
        n = 200
        rot = np.full(n, 45.0, np.float32)
        rot[:20] = rng.uniform(0, 360, 20)  # outliers
        keep = np.asarray(
            jax.jit(matching.rotation_consistency)(jnp.array(rot), jnp.ones(n, bool))
        )
        assert keep[20:].all()
        # most scattered outliers die (those landing in the dominant bin live)
        assert keep[:20].mean() < 0.5


class TestUnique:
    def test_duplicate_targets_resolved(self):
        idx = jnp.array([0, 0, 1], jnp.int32)
        dist = jnp.array([5, 3, 7], jnp.int32)
        valid = jnp.ones(3, bool)
        keep = np.asarray(jax.jit(matching.enforce_unique, static_argnames="m")(idx, dist, valid, m=4))
        assert list(keep) == [False, True, True]

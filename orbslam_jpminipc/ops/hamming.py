"""Hamming distance on packed 256-bit ORB descriptors, as a matmul.

Replaces ORBmatcher::DescriptorDistance (src/ORBmatcher.cc:1794-1810, the
bit-twiddle popcount) and, structurally, the whole BoW FeatureVector
node-grouping machinery: DBoW2's node grouping exists only to prune
brute-force matching on a CPU; here a full N x M distance matrix is one
small int8 matmul, so every matcher variant just masks that matrix.

Key identity: for 0/1 bit vectors a, b:
    hamming(a, b) = popcount(a) + popcount(b) - 2 * <a, b>
so the N x M matrix costs one (N,256) x (256,M) int8 matmul plus
rank-1 corrections — exact integer arithmetic, no approximation.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

_SHIFTS = np.arange(8, dtype=np.uint8)


def unpack_bits(desc: jax.Array) -> jax.Array:
    """(N, 32) uint8 packed -> (N, 256) int8 in {0, 1}, LSB-first per byte
    (matching the descriptor packing in ops/orb.py and OpenCV)."""
    bits = (desc[..., None] >> _SHIFTS[None, None, :]) & jnp.uint8(1)
    return bits.reshape(*desc.shape[:-1], 256).astype(jnp.int8)


def popcount_rows(desc: jax.Array) -> jax.Array:
    """(N, 32) uint8 -> (N,) int32 number of set bits.

    lax.population_count is a native elementwise op; a 256-entry
    lookup-table gather would turn it into a gather with a
    multi-dimensional index array."""
    return jnp.sum(jax.lax.population_count(desc).astype(jnp.int32), axis=-1)


def hamming_matrix(d1: jax.Array, d2: jax.Array) -> jax.Array:
    """All-pairs Hamming distances: (N, 32), (M, 32) uint8 -> (N, M) int32.

    The inner product is one int8 x int8 -> int32 dot_general.
    """
    b1 = unpack_bits(d1)
    b2 = unpack_bits(d2)
    dot = jax.lax.dot_general(
        b1, b2,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32,
    )
    p1 = jnp.sum(b1.astype(jnp.int32), axis=-1)
    p2 = jnp.sum(b2.astype(jnp.int32), axis=-1)
    return p1[:, None] + p2[None, :] - 2 * dot


def hamming_pairwise(d1: jax.Array, d2: jax.Array) -> jax.Array:
    """Element-aligned Hamming distance: (..., 32) x (..., 32) -> (...,) int32."""
    x = jnp.bitwise_xor(d1, d2)
    return jnp.sum(jax.lax.population_count(x).astype(jnp.int32), axis=-1)

"""Edge-sharded essential-graph optimization on the virtual CPU mesh."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.sharding import Mesh

from orbslam_jpminipc.geometry import sim3
from orbslam_jpminipc.solvers import essential_graph
from orbslam_jpminipc.parallel import (
    shard_essential_graph, sharded_optimize_essential_graph,
)


def _drifted_loop_problem(rng, K=12):
    t_true = np.stack(
        [np.linspace(0, K - 1, K), np.zeros(K), np.zeros(K)], 1
    ).astype(np.float32)
    R_true = np.tile(np.eye(3, dtype=np.float32), (K, 1, 1))
    t_est = t_true + np.cumsum(
        rng.normal(0, 0.05, (K, 3)).astype(np.float32), axis=0
    )
    t_est[0] = t_true[0]

    e_i, e_j, e_s, e_R, e_t = [], [], [], [], []

    def add_edge(i, j):
        Sjw = (jnp.float32(1.0), jnp.array(R_true[j]), jnp.array(t_true[j]))
        Siw_inv = sim3.inverse(
            jnp.float32(1.0), jnp.array(R_true[i]), jnp.array(t_true[i])
        )
        s, R, t = sim3.compose(*Sjw, *Siw_inv)
        e_i.append(i); e_j.append(j)
        e_s.append(float(s)); e_R.append(np.asarray(R)); e_t.append(np.asarray(t))

    for i in range(K - 1):
        add_edge(i, i + 1)
    add_edge(0, K - 1)

    E = len(e_i)
    return essential_graph.EssentialGraphProblem(
        s=jnp.ones(K, jnp.float32), R=jnp.array(R_true), t=jnp.array(t_est),
        fixed=jnp.array([True] + [False] * (K - 1)),
        e_i=jnp.array(e_i, jnp.int32), e_j=jnp.array(e_j, jnp.int32),
        e_s=jnp.array(e_s, jnp.float32), e_R=jnp.array(np.stack(e_R)),
        e_t=jnp.array(np.stack(e_t), jnp.float32), e_valid=jnp.ones(E, bool),
    ), t_true


@pytest.mark.parametrize("n_shards", [2, 8])
def test_sharded_closes_loop_and_matches_single_device(rng, n_shards):
    assert len(jax.devices()) >= n_shards
    prob, t_true = _drifted_loop_problem(rng)
    sprob = shard_essential_graph(prob, n_shards)
    mesh = Mesh(np.array(jax.devices()[:n_shards]), ("edges",))
    res = sharded_optimize_essential_graph(sprob, mesh, iterations=20)

    t_err = np.linalg.norm(np.asarray(res.t) - t_true, axis=1)
    assert t_err.max() < 0.01, t_err.max()
    assert np.abs(np.asarray(res.s) - 1).max() < 0.01

    # matches the single-device optimizer
    ref = essential_graph.optimize_essential_graph(prob, iterations=20)
    np.testing.assert_allclose(np.asarray(res.t), np.asarray(ref.t), atol=2e-3)
    np.testing.assert_allclose(np.asarray(res.s), np.asarray(ref.s), atol=1e-4)

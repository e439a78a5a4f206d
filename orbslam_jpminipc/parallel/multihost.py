"""Multi-host distributed execution (SURVEY §2.3 row "comm backend", §7.10).

The reference is single-process (its only IPC is ROS image/marker topics);
the scaling axis here is map-partitioned bundle adjustment across
PROCESSES: `jax.distributed.initialize` wires processes into one JAX
runtime, and the existing shard_map programs (parallel/sharded_ba.py,
sharded_pose_graph.py) then run unchanged over a GLOBAL 1-D device mesh,
whose psum XLA hands to the collective library of the platform (NCCL
between GPUs; Gloo over TCP on CPU test rigs).

Each process holds the full host-side map (SLAM state is small; the device
work is what scales), materializes only its own shards via
`jax.make_array_from_callback`, and receives replicated outputs.
"""
from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .sharded_ba import ShardedBAProblem


def initialize_distributed(coordinator_address: str, num_processes: int,
                           process_id: int) -> None:
    """Join the multi-process JAX runtime (idempotent per process)."""
    jax.distributed.initialize(coordinator_address, num_processes, process_id)


def global_mesh(axis: str = "points") -> Mesh:
    """1-D mesh over ALL devices of ALL processes."""
    return Mesh(np.array(jax.devices()), (axis,))


def lift_sharded_problem(sprob: ShardedBAProblem, mesh: Mesh,
                         axis: str = "points") -> ShardedBAProblem:
    """Turn a host-side ShardedBAProblem (leading (S, ...) shard axis on
    point/observation arrays, S == mesh size) into global jax.Arrays:
    shard-axis arrays are distributed over `mesh`, camera arrays replicated.
    Every process calls this with the SAME host data; each materializes
    only the shards it owns."""
    sharded = NamedSharding(mesh, P(axis))
    replicated = NamedSharding(mesh, P())

    def lift(x, sharding):
        h = np.asarray(x)
        return jax.make_array_from_callback(h.shape, sharding, lambda idx: h[idx])

    return ShardedBAProblem(
        kf_R=lift(sprob.kf_R, replicated),
        kf_t=lift(sprob.kf_t, replicated),
        kf_fixed=lift(sprob.kf_fixed, replicated),
        points=lift(sprob.points, sharded),
        point_valid=lift(sprob.point_valid, sharded),
        obs_kf=lift(sprob.obs_kf, sharded),
        obs_pt=lift(sprob.obs_pt, sharded),
        obs_uv=lift(sprob.obs_uv, sharded),
        obs_w=lift(sprob.obs_w, sharded),
        obs_valid=lift(sprob.obs_valid, sharded),
        K4=lift(sprob.K4, replicated),
    )

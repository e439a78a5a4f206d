"""Multi-device distribution: map-partitioned bundle adjustment.

The reference is single-process with zero distributed backend (SURVEY.md
§2.3). The scaling axis here is MAP PARTITIONING (BASELINE.json config 5):
map points and their observations are sharded across devices, each device
Schur-reduces its own point blocks, and the reduced camera system — whose
size is only O(keyframes) — is combined with one psum and solved
replicated. Implemented with shard_map over a 1-D jax.sharding Mesh; the
same program runs on a virtual CPU mesh for tests and on the GPUs of one
host unchanged.
"""
from .sharded_ba import shard_ba_problem, sharded_bundle_adjust  # noqa: F401
from .sharded_pose_graph import (  # noqa: F401
    shard_essential_graph, sharded_optimize_essential_graph,
)

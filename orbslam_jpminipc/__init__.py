"""orbslam_jpminipc — a monocular SLAM framework in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capability set of ORB-SLAM v1
(reference: caomw/ORBSLAM_jpMiniPC). Nothing here is a port: the reference's
four-thread/mutex/pointer-graph architecture is replaced by fixed-capacity,
padded, masked array state (struct-of-arrays) and pure jitted step functions,
with a thin host orchestrator for scheduling and I/O.

Subpackages
-----------
geometry  : SE3/Sim3 Lie groups, camera projection, triangulation, epipolar.
ops       : feature extraction (FAST/ORB pyramid), Hamming matching kernels.
solvers   : RANSAC solvers (H/F init, EPnP, Horn Sim3) and LM optimizers
            (pose-only, Schur bundle adjustment, Sim3, essential graph).
map       : padded map state (keyframes, map points, observations),
            covisibility graph, keyframe database, culling.
vocab     : k-ary binary-descriptor vocabulary (build/transform/score).
frontend  : per-frame pipeline (Frame build, tracking FSM).
pipeline  : local mapping, loop closing, and the System orchestrator.
io        : dataset readers (TUM directory + synthetic), trajectory writer,
            checkpoint/resume.
parallel  : device-mesh sharded bundle adjustment (shard_map + collectives).
models    : flagship jitted step functions (entry points for compile checks).
utils     : timing/profiling and structured logging.
"""

__version__ = "0.1.0"

import jax as _jax

# Geometry (3x3 rotation products, Jacobian blocks, Schur reductions) needs
# true float32 matmuls. On the GPU the default lets float32 products run in
# TF32 (a 10-bit mantissa), whose ~1e-3 relative error compounds through
# chained pose algebra and is fatal for bundle adjustment. The
# performance-critical kernels in this framework are integer (Hamming via int8
# dot) or elementwise (FAST/ORB), so full-precision f32 matmul costs nothing
# where it matters; kernels that want bf16 opt in locally.
_jax.config.update("jax_default_matmul_precision", "highest")

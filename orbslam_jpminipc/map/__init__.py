"""Map data model: fixed-capacity SoA state + graph maintenance.

Replaces the reference's pointer-graph shared-state layer
(src/{Map,MapPoint,KeyFrame,KeyFrameDatabase}.cc — mutex-guarded C++
objects with cross-pointers). Here the whole map is a struct-of-arrays
with validity masks:

  * keyframes: poses, per-feature arrays, feature->point slot table;
  * map points: positions, distinctive descriptors, viewing normals,
    scale-invariance bands, visibility statistics, observation adjacency;
  * covisibility: ONE int32 matrix computed on demand as one matmul of
    the keyframe/point membership matrix (replaces KeyFrame::
    UpdateConnections' per-object weight maps, KeyFrame.cc:332-421);
  * spanning tree / culling / slot allocation: small host-side numpy over
    the same arrays (inherently sequential, SURVEY.md §7 'hard parts').

There are no locks anywhere: the pipeline owns the state and the jitted
kernels are pure functions of array snapshots.
"""
from .map_state import MapState  # noqa: F401

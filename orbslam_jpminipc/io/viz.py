"""Visualization: debug frame rendering and map export.

Replaces the ROS publishers:
  * FramePublisher (src/FramePublisher.cc): draws tracked points /
    initialization matches and a state banner onto the current frame,
    published on /ORB_SLAM/Frame -> here `draw_frame` returns the
    annotated image (BGR) for imwrite/imshow.
  * MapPublisher (src/MapPublisher.cc): rviz markers for map points,
    keyframe frusta, covisibility graph and the current camera ->
    here `draw_map_topdown` renders an orthographic map view and
    `export_ply` writes the point cloud + keyframe poses for any
    3D viewer.
"""
from __future__ import annotations

import numpy as np

from ..frontend.frame import Frame
from ..frontend.tracking import TrackState
from ..map.map_state import MapState
from ..utils.cv import require_cv2


def draw_frame(image: np.ndarray, frame: Frame, state: TrackState,
               n_kf: int = 0, n_mp: int = 0) -> np.ndarray:
    """Annotated tracking image (FramePublisher::DrawFrame :60-150)."""
    cv2 = require_cv2()

    vis = cv2.cvtColor(image.astype(np.uint8), cv2.COLOR_GRAY2BGR)
    n_tracked = 0
    if state == TrackState.WORKING and frame.point is not None:
        sel = (frame.point >= 0) & ~frame.outlier
        n_tracked = int(sel.sum())
        for x, y in frame.xy[sel].astype(int):
            cv2.rectangle(vis, (x - 3, y - 3), (x + 3, y + 3), (0, 255, 0), 1)
            cv2.circle(vis, (x, y), 1, (0, 255, 0), -1)
    elif frame.valid is not None:
        for x, y in frame.xy[frame.valid].astype(int):
            cv2.circle(vis, (x, y), 1, (200, 200, 200), -1)

    # state banner (FramePublisher::DrawTextInfo :155-188)
    banners = {
        TrackState.NO_IMAGES_YET: "WAITING FOR IMAGES",
        TrackState.NOT_INITIALIZED: "TRYING TO INITIALIZE",
        TrackState.INITIALIZING: "TRYING TO INITIALIZE",
        TrackState.WORKING: f"SLAM ON | KFs: {n_kf} | MPs: {n_mp} | tracked: {n_tracked}",
        TrackState.LOST: "TRACK LOST - RELOCALIZING",
    }
    txt = banners.get(state, "")
    h = vis.shape[0]
    cv2.rectangle(vis, (0, h - 22), (vis.shape[1], h), (0, 0, 0), -1)
    cv2.putText(vis, txt, (6, h - 6), cv2.FONT_HERSHEY_PLAIN, 1.0, (255, 255, 255), 1)
    return vis


def draw_map_topdown(state: MapState, size: int = 640, pad: float = 0.1,
                     covis_weight: int = 15) -> np.ndarray:
    """Orthographic x-z map view: points, keyframes, covisibility graph
    (weight >= 15) and spanning tree — the same marker set the reference's
    MapPublisher draws (src/MapPublisher.cc:29-117: points, frusta,
    covisibility LINE_LIST, spanning tree, current camera)."""
    cv2 = require_cv2()

    vis = np.full((size, size, 3), 255, np.uint8)
    pts = state.mp_xyz[state.mp_valid]
    kfs = np.nonzero(state.kf_valid)[0]
    if len(pts) == 0 and len(kfs) == 0:
        return vis
    centers = np.stack(
        [-state.kf_R[k].T @ state.kf_t[k] for k in kfs]
    ) if len(kfs) else np.zeros((0, 3))
    allxz = np.concatenate([pts[:, [0, 2]], centers[:, [0, 2]]]) if len(pts) else centers[:, [0, 2]]
    lo = allxz.min(0) - pad
    hi = allxz.max(0) + pad
    scale = (size - 1) / max((hi - lo).max(), 1e-6)

    def to_px(xz):
        p = (xz - lo) * scale
        return int(p[0]), size - 1 - int(p[1])

    for p in pts:
        cv2.circle(vis, to_px(p[[0, 2]]), 1, (80, 80, 80), -1)
    # covisibility-graph edges (weight >= covis_weight, MapPublisher.cc
    # :29-117 draws the graph in green; light so the tree stays readable)
    kf_index = {int(k): i for i, k in enumerate(kfs)}
    covis = state.covisibility()
    for i, k in enumerate(kfs):
        for n in np.nonzero(covis[k] >= covis_weight)[0]:
            j = kf_index.get(int(n))
            if j is None or j <= i:
                continue
            cv2.line(vis, to_px(centers[i][[0, 2]]),
                     to_px(centers[j][[0, 2]]), (120, 220, 120), 1)
    # spanning tree edges
    for k in kfs:
        parent = state.kf_parent[k]
        if parent >= 0 and state.kf_valid[parent]:
            c1 = -state.kf_R[k].T @ state.kf_t[k]
            c2 = -state.kf_R[parent].T @ state.kf_t[parent]
            cv2.line(vis, to_px(c1[[0, 2]]), to_px(c2[[0, 2]]), (180, 120, 0), 1)
    for i, k in enumerate(kfs):
        color = (0, 0, 255) if i == len(kfs) - 1 else (255, 0, 0)
        cv2.circle(vis, to_px(centers[i][[0, 2]]), 3, color, -1)
    return vis


def export_ply(path: str, state: MapState):
    """Point cloud + keyframe centers as a PLY (any 3D viewer)."""
    pts = state.mp_xyz[state.mp_valid]
    kfs = np.nonzero(state.kf_valid)[0]
    centers = np.stack(
        [-state.kf_R[k].T @ state.kf_t[k] for k in kfs]
    ) if len(kfs) else np.zeros((0, 3))
    n = len(pts) + len(centers)
    with open(path, "w") as f:
        f.write(
            "ply\nformat ascii 1.0\n"
            f"element vertex {n}\n"
            "property float x\nproperty float y\nproperty float z\n"
            "property uchar red\nproperty uchar green\nproperty uchar blue\n"
            "end_header\n"
        )
        for p in pts:
            f.write(f"{p[0]:.5f} {p[1]:.5f} {p[2]:.5f} 120 120 120\n")
        for c in centers:
            f.write(f"{c[0]:.5f} {c[1]:.5f} {c[2]:.5f} 255 0 0\n")

"""Frame: per-image feature container with lazy device->host materialization.

Replaces src/Frame.cc (351 LoC): the constructor-extracts + undistorts +
grid-bins design becomes one jitted extraction program plus a padded
container. The reference's 64x48 keypoint grid (Frame.h:35-36) exists only
to accelerate CPU area queries — the array matchers mask the dense
distance matrix instead, so no grid is kept.

Device-resident twist: in the steady-state fused tracking path the feature
arrays live on DEVICE (outputs of the fused per-frame program) and are
pulled to host lazily, only when something actually needs them on host —
keyframe insertion, relocalization, or a slow-path fallback. Ordinary
tracked frames never pay the device->host transfer for their features.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..config import SlamConfig
from ..geometry import camera as cam
from ..ops import extractor

_FEAT_FIELDS = ("xy", "xy_un", "level", "angle", "response", "desc", "valid")


class Frame:
    """Padded per-frame features + tracking bookkeeping.

    Feature arrays (xy, xy_un, level, angle, response, desc, valid) are
    host numpy arrays, materialized lazily from device arrays when the
    frame was produced by the fused device path.
    """

    def __init__(self, frame_id: int, timestamp: float, n_feat: int,
                 host: dict | None = None, dev: dict | None = None,
                 prefetch=None):
        self.frame_id = frame_id
        self.timestamp = timestamp
        self.n_feat = n_feat
        self._host = dict(host) if host else {}
        self._dev = dev
        # optional Future of the already-pulled feature dict (submitted to
        # the pull pool at dispatch time): materialization then costs
        # nothing instead of a queue-contended pull at keyframe creation
        self._prefetch = prefetch
        # pose (world->cam), set by tracking
        self.R: np.ndarray | None = None
        self.t: np.ndarray | None = None
        # map point association per feature (-1 = none), set by tracking
        self.point = np.full(n_feat, -1, np.int32)
        self.point_gen = np.zeros(n_feat, np.int32)
        self.outlier = np.zeros(n_feat, bool)

    # --- lazy feature materialization -------------------------------------

    def materialize(self):
        """Pull all device-resident feature arrays to host (one batched
        device_get, or the dispatch-time prefetch). No-op when already
        host-resident."""
        if self._prefetch is not None:
            pulled = self._prefetch.result()
            self._prefetch = None
            for f, v in pulled.items():
                self._host.setdefault(f, np.asarray(v))
            self._dev = None
        if self._dev is not None:
            missing = [f for f in _FEAT_FIELDS if f not in self._host]
            if missing:
                pulled = jax.device_get([self._dev[f] for f in missing])
                for f, v in zip(missing, pulled):
                    self._host[f] = np.asarray(v)
            self._dev = None
        return self

    def _get(self, name: str) -> np.ndarray:
        if name not in self._host:
            if self._dev is None:
                raise AttributeError(name)
            self.materialize()
        return self._host[name]

    @property
    def xy(self) -> np.ndarray:        # (N, 2) raw keypoints (level-0 scale)
        return self._get("xy")

    @property
    def xy_un(self) -> np.ndarray:     # (N, 2) undistorted positions
        return self._get("xy_un")

    @property
    def level(self) -> np.ndarray:     # (N,) int32
        return self._get("level")

    @property
    def angle(self) -> np.ndarray:     # (N,) float32
        return self._get("angle")

    @property
    def response(self) -> np.ndarray:  # (N,)
        return self._get("response")

    @property
    def desc(self) -> np.ndarray:      # (N, 32) uint8
        return self._get("desc")

    @property
    def valid(self) -> np.ndarray:     # (N,) bool
        return self._get("valid")

    @property
    def n_valid(self) -> int:
        return int(self.valid.sum())


@jax.jit
def _undistort(xy, K4, dist):
    return cam.undistort_points(xy, K4, dist, iters=8)


def build_frame(
    image: np.ndarray, cfg: SlamConfig, frame_id: int = 0, timestamp: float = 0.0,
    n_features: int | None = None,
) -> Frame:
    """Extract features and undistort keypoints (Frame.cc:56-123)."""
    # upload the raw dtype (uint8 camera frames are 4x fewer bytes host->
    # device) and convert on device
    feats = extractor.extract(
        jnp.asarray(image).astype(jnp.float32),
        n_features=n_features or cfg.n_features,
        n_levels=cfg.n_levels,
        scale_factor=cfg.scale_factor,
        fast_th=cfg.fast_threshold,
        fast_min_th=cfg.fast_min_threshold,
        use_harris_score=cfg.use_harris_score,
    )
    if np.any(cfg.dist4 != 0):
        xy_un = _undistort(feats.xy, jnp.array(cfg.K4), jnp.array(cfg.dist4))
    else:
        xy_un = feats.xy
    dev = {
        "xy": feats.xy, "xy_un": xy_un, "level": feats.level,
        "angle": feats.angle, "response": feats.response,
        "desc": feats.desc, "valid": feats.valid,
    }
    # lazy: the features stay on device until something host-side actually
    # reads them (one batched pull then) — a frame that only feeds the
    # jitted init/track kernels never pays for a pull
    return Frame(frame_id=frame_id, timestamp=timestamp,
                 n_feat=int(feats.valid.shape[0]), dev=dev)


def predict_scale_level(dist: np.ndarray, max_dist: np.ndarray, scale_factor: float,
                        n_levels: int) -> np.ndarray:
    """Pyramid-level prediction from distance within the scale band
    (MapPoint::PredictScale usage in Frame::isInFrustum, Frame.cc:137-198)."""
    ratio = np.maximum(max_dist, 1e-9) / np.maximum(dist, 1e-9)
    level = np.ceil(np.log(np.maximum(ratio, 1e-9)) / np.log(scale_factor))
    return np.clip(level, 0, n_levels - 1).astype(np.int32)

"""The steady-state WORKING-path tracker as ONE device-resident XLA program.

It keeps host<->device traffic off the per-frame path. The composed
per-frame call stack of Tracking::GrabImage in the
WORKING state (src/Tracking.cc:205-311: extract -> TrackWithMotionModel ->
TrackLocalMap -> pose optimization) is compiled into a single jitted
program over DEVICE-RESIDENT state:

  * the only per-frame host->device transfer is the raw uint8 image;
  * the local-map slice (positions, normals, scale bands, descriptors of
    the points of the covisible neighborhood) lives on device, packed into
    ONE (M, 16) float32 buffer, refreshed only on keyframe/mapping events
    (the map does not change between keyframes);
  * the previous pose and the motion-model velocity (Tracking.cc:297-310)
    are device arrays fed back from the previous call — never uploaded;
  * the host pulls ONE small packed result per frame (pose + inlier count
    + per-feature match bindings + per-slice-slot visible/found flags)
    and does only cheap numpy bookkeeping with it.

Two match/optimize passes replace the reference's two-stage tracking:
pass 1 matches the slice under the motion-model pose with a wide radius
(TrackWithMotionModel's th=15 window, ORBmatcher.cc:1507-1620), pass 2
re-matches under the refined pose with the tight viewing-angle radius
(SearchReferencePointsInFrustum + TrackLocalMap, Tracking.cc:630-773) and
re-optimizes. Both use the 4-round chi2-regating pose optimizer
(Optimizer::PoseOptimization, src/Optimizer.cc:154-285).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from ..config import SlamConfig
from ..geometry.camera import frustum_check, undistort_points
from ..geometry.se3 import orthonormalize
from ..ops import matching
from ..ops.extractor import extract
from ..solvers import pose_opt

MAX_SLICE = 4096  # local-map slice capacity (points of the covisible set)

# feat_bind encoding: low 16 bits = slice slot, bit 16 = pose-opt inlier
BIND_INLIER = 1 << 16
# slice_flags encoding
FLAG_VISIBLE = 1
FLAG_FOUND = 2


class FusedOut(NamedTuple):
    # device-resident state fed back into the next call
    R: jax.Array          # (3, 3) refined world->cam
    t: jax.Array          # (3,)
    vel_R: jax.Array      # (3, 3) motion-model velocity
    vel_t: jax.Array      # (3,)
    # ONE host-pull buffer (the per-frame results ship as a single int32
    # vector, one transfer):
    #   [0:16)        f32-bitcast: R(9) t(3) n_inl2 n_inl1 n_match2 n_match1
    #   [16:16+N)     feat_bind: slice slot | BIND_INLIER, -1 = none
    #   [16+N:16+N+M) slice_flags: FLAG_VISIBLE | FLAG_FOUND
    pull: jax.Array
    # device-resident features for the lazy Frame
    feats: dict


def pack_slice(xyz, normal, min_dist, max_dist, desc, n_obs, n_valid,
               m=MAX_SLICE):
    """Host-side packing of the local-map slice into ONE (M, 17) f32 buffer
    (the single upload of a slice refresh). Rows >= n_valid are invalid
    (max_dist = 0 marks them). Column 16 is the observation count: pass 1
    (the motion-model stage) anchors only on established (>= 3 KF) points,
    the way the reference's TrackWithMotionModel tracks only the previous
    frame's surviving associations (Tracking.cc:594-628)."""
    buf = np.zeros((m, 17), np.float32)
    n = min(n_valid, m)
    buf[:n, 0:3] = xyz[:n]
    buf[:n, 3:6] = normal[:n]
    buf[:n, 6] = min_dist[:n]
    buf[:n, 7] = np.maximum(max_dist[:n], 1e-6)
    buf[:n, 8:16] = np.ascontiguousarray(desc[:n]).view(np.float32)
    buf[:n, 16] = n_obs[:n]
    return buf


def make_fused_step(cfg: SlamConfig, n_map: int = MAX_SLICE):
    """Build the jitted per-frame program, closing over the static camera/
    extractor configuration (constants live inside the executable — no
    per-frame scalar uploads)."""
    K4 = jnp.asarray(cfg.K4)
    dist4 = np.asarray(cfg.dist4)
    has_dist = bool(np.any(dist4 != 0))
    scale_factors = jnp.asarray(cfg.scale_factors)
    inv_sigma2 = jnp.asarray(cfg.inv_sigma2.astype(np.float32))
    n_levels = cfg.n_levels
    # undistorted image bounds (Frame.cc:321-349)
    corners = np.array(
        [[0, 0], [cfg.width, 0], [0, cfg.height], [cfg.width, cfg.height]],
        np.float32,
    )
    if has_dist:
        und = np.asarray(undistort_points(
            jnp.array(corners), jnp.array(cfg.K4), jnp.array(dist4)))
    else:
        und = corners
    bounds = jnp.asarray(np.array(
        [und[:, 0].min(), und[:, 0].max(), und[:, 1].min(), und[:, 1].max()],
        np.float32,
    ))

    def match_pass(R, t, xyz, normal, mind, maxd, valid, desc,
                   f_xy, f_desc, f_level, f_valid, radius_mult, nn_ratio,
                   n_rounds=4):
        ok, uv, _, view_cos, dist = frustum_check(
            xyz, R, t, K4, bounds, normal, 0.8 * mind, 1.2 * maxd
        )
        ok = ok & valid
        ratio = jnp.maximum(maxd, 1e-9) / jnp.maximum(dist, 1e-9)
        pred = jnp.clip(
            jnp.ceil(jnp.log(jnp.maximum(ratio, 1e-9)) / jnp.log(scale_factors[1])),
            0, n_levels - 1,
        ).astype(jnp.int32)
        th = jnp.where(view_cos > 0.998, 2.5, 4.0) * radius_mult
        m = matching.search_by_projection(
            desc, uv, pred, ok,
            f_desc, f_xy, f_level, f_valid,
            scale_factors, th,
            max_dist=100, nn_ratio=nn_ratio, level_window=(-1, 1),
        )
        # scatter matches to features: only matched rows scatter (unmatched
        # rows route to the dropped out-of-bounds index n) — scattering -1
        # for every unmatched row would nondeterministically overwrite a
        # legitimate match landing on the same feature (duplicate-index
        # .set order is undefined in XLA)
        n = f_xy.shape[0]
        feat_pt = jnp.full((n,), -1, jnp.int32)
        feat_pt = feat_pt.at[jnp.where(m.mask, m.idx, n)].set(
            jnp.arange(n_map, dtype=jnp.int32), mode="drop"
        )
        has = feat_pt >= 0
        xw = xyz[jnp.clip(feat_pt, 0, n_map - 1)]
        w = inv_sigma2[jnp.clip(f_level, 0, n_levels - 1)]
        res = pose_opt.optimize_pose(R, t, xw, f_xy, w, has, K4,
                                     n_rounds=n_rounds)
        return res, feat_pt, has, ok, jnp.sum(m.mask)

    @jax.jit
    def step(image_u8, R_prev, t_prev, vel_R, vel_t, has_vel, slice_buf):
        # unpack the device-resident slice
        xyz = slice_buf[:, 0:3]
        normal = slice_buf[:, 3:6]
        mind = slice_buf[:, 6]
        maxd = slice_buf[:, 7]
        valid = maxd > 0
        desc = jax.lax.bitcast_convert_type(
            slice_buf[:, 8:16], jnp.uint8
        ).reshape(n_map, 32)
        n_obs = slice_buf[:, 16]
        # established points: verified by >= 3 keyframes. When the young map
        # has too few of them, pass 1 anchors on everything.
        established = valid & (n_obs >= 3)
        use_est = jnp.sum(established) >= 100
        anchor = jnp.where(use_est, established, valid)

        feats = extract(
            image_u8.astype(jnp.float32),
            n_features=cfg.n_features, n_levels=n_levels,
            scale_factor=cfg.scale_factor, fast_th=cfg.fast_threshold,
            fast_min_th=cfg.fast_min_threshold,
            use_harris_score=cfg.use_harris_score,
        )
        if has_dist:
            xy_un = undistort_points(feats.xy, K4, jnp.asarray(dist4))
        else:
            xy_un = feats.xy

        # motion-model pose prediction (Tracking.cc:297-310). The velocity
        # feedback loop composes rotations every frame: re-project onto
        # SO(3) so f32 drift never accumulates across the session.
        R0 = orthonormalize(jnp.where(has_vel, vel_R @ R_prev, R_prev))
        t0 = jnp.where(has_vel, vel_R @ t_prev + vel_t, t_prev)

        # pass 1: wide search under the predicted pose, anchored on
        # established points only (drift cannot self-confirm through
        # freshly triangulated geometry)
        res1, _, _, ok1, n_m1 = match_pass(
            R0, t0, xyz, normal, mind, maxd, anchor, desc,
            xy_un, feats.desc, feats.level, feats.valid,
            radius_mult=3.0, nn_ratio=0.9, n_rounds=2,
        )
        # recovery pass: at motion-model breakdowns (direction reversals,
        # accelerations, dropped-frame gaps) the prediction error exceeds
        # the pass-1 radius and inliers collapse for one frame. The
        # reference re-searches with a doubled window and falls back to a
        # 200 px window search from the LAST pose, no motion model
        # (ORBmatcher.cc:1600-1616, TrackPreviousFrame :526-592); here one
        # extra ~25x-radius pass (~100 px at level 0) from the un-predicted
        # previous pose fills that role.
        def wide_recovery(_):
            # anchor on EVERY valid slice point, not just established ones:
            # in a sustained rotation the view slides onto freshly
            # triangulated (2-obs) geometry and the established subset in
            # the frustum can be empty — exactly the frames where this
            # recovery pass is the last line before LOST
            r, _, _, _, _ = match_pass(
                orthonormalize(R_prev), t_prev,
                xyz, normal, mind, maxd, valid, desc,
                xy_un, feats.desc, feats.level, feats.valid,
                radius_mult=25.0, nn_ratio=0.9, n_rounds=2,
            )
            return r.R, r.t, r.n_inliers

        def no_recovery(_):
            return res1.R, res1.t, res1.n_inliers

        # lax.cond: the wide pass costs a full match+optimize — only pay it
        # on the rare frames where the narrow pass collapsed
        Rw, tw, nw = jax.lax.cond(
            res1.n_inliers < 20, wide_recovery, no_recovery, None)
        use_wide = nw > res1.n_inliers
        n_inl1 = jnp.where(use_wide, nw, res1.n_inliers)
        R1p = jnp.where(use_wide, Rw, res1.R)
        t1p = jnp.where(use_wide, tw, res1.t)
        # accept pass 1 only if it converged on enough inliers
        acc1 = n_inl1 >= 10
        R1 = jnp.where(acc1, R1p, R0)
        t1 = jnp.where(acc1, t1p, t0)

        # pass 2: tight search under the refined pose (TrackLocalMap)
        res2, feat_pt, has, ok2, n_m2 = match_pass(
            R1, t1, xyz, normal, mind, maxd, valid, desc,
            xy_un, feats.desc, feats.level, feats.valid,
            radius_mult=1.0, nn_ratio=0.8,
        )

        inlier = res2.inliers & has
        # visible statistic: frustum pass under the final pose
        visible = ok2
        found = jnp.zeros((n_map,), bool).at[
            jnp.clip(feat_pt, 0, n_map - 1)
        ].max(inlier)
        flags = (visible.astype(jnp.uint8) * FLAG_VISIBLE
                 | found.astype(jnp.uint8) * FLAG_FOUND)

        feat_bind = jnp.where(
            has, feat_pt + jnp.where(inlier, BIND_INLIER, 0), -1
        ).astype(jnp.int32)

        # velocity for the next frame's prediction
        vel_R_new = res2.R @ R_prev.T
        vel_t_new = res2.t - vel_R_new @ t_prev

        packed = jnp.concatenate([
            res2.R.reshape(-1), res2.t,
            jnp.stack([
                res2.n_inliers.astype(jnp.float32),
                n_inl1.astype(jnp.float32),
                n_m2.astype(jnp.float32), n_m1.astype(jnp.float32),
            ]),
        ])
        pull = jnp.concatenate([
            jax.lax.bitcast_convert_type(packed, jnp.int32),
            feat_bind,
            flags.astype(jnp.int32),
        ])
        feats_out = {
            "xy": feats.xy, "xy_un": xy_un, "level": feats.level,
            "angle": feats.angle, "response": feats.response,
            "desc": feats.desc, "valid": feats.valid,
        }
        return FusedOut(
            R=res2.R, t=res2.t, vel_R=vel_R_new, vel_t=vel_t_new,
            pull=pull, feats=feats_out,
        )

    return step


@jax.jit
def _unpack_pose(buf):
    """(12,) f32 -> (R, t) device arrays; ONE upload when (re)entering the
    fused path from the host FSM."""
    return buf[:9].reshape(3, 3), buf[9:12]


_STEP_CACHE: dict = {}


class FusedContext:
    """Host handle on the device-resident tracking state."""

    def __init__(self, cfg: SlamConfig, n_map: int = MAX_SLICE):
        self.cfg = cfg
        self.n_map = n_map
        # one traced program per camera/extractor configuration, shared
        # across Slam instances — retracing the full fused step costs many
        # seconds and the persistent cache only skips the XLA compile
        key = (n_map, cfg.n_features, cfg.n_levels, cfg.scale_factor,
               cfg.fast_threshold, cfg.fast_min_threshold,
               cfg.use_harris_score, cfg.width, cfg.height,
               tuple(np.asarray(cfg.K4).tolist()),
               tuple(np.asarray(cfg.dist4).tolist()))
        step = _STEP_CACHE.get(key)
        if step is None:
            step = make_fused_step(cfg, n_map)
            _STEP_CACHE[key] = step
        self.step = step
        # device state (constants created once — a jnp.asarray per frame
        # would be a host->device transfer per frame)
        self._true = jnp.asarray(True)
        self._false = jnp.asarray(False)
        self.R = None
        self.t = None
        self.vel_R = jnp.eye(3)
        self.vel_t = jnp.zeros(3)
        self.has_vel = self._false
        self.slice_buf = None
        # host metadata for the slice
        self.slice_ids = np.zeros(0, np.int64)   # map-point slot per row
        self.slice_gen = np.zeros(0, np.int32)   # generation at refresh
        # bumped whenever the host overwrites the device-resident pose
        # (set_pose / invalidate): in-flight pipelined results dispatched
        # against the pre-intervention state are stale and must be
        # reprocessed on the host path
        self.epoch = 0

    @property
    def ready(self) -> bool:
        return self.R is not None and self.slice_buf is not None

    def set_pose(self, R: np.ndarray, t: np.ndarray, velocity=None):
        """(Re)enter the fused path from host state: one packed upload."""
        self.epoch += 1
        buf = np.concatenate([
            np.asarray(R, np.float32).reshape(-1), np.asarray(t, np.float32)
        ])
        self.R, self.t = _unpack_pose(jnp.asarray(buf))
        if velocity is not None:
            vbuf = np.concatenate([
                np.asarray(velocity[0], np.float32).reshape(-1),
                np.asarray(velocity[1], np.float32),
            ])
            self.vel_R, self.vel_t = _unpack_pose(jnp.asarray(vbuf))
            self.has_vel = self._true
        else:
            self.has_vel = self._false

    def clear_velocity(self):
        self.has_vel = self._false

    def refresh_slice(self, st, pts: np.ndarray):
        """Upload the local-map slice (ONE (M,16) f32 transfer, async)."""
        pts = pts[: self.n_map]
        n_obs = (st.mp_obs_kf[pts] >= 0).sum(axis=1).astype(np.float32)
        buf = pack_slice(
            st.mp_xyz[pts], st.mp_normal[pts], st.mp_min_dist[pts],
            st.mp_max_dist[pts], st.mp_desc[pts], n_obs, len(pts), self.n_map,
        )
        self.slice_buf = jnp.asarray(buf)
        self.slice_ids = pts.astype(np.int64)
        self.slice_gen = st.mp_gen[pts].copy()

    def invalidate(self):
        self.epoch += 1
        self.R = None
        self.slice_buf = None

    def track(self, image_u8) -> FusedOut:
        """Run one fused step. `image_u8` may be a host array or an already
        device-put array (prefetched)."""
        out = self.step(
            jnp.asarray(image_u8), self.R, self.t,
            self.vel_R, self.vel_t, self.has_vel, self.slice_buf,
        )
        # feed device state forward; the motion model stays off when the
        # settings disable it (UseMotionModel, Tracking.cc:118-129)
        self.R, self.t = out.R, out.t
        self.vel_R, self.vel_t = out.vel_R, out.vel_t
        if self.cfg.use_motion_model:
            self.has_vel = self._true
        return out

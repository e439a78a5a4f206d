"""Tracking: per-frame camera pose estimation state machine.

Replaces src/Tracking.cc (1136 LoC): the FSM {NO_IMAGES_YET, NOT_INITIALIZED,
INITIALIZING, WORKING, LOST} (Tracking.h:57-64), motion-model tracking
(TrackWithMotionModel :594-628), window-search fallback (TrackPreviousFrame
:526-592), local-map tracking (TrackLocalMap :630-662 with
UpdateReference* :775-860 and SearchReferencePointsInFrustum :715-773),
keyframe decision (NeedNewKeyFrame :665-703), BoW+PnP relocalization
(Relocalisation :881-1050), and the motion-model velocity update (:297-310).

Host-side control flow; every heavy step (matching, frustum checks, pose
optimization) is a jitted fixed-shape kernel. The tracker mutates only its
own Frame bookkeeping and the per-point visible/found statistics — map
growth belongs to the local-mapping stage.
"""
from __future__ import annotations

import enum
import functools
from time import monotonic as _monotonic

import numpy as np
import jax
import jax.numpy as jnp

from ..config import SlamConfig
from ..map.map_state import MapState
from ..map.keyframe_db import KeyFrameDatabase
from ..ops import matching
from ..solvers import pose_opt, pnp, initializer
from .frame import Frame, build_frame, predict_scale_level
from . import fused_track

MAX_LOCAL_POINTS = fused_track.MAX_SLICE


class TrackState(enum.Enum):
    NO_IMAGES_YET = 0
    NOT_INITIALIZED = 1
    INITIALIZING = 2
    WORKING = 3
    LOST = 4


class FusedRecord:
    """One in-flight pipelined fused step: the dispatch-time snapshot plus
    the async pull of its result buffer."""

    __slots__ = ("frame_id", "timestamp", "image", "out",
                 "slice_ids", "slice_gen", "epoch", "future", "t_dispatch")

    def __init__(self, frame_id, timestamp, image, out,
                 slice_ids, slice_gen, epoch, future):
        self.frame_id = frame_id
        self.timestamp = timestamp
        self.image = image
        self.out = out
        self.slice_ids = slice_ids
        self.slice_gen = slice_gen
        self.epoch = epoch
        self.future = future
        self.t_dispatch = _monotonic()





@jax.jit
def _init_attempt(key, d0, xy0, a0, v0, lvl0,
                  d1, xy1un, a1, lvl1, v1, K4):
    """One initialization attempt as ONE program: level-0 window match
    (SearchForInitialization, win=100, ORBmatcher.cc:598-713) + the batched
    dual-model H||F RANSAC (Initializer::Initialize). A single result pull
    replaces the match-pull -> host-check -> init-pull round trips — in a
    live-camera setting every stall drops a frame (src/Tracking.cc:166-189's
    depth-1 image queue)."""
    m = matching.window_search(
        d0, xy0, a0, v0, d1, xy1un, a1, lvl1, v1,
        window_px=100.0, max_dist=50, nn_ratio=0.9,
        min_level=0, max_level=0, check_rotation=True,
    )
    mask = m.mask & (lvl0 == 0)
    uv2 = xy1un[m.idx]
    res = initializer.initialize(key, xy0, uv2, mask, K4)
    return jnp.sum(v1), m.idx, mask, res
_init = jax.jit(initializer.initialize, static_argnames=("n_hyp", "min_triangulated"))


@jax.jit
def _frustum(xw, R, t, K4, bounds, normal, min_dist, max_dist):
    from ..geometry.camera import frustum_check

    return frustum_check(xw, R, t, K4, bounds, normal, min_dist, max_dist)


def _bind_and_optimize(idx, mask, xw_q, R0, t0, f_xy, w, K4, n_rounds=4):
    """Scatter query->feature matches to per-feature bindings and run the
    4-round pose optimizer. Returns (feat_q, res)."""
    n = f_xy.shape[0]
    nq = idx.shape[0]
    feat_q = jnp.full((n,), -1, jnp.int32)
    feat_q = feat_q.at[jnp.where(mask, idx, n)].set(
        jnp.arange(nq, dtype=jnp.int32), mode="drop")
    has = feat_q >= 0
    xw_f = xw_q[jnp.clip(feat_q, 0, nq - 1)]
    res = pose_opt.optimize_pose(R0, t0, xw_f, f_xy, w, has, K4,
                                 n_rounds=n_rounds)
    return feat_q, res


@jax.jit
def _track_frame_prog(desc_q, uv_proj, lf_xy, lf_angle, lf_level, valid_q,
                      xw_q, f_desc, f_xy, f_angle, f_level, f_valid, w,
                      R0, t0, K4, scale_factors):
    """The whole TrackWithMotionModel + TrackPreviousFrame fallback as ONE
    program with ONE pull (each extra device->host round trip stalls the
    frame loop): projection search under the
    predicted pose, 200 px window search fallback, binding scatter, 4-round
    pose optimization (Tracking.cc:526-628)."""
    m1 = matching.search_by_projection(
        desc_q, uv_proj, lf_level, valid_q,
        f_desc, f_xy, f_level, f_valid, scale_factors,
        radius=15.0, max_dist=100, nn_ratio=0.9, level_window=(-1, 1))
    m2 = matching.window_search(
        desc_q, lf_xy, lf_angle, valid_q,
        f_desc, f_xy, f_angle, f_level, f_valid,
        window_px=200.0, max_dist=100, nn_ratio=0.9,
        min_level=0, max_level=scale_factors.shape[0] - 1,
        check_rotation=True)
    use2 = jnp.sum(m1.mask) < 20
    idx = jnp.where(use2, m2.idx, m1.idx)
    mask = jnp.where(use2, m2.mask, m1.mask)
    feat_q, res = _bind_and_optimize(idx, mask, xw_q, R0, t0, f_xy, w, K4)
    return idx, mask, use2, feat_q, res


@jax.jit
def _track_local_map_prog(mp_xyz, mp_normal, mp_mind, mp_maxd, mp_desc,
                          q_valid, already, f_desc, f_xy, f_level, f_valid,
                          prev_xw, prev_has, w, R, t, K4, bounds,
                          scale_factors, radius_mult):
    """TrackLocalMap's frustum gate + projection search + pose
    re-optimization over the MERGED binding set (prior frame-to-frame
    matches + new local-map matches) as ONE program/pull
    (Tracking.cc:630-773)."""
    n_levels = scale_factors.shape[0]
    ok, uv, _, view_cos, dist = _frustum(
        mp_xyz, R, t, K4, bounds, mp_normal, mp_mind * 0.8, mp_maxd * 1.2)
    visible = ok & q_valid
    ratio = jnp.maximum(mp_maxd, 1e-9) / jnp.maximum(dist, 1e-9)
    pred = jnp.clip(
        jnp.ceil(jnp.log(jnp.maximum(ratio, 1e-9)) / jnp.log(scale_factors[1])),
        0, n_levels - 1).astype(jnp.int32)
    th = jnp.where(view_cos > 0.998, 2.5, 4.0) * radius_mult
    m = matching.search_by_projection(
        mp_desc, uv, pred, visible & ~already,
        f_desc, f_xy, f_level, f_valid & ~prev_has, scale_factors,
        radius=th, max_dist=100, nn_ratio=0.8, level_window=(-1, 1))
    n = f_xy.shape[0]
    nq = m.idx.shape[0]
    feat_q = jnp.full((n,), -1, jnp.int32)
    feat_q = feat_q.at[jnp.where(m.mask, m.idx, n)].set(
        jnp.arange(nq, dtype=jnp.int32), mode="drop")
    new_has = feat_q >= 0
    has = prev_has | new_has
    xw_f = jnp.where(new_has[:, None],
                     mp_xyz[jnp.clip(feat_q, 0, nq - 1)], prev_xw)
    res = pose_opt.optimize_pose(R, t, xw_f, f_xy, w, has, K4)
    return visible, m.idx, m.mask, feat_q, has, res


@jax.jit
def _reloc_candidate_prog(key, f_desc, f_xy, f_angle, f_level, f_valid, w,
                          kf_desc, kf_angle, kf_has, kf_xw, max_err2, K4):
    """One relocalization candidate attempt as ONE program/pull
    (Relocalisation :881-1050 inner loop): BoW-free mutual matching
    against the candidate keyframe, EPnP RANSAC over the matched points,
    then the 4-round pose optimization on the PnP inliers."""
    m = matching.mutual_match(
        f_desc, f_angle, f_valid, kf_desc, kf_angle, kf_has,
        max_dist=50, nn_ratio=0.75, check_rotation=True)
    # per frame-feature world point through the candidate's bindings
    xw = kf_xw[m.idx]
    valid = m.mask
    res = pnp.solve_pnp(key, xw, f_xy, valid, K4, max_err2)
    sel = valid & res.inliers
    opt = pose_opt.optimize_pose(res.R, res.t, xw, f_xy, w, sel, K4)
    return m.idx, m.mask, res.success, sel, opt


@functools.partial(jax.jit, static_argnames=("radius", "max_dist"))
def _reloc_refine_prog(q_desc, uv_proj, q_level, valid_q, q_xw,
                       f_desc, f_xy, f_level, f_valid, prev_xw, prev_has,
                       w, R, t, K4, scale_factors,
                       radius: float = 10.0, max_dist: int = 100):
    """One post-PnP projection-search ladder rung as ONE program/pull
    (Tracking.cc:988-1027): project the candidate KF's points, re-match
    within `radius` px (the reference runs a 10 px/dist-100 rung, then a
    3 px/dist-64 rung when 30 <= inliers < 50), re-optimize on the union."""
    m = matching.search_by_projection(
        q_desc, uv_proj, q_level, valid_q,
        f_desc, f_xy, f_level, f_valid, scale_factors,
        radius=radius, max_dist=max_dist, nn_ratio=1.0, level_window=(-1, 1))
    n = f_xy.shape[0]
    nq = m.idx.shape[0]
    feat_q = jnp.full((n,), -1, jnp.int32)
    feat_q = feat_q.at[jnp.where(m.mask, m.idx, n)].set(
        jnp.arange(nq, dtype=jnp.int32), mode="drop")
    new_has = feat_q >= 0
    has = prev_has | new_has
    xw_f = jnp.where(new_has[:, None],
                     q_xw[jnp.clip(feat_q, 0, nq - 1)], prev_xw)
    res = pose_opt.optimize_pose(R, t, xw_f, f_xy, w, has, K4)
    return m.idx, m.mask, feat_q, has, res


class Tracker:
    def __init__(self, cfg: SlamConfig, state: MapState, kfdb: KeyFrameDatabase | None = None):
        self.cfg = cfg
        self.map = state
        self.kfdb = kfdb
        self.state = TrackState.NO_IMAGES_YET
        self.velocity: tuple[np.ndarray, np.ndarray] | None = None
        self.last_frame: Frame | None = None
        self.init_frame: Frame | None = None
        self.ref_kf: int = -1
        self.last_kf_frame_id: int = 0
        self.last_reloc_frame_id: int = -(10 ** 9)
        self.n_inliers: int = 0
        self.rng_key = jax.random.key(cfg.seed)
        self.bounds = self._compute_bounds()
        # device-resident fused WORKING path (fused_track.py)
        self.fused = fused_track.FusedContext(cfg) if cfg.fused_tracking else None
        # device mirror of the map (owned by the LocalMapper, wired by the
        # System): slice refreshes gather on device instead of re-uploading
        self.dmap = None
        # callbacks wired by the System
        self.on_initialized = None   # fn(frame1, frame2, matches, init_result)
        self.on_new_keyframe = None  # fn(frame)
        self.mapper_busy = None      # fn() -> bool (mbAcceptKeyFrames inverse)

    def _compute_bounds(self):
        """Undistorted image bounds (Frame.cc:321-349)."""
        cfg = self.cfg
        corners = np.array(
            [[0, 0], [cfg.width, 0], [0, cfg.height], [cfg.width, cfg.height]],
            np.float32,
        )
        if np.any(cfg.dist4 != 0):
            from ..geometry.camera import undistort_points

            und = np.asarray(
                undistort_points(jnp.array(corners), jnp.array(cfg.K4), jnp.array(cfg.dist4))
            )
        else:
            und = corners
        return np.array(
            [und[:, 0].min(), und[:, 0].max(), und[:, 1].min(), und[:, 1].max()],
            np.float32,
        )

    def _next_key(self):
        self.rng_key, sub = jax.random.split(self.rng_key)
        return sub

    # ------------------------------------------------------------------
    # main entry
    # ------------------------------------------------------------------

    def process_frame(self, frame: Frame) -> TrackState:
        """One tracking step. Returns the post-step state; on success
        frame.R/frame.t hold the world->camera pose."""
        if self.state == TrackState.NO_IMAGES_YET:
            self.state = TrackState.NOT_INITIALIZED

        if self.state == TrackState.NOT_INITIALIZED:
            self._first_initialization(frame)
        elif self.state == TrackState.INITIALIZING:
            self._try_initialize(frame)
        else:
            ok = False
            if self.state == TrackState.WORKING:
                ok = self._track_frame(frame)
                if ok:
                    ok = self._track_local_map(frame)
            elif self.state == TrackState.LOST:
                ok = self._relocalize(frame)
                if ok:
                    ok = self._track_local_map(frame)

            if ok:
                self.state = TrackState.WORKING
                if self._need_new_keyframe(frame):
                    self._create_keyframe(frame)
                # motion model velocity (Tracking.cc:297-310). Host numpy:
                # a 3x3 compose is not worth a device dispatch per frame.
                if self.last_frame is not None and self.last_frame.R is not None:
                    Rl, tl = self.last_frame.R, self.last_frame.t
                    Rv = frame.R @ Rl.T
                    tv = frame.t - Rv @ tl
                    self.velocity = (Rv, tv)
            else:
                self.state = TrackState.LOST
                self.velocity = None
                # a failed frame must not keep its garbage pose: the motion
                # model would compose a wild velocity from it next frame and
                # the trajectory would record a junk entry (the reference
                # leaves mTcw empty on failure, Tracking.cc:244-311)
                frame.R = None
                frame.t = None

        self.last_frame = frame
        return self.state

    # ------------------------------------------------------------------
    # fused device-resident WORKING path (fused_track.py)
    # ------------------------------------------------------------------

    def fused_usable(self, frame_id: int) -> bool:
        """The fused path covers the steady WORKING state; the wide-radius
        post-relocalization window (Tracking.cc:646) stays on the host path."""
        return (
            self.fused is not None
            and self.state == TrackState.WORKING
            and self.fused.ready
            and frame_id >= self.last_reloc_frame_id + 2
        )

    def slice_points(self) -> np.ndarray:
        """Local-map point set around the reference KF: the points observed
        by the covisible neighborhood (UpdateReference*, Tracking.cc:775-860),
        prioritized by (seen-by-ref-kf, observation count) when over the
        slice capacity — never arbitrary slot order."""
        st = self.map
        k = self.ref_kf
        if k < 0 or not st.kf_valid[k]:
            return np.zeros(0, np.int64)
        covis = st.covisibility()
        row = covis[k].copy()
        row[~st.kf_valid] = 0
        row[k] = 0
        nb = np.nonzero(row > 0)[0]
        nb = nb[np.argsort(-row[nb])][:79]
        local = np.concatenate([[k], nb]).astype(np.int64)
        pts = np.unique(st.kf_point[local])
        pts = pts[pts >= 0]
        pts = pts[st.mp_valid[pts]]
        if len(pts) > MAX_LOCAL_POINTS:
            ref_pts = st.kf_point[k]
            in_ref = np.isin(pts, ref_pts[ref_pts >= 0])
            nobs = (st.mp_obs_kf[pts] >= 0).sum(axis=1)
            order = np.lexsort((-nobs, ~in_ref))
            pts = np.sort(pts[order[:MAX_LOCAL_POINTS]])
        return pts.astype(np.int64)

    def refresh_fused_slice(self):
        if self.fused is None:
            return
        # skip when neither the mirror nor the reference KF changed since
        # the last refresh — the slice would be identical
        key = (self.dmap.version if self.dmap is not None else -1,
               self.ref_kf, self.map.next_kf_id)
        if getattr(self, "_slice_key", None) == key:
            return
        self._slice_key = key
        pts = self.slice_points()
        if len(pts) == 0:
            return
        if self.dmap is not None:
            from ..map.device_map import slice_kernel

            st = self.map
            M = MAX_LOCAL_POINTS
            pts = pts[:M]
            n = len(pts)
            ids = np.zeros(M, np.int32)
            ids[:n] = pts
            rv = np.zeros(M, bool)
            rv[:n] = True
            n_obs = np.zeros(M, np.float32)
            n_obs[:n] = (st.mp_obs_kf[pts] >= 0).sum(axis=1)
            dm = self.dmap
            self.fused.slice_buf = slice_kernel(
                dm.mp_xyz, dm.mp_desc, dm.mp_normal, dm.mp_min_dist,
                dm.mp_max_dist, dm.mp_valid, ids, rv, n_obs,
            )
            self.fused.slice_ids = pts.astype(np.int64)
            self.fused.slice_gen = st.mp_gen[pts].copy()
        else:
            self.fused.refresh_slice(self.map, pts)

    def enter_fused(self, frame: Frame):
        """(Re)arm the fused path from host state after init/reloc/fallback:
        one packed pose upload + a slice refresh if none is resident."""
        if self.fused is None or frame.R is None:
            return
        self.fused.set_pose(frame.R, frame.t, velocity=self.velocity)
        if self.fused.slice_buf is None:
            self.refresh_fused_slice()

    def fused_dispatch(self, image, frame_id: int, timestamp: float) -> "FusedRecord":
        """Dispatch one fused step and submit its single result buffer to
        the pull pool. The host bookkeeping half (fused_complete) runs when
        the pull lands — possibly several frames later in pipelined mode.
        The slice metadata and epoch are snapshotted NOW: the result binds
        against the slice that was resident at dispatch time."""
        from ..utils.pull import pull_pool
        from ..utils.tracing import get_tracer

        with get_tracer().stage("track_dispatch"):
            out = self.fused.track(image)
        return FusedRecord(
            frame_id=frame_id, timestamp=timestamp, image=image, out=out,
            slice_ids=self.fused.slice_ids, slice_gen=self.fused.slice_gen,
            epoch=self.fused.epoch, future=pull_pool().submit(out.pull),
        )

    def fused_complete(self, rec: "FusedRecord"):
        """Host bookkeeping for a completed fused step (the second half of
        the old process_fused): pose writeback, visible/found statistics,
        match bindings, FSM transition, keyframe decision."""
        st = self.map
        from ..utils.tracing import get_tracer

        tracer = get_tracer()
        with tracer.stage("track_pull"):
            buf = np.asarray(rec.future.result())
        n_feat = int(rec.out.feats["valid"].shape[0])
        packed = buf[:16].view(np.float32)
        bind = buf[16:16 + n_feat]
        flags = buf[16 + n_feat:].astype(np.uint8)
        frame = Frame(rec.frame_id, rec.timestamp, n_feat=n_feat, dev=rec.out.feats)
        frame.R = packed[:9].reshape(3, 3).astype(np.float32).copy()
        frame.t = packed[9:12].astype(np.float32).copy()
        self.n_inliers = int(packed[12])
        # diagnostics: (inl2, inl1, n_match2, n_match1)
        self.fused_stats = tuple(int(x) for x in packed[12:16])

        ids = rec.slice_ids
        n_ids = len(ids)
        if n_ids:
            live = st.mp_valid[ids] & (st.mp_gen[ids] == rec.slice_gen)
            fl = flags[:n_ids]
            vis = ((fl & fused_track.FLAG_VISIBLE) > 0) & live
            fnd = ((fl & fused_track.FLAG_FOUND) > 0) & live
            st.mp_visible[ids[vis]] += 1
            st.mp_found[ids[fnd]] += 1

            has = bind >= 0
            slot = np.where(has, bind & 0xFFFF, 0)
            inl = bind >= fused_track.BIND_INLIER
            ok_slot = has & (slot < n_ids) & live[np.minimum(slot, n_ids - 1)]
            frame.point[ok_slot] = ids[slot[ok_slot]]
            frame.point_gen[ok_slot] = st.mp_gen[ids[slot[ok_slot]]]
            frame.outlier[:] = ok_slot & ~inl

        fell_back = False
        ok = self.n_inliers >= 30
        if not ok:
            # host fallback on this frame's (lazily pulled) features
            fell_back = True
            ok = self._track_frame(frame)
            if ok:
                ok = self._track_local_map(frame)
        else:
            # reference-KF vote (UpdateReferenceKeyFrames, Tracking.cc:804-860)
            pts = frame.point[(frame.point >= 0) & ~frame.outlier]
            if len(pts):
                obs = st.mp_obs_kf[pts]
                votes = np.bincount(obs[obs >= 0], minlength=st.max_kf)
                if votes.max() > 0:
                    self.ref_kf = int(votes.argmax())

        if ok:
            self.state = TrackState.WORKING
            if self._need_new_keyframe(frame):
                self._create_keyframe(frame)
            if self.last_frame is not None and self.last_frame.R is not None:
                Rl, tl = self.last_frame.R, self.last_frame.t
                Rv = frame.R @ Rl.T
                self.velocity = (Rv, frame.t - Rv @ tl)
            if fell_back:
                self.fused.set_pose(frame.R, frame.t, velocity=self.velocity)
        else:
            self.state = TrackState.LOST
            self.velocity = None
            self.fused.invalidate()
            frame.R = None  # see process_frame: no garbage pose survives
            frame.t = None
        self.last_frame = frame
        return self.state, frame

    def process_fused(self, image, frame_id: int, timestamp: float):
        """Synchronous fused step: dispatch + complete back to back (the
        deterministic path used by tests and non-pipelined configs)."""
        return self.fused_complete(self.fused_dispatch(image, frame_id, timestamp))

    def reprocess_stale(self, rec: "FusedRecord"):
        """A pipelined record dispatched before a host intervention
        (fallback pose fix, relocalization, reset) ran against stale device
        state — its result is garbage. Re-track the frame on the host path
        using its (device-resident) features; the extraction is NOT redone.
        """
        frame = Frame(rec.frame_id, rec.timestamp,
                      n_feat=int(rec.out.feats["valid"].shape[0]),
                      dev=rec.out.feats)
        state = self.process_frame(frame)
        return state, frame

    # ------------------------------------------------------------------
    # initialization (Tracking.cc:360-420 + CreateInitialMap :422-524)
    # ------------------------------------------------------------------

    def _first_initialization(self, frame: Frame):
        if frame.n_valid > 100:
            self.init_frame = frame
            self.state = TrackState.INITIALIZING

    @staticmethod
    def _feat(frame: Frame, name: str):
        """Device array for a feature field: the resident one when the
        frame is still device-backed (no pull), else an upload of the host
        copy."""
        if frame._dev is not None and name in frame._dev:
            return frame._dev[name]
        return jnp.array(getattr(frame, name))

    def _try_initialize(self, frame: Frame):
        f0 = self.init_frame
        # ONE program + ONE pull per attempt (kp-count gate + match +
        # dual-model RANSAC): the attempt must not pull candidates /
        # features separately
        n1, idx, mask, res = jax.device_get(_init_attempt(
            self._next_key(),
            self._feat(f0, "desc"), self._feat(f0, "xy_un"),
            self._feat(f0, "angle"), self._feat(f0, "valid"),
            self._feat(f0, "level"),
            self._feat(frame, "desc"), self._feat(frame, "xy_un"),
            self._feat(frame, "angle"), self._feat(frame, "level"),
            self._feat(frame, "valid"), jnp.array(self.cfg.K4),
        ))
        if int(n1) <= 100:
            self.state = TrackState.NOT_INITIALIZED
            return
        n_matches = int(mask.sum())
        if n_matches < 100:
            self.state = TrackState.NOT_INITIALIZED
            return
        if not bool(res.success):
            return  # keep trying with the same init frame
        if self.on_initialized is not None:
            self.on_initialized(f0, frame, (idx, mask), res)

    # ------------------------------------------------------------------
    # frame-to-frame tracking
    # ------------------------------------------------------------------

    def _predict_pose(self):
        lf = self.last_frame
        if self.velocity is not None and self.cfg.use_motion_model:
            Rv, tv = self.velocity
            return Rv @ lf.R, Rv @ lf.t + tv
        return lf.R.copy(), lf.t.copy()

    def _track_frame(self, frame: Frame) -> bool:
        """Motion-model projection search + window-search fallback + pose
        optimization (TrackWithMotionModel :594-628 / TrackPreviousFrame
        :526-592) — dispatched as ONE program with ONE result pull."""
        lf = self.last_frame
        if lf is None or lf.R is None:
            return False
        R0, t0 = self._predict_pose()

        lp = lf.point.copy()
        lp[lf.outlier] = -1
        has_pt = lp >= 0
        mp = np.clip(lp, 0, self.map.max_mp - 1)
        # generation check: mapping may have culled a point and recycled its
        # slot since the last frame was tracked — a stale association must
        # not silently bind to the slot's new occupant
        valid_q = has_pt & self.map.mp_valid[mp] & (self.map.mp_gen[mp] == lf.point_gen)
        xw = self.map.mp_xyz[mp]
        desc_q = self.map.mp_desc[mp]

        # project with predicted pose
        xc = xw @ R0.T + t0
        z = xc[:, 2]
        uv_proj = np.stack(
            [
                self.cfg.fx * xc[:, 0] / np.maximum(z, 1e-9) + self.cfg.cx,
                self.cfg.fy * xc[:, 1] / np.maximum(z, 1e-9) + self.cfg.cy,
            ],
            axis=1,
        ).astype(np.float32)
        valid_q &= z > 0

        w = self.cfg.inv_sigma2[np.clip(frame.level, 0, self.cfg.n_levels - 1)]
        midx, mmask, _use2, feat_q, res = jax.device_get(_track_frame_prog(
            jnp.array(desc_q), jnp.array(uv_proj), jnp.array(lf.xy_un),
            jnp.array(lf.angle), jnp.array(lf.level), jnp.array(valid_q),
            jnp.array(xw),
            self._feat(frame, "desc"), self._feat(frame, "xy_un"),
            self._feat(frame, "angle"), self._feat(frame, "level"),
            self._feat(frame, "valid"),
            jnp.array(w.astype(np.float32)),
            jnp.array(R0), jnp.array(t0), jnp.array(self.cfg.K4),
            jnp.array(self.cfg.scale_factors),
        ))
        if mmask.sum() < 20:
            return False
        # bindings from the program's feat_q (see _track_local_map: the
        # host table must be the one the optimizer scored)
        has = feat_q >= 0
        fq = np.clip(feat_q, 0, len(lp) - 1)
        frame.point[:] = -1
        frame.point[has] = lp[fq[has]]
        frame.point_gen[has] = self.map.mp_gen[lp[fq[has]]]
        frame.outlier = has & ~np.asarray(res.inliers)
        frame.R = np.asarray(res.R)
        frame.t = np.asarray(res.t)
        self.n_inliers = int(res.n_inliers)
        return self.n_inliers >= 10

    # ------------------------------------------------------------------
    # local map tracking (TrackLocalMap :630-662)
    # ------------------------------------------------------------------

    def _local_keyframes(self, frame: Frame) -> np.ndarray:
        """K1 = KFs sharing points with the frame; K2 = their top covisible
        neighbors (UpdateReferenceKeyFrames, Tracking.cc:804-860)."""
        has = (frame.point >= 0) & ~frame.outlier
        pts = frame.point[has]
        obs = self.map.mp_obs_kf[pts]  # (n, MAX_OBS)
        votes = np.bincount(obs[obs >= 0], minlength=self.map.max_kf)
        k1 = np.nonzero(votes)[0]
        if len(k1) == 0:
            return k1
        self.ref_kf = int(votes.argmax())
        covis = self.map.covisibility()
        k2 = set(k1.tolist())
        for k in k1:
            row = covis[k].copy()
            row[~self.map.kf_valid] = 0
            row[k] = 0
            top = np.argsort(-row)[:10]
            k2.update(int(x) for x in top if row[x] > 0)
            parent = self.map.kf_parent[k]
            if parent >= 0:
                k2.add(int(parent))
            if len(k2) > 80:
                break
        return np.array(sorted(k2), np.int64)

    def _track_local_map(self, frame: Frame) -> bool:
        """Frustum gate + projection search + pose re-optimization over the
        local-map points (TrackLocalMap :630-773) — ONE program, ONE pull."""
        local_kfs = self._local_keyframes(frame)
        if len(local_kfs) == 0:
            return False
        # local points (UpdateReferencePoints :775-802)
        pts = np.unique(self.map.kf_point[local_kfs])
        pts = pts[pts >= 0]
        pts = pts[self.map.mp_valid[pts]]
        if len(pts) == 0:
            return False
        if len(pts) > MAX_LOCAL_POINTS:
            pts = pts[:MAX_LOCAL_POINTS]
        pad = MAX_LOCAL_POINTS - len(pts)
        pts_pad = np.concatenate([pts, np.zeros(pad, np.int64)])
        pvalid = np.concatenate([np.ones(len(pts), bool), np.zeros(pad, bool)])

        # wider search right after relocalization (Tracking.cc:646)
        mult = 5.0 if frame.frame_id < self.last_reloc_frame_id + 2 else 1.0
        already = np.isin(pts_pad, frame.point[frame.point >= 0])
        w = self.cfg.inv_sigma2[np.clip(frame.level, 0, self.cfg.n_levels - 1)]
        # the program optimizes the UNION of the prior frame-to-frame
        # bindings (prev_xw/prev_has) and the new local-map matches
        lp = frame.point.copy()
        lp[frame.outlier] = -1
        prev_has = lp >= 0
        prev_xw = self.map.mp_xyz[np.clip(lp, 0, self.map.max_mp - 1)]
        visible, midx, mmask, feat_q, has, res = jax.device_get(_track_local_map_prog(
            jnp.array(self.map.mp_xyz[pts_pad]),
            jnp.array(self.map.mp_normal[pts_pad]),
            jnp.array(self.map.mp_min_dist[pts_pad]),
            jnp.array(np.where(np.isfinite(self.map.mp_max_dist[pts_pad]),
                               self.map.mp_max_dist[pts_pad], 0.0).astype(np.float32)),
            jnp.array(self.map.mp_desc[pts_pad]),
            jnp.array(pvalid), jnp.array(already),
            self._feat(frame, "desc"), self._feat(frame, "xy_un"),
            self._feat(frame, "level"), self._feat(frame, "valid"),
            jnp.array(prev_xw), jnp.array(prev_has),
            jnp.array(w.astype(np.float32)),
            jnp.array(frame.R), jnp.array(frame.t), jnp.array(self.cfg.K4),
            jnp.array(self.bounds), jnp.array(self.cfg.scale_factors),
            jnp.float32(mult),
        ))
        visible = visible & pvalid
        # visibility statistics (Frame::isInFrustum -> IncreaseVisible)
        self.map.mp_visible[pts_pad[visible]] += 1
        # Rebuild bindings from the PROGRAM's own feat_q so the host's
        # frame.point describes exactly the set the pose optimizer saw:
        # (a) features whose prior binding was outlier and were NOT
        # re-matched are cleared (they kept point >= 0 but lost the outlier
        # flag before — rejected matches then leaked into the map as
        # observations; the reference re-evaluates every binding each pass,
        # Optimizer.cc:242-276); (b) duplicate-target ties resolve to the
        # winner the optimizer actually used, not a host-side last-write.
        new_has = feat_q >= 0
        fq = np.clip(feat_q, 0, MAX_LOCAL_POINTS - 1)
        frame.point = np.where(
            new_has, pts_pad[fq], np.where(prev_has, lp, -1)
        ).astype(np.int32)
        frame.point_gen = np.where(
            new_has, self.map.mp_gen[pts_pad[fq]], frame.point_gen
        ).astype(np.int32)
        frame.outlier = has & ~np.asarray(res.inliers)
        frame.R = np.asarray(res.R)
        frame.t = np.asarray(res.t)
        self.n_inliers = int(res.n_inliers)
        # found statistics for inlier points (Tracking.cc:646-655)
        inl = (frame.point >= 0) & ~frame.outlier
        self.map.mp_found[frame.point[inl]] += 1

        min_needed = 50 if frame.frame_id < self.last_reloc_frame_id + self.cfg.max_frames else 30
        return self.n_inliers >= min_needed

    # ------------------------------------------------------------------
    # keyframe decision (NeedNewKeyFrame :665-703)
    # ------------------------------------------------------------------

    def _need_new_keyframe(self, frame: Frame) -> bool:
        """Reference-exact NeedNewKeyFrame (Tracking.cc:665-703):
        - post-reloc blackout only once the map holds > MaxFrames keyframes
          (:672-673 — an early map must keep growing after relocalization),
        - KF iff (timeout OR mapper idle) AND tracking degraded
          ((c1a||c1b) && c2 with mMinFrames = 0, :682-688)."""
        if self.ref_kf < 0:
            return False
        n_kf = int(self.map.kf_valid.sum())
        if (frame.frame_id < self.last_reloc_frame_id + self.cfg.max_frames
                and n_kf > self.cfg.max_frames):
            return False
        ref_matches = int((self.map.kf_point[self.ref_kf] >= 0).sum())
        idle = self.mapper_busy is None or not self.mapper_busy()
        c1a = frame.frame_id >= self.last_kf_frame_id + self.cfg.max_frames
        c2 = self.n_inliers < 0.9 * ref_matches and self.n_inliers > 15
        if not c2:
            return False
        # mapper busy: the reference interrupts the running BA instead of
        # inserting (InterruptBA, :692-698); our amortized queue drops the
        # pending BA stage when the KF does get inserted, so defer — unless
        # tracking is decaying hard, in which case insert anyway (ORB-SLAM2's
        # idle-override: interrupt BA and take the KF; the queue can hold
        # several keyframes). The urgent override must NOT sit behind the
        # idle gate: in a continuous rotation the amortized mapper is busy
        # for most frames, and deferring keyframes until it idles starves
        # the map exactly when the view is sliding onto fresh geometry —
        # tracking decayed to LOST with the urgent branch unreachable.
        urgent = self.n_inliers < 0.5 * ref_matches
        from ..utils.tracing import get_tracer

        get_tracer().log("kf_decision", frame=int(frame.frame_id),
                         inl=self.n_inliers, ref=ref_matches, idle=idle,
                         c1a=bool(c1a), urgent=bool(urgent))
        return c1a or urgent or idle  # c1b = idle (mMinFrames = 0, :77)

    def _create_keyframe(self, frame: Frame):
        if self.on_new_keyframe is not None:
            self.on_new_keyframe(frame)
        self.last_kf_frame_id = frame.frame_id

    # ------------------------------------------------------------------
    # relocalization (Relocalisation :881-1050)
    # ------------------------------------------------------------------

    def _relocalize(self, frame: Frame) -> bool:
        if self.kfdb is None:
            return False
        from ..utils.tracing import get_tracer

        tracer = get_tracer()
        qbow = self.kfdb.query_bow(frame.desc, frame.valid)
        self.kfdb.set_covisibility(self.map.covisibility())
        cands = self.kfdb.detect_reloc_candidates(qbow)
        tracer.log("reloc_candidates", frame=int(frame.frame_id),
                   cands=[int(c) for c in cands])
        st, cfg = self.map, self.cfg
        max_err = 5.991 * cfg.sigma2[np.clip(frame.level, 0, cfg.n_levels - 1)]
        w = cfg.inv_sigma2[np.clip(frame.level, 0, cfg.n_levels - 1)]
        for kf in cands:
            kf_point = st.kf_point[kf]
            mp_safe = np.clip(kf_point, 0, st.max_mp - 1)
            kf_has = (st.kf_feat_valid[kf] & (kf_point >= 0)
                      & st.mp_valid[mp_safe])
            # ONE program + ONE pull per candidate: mutual match + EPnP
            # RANSAC + 4-round pose optimization on the PnP inliers
            idx, mask, pnp_ok, sel, opt = jax.device_get(_reloc_candidate_prog(
                self._next_key(),
                self._feat(frame, "desc"), self._feat(frame, "xy_un"),
                self._feat(frame, "angle"), self._feat(frame, "level"),
                self._feat(frame, "valid"),
                jnp.array(w.astype(np.float32)),
                jnp.array(st.kf_desc[kf]), jnp.array(st.kf_angle[kf]),
                jnp.array(kf_has), jnp.array(st.mp_xyz[mp_safe]),
                jnp.array(max_err.astype(np.float32)), jnp.array(cfg.K4),
            ))
            tracer.log("reloc_attempt", frame=int(frame.frame_id),
                       kf=int(kf), n_match=int(mask.sum()),
                       pnp_ok=bool(pnp_ok))
            if mask.sum() < 15 or not bool(pnp_ok):
                continue
            mp = np.where(sel, kf_point[idx], -1)
            frame.point[:] = -1
            frame.point[sel] = mp[sel]
            frame.point_gen[sel] = st.mp_gen[mp[sel]]
            frame.outlier = sel & ~np.asarray(opt.inliers)
            frame.R = np.asarray(opt.R)
            frame.t = np.asarray(opt.t)
            self.n_inliers = int(opt.n_inliers)
            tracer.log("reloc_opt", frame=int(frame.frame_id), kf=int(kf),
                       n_inliers=self.n_inliers)
            if self.n_inliers >= 10:
                if self.n_inliers >= 50 or self._reloc_refine(frame, kf):
                    self.last_reloc_frame_id = frame.frame_id
                    return True
        return False

    def _reloc_refine(self, frame: Frame, kf: int) -> bool:
        """The reference's full post-PnP refinement ladder
        (Tracking.cc:988-1027): a 10 px projection-search rung, and — when
        it lands in [30, 50) inliers — a second, tighter 3 px / ORB-dist-64
        rung from the once-refined pose. Accept at >= 50."""
        if self._reloc_refine_rung(frame, kf, radius=10.0, max_dist=100):
            return True
        if 30 <= self.n_inliers < 50:
            return self._reloc_refine_rung(frame, kf, radius=3.0, max_dist=64)
        return False

    def _reloc_refine_rung(self, frame: Frame, kf: int, radius: float,
                           max_dist: int) -> bool:
        """One projection-search + re-optimize rung — ONE program/pull."""
        st, cfg = self.map, self.cfg
        q = st.kf_point[kf].copy()
        valid_q = q >= 0
        mpid = np.clip(q, 0, st.max_mp - 1)
        xw = st.mp_xyz[mpid]
        xc = xw @ frame.R.T + frame.t
        z = xc[:, 2]
        uv_proj = np.stack(
            [
                cfg.fx * xc[:, 0] / np.maximum(z, 1e-9) + cfg.cx,
                cfg.fy * xc[:, 1] / np.maximum(z, 1e-9) + cfg.cy,
            ],
            axis=1,
        ).astype(np.float32)
        valid_q &= (z > 0) & st.mp_valid[mpid]
        lp = frame.point.copy()
        lp[frame.outlier] = -1
        prev_has = lp >= 0
        prev_xw = st.mp_xyz[np.clip(lp, 0, st.max_mp - 1)]
        w = cfg.inv_sigma2[np.clip(frame.level, 0, cfg.n_levels - 1)]
        midx, mmask, feat_q, has, res = jax.device_get(_reloc_refine_prog(
            jnp.array(st.mp_desc[mpid]), jnp.array(uv_proj),
            jnp.array(st.kf_level[kf]), jnp.array(valid_q), jnp.array(xw),
            self._feat(frame, "desc"), self._feat(frame, "xy_un"),
            self._feat(frame, "level"), self._feat(frame, "valid"),
            jnp.array(prev_xw), jnp.array(prev_has),
            jnp.array(w.astype(np.float32)),
            jnp.array(frame.R), jnp.array(frame.t), jnp.array(cfg.K4),
            jnp.array(cfg.scale_factors),
            radius=radius, max_dist=max_dist,
        ))
        new_has = feat_q >= 0
        fqc = np.clip(feat_q, 0, len(q) - 1)
        frame.point = np.where(
            new_has, q[fqc], np.where(prev_has, lp, -1)
        ).astype(np.int32)
        frame.point_gen = np.where(
            new_has, st.mp_gen[np.clip(q[fqc], 0, st.max_mp - 1)],
            frame.point_gen,
        ).astype(np.int32)
        frame.outlier = has & ~np.asarray(res.inliers)
        frame.R = np.asarray(res.R)
        frame.t = np.asarray(res.t)
        self.n_inliers = int(res.n_inliers)
        from ..utils.tracing import get_tracer

        get_tracer().log("reloc_refine", frame=int(frame.frame_id),
                         kf=int(kf), radius=radius,
                         n_new=int(new_has.sum()),
                         n_inliers=self.n_inliers)
        return self.n_inliers >= 50

    def force_relocalization(self):
        """LoopClosing tells the tracker the map moved under it
        (Tracking::ForceRelocalisation, Tracking.cc:1052-1064)."""
        self.state = TrackState.LOST
        self.velocity = None
        if self.fused is not None:
            self.fused.invalidate()

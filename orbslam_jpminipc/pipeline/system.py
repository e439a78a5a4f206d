"""The SLAM system orchestrator.

Replaces src/main.cc (259 LoC): constructs the map, keyframe database,
tracker, local mapper and loop closer, wires them together, and exposes a
per-frame `process()`. Instead of three mutex-synchronized threads
(main.cc:165-218), stages run deterministically: tracking per frame,
mapping + loop closing per new keyframe. The keyframe trajectory dump
(main.cc:226-245, TUM format) and the world checkpoint hooks
(main.cc:143, 249) live here too.
"""
from __future__ import annotations

import time as _time

import numpy as np
import jax.numpy as jnp

from ..config import SlamConfig
from ..frontend.frame import Frame, build_frame
from ..frontend.tracking import Tracker, TrackState
from ..map.map_state import MapState
from ..map.keyframe_db import KeyFrameDatabase
from ..solvers import ba, gba
from ..utils.tracing import get_tracer
from ..vocab.vocabulary import Vocabulary
from .local_mapping import LocalMapper
from .loop_closing import LoopCloser


class Slam:
    def __init__(self, cfg: SlamConfig, vocab: Vocabulary | None = None,
                 enable_loop_closing: bool = True):
        self.cfg = cfg
        # keyframe feature arrays sized for the 2x init extractor output
        self.map = MapState.create(cfg.max_kf, cfg.max_mp, 2 * cfg.n_features, cfg.max_obs)
        self.kfdb = KeyFrameDatabase(vocab, cfg.max_kf) if vocab is not None else None
        self.tracker = Tracker(cfg, self.map, self.kfdb)
        self.mapper = LocalMapper(cfg, self.map, self.kfdb)
        self.loop_closer = (
            LoopCloser(cfg, self.map, self.kfdb)
            if (vocab is not None and enable_loop_closing)
            else None
        )
        self.tracker.on_initialized = self._create_initial_map
        self.tracker.on_new_keyframe = self._on_new_keyframe
        self.tracker.dmap = self.mapper.dmap
        if self.loop_closer is not None:
            self.loop_closer.dmap = self.mapper.dmap
        if cfg.async_mapping:
            self.tracker.mapper_busy = self._mapper_busy
        self.frame_count = 0
        self.trajectory: list[tuple[float, np.ndarray, np.ndarray]] = []
        self.n_loops_closed = 0
        self.tracer = get_tracer()
        # amortized mapping queue: (kf, [remaining stages]) — one stage per
        # frame when cfg.async_mapping, replacing the reference's mapper
        # thread overlap (main.cc:182, LocalMapping.cc:52-127)
        self.pending: list[tuple[int, list[str]]] = []
        # pipelined tracking: in-flight fused records awaiting their async
        # pull; completed strictly in frame order
        from collections import deque

        self._inflight: deque = deque()
        self._last_result: tuple[TrackState, Frame | None] = (
            TrackState.NO_IMAGES_YET, None)

    # ------------------------------------------------------------------

    def process(self, image, timestamp: float = 0.0) -> tuple[TrackState, Frame]:
        """One frame. `image` may be a host uint8 array or an already
        device-put array (prefetched by the caller to overlap the upload
        with the previous frame's compute).

        In pipelined mode (cfg.pipelined_tracking) the fused step for this
        frame is dispatched and the HOST bookkeeping of an earlier frame
        whose async pull completed is run instead; the returned (state,
        frame) is the most recently COMPLETED frame's. finish() drains the
        tail."""
        frame_id = self.frame_count
        self.frame_count += 1
        tr = self.tracker
        # latency-mode hysteresis: while tracking quality is degrading
        # (fast rotation eating the covisible set), in-flight pipelined
        # frames match against slices up to `depth` frames stale and the
        # quality collapse feeds itself — switch to synchronous processing
        # until the inlier count recovers, then resume pipelining. The
        # decaying peak serves as the regime-free health reference.
        self._inlier_peak = 0.97 * getattr(self, "_inlier_peak", 0.0)
        if tr.state == TrackState.WORKING:
            self._inlier_peak = max(float(tr.n_inliers), self._inlier_peak)
        degraded = (tr.n_inliers < self.cfg.pipeline_guard_inliers
                    or tr.n_inliers < 0.7 * self._inlier_peak)
        if degraded:
            if self.pending:
                # degraded tracking: interrupt BA and finish the mapper's
                # backlog NOW — every degraded frame, not only on entering
                # latency mode — so the keyframe the tracker needs is not
                # refused by the busy gate (InterruptBA dynamics,
                # Tracking.cc:692-698). During a sustained rotation the
                # queue refills each frame; draining only on entry left the
                # mapper busy for most of the collapse window and keyframe
                # insertion starved all the way to LOST.
                with self.tracer.stage("mapping_hard_drain"):
                    self._drain_mapping_hard()
            self._latency_frames = 10
        else:
            self._latency_frames = max(0, getattr(self, "_latency_frames", 0) - 1)
        if self.cfg.pipelined_tracking and tr.fused_usable(frame_id):
            rec = tr.fused_dispatch(image, frame_id, timestamp)
            self._inflight.append(rec)
            # run the mapping tick BEFORE completing frames: the keyframe
            # decision inside a completion reads the stage queue as the
            # mapper-busy gate (mbAcceptKeyFrames, Tracking.cc:679); with
            # the tick after the drain, every completion saw the previous
            # frame's undrained queue and refused keyframes almost always
            # — the map starved and tracking quality collapsed in
            # rotation-heavy stretches
            self._mapping_tick()
            # latency mode = depth-1 pipelining: decisions land next frame
            # and dispatches use a fresh slice, while the pull pipeline
            # still overlaps (full-sync processing costs 2-3x on healthy
            # translation-rich sequences that merely dip for a moment)
            depth = 1 if self._latency_frames > 0 else self.cfg.pipeline_depth
            # bound the DECISION lag independently of the queue budget:
            # when the depth flips 1 -> pipeline_depth after a latency
            # episode, the refill phase used to complete nothing for
            # `depth` frames and then burst — a keyframe-decision blackout
            # that, mid-rotation, starves the map straight to LOST. Force
            # the head out once it is >= 3 submissions old — but only
            # while a latency episode is live, or when the head is stale
            # in WALL-CLOCK terms (the real decision-lag bound, ~5 frame
            # periods at 30 fps). In healthy full-speed streaming the
            # submission counter runs far ahead of the device's
            # completion latency, and a submission-count force there
            # turns every frame into a blocking wait — serializing the
            # whole pipeline to the completion-notification floor.
            head = self._inflight[0] if self._inflight else None
            head_stale = head is not None and (
                frame_id - head.frame_id >= 3) and (
                self._latency_frames > 0
                or _time.monotonic() - head.t_dispatch > 0.15)
            self._drain_inflight(
                force=len(self._inflight) > depth or head_stale)
            return self._last_result
        # host/sync path: complete every in-flight frame first (ordering)
        self._drain_inflight(force=True, drain_all=True)
        if tr.fused_usable(frame_id):
            # steady-state device path: extraction happens INSIDE the fused
            # program; one upload (the image), one dispatch, one small pull
            with self.tracer.stage("track"):
                state, frame = tr.process_fused(image, frame_id, timestamp)
        else:
            # double feature budget until the map is initialized (the
            # reference builds a 2x-features init extractor, Tracking.cc:126)
            initializing = tr.state in (
                TrackState.NO_IMAGES_YET, TrackState.NOT_INITIALIZED,
                TrackState.INITIALIZING,
            )
            n_features = 2 * self.cfg.n_features if initializing else self.cfg.n_features
            with self.tracer.stage("extract"):
                frame = build_frame(
                    image, self.cfg, frame_id=frame_id, timestamp=timestamp,
                    n_features=n_features,
                )
            with self.tracer.stage("track"):
                state = tr.process_frame(frame)
            if state == TrackState.WORKING and self.cfg.fused_tracking:
                # (re)arm the fused path for the next frame
                tr.enter_fused(frame)
        self._after_track(state, frame, timestamp)
        self._mapping_tick()
        return self._last_result

    def _mapper_busy(self) -> bool:
        """The mbAcceptKeyFrames gate (Tracking.cc:679 / LocalMapping.cc:
        529-539): busy while the stage queue is non-empty. This
        backpressure is load-bearing — it rations keyframes the way the
        reference's mapper thread does (a looser gate floods the map with
        tiny-baseline keyframes and tracking collapses)."""
        return bool(self.pending)

    def _after_track(self, state: TrackState, frame: Frame, timestamp: float):
        """Post-tracking bookkeeping for one COMPLETED frame (in frame
        order): trajectory entry + auto-reset after a failed start
        (Tracking.cc:287-294 — the reference gates on map size alone)."""
        if frame is not None and frame.R is not None:
            self.trajectory.append((timestamp, frame.R.copy(), frame.t.copy()))
        n_kf = int(self.map.kf_valid.sum())
        if (state == TrackState.LOST and 0 < n_kf <= 5
                and not getattr(self, "_warming", False)):
            self.reset()
        self._last_result = (state, frame)

    def _mapping_tick(self):
        """Amortized mapping: run pending stages after the pose is out (the
        tracker never waits for the mapper); drain two per frame when the
        queue backs up behind a burst of keyframes."""
        if not self.pending:
            return
        # greedy drain: stages are either async dispatches or cheap host
        # merges (the pulls resolved in the pool), so run until a fresh
        # dispatch needs to cook, a merge's pull hasn't landed, or the
        # queue empties. A stingier cap (the old 2/frame) keeps the queue
        # resident longer, which keeps mbAcceptKeyFrames false and starves
        # the keyframe cadence exactly when rotation needs map growth.
        with self.tracer.stage("mapping"):
            dispatched = 0
            for _ in range(8):
                if not self.pending:
                    break
                kf, stages = self.pending[0]
                if (self.map.kf_valid[kf]
                        and not self.mapper.stage_ready(kf, stages[0])):
                    # the stage would block on a device kernel / pull
                    # still in flight: skip mapping this frame, the tracker
                    # keeps streaming (the reference's tracker never waits
                    # for its mapper thread either)
                    break
                stage = self._run_pending_stage()
                if stage in LocalMapper.DISPATCH_STAGES:
                    # up to two kernels in flight per tick: the pipelined
                    # frame loop runs ~3x the mapped-stage cadence, and a
                    # one-dispatch-per-frame clock stretches each
                    # keyframe's queue residency (the mapper-busy gate!)
                    # until keyframe acceptance starves
                    dispatched += 1
                    if dispatched >= 2:
                        break
        # mapping stages mutate the map: refresh the device-resident
        # tracking slice (one async upload) so the fused path sees it
        self.tracker.refresh_fused_slice()

    def _drain_mapping_hard(self):
        """Finish every pending mapping stage NOW, aborting bundle
        adjustment the way a new keyframe would (InterruptBA,
        LocalMapping.cc:541-544): the 5-iteration first BA stage still
        runs (the reference's aborted BA also writes back the iterations
        it completed, Optimizer.cc:450-452), only the second 10-iteration
        stage is skipped. Dropping BA outright here starved the map of
        refinement during sustained rotations — every frame was degraded,
        every drain killed the queued BA, and the freshly triangulated
        geometry drifted until tracking died. Blocks on the in-flight
        pulls (~30 ms each) — used only when the tracker is degrading and
        needs the mapper idle to insert a keyframe."""
        while self.pending:
            kf, stages = self.pending[0]
            if "ba2_d" in stages:
                i = stages.index("ba2_d")
                del stages[i:i + 2]
                # ba_abort writes the 5-iteration state back to the map —
                # after ba_m when stage 1 is still queued, immediately in
                # its place when stage 1 already ran
                stages.insert(
                    i if "ba_d" not in stages else stages.index("ba_m") + 1,
                    "ba_abort")
            self._run_pending_stage()
        self.mapper.drain_attrs(force=True)
        self.tracker.refresh_fused_slice()

    def _drain_inflight(self, force: bool = False, drain_all: bool = False):
        """Complete in-flight pipelined records whose pulls have landed —
        strictly in frame order. force: complete at least one (block on its
        pull). drain_all: complete everything."""
        tr = self.tracker
        while self._inflight:
            head = self._inflight[0]
            if not (drain_all or force or head.future.done()):
                break
            force = False
            self._inflight.popleft()
            if tr.fused is None or head.epoch != tr.fused.epoch:
                # dispatched against device state the host has since
                # overwritten (fallback/reloc/reset): the result is
                # garbage — re-track on the host path from the record's
                # device-resident features
                with self.tracer.stage("track"):
                    state, frame = tr.reprocess_stale(head)
                if state == TrackState.WORKING and self.cfg.fused_tracking:
                    tr.enter_fused(frame)
            else:
                with self.tracer.stage("track"):
                    state, frame = tr.fused_complete(head)
            self._after_track(state, frame, head.timestamp)

    def finish(self):
        """Drain all pending tracking/mapping/loop stages (end of sequence
        — the reference joins its mapper/loop threads on shutdown,
        main.cc:222)."""
        self._drain_inflight(drain_all=True)
        while self.pending:
            self._run_pending_stage()
        self.mapper.drain_attrs()
        self.tracker.refresh_fused_slice()

    def warmup(self):
        """Compile every steady-state AND recovery-path program before live
        frames arrive (a real-time system cannot hiccup seconds on a
        mid-run XLA compile; the reference never compiles at runtime).

        Two phases: (1) the explicit shape matrix — every jitted tracking /
        relocalization / loop-closing program at every feature-count
        combination the FSM can produce (init frames carry 2x features,
        fused/relocalization frames 1x, local-map and loop queries the
        padded capacities); (2) a short rendered sequence driving the full
        pipeline (extractors, fused step, mapping-stage kernels, size
        buckets). With the persistent compilation cache this costs seconds
        on later runs."""
        self._compile_programs()
        cfg = self.cfg
        from ..io.dataset import SyntheticSequence

        seq = SyntheticSequence(
            n_frames=60, width=cfg.width, height=cfg.height,
            K4=tuple(float(x) for x in cfg.K4), trajectory="xyz", seed=11,
        )
        rng = np.random.default_rng(7)
        noise = rng.integers(0, 256, (cfg.height, cfg.width)).astype(np.uint8)
        self._warming = True  # disables the LOST auto-reset (_after_track)
        try:
            i = 0
            fps = 30.0
            # init until WORKING (compiles extract 2x + fused init attempt)
            while i < 12:
                state, _ = self.process(seq.get(i)[0], i / fps)
                i += 1
                if state == TrackState.WORKING:
                    break
            # one fused frame (arms + compiles the fused step), then noise:
            # fused collapse -> host fallback -> LOST -> relocalization
            self.process(seq.get(i)[0], i / fps)
            self.process(noise, (i + 1) / fps)
            self._drain_inflight(drain_all=True)
            for j in range(i + 1, i + 4):
                self.process(seq.get(j)[0], j / fps)
            # steady fused tracking + the full mapping-stage family
            for j in range(i + 4, i + 24):
                self.process(seq.get(j)[0], j / fps)
            self.finish()
        finally:
            self._warming = False
        self.reset()
        self.frame_count = 0
        self.trajectory.clear()
        self._last_result = (TrackState.NO_IMAGES_YET, None)
        self.tracer.reset()

    def _compile_programs(self):
        """Phase 1 of warmup(): invoke every jitted host-path program once
        per reachable shape combination, with dummy device data. Results
        are discarded; only the executable caches matter."""
        import jax
        from ..frontend import tracking as T
        from ..solvers import pose_opt, sim3_opt, essential_graph
        from .loop_closing import _mutual as lc_mutual
        from .loop_closing import _search_proj as lc_proj
        from .loop_closing import _solve_sim3 as lc_sim3
        from .loop_closing import _fuse4 as lc_fuse

        cfg = self.cfg
        n1 = cfg.n_features           # fused / steady host frames
        n2 = 2 * cfg.n_features      # init-time frames (2x budget)
        M = T.MAX_LOCAL_POINTS
        K4 = jnp.asarray(cfg.K4)
        sf = jnp.asarray(cfg.scale_factors)
        key = jax.random.key(0)

        def feats(n):
            return dict(
                desc=jnp.zeros((n, 32), jnp.uint8),
                xy=jnp.zeros((n, 2), jnp.float32),
                angle=jnp.zeros((n,), jnp.float32),
                level=jnp.zeros((n,), jnp.int32),
                valid=jnp.zeros((n,), bool),
            )

        fs = {n: feats(n) for n in {n1, n2}}
        outs = []
        # init attempts: the init frame may be a 2x host frame OR a 1x
        # fused frame adopted after a reset mid-stream
        for a in (n1, n2):
            for b in (n1, n2):
                f0, f1 = fs[a], fs[b]
                outs.append(T._init_attempt(
                    key, f0["desc"], f0["xy"], f0["angle"], f0["valid"],
                    f0["level"], f1["desc"], f1["xy"], f1["angle"],
                    f1["level"], f1["valid"], K4))
        # frame-to-frame tracking: query side = last frame (1x or 2x),
        # frame side = current (1x or 2x)
        for a in (n1, n2):
            for b in (n1, n2):
                q, f = fs[a], fs[b]
                outs.append(T._track_frame_prog(
                    q["desc"], q["xy"], q["xy"], q["angle"], q["level"],
                    q["valid"], jnp.zeros((a, 3)),
                    f["desc"], f["xy"], f["angle"], f["level"], f["valid"],
                    jnp.zeros((b,), jnp.float32),
                    jnp.eye(3), jnp.zeros(3), K4, sf))
        for b in (n1, n2):
            f = fs[b]
            # local-map tracking (queries padded to the slice capacity)
            outs.append(T._track_local_map_prog(
                jnp.zeros((M, 3)), jnp.zeros((M, 3)), jnp.zeros((M,)),
                jnp.zeros((M,)), jnp.zeros((M, 32), jnp.uint8),
                jnp.zeros((M,), bool), jnp.zeros((M,), bool),
                f["desc"], f["xy"], f["level"], f["valid"],
                jnp.zeros((b, 3)), jnp.zeros((b,), bool),
                jnp.zeros((b,), jnp.float32),
                jnp.eye(3), jnp.zeros(3), K4,
                jnp.asarray(self.tracker.bounds), sf, jnp.float32(1.0)))
            # relocalization: KF rows are map-capacity (2x) arrays
            q2 = fs[n2]
            outs.append(T._reloc_candidate_prog(
                key, f["desc"], f["xy"], f["angle"], f["level"], f["valid"],
                jnp.zeros((b,), jnp.float32),
                q2["desc"], q2["angle"], q2["valid"], jnp.zeros((n2, 3)),
                jnp.zeros((b,), jnp.float32), K4))
            for radius, max_dist in ((10.0, 100), (3.0, 64)):
                outs.append(T._reloc_refine_prog(
                    q2["desc"], q2["xy"], q2["level"], q2["valid"],
                    jnp.zeros((n2, 3)),
                    f["desc"], f["xy"], f["level"], f["valid"],
                    jnp.zeros((b, 3)), jnp.zeros((b,), bool),
                    jnp.zeros((b,), jnp.float32),
                    jnp.eye(3), jnp.zeros(3), K4, sf,
                    radius=radius, max_dist=max_dist))
        outs.append(T._frustum(
            jnp.zeros((M, 3)), jnp.eye(3), jnp.zeros(3), K4,
            jnp.asarray(self.tracker.bounds), jnp.zeros((M, 3)),
            jnp.zeros((M,)), jnp.zeros((M,))))

        # loop closing (all on 2x keyframe rows + the 4096 guided cap)
        if self.loop_closer is not None:
            f2 = fs[n2]
            outs.append(lc_mutual(
                f2["desc"], f2["angle"], f2["valid"],
                f2["desc"], f2["angle"], f2["valid"],
                max_dist=50, nn_ratio=0.75, check_rotation=True))
            outs.append(lc_sim3(
                key, jnp.zeros((n2, 3)), jnp.zeros((n2, 3)),
                f2["xy"], f2["xy"], f2["valid"], K4,
                jnp.zeros((n2,), jnp.float32), jnp.zeros((n2,), jnp.float32)))
            outs.append(sim3_opt.optimize_sim3(
                jnp.float32(1.0), jnp.eye(3), jnp.zeros(3),
                jnp.zeros((n2, 3)), jnp.zeros((n2, 3)), f2["xy"], f2["xy"],
                jnp.zeros((n2,), jnp.float32), jnp.zeros((n2,), jnp.float32),
                f2["valid"], K4))
            for q_n in (n2, 4096):
                qq = feats(q_n)
                outs.append(lc_proj(
                    qq["desc"], qq["xy"], qq["level"], qq["valid"],
                    f2["desc"], f2["xy"], f2["level"], f2["valid"], sf,
                    radius=10.0, max_dist=100, nn_ratio=1.0,
                    level_window=(-1, 1)))
            qq = feats(4096)
            outs.append(lc_fuse(
                qq["desc"], qq["xy"], qq["level"], qq["valid"],
                f2["desc"], f2["xy"], f2["level"], f2["valid"], sf,
                radius=4.0, max_dist=50))
            # the Sim3 pose graph at map capacity (one static shape)
            E = cfg.eg_edges
            prob = essential_graph.EssentialGraphProblem(
                s=jnp.ones(cfg.max_kf), R=jnp.tile(jnp.eye(3)[None], (cfg.max_kf, 1, 1)),
                t=jnp.zeros((cfg.max_kf, 3)),
                fixed=jnp.ones(cfg.max_kf, bool),
                e_i=jnp.zeros(E, jnp.int32), e_j=jnp.zeros(E, jnp.int32),
                e_s=jnp.ones(E), e_R=jnp.tile(jnp.eye(3)[None], (E, 1, 1)),
                e_t=jnp.zeros((E, 3)), e_valid=jnp.zeros(E, bool),
            )
            outs.append(essential_graph.optimize_essential_graph(prob, iterations=20))

        # attrs / mirror-scatter size buckets beyond what a short warmup
        # sequence reaches
        st, dm = self.map, self.mapper.dmap
        for n in (256, 2048):
            ids = np.zeros(n, np.int64)
            self.map.update_point_attributes_async(ids, cfg.scale_factors,
                                                   dmap=dm)
            dm.sync_points(st, np.arange(n))
        jax.device_get(jax.tree.leaves(outs)[:1])  # flush the dispatch queue

    def reset(self):
        """Full reset (Tracking::Reset, Tracking.cc:1066-1103). In-flight
        pipelined records are NOT cleared: the fused epoch bump marks them
        stale and they re-enter through the host path (initialization) —
        they are real camera frames the reset must not swallow."""
        cfg = self.cfg
        self.map = MapState.create(cfg.max_kf, cfg.max_mp, 2 * cfg.n_features, cfg.max_obs)
        if self.kfdb is not None:
            self.kfdb.clear()
        self.tracker.map = self.map
        self.tracker.state = TrackState.NOT_INITIALIZED
        self.tracker.velocity = None
        self.tracker.last_frame = None
        self.tracker.init_frame = None
        self.tracker.ref_kf = -1
        if self.tracker.fused is not None:
            self.tracker.fused.invalidate()
        self.mapper.map = self.map
        self.mapper.probation = []
        self.mapper._tri_pending = None
        self.mapper._fuse_pending = None
        self.mapper._ba_pending = None
        self.mapper._ba_stage1 = None
        self.mapper._ba2_pending = None
        self.mapper._attrs_pending = []
        self.mapper._attrs_inflight = None
        from ..map.device_map import DeviceMap

        self.mapper.dmap = DeviceMap(self.map.max_kf, self.map.n_feat,
                                     self.map.max_mp)
        self.tracker.dmap = self.mapper.dmap
        self.pending = []
        if self.loop_closer is not None:
            self.loop_closer.map = self.map
            self.loop_closer.consistent_groups = []
            self.loop_closer.dmap = self.mapper.dmap

    # ------------------------------------------------------------------
    # initial map (Tracking::CreateInitialMap, Tracking.cc:422-524)
    # ------------------------------------------------------------------

    def _create_initial_map(self, f0: Frame, f1: Frame, match_info, init_res):
        idx, mask = match_info
        st, cfg = self.map, self.cfg
        good = np.asarray(init_res.good) & mask
        if good.sum() < 50:
            return
        R21 = np.asarray(init_res.R)
        t21 = np.asarray(init_res.t)
        pts3d = np.asarray(init_res.points)

        f0.R, f0.t = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
        f1.R, f1.t = R21.astype(np.float32), t21.astype(np.float32)

        kf0 = st.add_keyframe(
            f0.R, f0.t, f0.xy_un, f0.level, f0.angle, f0.desc, f0.valid,
            frame_id=f0.frame_id, timestamp=f0.timestamp,
        )
        kf1 = st.add_keyframe(
            f1.R, f1.t, f1.xy_un, f1.level, f1.angle, f1.desc, f1.valid,
            frame_id=f1.frame_id, timestamp=f1.timestamp,
        )
        feats0 = np.nonzero(good)[0]
        ids = st.add_points(
            pts3d[feats0], f0.desc[feats0], ref_kf=kf1, first_kf_id=st.next_kf_id - 1
        )
        for mp, fi in zip(ids, feats0):
            st.add_observation(int(mp), kf0, int(fi))
            st.add_observation(int(mp), kf1, int(idx[fi]))

        # global BA on the 2-KF map (Tracking.cc:476)
        self._two_frame_global_ba(kf0, kf1, ids)

        # gauge: scale to unit median depth (Tracking.cc:479-503)
        xc = st.mp_xyz[ids] @ st.kf_R[kf1].T + st.kf_t[kf1]
        med = float(np.median(xc[:, 2]))
        if med <= 0 or (~st.mp_valid[ids]).all():
            # degenerate: roll back (Tracking.cc:482-487)
            self.reset()
            return
        st.kf_t[kf1] /= med
        st.mp_xyz[ids] /= med
        # attributes AFTER the gauge scaling: the scale bands (min/max
        # distance) and normals must describe the scaled geometry, or the
        # level prediction and the min/max-dist frustum gates reject nearly
        # every point until the first mapping pass recomputes them. (The
        # reference computes them pre-scale, Tracking.cc:442-467, and
        # tolerates the staleness only because its frame-to-frame tracker
        # does not consult them; the fused device tracker does.) Mirror
        # first so the attrs kernel gathers on device — init runs against
        # the live camera clock, every ms drops frames.
        self.mapper.dmap.sync_keyframe(st, kf0)
        self.mapper.dmap.sync_keyframe(st, kf1)
        self.mapper.dmap.sync_points(st, ids)
        st.update_point_attributes(ids, cfg.scale_factors,
                                   dmap=self.mapper.dmap)

        if self.kfdb is not None:
            self.kfdb.add(kf0, st.kf_desc[kf0], st.kf_feat_valid[kf0])
            self.kfdb.add(kf1, st.kf_desc[kf1], st.kf_feat_valid[kf1])
        covis = st.covisibility()
        st.update_spanning_tree(kf1, covis[kf1])
        # re-sync the attrs writeback into the mirror (keyframe rows and
        # point geometry were synced before the attrs pass above)
        self.mapper.dmap.sync_points(st, ids)

        # frame bookkeeping -> WORKING
        f1.point[:] = -1
        f1.point[idx[feats0]] = ids
        f1.point_gen[idx[feats0]] = st.mp_gen[ids]
        f1.R, f1.t = st.kf_R[kf1].copy(), st.kf_t[kf1].copy()
        tr = self.tracker
        tr.ref_kf = kf1
        tr.last_kf_frame_id = f1.frame_id
        tr.state = TrackState.WORKING
        self.mapper.probation.extend((int(i), int(st.mp_gen[i])) for i in ids)

    def _two_frame_global_ba(self, kf0: int, kf1: int, ids: np.ndarray, iters: int = 20):
        st, cfg = self.map, self.cfg
        # static capacity: init produces <= one point per f0 feature (the
        # init extractor runs with a 2x budget, Tracking.cc:126)
        P = max(2048, 1 << int(np.ceil(np.log2(2 * cfg.n_features))))
        points = np.zeros((P, 3), np.float32)
        points[: len(ids)] = st.mp_xyz[ids]
        pvalid = np.zeros(P, bool)
        pvalid[: len(ids)] = True
        O = 2 * P
        obs_kf = np.zeros(O, np.int32)
        obs_pt = np.zeros(O, np.int32)
        obs_uv = np.zeros((O, 2), np.float32)
        obs_w = np.ones(O, np.float32)
        obs_valid = np.zeros(O, bool)
        n = 0
        for i, p in enumerate(ids):
            for s in np.nonzero(st.mp_obs_kf[p] >= 0)[0]:
                k = int(st.mp_obs_kf[p, s])
                f = int(st.mp_obs_feat[p, s])
                obs_kf[n] = 0 if k == kf0 else 1
                obs_pt[n] = i
                obs_uv[n] = st.kf_xy[k, f]
                obs_w[n] = cfg.inv_sigma2[min(int(st.kf_level[k, f]), cfg.n_levels - 1)]
                obs_valid[n] = True
                n += 1
        prob = ba.BAProblem(
            kf_R=jnp.array(np.stack([st.kf_R[kf0], st.kf_R[kf1]])),
            kf_t=jnp.array(np.stack([st.kf_t[kf0], st.kf_t[kf1]])),
            kf_fixed=jnp.array([True, False]),
            points=jnp.array(points), point_valid=jnp.array(pvalid),
            obs_kf=jnp.array(obs_kf), obs_pt=jnp.array(obs_pt),
            obs_uv=jnp.array(obs_uv), obs_w=jnp.array(obs_w),
            obs_valid=jnp.array(obs_valid), K4=jnp.array(cfg.K4),
        )
        import jax

        res = ba.bundle_adjust(prob, iterations=iters)
        kf_R1, kf_t1, points = jax.device_get(
            (res.kf_R[1], res.kf_t[1], res.points))  # one pull
        st.kf_R[kf1] = kf_R1
        st.kf_t[kf1] = kf_t1
        st.mp_xyz[ids] = points[: len(ids)]

    # ------------------------------------------------------------------

    def _on_new_keyframe(self, frame: Frame):
        if self.cfg.async_mapping:
            # insert synchronously (the tracker needs the reference KF and
            # its observations), then queue the heavy stages one-per-frame.
            # A newly arriving KF cancels a queued-but-unstarted local BA —
            # the reference's InterruptBA semantics (LocalMapping.cc:130-136)
            with self.tracer.stage("mapping"):
                kf = self.mapper.insert_keyframe(frame)
            if kf < 0:
                return  # capacity-refused insertion (alloc_kf)
            self.tracker.ref_kf = kf
            self.tracker.refresh_fused_slice()
            for _, stages in self.pending:
                # InterruptBA semantics (LocalMapping.cc:541-544 -> g2o
                # setForceStopFlag, Optimizer.cc:58-59):
                # - BA not yet started: cancel it entirely;
                # - stage 1 running/done but stage 2 not dispatched: abort —
                #   write back the 5-iteration state without the outlier
                #   erase passes (Optimizer.cc:450-452 + bDoMore=false)
                if "ba_d" in stages:
                    for s_ in ("ba_d", "ba_m", "ba2_d", "ba2_m"):
                        if s_ in stages:
                            stages.remove(s_)
                elif "ba2_d" in stages:
                    i = stages.index("ba2_d")
                    del stages[i:i + 2]
                    stages.insert(i, "ba_abort")
            self.pending.append((kf, list(self.mapper.STAGES) + ["loop"]))
            return
        with self.tracer.stage("mapping"):
            kf = self.mapper.process(frame)
        if kf < 0:
            return  # capacity-refused insertion (alloc_kf)
        self.tracker.ref_kf = kf
        self._loop_close(kf)
        self.tracker.refresh_fused_slice()

    def _run_pending_stage(self) -> str:
        kf, stages = self.pending[0]
        stage = stages.pop(0)
        if not stages:
            self.pending.pop(0)
        if not self.map.kf_valid[kf]:
            return stage  # culled while queued
        if stage == "loop":
            # loop detection/correction reads host mp attributes: flush any
            # deferred attrs writeback first
            self.mapper.drain_attrs()
            self._loop_close(kf)
        else:
            self.mapper.run_stage(kf, stage)
        return stage

    def _loop_close(self, kf: int):
        if self.loop_closer is None:
            return
        with self.tracer.stage("loop_closing"):
            closed = self.loop_closer.process(kf)
        if closed:
            self.n_loops_closed += 1
            self.tracer.log("loop_closed", kf=int(kf))
            # the correction rewrote poses and points wholesale
            self.mapper.dmap.sync_all(self.map)
            self.tracker.force_relocalization()
            if self.cfg.post_loop_gba:
                with self.tracer.stage("global_ba"):
                    self.global_ba()

    # ------------------------------------------------------------------
    # global bundle adjustment over the whole map (Optimizer.cc:38-152)
    # ------------------------------------------------------------------

    def build_global_ba_problem(self):
        """Full-map BAProblem at fixed capacity (max_kf, max_mp, gba_obs):
        every valid keyframe is a vertex (oldest one fixed as the gauge,
        GlobalBundleAdjustemnt fixes mnId==0, Optimizer.cc:87), every valid
        point a landmark, observations gathered from the adjacency."""
        st, cfg = self.map, self.cfg
        pts = np.nonzero(st.mp_valid)[0]
        kf_index = np.where(
            st.kf_valid, np.arange(st.max_kf), -1
        ).astype(np.int32)
        O = cfg.gba_obs
        obs_kf = np.zeros(O, np.int32)
        obs_pt = np.zeros(O, np.int32)
        obs_uv = np.zeros((O, 2), np.float32)
        obs_w = np.ones(O, np.float32)
        obs_valid = np.zeros(O, bool)
        from ..native import build_ba_obs_native

        native = build_ba_obs_native(st, pts, kf_index, O)
        if native is not None:
            okf, _, ofe, osp, osk = native
        else:
            okf, ofe, osp, osk = [], [], [], []
            for p in pts:
                for s in np.nonzero(st.mp_obs_kf[p] >= 0)[0]:
                    if len(okf) >= O:
                        break
                    okf.append(int(st.mp_obs_kf[p, s]))
                    ofe.append(int(st.mp_obs_feat[p, s]))
                    osp.append(int(p))
                    osk.append(int(st.mp_obs_kf[p, s]))
            okf, ofe = np.array(okf, np.int32), np.array(ofe, np.int32)
            osp, osk = np.array(osp, np.int32), np.array(osk, np.int32)
        n = len(okf)
        obs_kf[:n] = okf
        obs_pt[:n] = osp           # kf_index is the identity on valid KFs
        obs_uv[:n] = st.kf_xy[osk, ofe]
        lv = np.clip(st.kf_level[osk, ofe], 0, cfg.n_levels - 1)
        obs_w[:n] = cfg.inv_sigma2[lv]
        obs_valid[:n] = True

        fixed = ~st.kf_valid.copy()
        if st.kf_valid.any():
            gauge = int(
                np.nonzero(st.kf_valid)[0][
                    np.argmin(st.kf_frame_id[st.kf_valid])
                ]
            )
            fixed[gauge] = True
        return ba.BAProblem(
            kf_R=jnp.array(st.kf_R), kf_t=jnp.array(st.kf_t),
            kf_fixed=jnp.array(fixed),
            points=jnp.array(st.mp_xyz), point_valid=jnp.array(st.mp_valid),
            obs_kf=jnp.array(obs_kf), obs_pt=jnp.array(obs_pt),
            obs_uv=jnp.array(obs_uv), obs_w=jnp.array(obs_w),
            obs_valid=jnp.array(obs_valid), K4=jnp.array(cfg.K4),
        ), n

    def global_ba(self, iterations: int | None = None):
        """Run global BA and write back poses and points. On a multi-device
        mesh the map-partitioned solver runs (points/observations sharded,
        reduced camera system combined by one psum — SURVEY §2.3's
        scaling axis); single-device falls back to the implicit-Schur PCG.
        The reference's global variant does not erase outlier observations
        (only local BA does, Optimizer.cc:453-470)."""
        import jax

        st, cfg = self.map, self.cfg
        prob, n_obs = self.build_global_ba_problem()
        if n_obs < 20:
            return
        iters = cfg.gba_iterations if iterations is None else iterations
        devices = jax.devices()
        if len(devices) > 1 and cfg.distributed_gba:
            from jax.sharding import Mesh
            from ..parallel import shard_ba_problem, sharded_bundle_adjust

            sprob = shard_ba_problem(prob, len(devices))
            mesh = Mesh(np.array(devices), ("points",))
            R, t, pts_sh, _chi2, _out = sharded_bundle_adjust(
                sprob, mesh, iterations=iters)
            res = ba.BAResult(
                kf_R=R, kf_t=t,
                points=np.asarray(pts_sh).reshape(-1, 3)[: st.max_mp],
                chi2=_chi2, obs_outlier=_out,
            )
        else:
            res = gba.bundle_adjust_large(
                prob, iterations=iters, cg_iters=cfg.gba_cg_iters,
            )
        kf_R = np.asarray(res.kf_R)
        kf_t = np.asarray(res.kf_t)
        fixed = np.asarray(prob.kf_fixed)
        live = st.kf_valid & ~fixed
        st.kf_R[live] = kf_R[live]
        st.kf_t[live] = kf_t[live]
        st.mp_xyz[st.mp_valid] = np.asarray(res.points)[st.mp_valid]
        # refresh the mirror FIRST so the attrs pass gathers the post-BA
        # poses/points on device (index-only upload), then sync the
        # recomputed attributes back into it
        self.mapper.dmap.sync_all(st)
        ids = np.nonzero(st.mp_valid)[0]
        st.update_point_attributes(ids, cfg.scale_factors,
                                   dmap=self.mapper.dmap)
        self.mapper.dmap.sync_points(st, ids)

    # ------------------------------------------------------------------

    def keyframe_trajectory(self) -> list[tuple[float, np.ndarray, np.ndarray]]:
        """Keyframe poses in TUM order (main.cc:226-245)."""
        st = self.map
        out = []
        order = np.argsort(st.kf_timestamp)
        for k in order:
            if st.kf_valid[k]:
                out.append((float(st.kf_timestamp[k]), st.kf_R[k].copy(), st.kf_t[k].copy()))
        return out

    @property
    def n_keyframes(self) -> int:
        return int(self.map.kf_valid.sum())

    @property
    def n_points(self) -> int:
        return int(self.map.mp_valid.sum())

"""The SLAM estimator: full per-frame pipeline orchestration.

≙ ``CSRBAStereoSLAMEstimator`` (reference
src/CSRBAStereoSLAMEstimator.{h,cpp}): acquisition → VO (with the adaptive
detector-threshold retry protocol) → keyframe-check triggers → BoW query →
similar-KF selection → batched data-association cascade → loop-closure
confirmation → feature-ID propagation → SRBA insertion → pose bookkeeping →
final global pose-graph optimization and trajectory outputs.

Host code here is orchestration only — every hot stage (frontend extraction,
tracking/solving, BoW scoring, DA cascade, window BA, pose graph) is one of
the fixed-shape jitted device programs from ``srba_slam_tpu.ops`` /
``srba_slam_tpu.models``. In batched mode the host blocks on the device
exactly once per frame batch: keyframe checks are dispatched speculatively
(outcome predicted, device rows written ahead, decisions retro-applied —
see the "speculative KF checks" section below) and SRBA window solves
queue until the next bulk pull.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field

import numpy as np

import jax
import jax.numpy as jnp

from srba_slam_tpu.config import (
    GeneralOptions, SRBAStereoSLAMOptions, VOOptions, load_config,
)
from srba_slam_tpu.models.bow import BoWDatabase, Vocabulary
from srba_slam_tpu.models.data_association import S_TRACKED
# (query_and_associate is imported lazily inside _kf_check)
from srba_slam_tpu.models.keyframe import KeyframeStore
from srba_slam_tpu.models.srba import SRBAEngine, SRBAParams
from srba_slam_tpu.models.vo import StereoVOEngine
from srba_slam_tpu.ops.posegraph import optimize_pose_graph
from srba_slam_tpu.utils import se3_np
from srba_slam_tpu.utils.profiler import Profiler
from srba_slam_tpu.utils.pull import bulk_pull
from srba_slam_tpu.utils.thresholds import (
    update_rotation_threshold, update_translation_threshold,
)

MAX_SIMILAR = 5  # prev KF + up to 4 BoW results (reference queries n=4)


@jax.jit
def _slice_frame(feats, j):
    """Gather one frame's FrameFeatures row from a scanned batch in a single
    dispatch (a host-side tree.map would issue one device op per field)."""
    return jax.tree.map(lambda a: a[j], feats)


_BIRTH_DEAD = 1 << 30  # sentinel "no live track" birth value


@jax.jit
def _pack_scan_summary(track_idx, track_valid, m_valid, poses, pose_valid,
                       mean_res, last_inc, seed_birth, ref_thr, j0):
    """Per-frame SCALARS + the tracked-count matrix, computed ON DEVICE.

    The batched loop used to pull the full track lanes (track_idx /
    track_valid / m_valid — 3 x B x K int32 lanes, ~370 KB at B=60) every
    batch just so the host could walk the backpointer chain and count
    per-frame keyframe membership. Both are computable on device: carry a
    per-slot BIRTH frame through the track chains (a track alive at frame
    ``j`` with ``birth <= r`` was continuously m_valid-tracked through
    reference frame ``r``, hence chains to a valid slot there), then
    tracked-from-reference counts are threshold sums. The pull shrinks to
    ~B^2 ints; the lanes stay on device for the (rare) speculation-miss
    replay and the fused check programs.

    ``seed_birth`` [K] encodes the incoming reference state of the
    previous frame's slots: -1 = chained to the CURRENT keyframe
    reference, >=0/anything-smaller-than-j0 = alive but unchained, DEAD =
    no track. ``ref_thr`` (traced scalar) is the absolute frame index of
    the reference active at batch start (-1 = the seed's epoch entry).
    ``j0`` is the batch's absolute start frame (birth values are absolute
    so chains compose across batches).

    Skip frames (invalid pose or <8 matches) KILL keyframe chaining
    exactly like the host walk did (bp reset to -1): alive births clamp
    to the skip frame, so counts against any earlier reference drop to 0
    while chains re-counted from later references are unaffected
    (reference contract: the per-frame trigger semantics of .cpp:366-394).
    """
    b, k = track_idx.shape
    dead = jnp.int32(_BIRTH_DEAD)
    nm = jnp.sum(m_valid.astype(jnp.float32), axis=1).astype(jnp.int32)
    skip = (~pose_valid) | (nm < 8)
    js = j0 + jnp.arange(b, dtype=jnp.int32)

    def step(birth_prev, xs):
        ti, tv, mv, sk, j = xs
        g = jnp.where(tv, birth_prev[ti], dead)
        birth = jnp.where(mv, jnp.where(g == dead, j, g), dead)
        birth = jnp.where(sk & mv, jnp.maximum(birth, j), birth)
        return birth, birth

    _last, births = jax.lax.scan(
        step, seed_birth.astype(jnp.int32),
        (track_idx, track_valid, m_valid, skip, js))
    alive = m_valid[:, None, :]
    # counts as f32 sums (int32 reduces are pathologically slow here)
    thr = jnp.concatenate([ref_thr[None].astype(jnp.int32), js])  # [1+B]
    cnt = jnp.sum(
        ((births[:, None, :] <= thr[None, :, None]) & alive)
        .astype(jnp.float32), axis=-1).astype(jnp.int32)  # [B, 1+B]
    ints = jnp.concatenate([
        nm, pose_valid.astype(jnp.int32), cnt.ravel()])
    floats = jnp.concatenate([poses.ravel(), mean_res, last_inc])
    return ints, floats, births


def _unpack_scan_summary(ints, floats, b: int):
    o = 0
    nm = ints[o:o + b]; o += b
    pose_valid = ints[o:o + b].astype(bool); o += b
    cnt = ints[o:o + b * (1 + b)].reshape(b, 1 + b)
    cnt0, cnt_loc = cnt[:, 0], cnt[:, 1:]
    poses = floats[: b * 6].reshape(b, 6)
    mean_res = floats[b * 6: b * 7]
    last_inc = floats[b * 7: b * 7 + 6]
    return nm, pose_valid, cnt0, cnt_loc, poses, mean_res, last_inc


@jax.jit
def _chain_slotmaps(track_idx, track_valid, m_valid, pose_valid,
                    init_map, reset_mask):
    """Actual backpointer SLOT MAPS, on device (dispatched once per batch
    AFTER the host walk, when the predicted keyframe resets are known).

    Returns ``maps`` [B, K]: for each frame, the reference-KF slot each
    track chains back to (-1 = unchained) — the exact value the host walk
    used to compute per frame. ``maps[j]`` is PRE-reset at reset frames
    (matching the snapshot the speculation machinery takes before a
    predicted insert re-references the chains); the carried state resets
    after. ``maps[-1]`` seeds the next batch's call; a pull of one row
    serves id materialization (`_materialize_engine_ids`) and the
    speculation-miss replay."""
    b, k = track_idx.shape
    nm = jnp.sum(m_valid.astype(jnp.float32), axis=1).astype(jnp.int32)
    skip = (~pose_valid) | (nm < 8)
    idx = jnp.arange(k, dtype=jnp.int32)

    def step(M, xs):
        ti, tv, mv, sk, rs = xs
        chained = jnp.where(tv & mv, M[ti], -1)
        chained = jnp.where(sk, -1, chained)
        out = chained
        carry = jnp.where(rs, jnp.where(mv, idx, -1), chained)
        return carry, out

    _last, maps = jax.lax.scan(
        step, init_map.astype(jnp.int32),
        (track_idx, track_valid, m_valid, skip, reset_mask))
    return maps


class _FrameUploader:
    """Background host→device frame staging for the batched loop.

    Enqueueing one whole-batch upload per loop iteration from the main
    thread leaves the host→device link idle during every blocking pull
    wait (the only points the main thread yields) and head-of-line blocks
    the next pull request behind a whole batch of frame bytes. A worker
    thread feeding PER-FRAME uploads keeps the link busy through the
    pulls (blocking device_gets release the GIL) and bounds any pull's
    queueing delay at one frame.

    ``next()`` yields ``((dev_lefts, dev_rights), (host_l, host_r))``
    per batch — per-frame device arrays (stacked on device by
    ``_dispatch_scan``) plus the stacked host copies kept for the
    adaptive-retry tail re-dispatch.  ``drain_and_stop()`` returns the
    host copies of staged-but-unconsumed batches so an early stop
    (max_num_kfs / to_step) never loses prefetched frames.
    """

    def __init__(self, frame_iter, batch: int, depth: int = 2,
                 stats: list | None = None):
        import queue
        import threading

        self._it = frame_iter
        self._batch = batch
        self._q = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        # telemetry sink (estimator's lat["uploads"]): per-batch enqueue
        # wall time + bytes, measured ON the worker thread — the in-run
        # effective link speed, so a phase breakdown can attribute upload
        # waits to bandwidth vs overlap without a separate (time-shifted,
        # contention-confounded) link measurement
        self._stats = stats
        self._t = threading.Thread(target=self._run, daemon=True,
                                   name="srba-frame-uploader")
        self._t.start()

    def _run(self):
        import time as _time
        try:
            while not self._stop.is_set():
                lefts, rights, dev_l, dev_r = [], [], [], []
                t0 = _time.perf_counter()
                for _ in range(self._batch):
                    try:
                        l, r = next(self._it)
                    except StopIteration:
                        break
                    lefts.append(np.asarray(l))
                    rights.append(np.asarray(r))
                    # per-frame uploads: small chunks, link never idles
                    dev_l.append(jnp.asarray(lefts[-1]))
                    dev_r.append(jnp.asarray(rights[-1]))
                if not lefts:
                    self._q.put(None)
                    return
                if self._stats is not None:
                    self._stats.append(dict(
                        n=len(lefts),
                        bytes=sum(a.nbytes for a in lefts) * 2,
                        t0=t0, t1=_time.perf_counter()))
                self._q.put(((dev_l, dev_r),
                             (np.stack(lefts), np.stack(rights))))
            self._q.put(None)
        except BaseException as e:  # re-raised on the consumer side
            self._q.put(e)

    def next(self):
        item = self._q.get()
        if isinstance(item, BaseException):
            raise item
        return item

    def drain_and_stop(self) -> list:
        """Stop the worker; return the HOST (lefts, rights) chunk of every
        staged-but-unconsumed batch, in order."""
        import queue

        self._stop.set()
        leftovers = []
        while self._t.is_alive() or not self._q.empty():
            try:
                item = self._q.get(timeout=0.05)
            except queue.Empty:
                continue
            if item is None:
                continue
            if isinstance(item, BaseException):
                raise item
            leftovers.append(item[1])
        self._t.join()
        return leftovers


@dataclass
class StepResult:
    """What happened to one frame (for logging / tests)."""

    frame_idx: int
    vo_valid: bool = False
    n_stereo_matches: int = 0
    tracked_from_last_kf: int = 0
    kf_check: bool = False
    inserted_kf: int | None = None
    loop_closure_with: int | None = None
    # confirmed LC whose edge the consistency validator later rejected
    # (layer A at creation or layer B post-solve; see SRBAParams.lc_validate)
    lc_rejected_with: int | None = None
    best_tracked: int = 0
    define_kf_ms: float = 0.0


@dataclass
class TStatsSRBA:
    """≙ TStatsSRBA (reference utils.h:492-507) — per-insertion stats."""

    time_ms: float
    number_kfs: int
    number_feats_new: int
    number_feats_common: int


class SRBAStereoSLAMEstimator:
    def __init__(self, general: GeneralOptions | None = None,
                 options: SRBAStereoSLAMOptions | None = None,
                 vo_options: VOOptions | None = None,
                 capacity: int = 512, max_kfs: int = 512):
        self.general = general or GeneralOptions()
        self.opts = options or SRBAStereoSLAMOptions()
        self.vo_opts = vo_options or VOOptions()
        self.capacity = capacity
        self.max_kfs = max_kfs
        self.profiler = Profiler()
        # strict solve scheduling: land every window solve immediately after
        # its insertion (per-frame and batched modes then commit solves at
        # IDENTICAL points, so poses — not just decisions — match to ~1e-5;
        # the default pipelined scheduling trades that for throughput)
        self.solve_sync = False
        # intermediate scheduling (the measured middle of the Pareto —
        # tools/solve_sync_probe.py, BASELINE.md): flush QUEUED window
        # solves right before the NEXT insertion, so every insertion seeds
        # from the previous insertion's OPTIMIZED state while the solve
        # itself still overlaps the frames in between. Ignored when
        # solve_sync is set (strict wins).
        self.solve_flush_before_insert = False
        # latency log (always on; appends only): per-batch VO timing
        # ("batches": j0, b, t_dispatch, t_pull) and keyframe-decision
        # resolution lag ("checks": checked frame_idx, frame_idx at
        # resolution, wall time) — the raw material for bench.py's
        # frame->pose latency and KF-decision-lag percentiles
        self.lat: dict[str, list] = {"batches": [], "checks": []}
        self._initialized = False

    # ------------------------------------------------------------------ init
    @staticmethod
    def from_config(path: str, **kw) -> "SRBAStereoSLAMEstimator":
        gen, opts, vo = load_config(path)
        est = SRBAStereoSLAMEstimator(gen, opts, vo, **kw)
        return est

    def initialize(self, vocabulary: Vocabulary | None = None):
        """≙ initialize() (reference .cpp:1099-1339)."""
        o = self.opts
        self.cam = o.camera
        # VO engine with the n_feats / fast_th overrides (reference .cpp:1140-1142)
        self.vo_opts.n_feats = o.n_feats
        self.vo_opts.fast_th = o.detect_fast_th
        self.vo = StereoVOEngine(self.cam, self.vo_opts, capacity=self.capacity)
        # RECTIFY stage (≙ stereo-vo rectification, config_img_dir_example
        # .ini:36 + CAMERA_* dist rows): when the rig declares unrectified
        # images with real distortion, precompute per-eye undistortion grids
        # once; the remap fuses into the frontend program
        dist_l = list(o.camera_dist_l or [])
        dist_r = list(o.camera_dist_r or [])
        if not self.vo_opts.rectified_images and (
                any(dist_l) or any(dist_r)):
            from srba_slam_tpu.ops.rectify import build_maps

            self.vo.rect_maps = (
                build_maps(self.cam.width, self.cam.height, self.cam.fx_l,
                           self.cam.fy_l, self.cam.cx_l, self.cam.cy_l,
                           dist=dist_l),
                build_maps(self.cam.width, self.cam.height, self.cam.fx_r,
                           self.cam.fy_r, self.cam.cx_r, self.cam.cy_r,
                           dist=dist_r),
            )
        # vocabulary: explicit > config file > on-the-fly training later
        if vocabulary is None and o.voc_filename and os.path.exists(o.voc_filename):
            vocabulary = Vocabulary.load_dbow2(o.voc_filename)
        self._pending_voc_training = vocabulary is None
        self._voc_buffer = []  # (frame_idx, desc handle, valid handle)
        self.bow = (
            BoWDatabase(vocabulary, max_kfs=self.max_kfs) if vocabulary else None
        )
        self.store = KeyframeStore(max_kfs=self.max_kfs, capacity=self.capacity)
        from srba_slam_tpu.utils.stats import VerboseLogger

        self.log = VerboseLogger(self.general.verbose_level)
        self.rba = SRBAEngine(
            self.cam,
            SRBAParams(
                submap_size=o.srba_submap_size,
                max_tree_depth=o.srba_max_tree_depth,
                max_optimize_depth=o.srba_max_optimize_depth,
                min_obs_to_loop_closure=o.min_obs_to_loop_closure,
                use_robust_kernel=o.srba_use_robust_kernel,
                use_robust_kernel_stage1=o.srba_use_robust_kernel_stage1,
                kernel_param=o.srba_kernel_param,
                std_noise_pixels=o.std_noise_pixels,
                max_kfs=self.max_kfs,
                anchor_prior_w_rot=o.anchor_prior_w_rot,
                anchor_prior_w_trans=o.anchor_prior_w_trans,
            ),
            logger=VerboseLogger(self.general.verbose_level),
            on_commit=self._on_rba_commit,
            lazy=True,
        )
        self.rba.p.lc_validate = o.lc_validate
        self.rba.p.lc_reject_drift_frac = o.lc_reject_drift_frac
        self.rba.p.lc_reject_floor_m = o.lc_reject_floor_m
        self.rba.p.lc_chi2_px = o.lc_chi2_px
        self.rba.on_lc_reject = self._on_lc_reject
        # camera-on-robot extrinsic (≙ reference .cpp:1106-1112): the
        # configured pose (x y z, yaw pitch roll in degrees) composed with the
        # fixed (-90°, 0, -90°) image-to-camera axis swap. All INTERNAL
        # bookkeeping stays in the KF0-camera frame; the extrinsic is applied
        # at the boundaries — world outputs T_world = E ∘ T_cam ∘ E⁻¹ (KF
        # poses, ≙ .cpp:900-916/:977-987) and the current camera-in-world
        # pose E ∘ T_cam (≙ m_current_pose, .cpp:922/:1112).
        p = list(self.opts.camera_pose_on_robot or []) + [0.0] * 6
        cfg_pose = se3_np.from_xyz_ypr(
            p[0], p[1], p[2],
            np.deg2rad(p[3]), np.deg2rad(p[4]), np.deg2rad(p[5]))
        axis_swap = se3_np.from_xyz_ypr(
            0.0, 0.0, 0.0, np.deg2rad(-90.0), 0.0, np.deg2rad(-90.0))
        self.sensor_pose = se3_np.compose(cfg_pose, axis_swap)
        self.sensor_pose_inv = se3_np.inverse(self.sensor_pose)
        # pose state (KF0-camera frame)
        self.current_pose = np.zeros(6)
        self.last_kf_pose = np.zeros(6)
        self.incr_from_last_kf = np.zeros(6)
        self.incr_from_last_check = np.zeros(6)
        # dynamic thresholds (working values start at the config limits;
        # hard force-limits are 2x — reference .cpp:1163-1164)
        self.updated_translation_th = float(self.opts.max_translation)
        self.updated_rotation_th = float(self.opts.max_rotation)
        # RANSAC hypothesis budget from the configured confidence
        # (≙ ransac_fit_prob -> cv::findFundamentalMat iterations,
        # reference .cpp:2043)
        from srba_slam_tpu.ops.ransac import hypotheses_for_prob

        self._ransac_n_hyp = hypotheses_for_prob(self.opts.ransac_fit_prob)
        self.next_match_id = 0
        self.frame_idx = -1
        # speculative-check state (batched mode): deferred keyframe checks,
        # track backpointers to the latest (possibly speculative) keyframe,
        # and the dirty flag for lazy pose re-anchoring
        self._spec: list[dict] = []
        # deferred checks planned during the current batch walk but not yet
        # dispatched — fused_checks_batch runs them all in ONE jitted call
        self._check_plan: list[dict] = []
        # walk-time (frame, t_chk, r_chk, was_check) trigger norms since the
        # oldest unresolved check — lets _demote_shrink_miss prove a
        # deferred threshold shrink immaterial instead of replaying
        self._walk_log: list[tuple] = []
        # inside a _process_frames walk (mid-walk guard resolutions must use
        # the classic replay: the fast path re-walks the full tail, which
        # would double-walk the caller's remaining frames)
        self._in_walk = False
        self._bp: np.ndarray | None = None
        self._ref_ids: np.ndarray | None = None
        self._last_m_valid = None
        self._bp_live = False  # batch frames processed since the last sync
        # ---- on-device track-chain state (the virtual backpointer mode) --
        # During the batched walk, track identity lives ON DEVICE: the scan
        # summary ships only per-frame scalars + the tracked-count matrix
        # (see _pack_scan_summary); the actual slot maps are maintained by
        # one _chain_slotmaps dispatch per batch and pulled only at id
        # materialization or on a speculation miss.
        self._virtual_bp = False       # device chain state is authoritative
        self._ref_frame: int | None = None  # absolute frame of the current
        # track reference (None = the host-seeded epoch entry)
        self._chain_entry_dev = None   # [K] i32 slot map at last walked frame
        self._last_mv_dev = None       # [K] bool m_valid of last walked frame
        self._last_skip = False        # last walked frame was a skip frame
        self._scan_frame0 = 1          # absolute scan-frame counter (birth
        # values; strictly monotone, host-seed sentinels are -1/0 < 1)
        self._chain_pulled = None      # (bp, mv) prefetched by the finish pull
        self._da_dead = False  # appearance regime: does DA fail even at
        # short range? (learned from non-forced checks; the predictor)
        self._replay_flag = False  # set by _miss_recover; callers inspect
        self._pose_dirty = False
        self.kf_stats: list[TStatsSRBA] = []
        self.step_log: list[StepResult] = []
        # DA RNG: a plain host counter; per-check seeds ride the dispatch as python ints
        # for free and PRNG keys are built in-program (a chained
        # jax.random.split per check was a ~1-2 ms jitted dispatch each)
        self._da_seed = 7
        self.query_log: list = []  # (frame_idx, scores, ids) per KF check
        from srba_slam_tpu.utils.debug_dumps import DebugDumper

        self.debug = DebugDumper(
            os.path.join(self.general.out_dir or "out", "debug"),
            enabled=self.general.debug,
        )
        self._initialized = True

    def _skip_from_step(self, it):
        """Consume (and count) the first ``from_step`` frames unprocessed
        (≙ the from_step skip of reference .cpp:64-70: skipped frames
        advance the frame counter so to_step stays an absolute index)."""
        while self.frame_idx + 1 < self.general.from_step:
            try:
                next(it)
            except StopIteration:
                break
            self.frame_idx += 1
        return it

    def _pause_each_iteration(self):
        """≙ pause_at_each_iteration -> mrpt::system::pause()
        (reference .cpp:934-935); only meaningful on an interactive tty."""
        if not self.general.pause_at_each_iteration:
            return
        import sys

        if sys.stdin is not None and sys.stdin.isatty():
            input("Press <enter> to continue...")

    # ----------------------------------------------------------------- loop
    def perform_stereo_slam(self, frame_source) -> list[StepResult]:
        """≙ performStereoSLAM() main loop (reference .cpp:29-937)."""
        assert self._initialized, "call initialize() first"
        it = self._skip_from_step(iter(frame_source))
        for left, right in it:
            self.step(left, right)
            self._pause_each_iteration()
            if self.general.max_num_kfs and self.store.n_kfs >= self.general.max_num_kfs:
                break
            if self.general.to_step and self.frame_idx >= self.general.to_step:
                break
        return self.step_log

    # ---------------------------------------------------------- batched loop
    def perform_stereo_slam_batched(self, frame_source, batch: int = 8):
        """Batched main loop: B frames per device dispatch (lax.scan VO) and
        ONE blocking host transfer per batch — keyframe checks are
        dispatched speculatively and their pulls merge into the NEXT batch's
        transfer (see :meth:`_defer_check`), so the loop runs at ~1 sync
        per batch regardless of how many keyframes it inserts; decisions
        are identical to per-frame stepping (asserted by
        tests/test_batch_mode.py, including the speculation-miss replay)."""
        assert self._initialized, "call initialize() first"
        import itertools

        stashed = getattr(self, "_stashed_frames", None) or []
        self._stashed_frames = None
        it = itertools.chain(iter(stashed), iter(frame_source))
        it = self._skip_from_step(it)
        if self.store.n_kfs == 0 or self.vo._prev is None:
            # first frame bootstraps KF0 through the normal path; a resumed
            # run (checkpoint restores SLAM state but not the last frame's
            # device features) re-establishes the tracking reference the
            # same way
            try:
                left, right = next(it)
            except StopIteration:
                return self.step_log
            self.step(left, right)
        self._sync_bp_from_engine()

        # software pipeline: batch n+1's VO scan is dispatched from INSIDE
        # batch n's _process_scan, immediately after batch n's pull and
        # threshold drift — so the next batch always launches with its final
        # thresholds (no speculative scan to discard when the adaptive drift
        # fires; matches hovering around 1.2*adaptive_th made that discard
        # happen EVERY batch) while its device compute still overlaps all of
        # batch n's keyframe logic and batch n+1's pull wait.  Frame uploads
        # run continuously on the _FrameUploader worker thread (per-frame
        # chunks; see its docstring for the link-utilization model).
        up = _FrameUploader(it, batch,
                            stats=self.lat.setdefault("uploads", []))
        try:
            cur = up.next()
            disp = (
                self._dispatch_scan(*cur[0], host=cur[1]) if cur else None
            )
            nxt = up.next() if disp is not None else None
            while disp is not None:
                def next_fn(chain_disp, nd=nxt):
                    return self._dispatch_scan(*nd[0], chain=chain_disp,
                                               host=nd[1])

                disp = self._process_scan(
                    disp, next_fn if nxt is not None else None)
                n_spec_ins = sum(1 for c in self._spec if c["ins"])
                stop = False
                if self.general.max_num_kfs and \
                        self.store.n_kfs + n_spec_ins >= \
                        self.general.max_num_kfs:
                    # the predicted count includes unresolved speculative
                    # inserts; a predicted insert that resolves to no-insert
                    # would stop the run short of what per-frame mode
                    # produces — resolve first and re-evaluate on the
                    # COMMITTED count
                    self._resolve_pending_checks()
                    if self.store.n_kfs >= self.general.max_num_kfs:
                        stop = True
                if self.general.to_step and \
                        self.frame_idx >= self.general.to_step:
                    stop = True
                if stop:
                    break
                if disp is not None and nxt is not None:
                    nxt = up.next()
        finally:
            leftovers = up.drain_and_stop()
        self._finish_batched()
        if disp is not None:
            # a stop condition fired with prefetched-but-unprocessed chunks
            # in hand: stash them so callers sharing the frame iterator (or a
            # follow-up perform call) don't silently lose frames to the
            # prefetch
            if nxt is not None:
                leftovers.insert(0, nxt[1])
            if leftovers:
                self._stashed_frames = [fr for c in leftovers
                                        for fr in zip(*c)]
        return self.step_log

    def step_batch(self, lefts: np.ndarray, rights: np.ndarray):
        """Process B frames with one VO dispatch + one bulk transfer
        (synchronous semantics: all checks resolved on return)."""
        if self._bp is None or not self._spec:
            self._sync_bp_from_engine()
        self._process_scan(self._dispatch_scan(lefts, rights))
        self._finish_batched()

    def _dispatch_scan(self, lefts, rights, chain: dict | None = None,
                       host: tuple | None = None, j0: int | None = None) -> dict:
        """Dispatch one vo_scan batch (async). ``lefts``/``rights`` may be
        host numpy, already-staged device arrays, or LISTS of per-frame
        device arrays from the _FrameUploader (stacked here on device — a
        cheap async dispatch). ``chain`` continues from an earlier
        un-processed dispatch's device outputs (prefetch); otherwise the
        scan chains from the engine's current state. ``host``, when given,
        holds the numpy copies kept for the adaptive-retry tail re-dispatch
        (avoids a device->host download of the frames)."""
        from srba_slam_tpu.models.vo import vo_scan

        eng = self.vo
        o = eng.opts
        if isinstance(lefts, (list, tuple)):
            lefts = jnp.stack(lefts)
        if isinstance(rights, (list, tuple)):
            rights = jnp.stack(rights)
        prev_feat = chain["last_feat"] if chain else eng._prev
        prev_inc = (
            chain["last_inc"] if chain
            else jnp.asarray(eng._last_pose_inc, jnp.float32)
        )
        last_feat, last_inc, outs = vo_scan(
            jnp.asarray(lefts), jnp.asarray(rights),
            prev_feat, prev_inc,
            # thresholds as python scalars: no transfer rides the dispatch
            # (a device scalar would be one more enqueued transfer)
            self.cam, float(eng.fast_th), int(eng.orb_th),
            k=self.capacity, cell=o.min_distance, max_y_diff=o.max_y_diff,
            oriented=o.orb_oriented,
            n_levels=o.n_octaves,
            kernel_param=o.kernel_param,
            residual_threshold=o.residual_threshold,
            min_mod=o.min_mod_out_vector,
            max_iters_initial=o.initial_max_iters,
            max_iters=o.max_iters,
            min_inliers=o.bad_tracking_th,
            max_incr_cost=o.max_incr_cost,
            robust_1to1=o.enable_robust_1to1_match,
            filter_fund_matrix=o.filter_fund_matrix,
            rect_maps=eng.rect_maps,
        )
        h_l, h_r = host if host is not None else (lefts, rights)
        if j0 is None:
            j0 = self._scan_frame0
            self._scan_frame0 += lefts.shape[0]
        disp = dict(outs=outs, last_feat=last_feat, last_inc=last_inc,
                    b=lefts.shape[0], lefts=h_l, rights=h_r,
                    prev_feat=prev_feat, prev_inc=prev_inc, j0=j0,
                    chain_from=chain, t_dispatch=time.perf_counter())
        if chain is None:
            # synchronous entry (batch start / step_batch): the host chain
            # state is current, so the summary can attach immediately; a
            # PREFETCHED dispatch (chain != None) gets its summary attached
            # by _process_scan after the preceding batch's walk, when the
            # reference is final
            self._attach_summary(disp)
        return disp

    def _attach_summary(self, disp: dict, seed=None):
        """Dispatch the scan-summary pack for ``disp`` (see
        _pack_scan_summary). ``seed`` overrides the birth seed (retry
        tails chain from mid-batch rows); otherwise the seed comes from
        the chain source's births in virtual mode, or is synthesized from
        the host backpointers when (re)entering virtual mode."""
        (feats, track_idx, track_valid, poses, pose_valid, _n_inl,
         mean_res) = disp["outs"]
        if seed is None:
            # pop: holding the chain link would keep every batch's device
            # arrays reachable for the whole run
            ch = disp.pop("chain_from", None)
            if ch is not None and self._virtual_bp and "births" in ch:
                seed = ch["births"][ch["b"] - 1]
            else:
                # (re)enter virtual mode from the host backpointer state:
                # -1 = chained to the current KF reference, 0 = otherwise
                # (0 < any scan frame index, so such tracks count for every
                # in-batch reference — exactly the host reset semantics)
                assert self._bp is not None
                seed = jnp.asarray(
                    np.where(self._bp >= 0, -1, 0).astype(np.int32))
                self._chain_entry_dev = jnp.asarray(
                    self._bp.astype(np.int32))
                self._ref_frame = None
                self._virtual_bp = True
        ref_thr = -1 if self._ref_frame is None else self._ref_frame
        ints, floats, births = _pack_scan_summary(
            track_idx, track_valid, feats.m_valid, poses, pose_valid,
            mean_res, disp["last_inc"], seed, jnp.int32(ref_thr),
            jnp.int32(disp["j0"]))
        disp["pk"] = (ints, floats)
        disp["births"] = births
        disp["seed_birth"] = seed

    def _finish_batch_chain(self, batch_rec: dict, upto: int):
        """After walking batch frames [0, upto): dispatch the slot-map
        chain program (predicted keyframe resets now known) and advance
        the device chain-entry state to the last walked frame."""
        if upto <= 0 or not self._virtual_bp:
            return
        feats = batch_rec["feats"]
        (_f, track_idx, track_valid, _p, pose_valid, _n, _m) =             batch_rec["outs"]
        b = batch_rec["b_full"]
        reset_np = np.zeros(b, bool)
        for r in batch_rec["resets"]:
            reset_np[r] = True
        maps = _chain_slotmaps(track_idx, track_valid, feats.m_valid,
                               pose_valid, batch_rec["entry_dev"],
                               jnp.asarray(reset_np))
        batch_rec["maps"] = maps
        mv_last = feats.m_valid[upto - 1]
        if (upto - 1) in batch_rec["resets"]:
            # maps rows are PRE-reset (snapshot semantics); the chain entry
            # for the next batch is the post-reset identity over the new
            # reference frame's valid slots
            self._chain_entry_dev = jnp.where(
                mv_last, jnp.arange(self.capacity, dtype=jnp.int32),
                jnp.int32(-1))
        else:
            self._chain_entry_dev = maps[upto - 1]
        self._last_mv_dev = mv_last

    def _process_scan(self, disp: dict, next_fn=None):
        """Pull one dispatched batch and run the per-frame keyframe logic.

        ONE blocking transfer serves three purposes: this batch's VO
        outputs, the queued SRBA window solves, and the PREVIOUS batch's
        deferred keyframe-check results (which retro-resolve here — see
        :meth:`_defer_check` for the speculation model).

        Implements the adaptive-threshold retry protocol at batch
        granularity (≙ reference .cpp:271-315): if a frame's stereo matches
        fall below ``adaptive_th_min_matches`` and a threshold can still
        move, the detector thresholds are adjusted and the batch TAIL from
        that frame on is re-dispatched and re-processed at the new
        thresholds — the same frames the per-frame mode would re-process
        with the ``repeat`` request.

        ``next_fn(chain_disp)``, when given, dispatches the NEXT batch's
        scan; it is invoked exactly once, right after this batch's healthy
        threshold drift is applied (so the next scan always launches with
        final thresholds — no speculative dispatch to discard) and chained
        on the final scan state. Returns that dispatch (or None)."""
        b = disp["b"]
        eng = self.vo
        last_feat, last_inc = disp["last_feat"], disp["last_inc"]
        feats = disp["outs"][0]
        if "pk" not in disp:  # prefetched dispatch whose summary never
            self._attach_summary(disp)  # attached (defensive)
        self._dispatch_planned_checks()  # no-op unless a retry/guard path
        # left undispatched plans behind
        pend = self.rba.pending_device_arrays()
        spec = self._spec
        spec_handles = tuple(h for c in spec for h in c["handles"])
        pulled = bulk_pull(disp["pk"] + pend + spec_handles)
        # latency log: the batch's frame poses are ON HOST now — frame f in
        # [j0, j0+b) has frame->pose latency t_pull - max(t_arrival(f),
        # t_dispatch) for whatever arrival model the consumer applies
        self.lat["batches"].append(dict(
            j0=disp["j0"], b=b, t_dispatch=disp.get("t_dispatch", 0.0),
            t_pull=time.perf_counter()))
        (nm, pose_valid, cnt0, cnt_loc, poses, mean_res,
         last_inc_h) = _unpack_scan_summary(pulled[0], pulled[1], b)
        if pend:
            self.rba.commit_pending(pulled[2:2 + len(pend)])
        self._replay_flag = False
        if spec:
            # decision-lag accounting: frames of THIS batch are already in
            # the system when the previous batch's checks resolve here
            self._lat_resolved_at = disp["j0"] + b - 1
            self._resolve_spec(pulled[2 + len(pend):])
            self._lat_resolved_at = None
        self._reanchor_if_dirty()

        batch_rec = dict(feats=feats, outs=disp["outs"], nm=nm,
                         pose_valid=pose_valid, cnt0=cnt0, cnt=cnt_loc,
                         poses=poses, b=b, b_full=b, j0=disp["j0"],
                         resets=[], ref_local=None, h_lanes=None,
                         entry_dev=self._chain_entry_dev)
        if self._replay_flag or not self._virtual_bp:
            # a speculation miss replayed an earlier batch's tail (host
            # backpointers are live now), or virtual mode never engaged:
            # this batch's device summary was packed against PREDICTED
            # reference state — walk it in host mode from the pulled lanes
            # (one extra transfer, miss path only)
            self._pull_host_lanes(batch_rec)

        th = self.opts.adaptive_th_min_matches
        retry_j = None
        # the whole adaptive-threshold protocol is gated on
        # orb_adaptive_fast_th (≙ reference .cpp:271: the retry do-while and
        # the drift adjustments only run when the option is set)
        adaptive = self.opts.orb_adaptive_fast_th
        if adaptive and (not eng.is_fast_th_min() or not eng.is_orb_th_max()):
            below = np.nonzero(nm < th)[0]
            if len(below):
                retry_j = int(below[0])

        if retry_j is not None:
            # frames before the first sub-threshold frame are committed as-is;
            # the record's valid extent shrinks to the head so a later
            # speculation-miss replay never walks into the discarded tail
            # (those frames are re-processed by the re-dispatched scan below)
            batch_rec["b"] = retry_j
            self._process_frames(batch_rec, 0, retry_j)
            self._finish_batch_chain(batch_rec, retry_j)
            eng.retry_step()  # guaranteed to move: gated above on a
                              # movable threshold
            # chain state at the retry point: last processed frame's
            # features (device slice) and its pose increment
            if retry_j > 0:
                chain_feat = _slice_frame(feats, jnp.int32(retry_j - 1))
                # fall back to THIS dispatch's chain start (not the engine's
                # last increment, which is stale inside a nested retry)
                inc = jnp.asarray(disp["prev_inc"], jnp.float32)
                for jj in range(retry_j):
                    if bool(pose_valid[jj]):
                        inc = jnp.asarray(poses[jj].astype(np.float32))
                chain = {"last_feat": chain_feat, "last_inc": inc}
                tail_seed = disp["births"][retry_j - 1]
            else:
                chain = {"last_feat": disp["prev_feat"],
                         "last_inc": disp["prev_inc"]}
                tail_seed = disp["seed_birth"]
            tail = self._dispatch_scan(
                np.asarray(disp["lefts"])[retry_j:],
                np.asarray(disp["rights"])[retry_j:], chain=chain,
                j0=disp["j0"] + retry_j)
            if self._virtual_bp:
                self._attach_summary(tail, seed=tail_seed)
            else:
                self._attach_summary(tail)  # host-seeded (replay happened)
            # the tail's processing dispatches the next batch (thresholds
            # final there); may retry again at lower thresholds
            nxt = self._process_scan(tail, next_fn)
            disp["last_feat"] = tail["last_feat"]
            disp["last_inc"] = tail["last_inc"]
            disp["births"] = tail["births"]
            return nxt

        # healthy-threshold drift (≙ the post-retry adjustments of
        # .cpp:271-314, applied at batch granularity) BEFORE launching the
        # next batch — nothing below reads the detector thresholds
        if adaptive:
            min_matches = int(nm.min()) if b else self.capacity
            eng.drift_thresholds(min_matches, th)
        nxt = next_fn(disp) if next_fn is not None else None

        self._process_frames(batch_rec, 0, b)
        self._finish_batch_chain(batch_rec, b)
        if nxt is not None and "pk" not in nxt:
            # the prefetched next batch's summary attaches NOW — after this
            # batch's walk fixed the track reference it must count against
            self._attach_summary(nxt)
        # launch the batch's deferred checks now (ONE fused call) so the
        # device works on them while the host stages the next batch
        self._dispatch_planned_checks()

        # sync the VO engine's feature state to the end of the batch (global
        # ids are materialized lazily once the deferred checks resolve —
        # _finish_batched)
        eng._prev = last_feat
        eng._cur = last_feat
        eng._last_pose_inc = np.asarray(last_inc_h, np.float32)
        return nxt

    def _pull_host_lanes(self, batch_rec: dict):
        """Materialize a batch's track lanes on host (speculation-miss
        replay / host-mode walks): ONE bulk transfer of the three lanes
        kept on device by the summary design."""
        if batch_rec.get("h_lanes") is not None:
            return
        (feats, track_idx, track_valid, _p, pose_valid_d, _n, _m) =             batch_rec["outs"]
        ti, tv, mv = bulk_pull((track_idx, track_valid, feats.m_valid))
        batch_rec["h_lanes"] = dict(track_idx=ti,
                                    track_valid=tv.astype(bool),
                                    m_valid=mv.astype(bool))

    def _process_frames(self, batch_rec: dict, j0: int, j1: int,
                        defer: bool = True):
        """Per-frame keyframe logic for batch frames [j0, j1).

        Track identity is kept as BACKPOINTERS into the latest keyframe's
        feature slots instead of materialized global ids: the membership
        count the KF triggers need is id-free, so a keyframe check can be
        dispatched and its results pulled a whole batch later
        (``defer=True``) without knowing the propagated ids yet.

        In the normal deferred walk the backpointers are VIRTUAL: the
        device-computed count matrix (``cnt0``/``cnt`` from
        _pack_scan_summary) provides tracked-from-reference directly, and
        the host only tracks WHICH frame is the reference
        (``batch_rec['ref_local']`` / ``self._ref_frame``) — no per-frame
        lane math, no lane transfer. ``defer=False`` (replay after a
        speculation miss) walks with materialized host lanes
        (``batch_rec['h_lanes']``) and the host ``self._bp`` chain exactly
        as before."""
        lanes = batch_rec.get("h_lanes")
        if not defer:
            assert lanes is not None, "replay walk needs host lanes"
        nm = batch_rec["nm"]
        poses = batch_rec["poses"]
        pose_valid = batch_rec["pose_valid"]
        feats = batch_rec["feats"]
        k = self.capacity
        prev_in_walk, self._in_walk = self._in_walk, True
        try:
            self._walk_frames(batch_rec, j0, j1, defer, lanes, nm, poses,
                              pose_valid, feats, k)
        finally:
            self._in_walk = prev_in_walk

    def _walk_frames(self, batch_rec, j0, j1, defer, lanes, nm, poses,
                     pose_valid, feats, k):
        for j in range(j0, j1):
            self.frame_idx += 1
            res = StepResult(self.frame_idx)
            self.step_log.append(res)
            n_matches = int(nm[j])
            if not bool(pose_valid[j]) or n_matches < 8:
                # skip frame; the tracking reference still advances (chains
                # die — on device via the birth clamp, on host via bp=-1)
                if lanes is not None:
                    self._bp = np.full(k, -1, np.int64)
                    self._last_m_valid = None
                self._last_skip = True
                self._bp_live = True
                continue

            if lanes is not None:
                # host-mode chain (≙ the global-id inheritance of
                # StereoVOEngine.process_stereo_pair, names dropped)
                m_valid = lanes["m_valid"]
                nbp = np.full(k, -1, np.int64)
                tv = lanes["track_valid"][j]
                nbp[tv] = self._bp[lanes["track_idx"][j][tv]]
                nbp[~m_valid[j]] = -1
                self._bp = nbp
                self._last_m_valid = m_valid[j]
                tracked_kf = int((nbp >= 0).sum())
            else:
                rl = batch_rec["ref_local"]
                tracked_kf = (int(batch_rec["cnt"][j, rl])
                              if rl is not None
                              else int(batch_rec["cnt0"][j]))
            self._last_skip = False
            self._bp_live = True
            res.vo_valid = True
            res.n_stereo_matches = n_matches
            res.tracked_from_last_kf = tracked_kf
            self._buffer_voc_frame(feats=feats, j=j)

            motion = se3_np.inverse(poses[j].astype(np.float64))
            self.current_pose = se3_np.compose(self.current_pose, motion)
            self.incr_from_last_kf = se3_np.compose(self.incr_from_last_kf,
                                                    motion)
            self.incr_from_last_check = se3_np.compose(
                self.incr_from_last_check, motion)

            force_new_kf, check, t_chk, r_chk = self._kf_triggers(tracked_kf)
            # walk-time trigger norms, consumed by _demote_shrink_miss: a
            # deferred no-insert check that shrinks the dynamic thresholds
            # is only a REAL miss if some frame walked after it would have
            # triggered under the shrunk values (global log: retry tails
            # and multi-record batches stay covered)
            self._walk_log.append((self.frame_idx, t_chk, r_chk, check))
            if not check:
                continue
            res.kf_check = True
            self.incr_from_last_check = np.zeros(6)
            if defer and self.store.n_kfs + sum(
                    1 for x in self._spec if x["ins"]) >= self.max_kfs:
                # at keyframe capacity an insert prediction would write out
                # of range: land the in-flight state and check synchronously
                # (matching per-frame semantics, which only fail if a REAL
                # insertion exceeds the capacity)
                self._replay_flag = False
                self._resolve_pending_checks()
                if self._replay_flag:
                    # a misprediction replayed this batch's tail (including
                    # the current frame) with exact state — nothing left here
                    return
                defer = False
            if defer:
                self._defer_check(res, force_new_kf, batch_rec, j)
                from srba_slam_tpu.models.data_association import CHECK_SLOTS

                if len(self._check_plan) >= CHECK_SLOTS:
                    # a full fused-program group is planned: dispatch NOW so
                    # its ~10 ms/slot of device compute overlaps the rest of
                    # the host walk instead of starting after it (the
                    # end-of-batch dispatch still flushes the remainder)
                    self._dispatch_planned_checks()
            else:
                frame_j = _slice_frame(feats, jnp.int32(j))  # ONE dispatch
                new_ids = self._kf_check(frame_j, res, force_new_kf)
                if new_ids is not None:
                    if lanes is not None:
                        self._bp = np.where(lanes["m_valid"][j],
                                            np.arange(k), -1)
                    else:
                        # virtual mode (capacity guard switched to sync
                        # checks without a replay): a real insert
                        # re-references the chains like a predicted one
                        batch_rec["resets"].append(j)
                        batch_rec["ref_local"] = j
                        self._ref_frame = batch_rec["j0"] + j
                    self._ref_ids = new_ids.copy()
            # max_num_kfs is a per-FRAME stop in the reference main loop
            # (.cpp:930-932 ≙ perform_stereo_slam): a batch must not
            # overshoot it with later-frame insertions. When the PREDICTED
            # count reaches the limit, resolve and stop the walk at this
            # frame iff the committed count confirms it.
            if self.general.max_num_kfs and self.store.n_kfs + sum(
                    1 for x in self._spec if x["ins"]) \
                    >= self.general.max_num_kfs:
                self._replay_flag = False
                self._resolve_pending_checks()
                if self._replay_flag:
                    # the replay re-walked this batch's tail (honoring the
                    # stop itself) with exact state — nothing left here
                    return
                if self.store.n_kfs >= self.general.max_num_kfs:
                    return

    # ----------------------------------------------- speculative KF checks
    # The check's query+DA dispatch is cheap; its blocking PULL costs a full
    # host<->device round trip. Everything the host needs to CONTINUE past a
    # check is deterministic once the check's OUTCOME is assumed, and both
    # outcomes are cheap to speculate:
    #
    # * INSERT: the device store/BoW rows are exactly the frame's data
    #   (written speculatively — rows beyond the committed counters are
    #   inert, so a miss needs no cleanup), the trigger accumulators reset,
    #   and track membership needs only backpointers, not ids;
    # * NO-INSERT (the common outcome when tracking is strong and the check
    #   fired on the distance trigger): nothing changes at all.
    #
    # The outcome is predicted from the trigger reason (force / low VO
    # tracking => insert) plus the last resolved check's DA result (an
    # appearance-blind VO chain can stay long while DA fails — the previous
    # check's best-tracked count is the best available proxy). Checks DEFER:
    # their pulls merge into the next batch's single bulk transfer, and the
    # insertion's host-side graph work happens retroactively there with
    # full, exact state. A mispredicted check restores a snapshot, applies
    # the true outcome, and replays the batch tail with synchronous checks —
    # results stay identical to per-frame stepping either way.

    _N_CHECK_HANDLES = 1  # one int32 blob per check (floats bitcast) — see
    # data_association.pack_check_outputs (per-array pull overhead)

    def _defer_check(self, res: StepResult, force_new_kf: bool,
                     batch_rec: dict, j: int):
        """Dispatch a keyframe check without pulling it; speculate on the
        predicted outcome."""
        th = self.opts.updated_matches_th
        predict_insert = (
            force_new_kf
            or res.tracked_from_last_kf < 1.2 * th
            or self._da_dead
        )
        snap = dict(
            log_len=len(self.step_log),      # keeps res (the check frame)
            frame_idx=self.frame_idx,
            incr_kf=self.incr_from_last_kf.copy(),
            tr_th=self.updated_translation_th,
            rot_th=self.updated_rotation_th,
            ref_ids=self._ref_ids,
            batch=batch_rec, j=j,
            # virtual-chain snapshot: the reference + the resets recorded
            # SO FAR (a miss reconstructs the host backpointers at this
            # check from the device slot maps with exactly these resets)
            resets=list(batch_rec["resets"]),
            ref_local=batch_rec["ref_local"],
            ref_frame=self._ref_frame,
            bp=(self._bp.copy() if batch_rec.get("h_lanes") is not None
                else None),
        )
        n_pending_ins = sum(1 for x in self._spec if x["ins"])
        spec_row = self.store.n_kfs + n_pending_ins
        # The check itself (frame slice + speculative store/BoW row write +
        # BoW query + DA cascade) is only PLANNED here; all of a batch's
        # planned checks dispatch together in ONE fused_checks_batch call
        # (_dispatch_planned_checks) — one dispatch instead of one per
        # check.
        sub = self._da_seed
        self._da_seed += 1
        snap["da_seed"] = self._da_seed  # post-consume: replay re-counts in order
        spec_entry = dict(
            handles=None, frame=None, frame_ref=(batch_rec["feats"], j),
            res=res, force=force_new_kf,
            ins=predict_insert,
            incr_at_check=snap["incr_kf"], snap=snap, spec_row=spec_row)
        self._spec.append(spec_entry)
        self._check_plan.append(dict(
            spec=spec_entry, feats=batch_rec["feats"], j=j, row=spec_row,
            seed=sub))
        if predict_insert:
            # reset accumulators/thresholds, re-reference the track chains
            # to this frame (ids pending until resolution). The chain
            # re-reference is VIRTUAL: record the reset; the count matrix
            # already carries every candidate reference column
            self.incr_from_last_kf = np.zeros(6)
            self.updated_translation_th = float(self.opts.max_translation)
            self.updated_rotation_th = float(self.opts.max_rotation)
            if batch_rec.get("h_lanes") is not None:
                # host-mode walk (post-replay batch): reset the live host
                # backpointers directly
                self._bp = np.where(batch_rec["h_lanes"]["m_valid"][j],
                                    np.arange(self.capacity), -1)
            else:
                batch_rec["resets"].append(j)
                batch_rec["ref_local"] = j
                self._ref_frame = batch_rec["j0"] + j
            self._ref_ids = None
        # predicted no-insert: state untouched (the overwhelmingly common
        # no-insert outcome changes nothing — threshold shrink only happens
        # in the narrow best ∈ [th, th+plus] window and counts as a miss)

    def _dispatch_planned_checks(self):
        """Dispatch every planned-but-undispatched deferred check in ONE
        fused_checks_batch call per CHECK_SLOTS group (padded slots skip
        their compute via lax.cond — a single compiled program covers
        every check count). Must run before any pull of spec handles."""
        plan, self._check_plan = self._check_plan, []
        if not plan:
            return
        if self.bow is None:
            # first-ever check: train the fallback vocabulary capped at this
            # check's frame so batched and per-frame modes train identically
            self.ensure_vocabulary(
                limit_fidx=plan[0]["spec"]["res"].frame_idx)
        from srba_slam_tpu.models.data_association import (
            CHECK_SLOTS, fused_checks_batch,
        )

        # group by (feats identity, slot capacity): a group's js index into
        # ONE batch's feature arrays — a plan spanning two batches (never
        # produced today, but the flush sites tolerate leftovers) must not
        # mix them
        grps: list[list[dict]] = []
        for g in plan:
            if grps and grps[-1][0]["feats"] is g["feats"] \
                    and len(grps[-1]) < CHECK_SLOTS:
                grps[-1].append(g)
            else:
                grps.append([g])
        for grp in grps:
            n = len(grp)
            pad = CHECK_SLOTS - n
            # js/rows/valids travel as PYTHON SCALARS (no transfer);
            # array args would upload behind the in-flight frame
            # prefetch and delay the checks by a whole transfer
            js = tuple(int(g["j"]) for g in grp) + (0,) * pad
            rows = tuple(int(g["row"]) for g in grp) + (0,) * pad
            valids = (True,) * n + (False,) * pad
            seeds = tuple(int(g["seed"]) for g in grp) + \
                (int(grp[-1]["seed"]),) * pad
            with self.profiler.section("queryDB"):
                blobs, new_arrays, new_db = fused_checks_batch(
                    grp[0]["feats"], self.store.arrays, self.bow._db,
                    self.bow._leaf_bits, self.bow._weights,
                    js, rows, valids,
                    self.cam, seeds,
                    max_orb_distance_da=self.opts.max_orb_distance_da,
                    residual_th=self.opts.residual_th,
                    max_y_diff_epipolar=self.opts.max_y_diff_epipolar,
                    filter_by_direction=self.opts.da_filter_by_direction,
                    filter_by_orb_distance=self.opts.da_filter_by_orb_distance,
                    use_fund_matrix=self.opts.da_filter_by_fund_matrix,
                    use_change_pose=self.opts.da_filter_by_pose_change,
                    kernel_param=self.vo_opts.kernel_param,
                    ransac_n_hyp=self._ransac_n_hyp,
                    debug=self.debug.enabled,
                )
            self.store.arrays = new_arrays
            self.bow._db = new_db
            for g, blob in zip(grp, blobs[:n]):
                g["spec"]["handles"] = (blob,)

    def _spec_frame(self, c: dict):
        """Materialize a deferred check's sliced frame lazily (only the
        miss-recovery replay and debug dumps need it — the hit path works
        entirely from the fused check's handles)."""
        if c.get("frame") is None:
            feats, j = c["frame_ref"]
            c["frame"] = _slice_frame(feats, jnp.int32(j))
        return c["frame"]

    def _resolve_spec(self, vals: tuple):
        """Retro-process deferred checks in order from their pulled values.
        All host graph state (SRBA edges, topo distances, thresholds) is
        exact at this point, so the decisions equal what the synchronous
        path would have produced — only the device inputs were speculative,
        and those are exact unless a prediction missed."""
        checks, self._spec = self._spec, []
        if not checks:
            self._walk_log = []
        n = self._N_CHECK_HANDLES
        last_ins_ids = None
        t_res = time.perf_counter()
        newest = getattr(self, "_lat_resolved_at", None)
        if newest is None:
            newest = self.frame_idx
        for idx, c in enumerate(checks):
            pulled = tuple(vals[idx * n:(idx + 1) * n])
            d = self._kf_decide(pulled, c["res"], c["force"])
            # latency log: the keyframe DECISION for this frame commits now
            # (per check as it actually resolves — checks dropped by a miss
            # replay log at their re-resolution instead); the lag in frames
            # is vs the newest frame already dispatched
            self.lat["checks"].append(dict(
                frame=c["res"].frame_idx, resolved_at=newest, t=t_res))
            if not c["force"]:
                # non-forced checks run at short range: if DA fails there,
                # the appearance regime is bad and every check will insert
                self._da_dead = c["res"].best_tracked < \
                    self.opts.updated_matches_th
            hit = (d["insert"] == c["ins"]) and (
                d["insert"] or d["new_tr_th"] is None)
            if not hit:
                if self._demote_shrink_miss(c, d):
                    # immaterial shrink: the tail walk is provably identical
                    # under the shrunk thresholds — apply them and continue
                    # resolving instead of replaying (the dominant devres
                    # miss class; tools/devres_pull_sites.py)
                    self._apply_no_insert(d)
                    continue
                self._miss_recover(c, d)
                return
            if d["insert"]:
                last_ins_ids = self._kf_apply(
                    d, self._spec_frame(c) if self.debug.enabled else None,
                    c["res"],
                    initial_rel=c["incr_at_check"], pre_written=True)
            # no-insert hit: nothing to do (decide set the log fields)
        # every deferred check resolved without replay: entries are dead
        # (future checks have strictly larger frame indices)
        self._walk_log = []
        if checks:
            if self._ref_ids is None and last_ins_ids is not None:
                # the last insert-speculated check's frame is the current
                # track reference; its ids just materialized
                self._ref_ids = last_ins_ids.copy()
            if any(c["ins"] for c in checks):
                self.last_kf_pose = \
                    self.rba.kf_global[self.store.n_kfs - 1].copy()
                self.current_pose = se3_np.compose(self.last_kf_pose,
                                                   self.incr_from_last_kf)
                self._pose_dirty = False

    def _demote_shrink_miss(self, c: dict, d: dict) -> bool:
        """Is this miss a PURE threshold shrink whose tail is unaffected?

        A deferred check predicted no-insert, decided no-insert, but set
        ``new_tr_th``/``new_rot_th`` (≙ reference .cpp:525-541). The shrink
        only changes the walk through the frames between this check and the
        NEXT check of its batch: trigger = force | low-tracking |
        t_chk > tr_th | r_chk > rot_th, and shrinking thresholds can only
        ADD triggers. If no such tail frame's walk-time accumulated norms
        exceed the shrunk values, the triggered-frame set — and therefore
        every accumulator reset and later decision — is identical, so the
        true outcome can be applied without the snapshot replay. Frames
        after the NEXT check are governed by that check's own outcome
        (resolved next, with this shrink already applied — induction), and
        frames of LATER batches are walked after this resolution with the
        corrected thresholds. Exactness vs per-frame stepping is preserved;
        only the ~2 extra blocking pulls and the host re-walk of the replay
        path are saved."""
        if d["insert"] or c["ins"] or d["new_tr_th"] is None:
            return False  # a mispredicted outcome: the tail really diverges
        f_c = c["res"].frame_idx
        for (f, t_chk, r_chk, was_check) in self._walk_log:
            if f <= f_c:
                continue
            if was_check:
                # the next check triggers under both walks (shrinking only
                # adds triggers) and resets the accumulators identically;
                # its own resolution covers the frames beyond it
                break
            if t_chk > d["new_tr_th"] or r_chk > d["new_rot_th"]:
                return False  # material: this frame would now trigger
        return True

    def _shrink_tail_ok(self, c: dict, d: dict) -> bool:
        """Can the virtual fast-path replay handle this shrink miss?

        Dry-runs the tail trigger walk under the shrunk thresholds on the
        batch's host summary arrays (same data the real re-walk uses). The
        fast path requires every newly-triggered check to PREDICT no-insert
        (force off, tracking comfortably above threshold, DA alive): a
        predicted no-insert check touches no reference state, so the device
        chain maps, the next batch's already-attached scan summary, and the
        speculative row indices all stay exactly valid. Any insert
        prediction moves the track reference — the classic host replay
        handles those."""
        snap = c["snap"]
        b_rec = snap["batch"]
        nm, poses = b_rec["nm"], b_rec["poses"]
        pose_valid = b_rec["pose_valid"]
        rl = snap["ref_local"]
        incr_kf = snap["incr_kf"].copy()
        incr_chk = np.zeros(6)
        o = self.opts
        for j in range(snap["j"] + 1, b_rec["b"]):
            if not bool(pose_valid[j]) or int(nm[j]) < 8:
                continue  # skip frame: no motion integrated (≙ .cpp:318-323)
            tracked = (int(b_rec["cnt"][j, rl]) if rl is not None
                       else int(b_rec["cnt0"][j]))
            motion = se3_np.inverse(poses[j].astype(np.float64))
            incr_kf = se3_np.compose(incr_kf, motion)
            incr_chk = se3_np.compose(incr_chk, motion)
            force = (
                np.linalg.norm(incr_kf[3:]) > 2.0 * o.max_translation
                or np.rad2deg(np.linalg.norm(incr_kf[:3]))
                > 2.0 * o.max_rotation
            )
            check = (
                force
                or tracked < o.vo_id_tracking_th
                or np.linalg.norm(incr_chk[3:]) > d["new_tr_th"]
                or np.rad2deg(np.linalg.norm(incr_chk[:3])) > d["new_rot_th"]
            )
            if not check:
                continue
            if (force or tracked < 1.2 * o.updated_matches_th
                    or self._da_dead):
                return False  # would predict INSERT: reference moves
            incr_chk = np.zeros(6)
            # predicted no-insert: the deferred walk keeps the thresholds
            # (a further shrink is only known at ITS resolution)
        return True

    def _shrink_replay(self, c: dict, d: dict):
        """Fast-path replay for a pure threshold-shrink miss in virtual-
        chain mode (gated by :meth:`_shrink_tail_ok`): no insertion happened
        at the check and none will be predicted in the tail, so the device
        chain state, references, and any already-attached next-batch summary
        stay valid. Restore only the HOST walk counters, apply the shrink,
        and re-walk the tail with deferred checks — zero blocking transfers
        here; the re-deferred checks ride the next resolution round's bulk
        pull (mid-run) or the finish loop (at the batch end). Replaces the
        classic replay's chain/lane pulls + per-check synchronous pulls
        (tools/devres_pull_sites.py attributes them)."""
        snap = c["snap"]
        self.frame_idx = snap["frame_idx"]
        del self.step_log[snap["log_len"]:]
        self.incr_from_last_kf = snap["incr_kf"].copy()
        self.incr_from_last_check = np.zeros(6)
        self._apply_no_insert(d)  # the TRUE outcome: shrunk thresholds
        b_rec = snap["batch"]
        b_rec["resets"] = list(snap["resets"])
        b_rec["ref_local"] = snap["ref_local"]
        self._ref_frame = snap["ref_frame"]
        self._ref_ids = snap["ref_ids"]
        self._da_seed = snap["da_seed"]
        self._walk_log = []  # re-walk reuses the rewound frame indices
        if self.store.n_kfs:
            self.last_kf_pose = \
                self.rba.kf_global[self.store.n_kfs - 1].copy()
        self.current_pose = se3_np.compose(self.last_kf_pose,
                                           self.incr_from_last_kf)
        self._pose_dirty = False
        self._process_frames(b_rec, snap["j"] + 1, b_rec["b"], defer=True)
        # the tail's checks are no-insert-predicted (gate above), so the
        # reset list is unchanged — still re-derive the chain entry in case
        # a nested guard path inserted synchronously (cheap async dispatch)
        self._finish_batch_chain(b_rec, b_rec["b"])
        self._dispatch_planned_checks()  # overlap the fused check program

    def _miss_recover(self, c: dict, d: dict):
        """Prediction miss at check ``c``: restore the snapshot taken at its
        dispatch, apply the TRUE outcome, and replay the rest of its batch
        with synchronous checks (later deferred checks were dropped by the
        caller; insert-speculated device rows are inert and will be
        overwritten by the next real insertions)."""
        if (not self._in_walk and self._virtual_bp
                and c["snap"].get("bp") is None
                and not d["insert"] and not c["ins"]
                and d["new_tr_th"] is not None
                and self._shrink_tail_ok(c, d)):
            # pure shrink, virtual mode, outside any walk, insert-free tail:
            # the pull-free fast path (leaves _replay_flag unset — the
            # device chain and any attached next-batch summary stay valid)
            self._shrink_replay(c, d)
            return
        self._replay_flag = True
        # the replay rewinds frame_idx and re-walks synchronously: walk-log
        # entries would otherwise collide with the re-walked frame indices
        self._walk_log = []
        snap = c["snap"]
        self.frame_idx = snap["frame_idx"]
        del self.step_log[snap["log_len"]:]
        self.incr_from_last_kf = snap["incr_kf"].copy()
        self.incr_from_last_check = np.zeros(6)
        self.updated_translation_th = snap["tr_th"]
        self.updated_rotation_th = snap["rot_th"]
        b_rec = snap["batch"]
        j_c = snap["j"]
        snap_bp = snap.get("bp")
        if snap_bp is None:
            # virtual-chain snap: rebuild the host backpointers AT the
            # check frame from the device slot maps (the resets recorded up
            # to this check), pulling the row together with the batch's
            # lanes in ONE transfer (miss path only)
            (feats, track_idx, track_valid, _p, pose_valid_d, _n, _m) = \
                b_rec["outs"]
            reset_np = np.zeros(b_rec["b_full"], bool)
            for r in snap["resets"]:
                reset_np[r] = True
            maps = _chain_slotmaps(track_idx, track_valid, feats.m_valid,
                                   pose_valid_d, b_rec["entry_dev"],
                                   jnp.asarray(reset_np))
            row, ti, tv, mv = bulk_pull((maps[j_c], track_idx, track_valid,
                                         feats.m_valid))
            b_rec["h_lanes"] = dict(track_idx=ti,
                                    track_valid=tv.astype(bool),
                                    m_valid=mv.astype(bool))
            snap_bp = row.astype(np.int64)
        else:
            self._pull_host_lanes(b_rec)
        self._virtual_bp = False
        self._ref_frame = None
        self._bp = snap_bp.copy()
        self._last_m_valid = b_rec["h_lanes"]["m_valid"][j_c]
        self._last_skip = False
        self._ref_ids = snap["ref_ids"]
        self._da_seed = snap["da_seed"]
        if d["insert"]:
            # late insertion: the speculative row was written at the
            # DISPATCH-TIME row index, which may not equal the actual kf_id
            # after earlier mispredictions — re-write at the real slot
            ids = self._kf_apply(d, self._spec_frame(c), c["res"],
                                 initial_rel=snap["incr_kf"],
                                 pre_written=False)
            self.incr_from_last_kf = np.zeros(6)
            self.current_pose = self.last_kf_pose.copy()
            self._bp = np.where(b_rec["h_lanes"]["m_valid"][j_c],
                                np.arange(self.capacity), -1)
            self._ref_ids = ids.copy()
        else:
            self._apply_no_insert(d)
            if self.store.n_kfs:
                self.last_kf_pose = \
                    self.rba.kf_global[self.store.n_kfs - 1].copy()
            self.current_pose = se3_np.compose(self.last_kf_pose,
                                               self.incr_from_last_kf)
        self._pose_dirty = False
        self._process_frames(b_rec, j_c + 1, b_rec["b"], defer=False)

    def _resolve_pending_checks(self, with_chain: bool = False):
        """Force deferred checks + queued window solves to land (one pull).

        ``with_chain=True`` (the finish path) rides the device chain-entry
        slot map and last-frame validity mask along the same transfer so
        the id materialization that follows costs no extra round trip."""
        self._dispatch_planned_checks()
        self._chain_pulled = None
        first_round = True
        while True:
            chain_h = ()
            if with_chain and self._virtual_bp \
                    and self._chain_entry_dev is not None \
                    and self._last_mv_dev is not None:
                chain_h = (self._chain_entry_dev, self._last_mv_dev)
            if not self._spec:
                if first_round:
                    self.rba.flush()
                self._reanchor_if_dirty()
                if chain_h and self._chain_pulled is None:
                    self._chain_pulled = bulk_pull(chain_h)
                return
            pend = self.rba.pending_device_arrays()
            spec_handles = tuple(h for c in self._spec for h in c["handles"])
            pulled = bulk_pull(pend + spec_handles + chain_h)
            if pend:
                self.rba.commit_pending(pulled[:len(pend)])
            self._chain_pulled = pulled[-2:] if chain_h else None
            self._replay_flag = False
            self._resolve_spec(
                pulled[len(pend):len(pend) + len(spec_handles)]
                if chain_h else pulled[len(pend):])
            self._reanchor_if_dirty()
            if self._replay_flag:
                self._chain_pulled = None  # replay switched to host mode
                return
            if chain_h and chain_h[0] is not self._chain_entry_dev:
                # a fast-path shrink replay re-derived the chain entry:
                # the value pulled this round is stale
                self._chain_pulled = None
            if not self._spec:
                if with_chain and self._chain_pulled is None \
                        and self._virtual_bp \
                        and self._chain_entry_dev is not None \
                        and self._last_mv_dev is not None:
                    self._chain_pulled = bulk_pull(
                        (self._chain_entry_dev, self._last_mv_dev))
                return
            # a fast-path shrink replay re-deferred tail checks: dispatch
            # and resolve them in another round
            self._dispatch_planned_checks()
            first_round = False

    def _materialize_engine_ids(self):
        """Translate the backpointer chains into the VO engine's global-id
        representation so per-frame stepping, checkpointing, and fleet mode
        can continue seamlessly from batched state. In virtual-chain mode
        the slot map is pulled from the device first (prefetched by the
        finish pull when possible)."""
        if not self._bp_live or self._ref_ids is None:
            return
        if self._virtual_bp:
            if self._chain_entry_dev is None or self._last_mv_dev is None:
                return
            if self._chain_pulled is not None:
                bp, mv = self._chain_pulled
                self._chain_pulled = None
            else:
                bp, mv = jax.device_get((self._chain_entry_dev,
                                         self._last_mv_dev))
            self._bp = np.asarray(bp).astype(np.int64)
            self._last_m_valid = (None if self._last_skip
                                  else np.asarray(mv).astype(bool))
            self._virtual_bp = False
            self._ref_frame = None
        if self._bp is None:
            return
        self._bp_live = False
        eng = self.vo
        ids = np.full(self.capacity, -1, np.int64)
        sel = self._bp >= 0
        ids[sel] = self._ref_ids[self._bp[sel]]
        if self._last_m_valid is not None:
            # fresh ids must not collide with estimator-minted keyframe ids
            # (see StereoVOEngine.set_frame_ids)
            eng._next_id = max(eng._next_id, self.next_match_id)
            ids = eng._mint_ids(ids, self._last_m_valid)
        eng._prev_ids = ids
        eng._cur_ids = ids
        eng._kf_id_set = set(
            int(i) for i in self._ref_ids[self._ref_ids >= 0])

    def _sync_bp_from_engine(self):
        """(Re)build the backpointer state from the engine's global ids —
        called when batched mode (re)starts after per-frame stepping."""
        self._last_m_valid = None
        self._bp_live = False
        self._virtual_bp = False
        self._ref_frame = None
        self._chain_entry_dev = None
        self._last_mv_dev = None
        self._last_skip = False
        self._chain_pulled = None
        self._walk_log = []
        if self.store.n_kfs == 0:
            self._bp = np.full(self.capacity, -1, np.int64)
            self._ref_ids = None
            return
        ref_ids = self.store.match_ids[self.store.n_kfs - 1]
        slot_of = {int(v): s for s, v in enumerate(ref_ids) if v >= 0}
        bp = np.full(self.capacity, -1, np.int64)
        prev = self.vo._prev_ids
        if prev is not None:
            for i, v in enumerate(prev):
                if v >= 0:
                    bp[i] = slot_of.get(int(v), -1)
        self._bp = bp
        self._ref_ids = ref_ids.copy()

    def _finish_batched(self):
        """Resolve all speculative state; batched results become final."""
        self._resolve_pending_checks(with_chain=True)
        self._materialize_engine_ids()

    # ----------------------------------------------------------------- step
    def step(self, left: np.ndarray, right: np.ndarray) -> StepResult:
        self.frame_idx += 1
        res = StepResult(self.frame_idx)
        self.step_log.append(res)

        if self.store.n_kfs == 0:
            self._insert_first_kf(left, right, res)
            return res

        vo = self._vo_with_adaptive_retry(left, right, res)
        if vo is None or not vo.valid:
            return res  # skip frame (≙ reference .cpp:318-323)
        res.vo_valid = True
        res.n_stereo_matches = vo.num_stereo_matches
        res.tracked_from_last_kf = vo.tracked_from_last_kf
        self._buffer_voc_frame(frame=self.vo.last_frame())

        # pose integration (≙ .cpp:327-330): increment maps prev->cur points,
        # so camera motion is its inverse
        motion = se3_np.inverse(vo.pose_increment.astype(np.float64))
        self.current_pose = se3_np.compose(self.current_pose, motion)
        self.incr_from_last_kf = se3_np.compose(self.incr_from_last_kf, motion)
        self.incr_from_last_check = se3_np.compose(self.incr_from_last_check, motion)

        force_new_kf, check, _t, _r = self._kf_triggers(
            vo.tracked_from_last_kf)
        if not check:
            return res
        res.kf_check = True
        self.incr_from_last_check = np.zeros(6)
        ids = self._kf_check(self.vo.last_frame(), res, force_new_kf)
        if ids is not None:
            self.vo.set_frame_ids(ids, set(int(i) for i in ids if i >= 0))
        return res

    def _kf_triggers(
            self, tracked_from_last_kf: int) -> tuple[bool, bool, float, float]:
        """KF-check triggers (≙ reference .cpp:366-394): hard force limit at
        2x the configured translation/rotation, tracking-count trigger, and
        the dynamic since-last-check distance trigger. Returns
        (force_new_kf, check, t_chk, r_chk) — the accumulated-since-last-
        check norms are logged by the batched walk so a deferred shrink can
        be verified immaterial (see :meth:`_demote_shrink_miss`)."""
        t_kf = np.linalg.norm(self.incr_from_last_kf[3:])
        r_kf = np.rad2deg(np.linalg.norm(self.incr_from_last_kf[:3]))
        t_chk = float(np.linalg.norm(self.incr_from_last_check[3:]))
        r_chk = float(np.rad2deg(np.linalg.norm(self.incr_from_last_check[:3])))
        force_new_kf = (
            t_kf > 2.0 * self.opts.max_translation
            or r_kf > 2.0 * self.opts.max_rotation
        )
        check = (
            force_new_kf
            or tracked_from_last_kf < self.opts.vo_id_tracking_th
            or t_chk > self.updated_translation_th
            or r_chk > self.updated_rotation_th
        )
        return force_new_kf, check, t_chk, r_chk

    # ------------------------------------------------------- adaptive VO
    def _vo_with_adaptive_retry(self, left, right, res: StepResult):
        """≙ the FAST/ORB threshold retry protocol (reference .cpp:263-315).
        The protocol only runs when orb_adaptive_fast_th is set (≙ the gate
        at .cpp:271); otherwise one plain VO pass."""
        if not self.opts.orb_adaptive_fast_th:
            vo = self.vo.process_stereo_pair(left, right)
            return None if vo.num_stereo_matches < 8 else vo
        th_min_matches = self.opts.adaptive_th_min_matches
        vo = None
        for _attempt in range(6):
            state = self.vo.get_state()
            vo = self.vo.process_stereo_pair(left, right)
            n = vo.num_stereo_matches
            if n >= th_min_matches:
                break
            if not self.vo.retry_step():
                break
            self.vo.set_state(state)  # re-process the same frame
        n = vo.num_stereo_matches
        if n < 8:
            return None  # hopeless frame (≙ abort below 8 matches)
        self.vo.drift_thresholds(n, th_min_matches)
        return vo

    # ------------------------------------------------------------ first KF
    def _insert_first_kf(self, left, right, res: StepResult):
        """≙ the FIRST FRAME branch (reference .cpp:82-216)."""
        vo = self.vo.process_stereo_pair(left, right)
        frame = self.vo.last_frame()
        self._buffer_voc_frame(frame=frame)
        ids = self._mint_fresh_ids(np.asarray(frame.m_valid))
        kf_id = self.store.append(frame, ids, self.current_pose)
        if self.bow is not None:
            self.bow.insert(frame.desc_l, frame.m_valid)
        # else: the vocabulary is still accumulating (voc_train_frames);
        # ensure_vocabulary backfills this KF's DB row from the store
        obs = self._build_obs(frame, ids, first_kf=True)
        info = self.rba.define_new_keyframe(obs, run_opt=False)
        self.vo.set_frame_ids(ids, set(ids[ids >= 0]))
        self.debug.dump_kf(kf_id, frame, ids)
        res.vo_valid = True
        res.inserted_kf = kf_id
        res.n_stereo_matches = vo.num_stereo_matches
        self.kf_stats.append(TStatsSRBA(0.0, 1, int((ids >= 0).sum()), 0))
        if self.general.show3D:
            self._live_viz_snapshot()  # live view exists from KF0 on

    def _buffer_voc_frame(self, frame=None, feats=None, j: int = 0):
        """Accumulate a processed frame's descriptors for the fallback
        vocabulary (no voc_filename configured). Capped at the first
        ``voc_train_frames`` valid frames; replayed frames (speculation-miss
        recovery walks a batch tail twice) are deduplicated by frame index.
        Device handles only — ONE pull happens at training time."""
        if self.bow is not None or not self._pending_voc_training:
            return
        if len(self._voc_buffer) >= max(1, self.opts.voc_train_frames):
            return
        fidx = self.frame_idx
        if self._voc_buffer and self._voc_buffer[-1][0] >= fidx:
            return
        if frame is not None:
            d, v = frame.desc_l, frame.m_valid
        else:
            d, v = feats.desc_l[j], feats.m_valid[j]
        self._voc_buffer.append((fidx, d, v))

    def ensure_vocabulary(self, limit_fidx: int | None = None):
        """No vocabulary file: train one from the descriptors accumulated
        over the first ``voc_train_frames`` frames (framework capability
        beyond the reference, which requires a prebuilt voc.yml.gz —
        CBoWManager.h:59-66; the reference vocabulary is k=8 L=5 trained
        offline). Called lazily at the first keyframe check; any keyframes
        inserted before that point get their BoW DB rows backfilled from
        the keyframe store in one device program.

        ``limit_fidx`` restricts training to frames <= that index so the
        per-frame and batched modes (whose buffers can momentarily extend
        past an early first check) train bit-identical vocabularies."""
        if self.bow is not None:
            return
        ents = [e for e in self._voc_buffer
                if limit_fidx is None or e[0] <= limit_fidx]
        if ents:
            dh, vh = jax.device_get((
                jnp.stack([d for _, d, _ in ents]),
                jnp.stack([v for _, _, v in ents])))
            desc = dh.reshape(-1, dh.shape[-1])[vh.ravel()]
        else:
            desc = np.zeros((0, 8), np.uint32)
        if len(desc) < 32:  # degenerate; random fallback
            desc = np.random.default_rng(0).integers(
                0, 2**32, (1024, 8), dtype=np.uint64
            ).astype(np.uint32)
        # deeper tree once the corpus supports it (k=8: L=3 -> 512 leaves,
        # L=4 -> 4096); the multi-frame corpus generalizes to unseen views
        # far better than the old 1-frame L=3 bootstrap
        # (tests/test_bow.py::test_multiframe_vocabulary_beats_single_frame)
        L = 4 if len(desc) >= 2048 else 3
        voc = Vocabulary.train(desc, k=8, L=L, seed=0)
        self.bow = BoWDatabase(voc, max_kfs=self.max_kfs)
        if self.store.n_kfs:
            self.bow.rebuild_from_store(self.store.arrays, self.store.n_kfs)
        self._pending_voc_training = False
        self._voc_buffer = []

    # ------------------------------------------------------------- KF check
    def _kf_check(self, frame, res: StepResult, force_new_kf: bool):
        """BoW query -> similar KFs -> DA -> LC confirm -> possible insertion.
        Returns the inserted keyframe's match IDs, or None if no KF was
        inserted."""
        # ONE dispatch runs the BoW query AND the DA cascade against the
        # candidate superset {prev KF} ∪ top-4; ONE bulk transfer pulls the
        # results plus everything a possible insertion needs from the frame
        # (one round-trip instead of one per array)
        handles = self._kf_check_dispatch(frame)
        with self.profiler.section("performDA"):
            pend = self.rba.pending_device_arrays()
            pulled = bulk_pull(handles + pend)
            if pend:
                self.rba.commit_pending(pulled[len(handles):])
            self._reanchor_if_dirty()
        return self._kf_check_host(pulled[: len(handles)], frame, res,
                                   force_new_kf)

    def _kf_check_dispatch(self, frame, n_kfs: int | None = None) -> tuple:
        """Dispatch the fused BoW-query + DA-cascade program for one frame;
        returns the flat tuple of device arrays the host logic needs (pull
        them in ONE transfer, then call :meth:`_kf_check_host`).

        The DA change-in-pose solves seed themselves on device (Horn 3D-3D
        alignment inside the cascade, ≙ the role of the spanning-tree
        initialPoseVector at reference .cpp:1840-1868/:2133-2147) — no host
        graph state rides along."""
        from srba_slam_tpu.models.data_association import (
            query_and_associate_packed,
        )

        self.ensure_vocabulary(limit_fidx=self.frame_idx)
        sub = self._da_seed
        self._da_seed += 1
        if n_kfs is None:
            n_kfs = self.store.n_kfs
        with self.profiler.section("queryDB"):
            handles = query_and_associate_packed(
                frame, self.store.arrays, self.bow._db,
                self.bow._leaf_bits, self.bow._weights,
                jnp.int32(n_kfs), self.cam, sub,
                max_orb_distance_da=self.opts.max_orb_distance_da,
                residual_th=self.opts.residual_th,
                max_y_diff_epipolar=self.opts.max_y_diff_epipolar,
                filter_by_direction=self.opts.da_filter_by_direction,
                filter_by_orb_distance=self.opts.da_filter_by_orb_distance,
                use_fund_matrix=self.opts.da_filter_by_fund_matrix,
                use_change_pose=self.opts.da_filter_by_pose_change,
                kernel_param=self.vo_opts.kernel_param,
                ransac_n_hyp=self._ransac_n_hyp,
                debug=self.debug.enabled,
            )
        return handles

    def _kf_check_host(self, pulled: tuple, frame, res: StepResult,
                       force_new_kf: bool):
        """Host half of the keyframe check, SYNCHRONOUS semantics:
        similar-KF selection, LC confirmation, insertion decision and the
        insertion itself (decide + apply). ``pulled`` is the host copy of
        :meth:`_kf_check_dispatch`'s tuple."""
        d = self._kf_decide(pulled, res, force_new_kf)
        if not force_new_kf:
            self._da_dead = res.best_tracked < self.opts.updated_matches_th
        if not d["insert"]:
            self._apply_no_insert(d)
            return None
        ids = self._kf_apply(d, frame, res,
                             initial_rel=self.incr_from_last_kf,
                             pre_written=False)
        # reset accumulators (≙ .cpp:662-663, 922-923)
        self.current_pose = self.last_kf_pose.copy()
        self.incr_from_last_kf = np.zeros(6)
        return ids

    def _kf_decide(self, pulled: tuple, res: StepResult,
                   force_new_kf: bool) -> dict:
        """PURE insertion decision from the pulled check results: similar-KF
        selection + LC confirmation (≙ .cpp:483-545). Mutates only logs
        (query_log, debug dumps, res.best_tracked); threshold side effects
        are returned in the dict and applied by the caller — so the decision
        can be replayed exactly when a speculative check resolves late."""
        extras = None
        if len(pulled) == 1:  # blob-packed (the only dispatch format now)
            from srba_slam_tpu.models.data_association import (
                unpack_check_outputs,
            )

            pulled = unpack_check_outputs(
                pulled[0], s=MAX_SIMILAR, k=self.capacity, nq=4,
                debug=self.debug.enabled)
        if len(pulled) == 12:
            extras = pulled[11]
            pulled = pulled[:11]
        (scores, ids, da_status_all, da_oidx_all, tracked_all, f_m_valid,
         f_xs_l, f_ys_l, f_xs_r, f_m_r, f_pts) = pulled
        self.query_log.append((res.frame_idx, np.asarray(scores).copy(),
                               np.asarray(ids).copy()))
        if len(scores) and scores[0] < self.opts.query_score_th:
            # ≙ the "Lost camera?" warning (reference .cpp:1748-1751)
            self.log(1, "Best BoW query score below query_score_th — "
                        "lost camera?")
        with self.profiler.section("get_similar_kfs"):
            similar, lc_candidate = self._get_similar_kfs(scores, ids)
        if scores[0] < 0.05:
            force_new_kf = True  # "lost camera?" floor (≙ .cpp:439-440)

        # reindex the candidate-superset DA rows onto the selected similar
        # list (candidate layout: position 0 = prev KF, 1+r = BoW result r)
        prev_kf = self.store.n_kfs - 1
        pos_of = {prev_kf: 0}
        for r, i in enumerate(ids):
            pos_of.setdefault(int(i), 1 + r)
        positions = [pos_of[s] for s in similar]
        da_status = da_status_all[positions]
        da_oidx = da_oidx_all[positions]
        tracked = tracked_all[positions]
        self.debug.dump_da_host(self.store.n_kfs, similar, da_status, da_oidx,
                                tracked)
        da_dists = None
        if extras is not None:
            da_dists = extras["distance"][positions]
            self._dump_match_artifacts(similar, da_status, extras, positions,
                                       f_m_valid, f_xs_l, f_ys_l)
        order = np.argsort(-tracked)  # ≙ DATrackedSorter ranking
        best = int(tracked[order[0]]) if len(order) else 0
        res.best_tracked = best

        # LC confirmation (≙ .cpp:483-545): a CONFIRMED loop closure forces
        # the insertion; an unconfirmed potential LC neither inserts (beyond
        # voForceNewKf) nor shrinks thresholds; the no-potential-LC branch
        # inserts below updated_matches_th or shrinks the dynamic thresholds
        # from the TRACKED-FEATURE surplus (.cpp:525-541)
        lc_confirmed = None
        insert = force_new_kf
        new_tr_th = new_rot_th = None
        with self.profiler.section("confirmLC"):
            if lc_candidate is not None:
                lc_pos = similar.index(lc_candidate)
                if tracked[lc_pos] > 0.5 * best:
                    lc_confirmed = lc_candidate
                    insert = True
                    order = np.concatenate(
                        [[lc_pos], [o for o in order if o != lc_pos]]
                    ).astype(int)
            else:
                if best < self.opts.updated_matches_th:
                    insert = True
                elif best <= self.opts.updated_matches_th + \
                        self.opts.up_matches_th_plus:
                    olimit = (self.opts.updated_matches_th
                              + self.opts.up_matches_th_plus)
                    new_tr_th = update_translation_threshold(
                        best - self.opts.updated_matches_th,
                        self.opts.up_matches_th_plus,
                    )
                    new_rot_th = update_rotation_threshold(best, olimit)
        return dict(
            insert=insert, similar=similar, order=order, tracked=tracked,
            da_status=da_status, da_oidx=da_oidx, lc_confirmed=lc_confirmed,
            f_m_valid=f_m_valid, f_xs_l=f_xs_l, f_ys_l=f_ys_l, f_xs_r=f_xs_r,
            f_m_r=f_m_r, f_pts=f_pts, new_tr_th=new_tr_th,
            new_rot_th=new_rot_th, da_dists=da_dists,
        )

    def _dump_match_artifacts(self, similar, da_status, extras, positions,
                              m_valid, xs_l, ys_l):
        """Write the per-candidate match golden files the reference's
        ``debug=true`` mode produces: ``if_raw_match*`` (pre-filter matches,
        reference .cpp:1455-1473), ``if_match_after*`` (post-cascade status
        per match, .cpp:1649-1721) and ``posechange_outliers*`` (filter-4
        residual outliers, .cpp:2236-2251 — one file per new KF, the last
        cascade call's content surviving, as in the reference)."""
        kf_id = self.store.n_kfs
        raw_oidx = extras["raw_oidx"][positions]
        distance = extras["distance"][positions]
        residuals = extras["residuals"][positions]
        # other-KF left-keypoint coordinates, one bulk device read (debug
        # mode only — the hot path never pulls store rows)
        sim = np.asarray(similar)
        oth_x, oth_y = jax.device_get((self.store.arrays.xs_l[sim],
                                       self.store.arrays.ys_l[sim]))
        for s, other_kf in enumerate(similar):
            self.debug.dump_if_raw_match(
                kf_id, other_kf, xs_l, ys_l, oth_x[s], oth_y[s],
                raw_oidx[s], distance[s], m_valid)
            self.debug.dump_if_match_after(
                kf_id, other_kf, da_status[s], xs_l, ys_l, oth_x[s],
                oth_y[s], raw_oidx[s], distance[s], m_valid)
        if len(similar):
            s = len(similar) - 1
            sel = np.nonzero(m_valid & (distance[s] < 1e8)
                             & (residuals[s] > self.opts.residual_th))[0]
            self.debug.dump_posechange_outliers(kf_id, sel, residuals[s][sel])

    def _apply_no_insert(self, d: dict):
        """Threshold shrink of the no-insert branch (≙ .cpp:525-541)."""
        if d["new_tr_th"] is not None:
            self.updated_translation_th = d["new_tr_th"]
            self.updated_rotation_th = d["new_rot_th"]

    def _kf_apply(self, d: dict, frame, res: StepResult,
                  initial_rel: np.ndarray, pre_written: bool):
        """INSERT NEW KF (≙ .cpp:563-924) from a positive decision dict.

        ``pre_written=True`` means the keyframe row was already written to
        the device store/BoW DB speculatively — only the host counters and
        per-KF host fields commit here. ``initial_rel`` is the accumulated
        pose increment since the previous keyframe AT CHECK TIME (for
        ``use_initial_pose``). Returns the keyframe's match IDs."""
        import time as _time

        t0 = _time.perf_counter()
        ids, n_new, n_common = self._propagate_ids(
            d["f_m_valid"], d["da_status"], d["da_oidx"], d["similar"],
            d["order"], dists=d.get("da_dists"))
        obs = self._build_obs_host(d["f_m_valid"], d["f_xs_l"], d["f_ys_l"],
                                   d["f_xs_r"], d["f_m_r"], d["f_pts"], ids)
        if d["lc_confirmed"] is not None:
            self.rba.loop_closure_detected(True)
            self.rba.set_lc_old_id(d["lc_confirmed"])
            res.loop_closure_with = d["lc_confirmed"]
            self.debug.dump_loop_closure(self.store.n_kfs, d["lc_confirmed"],
                                         int(d["tracked"][d["order"][0]]))
        if self.opts.use_initial_pose:
            self.rba.set_initial_kf_pose(initial_rel)
        if self.solve_flush_before_insert and not self.solve_sync:
            # intermediate scheduling: land every QUEUED window solve before
            # this insertion dispatches its own — the new KF seeds from the
            # previous insertion's optimized state while the solves still
            # overlapped all frames since then (tools/solve_sync_probe.py
            # measures the fps/disagreement point; BASELINE.md)
            with self.profiler.section("solve_flush"):
                self.rba.flush()
        with self.profiler.section("define_kf"):
            try:
                info = self.rba.define_new_keyframe(obs, run_opt=True)
                if (d["lc_confirmed"] is not None
                        and self.rba.lc_rejects_last_insert):
                    # the confirmed closure's edge failed the creation-time
                    # consistency gate (aliased consensus): attempt the
                    # odometry-seeded RECOVERY before giving the closure up
                    tgt = self.rba._area_of(d["lc_confirmed"])
                    if any(self.rba._area_of(u) == tgt
                           for (u, _v) in self.rba.lc_rejects_last_insert):
                        if not self._lc_recovery(d, info.kf_id,
                                                 d["lc_confirmed"], ids,
                                                 frame):
                            res.lc_rejected_with = d["lc_confirmed"]
                            res.loop_closure_with = None
                if self.solve_sync:
                    self.rba.flush()
            except Exception as exc:
                # ≙ the reference's exception epilogue around
                # define_new_keyframe (.cpp:792-839): save the graph, the
                # trajectory so far, the timing stats, and a resumable
                # checkpoint before propagating the failure
                self.emergency_epilogue(exc)
                raise
        kf_id = info.kf_id
        new_global = self.rba.kf_global[kf_id].copy()
        if pre_written:
            committed = self.store.commit_row(ids, new_global)
            assert committed == kf_id
            self.bow.commit_row()
        else:
            self.store.append(frame, ids, new_global)
            self.bow.insert(frame.desc_l, frame.m_valid)
        if frame is not None:
            self.debug.dump_kf(kf_id, frame, ids)
        # restore thresholds (≙ .cpp:662-663)
        self.updated_translation_th = float(self.opts.max_translation)
        self.updated_rotation_th = float(self.opts.max_rotation)
        self.last_kf_pose = new_global.copy()
        dt = (_time.perf_counter() - t0) * 1e3
        res.inserted_kf = kf_id
        res.define_kf_ms = dt
        self.kf_stats.append(TStatsSRBA(dt, self.store.n_kfs, n_new, n_common))
        if self.general.show3D:
            self._live_viz_snapshot()
        return ids

    def _live_viz_snapshot(self):
        """Per-keyframe map snapshot (headless stand-in for the reference's
        LIVE CDisplayWindow3D updates, .cpp:1262-1338): overwrite
        ``<out_dir>/live_map.png`` with the current trajectory + the latest
        BoW query bars after every insertion, so a long run can be watched
        mid-flight — plus ``live_map.json``, the payload the live browser
        viewer (utils/live_server, ``--serve``) polls once a second.
        finalize() still renders the final optimized map."""
        out_dir = self.general.out_dir or "out"
        try:
            from srba_slam_tpu.utils.viz import render_map_png

            os.makedirs(out_dir, exist_ok=True)
            n = self.store.n_kfs
            q_scores = None
            if self.query_log:
                _f, sc, qids = self.query_log[-1]
                q_scores = np.zeros(n)
                for s_, i_ in zip(sc, qids):
                    if 0 <= int(i_) < n:
                        q_scores[int(i_)] = s_
            # raw camera-frame poses mid-run: plot the x-z ground plane
            render_map_png(
                os.path.join(out_dir, "live_map.png"),
                self.rba.kf_global[:n], query_scores=q_scores,
                query_score_th=self.opts.query_score_th, plane=(0, 2),
            )
            self._write_live_json(out_dir, q_scores)
        except Exception as exc:  # viz must never kill the pipeline
            self.log(1, f"live viz snapshot failed: {exc!r}")

    def _write_live_json(self, out_dir: str, q_scores=None):
        """Dump the current (mid-run, pre-epilogue) map as live_map.json for
        the polling browser viewer. Atomic rename so the poller never reads
        a half-written file."""
        import json as _json

        from srba_slam_tpu.utils.html_viewer import build_map_data

        n = self.store.n_kfs
        kinds = {0: "submap", 1: "base", 2: "lc"}
        data = build_map_data(
            self.rba.kf_global[:n],
            edges=[(self.rba._edge_u[e], self.rba._edge_v[e],
                    kinds.get(int(self.rba._edge_kind[e]), "submap"))
                   for e in range(self.rba.n_edges)
                   if self.rba._edge_valid[e]],
            query_scores=q_scores,
            query_score_th=self.opts.query_score_th,
            kf_frames=[r.frame_idx for r in self.step_log
                       if r.inserted_kf is not None],
            title="srba_slam_tpu live map (camera frame, mid-run)",
        )
        tmp = os.path.join(out_dir, ".live_map.json.tmp")
        with open(tmp, "w") as f:
            _json.dump(data, f)
        os.replace(tmp, os.path.join(out_dir, "live_map.json"))

    @property
    def current_world_pose(self) -> np.ndarray:
        """Camera pose in the world/robot frame: E ∘ T_cam
        (≙ m_current_pose, reference .cpp:922, :1112)."""
        return se3_np.compose(self.sensor_pose, self.current_pose)

    def _lc_recovery(self, d: dict, kf_id: int, lc_kf: int,
                     ids: np.ndarray, frame) -> bool:
        """Recover an aliasing-rejected confirmed loop closure (framework
        extension; no reference counterpart). The creation-time gate just
        proved the DA consensus disagrees with the odometry chain — but on
        an aliased world the TRUE correspondences are usually present among
        the raw matches, only outvoted by the period-offset consensus. So:
        (1) re-run the single-candidate DA with the change-in-pose solve
        seeded FROM the odometry-implied relative pose (recheck_candidate),
        which keeps exactly the odometry-consistent subset; (2) if it
        tracks enough (>= 15 and >= 0.5*best, the reference's own
        confirmation bar), re-propagate those match IDs and re-attach the
        observations to the far landmarks; (3) retry the loop-closure edge
        (geometric seed + the same consistency gate + post-solve
        validation). Mutates ``ids`` in place so the keyframe row commits
        the recovered IDs. Returns True when the edge was re-created."""
        from srba_slam_tpu.models.data_association import recheck_candidate

        # the recovery IS an odometry-prior-seeded change-in-pose re-check:
        # it only makes sense under a configuration whose DA uses pose-prior
        # seeds and the change-pose stage at all (≙ the ST2M_CHANGEPOSE /
        # ST2M_BOTH initialPose gate, reference .cpp:1372-1380)
        if self.opts.da_stage2_method not in (2, 3) \
                or not self.opts.da_filter_by_pose_change:
            return False
        if frame is not None:
            # per-frame mode: the new KF's row is not in the store yet
            self.store.write_row(frame, kf_id)
        init = se3_np.relative(self.rba.kf_global[lc_kf],
                               self.rba.kf_global[kf_id])
        sub = self._da_seed
        self._da_seed += 1
        status, oidx, tracked, _pose = jax.device_get(recheck_candidate(
            self.store.arrays, kf_id, lc_kf, self.cam,
            jnp.asarray(init, jnp.float32), sub,
            max_orb_distance_da=self.opts.max_orb_distance_da,
            residual_th=self.opts.residual_th,
            max_y_diff_epipolar=self.opts.max_y_diff_epipolar,
            filter_by_direction=self.opts.da_filter_by_direction,
            filter_by_orb_distance=self.opts.da_filter_by_orb_distance,
            use_fund_matrix=self.opts.da_filter_by_fund_matrix,
            kernel_param=self.vo_opts.kernel_param,
            ransac_n_hyp=self._ransac_n_hyp,
            # hard residual pre-gate at the odometry prior: without it the
            # recovery GN converges back into the aliased basin (Huber
            # downweights aliases, it does not zero them)
            init_gate_budget_m=self.rba.lc_budget(lc_kf, kf_id),
        ))
        best = int(max(d["tracked"])) if len(d["tracked"]) else 0
        if int(tracked) < max(15, int(0.5 * best)):
            self.log(1, f"kf{kf_id}: LC recovery re-check tracked only "
                        f"{int(tracked)} (need >= {max(15, int(0.5 * best))})")
            return False
        other_ids = self.store.match_ids[lc_kf]
        used = {int(i) for i in ids if i >= 0}
        pairs = []
        sel = np.nonzero((status == S_TRACKED) & (ids >= 0))[0]
        for f in sel:
            new_id = int(other_ids[oidx[f]])
            old_id = int(ids[f])
            if new_id < 0:
                continue
            if new_id != old_id and new_id in used:
                continue  # duplicate guard (≙ the foundIds guard, .cpp:596)
            pairs.append((old_id, new_id))
            if new_id != old_id:
                ids[f] = new_id
                used.add(new_id)
        if not pairs:
            return False
        n_moved = self.rba.reassociate_obs(kf_id, pairs,
                                           self.rba._area_of(lc_kf))
        ok = self.rba.retry_lc_edge(kf_id, lc_kf)
        self.log(1, f"kf{kf_id}: LC recovery vs kf{lc_kf}: tracked "
                    f"{int(tracked)}, {len(pairs)} id updates, {n_moved} "
                    f"obs re-attached, edge "
                    f"{'created' if ok else 'NOT created'}")
        return ok

    def _on_lc_reject(self, root: int, target_center: int, stage: str):
        """A loop-closure edge was rejected by the validator. For POST-SOLVE
        (layer B) rejections the insertion already logged a confirmed LC;
        move it to ``lc_rejected_with`` so trajectory consumers and tests
        see the closure as withdrawn (creation-time rejections are handled
        inline at :meth:`_kf_apply`)."""
        if stage != "solve":
            return
        for r in self.step_log:
            if r.inserted_kf == root and r.loop_closure_with is not None:
                r.lc_rejected_with = r.loop_closure_with
                r.loop_closure_with = None

    def _on_rba_commit(self, kf_id: int, old_global: np.ndarray,
                       new_global: np.ndarray):
        """A deferred window solve landed: record it and mark the pose
        bookkeeping dirty. Re-anchoring happens once per pull point via
        :meth:`_reanchor_if_dirty` (several queued solves may land at one
        pull; deriving from the final committed state is exact, a
        per-commit left-correction is not)."""
        if kf_id < self.store.n_kfs:
            self.store.set_pose(kf_id, new_global)
        self._pose_dirty = True

    def _reanchor_if_dirty(self):
        """Re-derive the pose bookkeeping from the committed graph, using
        the invariant current_pose = last_kf_global ∘ incr_from_last_kf.
        Only valid when the accumulated increment is measured from the last
        COMMITTED keyframe — i.e. after all speculative checks resolved."""
        if not self._pose_dirty or self._spec:
            return
        self._pose_dirty = False
        if self.store.n_kfs:
            self.last_kf_pose = self.rba.kf_global[self.store.n_kfs - 1].copy()
            self.current_pose = se3_np.compose(self.last_kf_pose,
                                               self.incr_from_last_kf)

    def _get_similar_kfs(self, scores, ids):
        """≙ m_get_similar_kfs (reference .cpp:1737-1878): prev KF always in;
        BoW results with score > 0.8*best; LC candidate = far-away (topo
        distance from the current submap base > lc_distance) with score > 0.05."""
        prev_kf = self.store.n_kfs - 1
        similar = [prev_kf]
        best = scores[0] if len(scores) else 0.0
        lc_candidate = None
        cur_base = (self.store.n_kfs // self.opts.srba_submap_size) \
            * self.opts.srba_submap_size
        cur_base = min(cur_base, prev_kf)
        for s, i in zip(scores, ids):
            i = int(i)
            if i < 0 or i == prev_kf or s <= 0:
                continue
            if s > 0.8 * best and i not in similar and len(similar) < MAX_SIMILAR:
                similar.append(i)
            if (
                lc_candidate is None
                and s > 0.05
                # never re-propose a candidate from an area pair a previous
                # validation rejected (perceptual-aliasing blacklist)
                and not self.rba.is_lc_blacklisted(
                    self.rba._area_of(i), self.rba._area_of(prev_kf))
                and not self.rba.is_lc_blacklisted(
                    self.rba._area_of(i), cur_base)
                and self.rba.topo_distance(cur_base, i, self.opts.lc_distance + 1)
                > self.opts.lc_distance
            ):
                lc_candidate = i
                if i not in similar:
                    if len(similar) >= MAX_SIMILAR:
                        similar[-1] = i
                    else:
                        similar.append(i)
        return similar, lc_candidate

    def _propagate_ids(self, m_valid, status, oidx, similar, order,
                       dists=None):
        """Feature-ID propagation (≙ .cpp:571-617): per stereo match, the
        first tracked hit across ranked similar KFs reuses that KF's match
        ID (duplicate guard); everything else gets a fresh ID. All inputs are
        host arrays; per-rank work is vectorized (feature loops here used to
        dominate insertion host time). With ``dists`` (debug mode: per-rank
        raw match distances), writes the ``da_dist_kf*`` golden file — the
        winning tracked match's distance per slot, 0.00 for new features
        (≙ reference .cpp:566-616)."""
        k = self.capacity
        ids = np.full(k, -1, np.int64)
        used = np.zeros(0, np.int64)
        n_common = 0
        win_dist = np.zeros(k, np.float32)
        for rank in order:
            if rank >= len(similar):
                continue
            other_kf = similar[int(rank)]
            other_ids = self.store.match_ids[other_kf]
            sel = np.nonzero((status[rank] == S_TRACKED) & m_valid & (ids < 0))[0]
            if not len(sel):
                continue
            cand = other_ids[oidx[rank, sel]]
            ok = (cand >= 0) & ~np.isin(cand, used)
            sel, cand = sel[ok], cand[ok]
            # duplicate guard within this rank: first feature (lowest index)
            # claims a repeated candidate id
            _uniq, first = np.unique(cand, return_index=True)
            sel, cand = sel[first], cand[first]
            ids[sel] = cand
            if dists is not None:
                win_dist[sel] = dists[int(rank), sel]
            used = np.concatenate([used, cand])
            n_common += len(sel)
        fresh = m_valid & (ids < 0)
        n_new = int(fresh.sum())
        ids[fresh] = np.arange(self.next_match_id, self.next_match_id + n_new)
        self.next_match_id += n_new
        if dists is not None:
            self.debug.dump_da_dist(self.store.n_kfs, win_dist[m_valid])
        return ids, n_new, n_common

    def _mint_fresh_ids(self, m_valid: np.ndarray) -> np.ndarray:
        ids = np.full(self.capacity, -1, np.int64)
        n = int(m_valid.sum())
        ids[m_valid] = np.arange(self.next_match_id, self.next_match_id + n)
        self.next_match_id += n
        return ids

    def _build_obs(self, frame, ids, first_kf: bool):
        """Observation arrays for SRBA (≙ .cpp:139-161 / 685-728); pulls the
        frame arrays in one transfer then delegates."""
        (m_valid, xs_l, ys_l, xs_r, m_r, pts) = jax.device_get(
            (frame.m_valid, frame.xs_l, frame.ys_l, frame.xs_r,
             frame.m_r_idx, frame.pts3d)
        )
        return self._build_obs_host(m_valid, xs_l, ys_l, xs_r, m_r, pts, ids)

    def _build_obs_host(self, m_valid, xs_l, ys_l, xs_r, m_r, pts, ids):
        """Vectorized (lm_ids, px, rel) observation arrays; the engine falls
        back to its default init for rows whose rel is non-finite and ignores
        rel for already-registered landmarks."""
        sel = np.nonzero(m_valid & (ids >= 0))[0]
        lm_ids = ids[sel]
        px = np.stack([
            xs_l[sel].astype(np.float64),
            ys_l[sel].astype(np.float64),
            xs_r[m_r[sel]].astype(np.float64),
        ], axis=-1)
        rel = pts[sel].astype(np.float64)
        return (lm_ids, px, rel)

    # -------------------------------------------------------------- epilogue
    def emergency_epilogue(self, exc: BaseException | None = None):
        """≙ the exception handler around define_new_keyframe (reference
        .cpp:792-839): on a mid-run failure, persist everything recoverable —
        final_graph.dot, out_kf_poses.txt, profiler.csv, and a full
        checkpoint — to ``<out_dir>/crash/`` so no state is lost. Never
        raises (best-effort; the original exception is the caller's)."""
        out_dir = os.path.join(self.general.out_dir or "out", "crash")
        try:
            os.makedirs(out_dir, exist_ok=True)
            with open(os.path.join(out_dir, "error.txt"), "w") as f:
                f.write(f"{type(exc).__name__ if exc else 'unknown'}: {exc}\n")
        except Exception:
            return
        try:
            self.rba._pending = []  # failed/in-flight solves are not committable
            self.rba._queued = []
            self._spec = []         # unresolved speculative checks likewise
            self._check_plan = []
            self._walk_log = []
            self.finalize(out_dir=out_dir)
        except Exception:
            # minimal fallback: raw graph + unoptimized trajectory
            try:
                self.final_poses = self.rba.kf_global[: self.store.n_kfs].copy()
                self.final_poses_cam = self.final_poses
                self.save_trajectory(os.path.join(out_dir, "out_kf_poses.txt"))
                self.save_kf_stats(os.path.join(out_dir, "time_new_kf.txt"))
                self.profiler.save_csv(os.path.join(out_dir, "profiler.csv"))
                self.rba.save_graph_as_dot(
                    os.path.join(out_dir, "final_graph.dot"))
            except Exception:
                pass
        try:
            from srba_slam_tpu.utils.checkpoint import save_state

            save_state(self, os.path.join(out_dir, "emergency_state.npz"))
        except Exception:
            pass

    def finalize(self, out_dir: str | None = None):
        """Final global pose-graph optimization + outputs
        (≙ the epilogue, reference .cpp:939-1096)."""
        self._finish_batched()
        n = self.store.n_kfs
        self.rba.flush()
        if n >= 2 and self.rba.n_edges:
            eu, ev, rel = self.rba.get_global_graphslam_problem()
            e_pad = max(64, 1 << (len(eu) - 1).bit_length())
            n_pad = max(64, 1 << (n - 1).bit_length())
            eu_a = np.zeros(e_pad, np.int32); eu_a[: len(eu)] = eu
            ev_a = np.zeros(e_pad, np.int32); ev_a[: len(ev)] = ev
            rel_a = np.zeros((e_pad, 6), np.float32); rel_a[: len(eu)] = rel
            e_valid = np.zeros(e_pad, bool); e_valid[: len(eu)] = True
            poses0 = np.zeros((n_pad, 6), np.float32)
            poses0[:n] = self.rba.kf_global[:n]
            with self.profiler.section("global_posegraph"):
                poses, c0, c1, _ = optimize_pose_graph(
                    jnp.asarray(poses0), jnp.asarray(np.arange(n_pad) < n),
                    jnp.asarray(eu_a), jnp.asarray(ev_a), jnp.asarray(rel_a),
                    jnp.asarray(e_valid), max_iters=25,
                )
            final_cam = np.asarray(poses)[:n].astype(np.float64)
        else:
            final_cam = self.rba.kf_global[:n].copy()
        # world-frame KF poses T_world = E ∘ T_cam ∘ E⁻¹ (≙ the reference's
        # robot-frame keyframe poses; camera_pose_on_robot semantics above)
        self.final_poses_cam = final_cam
        E = np.broadcast_to(self.sensor_pose, final_cam.shape)
        Ei = np.broadcast_to(self.sensor_pose_inv, final_cam.shape)
        self.final_poses = (
            se3_np.compose_batch(se3_np.compose_batch(E, final_cam), Ei)
            if n else final_cam
        )

        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            self.save_trajectory(os.path.join(out_dir, "out_kf_poses.txt"))
            # sidecar kf-id -> frame-index map: lets the standalone ATE tool
            # (python -m srba_slam_tpu.utils.evaluation) associate keyframes
            # with rows of a PER-FRAME ground truth (e.g. KITTI poses.txt)
            # without re-running SLAM — framework extension; the reference
            # only emits out_kf_poses.txt (.cpp:977-987)
            with open(os.path.join(out_dir, "kf_frames.txt"), "w") as f:
                for r in self.step_log:
                    if r.inserted_kf is not None:
                        f.write(f"{r.inserted_kf} {r.frame_idx}\n")
            self.save_kf_stats(os.path.join(out_dir, "time_new_kf.txt"))
            self.profiler.save_csv(os.path.join(out_dir, "profiler.csv"))
            self.rba.save_graph_as_dot(os.path.join(out_dir, "final_graph.dot"))
            # map + trajectory point cloud (≙ final_global_path.3DScene)
            from srba_slam_tpu.utils.debug_dumps import export_scene_ply

            # landmarks composed with the OPTIMIZED base-KF poses so map and
            # trajectory share the post-epilogue frame
            n_lms = self.rba.n_lms
            bases = self.rba.lm_base[:n_lms]
            in_range = bases < len(self.final_poses_cam)
            # landmark world position = (E ∘ T_cam_base) applied to the
            # base-frame point
            world_cam = se3_np.compose_batch(
                np.broadcast_to(self.sensor_pose,
                                self.final_poses_cam.shape),
                self.final_poses_cam,
            ) if n else self.final_poses_cam
            lms = list(se3_np.transform_points_by_pose(
                world_cam[bases[in_range]],
                self.rba.lm_pos[:n_lms][in_range],
            )) if in_range.any() else []
            export_scene_ply(
                os.path.join(out_dir, "final_global_path.ply"),
                self.final_poses, np.asarray(lms) if lms else None,
            )
            # interactive equivalent of the reference's live 3D window
            # (.cpp:1262-1338): one self-contained HTML file — orbit/zoom/
            # pan over trajectory + landmarks + typed kf2kf edges + frusta
            # + the BoW score bars; works offline in any browser
            from srba_slam_tpu.utils.html_viewer import write_map_viewer

            q_scores_v = None
            if self.query_log:
                _f, sc, qids = self.query_log[-1]
                q_scores_v = np.zeros(self.store.n_kfs)
                for s_, i_ in zip(sc, qids):
                    if 0 <= int(i_) < len(q_scores_v):
                        q_scores_v[int(i_)] = s_
            kinds = {0: "submap", 1: "base", 2: "lc"}
            write_map_viewer(
                os.path.join(out_dir, "map_viewer.html"),
                self.final_poses,
                landmarks=np.asarray(lms) if lms else None,
                edges=[(self.rba._edge_u[e], self.rba._edge_v[e],
                        kinds.get(int(self.rba._edge_kind[e]), "submap"))
                       for e in range(self.rba.n_edges)
                   if self.rba._edge_valid[e]],
                query_scores=q_scores_v,
                query_score_th=self.opts.query_score_th,
                kf_frames=[r.frame_idx for r in self.step_log
                           if r.inserted_kf is not None],
            )
            if self.general.show3D:
                # headless stand-in for the live 3D window (≙ show3D)
                from srba_slam_tpu.utils.viz import render_map_png

                q_scores = None
                if self.query_log:
                    # last check's ranked scores placed at their KF ids
                    _f, sc, qids = self.query_log[-1]
                    q_scores = np.zeros(self.store.n_kfs)
                    for s_, i_ in zip(sc, qids):
                        if 0 <= int(i_) < len(q_scores):
                            q_scores[int(i_)] = s_
                render_map_png(
                    os.path.join(out_dir, "final_global_path.png"),
                    self.final_poses, np.asarray(lms) if lms else None,
                    query_scores=q_scores,
                    query_score_th=self.opts.query_score_th,
                )
        return self.final_poses

    def save_trajectory(self, path: str):
        """``kf x y z yaw pitch roll`` rows (≙ out_kf_poses.txt,
        reference .cpp:977-987)."""
        from srba_slam_tpu.utils import se3 as se3j

        with open(path, "w") as f:
            for i in range(self.store.n_kfs):
                p = self.final_poses[i]
                R, t = se3_np.exp(p)
                ypr = np.asarray(se3j.ypr_from_rotmat(jnp.asarray(R, jnp.float32)))
                f.write(
                    f"{i} {t[0]:.6f} {t[1]:.6f} {t[2]:.6f} "
                    f"{ypr[0]:.6f} {ypr[1]:.6f} {ypr[2]:.6f}\n"
                )

    def save_kf_stats(self, path: str):
        """≙ time_new_kf.txt (reference .cpp:940-943)."""
        with open(path, "w") as f:
            for s in self.kf_stats:
                f.write(
                    f"{s.time_ms:.3f} {s.number_kfs} {s.number_feats_new} "
                    f"{s.number_feats_common}\n"
                )

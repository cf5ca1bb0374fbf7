"""Stereo visual-odometry engine (≙ rso::CStereoOdometryEstimator).

Reproduces the behavioral contract the reference app drives through the
external stereo-vo library (reference src/CSRBAStereoSLAMEstimator.cpp:112,
267, 2139-2147; forced modes dmORB / smDescRbR / ifmDescBF at :1135-1137):

* per frame: ORB-style detection on both rectified images, epipolar-gated
  stereo matching, brute-force tracking against the previous frame, robust
  two-stage pose estimation, track-ID bookkeeping;
* the adaptive FAST/ORB threshold protocol (get/set/isMin/isMax/reset —
  reference :275-311) is exposed as plain host attributes so the estimator's
  retry loop works unchanged;
* ``set_this_frame_as_kf`` / ``reset_ids`` mirror the KF hand-off
  (reference :113, :403, :620).

Architecture: two jitted fixed-shape device programs do all the math —
``extract_and_match`` (detect → NMS → top-K → describe → stereo match →
triangulate, both images batched together) and ``track_and_solve``
(inter-frame Hamming matching + robust GN pose). The host object holds a
FrameFeatures pytree for the previous frame plus numpy track-IDs, and makes
only scalar-sized host↔device transfers per frame.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np

import jax
import jax.numpy as jnp

from srba_slam_tpu.config import VOOptions
from srba_slam_tpu.ops.fast import fast_score_map
from srba_slam_tpu.ops.matching import interframe_match, stereo_match
from srba_slam_tpu.ops.nms import grid_topk, local_max_suppress
from srba_slam_tpu.ops.orb import describe
from srba_slam_tpu.ops.robust_lm import PoseSolveResult, solve_pose
from srba_slam_tpu.utils.camera import StereoCamera, project_match_to_3d


class FrameFeatures(NamedTuple):
    """Fixed-capacity per-frame feature set (capacity K static)."""

    ys_l: jax.Array      # int32 [K]
    xs_l: jax.Array
    score_l: jax.Array   # f32 [K]
    valid_l: jax.Array   # bool [K]
    desc_l: jax.Array    # uint32 [K, 8]
    ys_r: jax.Array
    xs_r: jax.Array
    valid_r: jax.Array
    desc_r: jax.Array
    m_r_idx: jax.Array   # int32 [K] stereo match: left i -> right m_r_idx[i]
    m_valid: jax.Array   # bool [K]
    pts3d: jax.Array     # f32 [K, 3] triangulated in left camera frame
    octave: jax.Array    # int32 [K] pyramid level the feature was detected at


def _avgpool2(img: jax.Array) -> jax.Array:
    """2x decimation for the next pyramid octave."""
    s = jax.lax.reduce_window(img, 0.0, jax.lax.add, (2, 2), (2, 2), "VALID")
    return s * 0.25


def _octave_budget(h0: int, w0: int, cell: int, k: int, n_levels: int):
    """Feature-budget split across pyramid octaves, capped by each octave's
    grid-cell count (lax.top_k over fewer cells than k would fail at trace
    time); any deficit from capped deep octaves flows back to octave 0."""
    cells = [((h0 >> lv) // cell) * ((w0 >> lv) // cell)
             for lv in range(n_levels)]
    k_levels = [min(k // n_levels, cells[lv]) for lv in range(n_levels)]
    k_levels[0] = k - sum(k_levels[1:])
    if k_levels[0] > cells[0]:
        raise ValueError(
            f"feature capacity k={k} exceeds octave-0 grid cells {cells[0]} "
            f"(image {h0}x{w0}, cell {cell})"
        )
    return k_levels


def _detect_describe_batch(imgs, fast_th, k, cell, nms_radius, margin,
                           oriented, n_levels):
    """Detect + describe for a whole batch of images at once.

    ``imgs``: [N, H, W] float32. Returns (ys, xs, sc, valid, desc, octv),
    each with leading dim N. Per-image math is identical to the per-frame
    path (vmap of the same stages); batching exists so the image-wide
    stages (FAST/NMS/blur) run as one large op instead of N small ones.
    """
    n, h0, w0 = imgs.shape
    k_levels = _octave_budget(h0, w0, cell, k, n_levels)
    per = []
    cur = imgs
    for lvl in range(n_levels):
        kl = k_levels[lvl]
        s = jax.vmap(lambda im: local_max_suppress(
            fast_score_map(im, fast_th, margin=margin),
            radius=nms_radius))(cur)
        ys, xs, sc, valid = jax.vmap(
            functools.partial(grid_topk, cell=cell, k=kl))(s)
        # stage barrier: without it XLA re-fuses the whole detector into
        # the descriptor gathers / matcher broadcasts and recomputes it
        # per element (50 ms and 400 s compiles observed; ~2 ms with)
        ys, xs, sc, valid = jax.lax.optimization_barrier((ys, xs, sc, valid))
        desc = jax.vmap(lambda im, y, x, v: describe(
            im, y, x, v, oriented=oriented, patch_safe=margin >= 16)[0]
        )(cur, ys, xs, valid)
        octv = jnp.full((n, kl), lvl, jnp.int32)
        per.append((ys << lvl, xs << lvl, sc, valid, desc, octv))
        if lvl + 1 < n_levels:
            cur = jax.vmap(_avgpool2)(cur)
    return tuple(jnp.concatenate(parts, axis=1) for parts in zip(*per))


def _build_frame(det_l, det_r, cam, orb_th, max_y_diff, min_disparity,
                 max_disparity, robust_1to1) -> FrameFeatures:
    """Stereo-match one detected pair and triangulate (single frame)."""
    (ys_l, xs_l, sc_l, v_l, d_l, o_l) = det_l
    (ys_r, xs_r, _sc_r, v_r, d_r, o_r) = det_r
    m = stereo_match(
        d_l, d_r, ys_l, xs_l, ys_r, xs_r, v_l, v_r,
        max_y_diff=max_y_diff, orb_max_distance=orb_th,
        min_disparity=min_disparity, max_disparity=max_disparity,
        oct_l=o_l, oct_r=o_r, robust_1to1=robust_1to1,
    )
    xr = xs_r[m.idx].astype(jnp.float32)
    pts = project_match_to_3d(
        xs_l.astype(jnp.float32), ys_l.astype(jnp.float32), xr, cam
    )
    pts = jnp.where(m.valid[:, None], pts, 0.0)
    return FrameFeatures(
        ys_l=ys_l, xs_l=xs_l, score_l=sc_l, valid_l=v_l, desc_l=d_l,
        ys_r=ys_r, xs_r=xs_r, valid_r=v_r, desc_r=d_r,
        m_r_idx=m.idx, m_valid=m.valid, pts3d=pts, octave=o_l,
    )


@functools.partial(
    jax.jit,
    static_argnames=("k", "cell", "nms_radius", "margin", "max_y_diff",
                     "min_disparity", "max_disparity", "oriented", "n_levels",
                     "robust_1to1"),
)
def extract_and_match(
    left: jax.Array,
    right: jax.Array,
    cam: StereoCamera,
    fast_th: jax.Array,
    orb_th: jax.Array,
    k: int = 512,
    cell: int = 5,
    nms_radius: int = 2,
    margin: int = 16,
    max_y_diff: float = 2.0,
    min_disparity: float = 0.1,
    max_disparity: float = 1e9,
    oriented: bool = False,
    n_levels: int = 1,
    robust_1to1: bool = False,
    rect_maps=None,
) -> FrameFeatures:
    """Full frontend for one stereo pair; one compiled program.

    ``n_levels`` > 1 detects/describes on a 2x image pyramid (≙ the
    stereo-vo nOctaves option) — coordinates are reported at full resolution,
    descriptors are sampled at the detecting octave's scale. The feature
    budget splits evenly across octaves (remainder to octave 0).

    ``rect_maps``, when given as a (RectifyMaps_left, RectifyMaps_right)
    pair, runs the RECTIFY stage first (≙ stereo-vo's rectification for
    ``rectified_images=false`` rigs): the undistortion remap fuses into this
    same compiled program.
    """
    # cast on device: hosts upload native 8-bit frames (a quarter of the
    # host->device bytes of f32)
    left = left.astype(jnp.float32)
    right = right.astype(jnp.float32)
    if rect_maps is not None:
        from srba_slam_tpu.ops.rectify import remap_bilinear

        left = remap_bilinear(left, rect_maps[0])
        right = remap_bilinear(right, rect_maps[1])
    imgs = jnp.stack([left, right])
    out = _detect_describe_batch(
        imgs, fast_th, k=k, cell=cell, nms_radius=nms_radius, margin=margin,
        oriented=oriented, n_levels=n_levels,
    )
    out = jax.lax.optimization_barrier(out)
    det_l = tuple(a[0] for a in out)
    det_r = tuple(a[1] for a in out)
    return _build_frame(det_l, det_r, cam, orb_th, max_y_diff,
                        min_disparity, max_disparity, robust_1to1)


class TrackSolveOut(NamedTuple):
    track_idx: jax.Array    # int32 [K]: cur i -> prev track_idx[i]
    track_valid: jax.Array  # bool [K]
    pose: PoseSolveResult


@functools.partial(
    jax.jit,
    static_argnames=("k", "cell", "nms_radius", "margin", "max_y_diff",
                     "min_disparity", "max_disparity", "oriented", "n_levels",
                     "max_iters_initial", "max_iters", "robust_1to1",
                     "filter_fund_matrix"),
)
def vo_scan(
    lefts: jax.Array,         # f32 [B, H, W]
    rights: jax.Array,        # f32 [B, H, W]
    prev: FrameFeatures,      # carry-in from the previous batch
    init_pose: jax.Array,     # [6] initial increment guess
    cam: StereoCamera,
    fast_th: jax.Array,
    orb_th: jax.Array,
    k: int = 512,
    cell: int = 5,
    nms_radius: int = 2,
    margin: int = 16,
    max_y_diff: float = 2.0,
    min_disparity: float = 0.1,
    max_disparity: float = 1e9,
    oriented: bool = False,
    n_levels: int = 1,
    kernel_param: float = 2.0,
    residual_threshold: float = 15.0,
    min_mod: float = 1e-3,
    max_iters_initial: int = 30,
    max_iters: int = 30,
    min_inliers: int = 5,
    max_incr_cost: int = 3,
    robust_1to1: bool = False,
    filter_fund_matrix: bool = False,
    rect_maps=None,
):
    """Whole-batch VO in one device dispatch (one host round-trip per
    batch instead of per frame).

    Two phases: (1) the frontend (rectify -> detect -> describe -> stereo
    match -> triangulate) for ALL 2B images as one batched computation —
    frames are independent there, so the image-wide stages run wide
    instead of serialized through a scan; (2) a lax.scan of track_and_solve over the B
    frames, which is genuinely sequential (each frame tracks against its
    predecessor's features and warm-starts from its pose increment).

    Per-frame math is identical to per-frame stepping; results match
    bit-exactly (tests/test_batch_mode.py).

    Returns per-frame FrameFeatures (stacked) + tracking/pose outputs; the
    host applies keyframe logic afterwards from a single bulk transfer.
    """
    b = lefts.shape[0]
    imgs = jnp.concatenate([lefts, rights], axis=0).astype(jnp.float32)
    if rect_maps is not None:
        from srba_slam_tpu.ops.rectify import remap_bilinear

        maps = jax.tree.map(
            lambda l_, r_: jnp.concatenate(
                [jnp.broadcast_to(l_, (b,) + l_.shape),
                 jnp.broadcast_to(r_, (b,) + r_.shape)], axis=0),
            rect_maps[0], rect_maps[1])
        imgs = jax.vmap(remap_bilinear)(imgs, maps)
    det = _detect_describe_batch(
        imgs, fast_th, k=k, cell=cell, nms_radius=nms_radius, margin=margin,
        oriented=oriented, n_levels=n_levels,
    )
    det = jax.lax.optimization_barrier(det)
    det_l = tuple(a[:b] for a in det)
    det_r = tuple(a[b:] for a in det)
    curs = jax.vmap(
        lambda dl, dr: _build_frame(dl, dr, cam, orb_th, max_y_diff,
                                    min_disparity, max_disparity, robust_1to1)
    )(det_l, det_r)
    curs = jax.lax.optimization_barrier(curs)

    def step(carry, cur):
        prev_feat, last_inc = carry
        out = track_and_solve(
            prev_feat, cur, cam, last_inc, orb_th,
            kernel_param=kernel_param,
            residual_threshold=residual_threshold,
            min_mod=min_mod,
            max_iters_initial=max_iters_initial,
            max_iters=max_iters,
            min_inliers=min_inliers,
            max_incr_cost=max_incr_cost,
            filter_fund_matrix=filter_fund_matrix,
        )
        next_inc = jnp.where(out.pose.valid, out.pose.pose, last_inc)
        ys = (out.track_idx, out.track_valid, out.pose.pose,
              out.pose.valid, out.pose.num_inliers, out.pose.mean_residual)
        return (cur, next_inc), ys

    (last_feat, last_inc), souts = jax.lax.scan(step, (prev, init_pose), curs)
    outs = (curs,) + souts
    return last_feat, last_inc, outs


@functools.partial(jax.jit, static_argnames=("max_iters_initial", "max_iters",
                                             "filter_fund_matrix"))
def track_and_solve(
    prev: FrameFeatures,
    cur: FrameFeatures,
    cam: StereoCamera,
    initial_pose: jax.Array,
    orb_th: jax.Array,
    kernel_param: float = 2.0,
    residual_threshold: float = 15.0,
    min_mod: float = 1e-3,
    max_iters_initial: int = 30,
    max_iters: int = 30,
    min_inliers: int = 5,
    max_incr_cost: int = 3,
    filter_fund_matrix: bool = False,
) -> TrackSolveOut:
    """Track stereo-matched features into the current frame and solve the
    frame-to-frame pose increment (x_cur = T x_prev)."""
    m = interframe_match(cur.desc_l, prev.desc_l, cur.m_valid, prev.m_valid,
                         orb_max_distance=orb_th,
                         oct_a=cur.octave, oct_b=prev.octave)
    pts_prev = prev.pts3d[m.idx]                       # [K, 3]
    ur = cur.xs_r[cur.m_r_idx].astype(jnp.float32)
    obs = jnp.stack(
        [cur.xs_l.astype(jnp.float32), cur.ys_l.astype(jnp.float32), ur], axis=-1
    )
    valid = m.valid & cur.m_valid
    if filter_fund_matrix:
        # ≙ the stereo-vo IF-MATCH filter_fund_matrix option: gate the
        # tracked matches by fundamental-matrix RANSAC over the left pixels
        # before the pose solve (applied only when enough matches survive)
        from srba_slam_tpu.ops.ransac import ransac_fundamental

        inl, _cnt, _F = ransac_fundamental(
            cur.xs_l.astype(jnp.float32), cur.ys_l.astype(jnp.float32),
            prev.xs_l[m.idx].astype(jnp.float32),
            prev.ys_l[m.idx].astype(jnp.float32),
            valid, jax.random.PRNGKey(0), threshold=2.0, n_hyp=64,
        )
        n_alive = jnp.sum(valid.astype(jnp.int32))
        valid = jnp.where(n_alive >= 15, valid & inl, valid)
    # stage barrier before the GN loop (prevents recompute-through-fusion of
    # the matcher into every solver iteration)
    pts_prev, obs, valid = jax.lax.optimization_barrier((pts_prev, obs, valid))
    res = solve_pose(
        pts_prev, obs, valid, cam,
        initial_pose=initial_pose,
        kernel_param=kernel_param,
        residual_threshold=residual_threshold,
        min_mod=min_mod,
        max_iters_initial=max_iters_initial,
        max_iters=max_iters,
        min_inliers=min_inliers,
        max_incr_cost=max_incr_cost,
    )
    return TrackSolveOut(track_idx=m.idx, track_valid=valid, pose=res)


class VOResult(NamedTuple):
    """≙ TStereoOdometryResult (reference .cpp:268-269, 318-360)."""

    valid: bool
    pose_increment: np.ndarray          # [6] prev-frame -> cur-frame
    num_stereo_matches: int
    tracked_from_last_frame: int
    tracked_from_last_kf: int
    mean_residual: float
    num_iters: int


@dataclass
class StereoVOEngine:
    """Host orchestrator; all heavy math happens in the two jitted programs."""

    cam: StereoCamera
    opts: VOOptions = field(default_factory=VOOptions)
    capacity: int = 512

    def __post_init__(self):
        self.fast_th: float = float(self.opts.fast_th)
        self.fast_th_min: float = 5.0
        self.fast_th_max: float = float(self.opts.fast_th)
        self.orb_th: float = float(self.opts.orb_max_distance)
        self.orb_th_max: float = 90.0
        self._prev: FrameFeatures | None = None
        self._prev_ids: np.ndarray = np.full(self.capacity, -1, np.int64)
        self._kf_id_set: set[int] = set()
        self._cur: FrameFeatures | None = None
        self._cur_ids: np.ndarray | None = None
        self._last_pose_inc = np.zeros(6, np.float32)
        self._next_id: int = 0
        # optional (RectifyMaps_l, RectifyMaps_r) undistortion grids applied
        # inside the frontend program (set by the estimator when the config
        # declares unrectified input)
        self.rect_maps = None
        if not self.opts.vo_use_matches_ids:
            # ≙ the stereo-vo GENERAL vo_use_matches_ids option: the SLAM
            # layer REQUIRES match-id bookkeeping (feature-ID propagation,
            # ≙ generateMatchesIDs) — honor the key by refusing to silently
            # disable it
            import sys

            print("[srba_slam_tpu] warning: vo_use_matches_ids=false "
                  "requested, but SLAM requires match-ID bookkeeping — "
                  "keeping it enabled", file=sys.stderr)

    def _mint_ids(self, ids: np.ndarray, m_valid: np.ndarray) -> np.ndarray:
        fresh = m_valid & (ids < 0)
        n = int(fresh.sum())
        ids[fresh] = np.arange(self._next_id, self._next_id + n)
        self._next_id += n
        return ids

    # --- adaptive threshold protocol (reference .cpp:275-311) -------------
    def is_fast_th_min(self) -> bool:
        return self.fast_th <= self.fast_th_min

    def is_orb_th_max(self) -> bool:
        return self.orb_th >= self.orb_th_max

    def set_fast_threshold(self, th: float):
        self.fast_th = float(np.clip(th, self.fast_th_min, 255.0))

    def set_orb_threshold(self, th: float):
        self.orb_th = float(np.clip(th, 1.0, self.orb_th_max))

    def reset_fast_threshold(self):
        self.fast_th = self.fast_th_max

    def reset_orb_threshold(self):
        self.orb_th = float(self.opts.orb_max_distance)

    def retry_step(self) -> bool:
        """One adaptive-retry threshold move (≙ the do-while body of
        reference .cpp:271-315): drop FAST by 10 while it can still drop,
        then raise the ORB matching threshold by 10. Returns True when a
        threshold moved (the caller re-processes the same frame / batch
        tail); False when both are exhausted. Single source for the
        per-frame retry loop, the batched-scan retry, and the fleet's
        lockstep retry."""
        if not self.is_fast_th_min():
            self.set_fast_threshold(self.fast_th - 10)
            return True
        if not self.is_orb_th_max():
            self.set_orb_threshold(self.orb_th + 10)
            return True
        return False

    def drift_thresholds(self, n_matches: float, th_min: float):
        """Post-retry healthy drift (≙ the tail adjustments of reference
        .cpp:298-314): below 1.2x the minimum (soft zone, no re-process)
        pull FAST down by 5, or — when FAST already sits on its floor —
        raise the ORB matching threshold by 5 (reference .cpp:301-306); a
        healthy frame drifts FAST back toward its configured baseline
        ``min(detect_fast_th, fast+5)`` (.cpp:310) and resets the ORB
        threshold. Same single-source rationale as :meth:`retry_step`."""
        if n_matches < 1.2 * th_min:
            if not self.is_fast_th_min():
                self.set_fast_threshold(self.fast_th - 5)
            elif not self.is_orb_th_max():
                self.set_orb_threshold(self.orb_th + 5)
        else:
            self.set_fast_threshold(min(self.fast_th_max, self.fast_th + 5))
            self.reset_orb_threshold()

    # --- main per-frame entry (≙ processNewImagePair) ---------------------
    def process_stereo_pair(self, left: np.ndarray, right: np.ndarray) -> VOResult:
        cur = extract_and_match(
            jnp.asarray(left), jnp.asarray(right), self.cam,
            jnp.float32(self.fast_th), jnp.int32(self.orb_th),
            k=self.capacity, cell=self.opts.min_distance,
            max_y_diff=self.opts.max_y_diff,
            oriented=self.opts.orb_oriented,
            n_levels=self.opts.n_octaves,
            robust_1to1=self.opts.enable_robust_1to1_match,
            rect_maps=self.rect_maps,
        )
        if self._prev is None:
            m_valid_h = np.asarray(cur.m_valid)
            n_matches = int(m_valid_h.sum())
            self._cur = cur
            self._cur_ids = self._mint_ids(
                np.full(self.capacity, -1, np.int64), m_valid_h
            )
            self._advance()
            return VOResult(True, np.zeros(6, np.float32), n_matches, 0, 0, 0.0, 0)

        init = (
            jnp.asarray(self._last_pose_inc)
            if self.opts.use_previous_pose_as_initial
            else jnp.zeros(6, jnp.float32)
        )
        out = track_and_solve(
            self._prev, cur, self.cam, init, jnp.int32(self.orb_th),
            kernel_param=self.opts.kernel_param,
            residual_threshold=self.opts.residual_threshold,
            min_mod=self.opts.min_mod_out_vector,
            max_iters_initial=self.opts.initial_max_iters,
            max_iters=self.opts.max_iters,
            min_inliers=self.opts.bad_tracking_th,
            max_incr_cost=self.opts.max_incr_cost,
            filter_fund_matrix=self.opts.filter_fund_matrix,
        )
        # one bulk host transfer for everything the frame decision needs
        (track_idx, track_valid, m_valid_h, pose_inc, pose_ok, mean_res,
         iters) = jax.device_get(
            (out.track_idx, out.track_valid, cur.m_valid, out.pose.pose,
             out.pose.valid, out.pose.mean_residual, out.pose.iters)
        )
        n_matches = int(m_valid_h.sum())
        # ID propagation: tracked features inherit the previous frame's IDs;
        # fresh stereo matches get fresh IDs from the engine counter (the
        # estimator may overwrite them at KF insertion via set_frame_ids)
        cur_ids = np.full(self.capacity, -1, np.int64)
        cur_ids[track_valid] = self._prev_ids[track_idx[track_valid]]
        cur_ids[~m_valid_h] = -1
        cur_ids = self._mint_ids(cur_ids, m_valid_h)
        tracked_last = int(track_valid.sum())
        if self._kf_id_set:
            kf_ids = np.fromiter(self._kf_id_set, np.int64)
            tracked_kf = int(np.isin(cur_ids[cur_ids >= 0], kf_ids).sum())
        else:
            tracked_kf = 0

        ok = bool(pose_ok)
        self._cur = cur
        self._cur_ids = cur_ids
        if ok:
            self._last_pose_inc = pose_inc
        self._advance()
        return VOResult(
            valid=ok,
            pose_increment=pose_inc if ok else np.zeros(6, np.float32),
            num_stereo_matches=n_matches,
            tracked_from_last_frame=tracked_last,
            tracked_from_last_kf=tracked_kf,
            mean_residual=float(mean_res),
            num_iters=int(iters),
        )

    def _advance(self):
        self._prev = self._cur
        self._prev_ids = self._cur_ids.copy()

    # --- KF hand-off (≙ setThisFrameAsKF / getValues / resetIds) ----------
    def last_frame(self) -> FrameFeatures:
        """The features of the most recent processed frame."""
        return self._prev

    def last_frame_ids(self) -> np.ndarray:
        return self._prev_ids

    def set_frame_ids(self, ids: np.ndarray, kf_id_set: set[int]):
        """Estimator writes back the (possibly freshly minted) match IDs when
        the last frame is promoted to a keyframe."""
        self._prev_ids = ids.copy()
        self._kf_id_set = set(kf_id_set)
        # keep the engine's fresh-id sequence ABOVE every assigned id: the
        # estimator mints keyframe ids from its own counter, and an
        # engine-minted track id that numerically collides with a keyframe
        # id would corrupt the tracked-from-last-KF membership counts
        if len(ids) and (ids >= 0).any():
            self._next_id = max(self._next_id, int(ids.max()) + 1)

    def reset_ids(self):
        self._kf_id_set = set()

    # --- state snapshot (for the estimator's re-process-same-frame retry,
    #     ≙ the `repeat` request flag of TStereoOdometryRequest) -----------
    def get_state(self):
        return (self._prev, None if self._prev_ids is None else self._prev_ids.copy(),
                self._last_pose_inc.copy(), self._next_id)

    def set_state(self, state):
        self._prev, ids, self._last_pose_inc, self._next_id = state
        self._prev_ids = None if ids is None else ids.copy()

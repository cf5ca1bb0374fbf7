"""Full-pipeline multi-sequence evaluation over a device mesh.

``FleetSLAM`` advances S independent SLAM runs in frame lockstep with every
device stage batched across sequences and sharded over the mesh's ``batch``
axis (one/few sequences per device; XLA partitions the programs):

* frontend + tracking + robust pose for ALL sequences is ONE sharded program
  per frame, with per-sequence adaptive FAST/ORB thresholds and the
  reference's low-match retry protocol applied fleet-wide (re-dispatch with
  the same inputs after adjusting the flagged sequences' thresholds —
  ≙ reference src/CSRBAStereoSLAMEstimator.cpp:263-315, per sequence);
* every keyframe check runs the fused BoW-query + DA-cascade program for ALL
  sequences at once (vmapped ``query_and_associate`` over stacked keyframe
  stores and BoW databases), with non-checking sequences' rows simply
  ignored host-side — the padded/masked design makes the batched program
  identical to the single-sequence one;
* per-sequence host bookkeeping (triggers, similar-KF selection, loop
  closure, SRBA insertion with lazy window solves) reuses the
  single-sequence estimator's host methods verbatim, so fleet results match
  per-sequence runs exactly (tests/test_parallel.py asserts KF-count and
  pose equality).

The reference app is strictly single-threaded (SURVEY §2.3); this module is
the scale-out axis across devices: multi-run evaluation, parameter sweeps,
fleet replay.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from srba_slam_tpu.models.estimator import SRBAStereoSLAMEstimator, StepResult
from srba_slam_tpu.models.vo import extract_and_match, track_and_solve
from srba_slam_tpu.parallel.batch import BATCH_AXIS, make_mesh, shard_batch
from srba_slam_tpu.utils import se3_np
from srba_slam_tpu.utils.pull import bulk_pull


class FleetSLAM:
    """Lockstep multi-sequence SLAM with mesh-sharded device stages."""

    def __init__(self, estimators: list[SRBAStereoSLAMEstimator], mesh=None):
        assert estimators, "need at least one estimator"
        self.ests = estimators
        e0 = estimators[0]
        for e in estimators[1:]:
            assert e.capacity == e0.capacity and e.max_kfs == e0.max_kfs, \
                "fleet sequences must share capacities"
            assert e.bow is not None and e0.bow is not None and \
                e.bow._leaf_bits.shape == e0.bow._leaf_bits.shape, \
                "fleet sequences must share the vocabulary shape"
        if mesh is None:
            # largest device count that divides S (NamedSharding needs the
            # batch axis divisible by the mesh axis)
            n_dev = len(jax.devices())
            n = max(d for d in range(1, min(n_dev, len(estimators)) + 1)
                    if len(estimators) % d == 0)
            mesh = make_mesh(n)
        self.mesh = mesh
        self._vo_prog = self._build_vo_prog(e0)
        self._qa_prog = self._build_qa_prog(e0)
        # fleet-stacked tracking state: kept ON DEVICE across lockstep steps
        # (re-stacking per-sequence _prev every frame and re-slicing it back
        # cost ~100 tiny dispatches per step — the dominant host-phase cost
        # in tools/fleet_phase_probe.py before this cache)
        self._prev_stacked = None

    # ------------------------------------------------------------- programs
    def _build_vo_prog(self, e0):
        o = e0.vo.opts
        cam = e0.cam
        k = e0.capacity

        def one(left, right, prev, init_inc, fast_th, orb_th):
            cur = extract_and_match(
                left, right, cam, fast_th, orb_th, k=k,
                cell=o.min_distance, max_y_diff=o.max_y_diff,
                oriented=o.orb_oriented, n_levels=o.n_octaves,
                rect_maps=e0.vo.rect_maps,
            )
            out = track_and_solve(
                prev, cur, cam, init_inc, orb_th,
                kernel_param=o.kernel_param,
                residual_threshold=o.residual_threshold,
                min_mod=o.min_mod_out_vector,
                max_iters_initial=o.initial_max_iters,
                max_iters=o.max_iters,
                min_inliers=o.bad_tracking_th,
            )
            return (cur, out.track_idx, out.track_valid, out.pose.pose,
                    out.pose.valid)

        return jax.jit(jax.vmap(one))

    def _build_qa_prog(self, e0):
        from srba_slam_tpu.models.data_association import query_and_associate

        opts = e0.opts
        cam = e0.cam
        leaf_bits = e0.bow._leaf_bits
        weights = e0.bow._weights

        def one(frame, store_arrays, db, n_kfs, seed):
            key = jax.random.PRNGKey(seed)
            return query_and_associate(
                frame, store_arrays, db, leaf_bits, weights, n_kfs, cam, key,
                max_orb_distance_da=opts.max_orb_distance_da,
                residual_th=opts.residual_th,
                max_y_diff_epipolar=opts.max_y_diff_epipolar,
                filter_by_direction=opts.da_filter_by_direction,
                # the same cascade gates as the estimator's own check
                # (SRBAStereoSLAMEstimator._kf_check_dispatch)
                filter_by_orb_distance=opts.da_filter_by_orb_distance,
                use_fund_matrix=opts.da_filter_by_fund_matrix,
                use_change_pose=opts.da_filter_by_pose_change,
                kernel_param=e0.vo_opts.kernel_param,
                ransac_n_hyp=e0._ransac_n_hyp,
            )

        return jax.jit(jax.vmap(one))

    # ------------------------------------------------------------------ run
    def run(self, sources, max_frames: int | None = None):
        """Drive S frame sources in lockstep until the shortest is
        exhausted (or ``max_frames``)."""
        its = [iter(s) for s in sources]
        n = 0
        try:
            while max_frames is None or n < max_frames:
                frames = []
                for it in its:
                    try:
                        frames.append(next(it))
                    except StopIteration:
                        return
                self.step(frames)
                n += 1
        finally:
            self.sync_states()

    def sync_states(self):
        """Write the fleet-stacked tracking state back into the individual
        estimators (their ``vo._prev`` goes stale during lockstep — the
        stacked copy is the live one) so per-sequence stepping,
        checkpointing, and finalize continue seamlessly after a fleet
        run."""
        if self._prev_stacked is None:
            return
        for i, e in enumerate(self.ests):
            e.vo._prev = jax.tree.map(lambda a, j=i: a[j],
                                      self._prev_stacked)
        self._prev_stacked = None

    def step(self, frames):
        """Advance every sequence by one frame (lockstep)."""
        S = len(self.ests)
        assert len(frames) == S
        # lockstep requires homogeneous estimator state: all bootstrapped or
        # none (a mixed fleet would double-bootstrap some sequences and
        # crash stacking others' empty frame state)
        boot = [e.store.n_kfs == 0 or e.vo._prev is None for e in self.ests]
        assert all(boot) or not any(boot), (
            "fleet estimators must be in the same lifecycle state "
            f"(needs-bootstrap flags: {boot})")
        # first-frame bootstrap goes through each estimator's normal path
        if boot[0]:
            for e, (l, r) in zip(self.ests, frames):
                e.step(l, r)
            self._prev_stacked = None  # (re)stack from per-seq state below
            return

        # native dtype (typically uint8): the frontend casts on the device, and
        # 8-bit uploads quarter the host->device bytes
        lefts = jnp.asarray(np.stack([f[0] for f in frames]))
        rights = jnp.asarray(np.stack([f[1] for f in frames]))
        if self._prev_stacked is None:
            prev = jax.tree.map(lambda *xs: jnp.stack(xs),
                                *[e.vo._prev for e in self.ests])
            prev = shard_batch(self.mesh, (prev,))[0]
        else:
            prev = self._prev_stacked  # already sharded program output
        if self.ests[0].vo.opts.use_previous_pose_as_initial:
            init = jnp.asarray(np.stack(
                [e.vo._last_pose_inc for e in self.ests]), jnp.float32)
        else:
            init = jnp.zeros((S, 6), jnp.float32)
        lefts, rights, init = shard_batch(
            self.mesh, (lefts, rights, init))

        # --- sharded VO with the fleet-wide adaptive-threshold retry loop
        th_min = self.ests[0].opts.adaptive_th_min_matches
        for _attempt in range(6):
            fast_ths = jnp.asarray([e.vo.fast_th for e in self.ests],
                                   jnp.float32)
            orb_ths = jnp.asarray([int(e.vo.orb_th) for e in self.ests],
                                  jnp.int32)
            with self.mesh:
                cur, track_idx, track_valid, poses, pose_valid = \
                    self._vo_prog(lefts, rights, prev, init, fast_ths,
                                  orb_ths)
            m_valid_h, tv_h, ti_h, poses_h, pv_h = bulk_pull(
                (cur.m_valid, track_valid, track_idx, poses, pose_valid))
            n_matches = m_valid_h.sum(axis=1)
            retry = False
            for e, nm in zip(self.ests, n_matches):
                if nm < th_min and e.vo.retry_step():
                    retry = True
            if not retry:
                break
        # healthy-threshold drift (≙ .cpp:271-314 post-retry adjustments)
        for e, nm in zip(self.ests, n_matches):
            if nm >= 8:
                e.vo.drift_thresholds(nm, th_min)

        # --- per-sequence host bookkeeping (mirrors the estimator's
        #     per-frame logic exactly)
        # KNOWN DEBT (reduced): the threshold retry/drift rules are now a
        # single source (StereoVOEngine.retry_step/drift_thresholds), but
        # this block still re-implements the id-chain bookkeeping that also
        # lives in StereoVOEngine.process_stereo_pair and the estimator's
        # backpointer loop; id-semantics changes must be applied in all
        # three places (the parity tests in tests/test_parallel.py and
        # tests/test_batch_mode.py catch drift between them)
        checks = []  # (seq index, force_new_kf, StepResult)
        self._prev_stacked = cur  # the whole fleet's new tracking reference
        for i, e in enumerate(self.ests):
            e.frame_idx += 1
            res = StepResult(e.frame_idx)
            e.step_log.append(res)
            eng = e.vo
            nm = int(n_matches[i])
            if not bool(pv_h[i]) or nm < 8:
                eng._prev_ids = np.full(e.capacity, -1, np.int64)
                continue
            cur_ids = np.full(e.capacity, -1, np.int64)
            tv = tv_h[i]
            cur_ids[tv] = eng._prev_ids[ti_h[i][tv]]
            cur_ids[~m_valid_h[i]] = -1
            fresh = m_valid_h[i] & (cur_ids < 0)
            n_fresh = int(fresh.sum())
            cur_ids[fresh] = np.arange(eng._next_id, eng._next_id + n_fresh)
            eng._next_id += n_fresh
            kf_ids = (np.fromiter(eng._kf_id_set, np.int64)
                      if eng._kf_id_set else np.zeros(0, np.int64))
            tracked_kf = int(np.isin(cur_ids[cur_ids >= 0], kf_ids).sum()) \
                if len(kf_ids) else 0
            res.vo_valid = True
            res.n_stereo_matches = nm
            res.tracked_from_last_kf = tracked_kf
            motion = se3_np.inverse(poses_h[i].astype(np.float64))
            e.current_pose = se3_np.compose(e.current_pose, motion)
            e.incr_from_last_kf = se3_np.compose(e.incr_from_last_kf, motion)
            e.incr_from_last_check = se3_np.compose(
                e.incr_from_last_check, motion)
            eng._prev_ids = cur_ids
            eng._last_pose_inc = poses_h[i].astype(np.float32)

            force_new_kf, check, _t_chk, _r_chk = e._kf_triggers(tracked_kf)
            if check:
                res.kf_check = True
                e.incr_from_last_check = np.zeros(6)
                checks.append((i, force_new_kf, res))

        if not checks:
            return

        # --- ONE sharded BoW-query + DA-cascade program for the whole fleet
        #     (sequences that did not trigger a check are computed anyway and
        #     ignored — uniform shapes keep the program identical across
        #     steps)
        stores = jax.tree.map(lambda *xs: jnp.stack(xs),
                              *[e.store.arrays for e in self.ests])
        dbs = jnp.stack([e.bow._db for e in self.ests])
        n_kfs = jnp.asarray([e.store.n_kfs for e in self.ests], jnp.int32)
        # advance the DA seed ONLY for sequences that actually check this
        # step (their rows are the only consumed results) — otherwise a
        # sequence's RNG stream would depend on its fleet-mates' checks and
        # diverge from the same sequence run solo
        checking = {i for (i, _f, _r) in checks}
        seeds = []
        for i, e in enumerate(self.ests):
            if i in checking:
                seeds.append(e._da_seed)
                e._da_seed += 1
            else:
                seeds.append(e._da_seed)  # computed-but-ignored row
        keys = jnp.asarray(seeds, jnp.uint32)
        # the DA change-in-pose solves seed themselves on device (Horn 3D-3D
        # inside the cascade) — no per-sequence host seeds ride along
        stores, dbs, n_kfs, keys = shard_batch(
            self.mesh, (stores, dbs, n_kfs, keys))
        with self.mesh:
            top_s, top_i, _cand, da = self._qa_prog(
                cur, stores, dbs, n_kfs, keys)
        handles = (top_s, top_i, da.status, da.other_idx, da.tracked_count,
                   cur.m_valid, cur.xs_l, cur.ys_l, cur.xs_r, cur.m_r_idx,
                   cur.pts3d)
        pends = [e.rba.pending_device_arrays() for e in self.ests]
        flat_pend = tuple(a for p in pends for a in p)
        pulled = bulk_pull(handles + flat_pend)
        qa = pulled[: len(handles)]
        off = len(handles)
        for e, p in zip(self.ests, pends):
            if p:
                e.rba.commit_pending(pulled[off:off + len(p)])
                off += len(p)
                e._reanchor_if_dirty()

        for (i, force_new_kf, res) in checks:
            e = self.ests[i]
            frame_i = jax.tree.map(lambda a: a[i], cur)
            pulled_i = tuple(a[i] for a in qa)
            ids = e._kf_check_host(pulled_i, frame_i, res, force_new_kf)
            if ids is not None:
                e.vo.set_frame_ids(ids, set(int(x) for x in ids if x >= 0))

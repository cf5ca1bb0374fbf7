import numpy as np

from srba_slam_tpu.utils.framesource import SyntheticSource

from tests.test_estimator import make_estimator, small_cam


def test_batched_matches_per_frame_pipeline():
    """Batched mode must reproduce per-frame mode exactly: the tail re-run
    of sub-threshold batches (≙ the reference's repeat request,
    .cpp:271-315) makes the two modes process identical detector outputs."""
    cam = small_cam()
    frames = list(SyntheticSource(cam, n_frames=25, seed=11, step=0.12))

    est_a = make_estimator()
    for l, r in frames:
        est_a.step(l, r)

    est_b = make_estimator()
    est_b.perform_stereo_slam_batched(frames, batch=6)

    assert est_a.store.n_kfs == est_b.store.n_kfs, (
        est_a.store.n_kfs, est_b.store.n_kfs)
    # identical insertion frames
    ka = [r.inserted_kf for r in est_a.step_log]
    kb = [r.inserted_kf for r in est_b.step_log]
    assert ka == kb
    est_a.rba.flush()
    est_b.rba.flush()
    n = est_a.store.n_kfs
    np.testing.assert_allclose(
        est_a.rba.kf_global[:n], est_b.rba.kf_global[:n], atol=1e-6)
    # frame accounting identical
    assert est_b.frame_idx == len(frames) - 1
    assert len(est_b.step_log) == len(frames)


def test_batched_retry_protocol_matches_per_frame():
    """Stress the adaptive FAST/ORB retry: dark low-texture frames force
    threshold drops mid-batch; the batched tail re-run must land on the same
    keyframes and final thresholds as the per-frame retry loop."""
    cam = small_cam()
    frames = list(SyntheticSource(cam, n_frames=25, seed=11, step=0.12))
    dark = [(l * 0.12, r * 0.12) for l, r in frames]

    est_a = make_estimator()
    for l, r in dark:
        est_a.step(l, r)
    est_b = make_estimator()
    est_b.perform_stereo_slam_batched(dark, batch=6)

    assert est_a.store.n_kfs == est_b.store.n_kfs
    assert est_a.vo.fast_th == est_b.vo.fast_th
    assert est_a.vo.orb_th == est_b.vo.orb_th
    ka = [r.inserted_kf for r in est_a.step_log]
    kb = [r.inserted_kf for r in est_b.step_log]
    assert ka == kb


def test_batched_handles_ragged_tail():
    cam = small_cam()
    frames = list(SyntheticSource(cam, n_frames=10, seed=11, step=0.12))
    est = make_estimator()
    est.perform_stereo_slam_batched(frames, batch=4)  # 1 + 4 + 4 + 1
    assert len(est.step_log) == 10
    assert est.store.n_kfs >= 1


def test_speculation_miss_replays_exactly():
    """Force keyframe checks that DECLINE to insert (distance-triggered
    checks while tracking stays strong): the deferred speculative path must
    detect the mispredictions, replay the batch tails, and still match
    per-frame mode exactly."""
    cam = small_cam()
    frames = list(SyntheticSource(cam, n_frames=25, seed=11, step=0.12))

    # tiny translation threshold triggers a check every ~2 frames; a very
    # low updated_matches_th means almost none of them insert -> misses
    from srba_slam_tpu.config import (
        GeneralOptions, SRBAStereoSLAMOptions, VOOptions,
    )
    from srba_slam_tpu.models.estimator import SRBAStereoSLAMEstimator

    def make():
        opts = SRBAStereoSLAMOptions(
            orb_adaptive_fast_th=True,
            camera=cam, n_feats=256, detect_fast_th=12,
            adaptive_th_min_matches=40, max_translation=0.18,
            max_rotation=10.0, updated_matches_th=12, vo_id_tracking_th=8,
            srba_submap_size=5, srba_max_optimize_depth=3,
            da_filter_by_direction=False, residual_th=10.0,
        )
        est = SRBAStereoSLAMEstimator(
            GeneralOptions(), opts, VOOptions(fast_th=12, n_feats=256),
            capacity=256, max_kfs=64,
        )
        est.initialize()
        return est

    est_a = make()
    for l, r in frames:
        est_a.step(l, r)
    est_b = make()
    est_b.perform_stereo_slam_batched(frames, batch=6)

    checks = [r.frame_idx for r in est_a.step_log if r.kf_check]
    inserts = [r.inserted_kf for r in est_a.step_log
               if r.inserted_kf is not None]
    assert len(checks) > len(inserts), (
        "scenario must contain declined checks (speculation misses): "
        f"{len(checks)} checks, {len(inserts)} inserts")

    assert est_a.store.n_kfs == est_b.store.n_kfs
    ka = [(r.frame_idx, r.kf_check, r.inserted_kf, r.best_tracked)
          for r in est_a.step_log]
    kb = [(r.frame_idx, r.kf_check, r.inserted_kf, r.best_tracked)
          for r in est_b.step_log]
    assert ka == kb
    assert est_a.updated_translation_th == est_b.updated_translation_th
    assert est_a.updated_rotation_th == est_b.updated_rotation_th
    est_a.rba.flush()
    est_b.rba.flush()
    n = est_a.store.n_kfs
    # decisions are bit-identical; poses agree to solver-scheduling
    # tolerance: queued window solves land at different points relative to
    # the next dispatch in the two modes, so each window's spanning-tree
    # INIT differs by a committed-vs-pending refinement — and the BA's
    # init-anchor prior (ops/window_ba.py) deliberately keeps each solution
    # near its own init. Decimeter-level here (dense misses + replays);
    # the trajectory-quality gates (ATE tests) hold in both modes.
    np.testing.assert_allclose(
        est_a.rba.kf_global[:n], est_b.rba.kf_global[:n], atol=0.15)


def test_solve_sync_strict_pose_equivalence():
    """With solve_sync (every window solve lands immediately after its
    insertion) per-frame and batched modes commit solves at IDENTICAL
    points, so poses — not just decisions — must match to solver precision.
    This is the strict-equivalence companion of
    test_speculation_miss_replays_exactly's scheduling-tolerant gate."""
    cam = small_cam()
    frames = list(SyntheticSource(cam, n_frames=25, seed=11, step=0.12))

    est_a = make_estimator()
    est_a.solve_sync = True
    for l, r in frames:
        est_a.step(l, r)

    est_b = make_estimator()
    est_b.solve_sync = True
    est_b.perform_stereo_slam_batched(frames, batch=6)

    assert est_a.store.n_kfs == est_b.store.n_kfs
    ka = [r.inserted_kf for r in est_a.step_log]
    kb = [r.inserted_kf for r in est_b.step_log]
    assert ka == kb
    est_a.rba.flush()
    est_b.rba.flush()
    n = est_a.store.n_kfs
    np.testing.assert_allclose(
        est_a.rba.kf_global[:n], est_b.rba.kf_global[:n], atol=1e-3)


def test_flush_before_insert_between_pipelined_and_strict():
    """The intermediate solve scheduling (solve_flush_before_insert: queued
    window solves land right before the NEXT insertion) must keep decisions
    identical to per-frame stepping and land poses CLOSER to the strict
    schedule than the pipelined default does — each insertion seeds from
    its predecessor's optimized state (tools/solve_sync_probe.py measures
    the modes' cost)."""
    cam = small_cam()
    frames = list(SyntheticSource(cam, n_frames=25, seed=11, step=0.12))

    est_ref = make_estimator()          # strict = per-frame-equivalent gold
    est_ref.solve_sync = True
    est_ref.perform_stereo_slam_batched(frames, batch=6)

    est_mid = make_estimator()
    est_mid.solve_flush_before_insert = True
    est_mid.perform_stereo_slam_batched(frames, batch=6)

    est_pipe = make_estimator()
    est_pipe.perform_stereo_slam_batched(frames, batch=6)

    for e in (est_ref, est_mid, est_pipe):
        e.rba.flush()
    assert [r.inserted_kf for r in est_mid.step_log] == \
        [r.inserted_kf for r in est_ref.step_log]
    n = est_ref.store.n_kfs
    assert est_mid.store.n_kfs == n

    def dmax(e):
        return float(np.max(np.linalg.norm(
            e.rba.kf_global[:n, 3:] - est_ref.rba.kf_global[:n, 3:],
            axis=1)))
    d_mid, d_pipe = dmax(est_mid), dmax(est_pipe)
    # the intermediate mode must not be WORSE than pipelined, and must hold
    # a tighter absolute gate than pipelined's 0.15 m scheduling tolerance
    assert d_mid <= max(d_pipe, 1e-6) + 1e-9, (d_mid, d_pipe)
    assert d_mid < 0.05, d_mid


def test_batched_single_transfer_per_batch(monkeypatch):
    """The batched loop's latency contract: ONE
    blocking device->host transfer per processed batch (scan outputs +
    queued window solves + deferred checks all ride the same bulk_pull),
    plus at most the final resolve/flush pair. Speculation-miss replays
    legitimately add synchronous per-check pulls, so this workload/seed is
    chosen to replay-free (asserted via the exactness invariants)."""
    import srba_slam_tpu.models.estimator as E
    import srba_slam_tpu.models.srba as S

    cam = small_cam()
    frames = list(SyntheticSource(cam, n_frames=25, seed=11, step=0.12))

    calls = []
    orig = E.bulk_pull

    def counting(handles):
        handles = tuple(handles)
        calls.append(len(handles))
        return orig(handles)

    monkeypatch.setattr(E, "bulk_pull", counting)
    monkeypatch.setattr(S, "bulk_pull", counting)

    est = make_estimator()
    est.perform_stereo_slam_batched(frames, batch=6)
    n_batches = -(-24 // 6)  # first frame bootstraps outside the scan
    loop_calls = len(calls)
    est.rba.flush()
    est._finish_batched()
    total = len(calls)
    # one transfer per batch while looping (misses would add per-check
    # pulls through _kf_check; this seed has none)
    assert loop_calls <= n_batches + 1, calls
    # epilogue: at most one resolve + one flush transfer
    assert total <= loop_calls + 2, calls


def test_kf_capacity_guard_with_planned_checks():
    """At the keyframe-capacity boundary the batched walk resolves mid-batch
    — planned-but-undispatched fused checks must flush before that pull, and
    batched mode must stop at exactly max_num_kfs like per-frame mode."""
    from srba_slam_tpu.config import (
        GeneralOptions, SRBAStereoSLAMOptions, VOOptions,
    )
    from srba_slam_tpu.models.estimator import SRBAStereoSLAMEstimator

    cam = small_cam()
    frames = list(SyntheticSource(cam, n_frames=25, seed=11, step=0.12))

    def make():
        opts = SRBAStereoSLAMOptions(
            orb_adaptive_fast_th=True,
            camera=cam, n_feats=256, detect_fast_th=12,
            adaptive_th_min_matches=40, max_translation=0.18,
            max_rotation=10.0, updated_matches_th=40, vo_id_tracking_th=30,
            srba_submap_size=5, srba_max_optimize_depth=3,
            da_filter_by_direction=False, residual_th=10.0,
        )
        est = SRBAStereoSLAMEstimator(
            GeneralOptions(max_num_kfs=4), opts,
            VOOptions(fast_th=12, n_feats=256),
            capacity=256, max_kfs=64,
        )
        est.initialize()
        return est

    est_a = make()
    for l, r in frames:
        est_a.step(l, r)
        if est_a.store.n_kfs >= 4:
            break
    est_b = make()
    est_b.perform_stereo_slam_batched(frames, batch=5)

    assert est_b.store.n_kfs == est_a.store.n_kfs == 4
    # the stop is per-frame exact: batched mode ends its log at the same
    # frame per-frame mode stopped on (no intra-batch overshoot)
    ka = [(r.frame_idx, r.kf_check, r.inserted_kf) for r in est_a.step_log]
    kb = [(r.frame_idx, r.kf_check, r.inserted_kf) for r in est_b.step_log]
    assert ka == kb


def test_forced_mispredictions_replay_exactly(monkeypatch):
    """Adversarial speculation: force EVERY deferred check to predict
    INSERT (claim the appearance regime is dead). Checks that resolve to
    no-insert then MISS, driving _miss_recover's full recovery path —
    including the virtual-chain reconstruction (host backpointers rebuilt
    from the device slot maps at the snap point) — on every batch. Results
    must still match per-frame mode exactly."""
    import srba_slam_tpu.models.estimator as E

    cam = small_cam()
    frames = list(SyntheticSource(cam, n_frames=25, seed=11, step=0.12))

    est_a = make_estimator()
    for l, r in frames:
        est_a.step(l, r)

    orig = E.SRBAStereoSLAMEstimator._defer_check
    recoveries = []
    orig_rec = E.SRBAStereoSLAMEstimator._miss_recover

    def bad_predict(self, res, force, batch_rec, j):
        self._da_dead = True  # poison the predictor only (decisions and
        # resolution never read it before the next check resolves)
        return orig(self, res, force, batch_rec, j)

    def counting_recover(self, c, d):
        recoveries.append(c["snap"]["frame_idx"])
        return orig_rec(self, c, d)

    monkeypatch.setattr(E.SRBAStereoSLAMEstimator, "_defer_check",
                        bad_predict)
    monkeypatch.setattr(E.SRBAStereoSLAMEstimator, "_miss_recover",
                        counting_recover)
    est_b = make_estimator()
    est_b.perform_stereo_slam_batched(frames, batch=6)

    assert recoveries, "the poisoned predictor must cause actual misses"
    assert est_a.store.n_kfs == est_b.store.n_kfs
    ka = [(r.frame_idx, r.kf_check, r.inserted_kf, r.n_stereo_matches,
           r.tracked_from_last_kf) for r in est_a.step_log]
    kb = [(r.frame_idx, r.kf_check, r.inserted_kf, r.n_stereo_matches,
           r.tracked_from_last_kf) for r in est_b.step_log]
    assert ka == kb
    est_a.rba.flush()
    est_b.rba.flush()
    n = est_a.store.n_kfs
    np.testing.assert_allclose(
        est_a.rba.kf_global[:n], est_b.rba.kf_global[:n], atol=1e-3)
    # engine ids materialize identically for keyframe-chained tracks
    # (fresh ids for unchained tracks are minted lazily in batched mode, so
    # their numeric values legitimately differ)
    est_b._finish_batched()
    ids_a = np.asarray(est_a.vo._prev_ids)
    ids_b = np.asarray(est_b.vo._prev_ids)
    last_ids = est_b.store.match_ids[est_b.store.n_kfs - 1]
    kf_id_set = set(int(v) for v in last_ids[last_ids >= 0])
    sel_a = np.asarray([int(v) in kf_id_set for v in ids_a])
    sel_b = np.asarray([int(v) in kf_id_set for v in ids_b])
    np.testing.assert_array_equal(sel_a, sel_b)
    assert sel_a.any(), "some tracks must chain to the last keyframe"
    np.testing.assert_array_equal(ids_a[sel_a], ids_b[sel_a])

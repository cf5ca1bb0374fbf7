"""Measure the solve-scheduling Pareto: pipelined vs flush-before-insert
vs strict.

Three schedulings of the SRBA window solves in the batched/device-resident
loop:

* ``pipelined`` (default): solves queue and land at the next batch
  boundary's single bulk pull — maximum overlap, but a later insertion can
  seed from a not-yet-optimized predecessor (decimeter-level pose drift vs
  per-frame stepping; tests/test_batch_mode.py gates 0.15 m at test scale).
* ``flush_before_insert``: queued solves land right before the NEXT
  insertion dispatches its own — every insertion seeds from optimized
  state, while solves still overlap all frames in between (one blocking
  pull per insertion, only when solves are pending).
* ``strict`` (solve_sync): flush immediately after every insertion —
  1e-5-level pose agreement with per-frame stepping, maximum sync cost.

The probe runs the device-resident loop in all three modes and reports fps
+ keyframe-pose disagreement vs STRICT (which stands in for per-frame
stepping at 1e-5), so the batched-mode default is chosen on measured
numbers (BASELINE.md records the curve).

Run standalone: `python tools/solve_sync_probe.py`.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

import bench  # noqa: E402

MODES = ("pipelined", "flush_before_insert", "strict")


def run_devres(est, chunks):
    import jax

    disp = est._dispatch_scan(*chunks[0])
    i = 0
    while disp is not None:
        nf = None
        if i + 1 < len(chunks):
            nf = (lambda cd, c=chunks[i + 1]:
                  est._dispatch_scan(*c, chain=cd))
        disp = est._process_scan(disp, nf)
        i += 1
    est._finish_batched()
    est.rba.flush()
    jax.device_get(np.asarray(est.vo._last_pose_inc))


def one_pass(cam, frames, chunks_of, mode):
    import jax

    est = bench._build_estimator(cam)
    est.solve_sync = mode == "strict"
    est.solve_flush_before_insert = mode == "flush_before_insert"
    est.perform_stereo_slam_batched(frames[: bench.WARMUP_FRAMES],
                                    batch=bench.BATCH)
    est.rba.flush()
    chunks = chunks_of(est)
    jax.block_until_ready(est.vo.last_frame().desc_l)
    t0 = time.perf_counter()
    run_devres(est, chunks)
    dt = time.perf_counter() - t0
    return est, bench.TIMED_FRAMES / dt


def main():
    import jax
    import jax.numpy as jnp

    from srba_slam_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    cam, frames = bench._build_workload()
    frames = frames[: bench.WARMUP_FRAMES + bench.TIMED_FRAMES]

    def chunks_of(est):
        chunks = []
        for c0 in range(bench.WARMUP_FRAMES, len(frames), bench.DEV_BATCH):
            chunk = frames[c0:c0 + bench.DEV_BATCH]
            chunks.append((jnp.asarray(np.stack([f[0] for f in chunk])),
                           jnp.asarray(np.stack([f[1] for f in chunk]))))
        jax.block_until_ready(chunks)
        return chunks

    # warm every mode's programs, then time (best of 2 each, interleaved to
    # decorrelate pool contention)
    for m in MODES:
        one_pass(cam, frames, chunks_of, m)
    best = {m: (None, 0.0) for m in MODES}
    for _ in range(2):
        for m in MODES:
            e, f = one_pass(cam, frames, chunks_of, m)
            if f > best[m][1]:
                best[m] = (e, f)

    est_ref = best["strict"][0]
    ka = [r.inserted_kf for r in est_ref.step_log]
    out = {"backend": jax.devices()[0].platform,
           "n_kfs": {m: best[m][0].store.n_kfs for m in MODES}}
    for m in MODES:
        e, f = best[m]
        n = min(e.store.n_kfs, est_ref.store.n_kfs)
        dpose = float(np.max(np.linalg.norm(
            e.rba.kf_global[:n, 3:] - est_ref.rba.kf_global[:n, 3:],
            axis=1))) if n else 0.0
        out[m] = {
            "fps": round(f, 2),
            "max_kf_pos_disagreement_vs_strict_m": round(dpose, 4),
            "decisions_identical_to_strict":
                [r.inserted_kf for r in e.step_log] == ka,
        }
    fp = out["pipelined"]["fps"]
    out["flush_cost_pct"] = round(
        100.0 * (1.0 - out["flush_before_insert"]["fps"] / fp), 1)
    out["strict_cost_pct"] = round(
        100.0 * (1.0 - out["strict"]["fps"] / fp), 1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()

"""Phase breakdown of the DEVICE-RESIDENT loop .

bench.py's device_resident_fps is the framework-attributable headline
(frames pre-staged on device — what DMA'd camera input would see). This
probe runs that exact loop at DEV_BATCH and attributes the wall clock:

  * pull      — blocking bulk_pulls (each waits RTT + device-queue drain)
  * dispatch  — _dispatch_scan enqueues (async RPCs)
  * chk_disp  — _dispatch_planned_checks enqueues (fused check programs)
  * host      — per-frame keyframe logic (_process_frames)
  * resolve   — _resolve_spec host work (decisions, insert bookkeeping)
  * flush     — rba.flush (waits for queued window solves + pull)

plus ISOLATED device-time measurements (dispatch → device_get of one
small leaf) for the big programs: the B-frame vo_scan, one full
fused_checks_batch (CHECK_SLOTS slots), and one window solve — so the
"pull" waits can be split into RTT vs genuine device-queue drain.

Run standalone: `python tools/devres_phase_probe.py` (uses the live
backend; CPU numbers are still phase-proportional).
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

import bench  # noqa: E402

PHASES = {"pull": 0.0, "dispatch": 0.0, "chk_disp": 0.0, "host": 0.0,
          "resolve": 0.0, "flush": 0.0}
COUNTS = {"pull": 0, "dispatch": 0, "chk_disp": 0}


def _wrap(obj, name, phase, count=False, nested=None):
    orig = getattr(obj, name)
    depth = {"d": 0}

    def timed(*a, **kw):
        if depth["d"]:  # nested (retry tail): outer call owns the time
            return orig(*a, **kw)
        depth["d"] += 1
        t0 = time.perf_counter()
        try:
            return orig(*a, **kw)
        finally:
            depth["d"] -= 1
            PHASES[phase] += time.perf_counter() - t0
            if count:
                COUNTS[phase] += 1

    setattr(obj, name, timed)
    return orig


def main():
    import jax

    from srba_slam_tpu.models import estimator as est_mod
    from srba_slam_tpu.models.srba import SRBAEngine
    from srba_slam_tpu.utils import pull as pull_mod

    from srba_slam_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    cam, frames = bench._build_workload()
    frames = frames[: bench.WARMUP_FRAMES + bench.TIMED_FRAMES]

    # throwaway FULL device-resident pass to absorb every compile
    import jax.numpy as jnp

    def stage_chunks(est):
        chunks = []
        for c0 in range(bench.WARMUP_FRAMES, len(frames), bench.DEV_BATCH):
            chunk = frames[c0:c0 + bench.DEV_BATCH]
            chunks.append((jnp.asarray(np.stack([f[0] for f in chunk])),
                           jnp.asarray(np.stack([f[1] for f in chunk]))))
        jax.block_until_ready(chunks)
        return chunks

    def run_devres(est, chunks):
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

    est = bench._build_estimator(cam)
    est.perform_stereo_slam_batched(frames[: bench.WARMUP_FRAMES],
                                    batch=bench.BATCH)
    est.rba.flush()
    run_devres(est, stage_chunks(est))

    # fresh estimator, warm caches; instrument AFTER warmup
    est = bench._build_estimator(cam)
    est.perform_stereo_slam_batched(frames[: bench.WARMUP_FRAMES],
                                    batch=bench.BATCH)
    est.rba.flush()
    chunks = stage_chunks(est)
    jax.block_until_ready(est.vo.last_frame().desc_l)

    origs = []
    origs.append(("bulk", _wrap(pull_mod, "bulk_pull", "pull", count=True)))
    est_mod.bulk_pull = pull_mod.bulk_pull
    o_ds = _wrap(est_mod.SRBAStereoSLAMEstimator, "_dispatch_scan",
                 "dispatch", count=True)
    o_pc = _wrap(est_mod.SRBAStereoSLAMEstimator, "_dispatch_planned_checks",
                 "chk_disp", count=True)
    o_pf = _wrap(est_mod.SRBAStereoSLAMEstimator, "_process_frames", "host")
    o_rs = _wrap(est_mod.SRBAStereoSLAMEstimator, "_resolve_spec", "resolve")
    o_fl = _wrap(SRBAEngine, "flush", "flush")

    t0 = time.perf_counter()
    run_devres(est, chunks)
    total = time.perf_counter() - t0

    est_mod.SRBAStereoSLAMEstimator._dispatch_scan = o_ds
    est_mod.SRBAStereoSLAMEstimator._dispatch_planned_checks = o_pc
    est_mod.SRBAStereoSLAMEstimator._process_frames = o_pf
    est_mod.SRBAStereoSLAMEstimator._resolve_spec = o_rs
    SRBAEngine.flush = o_fl
    pull_mod.bulk_pull = origs[0][1]
    est_mod.bulk_pull = origs[0][1]

    # nested-phase cleanup: _process_frames contains chk_disp/pull time when
    # checks resolve synchronously; report raw sums (overlaps noted)
    n_checks = sum(1 for r in est.step_log if r.kf_check)
    n_kfs = est.store.n_kfs

    # isolated device times (dispatch -> device_get of one small leaf)
    iso = {}
    d = est._dispatch_scan(*chunks[0])
    t0 = time.perf_counter()
    jax.device_get(d["last_inc"])
    iso["scan_60f_ms"] = round((time.perf_counter() - t0) * 1e3, 1)

    from srba_slam_tpu.models.data_association import (
        CHECK_SLOTS, fused_checks_batch,
    )

    feats = d["outs"][0]
    m = est.opts.da_stage2_method
    blobs, na, ndb = fused_checks_batch(
        feats, est.store.arrays, est.bow._db, est.bow._leaf_bits,
        est.bow._weights,
        tuple(range(CHECK_SLOTS)), tuple(
            est.store.n_kfs + i for i in range(CHECK_SLOTS)),
        (True,) * CHECK_SLOTS, est.cam, tuple(range(CHECK_SLOTS)),
        max_orb_distance_da=est.opts.max_orb_distance_da,
        residual_th=est.opts.residual_th,
        max_y_diff_epipolar=est.opts.max_y_diff_epipolar,
        filter_by_direction=est.opts.da_filter_by_direction,
        use_fund_matrix=m in (1, 3), use_change_pose=m in (2, 3),
        kernel_param=est.vo_opts.kernel_param,
        ransac_n_hyp=est._ransac_n_hyp, debug=est.debug.enabled)
    t0 = time.perf_counter()
    jax.device_get(np.asarray(blobs[0][:1]))
    iso["checks_8slot_ms"] = round((time.perf_counter() - t0) * 1e3, 1)
    est.store.arrays, est.bow._db = na, ndb  # donated; keep handles valid

    print(json.dumps({
        "fps": round(bench.TIMED_FRAMES / total, 2),
        "total_s": round(total, 3),
        **{k: round(v, 3) for k, v in PHASES.items()},
        "counts": COUNTS,
        "other_s": round(total - PHASES["pull"] - PHASES["dispatch"]
                         - PHASES["host"] - PHASES["flush"], 3),
        "n_kfs": n_kfs, "n_checks": n_checks,
        "isolated": iso,
        "backend": jax.devices()[0].platform,
        "note": "host includes nested chk_disp/resolve; pull waits include "
                "device-queue drain (compare with isolated.*)",
    }))


if __name__ == "__main__":
    main()

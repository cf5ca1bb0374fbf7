"""DA change-in-pose GN iteration-cap sweep: decision equivalence + cost.

The filter-4 solve is Horn-seeded (models/data_association._horn_seed), so
its GN budget is a pure cost knob PROVIDED the inlier classification — and
hence every keyframe/LC decision — is unchanged. Round 4 cut 30/30 -> 12/12
with verified identical decisions; this probe sweeps further caps and
reports, per cap: the street workload's keyframe decisions (insert frames +
tracked counts + LC flags) and the fused-check device time, against the
12/12 baseline.

Each cap runs in a SUBPROCESS: the caps are trace-time constants
(DA_SOLVE_ITERS_STAGE1/2), so a fresh process guarantees a clean jit cache.

Run: `timeout 1800 python tools/da_iters_probe.py [--caps 12 10 8 6]`
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run_one(cap: int) -> dict:
    """Child: run the street workload batched with the given cap; print the
    decision trace + timing as one JSON line."""
    import numpy as np

    import jax

    from srba_slam_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from srba_slam_tpu.models import data_association as da_mod

    da_mod.DA_SOLVE_ITERS_STAGE1 = cap
    da_mod.DA_SOLVE_ITERS_STAGE2 = cap

    import bench as B

    cam, frames = B._build_workload()
    est = B._build_estimator(cam)
    t0 = time.perf_counter()
    est.perform_stereo_slam_batched(frames, batch=B.BATCH)
    est.rba.flush()
    wall = time.perf_counter() - t0

    # decision trace: (frame, inserted-as, best_tracked, lc) per KF check
    trace = []
    for r in est.step_log:
        if r.kf_check:
            trace.append([int(r.frame_idx),
                          -1 if r.inserted_kf is None else int(r.inserted_kf),
                          int(r.best_tracked),
                          -1 if r.loop_closure_with is None
                          else int(r.loop_closure_with)])
    kf_frames = [int(r.frame_idx) for r in est.step_log
                 if r.inserted_kf is not None]
    print(json.dumps({
        "cap": cap, "wall_s": round(wall, 3), "n_kfs": est.store.n_kfs,
        "trace": trace, "kf_frames": kf_frames,
        "backend": jax.devices()[0].platform,
    }))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--caps", type=int, nargs="+", default=[12, 10, 8, 6])
    ap.add_argument("--child", type=int, default=None)
    args = ap.parse_args()
    if args.child is not None:
        run_one(args.child)
        return

    results = {}
    for cap in args.caps:
        r = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", str(cap)],
            capture_output=True, text=True, timeout=1500,
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        if r.returncode != 0:
            print(f"cap {cap} FAILED:\n{r.stderr[-2000:]}", file=sys.stderr)
            continue
        results[cap] = json.loads(r.stdout.strip().splitlines()[-1])

    base = results.get(args.caps[0])
    out = {"base_cap": args.caps[0]}
    for cap, r in results.items():
        same = (base is not None and r["trace"] == base["trace"]
                and r["kf_frames"] == base["kf_frames"])
        out[str(cap)] = {"wall_s": r["wall_s"], "n_kfs": r["n_kfs"],
                         "decisions_equal_base": bool(same),
                         "backend": r["backend"]}
    print(json.dumps(out))


if __name__ == "__main__":
    main()

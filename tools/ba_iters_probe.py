"""Window-BA LM iteration-cap sweep: pose agreement + cost on the street
workload.

The window solve early-exits on quadratic-model convergence (stall /
predicted-decrease rules in ops/window_ba), so its ``opt_iters`` /
``stage1_iters`` caps only bind on hard windows. This probe runs the full
batched street workload at several (stage1, full) caps and reports wall
time, keyframe decisions, and the max keyframe-position delta vs the
default caps — to tell whether the caps are real device time or already
slack.

Each cap pair runs in a SUBPROCESS (the caps are jit-static).

Run: `timeout 2400 python tools/ba_iters_probe.py [--caps 4,20 2,12 2,8]`
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run_one(s1: int, full: int) -> None:
    import numpy as np

    import jax

    from srba_slam_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    import bench as B

    cam, frames = B._build_workload()
    est = B._build_estimator(cam)
    est.rba.p.stage1_iters = s1
    est.rba.p.opt_iters = full
    t0 = time.perf_counter()
    est.perform_stereo_slam_batched(frames, batch=B.BATCH)
    est.rba.flush()
    wall = time.perf_counter() - t0

    trace = [[int(r.frame_idx),
              -1 if r.inserted_kf is None else int(r.inserted_kf),
              int(r.best_tracked)]
             for r in est.step_log if r.kf_check]
    # engine-global keyframe positions (post window solves)
    kfg = est.rba.kf_global
    pos = np.asarray([kfg[i][3:] for i in range(est.store.n_kfs)], np.float64)
    print(json.dumps({
        "s1": s1, "full": full, "wall_s": round(wall, 3),
        "n_kfs": est.store.n_kfs, "trace": trace,
        "pos": pos.tolist(),
        "backend": jax.devices()[0].platform,
    }))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--caps", nargs="+", default=["4,20", "2,12", "2,8"])
    ap.add_argument("--child", default=None)
    args = ap.parse_args()
    if args.child is not None:
        s1, full = (int(x) for x in args.child.split(","))
        run_one(s1, full)
        return

    import numpy as np

    results = {}
    for cap in args.caps:
        r = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", cap],
            capture_output=True, text=True, timeout=1800,
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        if r.returncode != 0:
            print(f"caps {cap} FAILED:\n{r.stderr[-2000:]}", file=sys.stderr)
            continue
        results[cap] = json.loads(r.stdout.strip().splitlines()[-1])

    base = results.get(args.caps[0])
    out = {"base": args.caps[0]}
    for cap, r in results.items():
        same = base is not None and r["trace"] == base["trace"]
        dpos = None
        if base is not None and r["n_kfs"] == base["n_kfs"]:
            dpos = float(np.abs(np.asarray(r["pos"])
                                - np.asarray(base["pos"])).max())
        out[cap] = {"wall_s": r["wall_s"], "n_kfs": r["n_kfs"],
                    "decisions_equal_base": bool(same),
                    "max_pos_delta_m": None if dpos is None
                    else round(dpos, 4),
                    "backend": r["backend"]}
    print(json.dumps(out))


if __name__ == "__main__":
    main()

"""Attribute the vo_scan device cost: detect/describe/match vs LS solves.

vo_scan is the single biggest device program in the device-resident loop
(tools/microbench.py times it). Its per-frame work splits into the dense
frontend (FAST + NMS + ORB + stereo match, image-sized tensor ops) and the
sequential two-stage robust GN solves (tiny-op while_loops under the
frame-axis lax.scan). This probe times the same B-frame scan compiled with
``max_iters_initial = max_iters = 1`` — the iteration-count delta is the
LS solve share.

Run: `timeout 1800 python tools/scan_phase_probe.py [--cpu] [--n 8]`
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--n", type=int, default=8)
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from srba_slam_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax.numpy as jnp

    import bench as B

    cam, frames = B._build_workload()
    est = B._build_estimator(cam)
    est.perform_stereo_slam_batched(frames[: B.WARMUP_FRAMES], batch=B.BATCH)
    est.rba.flush()

    lefts = jnp.asarray(np.stack([f[0] for f in frames[1:1 + B.BATCH]]))
    rights = jnp.asarray(np.stack([f[1] for f in frames[1:1 + B.BATCH]]))
    jax.device_get(np.asarray(lefts[:1, :1, :1]))

    def pull(d):
        jax.device_get(jax.tree.leaves(d["pk"])[0].ravel()[0])

    out = {"backend": jax.devices()[0].platform, "B": B.BATCH, "n": args.n}
    o = est.vo.opts
    for name, it0, it1 in (("default", o.initial_max_iters, o.max_iters),
                           ("iters1", 1, 1)):
        o.initial_max_iters, o.max_iters = it0, it1
        d = est._dispatch_scan(lefts, rights)
        pull(d)                       # compile + warm
        t0 = time.perf_counter()
        for _ in range(args.n):
            d = est._dispatch_scan(lefts, rights)
        pull(d)
        out[f"{name}_ms"] = round(
            (time.perf_counter() - t0) / args.n * 1e3, 2)
    out["ls_share_ms"] = round(out["default_ms"] - out["iters1_ms"], 2)
    out["per_frame_default_ms"] = round(out["default_ms"] / B.BATCH, 3)
    print(json.dumps(out))


if __name__ == "__main__":
    main()

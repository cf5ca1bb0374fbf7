"""Decompose the fused keyframe-check program's device cost.

The deferred-check program (models/data_association.fused_check_write =
slice + speculative store/BoW write + BoW query + DA cascade) is ~7-11 ms
of device compute per check; at the street workload's ~29 checks per 60
frames it rivals the 60-frame vo_scan itself. This probe times the program
with the cascade's expensive stages toggled off (static flags compile
separate programs) to attribute the cost:

  * full        — direction + ORB/uniqueness + fundamental RANSAC + pose
  * no_pose     — use_change_pose=False (drops the vmapped 2x30-iteration
                  GN while_loop, filter 4)
  * no_fund     — use_fund_matrix=False (drops the 128-hypothesis RANSAC,
                  filter 3)
  * neither     — both off (query + filters 1-2 + writes only)

Times use the N-dispatch / one-pull chain method (tools/microbench.py).
Run: `timeout 1800 python tools/check_phase_probe.py [--cpu] [--n 20]`
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
    ap.add_argument("--n", type=int, default=20)
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from srba_slam_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax.numpy as jnp

    import bench as B
    from srba_slam_tpu.models.data_association import fused_check_write

    cam, frames = B._build_workload()
    est = B._build_estimator(cam)
    est.perform_stereo_slam_batched(frames[: B.WARMUP_FRAMES], batch=B.BATCH)
    est.rba.flush()

    feat = est.vo.last_frame()
    fb = jax.tree.map(lambda a: a[None], feat)

    def pull(x):
        leaf = jax.tree.leaves(x)[0]
        jax.device_get(leaf.ravel()[0])

    out = {"backend": jax.devices()[0].platform, "n": args.n}
    variants = [
        ("full", dict()),
        ("no_pose", dict(use_change_pose=False)),
        ("no_fund", dict(use_fund_matrix=False)),
        ("neither", dict(use_change_pose=False, use_fund_matrix=False)),
    ]
    # one long-lived state per variant chain; store/db are DONATED
    for name, kw in variants:
        state = (est.store.arrays, est.bow._db)

        def chk(state, kw=kw):
            arrays, db = state
            h, a, d = fused_check_write(
                fb, arrays, db, est.bow._leaf_bits, est.bow._weights,
                jnp.int32(0), jnp.int32(est.store.n_kfs), est.cam, 0, **kw)
            return (a, d), h

        state, h = chk(state)
        pull(h)                      # compile + warm
        t0 = time.perf_counter()
        for _ in range(args.n):
            state, h = chk(state)
        pull(h)
        out[f"{name}_ms"] = round((time.perf_counter() - t0) / args.n * 1e3, 2)
        est.store.arrays, est.bow._db = state  # keep handles valid

    out["pose_ms"] = round(out["full_ms"] - out["no_pose_ms"], 2)
    out["fund_ms"] = round(out["full_ms"] - out["no_fund_ms"], 2)
    print(json.dumps(out))


if __name__ == "__main__":
    main()

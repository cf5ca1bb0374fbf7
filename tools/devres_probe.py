"""Device-resident throughput vs batch size.

If the device-resident loop is bound by its blocking pulls (one per
batch), fewer, larger batches should raise fps — this probe measures batch 20 (bench control) vs 30 vs
60 on the same 60 timed frames, warm, in one process. It also warms the
persistent compile cache for any batch size bench.py later adopts.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

import bench  # noqa: E402


def run_devres(cam, frames, devbatch):
    import jax
    import jax.numpy as jnp

    est = bench._build_estimator(cam)
    est.perform_stereo_slam_batched(frames[: bench.WARMUP_FRAMES],
                                    batch=bench.BATCH)
    est.rba.flush()
    chunks = []
    for c0 in range(bench.WARMUP_FRAMES, len(frames), devbatch):
        chunk = frames[c0:c0 + devbatch]
        chunks.append((
            jnp.asarray(np.stack([f[0] for f in chunk])),
            jnp.asarray(np.stack([f[1] for f in chunk])),
        ))
    jax.block_until_ready(chunks)
    jax.block_until_ready(est.vo.last_frame().desc_l)
    t0 = time.perf_counter()
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
    jax.block_until_ready(est.vo.last_frame().desc_l)
    dt = time.perf_counter() - t0
    return bench.TIMED_FRAMES / dt, est


def main():
    from srba_slam_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    cam, frames = bench._build_workload()
    frames = frames[: bench.WARMUP_FRAMES + bench.TIMED_FRAMES]
    out = {}
    logs = {}
    for b in (20, 30, 60):
        fps = 0.0
        for rep in range(3):  # rep 0 pays any new-batch-size compiles
            f, est = run_devres(cam, frames, b)
            fps = max(fps, f)
        out[f"b{b}"] = round(fps, 2)
        # decision-equivalence guard: same KF count/ids at every batch size
        logs[b] = [(r.frame_idx, r.inserted_kf) for r in est.step_log
                   if r.inserted_kf is not None]
    out["kf_log_equal"] = (logs[20] == logs[30] == logs[60])
    out["n_kfs"] = len(logs[20])
    print(json.dumps(out))


if __name__ == "__main__":
    main()

"""Attribute every blocking bulk_pull of the device-resident loop to its
call site.

`tools/devres_phase_probe.py` reports the pull phase as one total; this
probe records, per pull, the caller chain inside the estimator plus the
wait time and payload element count, so pull-count reductions (merging the
finish/flush pulls, double-buffering) are targeted at the right site.

Run standalone: `python tools/devres_pull_sites.py [--cpu]`.
"""

from __future__ import annotations

import json
import os
import sys
import time
import traceback

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

import bench  # noqa: E402

PULLS: list[dict] = []


def main():
    if "--cpu" in sys.argv:
        import jax

        jax.config.update("jax_platforms", "cpu")
    import jax
    import jax.numpy as jnp

    from srba_slam_tpu.models import estimator as est_mod
    from srba_slam_tpu.utils import pull as pull_mod

    from srba_slam_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    cam, frames = bench._build_workload()
    frames = frames[: bench.WARMUP_FRAMES + bench.TIMED_FRAMES]

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

    # warm pass (absorbs compiles), then instrumented pass
    est = bench._build_estimator(cam)
    est.perform_stereo_slam_batched(frames[: bench.WARMUP_FRAMES],
                                    batch=bench.BATCH)
    est.rba.flush()
    run_devres(est, stage_chunks(est))

    est = bench._build_estimator(cam)
    est.perform_stereo_slam_batched(frames[: bench.WARMUP_FRAMES],
                                    batch=bench.BATCH)
    est.rba.flush()
    chunks = stage_chunks(est)
    jax.block_until_ready(est.vo.last_frame().desc_l)

    orig = pull_mod.bulk_pull

    def traced(handles):
        # caller chain: estimator/srba frames only, innermost last
        stack = [f"{os.path.basename(fr.filename)}:{fr.lineno}:{fr.name}"
                 for fr in traceback.extract_stack()[:-1]
                 if "srba_slam_tpu" in fr.filename]
        n_el = int(sum(np.prod(h.shape) if hasattr(h, "shape") else 1
                       for h in handles))
        t0 = time.perf_counter()
        out = orig(handles)
        PULLS.append(dict(wait_ms=round((time.perf_counter() - t0) * 1e3, 1),
                          n_arrays=len(handles), n_elements=n_el,
                          site=stack[-3:]))
        return out

    pull_mod.bulk_pull = traced
    est_mod.bulk_pull = traced
    from srba_slam_tpu.models import srba as srba_mod
    srba_orig = getattr(srba_mod, "bulk_pull", None)
    if srba_orig is not None:
        srba_mod.bulk_pull = traced

    t0 = time.perf_counter()
    run_devres(est, chunks)
    dt = time.perf_counter() - t0

    pull_mod.bulk_pull = orig
    est_mod.bulk_pull = orig
    if srba_orig is not None:
        srba_mod.bulk_pull = srba_orig

    print(json.dumps(dict(
        backend=jax.devices()[0].platform,
        fps=round(bench.TIMED_FRAMES / dt, 2),
        total_s=round(dt, 3),
        pull_wait_s=round(sum(p["wait_ms"] for p in PULLS) / 1e3, 3),
        pulls=PULLS,
    )))


if __name__ == "__main__":
    main()

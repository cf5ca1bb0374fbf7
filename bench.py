"""End-to-end benchmark: KITTI-resolution stereo SLAM frames/sec per card.

Runs the full estimator pipeline (frontend + tracking + KF checks + DA +
SRBA insertions) over a pre-rendered synthetic sequence at the reference's
canonical benchmark geometry (1226x370, KITTI calibration, 500-feature
budget — demo/config_imgdir_kitti_srba.ini) on the GPU. Without a GPU it
exits non-zero: there is no CPU fallback.

Prints ONE json line. ``value`` is the MEDIAN fps over the repeats;
``best`` is the fastest repeat. Baseline provenance:

* ``cpu_fps`` — MEASURED single-core CPU throughput of this same pipeline
  (per-frame stepping, XLA CPU backend, 1 core), the lower-bound anchor
  for what a CPU build of the reference could do. Measured in a
  subprocess that stays off the GPU, and cached in bench_cpu_anchor.json
  (delete the file to re-measure).
* ``vs_baseline`` — median fps / 15 fps, where 15 fps is an ASSUMED
  single-thread throughput of the reference C++ app at this configuration
  on a desktop CPU (the reference publishes no numbers and cannot be built
  here — BASELINE.md); ``vs_baseline_provenance`` labels this.
* ``vs_cpu_anchor`` — median fps / cpu_fps, fully measured.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

BASELINE_FPS = 15.0          # ASSUMED reference-CPU fps (see module docstring)
BATCH = 20                   # frames per scan in the streamed loop
DEV_BATCH = 60               # device-resident loop: ONE batch of all timed
                             # frames, the fewest blocking pulls
WARMUP_FRAMES = 1 + BATCH    # bootstrap frame + one full batch (scan compile)
TIMED_FRAMES = 60
REPEATS = 5
CPU_ANCHOR_CACHE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "bench_cpu_anchor.json")
CPU_ANCHOR_FRAMES = 10


def _build_workload(n_frames: int = WARMUP_FRAMES + TIMED_FRAMES,
                    seed: int = 11, with_gt: bool = False):
    """(cam, frames) of the street sequence, pre-rendered so host rendering
    never pollutes timing; ``with_gt`` appends the per-frame ground-truth
    poses [n_frames, 6]."""
    from srba_slam_tpu.utils.camera import StereoCamera
    from srba_slam_tpu.utils.framesource import SyntheticSource

    cam = StereoCamera.kitti()
    # "street" scene: ground plane + roadside structure, the KITTI-like
    # world where inter-keyframe data association genuinely succeeds (a bare
    # ground plane forces a pathological keyframe-every-3-frames regime —
    # see utils/synthworld.StreetScene)
    src = SyntheticSource(cam, n_frames=n_frames, seed=seed, step=0.8,
                          scene="street")
    frames = list(src)
    return (cam, frames, src.gt_poses) if with_gt else (cam, frames)


def _build_estimator(cam, max_kfs: int = 128):
    from srba_slam_tpu.config import (
        GeneralOptions, SRBAStereoSLAMOptions, VOOptions,
    )
    from srba_slam_tpu.models.estimator import SRBAStereoSLAMEstimator

    opts = SRBAStereoSLAMOptions(
        orb_adaptive_fast_th=True,
        camera=cam, n_feats=500, detect_fast_th=20,
        adaptive_th_min_matches=100,
        max_translation=2.0, max_rotation=25.0,
        updated_matches_th=60, vo_id_tracking_th=40,
        srba_submap_size=10, srba_max_tree_depth=4,
        srba_max_optimize_depth=5,
        srba_kernel_param=1.5,
        # reference parity: the canonical KITTI config enables the
        # direction filter (demo/config_imgdir_kitti_srba.ini:124); the
        # round-3 stacked-image-slope binning made it forward-motion-safe
        da_filter_by_direction=True,
        residual_th=30.0,
    )
    est = SRBAStereoSLAMEstimator(
        GeneralOptions(), opts, VOOptions(fast_th=20, n_feats=500),
        capacity=512, max_kfs=max_kfs,
    )
    est.initialize()
    return est


def cpu_anchor():
    """Measure the per-frame pipeline on the XLA CPU backend (1 core) and
    print one JSON line {"cpu_fps": X}. Run in a subprocess by main()."""
    import jax

    from srba_slam_tpu.utils.compile_cache import enable_compile_cache

    jax.config.update("jax_platforms", "cpu")
    enable_compile_cache()
    cam, frames = _build_workload()
    frames = frames[: 3 + CPU_ANCHOR_FRAMES]
    est = _build_estimator(cam)
    for left, right in frames[:3]:          # compile + warm
        est.step(left, right)
    est.rba.flush()
    t0 = time.perf_counter()
    for left, right in frames[3:]:
        est.step(left, right)
    est.rba.flush()
    dt = time.perf_counter() - t0
    print(json.dumps({"cpu_fps": round(CPU_ANCHOR_FRAMES / dt, 3)}))


def _get_cpu_anchor() -> float | None:
    if os.path.exists(CPU_ANCHOR_CACHE):
        try:
            return float(json.load(open(CPU_ANCHOR_CACHE))["cpu_fps"])
        except Exception:
            pass
    try:
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--cpu-anchor"],
            capture_output=True, text=True, timeout=540,
            cwd=os.path.dirname(os.path.abspath(__file__)) or ".",
        )
        val = float(json.loads(out.stdout.strip().splitlines()[-1])["cpu_fps"])
        json.dump({"cpu_fps": val,
                   "provenance": "measured: per-frame pipeline, XLA CPU "
                                 "backend, 1 core, street workload "
                                 f"({CPU_ANCHOR_FRAMES} timed frames)"},
                  open(CPU_ANCHOR_CACHE, "w"))
        return val
    except Exception:
        return None


def _pct(xs, q):
    if not xs:
        return None
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * len(xs)))]


def _latency_stats(est, first_frame: int, t_consumed: dict | None):
    """Summarize the estimator's latency log for frames >= first_frame.

    frame->pose latency: per frame, t_pull(batch) - t_arrival(frame), where
    arrival = the moment the pipeline CONSUMED the frame from the source
    (streamed loop; includes batching + upload wait) or the batch's dispatch
    (device-resident loop, frames pre-staged). KF-decision lag: frames
    between a checked frame and the newest frame already in the system when
    its insert/no-insert decision committed (the speculation model defers
    decisions to the next batch boundary)."""
    lats = []
    for rec in est.lat["batches"]:
        for f in range(rec["j0"], rec["j0"] + rec["b"]):
            if f < first_frame:
                continue
            t_in = rec["t_dispatch"]
            if t_consumed is not None:
                t_in = t_consumed.get(f, t_in)
            lats.append((rec["t_pull"] - t_in) * 1e3)
    lags = [c["resolved_at"] - c["frame"]
            for c in est.lat["checks"] if c["frame"] >= first_frame]
    r = lambda v: None if v is None else round(v, 1)  # noqa: E731
    return {
        "frame_pose_p50_ms": r(_pct(lats, 0.50)),
        "frame_pose_p95_ms": r(_pct(lats, 0.95)),
        "kf_decision_lag_frames_p50": _pct(lags, 0.50),
        "kf_decision_lag_frames_p95": _pct(lags, 0.95),
        "n_checks": len(lags),
    }


def main():
    import jax

    from srba_slam_tpu.utils.compile_cache import enable_compile_cache

    backend = jax.devices()[0].platform
    if backend != "gpu":
        sys.exit(f"bench: needs a GPU, JAX found {backend!r}")
    enable_compile_cache()
    cam, frames = _build_workload()
    frames = frames[: WARMUP_FRAMES + TIMED_FRAMES]
    cpu_fps = _get_cpu_anchor()

    dts = []
    lat_reps = []
    for _rep in range(REPEATS):
        est = _build_estimator(cam)  # fresh state; jit caches persist
        est.perform_stereo_slam_batched(frames[:WARMUP_FRAMES], batch=BATCH)
        est.rba.flush()
        jax.block_until_ready(est.vo.last_frame().desc_l)
        # arrival model for the latency metric: the moment the pipeline
        # consumes each frame from the source (includes batching + upload
        # wait; prefetch makes this CONSERVATIVE — real cameras deliver
        # later than the uploader pulls ahead)
        t_consumed: dict = {}

        def timed_src(fr, base, sink=t_consumed):
            for k, f in enumerate(fr):
                sink[base + k] = time.perf_counter()
                yield f

        t0 = time.perf_counter()
        # pipelined batched loop (next batch's scan dispatch overlaps the
        # current batch's keyframe logic)
        est.perform_stereo_slam_batched(
            timed_src(frames[WARMUP_FRAMES:], WARMUP_FRAMES), batch=BATCH)
        est.rba.flush()
        jax.block_until_ready(est.vo.last_frame().desc_l)
        dts.append(time.perf_counter() - t0)
        lat_reps.append(_latency_stats(est, WARMUP_FRAMES, t_consumed))

    best_fps = TIMED_FRAMES / min(dts)
    med_i = dts.index(sorted(dts)[len(dts) // 2])
    median_fps = TIMED_FRAMES / dts[med_i]
    stream_latency = lat_reps[med_i]  # the median repeat's latency profile

    # secondary: device-resident throughput — frames pre-staged on device,
    # measuring the pipeline without host->device frame uploads
    import jax.numpy as jnp

    dev_fps = 0.0
    dev_latency = None
    bounded = None
    # max over the repeats (each timed pass is short; the repeat's cost is
    # the warmup + staging)
    for _rep in range(8):
        est = _build_estimator(cam)
        est.perform_stereo_slam_batched(frames[:WARMUP_FRAMES], batch=BATCH)
        est.rba.flush()
        chunks = []
        for c0 in range(WARMUP_FRAMES, len(frames), DEV_BATCH):
            chunk = frames[c0:c0 + DEV_BATCH]
            chunks.append((jnp.asarray(np.stack([f[0] for f in chunk])),
                           jnp.asarray(np.stack([f[1] for f in chunk]))))
        jax.block_until_ready(chunks)
        if _rep == 0:
            # warm the DEV_BATCH-shaped scan program OUTSIDE the timed
            # window (the warmup loop above runs at batch=BATCH, so the
            # 60-frame scan shape would otherwise compile inside repeat 1):
            # dispatch-and-discard one scan over the staged chunk
            # (_dispatch_scan mutates no host state)
            warm = est._dispatch_scan(*chunks[0])
            jax.device_get(warm["last_inc"])  # true sync: 6 floats
        jax.block_until_ready(est.vo.last_frame().desc_l)
        t0 = time.perf_counter()
        # pipelined exactly like the real batched loop: batch n+1's scan is
        # dispatched right after batch n's pull, so its device compute (and
        # batch n's check/solve programs behind it in the device queue)
        # overlaps batch n's host-side keyframe logic
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
        fps = TIMED_FRAMES / (time.perf_counter() - t0)
        if fps > dev_fps:
            dev_fps = fps
            # frames are pre-staged here, so "arrival" = batch dispatch:
            # this is the pipeline's own dispatch->pose-on-host latency
            dev_latency = _latency_stats(est, WARMUP_FRAMES, None)

    # bounded-lag operating point: same device-resident loop at a SMALL
    # batch (8 frames) — the latency/throughput trade the batching
    # assumption hides
    BOUNDED_BATCH = 8
    for _rep in range(2):  # pass 1 warms the 8-shaped scan program
        est = _build_estimator(cam)
        est.perform_stereo_slam_batched(frames[:WARMUP_FRAMES], batch=BATCH)
        est.rba.flush()
        chunks = []
        for c0 in range(WARMUP_FRAMES, len(frames), BOUNDED_BATCH):
            chunk = frames[c0:c0 + BOUNDED_BATCH]
            chunks.append((jnp.asarray(np.stack([f[0] for f in chunk])),
                           jnp.asarray(np.stack([f[1] for f in chunk]))))
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
        fps = TIMED_FRAMES / (time.perf_counter() - t0)
        if _rep:
            bounded = dict(batch=BOUNDED_BATCH, fps=round(fps, 2),
                           **_latency_stats(est, WARMUP_FRAMES, None))

    print(json.dumps({
        "metric": f"kitti_synth_e2e_fps_per_chip[{backend}]",
        "value": round(median_fps, 2),           # MEDIAN (headline)
        "unit": "frames/sec",
        "vs_baseline": round(median_fps / BASELINE_FPS, 2),
        "vs_baseline_provenance":
            "median fps / ASSUMED 15 fps reference-CPU throughput "
            "(reference publishes no numbers; BASELINE.md)",
        "best": round(best_fps, 2),
        "cpu_fps": None if cpu_fps is None else round(cpu_fps, 3),
        "vs_cpu_anchor":
            None if not cpu_fps else round(median_fps / cpu_fps, 2),
        "device_resident_fps": round(dev_fps, 2),
        # online-latency profile: frame->pose latency and KF-decision lag.
        # "stream" measures from frame CONSUMPTION (incl. batching + upload
        # wait, median repeat); "device_resident" from batch dispatch
        # (frames pre-staged, best repeat); "bounded_lag" = the same loop
        # at batch 8 (latency/throughput trade-off point)
        "latency": {
            f"stream_batch{BATCH}": stream_latency,
            f"device_resident_batch{DEV_BATCH}": dev_latency,
            "bounded_lag": bounded,
        },
    }))


if __name__ == "__main__":
    if "--cpu-anchor" in sys.argv:
        cpu_anchor()
    else:
        main()

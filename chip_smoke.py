#!/usr/bin/env python3
"""Bring-up check: the SLAM pipeline on the GPU, end to end, in one process.

Run from the repository root::

    python chip_smoke.py            # phases 1-5 on one GPU
    python chip_smoke.py --gpus 4   # phase 1 + phase 6 on four GPUs

Phases (any failure raises and the script exits non-zero):

1. device — JAX's first device must be a GPU; there is no CPU fallback.
2. main path, batched — the bench's KITTI workload (street scene at
   1226x370, 500 features, capacity 512, max_kfs 512) through
   ``perform_stereo_slam_batched`` at batch 8; ATE under 1% of the path.
3. plain reference — the same frames through per-frame ``step`` on the GPU
   (identical keyframe and loop-closure decisions), and a 20-frame prefix
   through ``step`` on the CPU (identical decisions, positions within
   ``CPU_POS_TOL``).
4. window BA at the loop-closure bucket (C=32/L=8192/O=16384) through both
   Hessian assembly paths.
5. the CLI, in-process, on the synthetic demo config.
6. (``--gpus 4`` only) fleet mode with one KITTI-geometry sequence per card
   against each sequence alone, and the observation-sharded window solve
   against the single-card solve.

The last line of standard output is one JSON object with the device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

N_FRAMES = 201          # bootstrap frame + 200 batched frames
BATCH = 8               # the CLI's default batch on an accelerator
MAX_KFS = 512           # the estimator default: the reference's <=500-KF scale
CPU_PREFIX = 20
ATE_FRAC = 0.01         # tests/test_kitti_geometry_ate.py: ATE < 1% of path
# batched vs per-frame poses: tests/test_batch_mode.py's gate for the default
# (pipelined) solve scheduling, where a replayed speculation miss moves a
# queued window solve relative to the next dispatch
BATCH_POSE_TOL = 0.15
# GPU vs CPU keyframe positions after the same 20 per-frame steps: sums run
# in another order on the two backends (f32 throughout, TF32 kept off by
# precision=HIGHEST), and the window BA amplifies last-bit differences
# through accepted LM steps. 5 mm is tests/test_parallel.py's bound for the
# same program compiled two ways.
CPU_POS_TOL = 5e-3
WINDOW_TOL = 1e-3       # pose agreement of two window solves of one problem
FLEET_FRAMES = 40
FLEET_POSE_TOL = 5e-3   # tests/test_parallel.py: fleet vs solo runs


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


class PhaseError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


# --------------------------------------------------------------- phase 1
def phase_device(n_gpus: int) -> dict:
    import jax

    from srba_slam_tpu.utils.compile_cache import enable_compile_cache
    from srba_slam_tpu.utils.devinfo import device_info, nvidia_smi_line

    info = device_info()
    if info["platform"] != "gpu":
        raise SystemExit(f"chip_smoke: needs a GPU; JAX found "
                         f"{info['platform']!r} ({info['kind']})")
    if info["count"] < n_gpus:
        raise SystemExit(f"chip_smoke: needs {n_gpus} GPUs; JAX found "
                         f"{info['count']}")
    cache = enable_compile_cache()
    log(f"device: {info['kind']} x{info['count']} ({info['platform']})")
    log(f"nvidia-smi: {nvidia_smi_line()}")
    log(f"jax {jax.__version__}; compile cache {cache}; "
        f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    return info


# --------------------------------------------------------------- phase 2
def kf_trajectory(est) -> tuple[list, np.ndarray]:
    """(frame index of each inserted keyframe, keyframe poses [n, 6])."""
    est.rba.flush()
    n = est.store.n_kfs
    frames = [r.frame_idx for r in est.step_log if r.inserted_kf is not None]
    return frames, np.asarray(est.rba.kf_global[:n])


def decisions(est) -> list:
    return [(r.frame_idx, r.inserted_kf, r.loop_closure_with)
            for r in est.step_log]


def phase_batched(frames, gt, make_est, batch: int = BATCH) -> dict:
    import jax

    from srba_slam_tpu.utils.evaluation import ate_rmse

    def run():
        est = make_est()
        t0 = time.perf_counter()
        est.perform_stereo_slam_batched(frames, batch=batch)
        est.rba.flush()
        jax.block_until_ready(est.vo.last_frame().desc_l)
        return est, time.perf_counter() - t0

    est, t_cold = run()
    _est_warm, t_warm = run()
    kf_frames, poses = kf_trajectory(est)
    n = len(poses)
    check(n >= 2, f"only {n} keyframes inserted")
    check(len(kf_frames) == n, f"{len(kf_frames)} insert frames, {n} KFs")
    check(bool(np.isfinite(poses).all()), "non-finite keyframe pose")
    path = float(np.sum(np.linalg.norm(np.diff(gt[:, 3:], axis=0), axis=1)))
    ate = float(ate_rmse(poses[:, 3:], gt[kf_frames][:, 3:], align=True))
    log(f"batched: {len(frames)} frames, {n} keyframes, ATE {ate:.4f} m over "
        f"{path:.1f} m ({100 * ate / path:.3f}% of path; gate "
        f"{100 * ATE_FRAC:.0f}%)")
    log(f"batched: cold pass {t_cold:.1f} s (compiles included), warm pass "
        f"{t_warm:.2f} s = {len(frames) / t_warm:.2f} fps at batch {batch} "
        f"(information only), cold-minus-warm {t_cold - t_warm:.1f} s")
    check(ate < ATE_FRAC * path, f"ATE {ate} >= {ATE_FRAC} x path {path}")
    return {"est": est, "ate": ate, "path": path, "n_kfs": n}


# --------------------------------------------------------------- phase 3
def phase_reference(frames, make_est, batched_est,
                    cpu_prefix: int = CPU_PREFIX) -> None:
    import jax

    ref = make_est()
    ref.perform_stereo_slam(frames)
    check(decisions(ref) == decisions(batched_est),
          "per-frame step and batched runs took different keyframe or "
          "loop-closure decisions")
    _, p_ref = kf_trajectory(ref)
    _, p_bat = kf_trajectory(batched_est)
    d = float(np.max(np.abs(p_ref - p_bat)))
    n_lc = sum(r.loop_closure_with is not None for r in ref.step_log)
    dpos = np.linalg.norm(p_ref[:, 3:] - p_bat[:, 3:], axis=1)
    along = ", ".join(f"{dpos[int(q * (len(dpos) - 1))]:.3e}"
                      for q in (0.25, 0.5, 0.75, 1.0))
    log(f"per-frame step (GPU): identical decisions ({len(p_ref)} KFs, "
        f"{n_lc} loop closures); max |pose diff| vs batched {d:.3e} "
        f"(gate {BATCH_POSE_TOL}); KF position diff at 1/4, 1/2, 3/4, end "
        f"of the run: {along} m")
    check(d <= BATCH_POSE_TOL, f"batched vs per-frame poses differ by {d}")

    gpu = make_est()
    gpu.perform_stereo_slam(frames[:cpu_prefix])
    cpu_dev = jax.devices("cpu")[0]
    with jax.default_device(cpu_dev):
        cpu = make_est()
        cpu.perform_stereo_slam(frames[:cpu_prefix])
        check(cpu.vo.last_frame().desc_l.devices() == {cpu_dev},
              "the CPU reference run left the CPU")
        _, p_cpu = kf_trajectory(cpu)
    _, p_gpu = kf_trajectory(gpu)
    check(decisions(gpu) == decisions(cpu),
          f"GPU and CPU took different decisions over {cpu_prefix} frames")
    dpos = float(np.max(np.linalg.norm(p_gpu[:, 3:] - p_cpu[:, 3:], axis=1)))
    drot = float(np.max(np.abs(p_gpu[:, :3] - p_cpu[:, :3])))
    log(f"per-frame step GPU vs CPU, {cpu_prefix} frames: identical "
        f"decisions ({len(p_gpu)} KFs); max KF position diff {dpos:.3e} m, "
        f"max rotation-vector diff {drot:.3e} rad (gate {CPU_POS_TOL} m)")
    check(dpos <= CPU_POS_TOL, f"GPU vs CPU KF positions differ by {dpos}")


# --------------------------------------------------------------- phase 4
def _window_problem(cam, C, L, O, n_cams, n_lms):
    from srba_slam_tpu.utils.synthworld import make_ba_window_problem

    win, _gt = make_ba_window_problem(
        cam, np.random.default_rng(7), C=C, L=L, O=O, n_cams=n_cams,
        n_lms=n_lms, pose_noise=0.03, px_noise=0.3)
    return win


def phase_window(cam, C=32, L=8192, O=16384, n_cams=30, n_lms=5000) -> None:
    import jax
    import jax.numpy as jnp

    import srba_slam_tpu.ops.window_ba as wba

    win = _window_problem(cam, C, L, O, n_cams, n_lms)
    chosen = wba.assembly_path()
    other = "scatter" if chosen == "onehot" else "onehot"
    res = {}
    try:
        for path in (chosen, other):
            wba.ASSEMBLY = path
            wba.optimize_window.clear_cache()
            t0 = time.perf_counter()
            r = jax.block_until_ready(
                wba.optimize_window(win, cam, max_iters=12))
            t_first = time.perf_counter() - t0
            t0 = time.perf_counter()
            r2 = jax.block_until_ready(
                wba.optimize_window(win, cam, max_iters=12))
            t_second = time.perf_counter() - t0
            res[path] = r
            same = (np.array_equal(np.asarray(r.cam_pose),
                                   np.asarray(r2.cam_pose))
                    and np.array_equal(np.asarray(r.lm_pos),
                                       np.asarray(r2.lm_pos)))
            log(f"window BA C={C}/L={L}/O={O} [{path}]: cost "
                f"{float(r.cost_init):.4g} -> {float(r.cost_final):.4g} in "
                f"{int(r.iters)} LM iters; first call {t_first:.2f} s "
                f"(compile included), second {t_second * 1e3:.1f} ms; two "
                f"solves bit-identical: {same}")
            check(float(r.cost_final) < float(r.cost_init),
                  f"{path} assembly did not lower the cost")
    finally:
        wba.ASSEMBLY = None
        wba.optimize_window.clear_cache()
    d = float(np.max(np.abs(np.asarray(res[chosen].cam_pose)
                            - np.asarray(res[other].cam_pose))))
    log(f"window BA: {chosen} (default here) vs {other}: max |pose diff| "
        f"{d:.3e} (gate {WINDOW_TOL})")
    check(d <= WINDOW_TOL, f"assembly paths disagree by {d}")

    ints, floats = wba.pack_window(*(np.asarray(a) for a in win))
    slots = wba.WINDOW_SLOTS
    compiled = wba.optimize_windows_batch_blob.lower(
        jnp.asarray(np.stack([ints] * slots)),
        jnp.asarray(np.stack([floats] * slots)),
        jnp.asarray(np.arange(slots) < 1), C, L, O, cam).compile()
    log(f"optimize_windows_batch_blob C={C}/L={L}/O={O} memory_analysis: "
        f"{compiled.memory_analysis()}")


# --------------------------------------------------------------- phase 5
def phase_cli(config: str, n_frames: int = 30) -> None:
    from srba_slam_tpu.__main__ import main as cli_main

    with tempfile.TemporaryDirectory() as tmp:
        out_dir = os.path.join(tmp, "out")
        cfg = os.path.join(tmp, "config.ini")
        with open(config) as f:
            lines = [f"out_dir = {out_dir}\n"
                     if ln.strip().startswith("out_dir") else ln for ln in f]
        with open(cfg, "w") as f:
            f.writelines(lines)
        rc = cli_main([cfg, "--synthetic", str(n_frames)])
        check(rc == 0, f"CLI returned {rc}")
        poses = os.path.join(out_dir, "out_kf_poses.txt")
        check(os.path.exists(poses), "CLI wrote no out_kf_poses.txt")
        n = len(np.loadtxt(poses, ndmin=2))
        log(f"CLI: exit 0, out_kf_poses.txt with {n} keyframes")


# --------------------------------------------------------------- phase 6
def phase_fleet(seqs, make_est, n_dev: int) -> None:
    """``seqs``: n_dev frame lists, one sequence per device."""
    from srba_slam_tpu.parallel.batch import make_mesh
    from srba_slam_tpu.parallel.fleet import FleetSLAM

    scratch = make_est()
    for left, right in seqs[0][:max(1, scratch.opts.voc_train_frames)]:
        scratch.step(left, right)
    scratch.ensure_vocabulary()
    voc = scratch.bow.voc

    def build():
        est = make_est()
        est.initialize(vocabulary=voc)   # share one vocabulary (fleet rule)
        return est

    fleet_ests = [build() for _ in seqs]
    fleet = FleetSLAM(fleet_ests, mesh=make_mesh(n_dev))
    t0 = time.perf_counter()
    for step_frames in zip(*seqs):
        fleet.step(list(step_frames))
        if fleet._prev_stacked is not None and fleet_ests[0].frame_idx == 1:
            shards = fleet._prev_stacked.desc_l.addressable_shards
            log("fleet: tracking state shards: " + ", ".join(
                f"rows {s.index[0].start}:{s.index[0].stop} on {s.device}"
                for s in shards))
            check(len({s.device for s in shards}) == n_dev,
                  "fleet state is not spread over every device")
    fleet.sync_states()
    log(f"fleet: {len(seqs)} sequences x {len(seqs[0])} frames on "
        f"{n_dev} devices in {time.perf_counter() - t0:.1f} s (compiles "
        "included)")
    for i, (frames, flt) in enumerate(zip(seqs, fleet_ests)):
        solo = build()
        solo.perform_stereo_slam(frames)
        check(decisions(flt) == decisions(solo),
              f"seq{i}: fleet and solo decisions differ")
        _, pf = kf_trajectory(flt)
        _, ps = kf_trajectory(solo)
        d = float(np.max(np.abs(pf - ps)))
        log(f"fleet seq{i}: identical decisions ({len(pf)} KFs), max |pose "
            f"diff| vs solo {d:.3e} (gate {FLEET_POSE_TOL}); solo ran on "
            f"{solo.vo.last_frame().desc_l.devices()}")
        check(d <= FLEET_POSE_TOL, f"seq{i}: fleet vs solo poses differ {d}")


def phase_sharded_window(cam, n_dev: int, C=32, L=8192, O=16384,
                         n_cams=30, n_lms=5000) -> None:
    import jax
    from jax.sharding import Mesh

    from srba_slam_tpu.ops.window_ba import optimize_window, shard_window_obs

    win = _window_problem(cam, C, L, O, n_cams, n_lms)
    mesh = Mesh(np.array(jax.devices()[:n_dev]), ("obs",))
    r1 = jax.block_until_ready(optimize_window(win, cam, max_iters=12))
    win_sh = shard_window_obs(win, mesh)
    log("sharded window: obs_px shards on " + ", ".join(
        str(s.device) for s in win_sh.obs_px.addressable_shards))
    rn = jax.block_until_ready(optimize_window(win_sh, cam, max_iters=12))
    t0 = time.perf_counter()
    jax.block_until_ready(optimize_window(win, cam, max_iters=12))
    t1 = time.perf_counter() - t0
    t0 = time.perf_counter()
    jax.block_until_ready(optimize_window(win_sh, cam, max_iters=12))
    tn = time.perf_counter() - t0
    d = float(np.max(np.abs(np.asarray(rn.cam_pose)
                            - np.asarray(r1.cam_pose))))
    log(f"sharded window C={C}/L={L}/O={O}: {n_dev}-device vs 1-device max "
        f"|pose diff| {d:.3e} (gate {WINDOW_TOL}); cost "
        f"{float(rn.cost_init):.4g} -> {float(rn.cost_final):.4g}; warm "
        f"solve 1-device {t1 * 1e3:.1f} ms, {n_dev}-device {tn * 1e3:.1f} ms")
    check(float(rn.cost_final) < float(rn.cost_init),
          "sharded solve did not lower the cost")
    check(d <= WINDOW_TOL, f"sharded vs single-device solve differ by {d}")


# ------------------------------------------------------------------ main
def _kitti_estimator_factory(cam, max_kfs: int):
    import bench as B

    return lambda: B._build_estimator(cam, max_kfs=max_kfs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--gpus", type=int, choices=(1, 4), default=1,
                    help="4: run only the four-card phase (fleet + sharded "
                         "window BA)")
    args = ap.parse_args(argv)

    t_start = time.perf_counter()
    info = phase_device(args.gpus)
    import bench as B

    if args.gpus == 4:
        cam, _ = B._build_workload(n_frames=1)
        seqs = [B._build_workload(n_frames=FLEET_FRAMES, seed=11 + 37 * i)[1]
                for i in range(4)]
        phase_fleet(seqs, _kitti_estimator_factory(cam, 128), 4)
        phase_sharded_window(cam, 4)
    else:
        cam, frames, gt = B._build_workload(n_frames=N_FRAMES, with_gt=True)
        make_est = _kitti_estimator_factory(cam, MAX_KFS)
        t0 = time.perf_counter()
        out = phase_batched(frames, gt, make_est)
        log(f"phase 2 done in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        phase_reference(frames, make_est, out["est"])
        log(f"phase 3 done in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        phase_window(cam)
        log(f"phase 4 done in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        phase_cli(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "demo", "config_synthetic_small.ini"))
        log(f"phase 5 done in {time.perf_counter() - t0:.1f} s")
    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": info["platform"], "kind": info["kind"],
        "count": info["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

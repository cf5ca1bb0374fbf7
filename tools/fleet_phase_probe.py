"""Per-phase breakdown of the fleet lockstep loop.

On a virtual CPU mesh all device compute serializes on the host's cores;
the question is how much of the fleet step is device compute (which real
devices run in parallel on this embarrassingly parallel axis) vs host
bookkeeping / pulls (which do not scale with devices either way).

Phases per fleet step:
  * vo_dev   — the sharded VO program + its bulk pull (device + sync)
  * host     — per-sequence bookkeeping python between transfers
  * qa_dev   — the sharded BoW+DA program + its bulk pull (check steps)
  * checks   — per-sequence host check logic incl. SRBA insertion

Prints one JSON line with the fleet/solo phase totals, the observed
scaling, and the PROJECTED scaling = throughput if the device phases
(vo_dev + qa_dev) ran S-way parallel instead of serialized on the host.
Run standalone:
  XLA_FLAGS=--xla_force_host_platform_device_count=8 \
  python tools/fleet_phase_probe.py
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def _build(n_seq, n_frames, mesh):
    import __graft_entry__ as g

    from srba_slam_tpu.config import (
        GeneralOptions, SRBAStereoSLAMOptions, VOOptions,
    )
    from srba_slam_tpu.models.bow import Vocabulary
    from srba_slam_tpu.models.estimator import SRBAStereoSLAMEstimator
    from srba_slam_tpu.parallel.fleet import FleetSLAM
    from srba_slam_tpu.utils.camera import StereoCamera
    from srba_slam_tpu.utils.framesource import SyntheticSource

    cam = StereoCamera(
        fx_l=64.0, fy_l=64.0, cx_l=64.0, cy_l=48.0,
        fx_r=64.0, fy_r=64.0, cx_r=64.0, cy_r=48.0,
        baseline=0.5, width=128, height=96,
    )
    k = 64
    rng = np.random.default_rng(1)
    desc = rng.integers(0, 2**32, (256, 8), dtype=np.uint64).astype(np.uint32)
    voc = Vocabulary.train(desc, k=8, L=2, seed=0)
    ests = []
    for _ in range(n_seq):
        opts = SRBAStereoSLAMOptions(
            orb_adaptive_fast_th=True,
            camera=cam, n_feats=k, detect_fast_th=8,
            adaptive_th_min_matches=20, max_translation=0.25,
            max_rotation=10.0, updated_matches_th=25, vo_id_tracking_th=20,
            srba_submap_size=4, srba_max_optimize_depth=3,
            da_filter_by_direction=False, residual_th=10.0,
        )
        e = SRBAStereoSLAMEstimator(
            GeneralOptions(), opts, VOOptions(fast_th=8, n_feats=k),
            capacity=k, max_kfs=16,
        )
        e.initialize(vocabulary=voc)
        ests.append(e)
    fleet = FleetSLAM(ests, mesh=mesh)
    sources = [SyntheticSource(cam, n_frames=n_frames, seed=100 + i,
                               step=0.12) for i in range(n_seq)]
    return fleet, sources


def _instrument(fleet_mod):
    phases = {"vo_dev": 0.0, "host": 0.0, "qa_dev": 0.0, "checks": 0.0}

    orig_step = fleet_mod.FleetSLAM.step
    import jax

    from srba_slam_tpu.utils import pull as pull_mod

    orig_pull = pull_mod.bulk_pull

    # classify each bulk_pull by a phase flag the step wrapper flips
    state = {"phase": "vo_dev"}

    def timed_pull(handles):
        t0 = time.perf_counter()
        try:
            return orig_pull(handles)
        finally:
            phases[state["phase"]] += time.perf_counter() - t0

    pull_mod.bulk_pull = timed_pull
    fleet_mod.bulk_pull = timed_pull

    orig_vo_build = fleet_mod.FleetSLAM._build_vo_prog
    orig_qa_build = fleet_mod.FleetSLAM._build_qa_prog

    def wrap_prog(prog, phase):
        def run(*a, **kw):
            t0 = time.perf_counter()
            out = prog(*a, **kw)
            jax.block_until_ready(out)
            phases[phase] += time.perf_counter() - t0
            state["phase"] = phase
            return out
        return run

    def build_vo(self, e0):
        return wrap_prog(orig_vo_build(self, e0), "vo_dev")

    def build_qa(self, e0):
        return wrap_prog(orig_qa_build(self, e0), "qa_dev")

    fleet_mod.FleetSLAM._build_vo_prog = build_vo
    fleet_mod.FleetSLAM._build_qa_prog = build_qa

    # time the whole step; host = total - (vo+qa+check deltas this step)
    def timed_step2(self, frames):
        before = phases["vo_dev"] + phases["qa_dev"] + phases["checks"]
        t0 = time.perf_counter()
        out = orig_step(self, frames)
        total = time.perf_counter() - t0
        after = phases["vo_dev"] + phases["qa_dev"] + phases["checks"]
        phases["host"] += total - (after - before)
        return out

    fleet_mod.FleetSLAM.step = timed_step2

    orig_check = fleet_mod.SRBAStereoSLAMEstimator._kf_check_host

    def timed_check(self, *a, **kw):
        t0 = time.perf_counter()
        try:
            return orig_check(self, *a, **kw)
        finally:
            phases["checks"] += time.perf_counter() - t0

    fleet_mod.SRBAStereoSLAMEstimator._kf_check_host = timed_check

    def restore():
        fleet_mod.FleetSLAM.step = orig_step
        fleet_mod.FleetSLAM._build_vo_prog = orig_vo_build
        fleet_mod.FleetSLAM._build_qa_prog = orig_qa_build
        fleet_mod.SRBAStereoSLAMEstimator._kf_check_host = orig_check
        pull_mod.bulk_pull = orig_pull
        fleet_mod.bulk_pull = orig_pull

    return phases, restore


def run_once(n_seq, n_dev, n_frames, measure=True):
    import jax

    from srba_slam_tpu.parallel import fleet as fleet_mod
    from srba_slam_tpu.parallel.batch import make_mesh

    mesh = make_mesh(n_dev)
    if measure:
        phases, restore = _instrument(fleet_mod)
    fleet, sources = _build(n_seq, n_frames, mesh)
    t0 = time.perf_counter()
    fleet.run(sources)
    for e in fleet.ests:
        e.rba.flush()
    total = time.perf_counter() - t0
    if measure:
        restore()
        return total, dict(phases)
    return total, {}


def main():
    import __graft_entry__ as g

    n_dev = int(os.environ.get("FLEET_PROBE_DEVICES", "8"))
    g._bootstrap_virtual_mesh(n_dev)
    from srba_slam_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    n_frames = int(os.environ.get("FLEET_PROBE_FRAMES", "10"))

    # warm all programs (both mesh sizes) in-process
    run_once(n_dev, n_dev, 4, measure=False)
    run_once(1, 1, 4, measure=False)

    fleet_total, fleet_ph = run_once(n_dev, n_dev, n_frames)
    solo_total, solo_ph = run_once(1, 1, n_frames)

    fleet_fps = n_dev * n_frames / fleet_total
    solo_fps = n_frames / solo_total
    observed = fleet_fps / solo_fps
    # projection: on real devices the device phases of the fleet step run
    # n_dev-way parallel (one sequence per device, zero cross-talk on this
    # embarrassingly parallel axis) instead of SERIALIZED on the host
    dev_fleet = fleet_ph["vo_dev"] + fleet_ph["qa_dev"]
    projected_total = fleet_total - dev_fleet + dev_fleet / n_dev
    raw = (n_dev * n_frames / projected_total) / solo_fps
    # the fleet amortizes HOST fixed costs (one python step-loop, one fused
    # dispatch) across sequences, so the raw aggregate-vs-solo ratio can
    # exceed n_dev — that excess is host batching efficiency, NOT device
    # scaling. The embarrassingly parallel one-sequence-per-chip axis is
    # physically bounded by n_dev: report the projection CAPPED there and
    # the amortization residue separately.
    projected = min(raw, float(n_dev))
    print(json.dumps({
        "n_devices": n_dev,
        "host_cores": len(os.sched_getaffinity(0)),
        "frames_per_seq": n_frames,
        "fleet_s": round(fleet_total, 3),
        "solo_s": round(solo_total, 3),
        "fleet_phases_s": {k: round(v, 3) for k, v in fleet_ph.items()},
        "solo_phases_s": {k: round(v, 3) for k, v in solo_ph.items()},
        "observed_scaling": round(observed, 2),
        "ici_projected_scaling": round(projected, 2),
        "host_amortization_x": round(max(raw / n_dev, 1.0), 2),
        "projection_method":
            "fleet device phases (vo_dev+qa_dev) divided by n_devices "
            "(one sequence per chip, zero cross-talk), host phases "
            "unscaled, aggregate fps vs the measured solo run; capped at "
            "n_devices — the per-sequence axis cannot beat "
            "one-chip-per-sequence, and any excess over the cap is "
            "host-side batching amortization (host_amortization_x)",
    }))


if __name__ == "__main__":
    main()

"""Device microbenchmarks for the hot programs.

Times each program with the N-dispatch / one-pull method (one blocking
sync amortized over N chained dispatches):

    t = (device_get(chain_N) - device_get(chain_0 warm)) / N

Usage::

    python tools/microbench.py [--cpu] [--n 20]

Prints one line per program: name, per-call device time, notes.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def _t_chain(fn, arg, n, pull):
    """Time n chained applications of fn via one final pull."""
    out = fn(arg)
    pull(out)                       # warm + sync
    t0 = time.perf_counter()
    out = arg
    for _ in range(n):
        out = fn(out)
    pull(out)
    return (time.perf_counter() - t0) / n


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

    cam, frames = B._build_workload()
    est = B._build_estimator(cam)
    est.perform_stereo_slam_batched(frames[: B.WARMUP_FRAMES], batch=B.BATCH)
    est.rba.flush()

    def pull(x):
        leaf = jax.tree.leaves(x)[0]
        # slice ON DEVICE before pulling (np.asarray would device_get the
        # whole leaf — an image-sized transfer)
        jax.device_get(leaf.ravel()[0])

    n = args.n
    rows = []

    # --- vo_scan: one full B-frame batch (detect+describe+match+track+solve)
    lefts = jnp.asarray(np.stack([f[0] for f in frames[1:1 + B.BATCH]]))
    rights = jnp.asarray(np.stack([f[1] for f in frames[1:1 + B.BATCH]]))
    jax.device_get(np.asarray(lefts[:1, :1, :1]))

    def scan_once(_):
        d = est._dispatch_scan(lefts, rights)
        return d["pk"]

    t = _t_chain(scan_once, None, max(2, n // 4), pull)
    rows.append((f"vo_scan[{B.BATCH}f incl dispatch]", t,
                 f"{t / B.BATCH * 1e3:.2f} ms/frame"))

    # --- bow_vector: quantize+histogram one frame against the vocabulary
    from srba_slam_tpu.models.bow import bow_vector

    feat = est.vo.last_frame()
    bv = jax.jit(lambda d, v: bow_vector(d, v, est.bow._leaf_bits,
                                         est.bow._weights))
    t = _t_chain(lambda _: bv(feat.desc_l, feat.m_valid), None, n, pull)
    rows.append(("bow_vector", t, f"W={est.bow._leaf_bits.shape[0]}"))

    # --- fused check (slice+write+query+DA), single slot
    from srba_slam_tpu.models.data_association import fused_check_write

    fb = jax.tree.map(lambda a: a[None], feat)  # [1, ...] pseudo batch

    def chk(state):
        arrays, db = state
        h, a, d = fused_check_write(
            fb, arrays, db, est.bow._leaf_bits,
            est.bow._weights, jnp.int32(0), jnp.int32(est.store.n_kfs),
            est.cam, 0)
        return (a, d), h

    # store/db are DONATED: thread them through the chain (est's store/BoW
    # buffers are consumed — est is scratch from here on)
    state = (est.store.arrays, est.bow._db)
    state, h = chk(state)
    pull(h)
    t0 = time.perf_counter()
    for _ in range(n):
        state, h = chk(state)
    pull(h)
    t = (time.perf_counter() - t0) / n
    rows.append(("fused_check (1 slot)", t, "query+DA+row write"))

    # --- window BA, biggest bucket used on this workload
    p = est.rba.p
    from srba_slam_tpu.ops.window_ba import optimize_window_packed_blob, pack_window
    rng = np.random.default_rng(0)
    C, L, O = min(16, p.win_cams), min(1024, p.win_lms), min(2048, p.win_obs)
    cp = np.zeros((C, 6), np.float32); cv = np.zeros(C, bool); cv[:8] = True
    lp = rng.normal(0, 1, (L, 3)).astype(np.float32) + [0, 0, 10]
    lb = np.zeros(L, np.int32); lv = np.ones(L, bool)
    oc = rng.integers(0, 8, O).astype(np.int32)
    ol = rng.integers(0, L, O).astype(np.int32)
    opx = rng.uniform(0, 300, (O, 3)).astype(np.float32)
    ov = np.ones(O, bool)
    ints, floats = pack_window(cp, cv, lp, lb, lv, oc, ol, opx, ov)
    ints, floats = jnp.asarray(ints), jnp.asarray(floats)

    def ba(_):
        return optimize_window_packed_blob(
            ints, floats, C, L, O, est.cam, kernel_param=p.kernel_param,
            max_iters=p.opt_iters, use_kernel=p.use_robust_kernel,
            w_prior_rot=p.anchor_prior_w_rot,
            w_prior_trans=p.anchor_prior_w_trans,
            stage1_iters=p.stage1_iters,
            use_kernel_stage1=p.use_robust_kernel_stage1)

    t = _t_chain(ba, None, n, pull)
    rows.append((f"window_ba[C{C} L{L} O{O}]", t, f"{p.opt_iters} LM iters"))

    backend = jax.devices()[0].platform
    print(f"backend={backend}")
    for name, t, note in rows:
        print(f"{name:34s} {t * 1e3:9.2f} ms   {note}")


if __name__ == "__main__":
    main()

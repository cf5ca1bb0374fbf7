"""Attribute the detect/describe frontend's device time stage by stage.

Times each stage on the same [2B, H, W] image batch ``vo_scan`` sees (both
eyes of B bench frames), beside the whole ``vo_scan`` at that batch:

  * fast_nms   — FAST-9/16 scores + 5x5 NMS (XLA)
  * grid_topk  — per-cell winner + global lax.top_k(k) selection
  * blur7      — 7x7 Gaussian for BRIEF sampling
  * orb_desc   — upright ORB descriptors through the patch path
                 (ops/orb.describe: one 33x33 block read per keypoint)
  * vo_scan    — the whole batched VO program (frontend + tracking scan)

Each time is the host clock around ``--n`` back-to-back calls that end in
``block_until_ready``, divided by ``--n``. The FAST+NMS roofline is one f32
read and one f32 write per pixel at the card's published bandwidth.

Run: `python tools/frontend_phase_probe.py [--n 20] [--batch 20]`
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

# published HBM bandwidth, bytes/s, keyed by JAX device_kind (NVIDIA data
# sheet, H100 SXM); a device missing here gets no roofline share
_PEAK_BYTES_S = {"NVIDIA H100 80GB HBM3": 3.35e12}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=20)
    ap.add_argument("--batch", type=int, default=0,
                    help="frames per scan (default: bench.BATCH)")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from srba_slam_tpu.utils.compile_cache import enable_compile_cache
    from srba_slam_tpu.utils.devinfo import device_info, nvidia_smi_line

    enable_compile_cache()

    import bench as B
    from srba_slam_tpu.models.vo import vo_scan
    from srba_slam_tpu.ops.fast import fast_score_map
    from srba_slam_tpu.ops.nms import grid_topk, local_max_suppress
    from srba_slam_tpu.ops.orb import describe, gauss_blur7

    bb = args.batch or B.BATCH
    cam, frames = B._build_workload(n_frames=1 + bb)
    est = B._build_estimator(cam)
    est.step(*frames[0])
    lefts = jnp.asarray(np.stack([f[0] for f in frames[1:1 + bb]]))
    rights = jnp.asarray(np.stack([f[1] for f in frames[1:1 + bb]]))
    imgs = jnp.concatenate([lefts, rights]).astype(jnp.float32)  # [2B,H,W]

    fast_th, k, cell, radius, margin = 20.0, est.capacity, 5, 2, 16
    f_fast = jax.jit(jax.vmap(lambda im: local_max_suppress(
        fast_score_map(im, fast_th, margin=margin), radius=radius)))
    f_topk = jax.jit(jax.vmap(functools.partial(grid_topk, cell=cell, k=k)))
    f_blur = jax.jit(jax.vmap(gauss_blur7))
    f_desc = jax.jit(jax.vmap(lambda im, y, x, v: describe(
        im, y, x, v, oriented=False, patch_safe=True)[0]))
    o = est.vo.opts
    f_scan = functools.partial(
        vo_scan, prev=est.vo._prev, init_pose=jnp.zeros(6, jnp.float32),
        cam=cam, fast_th=float(est.vo.fast_th), orb_th=int(est.vo.orb_th),
        k=k, cell=o.min_distance, max_y_diff=o.max_y_diff,
        kernel_param=o.kernel_param, residual_threshold=o.residual_threshold,
        min_mod=o.min_mod_out_vector, max_iters_initial=o.initial_max_iters,
        max_iters=o.max_iters, min_inliers=o.bad_tracking_th,
        max_incr_cost=o.max_incr_cost)

    def timeit(fn, *a):
        out = jax.block_until_ready(fn(*a))
        t0 = time.perf_counter()
        for _ in range(args.n):
            out = fn(*a)
        jax.block_until_ready(out)
        return (time.perf_counter() - t0) / args.n, out

    out = {"device": device_info(), "nvidia_smi": nvidia_smi_line(),
           "imgs": int(imgs.shape[0]), "hw": list(imgs.shape[1:]),
           "batch": bb, "n": args.n}
    t_fast, s = timeit(f_fast, imgs)
    t_topk, (ys, xs, _sc, valid) = timeit(f_topk, s)
    t_blur, _ = timeit(f_blur, imgs)
    t_desc, _ = timeit(f_desc, imgs, ys, xs, valid)
    t_scan, _ = timeit(lambda l, r: f_scan(l, r), lefts, rights)
    out.update({
        "fast_nms_ms": t_fast * 1e3, "grid_topk_ms": t_topk * 1e3,
        "blur7_ms": t_blur * 1e3, "orb_desc_ms": t_desc * 1e3,
        "vo_scan_ms": t_scan * 1e3,
        "fast_nms_share_of_vo_scan": t_fast / t_scan,
        "orb_desc_share_of_vo_scan": t_desc / t_scan,
    })
    peak = _PEAK_BYTES_S.get(out["device"]["kind"])
    if peak:
        bytes_min = int(np.prod(imgs.shape)) * 8      # f32 read + f32 write
        t_min = bytes_min / peak
        out["fast_nms_roofline_ms"] = t_min * 1e3
        out["fast_nms_x_from_roofline"] = t_fast / t_min
    print(json.dumps(out))


if __name__ == "__main__":
    main()

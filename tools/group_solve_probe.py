"""Window-BA assembly and group-path probe.

Two questions, both answered on the live backend:

1. Block-Hessian assembly (ops/window_ba.assembly_path): one-hot matmul
   contractions against scatter-adds, at the common bucket (C=16, L=1024,
   O=2048) and the loop-closure bucket (C=32, L=8192, O=16384). For each
   path: the time of one ``optimize_window`` solve, its LM iteration count,
   and whether ``--reps`` solves of the same window are bit-identical.
2. The WINDOW_SLOTS group program (ops/window_ba.optimize_windows_batch_blob):
   vmapped lanes against the serial lax.scan, at fills 2 / 4 / 8 of the
   common bucket (``_VMAP_LO_LIMIT`` chooses between them).

3. ``--components``: the assembly's blocks (g_c, g_l, Hcc, Hcl, Hll) from
   each path on random Jacobians at the loop-closure bucket, against a
   float64 numpy reference (a precision loss that only the GPU compiler
   introduces shows here first).

Times are the host clock around a call that ends in ``block_until_ready``;
the minimum over ``--reps`` repeats is reported with all repeats beside it.
XLA_FLAGS set by the caller (for example ``--xla_gpu_deterministic_ops``)
are echoed in the output.

Run: `python tools/group_solve_probe.py [--reps 5] [--skip-group] [--components]`
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

BUCKETS = ((16, 1024, 2048, 14, 900), (32, 8192, 16384, 30, 5000))


def _solve_times(wba, win, cam, path, reps):
    wba.ASSEMBLY = path
    wba.optimize_window.clear_cache()
    import jax

    r = wba.optimize_window(win, cam, kernel_param=1.5, max_iters=12)
    jax.block_until_ready(r)
    first = np.asarray(r.cam_pose), np.asarray(r.lm_pos)
    ts, same = [], True
    for _ in range(reps):
        t0 = time.perf_counter()
        r = wba.optimize_window(win, cam, kernel_param=1.5, max_iters=12)
        jax.block_until_ready(r)
        ts.append(time.perf_counter() - t0)
        same &= (np.array_equal(np.asarray(r.cam_pose), first[0])
                 and np.array_equal(np.asarray(r.lm_pos), first[1]))
    return {"ms_min": min(ts) * 1e3, "ms_all": [t * 1e3 for t in ts],
            "iters": int(r.iters),
            "cost": [float(r.cost_init), float(r.cost_final)],
            "bit_identical_over_reps": bool(same)}, first[0]


def _components(wba, out):
    import jax
    import jax.numpy as jnp

    C, L, O = 32, 8192, 16384
    rng = np.random.default_rng(3)
    obs_cam = rng.integers(0, C, O).astype(np.int32)
    obs_lm = rng.integers(0, L, O).astype(np.int32)
    lm_base = rng.integers(0, C, L).astype(np.int32)
    r = rng.normal(size=(O, 3)).astype(np.float32)
    JA = rng.normal(size=(O, 3, 6)).astype(np.float32) * 50
    JB = rng.normal(size=(O, 3, 6)).astype(np.float32) * 50
    JC = rng.normal(size=(O, 3, 3)).astype(np.float32) * 50
    # float64 reference by np.add.at
    a_, b_, l_ = obs_cam, lm_base[obs_lm], obs_lm
    f = lambda x: x.astype(np.float64)  # noqa: E731
    ref = {}
    g_c = np.zeros((C, 6))
    np.add.at(g_c, a_, np.einsum("oij,oi->oj", f(JA), f(r)))
    np.add.at(g_c, b_, np.einsum("oij,oi->oj", f(JB), f(r)))
    ref["g_c"] = g_c
    g_l = np.zeros((L, 3))
    np.add.at(g_l, l_, np.einsum("oij,oi->oj", f(JC), f(r)))
    ref["g_l"] = g_l
    Hll = np.zeros((L, 3, 3))
    np.add.at(Hll, l_, np.einsum("oij,oik->ojk", f(JC), f(JC)))
    ref["Hll"] = Hll
    Hcl = np.zeros((C, L, 6, 3))
    np.add.at(Hcl, (a_, l_), np.einsum("oij,oik->ojk", f(JA), f(JC)))
    np.add.at(Hcl, (b_, l_), np.einsum("oij,oik->ojk", f(JB), f(JC)))
    ref["Hcl"] = Hcl
    Hcc = np.zeros((C, C, 6, 6))
    np.add.at(Hcc, (a_, a_), np.einsum("oij,oik->ojk", f(JA), f(JA)))
    np.add.at(Hcc, (b_, b_), np.einsum("oij,oik->ojk", f(JB), f(JB)))
    ab = np.einsum("oij,oik->ojk", f(JA), f(JB))
    np.add.at(Hcc, (a_, b_), ab)
    np.add.at(Hcc, (b_, a_), np.swapaxes(ab, -1, -2))
    ref["Hcc"] = Hcc.reshape(C * C, 6, 6)
    comp = {}
    for path in ("onehot", "scatter"):
        wba.ASSEMBLY = path

        @jax.jit
        def run(oc, ol, lb, r, JA, JB, JC):
            sel = wba._selectors(oc, ol, lb, C, L)
            return wba._assemble(sel, C, L, r, JA, JB, JC, JA, JB, JC)

        got = run(*(jnp.asarray(x) for x in
                    (obs_cam, obs_lm, lm_base, r, JA, JB, JC)))
        errs = {}
        for name, g in zip(("g_c", "g_l", "Hcc", "Hcl", "Hll"), got):
            g = np.asarray(g, np.float64)
            scale = np.max(np.abs(ref[name]))
            errs[name] = float(np.max(np.abs(g - ref[name])) / scale)
        comp[path] = errs
    wba.ASSEMBLY = None
    out["components_max_rel_err"] = comp
    print(json.dumps({"components_max_rel_err": comp}), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--skip-group", action="store_true")
    ap.add_argument("--components", action="store_true")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from srba_slam_tpu.utils.compile_cache import enable_compile_cache
    from srba_slam_tpu.utils.devinfo import device_info, nvidia_smi_line

    enable_compile_cache()
    import srba_slam_tpu.ops.window_ba as wba
    from srba_slam_tpu.utils.camera import StereoCamera
    from srba_slam_tpu.utils.synthworld import make_ba_window_problem

    cam = StereoCamera.kitti()
    out = {"device": device_info(), "nvidia_smi": nvidia_smi_line(),
           "xla_flags": os.environ.get("XLA_FLAGS", ""),
           "default_path": wba.assembly_path()}
    if args.components:
        _components(wba, out)
    for C, L, O, n_cams, n_lms in BUCKETS:
        win, _gt = make_ba_window_problem(
            cam, np.random.default_rng(7), C=C, L=L, O=O, n_cams=n_cams,
            n_lms=n_lms, pose_noise=0.03, px_noise=0.3)
        rec, poses = {}, {}
        for path in ("onehot", "scatter"):
            rec[path], poses[path] = _solve_times(wba, win, cam, path,
                                                  args.reps)
        rec["max_abs_pose_diff"] = float(
            np.max(np.abs(poses["onehot"] - poses["scatter"])))
        out[f"C{C}_L{L}_O{O}"] = rec
        print(json.dumps({f"C{C}_L{L}_O{O}": rec}), flush=True)
    wba.ASSEMBLY = None
    wba.optimize_window.clear_cache()

    if not args.skip_group:
        C, L, O, n_cams, _ = BUCKETS[0]
        packed = []
        for i in range(wba.WINDOW_SLOTS):
            w, _ = make_ba_window_problem(
                cam, np.random.default_rng(100 + i), C=C, L=L, O=O,
                n_cams=6 + i, n_lms=240 + 9 * i, px_noise=0.3)
            packed.append(wba.pack_window(*(np.asarray(a) for a in w)))
        kw = dict(kernel_param=1.5, max_iters=8, stage1_iters=2)
        group = {}
        for path, limit in (("vmap", 10 ** 12), ("scan", 0)):
            wba._VMAP_LO_LIMIT = limit
            wba.optimize_windows_batch_blob.clear_cache()
            for fill in (2, 4, 8):
                ints = np.stack([packed[i % fill][0]
                                 for i in range(wba.WINDOW_SLOTS)])
                floats = np.stack([packed[i % fill][1]
                                   for i in range(wba.WINDOW_SLOTS)])
                valids = np.arange(wba.WINDOW_SLOTS) < fill
                a = (jnp.asarray(ints), jnp.asarray(floats),
                     jnp.asarray(valids))
                jax.block_until_ready(wba.optimize_windows_batch_blob(
                    *a, C, L, O, cam, **kw))
                ts = []
                for _ in range(args.reps):
                    t0 = time.perf_counter()
                    jax.block_until_ready(wba.optimize_windows_batch_blob(
                        *a, C, L, O, cam, **kw))
                    ts.append(time.perf_counter() - t0)
                group[f"{path}_fill{fill}_ms"] = min(ts) * 1e3
        out["group_C16_L1024_O2048"] = group
    print(json.dumps(out))


if __name__ == "__main__":
    main()

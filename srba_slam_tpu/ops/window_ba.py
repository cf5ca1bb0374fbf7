"""Windowed stereo bundle adjustment: LM + Schur over landmarks + Cholesky.

Device-side core of the SRBA backend (≙ the solver the reference configures:
LM with Schur complement over landmarks and dense Cholesky —
``srba::options::solver_LM_schur_dense_cholesky``, reference
src/srba-stereo-slam.h:34 — run over the ≤ max_optimize_depth window on each
keyframe insertion, src/CSRBAStereoSLAMEstimator.cpp:782-784).

Parameterization: window keyframes carry poses Q_c relative to the window
root (root frozen, fixed gauge); landmarks live in their base keyframe's
frame (the SRBA relative-landmark parameterization). Everything is padded to
static capacities (C cams, L landmarks, O observations) and masked, so one
XLA program serves every window.

Per LM iteration: batched analytic Jacobians for all observations at once,
block-Hessian assembly (one-hot matmul contractions on accelerators,
scatter-adds on the CPU — see assembly_path), closed-form 3x3 landmark-block
inverses, Schur reduction via two einsums, one dense Cholesky solve of the
6C camera system, masked accept/reject with adaptive damping.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from srba_slam_tpu.utils import se3
from srba_slam_tpu.utils.camera import StereoCamera

_HI = jax.lax.Precision.HIGHEST


class BAWindow(NamedTuple):
    """Padded window problem. C/L/O are static capacities."""

    cam_pose: jax.Array   # f32 [C, 6] pose of each window KF in ROOT frame (Q_c)
    cam_valid: jax.Array  # bool [C]; entry 0 is the root (always frozen)
    lm_pos: jax.Array     # f32 [L, 3] landmark in its base KF frame
    lm_base: jax.Array    # int32 [L] window-local index of the base KF
    lm_valid: jax.Array   # bool [L]
    obs_cam: jax.Array    # int32 [O] window-local observing KF
    obs_lm: jax.Array     # int32 [O] window-local landmark index
    obs_px: jax.Array     # f32 [O, 3] (ul, vl, ur)
    obs_valid: jax.Array  # bool [O]


def pack_window(cam_pose, cam_valid, lm_pos, lm_base, lm_valid,
                obs_cam, obs_lm, obs_px, obs_valid):
    """Host-side packing of a window into TWO arrays (one int32, one f32) so
    building a window costs two uploads instead of nine."""
    import numpy as np

    ints = np.concatenate([
        lm_base.astype(np.int32), obs_cam.astype(np.int32),
        obs_lm.astype(np.int32), cam_valid.astype(np.int32),
        lm_valid.astype(np.int32), obs_valid.astype(np.int32),
    ])
    floats = np.concatenate([
        cam_pose.astype(np.float32).ravel(), lm_pos.astype(np.float32).ravel(),
        obs_px.astype(np.float32).ravel(),
    ])
    return ints, floats


def unpack_window(ints: jax.Array, floats: jax.Array, C: int, L: int, O: int
                  ) -> BAWindow:
    """Traced inverse of pack_window (static capacities -> static slices)."""
    o = 0
    lm_base = ints[o:o + L]; o += L
    obs_cam = ints[o:o + O]; o += O
    obs_lm = ints[o:o + O]; o += O
    cam_valid = ints[o:o + C].astype(bool); o += C
    lm_valid = ints[o:o + L].astype(bool); o += L
    obs_valid = ints[o:o + O].astype(bool)
    f = 0
    cam_pose = floats[f:f + C * 6].reshape(C, 6); f += C * 6
    lm_pos = floats[f:f + L * 3].reshape(L, 3); f += L * 3
    obs_px = floats[f:f + O * 3].reshape(O, 3)
    return BAWindow(cam_pose, cam_valid, lm_pos, lm_base, lm_valid,
                    obs_cam, obs_lm, obs_px, obs_valid)


class BAResult(NamedTuple):
    cam_pose: jax.Array   # optimized [C, 6]
    lm_pos: jax.Array     # optimized [L, 3]
    cost_init: jax.Array  # robust total cost before
    cost_final: jax.Array
    obs_rmse: jax.Array   # raw pixel RMSE over valid obs after
    iters: jax.Array
    obs_rmse_stg1: jax.Array  # raw pixel RMSE after the pose-only stage 1
    # (≙ optimize_results_stg1.obs_rmse, reference .cpp:790); equals the
    # init RMSE when stage 1 is disabled (stage1_iters=0)


def _project_residuals(cam_pose, lm_pos, lm_base, obs_cam, obs_lm, obs_px,
                       cam: StereoCamera, eps=1e-6):
    """Residuals + everything needed for Jacobians, batched over O."""
    Q_R, Q_t = se3.exp(cam_pose)                     # [C,3,3], [C,3]
    Xw = (
        jnp.einsum("lij,lj->li", Q_R[lm_base], lm_pos, precision=_HI)
        + Q_t[lm_base]
    )                                                # [L,3] in root frame
    Rc = Q_R[obs_cam]                                # [O,3,3]
    tc = Q_t[obs_cam]
    X = Xw[obs_lm]                                   # [O,3]
    x = jnp.einsum("oji,oj->oi", Rc, X - tc, precision=_HI)  # R^T (X - t)
    Xc, Yc, Zc = x[..., 0], x[..., 1], x[..., 2]
    zi = 1.0 / jnp.maximum(Zc, eps)
    ul = cam.cx_l + cam.fx_l * Xc * zi
    vl = cam.cy_l + cam.fy_l * Yc * zi
    ur = cam.cx_r + cam.fx_r * (Xc - cam.baseline) * zi
    r = jnp.stack([ul, vl, ur], axis=-1) - obs_px
    return r, x, X, Rc, Q_R


def _dproj(x, cam: StereoCamera, eps=1e-6):
    X, Y, Z = x[..., 0], x[..., 1], x[..., 2]
    zi = 1.0 / jnp.maximum(Z, eps)
    zi2 = zi * zi
    zeros = jnp.zeros_like(X)
    return jnp.stack(
        [
            jnp.stack([cam.fx_l * zi, zeros, -cam.fx_l * X * zi2], axis=-1),
            jnp.stack([zeros, cam.fy_l * zi, -cam.fy_l * Y * zi2], axis=-1),
            jnp.stack([cam.fx_r * zi, zeros, -cam.fx_r * (X - cam.baseline) * zi2], axis=-1),
        ],
        axis=-2,
    )  # [O,3,3]


def _inv3x3(A: jax.Array, damp: float = 1e-8) -> jax.Array:
    """Batched closed-form 3x3 inverse with tiny Tikhonov guard."""
    A = A + damp * jnp.eye(3, dtype=A.dtype)
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    co00 = e * i - f * h
    co01 = c * h - b * i
    co02 = b * f - c * e
    co10 = f * g - d * i
    co11 = a * i - c * g
    co12 = c * d - a * f
    co20 = d * h - e * g
    co21 = b * g - a * h
    co22 = a * e - b * d
    det = a * co00 + b * co10 + c * co20
    inv_det = 1.0 / jnp.where(jnp.abs(det) < 1e-12, 1e-12, det)
    adj = jnp.stack(
        [
            jnp.stack([co00, co01, co02], axis=-1),
            jnp.stack([co10, co11, co12], axis=-1),
            jnp.stack([co20, co21, co22], axis=-1),
        ],
        axis=-2,
    )
    return adj * inv_det[..., None, None]


def _split_matmul(oh: jax.Array, data: jax.Array) -> jax.Array:
    """[N, O] x [O, M] contraction where ``oh`` is an exact-in-bf16 0/1
    matrix (stored bf16: half the bytes per read — these reads dominate
    the LM iteration at the big window buckets). ``data`` is split into a
    bf16 high part and a bf16 residual, so two bf16 matmuls with f32
    accumulation keep ~16 mantissa bits (relative error ~1e-5) on the
    tensor cores.

    The high part is cut by masking the low 16 bits of each f32 (exact in
    bf16), not by an f32 -> bf16 -> f32 round trip: XLA on the GPU treats
    such a round trip as removable excess precision, which zeroed the
    residual and left only bf16 accuracy (2e-3 relative; the Schur system
    then never produced an accepted LM step)."""
    bits = jax.lax.bitcast_convert_type(data, jnp.uint32)
    hi32 = jax.lax.bitcast_convert_type(bits & jnp.uint32(0xFFFF0000),
                                        jnp.float32)
    hi = hi32.astype(jnp.bfloat16)                  # exact
    lo = (data - hi32).astype(jnp.bfloat16)
    return (
        jax.lax.dot(oh, hi, preferred_element_type=jnp.float32)
        + jax.lax.dot(oh, lo, preferred_element_type=jnp.float32)
    )


ASSEMBLY: str | None = None  # "onehot" | "scatter"; None = assembly_path()
# picks by backend. Read at trace time: after changing it, clear the jit
# caches of the optimize_* programs.


def assembly_path() -> str:
    """Block-Hessian assembly of the LM iteration: ``"onehot"`` (matmul
    contractions against one-hot selectors) or ``"scatter"`` (scatter-adds
    over the observation indices).

    On the GPU a float scatter-add lowers to atomics whose summation order
    changes from run to run, so two solves of the same window differ in the
    last bits and keyframe decisions are no longer reproducible;
    ``--xla_gpu_deterministic_ops`` fixes the order but costs ~400x. The
    one-hot contractions are bit-reproducible. Measured on one H100 80GB
    HBM3 (400 W limit, tools/group_solve_probe.py, one optimize_window
    solve, min of 5): C=16/L=1024/O=2048 one-hot 8.5 ms vs scatter 3.1 ms;
    C=32/L=8192/O=16384 one-hot 20.5 ms vs scatter 7.5 ms (and 1.5 s /
    13.2 s for scatter with the determinism flag, at 700 W). The GPU takes
    the reproducible path at ~2.8x the scatter's time. On the CPU a
    scatter-add is deterministic and far cheaper than the O x L x C*18
    matmul FLOPs, so the CPU keeps it."""
    if ASSEMBLY is not None:
        return ASSEMBLY
    return "scatter" if jax.default_backend() == "cpu" else "onehot"


class _Selectors(NamedTuple):
    """Loop-invariant observation indices of one window (and, on the
    one-hot path, their one-hot selectors, hoisted out of the LM loop)."""

    cam_a: jax.Array         # int32 [O] observing KF
    cam_b: jax.Array         # int32 [O] base KF of the observed landmark
    lm_i: jax.Array          # int32 [O] observed landmark
    oh_a: jax.Array | None   # f32 [O, C] one-hot of cam_a
    oh_b: jax.Array | None   # f32 [O, C] one-hot of cam_b
    oh_lT: jax.Array | None  # bf16 [L, O] one-hot of lm_i, transposed


def _selectors(obs_cam, obs_lm, lm_base, C: int, L: int) -> _Selectors:
    cam_b = lm_base[obs_lm]
    if assembly_path() != "onehot":
        return _Selectors(obs_cam, cam_b, obs_lm, None, None, None)
    # the big [L, O] selector is stored bf16 (0/1 exact): its repeated
    # reads are the iteration's main memory traffic at large buckets
    oh_a = (obs_cam[:, None] == jnp.arange(C)[None, :]).astype(jnp.float32)
    oh_b = (cam_b[:, None] == jnp.arange(C)[None, :]).astype(jnp.float32)
    oh_lT = (obs_lm[None, :] == jnp.arange(L)[:, None]).astype(jnp.bfloat16)
    oh_a, oh_b, oh_lT = jax.lax.optimization_barrier((oh_a, oh_b, oh_lT))
    return _Selectors(obs_cam, cam_b, obs_lm, oh_a, oh_b, oh_lT)


def _assemble(sel: _Selectors, C: int, L: int, r, wJA, wJB, wJC, JA, JB, JC,
              skip_lms: bool = False):
    """Block gradient and Hessian of one LM iteration:
    (g_c [C,6], g_l [L,3], Hcc [C*C,6,6], Hcl [C,L,6,3], Hll [L,3,3]).

    ``sel.oh_a is None`` selects scatter-adds over the observation indices;
    otherwise every sum is a contraction with the one-hot selectors.
    ``skip_lms=True`` (the pose-only stage 1) skips every landmark-side
    block — the [L, O] contractions are the bulk of the iteration cost and
    stage 1 never reads them."""
    rA = jnp.einsum("oij,oi->oj", wJA, r, precision=_HI)   # [O,6]
    rB = jnp.einsum("oij,oi->oj", wJB, r, precision=_HI)
    aa = jnp.einsum("oij,oik->ojk", wJA, JA, precision=_HI)
    bb = jnp.einsum("oij,oik->ojk", wJB, JB, precision=_HI)
    ab = jnp.einsum("oij,oik->ojk", wJA, JB, precision=_HI)
    rC = jnp.einsum("oij,oi->oj", wJC, r, precision=_HI)   # [O,3]
    ac = jnp.einsum("oij,oik->ojk", wJA, JC, precision=_HI)
    bc = jnp.einsum("oij,oik->ojk", wJB, JC, precision=_HI)
    cc = jnp.einsum("oij,oik->ojk", wJC, JC, precision=_HI)
    a_, b_, l_ = sel.cam_a, sel.cam_b, sel.lm_i
    if sel.oh_a is None:
        g_c = jnp.zeros((C, 6), jnp.float32).at[a_].add(rA).at[b_].add(rB)
        Hcc = jnp.zeros((C * C, 6, 6), jnp.float32)
        Hcc = Hcc.at[a_ * C + a_].add(aa)
        Hcc = Hcc.at[b_ * C + b_].add(bb)
        Hcc = Hcc.at[a_ * C + b_].add(ab)
        Hcc = Hcc.at[b_ * C + a_].add(jnp.swapaxes(ab, -1, -2))
        if skip_lms:
            return g_c, None, Hcc, None, None
        g_l = jnp.zeros((L, 3), jnp.float32).at[l_].add(rC)
        Hcl = jnp.zeros((C * L, 6, 3), jnp.float32)
        Hcl = Hcl.at[a_ * L + l_].add(ac)
        Hcl = Hcl.at[b_ * L + l_].add(bc)
        Hcl = Hcl.reshape(C, L, 6, 3)
        Hll = jnp.zeros((L, 3, 3), jnp.float32).at[l_].add(cc)
        return g_c, g_l, Hcc, Hcl, Hll
    oh_a, oh_b = sel.oh_a, sel.oh_b
    g_c = (jnp.einsum("oc,oj->cj", oh_a, rA, precision=_HI)
           + jnp.einsum("oc,oj->cj", oh_b, rB, precision=_HI))
    Hcc = (
        jnp.einsum("oc,od,om->cdm", oh_a, oh_a, aa.reshape(-1, 36),
                   precision=_HI)
        + jnp.einsum("oc,od,om->cdm", oh_b, oh_b, bb.reshape(-1, 36),
                     precision=_HI)
    ).reshape(C, C, 6, 6)
    Hab = jnp.einsum("oc,od,om->cdm", oh_a, oh_b, ab.reshape(-1, 36),
                     precision=_HI).reshape(C, C, 6, 6)
    Hcc = Hcc + Hab + jnp.swapaxes(Hab.transpose(1, 0, 2, 3), -1, -2)
    Hcc = Hcc.reshape(C * C, 6, 6)
    if skip_lms:
        return g_c, None, Hcc, None, None
    # every landmark-side sum rides ONE [L, O] x [O, 12 + C*18] split-bf16
    # matmul (g_l | Hll | Hcl fused: the selector reads dominate, so read
    # it twice total instead of six times)
    acm = (oh_a[:, :, None] * ac.reshape(-1, 1, 18)
           + oh_b[:, :, None] * bc.reshape(-1, 1, 18)).reshape(-1, C * 18)
    data = jnp.concatenate([rC, cc.reshape(-1, 9), acm], axis=-1)
    out = _split_matmul(sel.oh_lT, data)          # [L, 12 + C*18]
    g_l = out[:, :3]
    Hll = out[:, 3:12].reshape(L, 3, 3)
    Hcl = jnp.swapaxes(out[:, 12:].reshape(L, C, 6, 3), 0, 1)
    return g_c, g_l, Hcc, Hcl, Hll


def _robust_cost(r, w_valid, kernel_param, use_kernel):
    rsq = jnp.sum(r * r, axis=-1)
    b2 = kernel_param * kernel_param
    rho = jnp.where(use_kernel, 2.0 * b2 * (jnp.sqrt(1.0 + rsq / b2) - 1.0), rsq)
    return jnp.sum(rho * w_valid)


@functools.partial(
    jax.jit, static_argnames=("C", "L", "O", "max_iters", "use_kernel",
                              "stage1_iters", "use_kernel_stage1")
)
def optimize_window_packed(
    ints: jax.Array, floats: jax.Array, C: int, L: int, O: int,
    cam: StereoCamera, kernel_param: float = 1.5, max_iters: int = 12,
    use_kernel: bool = True,
    w_prior_rot: float = 1000.0, w_prior_trans: float = 100.0,
    stage1_iters: int = 0, use_kernel_stage1: bool = True,
) -> BAResult:
    """optimize_window with the two-blob input layout (see pack_window)."""
    win = unpack_window(ints, floats, C, L, O)
    return _optimize_window_impl(win, cam, kernel_param, max_iters,
                                 use_kernel, 1e-4, w_prior_rot, w_prior_trans,
                                 stage1_iters, use_kernel_stage1)


@functools.partial(
    jax.jit, static_argnames=("C", "L", "O", "max_iters", "use_kernel",
                              "stage1_iters", "use_kernel_stage1")
)
def optimize_window_packed_blob(
    ints: jax.Array, floats: jax.Array, C: int, L: int, O: int,
    cam: StereoCamera, kernel_param: float = 1.5, max_iters: int = 12,
    use_kernel: bool = True,
    w_prior_rot: float = 1000.0, w_prior_trans: float = 100.0,
    stage1_iters: int = 0, use_kernel_stage1: bool = True,
) -> jax.Array:
    """optimize_window_packed returning ONE f32 blob
    ``[cam_pose (C*6) | lm_pos (L*3) | cost_init cost_final rmse rmse_stg1]``
    — the engine's deferred solves travel as a single buffer (unpacked host-side in
    SRBAEngine._commit_one)."""
    r = optimize_window_packed(
        ints, floats, C, L, O, cam, kernel_param=kernel_param,
        max_iters=max_iters, use_kernel=use_kernel,
        w_prior_rot=w_prior_rot, w_prior_trans=w_prior_trans,
        stage1_iters=stage1_iters, use_kernel_stage1=use_kernel_stage1,
    )
    return jnp.concatenate([
        r.cam_pose.ravel(), r.lm_pos.ravel(),
        jnp.stack([r.cost_init, r.cost_final, r.obs_rmse, r.obs_rmse_stg1]),
    ])


WINDOW_SLOTS = 8  # fixed group size of the batched window-solve program:
# one compiled program per (C, L, O) bucket regardless of how many solves a
# resolution queues (padded slots skip via lax.cond)

# Group-path selector: windows whose [L, O] selector is <= this limit run
# VMAPPED (all WINDOW_SLOTS lanes, padded ones included); larger buckets run
# a serial lax.scan with lax.cond SKIPPING invalid slots. Default 0 = always
# scan. On one H100 (400 W limit, tools/group_solve_probe.py, bucket
# C=16/L=1024/O=2048, min of 5) the vmapped group took 10.9/10.9/10.4 ms at
# fills 2/4/8 against the scan's 12.2/23.2/44.1 ms: a lone window leaves the
# card mostly idle. Flipping the default is a speed change for a benchmark
# cell to confirm end to end (ROADMAP Queue 1 #4.4).
_VMAP_LO_LIMIT = 0


@functools.partial(
    jax.jit, static_argnames=("C", "L", "O", "max_iters", "use_kernel",
                              "stage1_iters", "use_kernel_stage1")
)
def optimize_windows_batch_blob(
    ints: jax.Array,      # [WINDOW_SLOTS, ni] stacked pack_window ints
    floats: jax.Array,    # [WINDOW_SLOTS, nf] stacked pack_window floats
    valids: jax.Array,    # [WINDOW_SLOTS] bool
    C: int, L: int, O: int,
    cam: StereoCamera, kernel_param: float = 1.5, max_iters: int = 12,
    use_kernel: bool = True,
    w_prior_rot: float = 1000.0, w_prior_trans: float = 100.0,
    stage1_iters: int = 0, use_kernel_stage1: bool = True,
) -> jax.Array:
    """Up to WINDOW_SLOTS queued window solves in ONE dispatch (one jitted
    call per group instead of per solve).

    Two paths (chosen by ``_VMAP_LO_LIMIT``, see its comment for the H100
    measurements): a serial lax.scan whose lax.cond SKIPS invalid slots
    (default), and a vmapped variant that runs all lanes in max(iters_i)
    lock-step LM iterations.
    Callers pad invalid slots with a COPY of a valid window (benign
    through the vmapped solve); either path zeroes invalid output rows.
    Returns [WINDOW_SLOTS, C*6 + L*3 + 4] blobs (same row layout as
    optimize_window_packed_blob)."""
    blob_len = C * 6 + L * 3 + 4

    def one(ints_g, floats_g):
        win = unpack_window(ints_g, floats_g, C, L, O)
        r = _optimize_window_impl(
            win, cam, kernel_param, max_iters, use_kernel, 1e-4,
            w_prior_rot, w_prior_trans, stage1_iters, use_kernel_stage1)
        return jnp.concatenate([
            r.cam_pose.ravel(), r.lm_pos.ravel(),
            jnp.stack([r.cost_init, r.cost_final, r.obs_rmse,
                       r.obs_rmse_stg1])])

    if L * O <= _VMAP_LO_LIMIT:
        blobs = jax.vmap(one)(ints, floats)
        return jnp.where(valids[:, None], blobs, jnp.float32(0.0))

    def body(carry, xs):
        ints_g, floats_g, valid = xs
        return carry, jax.lax.cond(
            valid, lambda _: one(ints_g, floats_g),
            lambda _: jnp.zeros(blob_len, jnp.float32), None)

    _, blobs = jax.lax.scan(body, None, (ints, floats, valids))
    return blobs


def shard_window_obs(win: BAWindow, mesh, axis: str = "obs") -> BAWindow:
    """Lay a window out for MESH-PARALLEL optimization: the observation
    arrays (the FLOP-heavy axis — every LM iteration contracts O x {C, L}
    one-hot matmuls over it) are sharded across ``mesh``'s ``axis``; the
    small camera/landmark state replicates. Passing the result to
    :func:`optimize_window` compiles an SPMD program where each device
    assembles its observation shard's Hessian/gradient contribution and
    XLA inserts the cross-device psums; the tiny Schur/Cholesky solve
    replicates. O must be divisible by the mesh axis size (window
    capacities are powers of two).

    This is the intra-step scale-out the reference cannot express (it is
    single-threaded C++): one SLAM sequence's bundle adjustment spread
    over several devices instead of one.
    """
    from jax.sharding import NamedSharding, PartitionSpec

    repl = NamedSharding(mesh, PartitionSpec())
    obs = NamedSharding(mesh, PartitionSpec(axis))
    sh = BAWindow(cam_pose=repl, cam_valid=repl, lm_pos=repl, lm_base=repl,
                  lm_valid=repl, obs_cam=obs, obs_lm=obs, obs_px=obs,
                  obs_valid=obs)
    return jax.device_put(win, sh)


@functools.partial(jax.jit, static_argnames=("max_iters", "use_kernel",
                                             "stage1_iters",
                                             "use_kernel_stage1"))
def optimize_window(
    win: BAWindow,
    cam: StereoCamera,
    kernel_param: float = 1.5,
    max_iters: int = 12,
    use_kernel: bool = True,
    init_lambda: float = 1e-4,
    w_prior_rot: float = 1000.0,
    w_prior_trans: float = 100.0,
    stage1_iters: int = 0,
    use_kernel_stage1: bool = True,
) -> BAResult:
    return _optimize_window_impl(win, cam, kernel_param, max_iters,
                                 use_kernel, init_lambda, w_prior_rot,
                                 w_prior_trans, stage1_iters,
                                 use_kernel_stage1)


def _optimize_window_impl(
    win: BAWindow,
    cam: StereoCamera,
    kernel_param: float,
    max_iters: int,
    use_kernel: bool,
    init_lambda: float,
    w_prior_rot=1000.0,
    w_prior_trans=100.0,
    stage1_iters: int = 0,
    use_kernel_stage1: bool = True,
) -> BAResult:
    C = win.cam_pose.shape[0]
    kernel_param = jnp.asarray(kernel_param, jnp.float32)
    obs_w = win.obs_valid.astype(jnp.float32)
    lm_w = win.lm_valid.astype(jnp.float32)

    # camera freeze mask: root (index 0) and invalid cams are fixed
    free_cam = win.cam_valid & (jnp.arange(C) != 0)          # [C]
    free6 = jnp.repeat(free_cam, 6)                           # [6C]

    # Pose prior anchoring every free camera to its spanning-tree INIT pose
    # (a cheap proxy for the information of all observations OUTSIDE this
    # window). Without it the older cameras in a window are bound to the new
    # keyframe only through the handful of cross-keyframe observations: a
    # small contaminated consensus in those (e.g. perceptually aliased
    # matches that passed every DA filter) can FOLD the established map
    # meters away while the robust kernel writes the true matches off as
    # outliers. The prior makes such a fold cost ~(d/sigma)^2 while leaving
    # centimeter refinements (and loop closures — whose window INIT already
    # composes through the fresh closure edge, so the anchor is the
    # reconciled geometry) essentially free. Units: twist rad / meters.
    # Weights are SRBAParams.anchor_prior_w_rot/_trans (defaults: sigma ~
    # 0.03 rad / ~0.1 m of unexplained drift per window); 0 disables. NOTE:
    # this prior is a deliberate deviation from the reference SRBA objective
    # (which has no such term) — see tests/test_window_ba.py for the
    # focused fold-blocked / loop-closure-free assertions.
    W_PRIOR_R = jnp.asarray(w_prior_rot, jnp.float32)
    W_PRIOR_T = jnp.asarray(w_prior_trans, jnp.float32)
    init_R, init_t = se3.exp(win.cam_pose)                   # [C,3,3], [C,3]

    def prior_residual(cam_pose):
        """Left-multiplicative twist from init to current, per camera."""
        Rq, tq = se3.exp(cam_pose)
        dR = jnp.einsum("cij,ckj->cik", Rq, init_R, precision=_HI)
        w = jax.vmap(se3.so3_log)(dR)                        # [C,3]
        dt = tq - jnp.einsum("cij,cj->ci", dR, init_t, precision=_HI)
        return w, dt

    def prior_cost(cam_pose):
        w, dt = prior_residual(cam_pose)
        m = free_cam.astype(jnp.float32)
        return jnp.sum(m * (W_PRIOR_R * jnp.sum(w * w, -1)
                            + W_PRIOR_T * jnp.sum(dt * dt, -1)))

    def cost_of(cam_pose, lm_pos, kern=use_kernel):
        r, *_ = _project_residuals(cam_pose, lm_pos, win.lm_base, win.obs_cam,
                                   win.obs_lm, win.obs_px, cam)
        return _robust_cost(r, obs_w, kernel_param, kern) \
            + prior_cost(cam_pose)

    def rmse_of(cam_pose, lm_pos):
        r, *_ = _project_residuals(cam_pose, lm_pos, win.lm_base, win.obs_cam,
                                   win.obs_lm, win.obs_px, cam)
        n_obs = jnp.maximum(jnp.sum(obs_w), 1.0)
        return jnp.sqrt(jnp.sum(jnp.sum(r * r, -1) * obs_w) / n_obs)

    cost0 = cost_of(win.cam_pose, win.lm_pos)

    L_n = win.lm_pos.shape[0]
    sel = _selectors(win.obs_cam, win.obs_lm, win.lm_base, C, L_n)

    def lm_step(cam_pose, lm_pos, lam, kern=use_kernel, freeze_lms=False):
        r, x, X, Rc, Q_R = _project_residuals(
            cam_pose, lm_pos, win.lm_base, win.obs_cam, win.obs_lm, win.obs_px, cam
        )
        P = _dproj(x, cam)                                    # [O,3,3]
        rnorm = jnp.linalg.norm(r, axis=-1)
        w_rob = jnp.where(
            kern, 1.0 / jnp.sqrt(1.0 + (rnorm / kernel_param) ** 2), 1.0
        )
        w = w_rob * obs_w                                     # [O]

        RcT = jnp.swapaxes(Rc, -1, -2)
        # dx/d(base twist) = R_c^T [ -[X]x | I ];  dx/d(cam twist) = -that
        hatX = se3.hat(X)                                     # [O,3,3]
        dB_rot = jnp.einsum("oij,ojk->oik", RcT, -hatX, precision=_HI)
        dB = jnp.concatenate([dB_rot, RcT], axis=-1)          # [O,3,6]
        JB = jnp.einsum("oij,ojk->oik", P, dB, precision=_HI)  # base-KF block
        JA = -JB                                               # observing-KF block
        # dx/dp = R_c^T R_base
        Rb = Q_R[win.lm_base][win.obs_lm]                     # [O,3,3]
        dP = jnp.einsum("oij,ojk->oik", RcT, Rb, precision=_HI)
        JC = jnp.einsum("oij,ojk->oik", P, dP, precision=_HI)  # [O,3,3]

        wJA = JA * w[:, None, None]
        wJB = JB * w[:, None, None]
        wJC = JC * w[:, None, None]

        g_c, g_l, Hcc, Hcl, Hll = _assemble(sel, C, L_n, r, wJA, wJB, wJC,
                                            JA, JB, JC, skip_lms=freeze_lms)
        # init-anchor prior: residual is the left twist from init; its
        # Jacobian wrt the left-multiplicative step is ~identity
        pw, pdt = prior_residual(cam_pose)
        prior_w6 = jnp.concatenate([jnp.full((3,), W_PRIOR_R, jnp.float32),
                                    jnp.full((3,), W_PRIOR_T, jnp.float32)])
        g_c = g_c + jnp.concatenate([pw, pdt], -1) * prior_w6[None, :]
        diag_idx = jnp.arange(C) * C + jnp.arange(C)
        Hcc = Hcc.at[diag_idx].add(
            prior_w6[None, :, None] * jnp.eye(6)[None, :, :])
        if freeze_lms:
            # stage 1 (pose-only): landmarks held at their current
            # estimates, so the camera system is plain Hcc (no Schur
            # reduction — that would assume the landmarks re-optimize)
            S = Hcc.reshape(C, C, 6, 6)
            rhs = g_c
        else:
            # LM damping + keep padded landmarks fully determined
            Hll = Hll + (lam + 1e-6) * jnp.eye(3)[None]
            Hll = jnp.where(lm_w[:, None, None] > 0, Hll, jnp.eye(3)[None])
            g_l = g_l * lm_w[:, None]

            Hll_inv = _inv3x3(Hll)
            W = jnp.einsum("clij,ljk->clik", Hcl, Hll_inv,
                           precision=_HI)  # [C,L,6,3]
            # Schur: S = Hcc - W Hcl^T ; rhs = g_c - W g_l
            S = Hcc.reshape(C, C, 6, 6) - jnp.einsum(
                "clij,dlkj->cdik", W, Hcl, precision=_HI
            )
            rhs = g_c - jnp.einsum("clij,lj->ci", W, g_l, precision=_HI)

        # dense 6C system with gauge/invalid freezing
        S = S.transpose(0, 2, 1, 3).reshape(C * 6, C * 6)
        S = S + lam * jnp.diag(jnp.diag(S)) + 1e-8 * jnp.eye(C * 6)
        rhs_f = rhs.reshape(C * 6)
        S = jnp.where(free6[:, None] & free6[None, :], S, 0.0)
        S = S + jnp.diag(jnp.where(free6, 0.0, 1.0))
        rhs_f = jnp.where(free6, rhs_f, 0.0)
        Lchol = jnp.linalg.cholesky(S)
        dc = -jax.scipy.linalg.cho_solve((Lchol, True), rhs_f)
        ok = jnp.all(jnp.isfinite(dc))
        dc = jnp.where(ok, dc, 0.0).reshape(C, 6)

        # predicted decrease of the local quadratic model: ~0 at convergence
        # (drives the early loop exit — re-solving an already-optimal window
        # used to burn the full reject budget changing nothing)
        pred = -jnp.sum(dc.reshape(-1) * rhs_f)
        if freeze_lms:
            dl = jnp.zeros_like(lm_pos)
        else:
            # back-substitute landmarks
            corr = jnp.einsum("clij,ci->lj", Hcl, dc, precision=_HI)
            dl = -jnp.einsum("lij,lj->li", Hll_inv, g_l + corr, precision=_HI)
            dl = dl * lm_w[:, None]
            pred = pred - jnp.sum(dl * g_l)

        # apply (left-multiplicative twist on cam poses)
        dR = se3.so3_exp(dc[:, :3])
        Rq, tq = se3.exp(cam_pose)
        R_new = jnp.einsum("cij,cjk->cik", dR, Rq, precision=_HI)
        t_new = jnp.einsum("cij,cj->ci", dR, tq, precision=_HI) + dc[:, 3:]
        cam_new = se3.log(R_new, t_new)
        cam_new = jnp.where(free_cam[:, None], cam_new, cam_pose)
        lm_new = lm_pos + dl
        return cam_new, lm_new, ok, pred

    def make_loop(n_iters, kern, freeze_lms):
        def cond(carry):
            _cam, _lm, _cost, _lam, _iters, it, stall, rejects = carry
            # stop early once ACCEPTED steps stop improving the cost
            # meaningfully (sub-1e-6 relative decreases), or once a long
            # unbroken streak of rejected steps shows the damping escalation
            # is hopeless. Rejected steps alone must NOT count toward the
            # convergence stall: a far initialization (loop-closure windows)
            # can need several rejections while lambda climbs before the
            # first accepted step.
            return (it < n_iters) & (stall < 3) & (rejects < 6)

        def body(carry):
            cam_pose, lm_pos, cost, lam, iters, it, stall, rejects = carry
            cam_new, lm_new, ok, pred = lm_step(cam_pose, lm_pos, lam, kern,
                                                freeze_lms)
            new_cost = cost_of(cam_new, lm_new, kern)
            accept = ok & (new_cost < cost)
            improving = accept & (cost - new_cost > 1e-6 * cost)
            # quadratic-model convergence: a vanishing predicted decrease
            # means no step (at ANY damping) can materially improve — stop
            # now instead of burning the reject budget on a solved window
            converged = ok & (jnp.abs(pred) < 1e-8 * (cost + 1.0))
            stall = jnp.where(improving, 0,
                              jnp.where(accept, stall + 1, stall))
            stall = jnp.where(converged, 3, stall)
            rejects = jnp.where(accept, 0, rejects + 1)
            cam_pose = jnp.where(accept, cam_new, cam_pose)
            lm_pos = jnp.where(accept, lm_new, lm_pos)
            cost = jnp.where(accept, new_cost, cost)
            lam = jnp.where(accept, jnp.maximum(lam * 0.4, 1e-7),
                            jnp.minimum(lam * 6.0, 1e3))
            return (cam_pose, lm_pos, cost, lam,
                    iters + accept.astype(jnp.int32), it + 1, stall, rejects)

        return cond, body

    def run_loop(cam_pose, lm_pos, n_iters, kern, freeze_lms):
        cond, body = make_loop(n_iters, kern, freeze_lms)
        cost_in = cost_of(cam_pose, lm_pos, kern)
        out = jax.lax.while_loop(
            cond, body,
            (cam_pose, lm_pos, cost_in, jnp.float32(init_lambda),
             jnp.asarray(0, jnp.int32), jnp.asarray(0, jnp.int32),
             jnp.asarray(0, jnp.int32), jnp.asarray(0, jnp.int32)),
        )
        return out[0], out[1], out[4]

    cam_pose, lm_pos = win.cam_pose, win.lm_pos
    if stage1_iters > 0:
        # stage 1 (≙ SRBA's first optimization pass over the NEW kf2kf
        # edges, kernel flag use_robust_kernel_stage1 — reference
        # .cpp:1159, utils.h:276): pose-only refinement with the landmarks
        # held, before the full window BA below
        cam_pose, lm_pos, _ = run_loop(cam_pose, lm_pos, stage1_iters,
                                       use_kernel_stage1, True)
    rmse_stg1 = rmse_of(cam_pose, lm_pos)
    cam_pose, lm_pos, iters = run_loop(cam_pose, lm_pos, max_iters,
                                       use_kernel, False)
    cost = cost_of(cam_pose, lm_pos)
    rmse = rmse_of(cam_pose, lm_pos)
    return BAResult(cam_pose, lm_pos, cost0, cost, rmse, iters, rmse_stg1)

"""Robust Gauss-Newton / Levenberg-Marquardt SE(3) pose estimation.

Equivalent of the stereo-vo engine's least-squares pose solver
(the ``getChangeInPose`` / ``processNewImagePair`` contract, reference
src/CSRBAStereoSLAMEstimator.cpp:2139-2177 and the LEAST_SQUARES config
section of demo/config_imgdir_kitti_srba.ini): estimate the rigid transform
taking 3D points expressed in a previous camera frame onto their observed
stereo pixels (ul, vl, ur) in the current frame, with a pseudo-Huber kernel
and residual-based outlier rejection.

Design: everything is fixed-shape and mask-driven. One jitted program runs a
bounded ``fori_loop`` of damped Gauss-Newton steps (updates freeze once the
step modulus drops below ``min_mod``, mirroring the reference's stop rule
without data-dependent shapes), in two stages like the reference: stage 1 on
all correspondences, then outliers (residual norm > threshold) are masked and
stage 2 refines. The 6x6 normal system is assembled with batched einsums
(tiny MXU work) and solved with Cholesky.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from srba_slam_tpu.utils import se3
from srba_slam_tpu.utils.camera import StereoCamera

_HI = jax.lax.Precision.HIGHEST


class PoseSolveResult(NamedTuple):
    pose: jax.Array          # [6] rotvec+trans: x_cur = R x_prev + t
    residuals: jax.Array     # [N] final residual norms (0 where invalid input)
    inliers: jax.Array       # [N] bool mask of correspondences that survived
    num_inliers: jax.Array   # int32
    mean_residual: jax.Array # mean over inliers (pixels)
    iters: jax.Array         # int32 GN iterations actually applied (stage 2)
    valid: jax.Array         # bool — enough inliers & finite solution


def stereo_residuals(R: jax.Array, t: jax.Array, pts: jax.Array,
                     obs: jax.Array, cam: StereoCamera, eps: float = 1e-6):
    """Residuals r = project(R p + t) - obs and camera-frame points.

    pts: [N,3] in the previous frame; obs: [N,3] = (ul, vl, ur).
    Returns (r [N,3], x [N,3]).
    """
    x = jnp.einsum("ij,nj->ni", R, pts, precision=_HI) + t[None, :]
    X, Y, Z = x[..., 0], x[..., 1], x[..., 2]
    zi = 1.0 / jnp.maximum(Z, eps)
    ul = cam.cx_l + cam.fx_l * X * zi
    vl = cam.cy_l + cam.fy_l * Y * zi
    ur = cam.cx_r + cam.fx_r * (X - cam.baseline) * zi
    r = jnp.stack([ul, vl, ur], axis=-1) - obs
    return r, x


def _jacobian(x: jax.Array, cam: StereoCamera, eps: float = 1e-6) -> jax.Array:
    """d residual / d twist (left perturbation), [N, 3, 6]."""
    X, Y, Z = x[..., 0], x[..., 1], x[..., 2]
    zi = 1.0 / jnp.maximum(Z, eps)
    zi2 = zi * zi
    zeros = jnp.zeros_like(X)
    # d(ul,vl,ur)/dx  [N,3,3]
    dr_dx = jnp.stack(
        [
            jnp.stack([cam.fx_l * zi, zeros, -cam.fx_l * X * zi2], axis=-1),
            jnp.stack([zeros, cam.fy_l * zi, -cam.fy_l * Y * zi2], axis=-1),
            jnp.stack([cam.fx_r * zi, zeros, -cam.fx_r * (X - cam.baseline) * zi2], axis=-1),
        ],
        axis=-2,
    )
    # dx/d(omega, nu): [-hat(x) | I]  [N,3,6]
    dx_dxi = jnp.concatenate(
        [-se3.hat(x), jnp.broadcast_to(jnp.eye(3, dtype=x.dtype), (*x.shape[:-1], 3, 3))],
        axis=-1,
    )
    return jnp.einsum("nij,njk->nik", dr_dx, dx_dxi, precision=_HI)


def _pseudo_huber_weight(rnorm: jax.Array, b: jax.Array) -> jax.Array:
    """IRLS weight rho'(r)/r for the pseudo-Huber kernel with parameter b."""
    return 1.0 / jnp.sqrt(1.0 + (rnorm / b) ** 2)


def _gn_stage(R0, t0, pts, obs, w_valid, cam, kernel_param, use_kernel,
              max_iters: int, min_mod: float, damping: float,
              max_incr_cost=1 << 30):
    """Run up to max_iters damped GN steps, stopping early once the step
    modulus drops below ``min_mod`` (the reference's ending condition) — a
    real while_loop exit, not a frozen-carry fori_loop, because each spent
    iteration is device time on the serial per-frame critical path.

    ``max_incr_cost`` (≙ the stereo-vo LEAST_SQUARES option of the same
    name): additionally stop after this many CONSECUTIVE iterations whose
    robust cost increased — the solver is diverging, keep the best pose seen
    so far."""

    b2 = kernel_param * kernel_param

    def cost_at(r):
        rsq = jnp.sum(r * r, axis=-1)
        rho = jnp.where(use_kernel,
                        2.0 * b2 * (jnp.sqrt(1.0 + rsq / b2) - 1.0), rsq)
        return jnp.sum(rho * w_valid)

    def cond(carry):
        _R, _t, done, iters, _c, incr, _best = carry
        return (~done) & (iters < max_iters) & (incr < max_incr_cost)

    def body(carry):
        R, t, done, iters, prev_cost, incr, best = carry
        best_R, best_t, best_cost = best
        r, x = stereo_residuals(R, t, pts, obs, cam)
        cost = cost_at(r)
        incr = jnp.where(cost > prev_cost, incr + 1, 0)
        better = cost < best_cost
        best = (jnp.where(better, R, best_R), jnp.where(better, t, best_t),
                jnp.minimum(cost, best_cost))
        J = _jacobian(x, cam)
        rnorm = jnp.linalg.norm(r, axis=-1)
        w = jnp.where(use_kernel, _pseudo_huber_weight(rnorm, kernel_param), 1.0)
        w = w * w_valid
        H = jnp.einsum("nij,n,nik->jk", J, w, J, precision=_HI)
        g = jnp.einsum("nij,n,ni->j", J, w, r, precision=_HI)
        H = H + damping * jnp.eye(6, dtype=H.dtype)
        L = jnp.linalg.cholesky(H)
        delta = -jax.scipy.linalg.cho_solve((L, True), g)
        ok = jnp.all(jnp.isfinite(delta))
        delta = jnp.where(ok, delta, 0.0)
        step_mod = jnp.linalg.norm(delta)
        apply = (~done) & ok
        dR = se3.so3_exp(delta[:3])
        R_new = jnp.einsum("ij,jk->ik", dR, R, precision=_HI)
        t_new = jnp.einsum("ij,j->i", dR, t, precision=_HI) + delta[3:]
        R = jnp.where(apply, R_new, R)
        t = jnp.where(apply, t_new, t)
        done = done | (step_mod < min_mod) | (~ok)
        iters = iters + apply.astype(jnp.int32)
        return R, t, done, iters, cost, incr, best

    inf = jnp.asarray(jnp.inf, jnp.float32)
    R, t, _, iters, _c, incr, (bR, bt, bc) = jax.lax.while_loop(
        cond, body,
        (R0, t0, jnp.asarray(False), jnp.asarray(0, jnp.int32), inf,
         jnp.asarray(0, jnp.int32), (R0, t0, inf)),
    )
    # if we bailed on diverging cost, return the best-seen pose instead of
    # the diverged one
    r_fin, _ = stereo_residuals(R, t, pts, obs, cam)
    diverged = (incr >= max_incr_cost) & (cost_at(r_fin) > bc)
    R = jnp.where(diverged, bR, R)
    t = jnp.where(diverged, bt, t)
    return R, t, iters


@functools.partial(
    jax.jit,
    static_argnames=("max_iters_initial", "max_iters", "use_kernel"),
)
def solve_pose(
    pts_prev: jax.Array,
    obs_cur: jax.Array,
    valid: jax.Array,
    cam: StereoCamera,
    initial_pose: jax.Array | None = None,
    kernel_param: float = 2.0,
    residual_threshold: float = 15.0,
    min_mod: float = 1e-3,
    max_iters_initial: int = 30,
    max_iters: int = 30,
    min_inliers: int = 5,
    use_kernel: bool = True,
    damping: float = 1e-4,
    max_incr_cost: int = 3,
) -> PoseSolveResult:
    """Two-stage robust pose solve (≙ LEAST_SQUARES config defaults).

    Args:
      pts_prev: [N, 3] 3D points in the previous camera frame (padded).
      obs_cur: [N, 3] observed (ul, vl, ur) in the current frame.
      valid: [N] bool correspondence mask.
      initial_pose: optional [6] rotvec+trans initial guess.
      min_inliers: ≙ bad_tracking_th.
      max_incr_cost: ≙ the stereo-vo LEAST_SQUARES max_incr_cost option —
        abort a stage after this many consecutive cost-increasing steps
        (best-seen pose kept).
    """
    pts_prev = pts_prev.astype(jnp.float32)
    obs_cur = obs_cur.astype(jnp.float32)
    w_valid = valid.astype(jnp.float32)
    if initial_pose is None:
        initial_pose = jnp.zeros((6,), jnp.float32)
    R0, t0 = se3.exp(initial_pose)

    kernel_param = jnp.asarray(kernel_param, jnp.float32)

    # stage 1: all valid correspondences
    R1, t1, _ = _gn_stage(R0, t0, pts_prev, obs_cur, w_valid, cam,
                          kernel_param, use_kernel, max_iters_initial,
                          min_mod, damping, max_incr_cost)
    r1, _ = stereo_residuals(R1, t1, pts_prev, obs_cur, cam)
    rnorm1 = jnp.linalg.norm(r1, axis=-1)
    inliers = valid & (rnorm1 <= residual_threshold)

    # stage 2: refine on inliers only
    w2 = inliers.astype(jnp.float32)
    R2, t2, iters2 = _gn_stage(R1, t1, pts_prev, obs_cur, w2, cam,
                               kernel_param, use_kernel, max_iters,
                               min_mod, damping, max_incr_cost)
    r2, _ = stereo_residuals(R2, t2, pts_prev, obs_cur, cam)
    rnorm2 = jnp.linalg.norm(r2, axis=-1) * w2
    n_in = jnp.sum(inliers.astype(jnp.int32))
    mean_res = jnp.sum(rnorm2) / jnp.maximum(n_in.astype(jnp.float32), 1.0)
    pose = se3.log(R2, t2)
    ok = (n_in >= min_inliers) & jnp.all(jnp.isfinite(pose))
    pose = jnp.where(ok, pose, initial_pose)
    return PoseSolveResult(
        pose=pose,
        residuals=rnorm2,
        inliers=inliers,
        num_inliers=n_in,
        mean_residual=mean_res,
        iters=iters2,
        valid=ok,
    )

"""SE(3) / SO(3) algebra as pure JAX.

Replacement for the pose algebra the reference pulls from MRPT
(``CPose3DRotVec`` / ``CPose3D`` — see reference src/srba-stereo-slam_common.h:58-72
and the compose/inverse call sites in src/CSRBAStereoSLAMEstimator.cpp:327-330,922).

Poses are represented as 6-vectors ``[wx wy wz tx ty tz]`` (rotation vector +
translation — the CPose3DRotVec layout) or as ``(R, t)`` pairs. Every function
is shape-polymorphic over leading batch dimensions and safe to ``vmap``/``jit``;
small-angle branches use ``jnp.where`` so gradients are finite everywhere.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_EPS = 1e-9

# Pose algebra operates on tiny 3x3 blocks; on the GPU the default f32
# matmul precision may run in TF32 (~3 decimal digits), far too coarse for
# chained SE(3) compositions. Force full f32 everywhere (negligible cost at
# these shapes).
_HI = jax.lax.Precision.HIGHEST


def _mm(a: jax.Array, b: jax.Array) -> jax.Array:
    """Batched matrix product at full precision."""
    return jnp.einsum("...ij,...jk->...ik", a, b, precision=_HI)


def hat(w: jax.Array) -> jax.Array:
    """Skew-symmetric matrix of a 3-vector. Batched over leading dims."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = jnp.zeros_like(wx)
    return jnp.stack(
        [
            jnp.stack([z, -wz, wy], axis=-1),
            jnp.stack([wz, z, -wx], axis=-1),
            jnp.stack([-wy, wx, z], axis=-1),
        ],
        axis=-2,
    )


def so3_exp(w: jax.Array) -> jax.Array:
    """Rodrigues: rotation vector -> rotation matrix. Batched."""
    theta2 = jnp.sum(w * w, axis=-1, keepdims=True)[..., None]  # [...,1,1]
    theta = jnp.sqrt(jnp.maximum(theta2, _EPS))
    W = hat(w)
    W2 = _mm(W, W)
    small = theta2 < 1e-12
    # sin(t)/t and (1-cos t)/t^2 with Taylor fallbacks
    a = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta) / theta)
    b = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / theta2)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye + a * W + b * W2


def so3_log(R: jax.Array) -> jax.Array:
    """Rotation matrix -> rotation vector. Batched.

    Uses the numerically-stable quaternion route so it is exact at
    theta -> 0 and well-behaved near theta -> pi.
    """
    q = quat_from_rotmat(R)  # [w, x, y, z], w >= 0
    qw = q[..., 0]
    qv = q[..., 1:]
    nv = jnp.linalg.norm(qv, axis=-1, keepdims=True)
    # theta = 2*atan2(|qv|, qw); axis = qv/|qv|
    theta = 2.0 * jnp.arctan2(nv, qw[..., None])
    scale = jnp.where(nv < 1e-9, 2.0 / jnp.maximum(qw[..., None], _EPS), theta / jnp.maximum(nv, _EPS))
    return qv * scale


def quat_from_rotmat(R: jax.Array) -> jax.Array:
    """Rotation matrix -> unit quaternion [w,x,y,z] with w >= 0. Batched.

    Branch-free Shepperd's method: compute all four candidate quaternions and
    select the one keyed on the largest of (trace, R00, R11, R22).
    """
    r00, r01, r02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    r10, r11, r12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    r20, r21, r22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = r00 + r11 + r22

    def safe_sqrt(x):
        return jnp.sqrt(jnp.maximum(x, _EPS))

    # candidate 0: w largest
    s0 = safe_sqrt(1.0 + tr) * 2.0
    q0 = jnp.stack([0.25 * s0, (r21 - r12) / s0, (r02 - r20) / s0, (r10 - r01) / s0], axis=-1)
    # candidate 1: x largest
    s1 = safe_sqrt(1.0 + r00 - r11 - r22) * 2.0
    q1 = jnp.stack([(r21 - r12) / s1, 0.25 * s1, (r01 + r10) / s1, (r02 + r20) / s1], axis=-1)
    # candidate 2: y largest
    s2 = safe_sqrt(1.0 - r00 + r11 - r22) * 2.0
    q2 = jnp.stack([(r02 - r20) / s2, (r01 + r10) / s2, 0.25 * s2, (r12 + r21) / s2], axis=-1)
    # candidate 3: z largest
    s3 = safe_sqrt(1.0 - r00 - r11 + r22) * 2.0
    q3 = jnp.stack([(r10 - r01) / s3, (r02 + r20) / s3, (r12 + r21) / s3, 0.25 * s3], axis=-1)

    cond1 = (r00 > r11) & (r00 > r22)
    cond2 = r11 > r22
    q_not0 = jnp.where(cond1[..., None], q1, jnp.where(cond2[..., None], q2, q3))
    q = jnp.where((tr > 0.0)[..., None], q0, q_not0)
    q = q / jnp.linalg.norm(q, axis=-1, keepdims=True)
    # canonicalize sign: w >= 0
    return q * jnp.where(q[..., :1] < 0.0, -1.0, 1.0)


# ---------------------------------------------------------------------------
# 6-vector pose API ([wx wy wz tx ty tz], CPose3DRotVec layout)
# ---------------------------------------------------------------------------

def identity(dtype=jnp.float32) -> jax.Array:
    return jnp.zeros((6,), dtype=dtype)


def exp(xi: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Pose 6-vector -> (R, t).

    NOTE: like MRPT's CPose3DRotVec, the 6-vector is (rotvec, translation),
    NOT the se(3) exponential twist — translation is stored directly.
    """
    return so3_exp(xi[..., :3]), xi[..., 3:]


def log(R: jax.Array, t: jax.Array) -> jax.Array:
    """(R, t) -> pose 6-vector [rotvec, t]."""
    return jnp.concatenate([so3_log(R), t], axis=-1)


def compose(a: jax.Array, b: jax.Array) -> jax.Array:
    """Pose composition a ⊕ b on 6-vectors (point maps: x_w = Ra (Rb x + tb) + ta)."""
    Ra, ta = exp(a)
    Rb, tb = exp(b)
    R = _mm(Ra, Rb)
    t = jnp.einsum("...ij,...j->...i", Ra, tb, precision=_HI) + ta
    return log(R, t)


def inverse(a: jax.Array) -> jax.Array:
    """Pose inverse on 6-vectors."""
    Ra, ta = exp(a)
    Rinv = jnp.swapaxes(Ra, -1, -2)
    tinv = -jnp.einsum("...ij,...j->...i", Rinv, ta, precision=_HI)
    return log(Rinv, tinv)


def relative(a: jax.Array, b: jax.Array) -> jax.Array:
    """a ⊖ b = inverse(b) ⊕ a : pose of `a` as seen from frame `b`.

    Matches MRPT ``inverseComposeFrom`` semantics used when seeding kf2kf
    edges (reference src/srba-stereo-slam.h:203).
    """
    return compose(inverse(b), a)


def transform_points(pose: jax.Array, pts: jax.Array) -> jax.Array:
    """Apply pose to points: R @ p + t. pts [..., N, 3], pose [..., 6]."""
    R, t = exp(pose)
    return jnp.einsum("...ij,...nj->...ni", R, pts, precision=_HI) + t[..., None, :]


def inverse_transform_points(pose: jax.Array, pts: jax.Array) -> jax.Array:
    """Apply pose^-1 to points."""
    R, t = exp(pose)
    return jnp.einsum("...ji,...nj->...ni", R, pts - t[..., None, :], precision=_HI)


def ypr_from_rotmat(R: jax.Array) -> jax.Array:
    """Rotation matrix -> [yaw, pitch, roll] (ZYX convention, MRPT order).

    Used for the ``out_kf_poses.txt`` trajectory dump
    (reference src/CSRBAStereoSLAMEstimator.cpp:977-987).
    """
    pitch = jnp.arctan2(-R[..., 2, 0], jnp.sqrt(R[..., 0, 0] ** 2 + R[..., 1, 0] ** 2))
    yaw = jnp.arctan2(R[..., 1, 0], R[..., 0, 0])
    roll = jnp.arctan2(R[..., 2, 1], R[..., 2, 2])
    return jnp.stack([yaw, pitch, roll], axis=-1)


def rotmat_from_ypr(ypr: jax.Array) -> jax.Array:
    """[yaw, pitch, roll] -> rotation matrix (ZYX)."""
    y, p, r = ypr[..., 0], ypr[..., 1], ypr[..., 2]
    cy, sy = jnp.cos(y), jnp.sin(y)
    cp, sp = jnp.cos(p), jnp.sin(p)
    cr, sr = jnp.cos(r), jnp.sin(r)
    row0 = jnp.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr], axis=-1)
    row1 = jnp.stack([sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr], axis=-1)
    row2 = jnp.stack([-sp, cp * sr, cp * cr], axis=-1)
    return jnp.stack([row0, row1, row2], axis=-2)


def rotation_angle(pose_or_rotvec: jax.Array) -> jax.Array:
    """Magnitude of the rotation (radians) of a 6-vector pose or 3-vector rotvec."""
    w = pose_or_rotvec[..., :3]
    return jnp.linalg.norm(w, axis=-1)


def translation_norm(pose: jax.Array) -> jax.Array:
    return jnp.linalg.norm(pose[..., 3:6], axis=-1)

"""Multi-device scale-out via jax.sharding over a device mesh.

The reference is strictly single-threaded (SURVEY §2.3) — there is no
communication layer to port. The win is *embarrassingly parallel batch
axes*: many stereo sequences (multi-run evaluation, feature-budget sweeps,
fleet replay) processed simultaneously, one sequence per mesh slot, with XLA
inserting the collectives for any cross-sequence reduction (global
statistics, fleet-level convergence checks).

Everything here builds on the exact same jitted programs the single-device
pipeline uses — the batch dimension is sharded with ``NamedSharding`` and
XLA partitions the whole step, handing the collectives to NCCL on GPUs. The
mesh is flat (1-D): every card of an NVLink host reaches every other at the
same rate.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from srba_slam_tpu.models.vo import FrameFeatures, extract_and_match, track_and_solve
from srba_slam_tpu.utils.camera import StereoCamera

BATCH_AXIS = "batch"


def make_mesh(n_devices: int | None = None) -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.asarray(devs[:n]), (BATCH_AXIS,))


def shard_batch(mesh: Mesh, tree):
    """Place a pytree with leading batch dim across the mesh."""
    sharding = NamedSharding(mesh, P(BATCH_AXIS))
    return jax.tree.map(lambda x: jax.device_put(x, sharding), tree)


@functools.partial(jax.jit, static_argnames=("k", "cell"))
def _batched_step(lefts, rights, prev: FrameFeatures, init_pose, cam: StereoCamera,
                  fast_th, orb_th, k: int = 256, cell: int = 5):
    """One VO step for B sequences at once: extract + stereo-match each
    sequence's pair, track against its previous frame, solve its pose.
    Returns per-sequence features/poses plus fleet-level aggregates (the
    cross-shard reduction XLA lowers to collectives)."""

    def one(left, right, prev_i, init_i):
        cur = extract_and_match(left, right, cam, fast_th, orb_th, k=k, cell=cell)
        out = track_and_solve(prev_i, cur, cam, init_i, orb_th)
        return cur, out.pose.pose, out.pose.valid, out.pose.mean_residual

    cur, poses, valid, res = jax.vmap(one)(lefts, rights, prev, init_pose)
    fleet_mean_residual = jnp.mean(res)          # cross-device reduction
    fleet_valid_fraction = jnp.mean(valid.astype(jnp.float32))
    return cur, poses, valid, fleet_mean_residual, fleet_valid_fraction


def batched_vo_step(mesh: Mesh, lefts, rights, prev: FrameFeatures,
                    init_pose, cam: StereoCamera,
                    fast_th: float = 20.0, orb_th: int = 60,
                    k: int = 256, cell: int = 5):
    """Sharded multi-sequence VO step. Inputs carry a leading batch dim that
    is partitioned over the mesh's ``batch`` axis."""
    lefts, rights, prev, init_pose = shard_batch(
        mesh, (lefts, rights, prev, init_pose)
    )
    with mesh:
        return _batched_step(
            lefts, rights, prev, init_pose, cam,
            jnp.float32(fast_th), jnp.int32(orb_th), k=k, cell=cell,
        )


def empty_features(batch: int, k: int) -> FrameFeatures:
    """A valid all-empty FrameFeatures batch (for the first frame)."""
    z_i = jnp.zeros((batch, k), jnp.int32)
    z_b = jnp.zeros((batch, k), bool)
    return FrameFeatures(
        ys_l=z_i, xs_l=z_i, score_l=jnp.zeros((batch, k), jnp.float32),
        valid_l=z_b, desc_l=jnp.zeros((batch, k, 8), jnp.uint32),
        ys_r=z_i, xs_r=z_i, valid_r=z_b,
        desc_r=jnp.zeros((batch, k, 8), jnp.uint32),
        m_r_idx=z_i, m_valid=z_b,
        pts3d=jnp.zeros((batch, k, 3), jnp.float32),
        octave=z_i,
    )

"""Fixed-capacity keyframe store (≙ CStereoSLAMKF + vector of KFs).

The reference keeps a ``std::vector<CStereoSLAMKF>`` of keyframes, each with
left/right keypoints, 256-bit descriptors, L-R matches, globally unique match
IDs and a camera pose (reference src/CStereoSLAMKF.h:99-104). Here the whole
store is a pytree of padded device arrays with static capacities
``[MAX_KFS, K, ...]`` so any subset of keyframes can be gathered into a
compiled program without shape changes; scalar bookkeeping lives on host.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

import jax
import jax.numpy as jnp

from srba_slam_tpu.models.vo import FrameFeatures


class KFArrays(NamedTuple):
    """Device-side stacked keyframe data."""

    ys_l: jax.Array     # int32 [M, K]
    xs_l: jax.Array
    valid_l: jax.Array  # bool [M, K]
    desc_l: jax.Array   # uint32 [M, K, 8]
    ys_r: jax.Array
    xs_r: jax.Array
    valid_r: jax.Array
    desc_r: jax.Array
    m_r_idx: jax.Array  # int32 [M, K]
    m_valid: jax.Array  # bool [M, K]
    pts3d: jax.Array    # f32 [M, K, 3] (left-camera frame)
    octave: jax.Array   # int32 [M, K]


import functools


@functools.partial(jax.jit, donate_argnums=(0,))
def _append_row(arrays: KFArrays, i: jax.Array, frame) -> KFArrays:
    """Write one keyframe row into every store array in a single dispatch
    (donated: updates in place, no 20MB copies)."""
    return KFArrays(*(arr.at[i].set(val) for arr, val in zip(arrays, frame)))


class KeyframeStore:
    """Host wrapper around KFArrays + per-KF match IDs and poses."""

    def __init__(self, max_kfs: int = 512, capacity: int = 512):
        self.max_kfs = max_kfs
        self.capacity = capacity
        k = capacity
        self.arrays = KFArrays(
            ys_l=jnp.zeros((max_kfs, k), jnp.int32),
            xs_l=jnp.zeros((max_kfs, k), jnp.int32),
            valid_l=jnp.zeros((max_kfs, k), bool),
            desc_l=jnp.zeros((max_kfs, k, 8), jnp.uint32),
            ys_r=jnp.zeros((max_kfs, k), jnp.int32),
            xs_r=jnp.zeros((max_kfs, k), jnp.int32),
            valid_r=jnp.zeros((max_kfs, k), bool),
            desc_r=jnp.zeros((max_kfs, k, 8), jnp.uint32),
            m_r_idx=jnp.zeros((max_kfs, k), jnp.int32),
            m_valid=jnp.zeros((max_kfs, k), bool),
            pts3d=jnp.zeros((max_kfs, k, 3), jnp.float32),
            octave=jnp.zeros((max_kfs, k), jnp.int32),
        )
        self.match_ids = np.full((max_kfs, k), -1, np.int64)  # host
        self.poses = np.zeros((max_kfs, 6), np.float32)       # world poses, host
        self.n_kfs = 0

    def write_row(self, frame: FrameFeatures, row: int):
        """Device write of a keyframe row WITHOUT committing the host
        counter. Rows at index >= n_kfs are inert (every consumer masks by
        the committed count), so a speculative write that is never
        committed needs no cleanup — the next committed write simply
        overwrites the slot."""
        assert row < self.max_kfs, "keyframe capacity exhausted"
        self.arrays = _append_row(
            self.arrays, jnp.int32(row),
            (
                frame.ys_l, frame.xs_l, frame.valid_l, frame.desc_l,
                frame.ys_r, frame.xs_r, frame.valid_r, frame.desc_r,
                frame.m_r_idx, frame.m_valid, frame.pts3d, frame.octave,
            ),
        )

    def commit_row(self, ids: np.ndarray, pose: np.ndarray) -> int:
        """Commit the next row (previously device-written via
        :meth:`write_row`) with its host-side match IDs and pose."""
        i = self.n_kfs
        self.match_ids[i] = ids
        self.poses[i] = pose
        self.n_kfs += 1
        return i

    def append(self, frame: FrameFeatures, ids: np.ndarray,
               pose: np.ndarray) -> int:
        """Store a frame as keyframe; returns its KF id."""
        self.write_row(frame, self.n_kfs)
        return self.commit_row(ids, pose)

    def drop_last(self):
        """Un-insert the most recent KF (≙ the candidate-KF rollback at
        reference src/CSRBAStereoSLAMEstimator.cpp:558-562)."""
        assert self.n_kfs > 0
        self.n_kfs -= 1
        self.match_ids[self.n_kfs] = -1

    def set_pose(self, kf_id: int, pose: np.ndarray):
        self.poses[kf_id] = np.asarray(pose, np.float32)

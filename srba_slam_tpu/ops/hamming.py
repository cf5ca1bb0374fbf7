"""Pairwise Hamming distance as one matmul.

The reference computes brute-force Hamming matching with
``cv::BFMatcher(NORM_HAMMING)`` (src/CSRBAStereoSLAMEstimator.cpp:1447-1452) —
an N×M scalar popcount loop on CPU. Here the same computation is one small
matmul: with descriptors unpacked to {0,1} vectors a, b,

    hamming(a, b) = popcount(a) + popcount(b) - 2 * <a, b>

so the full N×M distance matrix is ``pa[:,None] + pb[None,:] - 2 A @ B^T``
with an exact product (bf16 operands, f32 accumulation).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from srba_slam_tpu.ops import bits as bitops


def hamming_matrix_unpacked(a_bits: jax.Array, b_bits: jax.Array) -> jax.Array:
    """{0,1} [N,256] x [M,256] -> f32 [N,M] exact Hamming distances.

    bf16 inputs + f32 accumulation: bits are exact in bf16 and the sums
    stay below 2^24, so the result is exact on the tensor-core matmul path
    (TF32 or bf16 rounding cannot touch 0/1 operands). The whole matching
    pipeline stays in f32 downstream.
    """
    ab = a_bits.astype(jnp.bfloat16)
    bb = b_bits.astype(jnp.bfloat16)
    dot = jax.lax.dot_general(
        ab, bb,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
    )
    pa = jnp.sum(ab.astype(jnp.float32), axis=-1)
    pb = jnp.sum(bb.astype(jnp.float32), axis=-1)
    return pa[:, None] + pb[None, :] - 2.0 * dot


def hamming_matrix(a_packed: jax.Array, b_packed: jax.Array) -> jax.Array:
    """uint32[N,8] x uint32[M,8] packed descriptors -> f32[N,M] distances."""
    return hamming_matrix_unpacked(
        bitops.unpack_bits(a_packed, jnp.bfloat16),
        bitops.unpack_bits(b_packed, jnp.bfloat16),
    )


def hamming_pairs(a_packed: jax.Array, b_packed: jax.Array) -> jax.Array:
    """Elementwise Hamming distance of aligned descriptor rows: [N,8]x[N,8] -> [N]."""
    return bitops.popcount_desc(jnp.bitwise_xor(a_packed, b_packed))

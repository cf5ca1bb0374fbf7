"""FAST-9/16 corner detection as a fixed-shape whole-image tensor program.

Equivalent of the FAST detector inside the reference's stereo-vo
engine (forced ORB detection mode, reference src/CSRBAStereoSLAMEstimator.cpp:1135
and demo/config_imgdir_kitti_srba.ini FAST threshold at SRBA_DETECT).

Instead of the CPU's per-pixel early-exit scan, every pixel is tested at once:
the 16 Bresenham-circle neighbours are 16 shifted views of the image, and the
corner score (max threshold that keeps the corner — OpenCV's nonmax score) is
a min/max over the 16 contiguous 9-arcs, all elementwise, which XLA fuses
into one pass over the image.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

# The 16 Bresenham circle offsets (dy, dx), clockwise from 12 o'clock,
# matching the classic FAST-9/16 layout.
CIRCLE = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3),
    (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3),
    (0, -3), (-1, -3), (-2, -2), (-3, -1),
)

ARC = 9  # contiguous run length for FAST-9


def _shift(img: jax.Array, dy: int, dx: int) -> jax.Array:
    """View of img shifted so that out[y, x] = img[y+dy, x+dx] (border wraps;
    the wrapped ring is discarded by the margin mask downstream)."""
    return jnp.roll(img, shift=(-dy, -dx), axis=(0, 1))


def _window9(vals: list, combine) -> list:
    """combine() over all 9-long contiguous circular windows of the 16
    per-tap arrays: out[i] = combine over vals[i..i+8 (mod 16)].
    log-depth: w3 = c(v, v+1, v+2); w9 = c(w3, w3+3, w3+6)."""
    w3 = [combine(combine(vals[i], vals[(i + 1) % 16]), vals[(i + 2) % 16])
          for i in range(16)]
    return [combine(combine(w3[i], w3[(i + 3) % 16]), w3[(i + 6) % 16])
            for i in range(16)]


@functools.partial(jax.jit, static_argnames=("margin",))
def fast_score_map(img: jax.Array, threshold: jax.Array, margin: int = 16) -> jax.Array:
    """FAST-9/16 corner score for every pixel.

    Args:
      img: [H, W] float32 grayscale (any scale; thresholds in the same units).
      threshold: scalar detection threshold t.
      margin: border (pixels) forced to score 0 — must cover the descriptor
        patch radius so downstream keypoints always have full support.

    Returns:
      [H, W] float32 score map; 0 where not a corner. The score is the
      largest threshold at which the pixel remains a corner (OpenCV-style
      nonmax score): max over contiguous-9 arcs of the min arc contrast.
    """
    img = img.astype(jnp.float32)
    h, w = img.shape
    # contrast of each circle pixel vs the center: 16 separate [H, W] views
    # (a list, not a stacked [16, H, W] tensor, so the whole score is one
    # elementwise expression that XLA fuses into a single pass)
    d = [_shift(img, dy, dx) - img for (dy, dx) in CIRCLE]

    # candidate test: some 9-contiguous arc entirely > t (bright) or < -t (dark)
    min9 = _window9(d, jnp.minimum)   # min over each arc
    max9 = _window9(d, jnp.maximum)
    bright_score = functools.reduce(jnp.maximum, min9)  # > t => bright corner
    dark_score = -functools.reduce(jnp.minimum, max9)   # > t => dark corner
    score = jnp.maximum(bright_score, dark_score)
    is_corner = score > threshold
    score = jnp.where(is_corner, score, 0.0)

    if margin > 0:
        ys = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
        xs = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
        inside = (
            (ys >= margin) & (ys < h - margin) & (xs >= margin) & (xs < w - margin)
        )
        score = jnp.where(inside, score, 0.0)
    return score

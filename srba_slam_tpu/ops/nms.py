"""Non-max suppression and fixed-capacity keypoint selection.

Replaces the reference stereo-vo's 5x5 non-maximal suppression plus
"adaptive" min-distance thinning (demo/config_imgdir_kitti_srba.ini DETECT
section: non_maximal_suppression=true, non_max_supp_method=1 adaptive,
min_distance=5) with two static-shape passes:

1. local-max NMS: a (2r+1)^2 max-pool (XLA reduce_window); a pixel survives
   only if it equals the local max (ties broken toward the lexically first
   pixel of the window);
2. grid thinning + top-K: the image is cut into min_distance-sized cells,
   each cell keeps its best survivor, and a global top-K over cells produces
   a fixed-capacity keypoint set (padded, masked) — the shape every
   downstream stage compiles against.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def local_max_suppress(score: jax.Array, radius: int = 2) -> jax.Array:
    """Zero out pixels that are not the maximum of their (2r+1)^2 window.

    Ties go to the lexically first pixel: a window maximum survives only if
    no pixel before it in row-major order inside its window has the same
    score, so a plateau that fits in one window keeps exactly one pixel.
    Exact for any float scores (equality tests, no keyed epsilon)."""
    k = 2 * radius + 1
    h, w = score.shape
    pooled = jax.lax.reduce_window(
        score, -jnp.inf, jax.lax.max, (k, k), (1, 1), "SAME"
    )
    keep = (score >= pooled) & (score > 0.0)
    padded = jnp.pad(score, radius, constant_values=-jnp.inf)
    for dy in range(-radius, 1):
        for dx in range(-radius, radius + 1):
            if dy == 0 and dx >= 0:
                break
            # score[y + dy, x + dx]: a pixel that precedes (y, x)
            prev = padded[radius + dy:radius + dy + h,
                          radius + dx:radius + dx + w]
            keep = keep & (prev != score)
    return jnp.where(keep, score, 0.0)


@functools.partial(jax.jit, static_argnames=("cell", "k"))
def grid_topk(score: jax.Array, cell: int = 5, k: int = 500):
    """One winner per cell, then global top-k.

    Args:
      score: [H, W] NMS'd score map (0 = not a keypoint).
      cell: grid cell size in pixels (≙ min_distance).
      k: fixed keypoint capacity.

    Returns:
      (ys, xs, scores, valid): each [k]; invalid slots carry y=x=0, score=0.
    """
    h, w = score.shape
    gh, gw = h // cell, w // cell
    trimmed = score[: gh * cell, : gw * cell]
    cells = trimmed.reshape(gh, cell, gw, cell).transpose(0, 2, 1, 3).reshape(gh, gw, cell * cell)
    best = jnp.max(cells, axis=-1)             # [gh, gw]
    argbest = jnp.argmax(cells, axis=-1)       # [gh, gw] index within cell
    flat_best = best.reshape(-1)
    top_scores, top_cells = jax.lax.top_k(flat_best, k)
    cy = top_cells // gw
    cx = top_cells % gw
    inner = argbest.reshape(-1)[top_cells]
    ys = cy * cell + inner // cell
    xs = cx * cell + inner % cell
    valid = top_scores > 0.0
    ys = jnp.where(valid, ys, 0).astype(jnp.int32)
    xs = jnp.where(valid, xs, 0).astype(jnp.int32)
    return ys, xs, jnp.where(valid, top_scores, 0.0), valid

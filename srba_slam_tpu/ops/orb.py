"""Oriented 256-bit binary (ORB-style) descriptors as batched gathers.

Equivalent of the ORB descriptor stage inside the reference's
stereo-vo engine (forced dmORB mode, reference
src/CSRBAStereoSLAMEstimator.cpp:1135; 1 octave per
demo/config_imgdir_kitti_srba.ini RECTIFY nOctaves=1).

Per image the pipeline is three fixed-shape batched gathers over all K
keypoints at once — no per-keypoint loop:

1. orientation: intensity-centroid moments over a radius-15 disc,
   theta = atan2(m01, m10);
2. steering: the 256 (p, q) test-point pairs are rotated by theta
   (per-keypoint 2x2 rotation applied to the whole pattern tensor);
3. test: bit_i = blurred(x + Rp_i) < blurred(x + Rq_i), packed to
   uint32[K, 8] in the byte-LSB-first bit order shared with the reference
   (see srba_slam_tpu.ops.bits).

Two test-point patterns are available:

* ``pattern="opencv"`` (default): OpenCV's learned ``bit_pattern_31_`` table
  (shipped as orb_pattern_opencv.npy), with OpenCV's 7x7 sigma=2 Gaussian
  pre-blur and integer rounding — upright descriptors are bit-compatible
  with cv2.ORB's, so the reference demo vocabulary (trained on OpenCV ORB
  output) quantizes them properly;
* ``pattern="gaussian"``: a deterministic seeded BRIEF-style pattern
  constrained to the radius-15 disc (useful when no OpenCV compatibility is
  wanted).
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

PATCH_RADIUS = 15
N_BITS = 256


def _make_pattern(seed: int = 7) -> np.ndarray:
    """[256, 2, 2] int32 (pair, point, (dy,dx)) test pattern inside the disc."""
    rng = np.random.default_rng(seed)
    sigma = (2 * PATCH_RADIUS + 1) / 5.0
    pts = []
    while len(pts) < N_BITS * 2:
        cand = rng.normal(0.0, sigma, size=(N_BITS * 4, 2))
        cand = cand[np.linalg.norm(cand, axis=1) <= PATCH_RADIUS - 1.0]
        pts.extend(cand.tolist())
    pts = np.asarray(pts[: N_BITS * 2], dtype=np.float64)
    return pts.reshape(N_BITS, 2, 2)


_PATTERN = _make_pattern()  # float64 [256, 2, 2] in (dy, dx)


def _load_opencv_pattern() -> np.ndarray:
    """OpenCV bit_pattern_31_ as [256, 2, 2] in (dy, dx) point order (p, q).
    Table rows are (x1, y1, x2, y2)."""
    import os

    path = os.path.join(os.path.dirname(__file__), "orb_pattern_opencv.npy")
    t = np.load(path).astype(np.float64)  # [256, 4]
    return np.stack(
        [np.stack([t[:, 1], t[:, 0]], -1), np.stack([t[:, 3], t[:, 2]], -1)], 1
    )  # [256, 2(point), 2(dy,dx)]


_PATTERN_OPENCV = _load_opencv_pattern()

# OpenCV ORB pre-smoothing: GaussianBlur(ksize=7, sigma=2), fixed-point on
# uint8 images — reproduced as a separable conv + rounding
_G7 = np.exp(-((np.arange(7) - 3.0) ** 2) / (2.0 * 2.0**2))
_G7 = _G7 / _G7.sum()


def _disc_offsets(radius: int) -> np.ndarray:
    """Integer (dy, dx) offsets of OpenCV ORB's IC_Angle patch: |dx| bounded
    per row by the umax Bresenham table (cv2 orb.cpp), so the intensity
    centroid — and hence the steering angle — matches cv2's."""
    # umax for HALF_PATCH_SIZE=15, including OpenCV's symmetry fix-up
    umax = [15, 15, 15, 15, 14, 14, 14, 13, 13, 12, 11, 10, 9, 8, 6, 3]
    offs = []
    for dy in range(-radius, radius + 1):
        for dx in range(-umax[abs(dy)], umax[abs(dy)] + 1):
            offs.append((dy, dx))
    return np.asarray(offs, np.int32)


_DISC = _disc_offsets(PATCH_RADIUS)  # [D, 2]


def box_blur5(img: jax.Array) -> jax.Array:
    """5x5 box filter (legacy-pattern smoothing)."""
    s = jax.lax.reduce_window(
        img.astype(jnp.float32), 0.0, jax.lax.add, (5, 5), (1, 1), "SAME"
    )
    return s / 25.0


def gauss_blur7(img: jax.Array) -> jax.Array:
    """Separable 7x7 sigma=2 Gaussian + rounding (cv2.ORB's pre-smoothing on
    uint8 images, GaussianBlur(7,7,2,2) in fixed point)."""
    k = jnp.asarray(_G7, jnp.float32)
    x = img.astype(jnp.float32)
    x = jax.lax.conv_general_dilated(
        x[None, None], k[None, None, :, None], (1, 1), "SAME",
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
    )
    x = jax.lax.conv_general_dilated(
        x, k[None, None, None, :], (1, 1), "SAME",
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
    )
    return jnp.round(x[0, 0])


def _gather(img: jax.Array, ys: jax.Array, xs: jax.Array) -> jax.Array:
    """img[ys, xs] with clipping; ys/xs any equal shape."""
    h, w = img.shape
    yc = jnp.clip(ys, 0, h - 1)
    xc = jnp.clip(xs, 0, w - 1)
    return img.reshape(-1)[yc * w + xc]


def orientations(img: jax.Array, ys: jax.Array, xs: jax.Array) -> jax.Array:
    """Intensity-centroid orientation (radians) for K keypoints. [K] -> [K]."""
    dy = jnp.asarray(_DISC[:, 0], jnp.int32)
    dx = jnp.asarray(_DISC[:, 1], jnp.int32)
    vals = _gather(img, ys[:, None] + dy[None, :], xs[:, None] + dx[None, :])
    m01 = jnp.sum(vals * dy.astype(jnp.float32)[None, :], axis=-1)
    m10 = jnp.sum(vals * dx.astype(jnp.float32)[None, :], axis=-1)
    return jnp.arctan2(m01, m10)


@functools.partial(jax.jit,
                   static_argnames=("oriented", "pattern", "patch_safe"))
def describe(img: jax.Array, ys: jax.Array, xs: jax.Array, valid: jax.Array,
             oriented: bool = True, pattern: str = "opencv",
             theta_override: jax.Array | None = None,
             patch_safe: bool = True):
    """Compute 256-bit binary descriptors for K keypoints.

    Args:
      img: [H, W] float32 grayscale.
      ys, xs: [K] int32 keypoint coordinates (full patch support assumed —
        the detector enforces the margin).
      valid: [K] bool; invalid rows get zero descriptors.
      oriented: steer the pattern by the intensity-centroid angle (rotation
        invariance for wide-baseline place recognition). Upright descriptors
        (False) are markedly more stable for stereo matching and
        frame-to-frame tracking — the intensity centroid is noisy on
        weak-gradient patches — and are what the VO frontend uses.
      pattern: "opencv" (bit_pattern_31_ + Gaussian-7 blur, cv2-compatible
        bits when upright) or "gaussian" (seeded in-disc pattern + box blur).
      theta_override: optional [K] angles (radians) to steer with instead of
        the computed orientation — used by the cv2 parity tests and by
        callers that precompute orientation externally.
      patch_safe: every valid keypoint is >= 16 px from the image borders
        (true for the detector's default margin). Enables the block-gather
        fast path for upright descriptors; pass False when keypoints may
        sit closer to the border.

    Returns:
      (desc, theta): uint32[K, 8] packed descriptors, [K] orientations.
    """
    img = img.astype(jnp.float32)
    blurred = gauss_blur7(img) if pattern == "opencv" else box_blur5(img)

    if theta_override is None and not oriented and patch_safe:
        # FAST PATH (the VO frontend's): upright tests sample at FIXED
        # integer offsets, so instead of 512 random point-gathers per
        # keypoint, block-gather ONE 33x33 patch per keypoint (vmapped dynamic_slice
        # -> a structured gather of contiguous blocks) and do the 256
        # comparisons as constant-index takes inside the patch. The sampled
        # pixels are identical, so the descriptors are bit-identical to the
        # general path below — PROVIDED every keypoint is >= 16 px from the
        # borders (patch_safe; the detector margin guarantees it). Callers
        # with closer keypoints must pass patch_safe=False: dynamic_slice's
        # boundary clamp would shift the whole patch where the general path
        # clips per sample.
        from srba_slam_tpu.ops.bits import pack_bits

        r = 16
        side = 2 * r + 1

        def one_patch(y, x):
            return jax.lax.dynamic_slice(
                blurred, (y - r, x - r), (side, side))

        patch = jax.vmap(one_patch)(ys, xs).reshape(ys.shape[0], side * side)
        pat_np = _PATTERN_OPENCV if pattern == "opencv" else _PATTERN
        pidx = np.rint(pat_np[:, 0, 0]).astype(np.int64) * side + \
            np.rint(pat_np[:, 0, 1]).astype(np.int64) + r * side + r
        qidx = np.rint(pat_np[:, 1, 0]).astype(np.int64) * side + \
            np.rint(pat_np[:, 1, 1]).astype(np.int64) + r * side + r
        bits = (patch[:, pidx] < patch[:, qidx]).astype(jnp.uint32)
        desc = pack_bits(bits)
        desc = jnp.where(valid[:, None], desc, jnp.uint32(0))
        return desc, jnp.zeros(ys.shape[0], jnp.float32)

    theta = orientations(img, ys, xs)
    if theta_override is not None:
        theta = theta_override
    elif not oriented:
        # upright contract on the GENERAL path too (patch_safe=False — the
        # documented escape hatch for keypoints within 16 px of the border):
        # the pattern must not be steered by the computed orientation, or
        # the cv2 upright bit-parity breaks for exactly those callers
        theta = jnp.zeros_like(theta)

    c, s = jnp.cos(theta), jnp.sin(theta)  # [K]
    pat_np = _PATTERN_OPENCV if pattern == "opencv" else _PATTERN
    pat = jnp.asarray(pat_np, jnp.float32)  # [256, 2, 2] (pair, point, (dy,dx))
    pdy, pdx = pat[..., 0], pat[..., 1]  # [256, 2]
    # rotate each offset by theta_k: dy' = s*dx + c*dy? Using image coords
    # (y down, x right) rotate by theta about the keypoint:
    rdx = c[:, None, None] * pdx[None] - s[:, None, None] * pdy[None]  # [K,256,2]
    rdy = s[:, None, None] * pdx[None] + c[:, None, None] * pdy[None]
    iy = ys[:, None, None] + jnp.round(rdy).astype(jnp.int32)
    ix = xs[:, None, None] + jnp.round(rdx).astype(jnp.int32)
    samples = _gather(blurred, iy, ix)  # [K, 256, 2]
    bits = (samples[..., 0] < samples[..., 1]).astype(jnp.uint32)  # [K, 256]
    from srba_slam_tpu.ops.bits import pack_bits

    desc = pack_bits(bits)
    desc = jnp.where(valid[:, None], desc, jnp.uint32(0))
    return desc, theta

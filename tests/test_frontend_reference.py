"""The frontend's XLA detector and descriptor stages against plain
references: a numpy FAST-9/16 + 5x5 NMS written from the definition, and
OpenCV's ORB for upright descriptors."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from srba_slam_tpu.ops.fast import CIRCLE, fast_score_map
from srba_slam_tpu.ops.nms import local_max_suppress


def _fast_ref(img, th, margin):
    """FAST-9/16 score (OpenCV's nonmax score: the largest contrast that
    keeps a 9-contiguous arc brighter or darker than the centre), with the
    contrasts taken in f32 like the device program."""
    img = img.astype(np.float32)
    h, w = img.shape
    d = np.stack([np.roll(img, (-dy, -dx), (0, 1)) - img for dy, dx in CIRCLE])
    arcs = d[(np.arange(16)[:, None] + np.arange(9)[None]) % 16]  # [16,9,H,W]
    score = np.maximum(arcs.min(1).max(0), -arcs.max(1).min(0))
    score = np.where(score > th, score, 0.0)
    ys, xs = np.mgrid[:h, :w]
    inside = ((ys >= margin) & (ys < h - margin)
              & (xs >= margin) & (xs < w - margin))
    return np.where(inside, score, 0.0)


def _nms_ref(score, r):
    """A corner survives iff no pixel of its (2r+1)^2 window scores higher,
    and no pixel before it in row-major order scores the same."""
    h, w = score.shape
    out = np.zeros_like(score)
    for y, x in zip(*np.nonzero(score)):
        win = score[max(0, y - r):y + r + 1, max(0, x - r):x + r + 1]
        y0, x0 = max(0, y - r), max(0, x - r)
        s = score[y, x]
        earlier = [(yy, xx) for yy, xx in zip(*np.nonzero(win == s))
                   if (yy + y0, xx + x0) < (y, x)]
        if win.max() <= s and not earlier:
            out[y, x] = s
    return out


def _plateau_img(rng, shape):
    # quantized intensities: many equal FAST scores side by side, so the
    # row-major tiebreak decides most survivors
    return (rng.integers(0, 8, shape) * 30).astype(np.float32)


@pytest.mark.parametrize("shape,th,make", [
    ((123, 300), 12.0, lambda rng, s: rng.integers(0, 255, s)),
    ((200, 320), 12.0, lambda rng, s: rng.uniform(0, 255, s)),
    ((370, 1226), 20.0, _plateau_img),
], ids=["unaligned_123x300", "float_200x320", "plateaus_370x1226"])
def test_fast_nms_matches_numpy_reference(rng, shape, th, make):
    img = np.asarray(make(rng, shape), np.float32)
    got = jax.jit(lambda im: local_max_suppress(
        fast_score_map(im, th, margin=16), radius=2))(jnp.asarray(img))
    ref = _nms_ref(_fast_ref(img, th, 16), 2)
    assert (ref > 0).sum() > 50
    np.testing.assert_array_equal(np.asarray(got), ref)


def test_batched_upright_describe_matches_cv2(rng):
    """The frontend's batched upright describe (patch path, keypoints at the
    detector's 16 px margin) is bit-identical to cv2's ORB descriptors."""
    cv2 = pytest.importorskip("cv2")
    from srba_slam_tpu.ops.bits import words_to_bytes
    from srba_slam_tpu.ops.orb import describe

    n, h, w, k = 2, 123, 300, 40
    imgs = rng.integers(0, 256, (n, h, w), dtype=np.uint8)
    ys = rng.integers(16, h - 16, (n, k)).astype(np.int32)
    xs = rng.integers(16, w - 16, (n, k)).astype(np.int32)
    ours = jax.vmap(lambda im, y, x: describe(
        im, y, x, jnp.ones(k, bool), oriented=False, patch_safe=True)[0])(
        jnp.asarray(imgs, jnp.float32), jnp.asarray(ys), jnp.asarray(xs))
    orb = cv2.ORB_create(edgeThreshold=16)
    for i in range(n):
        kps = [cv2.KeyPoint(float(x), float(y), 31.0, 0.0, 0, 0)
               for y, x in zip(ys[i], xs[i])]
        kept, desc_cv = orb.compute(imgs[i], kps)
        assert len(kept) == k
        np.testing.assert_array_equal(np.asarray(words_to_bytes(ours[i])),
                                      desc_cv)

"""Single-transfer bulk pulls.

Packing a batch's heterogeneous pull set (scan outputs + queued window-solve
blobs + deferred-check blobs) into ONE device-side int32 concatenation turns
an N-array transfer into a single round trip (the concat itself is one more
async dispatch). Whether the packing still pays against a plain
``jax.device_get`` on the H100 is not measured yet (ROADMAP Queue 3 #4).

Float arrays ride along bitcast to int32 (f32 <-> i32 is bijective, and an
integer transfer is exact — no NaN-canonicalization hazard on the host
side); the host views the bits back as float32.  This keeps batched-mode
results bit-identical to individually pulled arrays.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

_I32 = np.dtype(np.int32)
_F32 = np.dtype(np.float32)
# dtypes that widen to int32 exactly (narrowed back on the host); int64 and
# f64 are deliberately rejected — they cannot ride an int32 lane losslessly
_WIDEN = tuple(np.dtype(t) for t in (np.bool_, np.int8, np.int16,
                                     np.uint8, np.uint16, np.uint32))


def bulk_pull(handles) -> tuple:
    """``jax.device_get`` a sequence of device arrays in as few transfers
    as possible (one per distinct device set).  Returns a tuple of numpy
    arrays in input order, bit-exact vs pulling each individually.
    float32 rides bitcast; bool/int8/int16/uint8/uint16/uint32 widen to
    int32 on device and narrow back on the host (uint32 bitcasts, so all
    32 bits survive).

    Handles committed to DIFFERENT device sets (e.g. a mesh-sharded
    window-solve blob next to a single-device check blob) cannot share one
    ``jnp.concatenate`` — XLA refuses mixed-commitment inputs — so handles
    are grouped by their device set and each group pulled as one blob; any
    group that still fails to fuse falls back to a plain device_get."""
    handles = tuple(handles)
    if not handles:
        return ()
    if len(handles) == 1:
        return (np.asarray(jax.device_get(handles[0])),)
    # group by committed device set (metadata only — no sync)
    groups: dict[tuple, list[int]] = {}
    for i, h in enumerate(handles):
        try:
            key = tuple(sorted(d.id for d in h.devices()))
        except Exception:
            key = ()
        groups.setdefault(key, []).append(i)
    out: list = [None] * len(handles)
    for idxs in groups.values():
        if len(idxs) == 1:
            out[idxs[0]] = np.asarray(jax.device_get(handles[idxs[0]]))
            continue
        try:
            vals = _fused_pull([handles[i] for i in idxs])
        except Exception:
            vals = [np.asarray(v)
                    for v in jax.device_get([handles[i] for i in idxs])]
        for i, v in zip(idxs, vals):
            out[i] = v
    return tuple(out)


def _fused_pull(handles) -> list:
    """One concatenated int32 transfer for same-device-set handles."""
    parts = []
    for h in handles:
        flat = h if (getattr(h, "ndim", None) == 1) else jnp.ravel(h)
        if h.dtype == _F32:
            flat = jax.lax.bitcast_convert_type(flat, jnp.int32)
        elif h.dtype == np.dtype(np.uint32):
            flat = jax.lax.bitcast_convert_type(flat, jnp.int32)
        elif h.dtype in _WIDEN:
            flat = flat.astype(jnp.int32)
        elif h.dtype != _I32:
            raise TypeError(f"bulk_pull cannot carry {h.dtype} losslessly")
        parts.append(flat)
    big = np.asarray(jax.device_get(jnp.concatenate(parts)))
    out, o = [], 0
    for h in handles:
        n = int(np.prod(h.shape)) if h.ndim else 1
        v = big[o:o + n]
        o += n
        if h.dtype == _F32:
            v = v.view(np.float32)
        elif h.dtype == np.dtype(np.uint32):
            v = v.view(np.uint32)
        elif h.dtype in _WIDEN:
            v = v.astype(h.dtype)
        out.append(v.reshape(h.shape))
    return out

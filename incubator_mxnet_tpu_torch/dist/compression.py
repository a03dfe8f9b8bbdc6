"""2-bit gradient wire packing (reference
`src/kvstore/gradient_compression.h:52-134`).

The reference packs 16 two-bit codes into each 32-bit word before the
ps-lite ZPush; here 4 codes pack into each byte — same 16× density over
fp32.  Quantization itself (threshold + error-feedback residuals) happens
in `KVStore._compress`; this module is only the host-side wire
codec: a {-thr, 0, +thr} array becomes ceil(n/4) bytes on the socket, and
the server expands back to dense before accumulating.

Code map (2 bits): 0 -> 0.0, 1 -> +threshold, 2 -> -threshold.

A copy of `incubator_mxnet_tpu/dist/compression.py` (which imports no
JAX): the bytes on the wire are the JAX package's, so either package's
server expands the other's pushes.
"""
from __future__ import annotations

import numpy as np

__all__ = ["pack_2bit", "unpack_2bit", "is_packed"]


def pack_2bit(q: np.ndarray, threshold: float) -> dict:
    """Encode a quantized {-thr, 0, +thr} float array as a 2-bit stream."""
    flat = np.asarray(q, dtype=np.float32).ravel()
    codes = np.zeros(flat.size, dtype=np.uint8)
    codes[flat > 0] = 1
    codes[flat < 0] = 2
    pad = (-codes.size) % 4
    if pad:
        codes = np.concatenate([codes, np.zeros(pad, np.uint8)])
    packed = (codes[0::4] | (codes[1::4] << 2) | (codes[2::4] << 4) |
              (codes[3::4] << 6))
    return {"packed2bit": packed, "shape": tuple(q.shape),
            "threshold": float(threshold), "dtype": str(q.dtype)}


def is_packed(value) -> bool:
    return isinstance(value, dict) and "packed2bit" in value


def unpack_2bit(msg: dict) -> np.ndarray:
    """Expand a packed 2-bit stream back to the dense quantized array."""
    packed = np.asarray(msg["packed2bit"], dtype=np.uint8)
    shape = tuple(msg["shape"])
    thr = float(msg["threshold"])
    n = int(np.prod(shape)) if shape else 1
    codes = np.empty((packed.size, 4), dtype=np.uint8)
    codes[:, 0] = packed & 3
    codes[:, 1] = (packed >> 2) & 3
    codes[:, 2] = (packed >> 4) & 3
    codes[:, 3] = (packed >> 6) & 3
    codes = codes.ravel()[:n]
    out = np.zeros(n, dtype=np.dtype(msg.get("dtype", "float32")))
    out[codes == 1] = thr
    out[codes == 2] = -thr
    return out.reshape(shape)

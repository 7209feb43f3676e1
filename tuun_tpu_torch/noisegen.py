"""Counter-based noise, shared by the oracle and the PyTorch engine.

A splitmix32-style hash of (seed, node uid, absolute sample index): a
pure function of the sample index, so noise is invariant to block
boundaries and identical in every engine.  `noise_np` is the oracle's
(numpy, uint32); `noise_torch` is the engine's, bit-identical to it on
every device.  torch has no usable uint32 arithmetic (`+` and `>>` raise
on the CPU build), so there the 32-bit words ride in int64 and are
masked to 32 bits after every operation; products are split into 16-bit
halves so that no int64 product overflows.
"""

from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF
GOLDEN = 0x9E3779B9
M1 = 0x85EBCA6B
M2 = 0xC2B2AE35
_GOLDEN = np.uint32(GOLDEN)
_M1 = np.uint32(M1)
_M2 = np.uint32(M2)


def _mix_u32(x):
    """splitmix32 finalizer on numpy uint32 arrays."""
    x = x ^ (x >> 16)
    x = x * _M1
    x = x ^ (x >> 13)
    x = x * _M2
    x = x ^ (x >> 16)
    return x


def noise_np(seed: int, uid: int, idx) -> np.ndarray:
    """Uniform [-1, 1) float32 noise for absolute sample indices `idx`."""
    with np.errstate(over="ignore"):
        idx = np.asarray(idx, dtype=np.uint32)
        x = idx * _GOLDEN + np.uint32(seed) * _M1 + np.uint32(uid) * _M2
        bits = _mix_u32(x)
    u24 = (bits >> np.uint32(8)).astype(np.float32)  # [0, 2^24)
    return (u24 * np.float32(2.0 ** -23) - np.float32(1.0)).astype(np.float32)


def mul32(x, c: int):
    """(x * c) mod 2^32 for int64 tensors x in [0, 2^32) and a constant c."""
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (hi + x * (c & 0xFFFF)) & M32


def noise_torch(seed, uid: int, idx: torch.Tensor) -> torch.Tensor:
    """Uniform [-1, 1) float32 noise for absolute sample indices `idx`.

    `seed` is a Python int or an integer tensor (taken mod 2^32), `uid`
    the node's pre-order id, `idx` an integer tensor (taken mod 2^32, as
    noise_np's uint32 conversion does)."""
    idx = idx.to(torch.int64) & M32
    if isinstance(seed, torch.Tensor):
        s = mul32(seed.to(torch.int64) & M32, M1)
    else:
        s = ((int(seed) & M32) * M1) & M32
    x = mul32(idx, GOLDEN) + s + (((int(uid) & M32) * M2) & M32)
    x = x & M32
    x = x ^ (x >> 16)
    x = mul32(x, M1)
    x = x ^ (x >> 13)
    x = mul32(x, M2)
    x = x ^ (x >> 16)
    u24 = (x >> 8).to(torch.float32)  # < 2^24: exact in float32
    return u24 * (2.0 ** -23) - 1.0

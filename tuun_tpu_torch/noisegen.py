"""Counter-based noise for the PyTorch engine.

`noise_torch` is the twin of tuun_tpu.noisegen.noise_jnp: the same
splitmix32-style hash of (seed, node uid, absolute sample index), giving
output bit-identical to `noise_np` on every device.  torch has no usable
uint32 arithmetic (`+` and `>>` raise on the CPU build), so the 32-bit
words ride in int64 and are masked to 32 bits after every operation;
products are split into 16-bit halves so that no int64 product overflows.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
GOLDEN = 0x9E3779B9
M1 = 0x85EBCA6B
M2 = 0xC2B2AE35


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

"""Double-single (two-float) arithmetic: near-f64 accuracy from f32 pairs.

Port of tuun_tpu/engine/df32.py, the arithmetic of the `exact_df`
precision.  A value is the unevaluated sum `hi + lo` of two float32 with
|lo| <= ulp(hi)/2, about 48 mantissa bits.  The engine uses it where f32
rounding is what separates fast mode from exact mode: CSine's phase
(a compensated prefix sum of the per-lane increments, reduced mod 2 pi
in df before the sin).

Every building block is a branch-free elementwise op: TwoSum, the
Veltkamp split and Dekker's product.  The error-free transformations
hold only if each `+`, `-` and `*` rounds on its own.  Eager PyTorch runs
each op as its own kernel, so nothing contracts `a*b + c` into a fused
multiply-add; `torch.compile`, or any fusion of these ops into one
kernel, would be free to contract and would break Dekker's product (and
with it df_mul, df_div_f32 and df_mod_tau).  Every constant is float32.

The compensated prefix sum, `df_cumsum`, runs the hand-written kernel
in csrc/exact.cu on a CUDA tensor (scan_ops.df_prefix_sum_f32) and its
plain doubling scan on a CPU one.  df_add is not associative, so the
kernel's grouping, the plain version's and XLA's differ in the last
compensated bits; each is f64-class against the float64 cumsum.
"""

from __future__ import annotations

import numpy as np
import torch

from . import scan_ops

f32 = torch.float32

# Veltkamp splitting constant for f32 (24-bit mantissa): 2^12 + 1.
_SPLIT = np.float32(4097.0)
# 2 pi as a df pair (hi = fl32(2 pi), lo = fl32(2 pi - hi)).
TAU_H = np.float32(6.2831855)
TAU_L = np.float32(-1.7484555e-07)


def _const(v: np.float32, like: torch.Tensor) -> torch.Tensor:
    """A float32 constant as a 0-dim tensor on like's device (a Python
    float would be rounded to like's dtype in the op; this keeps the
    value float32 whatever the op)."""
    return torch.full((), float(v), dtype=f32, device=like.device)


def two_sum(a, b):
    """Knuth's error-free transformation: a + b = s + err exactly."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def fast_two_sum(a, b):
    """Dekker's variant, valid when |a| >= |b|: a + b = s + err."""
    s = a + b
    err = b - (s - a)
    return s, err


def split(a):
    """Veltkamp split: a = hi + lo with hi, lo having <= 12 mantissa
    bits each (so their products are exact in f32)."""
    c = _const(_SPLIT, a) * a
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a, b):
    """Dekker's error-free product: a * b = p + err exactly (no FMA)."""
    p = a * b
    ah, al = split(a)
    bh, bl = split(b)
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, err


def df_add(xh, xl, yh, yl):
    """(xh+xl) + (yh+yl), renormalized to a double-single pair."""
    sh, se = two_sum(xh, yh)
    te = se + (xl + yl)
    return fast_two_sum(sh, te)


def df_mul(xh, xl, yh, yl):
    """(xh+xl) * (yh+yl), renormalized (dropping the xl*yl term, below
    the representable error)."""
    ph, pe = two_prod(xh, yh)
    pe = pe + (xh * yl + xl * yh)
    return fast_two_sum(ph, pe)


def df_div_f32(a, b):
    """a / b (f32 inputs) to double-single accuracy: one Newton
    correction of the f32 quotient via an error-free remainder."""
    q = a / b
    p, pe = two_prod(q, b)
    corr = ((a - p) - pe) / b
    return fast_two_sum(q, corr)


def df_from_f64(x, device="cpu"):
    """Splits host f64 scalars or arrays into df32 pairs on `device`."""
    x64 = np.asarray(x, np.float64)
    hi = x64.astype(np.float32)
    lo = (x64 - hi.astype(np.float64)).astype(np.float32)
    return (torch.from_numpy(np.array(hi)).to(device),
            torch.from_numpy(np.array(lo)).to(device))


def df_to_f64(h, l):
    """Host readback to f64 (for measurement only)."""
    return (torch.as_tensor(h).detach().cpu().numpy().astype(np.float64)
            + torch.as_tensor(l).detach().cpu().numpy().astype(np.float64))


def df_cumsum(x, xl=None):
    """Compensated inclusive prefix sum of f32 (or df32) values along the
    last axis: ~48-bit accumulation, where the f32 cumsum drifts by
    O(n * ulp(total)).  One launch of the df prefix-sum kernel on a CUDA
    tensor (its voices x lanes form under torch.func.vmap)."""
    if xl is None:
        xl = torch.zeros_like(x)
    return scan_ops.df_prefix_sum_f32(x, xl)


def df_mod_tau(h, l):
    """(h + l) mod 2 pi to double-single accuracy: the reduction constant
    is itself a df32 pair, and the quotient is computed in f32 (exact for
    the magnitudes a per-block phase total reaches)."""
    tau_h, tau_l = _const(TAU_H, h), _const(TAU_L, h)
    q = torch.floor(h / tau_h)
    # h - q*tau as df: q*tau in df, then df subtraction.
    qth, qtl = df_mul(q, torch.zeros_like(q), tau_h, tau_l)
    return df_add(h, l, -qth, -qtl)


def df_sin(h, l):
    """sin(h + l) ~ sin(h) + l*cos(h): the first-order correction is exact
    to f32 output precision because |l| <= ulp(h)/2."""
    return torch.sin(h) + l * torch.cos(h)

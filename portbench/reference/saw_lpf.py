"""Plain reference of the `saw_lpf` configuration, the A2 pad:
`((sawtooth(f) + sawtooth(f * 55.3/55)) * 0.5 | lpf(0.7, fc)) * 0.5` for
each voice, summed.

By std.tuun, `sawtooth(F)` is `(reset($F, -F * time) + 0.5) * 2`: a
falling ramp that restarts at each rising edge of `$F = sine(2*pi*F, 0)`,
a constant-frequency sine, so fast mode's NCO (nco.py).  Its rising
edges are the wraps of the NCO's 32-bit phase p(k) = k * inc mod 2^32,
so the samples since the last edge are floor(p(k) / inc), exactly.
`lpf(Q, fc)` is the RBJ cookbook biquad of std.tuun, `filter([b0, b1,
b2], [a1, a2])`.  A Tuun filter of K feed-forward taps reads K - 1
samples ahead of its output (the language's generator fills its input
history with the first K - 1 samples before it emits one), so it runs
here as y[k] = b0 x[k+2] + b1 x[k+1] + b2 x[k] - a1 y[k-1] - a2 y[k-2],
from y[-1] = y[-2] = 0, one sample after another.  It forgets its state
within about a hundred samples at fc >= 200 Hz (pole radius <= 0.98),
so each block is filtered from a zero state WARM samples before it:
2048 samples leave 1e-18 of the start, below float64's resolution of
the output.  A voice starts at sample 0 with a zero state, so a block
nearer the start is filtered from there, exactly.

The numbers of the program text are the language's float32 values and
each operation on them rounds to float32 (nco.f32): the frequencies and
the filter's coefficients are taken so.  With `precision` "float64" the
samples are float64: the reference; with a lower one ("bfloat16") every
operation on samples is in that dtype: the harness's control.

Plain PyTorch: nothing here imports the program.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from reference.nco import TWO_PI, f32, nco_increment, nco_phase

DETUNE = (55.3, 55.0)
Q = 0.7
WARM = 2048
GAIN = 0.5


def coefficients(Q: float, fc: float, sample_rate: int):
    """(b0, b1, b2), (a1, a2) of std.tuun's lpf, normalised by a0, each
    step rounded to float32 as the language computes it."""
    w0 = f32(f32(TWO_PI * fc) / sample_rate)
    sin_w0 = f32(np.sin(np.float64(w0)))
    cos_w0 = f32(np.cos(np.float64(w0)))
    alpha = f32(sin_w0 / f32(2.0 * Q))
    one_minus = f32(1.0 - cos_w0)
    b0 = f32(one_minus / 2.0)
    a0 = f32(1.0 + alpha)
    return ((f32(b0 / a0), f32(one_minus / a0), f32(b0 / a0)),
            (f32(f32(-2.0 * cos_w0) / a0), f32(f32(1.0 - alpha) / a0)))


def _saw(k: torch.Tensor, F: Sequence[float], sample_rate: int, dtype):
    """sawtooth(F[r]) at the sample indices k >= 0: [len(F), len(k)]."""
    inc = torch.tensor([[nco_increment(TWO_PI * x, sample_rate)] for x in F],
                       device=k.device)
    age = torch.div(nco_phase(k[None, :], inc), inc, rounding_mode="floor")
    t = age.to(dtype) / sample_rate
    Fs = torch.tensor(F, dtype=torch.float64, device=k.device)[:, None]
    return (-Fs.to(dtype) * t + 0.5) * 2.0


def mix_blocks(voices: Sequence[Dict[str, float]], starts: Sequence[int],
               n: int, sample_rate: int, precision: str = "float64",
               device="cpu") -> np.ndarray:
    """The mix of every voice over [start, start + n) for each start:
    float64 [len(starts), n]."""
    dtype = getattr(torch, precision)
    V, B = len(voices), len(starts)
    f = [v["f"] for v in voices]
    f2 = [f32(f32(x * f32(DETUNE[0])) / DETUNE[1]) for x in f]
    coef = [coefficients(Q, v["fc"], sample_rate) for v in voices]
    b = torch.tensor([c[0] for c in coef], dtype=torch.float64,
                     device=device).to(dtype).repeat(B, 1)
    a = torch.tensor([c[1] for c in coef], dtype=torch.float64,
                     device=device).to(dtype).repeat(B, 1)
    # each block's voices in rows of their own, over the samples
    # [start - WARM, start + n + 2); samples before 0 are not played
    L = WARM + n + 2
    x = torch.zeros(B * V, L, dtype=dtype, device=device)
    live = torch.ones(B * V, L - 2, dtype=torch.bool, device=device)
    for j, k0 in enumerate(starts):
        lo = max(0, k0 - WARM)
        k = torch.arange(lo, k0 + n + 2, dtype=torch.int64, device=device)
        rows = slice(j * V, (j + 1) * V)
        x[rows, L - len(k):] = (_saw(k, f, sample_rate, dtype)
                                + _saw(k, f2, sample_rate, dtype)) * 0.5
        live[rows, :L - len(k)] = False
    # the feed-forward part of every sample at once, then the feedback
    ff = (b[:, :1] * x[:, 2:] + b[:, 1:2] * x[:, 1:-1]) + b[:, 2:] * x[:, :-2]
    ff = torch.where(live, ff, torch.zeros((), dtype=dtype, device=device))
    y = torch.zeros_like(ff)
    y1 = y2 = torch.zeros(B * V, dtype=dtype, device=device)
    a1, a2 = a[:, 0], a[:, 1]
    for i in range(ff.shape[1]):
        yi = ff[:, i] - (a1 * y1 + a2 * y2)
        y[:, i] = yi
        y2, y1 = y1, yi
    out = (y[:, -n:] * GAIN).to(torch.float64).reshape(B, V, n).sum(1)
    return out.cpu().numpy()

"""Plain reference of the `fm_vibrato_exact_df` configuration: the
vibrato demo `sine(2*pi * f, depth * sine(2*pi * $rate, 0))`, rate 5 and
depth 0.3, for each voice, summed, in the exact semantics that the
`exact_df` precision holds on the card.

The exact semantics (the reference generator's f64 radian accumulator):

  * The source's numbers are float32, and each product of two of them
    rounds to float32: the carrier's angular frequency w_c = fl(2 pi f),
    the LFO's w_l = fl(2 pi 5) (std.tuun: `$rate` is
    `sine(2*pi * rate, 0)`), the vibrato's fl(2 pi lfo(k)) and the phase
    input fl(depth vib(k)), with `2 pi` std.tuun's fl(2 fl(3.14159265)).
  * A sine's phase at sample k is the exact running sum of its float32
    angular frequency over the sample rate, sum_{j<k} w(j) / sr, reduced
    mod 2 pi; its output is sin(phase + phase input), rounded to float32.

So the LFO's phase is k w_l / sr and the carrier's k w_c / sr, each in
closed form at any k; the vibrato's phase is

    S(k) = sum_{j<k} fl(2 pi lfo(j)) / sr,   lfo(j) = fl(sin(j w_l / sr)).

At a block's start S comes in closed form, the sum of the LFO's sines
(nco.sine_sum's identity with a = w_l / sr), so a block 10^8 samples in
costs what the first one does; inside the block it is the start plus
the exclusive running sum of the block's own rounded increments.  The
carrier is then y(k) = fl(sin(k w_c / sr mod 2 pi + fl(depth vib(k)))),
vib(k) = fl(sin(S(k))), and the mix is the sum over voices in float64.

Departures from the program's order of operations, each below what a
float32 output resolves:

  * the closed form at a block's start sums the LFO's unrounded terms
    2 pi sin(j w_l / sr) / sr: the float32 roundings of lfo(j) and of
    its product with 2 pi are left out there (each under 2.4e-7 of a
    term of at most 1.4e-4 rad, of either sign and cancelling over each
    LFO period, whose samples pair off by sign);
  * k w / sr and the closed form's angles are float64 (k w is exact in
    float64 below 2^29 samples, the quotient within 1e-16 of its value:
    1e-9 rad at 10^8 samples), where the program carries a double-single
    pair of about 48 bits;
  * sin is float64's, where the program's is float32's sin(hi) plus
    lo cos(hi), within a unit or two of the last float32 place.

`precision` "float64" is the reference.  "float32" computes every phase,
its sums and its reduction in float32 (a plain float32 accumulator of
the running phase): the control, the precision that `exact_df` exists
to exceed.  TF32 is off while it computes (nothing here multiplies
matrices; the switch keeps it so).

Plain PyTorch and NumPy: nothing here imports the program.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Sequence

import numpy as np
import torch

from reference.nco import TWO_PI, f32

RATE_HZ = 5.0
DEPTH = f32(0.3)
W_LFO = f32(TWO_PI * RATE_HZ)


@contextlib.contextmanager
def _no_tf32():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _phase(k: torch.Tensor, w: torch.Tensor, sr: float) -> torch.Tensor:
    """k w / sr mod 2 pi in k's dtype."""
    return torch.remainder(k * w / sr, math.tau)


def _sine_sum(k0: int, sr: float, dtype, device) -> torch.Tensor:
    """sum_{j<k0} sin(j a), a = W_LFO / sr, in closed form:
    sin(k0 a / 2) sin((k0 - 1) a / 2) / sin(a / 2), in `dtype`."""
    if k0 <= 1:
        return torch.zeros((), dtype=dtype, device=device)
    k = torch.tensor([k0, k0 - 1, 1], dtype=dtype, device=device)
    s = torch.sin(_phase(k, torch.tensor(W_LFO, dtype=dtype, device=device),
                         2.0 * sr))
    return s[0] * s[1] / s[2]


def mix_blocks(voices: Sequence[Dict[str, float]], starts: Sequence[int],
               n: int, sample_rate: int, precision: str = "float64",
               device="cpu") -> np.ndarray:
    """The mix of every voice over [start, start + n) for each start:
    float64 [len(starts), n]."""
    dtype = getattr(torch, precision)
    sr = float(sample_rate)
    with _no_tf32():
        w_c = torch.tensor([[f32(TWO_PI * v["f"])] for v in voices],
                           dtype=dtype, device=device)
        w_l = torch.tensor(W_LFO, dtype=dtype, device=device)
        out: List[np.ndarray] = []
        for k0 in starts:
            k = torch.arange(k0, k0 + n, dtype=torch.int64,
                             device=device).to(dtype)
            # the LFO and the vibrato's increments, rounded as the
            # language rounds them
            lfo = torch.sin(_phase(k, w_l, sr)).to(torch.float32)
            inc = (TWO_PI * lfo).to(torch.float32).to(dtype) / sr
            start = TWO_PI * _sine_sum(k0, sr, dtype, device) / sr
            vib = torch.sin(start + torch.cumsum(inc, 0) - inc)
            pin = (DEPTH * vib.to(torch.float32)).to(torch.float32)
            y = torch.sin(_phase(k[None, :], w_c, sr) + pin.to(dtype))
            out.append(y.to(torch.float32).to(torch.float64).sum(0)
                       .cpu().numpy())
    return np.stack(out)

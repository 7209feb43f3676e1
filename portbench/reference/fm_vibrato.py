"""Plain reference of the `fm_vibrato` configuration: the vibrato demo
`sine(2*pi * f, depth * sine(2*pi * $rate, 0))`, rate 5 and depth 0.3,
for each voice, summed.

By std.tuun, `$rate` is `sine(2*pi*rate, 0)`: a constant-frequency sine,
so fast mode's NCO (nco.py).  The vibrato `sine(2*pi * $rate, 0)` has
that sine as its angular frequency, so its phase is the running sum of
the angular frequency over the sample rate:

    S(k) = sum_{j<k} 2 pi lfo(j) / sr,   lfo(j) = sin of the NCO at rate

with the sum in closed form (nco.sine_sum), so the phase at any block
start costs nothing.  S stays within [0, 0.4] rad, so the program's
float32 accumulator never wraps and carries no growing error.  The
carrier is an NCO at f with the vibrato, times depth, added to its
angle: y(k) = sin(2 pi p(k) / 2^32 + depth sin(S(k))), p the carrier's
32-bit phase.  Everything is exact or float64: the angles come from the
NCOs' integer phases, the sums in float64.

`precision` "float64" is the reference; a lower one ("bfloat16")
computes the lanes (the LFO, the increments, their running sum, the
angles, the sines) in that dtype: the harness's control.

Plain PyTorch and NumPy: nothing here imports the program.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch

from reference.nco import TWO_PI, f32, nco_increment, nco_phase, sine_sum

RATE_HZ = 5.0
DEPTH = f32(0.3)


def mix_blocks(voices: Sequence[Dict[str, float]], starts: Sequence[int],
               n: int, sample_rate: int, precision: str = "float64",
               device="cpu") -> np.ndarray:
    """The mix of every voice over [start, start + n) for each start:
    float64 [len(starts), n]."""
    dtype = getattr(torch, precision)
    sr = float(sample_rate)
    inc_lfo = nco_increment(TWO_PI * RATE_HZ, sample_rate)
    inc_c = torch.tensor([[nco_increment(f32(TWO_PI * v["f"]), sample_rate)]
                          for v in voices], device=device)
    to_rad = math.tau / 2.0 ** 32
    out: List[np.ndarray] = []
    for k0 in starts:
        k = np.arange(k0, k0 + n, dtype=np.int64)
        lfo_ang = torch.from_numpy(nco_phase(k, inc_lfo) * to_rad)
        lfo = torch.sin(lfo_ang.to(device=device, dtype=dtype))
        inc = TWO_PI * lfo / sr
        # the vibrato's phase: its value at the block's start plus the
        # exclusive running sum in the block
        start = TWO_PI * sine_sum(k0, inc_lfo) / sr
        vib = torch.sin(torch.tensor(start, dtype=torch.float64,
                                     device=device).to(dtype)
                        + (torch.cumsum(inc, 0) - inc))
        kt = torch.from_numpy(k).to(device)
        car = nco_phase(kt[None, :], inc_c).to(torch.float64) * to_rad
        ang = car.to(dtype)
        y = torch.sin(ang + DEPTH * vib[None, :])
        out.append(y.to(torch.float64).sum(0).cpu().numpy())
    return np.stack(out)

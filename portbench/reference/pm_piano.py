"""Plain reference of the `pm_piano` configuration: the note_on element of
`pm_piano_keys(k, v)` (pm_synth.tuun), held, for each voice, summed.

By pm_synth.tuun and std.tuun, with fc = @k = pow(2, (k - 69) / 12) * 440:

    stack_a = v * sine(2*pi * fc, (6 | env_a) * sine(2*pi * fc, 0)) | env_a
    stack_b = v * v * sine(2*pi * fc_b, (10 | env_b) * sine(2*pi * mod_b, 0))
              | env_b,   fc_b = fc * 1.01,  mod_b = 2.98 * fc_b
    note_on = 0.73 * stack_a + (1 - 0.73) * stack_b

where `x | env` is x times the envelope's shape.  The envelopes are
env_minmax.tuun's ADS(a, d, s): shape = min(rise, max(fall, s)) of the
ramps rise = linear(0, 1 / a) and fall = linear(1 - a * d_slope,
d_slope), d_slope = (s - 1) / d, with linear(i, m) = i + time * m and
std.tuun's min(x, y) = alt(x - y, y, x), max(x, y) = alt(x - y, x, y)
(alt takes its second argument where the first is >= 0).  env_a is
ADS(0.01, 0.55, 0.65), env_b ADS(0.01, 0.33, 0.2).

The four sines have constant frequencies, so each is fast mode's 32-bit
NCO (nco.py), its increment taken from the frequency the program text
states, each constant rounded as the language rounds it (nco.f32; pow in
float32, as the front end folds it).  `time` is the sample index over
the rate, and the envelopes are computed as std.tuun states them, each
operation rounded to float32 as the language rounds it, so they are in
closed form at any sample.  A carrier's angle is its NCO angle, exact
from the integer phase, plus its phase input (the index times the
envelope times the modulator's sine); then sin, times velocity, the
envelope and the mix's weight; the voices summed.

Departures from the program's own order of operations, each far inside
the limit:
  * the program's NCO angle keeps the phase's top 24 bits and rounds the
    angle, the phase input and their sum to float32 (an error of at most
    ~1e-6 rad at an index of 10); the angles here are exact, the sines
    and products float64;
  * the optimizer folds `fall - s` into `time * d_slope + (i - s)` and
    reorders the products (`(sine * v) * (shape * 0.73)`); the two roundings
    differ by a float32 ulp, and a condition that rounds either way
    picks between two ramps within an ulp of each other.
In the timed window (from ~0.56 s on) both envelopes sit at their
sustain level exactly, so only the first departure counts there.

`precision` "float64" is the reference; a lower one ("bfloat16") computes
every operation on samples in that dtype, the envelopes too: the
harness's control.

Plain PyTorch and NumPy: nothing here imports the program.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch

from reference.nco import TWO_PI, f32, nco_increment, nco_phase

MIX = f32(0.73)
# (attack, decay, sustain level) of env_a and env_b, and each stack's index
ENV_A = (0.01, 0.55, 0.65)
ENV_B = (0.01, 0.33, 0.2)
INDEX_A, INDEX_B = 6.0, 10.0
DETUNE = 1.01
MOD_RATIO = 2.98
# voices whose phases are summed in one pass (bounds the temporaries)
CHUNK = 64


def pitch(k: float) -> float:
    """@k = pow(2, (k - 69) / 12) * 440 in the language's float32."""
    e = np.float32(f32(f32(k - 69.0) / 12.0))
    p = np.power(np.float32(2.0), e, dtype=np.float32)
    return f32(float(p) * 440.0)


def increments(k: float, sample_rate: int):
    """The NCO increments of stack a's carrier and modulator (one
    frequency), stack b's carrier and its modulator."""
    fc = pitch(k)
    fc_b = f32(fc * f32(DETUNE))
    mod_b = f32(f32(MOD_RATIO) * fc_b)
    return (nco_increment(f32(TWO_PI * fc), sample_rate),
            nco_increment(f32(TWO_PI * fc_b), sample_rate),
            nco_increment(f32(TWO_PI * mod_b), sample_rate))


def shape(t: torch.Tensor, a_dur: float, d_dur: float, s_level: float
          ) -> torch.Tensor:
    """ADS's shape min(rise, max(fall, s)) at the times t, each operation
    in t's dtype (float32: as the language rounds it)."""
    a, d, s = f32(a_dur), f32(d_dur), f32(s_level)
    d_slope = f32(f32(s - 1.0) / d)
    rise = 0.0 + t * f32(1.0 / a)
    fall = f32(1.0 - f32(a * d_slope)) + t * d_slope
    hi = torch.where(fall - s >= 0, fall, torch.full_like(fall, s))
    return torch.where(rise - hi >= 0, hi, rise)


def mix_blocks(voices: Sequence[Dict[str, float]], starts: Sequence[int],
               n: int, sample_rate: int, precision: str = "float64",
               device="cpu") -> np.ndarray:
    """The mix of every voice over [start, start + n) for each start:
    float64 [len(starts), n].  A voice without `k` or `v` plays middle A
    at full velocity."""
    dtype = getattr(torch, precision)
    lang = torch.float32 if dtype.itemsize >= 4 else dtype
    ks = [v.get("k", 69.0) for v in voices]
    vel = [v.get("v", 1.0) for v in voices]
    inc = torch.tensor([increments(k, sample_rate) for k in ks],
                       device=device)
    gain_a = torch.tensor([f32(x) for x in vel], dtype=torch.float64,
                          device=device)[:, None].to(dtype)
    gain_b = torch.tensor([f32(x * x) for x in vel], dtype=torch.float64,
                          device=device)[:, None].to(dtype)
    to_rad = math.tau / 2.0 ** 32
    out: List[np.ndarray] = []
    for k0 in starts:
        k = torch.arange(k0, k0 + n, dtype=torch.int64, device=device)
        t = k.to(lang) / float(sample_rate)
        env_a = shape(t, *ENV_A).to(dtype)[None, :]
        env_b = shape(t, *ENV_B).to(dtype)[None, :]
        acc = torch.zeros(n, dtype=torch.float64, device=device)
        for lo in range(0, len(voices), CHUNK):
            rows = slice(lo, lo + CHUNK)

            def angle(j):
                ph = nco_phase(k[None, :], inc[rows, j:j + 1])
                return (ph.to(torch.float64) * to_rad).to(dtype)
            sin_a = angle(0)
            car_a = torch.sin(sin_a + INDEX_A * env_a * torch.sin(sin_a))
            car_b = torch.sin(angle(1)
                              + INDEX_B * env_b * torch.sin(angle(2)))
            y = (car_a * gain_a[rows] * (env_a * MIX)
                 + car_b * gain_b[rows] * (env_b * f32(1.0 - MIX)))
            acc += y.to(torch.float64).sum(0)
        out.append(acc.cpu().numpy())
    return np.stack(out)

"""Numerical phase-accumulation study.

Port of the reference's sweep tool (src/misc/sweep.rs) — the experiment
behind its choice of an f64 phase accumulator with per-step mod-tau: render
a frequency sweep with different accumulation strategies and measure the
deviation (audible as sidebands) against the exact closed form.  Extended
with the uint32 NCO strategy the TPU engine uses for constant-frequency
oscillators.

Usage: python -m tuun_tpu_torch.tools.sweep [--seconds S] [--out-dir DIR]
Writes per-strategy difference WAVs when --out-dir is given and prints a
deviation table.
"""

from __future__ import annotations

import argparse
import math
import sys
from pathlib import Path

import numpy as np

TAU = math.tau


def sweep_frequency(n: int, sr: int, f0=20.0, f1=10000.0) -> np.ndarray:
    """Linear frequency ramp f0 -> f1 over n samples (Hz, f64)."""
    return np.linspace(f0, f1, n)


def exact_phase(freq: np.ndarray, sr: int) -> np.ndarray:
    """Reference: f64 cumulative sum of per-sample increments (exclusive)."""
    inc = freq * TAU / sr
    phase = np.concatenate([[0.0], np.cumsum(inc)[:-1]])
    return phase


def strategy_f32_accumulator(freq, sr, reduce_mod=True):
    acc = np.float32(0.0)
    out = np.empty(len(freq), np.float32)
    tau32 = np.float32(TAU)
    for i, f in enumerate(freq):
        out[i] = acc
        acc = np.float32(acc + np.float32(f * TAU / sr))
        if reduce_mod:
            acc = np.float32(np.mod(acc, tau32))
    return out.astype(np.float64)


def strategy_f64_accumulator(freq, sr, reduce_mod=True):
    acc = 0.0
    out = np.empty(len(freq), np.float64)
    for i, f in enumerate(freq):
        out[i] = acc
        acc += f * TAU / sr
        if reduce_mod:
            acc %= TAU
    return out


def strategy_closed_form_f32(freq, sr):
    """phase = t * f(t) * tau computed directly in f32 — the naive formula
    whose error grows with absolute phase (docs/sine.md's warning)."""
    t = (np.arange(len(freq)) / sr).astype(np.float32)
    # For a linear sweep, integral of f is (f0 + f(t))/2 * t.
    f_avg = ((freq[0] + freq) / 2).astype(np.float32)
    return (np.float32(TAU) * f_avg * t).astype(np.float64)


def strategy_nco_u32(freq, sr):
    """The TPU engine's uint32 NCO: phase in turns scaled to 2^32."""
    inc = np.round(freq / sr * (2.0 ** 32)).astype(np.uint64)
    acc = np.concatenate([np.zeros(1, np.uint64), np.cumsum(inc)[:-1]])
    acc = acc & np.uint64(0xFFFFFFFF)
    return (acc >> np.uint64(8)).astype(np.float64) * (TAU / 2 ** 24)


def phase_error_metrics(phase, reference):
    """Max/RMS of the *wrapped* phase difference (what you hear)."""
    d = np.angle(np.exp(1j * (phase - reference)))
    return float(np.abs(d).max()), float(np.sqrt((d ** 2).mean()))


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--sample_rate", type=int, default=44100)
    p.add_argument("--out-dir", default=None)
    args = p.parse_args(argv)

    sr = args.sample_rate
    n = int(args.seconds * sr)
    freq = sweep_frequency(n, sr)
    ref = exact_phase(freq, sr)

    strategies = {
        "f32_acc_mod": lambda: strategy_f32_accumulator(freq, sr, True),
        "f32_acc_nomod": lambda: strategy_f32_accumulator(freq, sr, False),
        "f64_acc_mod": lambda: strategy_f64_accumulator(freq, sr, True),
        "closed_form_f32": lambda: strategy_closed_form_f32(freq, sr),
        "nco_u32": lambda: strategy_nco_u32(freq, sr),
    }
    print(f"# sweep 20->10k Hz over {args.seconds}s at {sr} Hz; wrapped "
          f"phase error vs f64 exclusive cumsum")
    for name, fn in strategies.items():
        phase = fn()
        mx, rms = phase_error_metrics(phase, ref)
        db = 20 * math.log10(max(rms, 1e-12))
        print(f"{name:18s} max={mx:.3e} rad  rms={rms:.3e} rad "
              f"(~{db:.0f} dB)")
        if args.out_dir:
            from ..wav import write_wav_f32
            out = Path(args.out_dir)
            out.mkdir(parents=True, exist_ok=True)
            diff = (np.sin(phase) - np.sin(ref)).astype(np.float32)
            write_wav_f32(out / f"sweep_diff_{name}.wav", diff, sr)
    return 0


if __name__ == "__main__":
    sys.exit(main())

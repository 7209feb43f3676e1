"""Shared arithmetic of the plain references: fast mode's 32-bit NCO.

Fast mode renders every sine whose frequency is a constant as a 32-bit
phase accumulator (an NCO): the increment a sample is the frequency in
cycles a sample, taken in float32 and truncated to a multiple of 2^-32,
and the phase wraps at 2^32.  The references compute that increment from
the frequency the program text states, by this rule, and from it the
phase at any sample exactly, with integers.  A frequency one increment
apart drifts by 2^-32 of a cycle a sample, which over an offline run of
10^9 samples is a quarter of a cycle: so the references take the
increment by the configuration's rule and not from the real frequency.

Plain NumPy (and torch tensors where given): nothing here imports the
program.
"""

from __future__ import annotations

import math

import numpy as np

WORD = 1 << 32  # the NCO phase wraps here


def f32(x: float) -> float:
    """x rounded to float32, as a Python float.  The language's numbers
    are float32 and each operation on two of them rounds to float32, so
    the product of two float32 values, exact in float64, rounded by this,
    is the language's product."""
    return float(np.float32(x))


# `2*pi` of std.tuun (`pi = 3.14159265;`) in the language's arithmetic.
TWO_PI = f32(2.0 * f32(3.14159265))


def nco_increment(omega: float, sample_rate: int) -> int:
    """The 32-bit phase increment a sample of a sine at `omega` rad/s:
    frac(omega / (sample_rate * tau)) * 2^32 in float32 arithmetic,
    truncated toward zero (`omega` is rounded to float32 first, as the
    program's constants are)."""
    fc = np.float32(omega) / np.float32(sample_rate * math.tau)
    frac = np.float32(fc - np.floor(fc))
    return int(np.float32(frac * np.float32(WORD))) % WORD


def nco_phase(k, inc):
    """(k * inc) mod 2^32 for int64 sample indices k >= 0, exact: the
    product is split in 16-bit halves of inc so no term passes 2^63.
    `k` and `inc` are NumPy int64 arrays or ints, or torch int64
    tensors, which broadcast."""
    if isinstance(k, np.ndarray) or not hasattr(k, "dtype"):
        k = np.asarray(k, dtype=np.int64)
    k = k % WORD
    hi = (k * (inc >> 16)) % (1 << 16)
    return (k * (inc & 0xFFFF) + (hi << 16)) % WORD


def sine_sum(k0: int, inc: int) -> float:
    """sum over j < k0 of sin(2 pi (j * inc mod 2^32) / 2^32), in closed
    form: sin(k0 a / 2) sin((k0 - 1) a / 2) / sin(a / 2), a = 2 pi inc /
    2^32, with each angle reduced exactly in integers first."""
    if k0 <= 1 or inc == 0:
        return 0.0

    def half_angle(m: int) -> float:
        # m * a / 2 = pi * (m * inc mod 2^33) / 2^32
        return math.pi * ((m * inc) % (2 * WORD)) / WORD
    return (math.sin(half_angle(k0)) * math.sin(half_angle(k0 - 1))
            / math.sin(half_angle(1)))

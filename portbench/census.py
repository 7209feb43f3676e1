"""Arithmetic over a torch.profiler trace: the device's busy time as the
union of its operations' intervals, and the idle gaps between them.

The union is tuun_tpu_torch/tools/profile.py's `block_census`
arithmetic, copied here so that a change to the program cannot change
how the benchmark reads a trace.  Times are in the profiler's
microseconds; intervals are (start, end) pairs.
"""

from __future__ import annotations

from typing import Iterable, List, Tuple

Interval = Tuple[float, float]


def merged(spans: Iterable[Interval], lo: float, hi: float
           ) -> List[Interval]:
    """The union of `spans` clipped to [lo, hi], as sorted disjoint
    intervals."""
    out: List[Interval] = []
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in spans):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def busy_seconds(spans: Iterable[Interval], lo: float, hi: float) -> float:
    """Seconds within [lo, hi] in which at least one span ran."""
    return sum(b - a for a, b in merged(spans, lo, hi)) / 1e6


def idle_gaps(spans: Iterable[Interval], lo: float, hi: float
              ) -> List[Interval]:
    """The intervals of [lo, hi] in which no span ran, longest first."""
    gaps = []
    t = lo
    for a, b in merged(spans, lo, hi):
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if hi > t:
        gaps.append((t, hi))
    return sorted(gaps, key=lambda g: g[0] - g[1])


def idle_pct(spans: Iterable[Interval], lo: float, hi: float) -> float:
    """100 less the busy share of [lo, hi], in percent."""
    return 100.0 - 100.0 * busy_seconds(spans, lo, hi) * 1e6 / (hi - lo)

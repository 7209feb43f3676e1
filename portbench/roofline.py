"""The work of the scan kernels, counted from the shapes the engine
passes them: each input read once and each output written once,
whatever a given kernel reads again (PERF.md's bytes a lane).

  * the prefix sum and max, [rows, lanes] float32 in, float32 out:
    8 bytes a lane;
  * the affine scan (J <= 8, y out) and its deep form (J <= 16): J
    feedback coefficients, the feed-forward value and the output in
    float32 and a one-byte live flag: 4 J + 9 bytes a lane.

A share of the roofline is the least time these bytes take at the card's
peak bandwidth over the time the kernel took.
"""

from __future__ import annotations

from typing import Optional


def prefix_scan_bytes(rows: int, lanes: int) -> int:
    return 8 * rows * lanes


def affine_scan_bytes(rows: int, lanes: int, J: int) -> int:
    return (4 * J + 9) * rows * lanes


def share_pct(total_bytes: float, seconds: float, peak_bytes_per_s: float
              ) -> Optional[float]:
    """100 * (total_bytes / peak) / seconds, or None when nothing ran."""
    if seconds <= 0 or total_bytes <= 0:
        return None
    return 100.0 * total_bytes / peak_bytes_per_s / seconds

"""df_sum_rows_roofline: the df prefix sum's voices x lanes kernel
(csrc/exact.cu's df_prefix_sum via scan_ops.df_prefix_sum_rows_f32, the
exact_df phase's compensated running sum) as a share of its bytes bound,
in the traced slice.

A call reads a float32 (hi, lo) pair a lane and writes one: 16 bytes a
lane, rows x lanes of them, at the shape the program marks each call
with on the profiler's clock (`tuun.scan.df_prefix_sum_rows_f32:<rows>x
<lanes>`, engine/scan_ops.py).  Every device event of the kernel in the
slice is counted at that shape, and the sum is set against those
events' device time at the card's peak bandwidth (peaks.json).  Nothing
is read where the markers are absent or disagree on the shape, or where
the one-row entry, which launches the same kernel, is marked too (its
events could not be told apart)."""

import roofline

MARKER = "tuun.scan."
ENTRIES = ("df_prefix_sum_rows_f32", "df_prefix_sum_f32")
KERNEL = "df_prefix_sum"
BYTES_PER_LANE = 16  # hi and lo read, hi and lo written, float32


def read(run):
    tr = run.trace
    peak = run.peaks.get("hbm_bytes_per_s")
    if tr is None or peak is None:
        return None
    lo, hi = tr.slice_us
    marked = {tuple(h[0][len(MARKER):].split(":")) for h in tr.host_events
              if h[0].startswith(MARKER) and lo <= h[1] <= hi}
    marked = {m for m in marked if m[0] in ENTRIES}
    if len(marked) != 1:
        return None
    entry, shape = marked.pop()
    if entry != ENTRIES[0]:
        return None
    rows, lanes = (int(x) for x in shape.split("x"))
    calls = [(s, e) for name, s, e in tr.device_events
             if KERNEL in name and lo <= s and e <= hi]
    seconds = sum(e - s for s, e in calls) / 1e6
    total = len(calls) * BYTES_PER_LANE * rows * lanes
    return roofline.share_pct(total, seconds, peak)

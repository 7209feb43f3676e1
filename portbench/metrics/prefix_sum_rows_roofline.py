"""prefix_sum_rows_roofline: the prefix sum's voices x lanes kernel
(csrc/scan.cu's scan_single_pass via scan_ops.prefix_sum_rows_f32) as a
share of its bytes bound, in the traced slice.

Every call in a steady window renders the group's phase increments as
one [voices, window lanes] float32 scan: 8 bytes a lane (roofline.py),
against the card's peak bandwidth (peaks.json), over the kernels' device
time.  The slice is read only when the program's own launch counters
show that every prefix-scan launch in it was the rows form of a sum: the
kernel serves the prefix max too, under the same name."""

import roofline

KERNEL = "scan_single_pass"
OTHER_ENTRIES = ("prefix_sum_f32", "prefix_max_f32", "prefix_max_rows_f32")


def read(run):
    tr = run.trace
    peak = run.peaks.get("hbm_bytes_per_s")
    if tr is None or peak is None:
        return None
    if any(tr.launches.get(k, 0) for k in OTHER_ENTRIES):
        return None
    lo, hi = tr.slice_us
    calls = [(s, e) for name, s, e in tr.device_events
             if KERNEL in name and lo <= s and e <= hi]
    seconds = sum(e - s for s, e in calls) / 1e6
    total = len(calls) * roofline.prefix_scan_bytes(run.voices,
                                                    run.window_lanes)
    return roofline.share_pct(total, seconds, peak)

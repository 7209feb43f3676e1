"""affine_scan_rows_roofline: the affine scan's voices x lanes kernel
(csrc/scan.cu's affine_scan_pass via scan_ops.affine_scan_rows_f32) as a
share of its bytes bound, in the traced slice.

Every call in a steady window runs the group's biquad feedback as one
[voices, window lanes] scan of J = 2 coefficients: 4 J + 9 bytes a lane
(roofline.py), against the card's peak bandwidth (peaks.json), over the
kernels' device time.  The slice is read only when the program's own
launch counters show that every affine-scan launch in it was the rows
form."""

import roofline

KERNEL = "affine_scan_pass"
J = 2
OTHER_ENTRIES = ("affine_scan_f32",)


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
    total = len(calls) * roofline.affine_scan_bytes(run.voices,
                                                    run.window_lanes, J)
    return roofline.share_pct(total, seconds, peak)

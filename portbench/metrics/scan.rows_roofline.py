"""scan.rows_roofline: the scan kernels of the traced slice as one share
of their bytes bound, with the shapes the program says it ran them at.

The program marks each scan call with its shape on the profiler's clock
(tuun.scan.<entry>:<rows>x<lanes>[:J<J>], engine/scan_ops.py): a
captured step's calls where it is dispatched or handed to the prefetch
worker, an eager call where it is made.  For each entry the markers of
the slice name, every device event of its kernel in the slice is
counted at the bytes of the markers' shape (roofline.py), and the sum
is set against those kernels' device time at the card's peak bandwidth
(peaks.json).  Nothing is read where one entry's markers disagree on the
shape, where two entries launch the same kernel in the slice (its events
could not be told apart), or where an entry has no byte model."""

import roofline

MARKER = "tuun.scan."
# Each scan entry point's kernel, as the profiler names it (a substring
# of the device event's name).
SYMBOLS = {
    "prefix_sum_f32": "scan_single_pass",
    "prefix_max_f32": "scan_single_pass",
    "prefix_sum_rows_f32": "scan_single_pass",
    "prefix_max_rows_f32": "scan_single_pass",
    "affine_scan_f32": "affine_scan_pass",
    "affine_scan_rows_f32": "affine_scan_pass",
    "affine_scan_deep_f32": "affine_deep_pass",
    "affine_scan_deep_rows_f32": "affine_deep_pass",
    "linear_recurrence_f32": "linear_recurrence",
    "linear_recurrence_f64": "linear_recurrence",
    "linear_recurrence_rows_f32": "linear_recurrence",
    "linear_recurrence_rows_f64": "linear_recurrence",
    "df_prefix_sum_f32": "df_prefix_sum",
    "df_prefix_sum_rows_f32": "df_prefix_sum"}


def call_bytes(entry, rows, lanes, J):
    """The bytes one call moves, or None without a byte model."""
    if entry.startswith(("prefix_sum", "prefix_max")):
        return roofline.prefix_scan_bytes(rows, lanes)
    if entry.startswith("affine_scan") and J is not None:
        return roofline.affine_scan_bytes(rows, lanes, J)
    return None


def parse(name):
    """(entry, (rows, lanes, J or None)) of a marker's name."""
    entry, shape, *depth = name[len(MARKER):].split(":")
    rows, lanes = shape.split("x")
    J = int(depth[0][1:]) if depth else None
    return entry, (int(rows), int(lanes), J)


def read(run):
    tr = run.trace
    peak = run.peaks.get("hbm_bytes_per_s")
    if tr is None or peak is None:
        return None
    lo, hi = tr.slice_us
    shapes = {}
    for h in tr.host_events:
        if h[0].startswith(MARKER) and lo <= h[1] <= hi:
            entry, shape = parse(h[0])
            shapes.setdefault(entry, set()).add(shape)
    if not shapes:
        return None
    total = seconds = 0.0
    symbols = set()
    for entry, shape in shapes.items():
        symbol = SYMBOLS.get(entry)
        per_call = call_bytes(entry, *next(iter(shape)))
        if len(shape) != 1 or symbol is None or symbol in symbols \
                or per_call is None:
            return None
        symbols.add(symbol)
        calls = [(s, e) for name, s, e in tr.device_events
                 if symbol in name and lo <= s and e <= hi]
        total += len(calls) * per_call
        seconds += sum(e - s for s, e in calls) / 1e6
    return roofline.share_pct(total, seconds, peak)

"""tracker.wait_ms_per_window.offline: the serving thread's milliseconds
in the program's wait spans in the traced slice (tuun.tracker.copy_wait:
a staged copy's event, the fetch results' wait included;
tuun.tracker.prefetch_wait: the adoption of a prefetched window), over
the windows the slice opened (tuun.tracker.window_open).  Nested spans
count once.  The serving thread is the thread of the harness's
portbench.slice span.  A program without those spans reads nothing."""

import census

SLICE = "portbench.slice"
TRACKER = "tuun.tracker."
WAITS = ("tuun.tracker.copy_wait", "tuun.tracker.prefetch_wait")


def read(run):
    tr = run.trace
    if tr is None:
        return None
    serve = [h[3] for h in tr.host_events if h[0] == SLICE]
    if not serve:
        return None
    lo, hi = tr.slice_us
    spans = [h for h in tr.host_events
             if h[3] == serve[0] and h[0].startswith(TRACKER)]
    windows = sum(h[0] == TRACKER + "window_open" and lo <= h[1] < hi
                  for h in spans)
    if not windows:
        return None
    waits = census.busy_seconds([(h[1], h[2]) for h in spans
                                 if h[0] in WAITS], lo, hi)
    return 1e3 * waits / windows

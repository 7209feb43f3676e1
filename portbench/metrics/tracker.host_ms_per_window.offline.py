"""tracker.host_ms_per_window.offline: the serving thread's milliseconds
inside the program's per-block spans in the traced slice (its blocks,
tuun.tracker.render_block, and their host copies, tuun.tracker.flush),
less its milliseconds waiting there (tuun.tracker.copy_wait: a staged
copy's event; tuun.tracker.prefetch_wait: the adoption of a prefetched
window), over the windows the slice opened (tuun.tracker.window_open).
The render's tail, paid once a render and not once a window, is left
out: the final drain of the copies and the concatenation of the mix
(tuun.tracker.concat).  Nested spans count once (their union).  The
serving thread is the thread of the harness's portbench.slice span.  A
program without those spans reads nothing."""

import census

SLICE = "portbench.slice"
TRACKER = "tuun.tracker."
PER_BLOCK = ("tuun.tracker.render_block", "tuun.tracker.flush")
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
    waits = [(h[1], h[2]) for h in spans if h[0] in WAITS]
    work = [(h[1], h[2]) for h in spans if h[0] in PER_BLOCK]
    # the per-block spans' time outside every wait: |A and not W| =
    # |A or W| - |W|
    host = census.busy_seconds(work + waits, lo, hi) - \
        census.busy_seconds(waits, lo, hi)
    return 1e3 * host / windows

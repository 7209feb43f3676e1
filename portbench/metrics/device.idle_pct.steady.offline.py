"""device.idle_pct.steady.offline: 100 less the share of the traced
slice's body in which any device operation ran (the union of their
intervals).  The body runs from the first kernel the card starts once
the serving thread's first window has been opened (the end of the
slice's first tuun.tracker.window_open span) to the end of the card's
last operation in the slice.  It leaves out the lead-in, where the card
has nothing to do but the first window's input copies (device events
named Memcpy or Memset) while it waits for that window's launch and the
profiler's first buffer requests, and the tail, where the card is done
and the host finishes the render (tuun.tracker.concat).  A program
without the span reads nothing.  The serving thread is the thread of
the harness's portbench.slice span."""

import census

SLICE = "portbench.slice"
WINDOW_OPEN = "tuun.tracker.window_open"
COPIES = ("Memcpy", "Memset")


def read(run):
    tr = run.trace
    if tr is None or not tr.device_events:
        return None
    serve = [h[3] for h in tr.host_events if h[0] == SLICE]
    if not serve:
        return None
    lo, hi = tr.slice_us
    opened = [h[2] for h in tr.host_events
              if h[0] == WINDOW_OPEN and h[3] == serve[0]
              and lo <= h[1] < hi]
    if not opened:
        return None
    first = min(opened)
    starts = [s for name, s, _ in tr.device_events
              if first <= s < hi and not name.startswith(COPIES)]
    if not starts:
        return None
    start = min(starts)
    end = max(e for _, s, e in tr.device_events if s < hi)
    end = min(end, hi)
    if end <= start:
        return None
    return census.idle_pct([(s, e) for _, s, e in tr.device_events],
                           start, end)

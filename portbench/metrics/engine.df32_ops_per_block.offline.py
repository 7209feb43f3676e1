"""engine.df32_ops_per_block.offline: the device operations that the
engine's double-single arithmetic (engine/df32.py: the exact_df phase's
two-float sums, products, quotient, reduction mod 2 pi, sine and its
prefix-sum launch) enqueues in one replay of the traced slice's window
step, over the blocks a window renders.

The program counts, when it captures a step, the device operations
enqueued inside the outermost calls of df32.py's public functions (they
count under their engine node class as well), and marks them at each
replay's dispatch on the profiler's clock as `tuun.engine.df32:<n>`
(engine/capture.py), where the serve thread dispatches a window or hands
it to the prefetch worker; a step with none marks 0.  The mean n of the
markers in the slice, over the blocks a window renders (its lanes over
the block size), is the reading, so a window rendered inline (one marker
more in the slice) reads the same.  A program without the marker reads
nothing."""

MARKER = "tuun.engine.df32:"


def read(run):
    tr = run.trace
    if tr is None:
        return None
    lo, hi = tr.slice_us
    seen = [int(h[0][len(MARKER):]) for h in tr.host_events
            if h[0].startswith(MARKER) and lo <= h[1] <= hi]
    if not seen:
        return None
    return sum(seen) / len(seen) * run.block_size / run.window_lanes

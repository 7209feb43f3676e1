"""engine.sine_ops_per_block.offline: the device operations that the
engine's sine nodes (CSine) enqueue in one replay of the traced slice's
window step, over the blocks a window renders.

The program counts, when it captures a step, every device operation the
step enqueues by the engine node class whose render enqueued it, and
marks them at each replay's dispatch on the profiler's clock as
`tuun.engine.ops.<Class>:<n>` (engine/capture.py): where the serve
thread dispatches a window or hands it to the prefetch worker.  Each
marker of the class in the slice gives n, the operations of one replay;
their mean, over the blocks a window renders (its lanes over the block
size), is the reading, so a window rendered inline (one marker more in
the slice) reads the same.  A program without the markers reads
nothing."""

MARKER = "tuun.engine.ops."
CLASSES = ("CSine",)


def read(run):
    tr = run.trace
    if tr is None:
        return None
    lo, hi = tr.slice_us
    seen = {}
    for h in tr.host_events:
        if h[0].startswith(MARKER) and lo <= h[1] <= hi:
            cls, _, n = h[0][len(MARKER):].rpartition(":")
            if cls in CLASSES:
                seen.setdefault(cls, []).append(int(n))
    if not seen:
        return None
    ops = sum(sum(v) / len(v) for v in seen.values())
    return ops * run.block_size / run.window_lanes

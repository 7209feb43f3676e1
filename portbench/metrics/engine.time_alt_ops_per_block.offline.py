"""engine.time_alt_ops_per_block.offline: the device operations that the
engine's time and alt nodes (CTime, CAlt) enqueue in one replay of the
traced slice's window step, over the blocks a window renders: in the
piano these are exactly its two envelopes' ramps and their min and max.

Read from the program's `tuun.engine.ops.<Class>:<n>` markers as
engine.sine_ops_per_block.offline reads them: for each class the mean
n of its markers in the slice, summed over the classes, times the block
size over the lanes a window renders.  A program without the markers
reads nothing."""

MARKER = "tuun.engine.ops."
CLASSES = ("CTime", "CAlt")


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

"""live_block_ms_p95: the 95th percentile, over every block of the
window, of the milliseconds from the render_block call for the block to
its mix readable on the host (host clock; nearest rank).  Only a
closed-loop pull times blocks one by one: none else reports it."""

import math


def read(run):
    lat = sorted(run.block_latencies_s)
    if not lat:
        return None
    return 1e3 * lat[max(0, math.ceil(0.95 * len(lat)) - 1)]

"""device.idle_pct: 100 less the share of the traced slice's wall time
in which any device operation ran (the union of their intervals)."""

import census


def read(run):
    tr = run.trace
    if tr is None or not tr.device_events:
        return None
    return census.idle_pct([(s, e) for _, s, e in tr.device_events],
                           *tr.slice_us)

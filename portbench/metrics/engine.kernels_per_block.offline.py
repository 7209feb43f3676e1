"""engine.kernels_per_block: the device operations (kernels, copies,
sets) in the traced slice over the blocks it pulled, as the port's
tools/profile.py block_census counts them."""


def read(run):
    tr = run.trace
    if tr is None or not tr.device_events or not tr.blocks:
        return None
    lo, hi = tr.slice_us
    inside = [e for e in tr.device_events if e[2] > lo and e[1] < hi]
    return len(inside) / tr.blocks

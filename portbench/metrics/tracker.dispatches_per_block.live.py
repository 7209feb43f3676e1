"""tracker.dispatches_per_block.live: the program's Status.dispatches
(render calls issued: one a fused block or window opened, none a block
served from a window) summed over the window's blocks, over the
blocks."""


def read(run):
    if not run.blocks:
        return None
    return run.counters["dispatches"] / run.blocks

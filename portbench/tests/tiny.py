"""A cell at a tiny size on the CPU, for the tests."""

import time

import harness

# A few voices, short blocks, a window of a few blocks: what the CPU
# renders in well under a second.
TINY = {"voices": 3, "block_size": 256, "sync_interval": 4,
        "compare_blocks": 4, "pace_blocks": 8, "trace_blocks": 8}
SECONDS = 0.3


def run_tiny(name: str, seed: int = 12345678901, trace: bool = False,
             root=None, **over):
    """(cell, result of harness.run_cell) of workload `name`."""
    cell = harness.load_cell(root or harness.ROOT, name)
    res = harness.run_cell(cell, seed, SECONDS, trace, time.perf_counter(),
                           device="cpu", overrides=dict(TINY, **over))
    return cell, res


def cells():
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    return [w["name"] for w in bench["workloads"]]

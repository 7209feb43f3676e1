"""The benchmark's readers of the program's spans and scan markers
(portbench/metrics/), each on a synthetic trace of known value, as
portbench/tests/test_portbench_census.py reads the others."""

import sys
from pathlib import Path

import pytest

PORTBENCH = Path(__file__).resolve().parent.parent / "portbench"
for _p in (str(PORTBENCH.parent), str(PORTBENCH)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import harness  # noqa: E402

SERVE, WORKER = 1, 2
ROWS, LANES = 256, 1 << 20


def _run(host, device=(), slice_us=(0.0, 1000.0)):
    run = harness.Run(
        cell="fm_vibrato.offline", config={}, traffic={}, sample_rate=44100,
        block_size=65536, voices=ROWS, window_lanes=LANES, device_kind="x",
        setup_s=1.0, frontend_s=0.1, capture_seconds=[0.2], blocks=32,
        wall_s=1.0, block_latencies_s=[], counters={},
        peaks={"hbm_bytes_per_s": 3.35e12})
    host = [("portbench.slice", *slice_us, SERVE)] + list(host)
    run.trace = harness.Trace(list(device), host, slice_us, 32, {})
    return run


def _read(name, run):
    return harness.metric_reader(name).read(run)


# Two windows in [0, 1000] us on the serving thread: run_to_completion
# over [0, 900]; two blocks, [10, 100] and [400, 500], with a wait of 20
# us in the first; a block's host copy of 50 us; a copy wait of 100 us
# between them; the tail's concatenation; and spans of another thread
# and outside the slice that count for nothing.
TRACKER_SPANS = [
    ("tuun.tracker.run_to_completion", 0.0, 900.0, SERVE),
    ("tuun.tracker.render_block", 10.0, 100.0, SERVE),
    ("tuun.tracker.window_open", 10.0, 50.0, SERVE),
    ("tuun.tracker.prefetch_wait", 20.0, 40.0, SERVE),
    ("tuun.tracker.flush", 100.0, 150.0, SERVE),
    ("tuun.tracker.copy_wait", 200.0, 300.0, SERVE),
    ("tuun.tracker.render_block", 400.0, 500.0, SERVE),
    ("tuun.tracker.window_open", 400.0, 450.0, SERVE),
    ("tuun.tracker.concat", 800.0, 900.0, SERVE),
    ("aten::copy_", 950.0, 990.0, SERVE),
    ("tuun.prefetch.window", 0.0, 1000.0, WORKER),
    ("tuun.tracker.window_open", 1200.0, 1300.0, SERVE),
]


def test_tracker_host_and_wait_ms_per_window():
    run = _run(TRACKER_SPANS)
    # the blocks and the host copy less the wait inside a block: 70 + 50
    # + 100 us; the copy wait between blocks and the tail count nothing
    assert _read("tracker.host_ms_per_window.offline", run) == \
        pytest.approx((70 + 50 + 100) / 2 / 1e3)
    assert _read("tracker.wait_ms_per_window.offline", run) == \
        pytest.approx(120 / 2 / 1e3)
    # a program without the spans (the parent's): nothing read
    bare = _run([("aten::add", 0.0, 10.0, SERVE)])
    for name in ("tracker.host_ms_per_window.offline",
                 "tracker.wait_ms_per_window.offline",
                 "device.idle_pct.steady.offline", "scan.rows_roofline"):
        assert _read(name, bare) is None


def test_steady_idle_runs_from_the_first_window_open_to_the_last():
    """From the first kernel after the first window_open (which ends at
    50 us) to the end of the card's last operation: the lead-in's input
    copies and the tail count nothing."""
    copy = "Memcpy DtoD (Device -> Device)"
    device = [(copy, 0.0, 5.0), (copy, 60.0, 61.0), ("k1", 100.0, 300.0),
              ("k2", 350.0, 600.0), ("Memcpy DtoH (Device -> Pinned)",
                                     600.0, 620.0), ("k3", 700.0, 800.0)]
    run = _run(TRACKER_SPANS, device)
    # [100, 800]: busy 200 + 250 + 20 + 100 of 700 us
    assert _read("device.idle_pct.steady.offline", run) == \
        pytest.approx(100 * (1 - 570 / 700))
    # no kernel after the first window_open: nothing read
    early = _run(TRACKER_SPANS, [("k0", 0.0, 9.0), (copy, 60.0, 61.0)])
    assert _read("device.idle_pct.steady.offline", early) is None


SCAN = "void scan_single_pass<0>(float const*, float*)"
AFFINE = "void affine_scan_pass<2>(float const*)"


def test_scan_rows_roofline_counts_each_kernel_at_its_marked_shape():
    prefix = f"tuun.scan.prefix_sum_rows_f32:{ROWS}x{LANES}"
    affine = f"tuun.scan.affine_scan_rows_f32:{ROWS}x{LANES}:J2"
    device = [(SCAN, 100.0, 1100.0), (SCAN, 2100.0, 3100.0),
              (AFFINE, 3200.0, 4200.0), ("elementwise_kernel", 0.0, 90.0),
              (SCAN, 4100.0, 5200.0)]  # past the slice
    markers = [(prefix, 50.0, 50.0, SERVE), (prefix, 2000.0, 2000.0, SERVE),
               (affine, 3100.0, 3100.0, SERVE)]
    run = _run(markers, device, (0.0, 5000.0))
    # 2 GiB for each prefix call, (4 J + 9) / 8 of it for the affine one,
    # in 3 ms
    want = 100 * (8 + 8 + 17) * ROWS * LANES / 3.35e12 / 3e-3
    assert _read("scan.rows_roofline", run) == pytest.approx(want)
    # a prefix sum alone: what the reader of the cell's shapes reads
    alone = _run(markers[:2], device[:2], (0.0, 5000.0))
    assert _read("scan.rows_roofline", alone) == pytest.approx(
        _read("prefix_sum_rows_roofline", alone))


@pytest.mark.parametrize("marker", [
    "tuun.scan.prefix_sum_rows_f32:128x1048576",   # a second shape
    "tuun.scan.prefix_max_rows_f32:256x1048576",   # the same kernel
    "tuun.scan.linear_recurrence_rows_f32:256x1048576:J2",  # no model
])
def test_scan_rows_roofline_reads_nothing_it_cannot_attribute(marker):
    device = [(SCAN, 100.0, 1100.0), ("linear_recurrence<float, 0>", 0, 9)]
    markers = [(f"tuun.scan.prefix_sum_rows_f32:{ROWS}x{LANES}", 50.0,
                50.0, SERVE), (marker, 60.0, 60.0, SERVE)]
    assert _read("scan.rows_roofline", _run(markers, device)) is None

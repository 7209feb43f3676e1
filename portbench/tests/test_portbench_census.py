"""The yardstick's arithmetic: the roofline's byte counts at the cells'
shapes (PERF.md's bytes a lane: 8 for the prefix scans, 4 J + 9 for
the affine scan), and the busy union of a trace's intervals."""

import pytest

import census
import harness
import roofline


def _shape(cell_name):
    cell = harness.load_cell(harness.ROOT, cell_name)
    t = cell.traffic
    return t["voices"], t["block_size"] * t["sync_interval"]


def test_prefix_sum_rows_bytes_at_fm_vibrato_offline():
    rows, lanes = _shape("fm_vibrato.offline")
    assert (rows, lanes) == (256, 1 << 20)
    assert roofline.prefix_scan_bytes(rows, lanes) == 8 * 256 * (1 << 20)


def test_affine_scan_rows_bytes_at_saw_lpf_offline():
    rows, lanes = _shape("saw_lpf.offline")
    J = harness.metric_reader("affine_scan_rows_roofline").J
    assert J == 2
    assert roofline.affine_scan_bytes(rows, lanes, J) == \
        (4 * 2 + 9) * 256 * (1 << 20)


@pytest.mark.parametrize("J", [1, 2, 8, 16])
def test_affine_bytes_a_lane(J):
    assert roofline.affine_scan_bytes(1, 1, J) == 4 * J + 9


def test_share_of_the_bound():
    # 3.35 GB in 1 ms at 3.35 TB/s is the whole bound
    assert roofline.share_pct(3.35e9, 1e-3, 3.35e12) == pytest.approx(100)
    assert roofline.share_pct(1.0, 0.0, 3.35e12) is None


def test_busy_union_of_overlapping_and_clipped_spans():
    spans = [(0, 10), (5, 15), (20, 30), (28, 29), (40, 60), (-5, 2)]
    # within [0, 50]: [0, 15] + [20, 30] + [40, 50]
    assert census.busy_seconds(spans, 0, 50) == pytest.approx(35e-6)
    assert census.idle_pct(spans, 0, 50) == pytest.approx(30.0)
    assert census.idle_gaps(spans, 0, 50) == [(30, 40), (15, 20)]
    assert census.busy_seconds([], 0, 50) == 0.0
    assert census.idle_gaps([], 0, 50) == [(0, 50)]


def test_metric_readers_on_a_synthetic_trace():
    """The roofline and idle readers read a slice of two scan calls."""
    rows, lanes = 256, 1 << 20
    run = harness.Run(
        cell="fm_vibrato.offline", config={}, traffic={}, sample_rate=44100,
        block_size=65536, voices=rows, window_lanes=lanes, device_kind="x",
        setup_s=1.0, frontend_s=0.1, capture_seconds=[0.2], blocks=32,
        wall_s=1.0, block_latencies_s=[], counters={"dispatches": 2},
        peaks={"hbm_bytes_per_s": 3.35e12})
    # each call 1 ms: 2 GiB read and written in 1 ms is 64.1% of 3.35 TB/s
    events = [("void scan_single_pass(float const*)", 100.0, 1100.0),
              ("void scan_single_pass(float const*)", 2100.0, 3100.0),
              ("elementwise_kernel", 1100.0, 2100.0)]
    run.trace = harness.Trace(events, [], (0.0, 4000.0), 32,
                              {"prefix_sum_rows_f32": 2})
    share = harness.metric_reader("prefix_sum_rows_roofline").read(run)
    assert share == pytest.approx(100 * 8 * rows * lanes / 3.35e12 / 1e-3)
    assert harness.metric_reader("device.idle_pct.offline").read(run) == \
        pytest.approx(100 * (1 - 3000 / 4000))
    assert harness.metric_reader(
        "engine.kernels_per_block.offline").read(run) == 3 / 32
    # a prefix max in the slice would share the kernel's name: no reading
    run.trace.launches["prefix_max_rows_f32"] = 1
    assert harness.metric_reader("prefix_sum_rows_roofline").read(run) is None

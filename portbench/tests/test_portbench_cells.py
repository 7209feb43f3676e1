"""Each cell runs end to end at a tiny size on the CPU and yields the
contract's result line; run.py refuses to run without a card."""

import json
import os
import shutil
import subprocess
import sys
import time

import pytest

import harness
from tiny import SECONDS, TINY, cells, run_tiny

RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("name", cells())
def test_cell_runs_and_prints_the_result_line(name):
    cell, res = run_tiny(name)
    line = harness.result_line(cell, res, trace=False)
    assert list(line)[:5] == RESULT_KEYS and list(line)[-1] == "check"
    assert line["correct"] is True
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
    for m in line["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    assert line["device"]["count"] == 1
    chk = line["check"]["mix_err"]
    assert chk["value"] <= chk["limit"]
    json.loads(json.dumps(line))


@pytest.mark.parametrize("name", cells())
def test_traced_cell_reports_its_per_layer_metrics(name):
    cell, res = run_tiny(name, trace=True)
    line = harness.result_line(cell, res, trace=True)
    assert line["correct"] is True
    dev = line["device"]
    assert dev["window_s"] > 0 and "busy_s" in dev
    # the CPU has no device trace: only the host-side metrics read here
    host_side = {"frontend.compile_s"}
    want = {m["name"] for m in cell.per_layer} & host_side
    assert want <= set(line["metrics"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert all(len(v) <= 10 for v in line["breakdown"].values())


def test_the_live_mix_and_its_readers_run_a_tiny_cell():
    """The live mix (a closed loop) and its metric readers, which no
    cell of BENCHMARK.json uses yet (PERF.md, Open questions), so that a
    later live cell is data only."""
    config = harness.load_json(harness.HERE / "configs" / "fm_vibrato.json")
    traffic = harness.load_json(harness.HERE / "traffic" / "live.json")
    e2e = [{"name": "live_x_realtime", "unit": "x_realtime"},
           {"name": "live_block_ms_p95", "unit": "ms"}]
    per_layer = [{"name": n, "unit": "count/block"} for n in (
        "tracker.dispatches_per_block.live",
        "engine.kernels_per_block.live", "device.idle_pct.live")]
    cell = harness.Cell("fm_vibrato.live", {"chips": 1}, config, traffic,
                        {"mix_err": 0.005}, e2e, per_layer)
    res = harness.run_cell(cell, 4000000013, SECONDS, True,
                           time.perf_counter(), device="cpu",
                           overrides=TINY)
    assert res["checks"]["correct"] is True
    run = res["run"]
    assert len(run.block_latencies_s) == run.blocks > 0
    got = harness.metrics_of(run, e2e)
    assert set(got) == {"live_x_realtime", "live_block_ms_p95"}
    assert all(m["value"] > 0 for m in got.values())
    # the CPU has no device trace: the program's counter alone reads here
    layer = harness.metrics_of(run, per_layer)
    assert set(layer) == {"tracker.dispatches_per_block.live"}
    assert 0 < layer["tracker.dispatches_per_block.live"]["value"] <= 1


def test_run_without_a_card_exits_nonzero_and_prints_no_result(tmp_path):
    run = [sys.executable, "portbench/run.py", "--workload",
           "fm_vibrato.offline", "--seed", "3000000000", "--seconds", "1",
           "--trace", "0"]
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run(run, cwd=harness.ROOT, env=env, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
    # a directory with only BENCHMARK.json and the benchmark's files
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run(run, cwd=tmp_path, env=env, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.chip
def test_cell_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    p = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "fm_vibrato.offline",
         "--seed", "3000000001", "--seconds", "2", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu"

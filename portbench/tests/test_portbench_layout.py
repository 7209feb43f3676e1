"""Every configuration, traffic mix, limit, reference and metric that
BENCHMARK.json names is a file of its own found by name, and a new one
of each, added as new files, is found without editing any file."""

import json
import os
import shutil
import subprocess
import sys

import pytest

import harness
from tiny import cells

BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")


@pytest.mark.parametrize("name", cells())
def test_cell_files_load_by_name(name):
    cell = harness.load_cell(harness.ROOT, name)
    assert cell.config["name"] == cell.spec["config"]
    assert cell.traffic["name"] == cell.spec["traffic"]
    assert cell.limits["mix_err"] > 0
    assert callable(harness.reference_module(cell.config["name"]).mix_blocks)
    for m in cell.end_to_end + cell.per_layer:
        assert callable(harness.metric_reader(m["name"]).read)


@pytest.mark.parametrize("metric", [m["name"] for m in
                                    BENCH["end_to_end"] + BENCH["per_layer"]])
def test_metric_files_load_by_name(metric):
    assert callable(harness.metric_reader(metric).read)


def test_each_metric_lists_cells_that_report_what_it_moves():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert "workloads" not in moved or cell in moved["workloads"]


NEW_CELL_RUN = """
import json, sys
sys.path[:0] = ["portbench", "portbench/tests", "."]
import harness
from tiny import run_tiny
cell, res = run_tiny("fm_deep.duet", voices=2)
print(json.dumps({"traffic": cell.traffic["name"],
                  "correct": res["checks"]["correct"],
                  "harness": str(harness.HERE),
                  "metrics": harness.metrics_of(res["run"], cell.per_layer)}))
"""


def test_new_files_are_found_without_editing_any(tmp_path):
    """A copy of the benchmark gains a configuration, a traffic mix, a
    metric and a cell made of them: new files, and entries appended to
    BENCHMARK.json's lists; no file of the copy is edited."""
    root = tmp_path / "checkout"
    pb = root / "portbench"
    shutil.copytree(harness.HERE, pb,
                    ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(harness.ROOT / "tuun_tpu_torch", root / "tuun_tpu_torch")
    before = {p: p.read_bytes() for p in pb.rglob("*") if p.is_file()}
    cfg = json.loads((pb / "configs/fm_vibrato.json").read_text())
    cfg["name"] = "fm_deep"
    cfg["params"]["f"]["range"] = [48, 60]
    (pb / "configs/fm_deep.json").write_text(json.dumps(cfg))
    shutil.copy(pb / "reference/fm_vibrato.py", pb / "reference/fm_deep.py")
    mix = json.loads((pb / "traffic/live.json").read_text())
    mix.update(name="duet")
    (pb / "traffic/duet.json").write_text(json.dumps(mix))
    (pb / "limits/fm_deep.duet.json").write_text('{"mix_err": 0.03}')
    (pb / "metrics/blocks_total.py").write_text(
        "def read(run):\n    return run.blocks\n")
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append(dict(bench["configs"][0], name="fm_deep",
                                 file="portbench/configs/fm_deep.json"))
    bench["workloads"].append({"name": "fm_deep.duet", "config": "fm_deep",
                               "traffic": "duet", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "blocks_total", "unit": "count",
                               "better": "higher", "source": "host_clock",
                               "layer": "tracker",
                               "moves": "setup_s",
                               "workloads": ["fm_deep.duet"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    p = subprocess.run([sys.executable, "-c", NEW_CELL_RUN], cwd=root,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["harness"] == str(pb)
    assert out["traffic"] == "duet" and out["correct"]
    assert out["metrics"]["blocks_total"]["value"] > 0
    for path, data in before.items():
        assert path.read_bytes() == data, f"{path} was edited"

"""Nothing the harness, its metrics or the references load has a
top-level module name of JAX or of the JAX package, compared whole
(`tuun_tpu_torch` is the port, not `tuun_tpu`); the references load
nothing of the port."""

import json
import subprocess
import sys

import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "tuun_tpu"}

HARNESS_RUN = """
import json, sys
sys.path[:0] = ["portbench", "portbench/tests", "."]
import harness
from tiny import cells, run_tiny
for name in cells():
    cell, res = run_tiny(name, trace=True)
    harness.result_line(cell, res, trace=True)
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""

REFERENCES = """
import json, sys
sys.path[:0] = ["portbench"]
import harness
bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
for c in bench["configs"]:
    ref = harness.reference_module(c["name"])
    ref.mix_blocks([{"f": 220.0, "fc": 1000.0}], [0], 64, 44100)
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _top_level_names(code: str):
    p = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                       capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    return set(json.loads(p.stdout.strip().splitlines()[-1]))


def test_a_run_of_every_cell_loads_no_jax():
    names = _top_level_names(HARNESS_RUN)
    assert "tuun_tpu_torch" in names
    assert not names & FORBIDDEN, names & FORBIDDEN


def test_the_references_load_nothing_of_the_program():
    names = _top_level_names(REFERENCES)
    assert not names & (FORBIDDEN | {"tuun_tpu_torch"})


def test_forbidden_loaded_compares_whole_names():
    saved = dict(sys.modules)
    try:
        sys.modules["tuun_tpu_torch_x"] = sys
        assert "tuun_tpu" not in harness.forbidden_loaded()
        sys.modules["tuun_tpu.ir"] = sys
        assert harness.forbidden_loaded() == ["tuun_tpu"]
    finally:
        sys.modules.clear()
        sys.modules.update(saved)

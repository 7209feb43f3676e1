"""Tests of the port's benchmark harness, run on the CPU:

    python -m pytest portbench/tests -q

A test that needs the card is marked `chip` and skips itself where
torch sees no CUDA device; on the card's machine the same command runs
it.  Cells run here at a tiny size (tiny.py)."""

import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
PORTBENCH = HERE.parent
for p in (str(PORTBENCH.parent), str(PORTBENCH), str(HERE)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA device (skips itself without one)")

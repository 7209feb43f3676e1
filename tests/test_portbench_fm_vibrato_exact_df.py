"""The `fm_vibrato_exact_df` configuration's plain reference
(portbench/reference/fm_vibrato_exact_df.py) against the port's exact_df
render on the CPU, its float32 control far into a render, and the faults
of portbench/faults.py planted in its cell at a tiny size."""

import math
import sys
from pathlib import Path

import numpy as np
import pytest

PORTBENCH = Path(__file__).resolve().parent.parent / "portbench"
for _p in (str(PORTBENCH.parent), str(PORTBENCH), str(PORTBENCH / "tests")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import faults  # noqa: E402
import harness  # noqa: E402
from tiny import run_tiny  # noqa: E402

SR = 44100
BLOCK = 1024
BLOCKS = 40  # 0.93 s from sample 0
CELL = "fm_vibrato_exact_df.offline"
# The program's phases are double-single sums (~48 bits: ~1e-9 rad after
# 10^5 samples), so what is left is its float32 sine: sin(hi) + lo
# cos(hi) within an ulp or two, the output rounded to float32 (6e-8 of a
# voice's amplitude), and the mix summed in float32: ~3e-7 of the mix
# rms over 4 voices on the CPU.  1e-5 leaves it thirty times that; the
# float32 control reads 4e-4 at the first blocks and ~0.7 from 2^26
# samples on.
TOL = 1e-5
CONFIG = harness.load_json(PORTBENCH / "configs" / "fm_vibrato_exact_df.json")
REF = harness.reference_module("fm_vibrato_exact_df")


def _tracker_mix(voices):
    from tuun_tpu_torch.evaluator import Evaluator
    from tuun_tpu_torch.tracker import Tracker
    ev = Evaluator(SR, 90, harness.ROOT / "tuun_tpu_torch" / "stdlib" / "v0")
    t = Tracker(SR, BLOCK, precision=CONFIG["precision"], device="cpu",
                sync_interval=4)
    for i, w in enumerate(harness.compile_voices(CONFIG, voices, ev)):
        t.play(i, w, start=0)
    try:
        got = harness.pull_closed_loop(t, blocks=BLOCKS)
    finally:
        t.close()
    assert t.window_opens > 0  # the windows served blocks too
    assert got.start == 0
    return got.mix


@pytest.fixture(scope="module")
def held():
    """4 seeded voices through the Tracker in exact_df, every block from
    sample 0, and the reference at the same blocks."""
    voices = harness.draw_voices(CONFIG, 4, 4000000007)
    starts = [i * BLOCK for i in range(BLOCKS)]
    return voices, starts, _tracker_mix(voices), \
        REF.mix_blocks(voices, starts, BLOCK, SR)


def test_the_configuration_is_fm_vibrato_in_exact_df():
    fm = harness.load_json(PORTBENCH / "configs" / "fm_vibrato.json")
    for key in ("program", "opens", "sample_rate", "params"):
        assert CONFIG[key] == fm[key]
    assert CONFIG["precision"] == "exact_df"
    assert CONFIG["control"] == "float32" and CONFIG["reduced"] == []


def test_reference_holds_the_exact_df_tracker_mix(held):
    voices, starts, got, want = held
    assert harness.mix_error(got, want) < TOL
    for g, w in zip(got, want):
        assert harness.mix_error(g, w) < TOL


def test_the_fast_render_is_another_mix(held):
    """Fast mode's NCO phases differ from the exact ones by the float32
    rounding of each increment: already at the first second, far more
    than the exact_df render does."""
    voices, starts, got, want = held
    fast = harness.reference_module("fm_vibrato").mix_blocks(
        voices, starts, BLOCK, SR)
    assert harness.mix_error(fast, want) > 10 * harness.mix_error(got, want)


@pytest.mark.parametrize("k0", [1 << 26, 10 ** 8 + 12345])
def test_the_float32_control_fails_far_into_a_render(k0):
    """A block at least 2^26 samples in: the float32 accumulator's phase
    is off by whole samples' worth, far above the cell's limit."""
    voices = harness.draw_voices(CONFIG, 4, 4000000011)
    want = REF.mix_blocks(voices, [k0], BLOCK, SR)
    low = REF.mix_blocks(voices, [k0], BLOCK, SR,
                         precision=CONFIG["control"])
    limit = harness.load_json(PORTBENCH / "limits" / f"{CELL}.json")
    err = harness.mix_error(low, want)
    assert err > TOL and not err <= limit["mix_err"]


@pytest.mark.parametrize("k0", [2, 8821, 100003, (1 << 20) + 3])
def test_the_vibratos_closed_form_is_its_running_sum(k0):
    """The block start's sum of the LFO's sines in closed form against
    the sum itself, term by term in float64."""
    import torch
    j = np.arange(k0, dtype=np.float64)
    direct = math.fsum(np.sin(j * REF.W_LFO / SR))
    got = float(REF._sine_sum(k0, float(SR), torch.float64, "cpu"))
    assert got == pytest.approx(direct, rel=0, abs=1e-9 * max(1.0, k0 ** 0.5))


def test_consecutive_blocks_join(held):
    """A block computed from its own start's closed form continues the
    previous block's last sample: one block of 2 n from sample 0 equals
    two blocks of n."""
    voices = held[0]
    whole = REF.mix_blocks(voices, [0], 2 * BLOCK, SR)[0]
    halves = REF.mix_blocks(voices, [0, BLOCK], BLOCK, SR).reshape(-1)
    np.testing.assert_allclose(halves, whole, rtol=0, atol=1e-12)


def test_the_cell_runs_correct_at_a_tiny_size():
    cell, res = run_tiny(CELL, voices=4)
    assert res["checks"]["correct"] is True
    assert res["checks"]["mix_err"] < TOL


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_each_fault_is_not_correct(fault, monkeypatch):
    faults.plant(fault, monkeypatch.setattr)
    cell, res = run_tiny(CELL, voices=4)
    assert res["checks"]["correct"] is False
    line = harness.result_line(cell, res, trace=False)
    assert line["check"]["mix_err"]["value"] > \
        line["check"]["mix_err"]["limit"]

"""The `pm_piano` configuration's plain reference
(portbench/reference/pm_piano.py) against the port on the CPU, and the
faults of portbench/faults.py planted in its cell at a tiny size.

The voices play from sample 0 through the attack (10 ms) and both decays
(to 0.34 s and 0.56 s), which the card's timed window, from seconds in,
never reaches: there both envelopes sit at their sustain level."""

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
CELL = "pm_piano.offline"
# The program's NCO angle keeps its phase's top 24 bits (2 pi / 2^24 =
# 3.7e-7 rad) and rounds the angle, the phase input (an index of up to
# 10 times a sine) and their sum to float32: ~1e-6 rad in a carrier,
# ~1e-6 of a voice's amplitude, summed over 4 voices against a mix rms
# of ~0.6.  The port reads 4.5e-6; 5e-5 leaves it eleven times that,
# and the bfloat16 control reads ~0.2.
TOL = 5e-5
CONFIG = harness.load_json(PORTBENCH / "configs" / "pm_piano.json")
REF = harness.reference_module("pm_piano")


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
    """4 seeded voices through the Tracker, every block from sample 0,
    and the reference at the same blocks."""
    voices = harness.draw_voices(CONFIG, 4, 4000000007)
    starts = [i * BLOCK for i in range(BLOCKS)]
    return voices, starts, _tracker_mix(voices), \
        REF.mix_blocks(voices, starts, BLOCK, SR)


def test_reference_holds_the_tracker_mix_from_the_first_sample(held):
    voices, starts, got, want = held
    assert harness.mix_error(got, want) < TOL
    # each block alone, the attack's first too
    for g, w in zip(got, want):
        assert harness.mix_error(g, w) < TOL


def test_the_control_fails_the_tolerance_and_the_cells_limit(held):
    voices, starts, got, want = held
    low = REF.mix_blocks(voices, starts, BLOCK, SR,
                         precision=CONFIG["control"])
    err = harness.mix_error(low, want)
    limit = harness.load_json(PORTBENCH / "limits" / f"{CELL}.json")
    assert err > TOL and not err <= limit["mix_err"]


def test_a_mix_of_many_voices_is_the_sum_of_its_voices():
    """The reference sums its voices a chunk at a time: more voices than
    a chunk give the sum of each voice's own mix."""
    voices = harness.draw_voices(CONFIG, REF.CHUNK + 3, 4000000029)
    starts = [0, 30000, 10 ** 7]
    whole = REF.mix_blocks(voices, starts, 256, SR)
    alone = sum(REF.mix_blocks([v], starts, 256, SR) for v in voices)
    np.testing.assert_allclose(whole, alone, rtol=0, atol=1e-12)


def _sine_freqs(w, out):
    from tuun_tpu_torch import ir
    if isinstance(w, ir.Sine):
        assert isinstance(w.frequency, ir.Const)
        out.append(w.frequency.value)
    for name in getattr(w, "__dataclass_fields__", {}):
        x = getattr(w, name)
        if isinstance(x, ir.Waveform):
            _sine_freqs(x, out)
    return out


@pytest.mark.parametrize("seed", [4000000031, 4000000033, 2 ** 31 + 5])
def test_reference_takes_the_programs_frequencies(seed):
    """The four sines' frequencies, as the front end folds @k, 1.01 and
    2.98 in float32, are the reference's, so their NCO increments are
    the program's."""
    from tuun_tpu_torch.evaluator import Evaluator
    from reference.nco import TWO_PI, f32
    voices = harness.draw_voices(CONFIG, 3, seed)
    ev = Evaluator(SR, 90, harness.ROOT / "tuun_tpu_torch" / "stdlib" / "v0")
    for v, w in zip(voices, harness.compile_voices(CONFIG, voices, ev)):
        fc = REF.pitch(v["k"])
        fc_b = f32(fc * f32(1.01))
        want = sorted([f32(TWO_PI * fc)] * 2 + [
            f32(TWO_PI * fc_b), f32(TWO_PI * f32(f32(2.98) * fc_b))])
        assert sorted(_sine_freqs(w, [])) == want
        assert 65.0 < fc < 524.0


def test_envelopes_sit_at_their_sustain_levels_in_the_window():
    """From 0.56 s on both shapes are their sustain levels exactly, in
    the language's float32, up to the largest sample index a run
    reaches."""
    import torch
    k = torch.tensor([24696, 10 ** 6, 2 ** 24 + 3, 2 ** 31 - 1])
    t = k.to(torch.float32) / float(SR)
    for env in (REF.ENV_A, REF.ENV_B):
        got = REF.shape(t, *env)
        assert (got == np.float32(env[2])).all()


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

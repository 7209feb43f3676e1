"""The port's background pre-warming (tuun_tpu_torch.prewarm) on the CPU:
twins of tests/test_prewarm.py, each keeping its name, on the port's
Tracker with device="cpu", held against tuun_tpu's prewarm_structures on
the same expressions.  (test_prewarm.py's coldstart probe is bench.py's,
which the port does not have yet.)

Added: a structure whose warm-up fails is counted and reported with its
error, never dropped, and the REPL logs it.
"""

import io
import time
from pathlib import Path

import torch

import tuun_tpu
import tuun_tpu_torch
from tuun_tpu.evaluator import Evaluator as JaxEvaluator
from tuun_tpu.prewarm import prewarm_structures as jax_prewarm
from tuun_tpu.tracker import Tracker as JaxTracker
from tuun_tpu_torch.evaluator import Evaluator
from tuun_tpu_torch.prewarm import (COMMON_EXPRS, prewarm_structures,
                                    start_background)
from tuun_tpu_torch.tracker import Tracker

torch.set_num_threads(1)
STDLIB = Path(tuun_tpu_torch.__file__).resolve().parent / "stdlib" / "v0"
JAX_STDLIB = Path(tuun_tpu.__file__).resolve().parent / "stdlib" / "v0"


def _tracker():
    return Tracker(8000, 256, precision="fast", jit=True, device="cpu")


def test_prewarm_compiles_every_common_structure():
    tracker = _tracker()
    ev = Evaluator(8000, 120, STDLIB)
    warmed, failures = prewarm_structures(tracker, ev)
    assert failures == []
    # Keys-instrument entries (pm_piano_keys) warm both tuple elements
    # (note_on + note_off), so warmed >= the expression count.
    assert warmed >= len(COMMON_EXPRS)
    # The structures live in the tracker's own voice cache, keyed the
    # way a later `play` will look them up.
    assert len(tracker.cache._cache) >= len(COMMON_EXPRS)
    # tuun_tpu warms as many structures from the same list.
    jt = JaxTracker(8000, 256, precision="fast", jit=True)
    assert jax_prewarm(jt, JaxEvaluator(8000, 120, JAX_STDLIB)) == warmed
    jt.close()
    tracker.close()


def test_prewarm_failures_never_raise():
    tracker = _tracker()
    ev = Evaluator(8000, 120, STDLIB)
    bad = "this is ! not tuun ("
    warmed, failures = prewarm_structures(tracker, ev,
                                          exprs=("$440 * Qw", bad))
    assert warmed == 1  # the broken expression is skipped, not fatal
    # ... and reported with its error.
    assert [text for text, _ in failures] == [bad]
    assert isinstance(failures[0][1], Exception)
    tracker.close()


def test_prewarm_background_thread_reports_done():
    tracker = _tracker()
    ev = Evaluator(8000, 120, STDLIB)
    done = []
    t = start_background(tracker, ev, exprs=("$440 * Qw",),
                         on_done=lambda w, f: done.append((w, f)))
    assert t is not None
    t.join(timeout=120)
    assert not t.is_alive()
    assert done == [(1, [])]
    tracker.close()


def test_prewarmed_play_is_fast():
    """After pre-warming, eval -> first block of a same-structure program
    with DIFFERENT constants is quick (no compile; const leaves are
    runtime params)."""
    from tuun_tpu_torch.expr import ESeq, EWaveform
    from tuun_tpu_torch.ids import WaveformId
    from tuun_tpu_torch.optimizer import optimize
    from tuun_tpu_torch.player import build_top_level_waveform

    tracker = _tracker()
    ev = Evaluator(8000, 120, STDLIB)
    prewarm_structures(tracker, ev, exprs=("$440 * Qw",))
    compiled = len(tracker.cache._cache)
    t0 = time.perf_counter()
    out = ev.evaluate_source("$523.25 * Qw", opens=("std",))
    if isinstance(out, ESeq):
        out = out.waveform
    assert isinstance(out, EWaveform)
    w = optimize(out.waveform)
    tracker.play(WaveformId.program(0), build_top_level_waveform(w, 0.0))
    tracker.render_block()
    dt = time.perf_counter() - t0
    assert dt < 1.0, dt
    # The play found the prewarmed structure: nothing new was compiled.
    assert len(tracker.cache._cache) == compiled
    tracker.close()


def test_prewarm_counts_and_reports_a_structure_that_fails(monkeypatch):
    """A structure whose warm-up fails on the device (a build or launch
    error) is counted and reported with its error; the others still
    warm."""
    tracker = _tracker()
    ev = Evaluator(8000, 120, STDLIB)
    get = tracker.cache.get
    calls = []

    def failing(w, cfg):  # the second structure asked for fails
        calls.append(w)
        if len(calls) == 2:
            raise RuntimeError("nvcc failed on scan.cu")
        return get(w, cfg)
    monkeypatch.setattr(tracker.cache, "get", failing)
    exprs = ("$440 * Qw", "sawtooth(110) | lpf(0.9, 1800)", "$220")
    warmed, failures = prewarm_structures(tracker, ev, exprs=exprs)
    assert warmed + len(failures) == len(exprs)
    assert [text for text, _ in failures] == [exprs[1]]
    assert "nvcc failed" in str(failures[0][1])
    tracker.close()


def test_repl_logs_prewarm_failures():
    from tuun_tpu_torch.repl import Repl
    out = io.StringIO()
    r = Repl(sample_rate=8000, buffer_size=256, library_root=STDLIB,
             device="cpu", out=out)
    r.log_prewarm(9, [("pm_brass(@60, 0.5)", RuntimeError("no card"))])
    text = out.getvalue()
    assert "(prewarm: 9 common structures compiled, 1 failed)" in text
    assert "prewarm failed: pm_brass(@60, 0.5): RuntimeError: no card" in text
    r.dispatch("quit")


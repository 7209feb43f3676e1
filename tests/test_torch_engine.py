"""The port's engine (tuun_tpu_torch.engine) on the CPU.

  * A twin of tests/test_engine.py's diff_test: the port in 'exact'
    precision against the numpy oracle at several block sizes, in
    original, optimized and port-precomputed forms, over the same node
    cases.
  * The port in 'fast' precision against the JAX engine in 'fast'
    precision (jitted, timeline off) on stdlib instruments.
  * A JAX -> port state handoff mid-stream.

Each side builds its IR with its own package: the references take
tuun_tpu's IR (built with tuun_tpu.ir or tuun_tpu's front end), the port
takes its own (tuun_tpu_torch.ir or its front end), since the port's
compiler checks nodes against its own classes.  Every render asks for
the CPU explicitly: the port's entry points default to the card.
"""

import math
from importlib import import_module
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import tuun_tpu
import tuun_tpu_torch
from tuun_tpu import ir as jir
from tuun_tpu import oracle
from tuun_tpu.engine import CompiledVoice as JaxVoice
from tuun_tpu.engine import EngineConfig as JaxConfig
from tuun_tpu_torch import ir as tir
from tuun_tpu_torch import optimizer
from tuun_tpu_torch.engine import CompiledVoice, EngineConfig, render
from tuun_tpu_torch.engine.graph import params_from_numpy, state_from_numpy
from tuun_tpu_torch.engine.precompute import EnginePrecomputer

torch.set_num_threads(1)
CPU = "cpu"


def diff_test(w_ref, w, n, sr=1, atol=1e-6, blocks=(7, 16, 64),
              optimize=True, seed=0):
    """tests/test_engine.py:36-62 for the port: the same samples must come
    out of the original, optimized and precomputed forms of `w` (port IR)
    at several block sizes as the oracle renders from `w_ref` (the same
    waveform in tuun_tpu's IR).  Tolerances are test_engine.py's (exact
    mode: f64 phase and the oracle's IIR op order, so only f32 rounding
    of elementwise ops and the f64 sin differ)."""
    forms = [w, optimizer.optimize(w)] if optimize else [w]
    if optimize and not any(isinstance(x, tir.Noise) for x in w.walk()):
        forms.append(EnginePrecomputer(
            sr, seed=seed, cfg=EngineConfig(sr, "exact", CPU)).precompute(
            optimizer.optimize(w)))
    ref = oracle.render(w_ref, n, sr, seed=seed)
    for form in forms:
        for b in blocks:
            got = render(form, n, sr, precision="exact", seed=seed, block=b,
                         device=CPU)
            assert len(got) == len(ref), (
                f"length {len(got)} != {len(ref)} (block={b}) for {form}")
            np.testing.assert_allclose(got, ref, atol=atol, rtol=1e-5,
                                       err_msg=f"block={b} on {form}")


def node_cases(ir):
    """(id, waveform, n, diff_test kwargs): the node cases of
    test_engine.py, built from the IR module `ir`."""
    Alt, Append, Const, Filter = ir.Alt, ir.Append, ir.Const, ir.Filter
    Fin, Fixed, Marked = ir.Fin, ir.Fixed, ir.Marked
    Operator, Reset, Sine, Time = ir.Operator, ir.Reset, ir.Sine, ir.Time
    BinaryPointOp = ir.BinaryPointOp

    def sub_time(c):
        return BinaryPointOp(Operator.SUBTRACT, Time(), Const(c))

    def sin_waveform(freq_hz, phase):
        return Sine(BinaryPointOp(Operator.MULTIPLY, Const(math.tau),
                                  Const(freq_hz)), Const(phase))

    chirp = Sine(BinaryPointOp(Operator.MULTIPLY, Time(), Const(math.tau)),
                 Const(0.0))
    return [
        ("const", Const(3.5), 20, {}),
        ("time", Time(), 20, {}),
        ("fixed", Fixed([1, 2, 3, 4, 5]), 10, {}),
        ("fixed-empty", Fixed([]), 10, {}),
        ("add-const", BinaryPointOp(Operator.ADD, Const(1.0), Const(2.0)), 10, {}),
        ("add-fixed-const", BinaryPointOp(Operator.ADD, Fixed([1, 2, 3]),
                                          Const(10.0)), 10, {}),
        ("add-fixed", BinaryPointOp(Operator.ADD, Fixed([1, 2]),
                                    Fixed([10, 20, 30])), 10, {}),
        ("merge-fixed", BinaryPointOp(Operator.MERGE, Fixed([1, 2]),
                                      Fixed([10, 20, 30])), 10, {}),
        ("merge-const", BinaryPointOp(Operator.MERGE, Fixed([1, 2]),
                                      Const(10.0)), 10, {}),
        ("multiply", BinaryPointOp(Operator.MULTIPLY, Fixed([3, 4]),
                                   Fixed([2, 5, 1])), 10, {}),
        ("divide", BinaryPointOp(Operator.DIVIDE, Fixed([4, 9]),
                                 Fixed([2.0, 0.0])), 10, {}),
        ("power", BinaryPointOp(Operator.POWER, Fixed([2, 3, 4]),
                                Const(2.0)), 10, {}),
        ("subtract", BinaryPointOp(Operator.SUBTRACT, Time(), Const(3.0)), 10, {}),
        ("append", Append(Fixed([1.0] * 3), Fixed([2.0] * 3)), 10, {}),
        ("append-empty", Append(Fixed([]), Fixed([2.0] * 3)), 10, {}),
        ("append-fin", Append(Fin(sub_time(3.0), Const(1.0)), Const(0.5)), 10, {}),
        ("append-nested", Append(Append(Fixed([1]), Fixed([2])),
                                 Fixed([3, 4])), 10, {}),
        ("fin", Fin(sub_time(4.0), Const(3.0)), 10, {}),
        ("fin-zero", Fin(sub_time(0.0), Const(3.0)), 10, {"optimize": False}),
        ("fin-add", Fin(BinaryPointOp(Operator.ADD, Time(), Const(-5.0)),
                        Time()), 10, {}),
        ("fin-short-inner", Fin(sub_time(8.0), Fixed([1, 2, 3])), 10, {}),
        ("fin-value-path", BinaryPointOp(
            Operator.MULTIPLY, Const(2.0),
            Append(Fin(BinaryPointOp(Operator.SUBTRACT, Time(),
                                     Marked(1, Const(4.0))), Const(1.0)),
                   Fixed([1.0, 0.75, 0.5, 0.25]))), 8, {}),
        ("sine", sin_waveform(0.25, 0.0), 16, {}),
        ("sine-44k", sin_waveform(1.0, 0.0), 100, {"sr": 44100}),
        ("sine-fm", Sine(BinaryPointOp(
            Operator.MULTIPLY, BinaryPointOp(Operator.ADD, Time(), Const(10.0)),
            Const(math.tau)), Const(0.0)), 100, {"sr": 44100}),
        ("sine-pm", Sine(Const(math.tau * 100), sin_waveform(5.0, 0.0)), 200,
         {"sr": 1000}),
        ("sine-finite-phase", Sine(Const(0.0), Fixed([0.5])), 5,
         {"optimize": False}),
        ("fir-3", Filter(Time(), (Const(2.0),) * 3, ()), 8, {}),
        ("fir-fin", Filter(Fin(sub_time(5.0), Time()), (Const(2.0),) * 3, ()),
         8, {}),
        ("fir-5", Filter(Fin(sub_time(8.0), Time()), (Const(2.0),) * 5, ()),
         8, {}),
        ("fir-const", Filter(Const(1.0), (Const(0.2),) * 5, ()), 8, {}),
        ("fir-fixed-coeffs", Filter(Fixed([1.0] * 3), (Const(1.0), Fixed([2.0]),
                                                       Fixed([3.0, 3.0])), ()),
         8, {}),
        ("fir-time-coeff", Filter(Const(1.0), (Const(1.0), Time()), ()), 8, {}),
        ("iir-1", Filter(Time(), (Const(0.5),), (Const(-0.5),)), 8, {}),
        ("iir-cascade", Filter(Filter(Time(), (Const(0.5),), (Const(-0.5),)),
                               (Const(0.4),), (Const(-0.6),)), 8, {"atol": 1e-5}),
        ("biquad", Filter(Time(), (Const(0.3), Const(0.2), Const(0.1)),
                          (Const(-0.4), Const(0.05))), 32, {"atol": 1e-5}),
        ("reset-reloc", Reset(sin_waveform(0.25, 0.0), Time()), 16, {}),
        ("reset-fin-trigger", Reset(Fin(sub_time(6.0), sin_waveform(0.25, 0.0)),
                                    Time()), 10, {}),
        ("reset-fin-inner", Reset(sin_waveform(0.25, 0.0),
                                  Fin(sub_time(3.0), Time())), 16, {}),
        ("reset-pi", Reset(sin_waveform(0.25, math.pi), Time()), 16, {}),
        ("reset-stateful", Reset(sin_waveform(0.125, 0.0), chirp), 24,
         {"atol": 1e-5}),
        ("reset-dense-edges", Reset(sin_waveform(0.4, 0.0), chirp), 48,
         {"atol": 1e-5, "blocks": (16, 48)}),
        ("alt", Alt(sin_waveform(0.25, 0.0), Const(1.0), Const(-1.0)), 16, {}),
        ("alt-time", Alt(sin_waveform(0.25, 0.0), Time(),
                         BinaryPointOp(Operator.MULTIPLY, Time(), Const(-1.0))),
         16, {}),
        ("marked", Marked("x", Fixed([1, 2, 3])), 5, {}),
        ("captured", ir.Captured("stem", Fixed([1, 2, 3])), 5, {}),
    ]


JAX_CASES = {c[0]: c[1:] for c in node_cases(jir)}
PORT_CASES = {c[0]: c[1] for c in node_cases(tir)}


@pytest.mark.parametrize("case", list(JAX_CASES))
def test_diff_against_oracle(case):
    w_ref, n, kw = JAX_CASES[case]
    diff_test(w_ref, PORT_CASES[case], n, **kw)


def test_noise_bit_identical():
    ref = oracle.render(jir.Noise(), 100, 1, seed=42)
    got = render(tir.Noise(), 100, 1, precision="exact", seed=42, block=13,
                 device=CPU)
    np.testing.assert_array_equal(got, ref)


def test_capture_collection():
    w = tir.BinaryPointOp(tir.Operator.MULTIPLY,
                          tir.Captured("inner", tir.Time()), tir.Const(2.0))
    voice = CompiledVoice(w, EngineConfig(1, "exact", CPU))
    P = voice.params()
    y, v, st, caps = voice.render_block(P, voice.init(P), 8)
    cy, cs, cv = caps["inner"]
    np.testing.assert_allclose(cy.numpy(), np.arange(8, dtype=np.float32))
    assert int(cs) == 0 and int(cv) == 8


def _std_waveform(text, sr, pkg=tuun_tpu_torch, tempo=60):
    """`text` evaluated and optimized by `pkg`'s own front end and stdlib:
    tuun_tpu's IR for the references, the port's for the port."""
    ev = import_module(f"{pkg.__name__}.evaluator")
    stdlib = Path(pkg.__file__).resolve().parent / "stdlib" / "v0"
    out = ev.Evaluator(sr, tempo, stdlib).evaluate_source(text, opens=("std",))
    if isinstance(out, import_module(f"{pkg.__name__}.expr").ESeq):
        out = out.waveform
    return import_module(f"{pkg.__name__}.optimizer").optimize(out.waveform)


CORPUS_TEXTS = ["sawtooth(10)", "square(10)", "triangle(10)",
                "pulse(0.25, 5) * 0.5 + $10 * 0.5",
                "$10 | ADSR(0.1, 0.1, 0.5, 0.2, 0.1)",
                "square(10) | lpf(0.707, 20)"]


@pytest.mark.parametrize("text", CORPUS_TEXTS)
def test_corpus_exact_against_oracle(text):
    # test_engine.py's corpus_diff tolerances (atol 1e-4 with the filter).
    ref = oracle.render(_std_waveform(text, 100, tuun_tpu), 200, 100)
    got = render(_std_waveform(text, 100), 200, 100, precision="exact",
                 block=64, device=CPU)
    assert len(got) == len(ref)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)


# -- fast precision against the JAX engine -----------------------------


def _jax_fast(w, n, sr, block, seed=0):
    cfg = JaxConfig(sr, "fast", seed, jit=True, timeline=False)
    voice = JaxVoice(w, cfg)
    P = voice.params(seed)
    st = voice.init(P)
    out, total = [], 0
    while total < n:
        m = min(block, n - total)
        y, v, st, _ = voice.render_block(P, st, block, 0, m)
        v = int(v)
        out.append(np.asarray(y[:v], np.float32))
        total += v
        if v < m:
            break
    return np.concatenate(out)


# Tolerances: both engines use the same u32 NCO and the same sampled
# reset edges, so non-filtered voices differ only by the two libraries'
# float32 sin (a few ulp: 2e-6).  The prefix sum (FM phase) and the
# affine scan (filters) round in different orders in the two engines
# (torch.cumsum / doubling vs XLA's associative_scan): 1e-4 absolute on
# unit-amplitude output at these lengths.
FAST_CASES = [
    ("sawtooth(110)", 2e-6),
    ("triangle(110)", 2e-6),
    ("pulse(0.3, 110)", 2e-6),
    ("sawtooth(110) | lpf(0.7, 800)", 1e-4),
    ("sine(2*pi*(220 + 30*$(5)), 0) * 0.5", 1e-4),
    ("harmonica(0.3, 440)", 1e-4),
]


@pytest.mark.parametrize("text,atol", FAST_CASES,
                         ids=[c[0] for c in FAST_CASES])
def test_fast_matches_jax_fast(text, atol):
    sr, n, block = 8000, 2400, 1024
    want = _jax_fast(_std_waveform(text, sr, tuun_tpu), n, sr, block)
    got = render(_std_waveform(text, sr), n, sr, precision="fast",
                 block=block, device=CPU)
    assert len(got) == len(want)
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


HANDOFF_TEXT = ("sawtooth(110) * (1 + 0.5 * $(3)) | lpf(0.7, 800)"
                " | fin(time - 0.7)")


def test_state_handoff_from_jax():
    """Render k blocks in JAX, carry params and state into the port,
    continue there: the output must match an all-JAX render."""
    sr, block, k, total = 8000, 512, 3, 6
    text = HANDOFF_TEXT
    jv = JaxVoice(_std_waveform(text, sr, tuun_tpu),
                  JaxConfig(sr, "fast", jit=True, timeline=False))
    jP = jv.params(5)
    jst = jv.init(jP)
    want = []
    for i in range(total):
        y, v, jst, _ = jv.render_block(jP, jst, block)
        want.append(np.asarray(y))
        if i == k - 1:
            handoff = jax.device_get(jst)
    tv = CompiledVoice(_std_waveform(text, sr), EngineConfig(sr, "fast", CPU))
    hp = jax.device_get(jP)
    tP = params_from_numpy(hp.consts, hp.fixeds, hp.seed, CPU)
    tst = state_from_numpy(handoff, CPU)
    assert isinstance(tst, tuple) and tst[0].dtype == torch.int64
    got = []
    for _ in range(total - k):
        y, v, tst, _ = tv.render_block(tP, tst, block)
        got.append(y.numpy())
    # Same tolerance as the filtered fast case above.
    np.testing.assert_allclose(np.concatenate(got),
                               np.concatenate(want[k:]), atol=1e-4, rtol=0)

"""The port's fast mode on the CPU: literal Fin cutoffs, the relocatable
path, the analytic Reset tiers, closed-form state and note_fn.

Twins of tests/test_engine.py:316-790 (each test keeps its JAX name),
plus the port held against the JAX engine on the same IR:

  * port analytic against port generic (the tiers forced off, as
    tests/test_engine.py's _fast_render does): bit-identical;
  * port fast against JAX fast (jit=False, the associative_scan
    fallback): within 1.1e-6 absolute unless a test states otherwise;
  * lits_for, symbolic_len and a JAX state carried into the port mid-
    stream on each new state shape.

Each side builds its IR with its own package's front end.  Every render
asks for the CPU: the port's entry points default to the card.
"""

import math
from contextlib import contextmanager
from importlib import import_module
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import tuun_tpu
import tuun_tpu_torch
import tuun_tpu_torch.engine.graph as G
from tuun_tpu import ir as jir
from tuun_tpu import oracle
from tuun_tpu.engine import CompiledVoice as JaxVoice
from tuun_tpu.engine import EngineConfig as JaxConfig
from tuun_tpu_torch import ir as tir
from tuun_tpu_torch.engine import CompiledVoice, EngineConfig, render
from tuun_tpu_torch.engine.graph import (params_from_numpy,
                                         reconstruct_state, state_from_numpy)
from tuun_tpu_torch.tracker import _CompileCache

torch.set_num_threads(1)
CPU = "cpu"
# Port fast against JAX fast on the same IR: the same u32 NCO and the same
# edges, so only the two libraries' float32 sin differs (PR 1 measured
# W1/W2 within this on the CPU).
JAX_TOL = 1.1e-6


def _std(text, sr=100, pkg=tuun_tpu_torch, tempo=60):
    """`text` evaluated and optimized by `pkg`'s own front end."""
    ev = import_module(f"{pkg.__name__}.evaluator")
    stdlib = Path(pkg.__file__).resolve().parent / "stdlib" / "v0"
    out = ev.Evaluator(sr, tempo, stdlib).evaluate_source(text, opens=("std",))
    if isinstance(out, import_module(f"{pkg.__name__}.expr").ESeq):
        out = out.waveform
    return import_module(f"{pkg.__name__}.optimizer").optimize(out.waveform)


@contextmanager
def _generic_tiers():
    """Compiles every Reset on the generic sampled-sign tier."""
    C = G.CReset
    saved = {k: C.__dict__[k] for k in
             ("_analytic_ok", "_wrap_edge_info", "_wrap_edge_info_pwm")}
    C._analytic_ok = staticmethod(lambda t, c: False)
    C._wrap_edge_info = classmethod(lambda cls, t, c: None)
    C._wrap_edge_info_pwm = classmethod(lambda cls, t, c: None)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(C, k, v)


def _fast_render(w, n, sr, block, analytic=True):
    if analytic:
        return render(w, n, sr, precision="fast", block=block, device=CPU)
    with _generic_tiers():
        return render(w, n, sr, precision="fast", block=block, device=CPU)


def _jax_fast(w, n, sr, block, timeline=True):
    cfg = JaxConfig(sr, "fast", 0, jit=False, timeline=timeline)
    voice = JaxVoice(w, cfg)
    P = voice.params(0)
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


def _fast_voice(text, sr=100, **kw):
    return CompiledVoice(_std(text, sr), EngineConfig(sr, "fast", CPU, **kw))


def _root_reset(w, sr=100):
    node = CompiledVoice(w, EngineConfig(sr, "fast", CPU)).root
    while not isinstance(node, G.CReset):
        node = getattr(node, "inner", None) or node.a
    return node


def _leaves(st):
    if isinstance(st, tuple):
        return [x for s in st for x in _leaves(s)]
    return [st]


def _assert_same_state(a, b, msg=""):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb), msg
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                      err_msg=msg)


# -- the relocatable fast path ---------------------------------------------


def _reloc_case(ir):
    def sub_time(c):
        return ir.BinaryPointOp(ir.Operator.SUBTRACT, ir.Time(), ir.Const(c))
    sine = ir.Sine(ir.BinaryPointOp(ir.Operator.MULTIPLY, ir.Const(math.tau),
                                    ir.Const(0.21)), ir.Const(0.4))
    return ir.BinaryPointOp(
        ir.Operator.MERGE,
        ir.Append(ir.Fin(sub_time(3.0), sine), ir.Fin(sub_time(2.0),
                                                      ir.Time())),
        ir.BinaryPointOp(ir.Operator.MULTIPLY, ir.Noise(), ir.Const(0.5)))


def test_reloc_fast_path_matches_interval_path():
    """reloc_fast=True (one pure function of the absolute index, literal
    Fin cutoffs from lits_for) against the oracle, with mid-block starts
    and Append/Fin/Merge boundaries (exact mode, test_engine.py's 1e-6)."""
    ref = oracle.render(_reloc_case(jir), 40, 1)
    voice = CompiledVoice(_reloc_case(tir),
                          EngineConfig(1, "exact", CPU, reloc_fast=True))
    assert voice.relocatable and voice.fast_default
    P = voice.params()
    lits = voice.lits_for(P)
    assert all(isinstance(x, int) for x in lits) and len(lits) == 2
    st = voice.init(P)
    got = []
    for _ in range(5):
        y, v, st, _ = voice.render_block(P, st, 8)
        got.append(y.numpy()[:int(v)])
    got = np.concatenate(got)
    np.testing.assert_allclose(got, ref[:len(got)], atol=1e-6)
    st = voice.init(P)
    y, v, st, _ = voice.render_block(P, st, 8, s=3, e=8)
    assert np.all(y.numpy()[:3] == 0.0)
    np.testing.assert_allclose(y.numpy()[3:8], ref[:5], atol=1e-6)


def test_lits_and_symbolic_len_match_jax():
    """lits_for and symbolic_len give the JAX engine's ints, from the
    host mirror of the params (no device read)."""
    for text in ("sawtooth(10) | fin(time - 2)",
                 "($5 * Qw) \\ ($7 * Qw) \\ ($9 * Qw)",
                 "sawtooth(11) | ADSR(0.1, 0.2, 0.5, 1.0, 0.3)",
                 "<[" + ", ".join(["0 | fin(time - 0.05) | seq(time - 0.05)"]
                                  * 8) + "]>"):
        jv = JaxVoice(_std(text, 100, tuun_tpu),
                      JaxConfig(100, "fast", jit=False))
        tv = _fast_voice(text)
        jP, tP = jv.params(), tv.params()
        assert tv.lits_for(tP) == jv.lits_for(jP), text
        assert tv.lits_for(tP) is tv.lits_for(tP)  # cached per params
        assert tv.symbolic_len(tP) == jv.symbolic_len(jP), text
        assert tv.symbolic_len(tP, tv.lits_for(tP)) == \
            jv.symbolic_len(jP, jv.lits_for(jP)), text


def test_reloc_block_u32_products_past_2_32():
    """The NCO phase of an absolute index past 2^32 is (index * inc) mod
    2^32, computed without an int64 product of two u32 values."""
    voice = _fast_voice("$10", sr=48000)
    P = voice.params()
    inc = int(voice.root._nco_inc(P))
    idx = torch.tensor([0, 1, 2 ** 31 + 7, 2 ** 32 + 3, 2 ** 40 + 12345,
                        2 ** 47 - 1], dtype=torch.int64)
    want = [(int(i) * inc) % 2 ** 32 for i in idx]
    assert G._mul_u32(idx, torch.tensor(inc)).tolist() == want
    # and inside the analytic Reset's age.
    saw = _fast_voice("sawtooth(110)", sr=48000)
    r = saw.root
    while not isinstance(r, G.CReset):
        r = r.a
    sP = saw.params()
    sinc = int(r._inc(sP))
    ages = r._analytic_age(torch.tensor(sinc), idx).tolist()
    assert ages == [((int(i) * sinc) % 2 ** 32) // sinc for i in idx]


# -- analytic Reset tiers ---------------------------------------------------


ANALYTIC_TEXTS = ["sawtooth(10)", "triangle(10)", "pulse(0.5, 10)",
                  "sawtooth(7.3)", "triangle(49.9)",
                  "pulse(0.25, 5) * 0.5 + $10 * 0.5"]


@pytest.mark.parametrize("text", ANALYTIC_TEXTS)
def test_analytic_reset_matches_sampled_sign_path(text):
    """The closed-form edge tier is bit-identical to the generic sampled-
    sign tier of the port, and within JAX_TOL of JAX fast."""
    w = _std(text)
    for node in _resets(CompiledVoice(w, EngineConfig(100, "fast",
                                                      CPU)).root):
        assert node.analytic, text
    for block in (7, 64):
        new = _fast_render(w, 300, 100, block)
        old = _fast_render(w, 300, 100, block, analytic=False)
        np.testing.assert_array_equal(new, old, err_msg=f"block={block}")
    want = _jax_fast(_std(text, 100, tuun_tpu), 300, 100, 64)
    np.testing.assert_allclose(new, want, atol=JAX_TOL, rtol=0)


def _resets(node, acc=None):
    from tuun_tpu_torch.engine.timeline import CTimeline
    acc = [] if acc is None else acc
    if isinstance(node, G.CReset):
        acc.append(node)
    for a in ("a", "b", "inner", "trigger", "pos", "neg", "freq", "phase",
              "length"):
        c = getattr(node, a, None)
        if isinstance(c, G.Node):
            _resets(c, acc)
    for c in list(getattr(node, "ffs", ())) + list(getattr(node, "fbs", ())):
        _resets(c, acc)
    if isinstance(node, CTimeline):
        for inf in node.infos:
            _resets(inf.node, acc)
    return acc


def _chirp(ir):
    return ir.Sine(ir.BinaryPointOp(ir.Operator.MULTIPLY, ir.Time(),
                                    ir.Const(math.tau)), ir.Const(0.0))


@pytest.mark.parametrize("freq", [1.25, 1.13, 0.37])
def test_analytic_reset_stateful_inner_matches(freq):
    """A stateful inner (a chirp) under a tier-0 trigger: the three-render
    scheme with closed-form edges equals the generic tier, at block sizes
    the period does not divide (carried inner state is consumed)."""
    def mk(ir):
        return ir.Reset(ir.Sine(ir.Const(math.tau * freq), ir.Const(0.0)),
                        _chirp(ir))
    w = mk(tir)
    for block in (16, 61, 240):
        new = _fast_render(w, 240, 10, block)
        old = _fast_render(w, 240, 10, block, analytic=False)
        np.testing.assert_array_equal(new, old, err_msg=f"block={block}")
    # The chirp's FM phase is a prefix sum, summed in another order by
    # XLA's associative_scan: 1e-5 over 240 lanes (test_engine.py's
    # tolerance for this case against the oracle).
    want = _jax_fast(mk(jir), 240, 10, 61)
    np.testing.assert_allclose(_fast_render(w, 240, 10, 61), want,
                               atol=1e-5, rtol=0)


def test_analytic_reset_age_state_matches_generic():
    """The analytic tier's carried (sign, age) and trigger accumulator
    equal the generic tier's after every block."""
    w = _std("sawtooth(10)")
    cfg = EngineConfig(100, "fast", CPU)
    v_new = CompiledVoice(w, cfg)
    with _generic_tiers():
        v_old = CompiledVoice(w, cfg)
    P = v_new.params()
    st_n, st_o = v_new.init(P), v_old.init(P)
    for blk in (64, 64, 64, 64, 64, 13):
        _, _, st_n, _ = v_new.render_block(P, st_n, 64, 0, blk, fast=False)
        _, _, st_o, _ = v_old.render_block(P, st_o, 64, 0, blk, fast=False)
        _assert_same_state(st_n, st_o, f"block {blk}")


def test_analytic_reset_reloc_matches_interval():
    """Analytic resets are relocatable: reloc_block equals the interval
    render sample for sample across carried blocks."""
    voice = _fast_voice("(sawtooth(12) * 0.3 + triangle(7) * 0.2)"
                        " | fin(time - 2)")
    assert voice.relocatable
    P = voice.params()
    sti, stf = voice.init(P), voice.init(P)
    for _ in range(5):
        yi, vi, sti, _ = voice.render_block(P, sti, 64, fast=False)
        yf, vf, stf, _ = voice.render_block(P, stf, 64, fast=True)
        np.testing.assert_array_equal(yi.numpy(), yf.numpy())
        assert int(vi) == int(vf)


def test_analytic_reset_eligibility_gates():
    """Super-Nyquist or non-zero-phase triggers stay generic and still
    render the same bits."""
    def mk(f, ph):
        return tir.Reset(tir.Sine(tir.Const(math.tau * f), tir.Const(ph)),
                         tir.Time())
    w_sup = mk(55.0, 0.0)
    assert not _root_reset(w_sup, 100).analytic
    assert _root_reset(w_sup, 44100).analytic
    w_ph = mk(5.0, 0.5)
    assert not _root_reset(w_ph, 100).analytic
    np.testing.assert_array_equal(_fast_render(w_ph, 200, 100, 64),
                                  _fast_render(w_ph, 200, 100, 64,
                                               analytic=False))


COMPOSITE_CASES = ["reset(sawtooth(9), time * -9)",
                   "reset(pulse(0.7, 11), $25 * 0.5)",
                   "reset(pulse(0.25, 6.7), time)",
                   "reset(sawtooth(7.3), triangle(10) * 0.5)",
                   # stateful inner under the composite tier
                   "reset(pulse(0.5, 4.2), noise | lpf(0.5, 20))"]


@pytest.mark.parametrize("text", COMPOSITE_CASES)
def test_composite_trigger_reset_matches_sampled_sign_path(text):
    """Hard-sync triggers (a pointwise tree over one tier-0 Reset) take
    the composite tier, bit-identical to the generic tier."""
    w = _std(text)
    node = _root_reset(w)
    assert node.analytic and node._trig is not None, text
    for block in (7, 64):
        new = _fast_render(w, 300, 100, block)
        old = _fast_render(w, 300, 100, block, analytic=False)
        np.testing.assert_array_equal(new, old, err_msg=f"block={block}")
    if "lpf" not in text:  # the filtered case meets JAX in the handoff
        want = _jax_fast(_std(text, 100, tuun_tpu), 300, 100, 64)
        np.testing.assert_allclose(new, want, atol=JAX_TOL, rtol=0)


@pytest.mark.parametrize("text", ["reset(triangle(10), time)",
                                  "reset(pulse(0.2 + 0.9 * $(1.6), 10), time)",
                                  "reset(pulse(0.5 + 0.5 * $(49), 10), time)",
                                  "reset(square(10), time)"])
def test_composite_trigger_rejections_stay_generic(text):
    """Triggers whose rising edges are not provably the base NCO's wraps
    keep the sampled-sign tier."""
    assert not _root_reset(_std(text)).analytic, text


def test_generic_tier_workload_keeps_its_running_max():
    """chip_smoke.py's W2g: every analytic tier rejects the outer
    reset(triangle(110), ...), so it keeps the generic tier (and the
    prefix-max kernel) on the card's main path; the triangle's own two
    resets go analytic."""
    w = _std("reset(triangle(110), time * -110) * 2 | lpf(0.7, 2000) "
             "| fin(time - 60)", 48000)
    node = _root_reset(w, 48000)
    assert not node.analytic
    inner = _resets(node.trigger)
    assert len(inner) == 2 and all(r.analytic for r in inner)


PWM_CASES = ["reset(pulse(0.9 + 0.05 * $(1.6), 10), time)",
             "reset(pulse(0.5 + 0.3 * $(2.3), 7.3), $25 * 0.5)",
             "reset(pulse(0.9 + 0.05 * $(1.6), 10), noise | lpf(0.5, 20))",
             # the harmonica's `locked` shape
             "reset(pulse(0.93 + 0.05 * $(1.6), 11), pulse(0.7, 13))"]


@pytest.mark.parametrize("text", PWM_CASES)
def test_pwm_trigger_admitted_and_bit_identical(text):
    """Modulated-width triggers pass the interval verification and stay
    bit-identical to the generic tier (the sign at the last lane comes
    from the closed-form evaluation)."""
    w = _std(text)
    node = _root_reset(w)
    assert node.analytic and node._trig is not None, text
    assert node._trig[2] is None and len(node._trig[3]) >= 1, text
    for block in (7, 64):
        new = _fast_render(w, 300, 100, block)
        old = _fast_render(w, 300, 100, block, analytic=False)
        np.testing.assert_array_equal(new, old, err_msg=f"block={block}")


@pytest.mark.parametrize("text", ["reset(pulse(0.7, 11), $25 * 0.5)",
                                  "reset(pulse(0.9 + 0.05 * $(1.6), 10), "
                                  "$25 * 0.5)"])
def test_composite_trigger_state_matches_generic(text):
    """The composite and PWM tiers' carried sign, age, base accumulator
    and LFO accumulators equal the generic tier's block by block."""
    w = _std(text)
    cfg = EngineConfig(100, "fast", CPU)
    v_new = CompiledVoice(w, cfg)
    with _generic_tiers():
        v_old = CompiledVoice(w, cfg)
    root = v_new.root
    assert isinstance(root, G.CReset) and root._trig is not None
    assert isinstance(v_old.root, G.CReset) and not v_old.root.analytic
    P = v_new.params()
    st_n, st_o = v_new.init(P), v_old.init(P)
    for blk in (64, 64, 64, 13, 64):
        _, _, st_n, _ = v_new.render_block(P, st_n, 64, 0, blk, fast=False)
        _, _, st_o, _ = v_old.render_block(P, st_o, 64, 0, blk, fast=False)
        rs_n, rs_o = st_n[1], st_o[1]
        assert torch.equal(rs_n[0], rs_o[0]), "sign"
        assert torch.equal(rs_n[1], rs_o[1]), "age"
        assert torch.equal(root._acc_get(rs_n[2]), root._acc_get(rs_o[2]))
        for sn, pth in root._trig[3]:
            assert torch.equal(G._path_get(rs_n[2], pth),
                               G._path_get(rs_o[2], pth)), "lfo acc"


# -- closed-form state, state_at, note_fn -----------------------------------


RECONSTRUCT_TEXTS = ["sawtooth(10) * 0.5 + $7",
                     "triangle(12) | fin(time - 2)",
                     "($5 * Qw) \\ ($7 * Qw) \\ ($9 * Qw)",
                     "pulse(0.3, 8) + noise * 0.1",
                     "sawtooth(11) | ADSR(0.1, 0.2, 0.5, 1.0, 0.3)",
                     "alt($3, time, 0 - time)",
                     "reset(pulse(0.7, 11), $25 * 0.5) | fin(time - 3)",
                     "reset(pulse(0.9 + 0.05 * $(1.6), 10), $25 * 0.5)"]


@pytest.mark.parametrize("text", RECONSTRUCT_TEXTS)
def test_reconstruct_state_matches_continuous_render(text):
    """Rendering on from reconstruct_state's tree is bit-identical to a
    continuous interval render."""
    voice = _fast_voice(text)
    assert voice.relocatable, text
    P = voice.params()
    for pos in (0, 17, 150, 333):
        st = voice.init(P)
        full, done = [], 0
        while done < pos + 64:
            k = min(64, pos + 64 - done)
            y, _, st, _ = voice.render_block(P, st, 64, 0, k, fast=False)
            full.append(y.numpy()[:k])
            done += k
        full = np.concatenate(full)
        st2 = (torch.tensor(pos),
               reconstruct_state(voice.root, P, voice.lits_for(P), pos))
        y, _, _, _ = voice.render_block(P, st2, 64, 0, 64, fast=False)
        np.testing.assert_array_equal(y.numpy(), full[pos:pos + 64],
                                      err_msg=f"pos={pos}")


@pytest.mark.parametrize("text", ["sawtooth(10) * 0.5 + $7",
                                  "alt($3 | fin(time - 2), time, 0 - time)"])
def test_state_at_uses_reconstruction_for_fast_voices(text):
    """state_at's closed form equals the replay (an alt whose finite
    trigger ends mid-history never advances its branches past it)."""
    voice = _fast_voice(text)
    assert voice.relocatable
    P = voice.params()
    st_fast = voice.state_at(P, 333)
    voice.relocatable = False  # force the replay
    st_replay = voice.state_at(P, 333, n=64)
    voice.relocatable = True
    la, lb = _leaves(st_fast), _leaves(st_replay)
    assert len(la) == len(lb)
    for a, b in zip(la, lb):
        np.testing.assert_allclose(a.numpy(), b.numpy())


def test_state_at_matches_jax_state_at():
    """The port's closed-form state equals the JAX engine's, leaf by
    leaf (JAX's u32 and int32 leaves as int64)."""
    for text in ("sawtooth(10) * 0.5 + $7",
                 "reset(pulse(0.9 + 0.05 * $(1.6), 10), $25 * 0.5)"):
        jv = JaxVoice(_std(text, 100, tuun_tpu),
                      JaxConfig(100, "fast", jit=False))
        tv = _fast_voice(text)
        want = state_from_numpy(jax.device_get(jv.state_at(jv.params(),
                                                           333)), CPU)
        _assert_same_state(tv.state_at(tv.params(), 333), want, text)


NOTE_CASES = [("harmonica(0.5, 40)", (37, 37, 19)),
              ("sawtooth(10) * 0.5 + $7 | fin(time - 1)", (64, 64)),
              ("{[$40 + $60, $50 + $55]} | fin(time - 1)", (64, 40))]


@pytest.mark.parametrize("text,sizes", NOTE_CASES,
                         ids=[c[0] for c in NOTE_CASES])
def test_note_fn_matches_block_by_block(text, sizes):
    """note_fn renders the whole piece as the block-by-block path does:
    the same last block, valid end and state; with passes=3, y sums the
    passes' last blocks and v and the state are the last pass's."""
    voice = _fast_voice(text)
    P = voice.params()
    n = 64
    fn = voice.render_fn(n, P=P)
    st = voice.init(P)
    s = torch.tensor(0)
    for m in sizes:
        y, v, st, _ = fn(P, st, s, torch.tensor(m))
    y2, v2, st2 = voice.note_fn(sizes, n=n, P=P)(P)
    np.testing.assert_array_equal(y.numpy(), y2.numpy())
    assert int(v) == int(v2)
    _assert_same_state(st, st2)
    yk, vk, stk = voice.note_fn(sizes, n=n, P=P, passes=3)(P)
    np.testing.assert_allclose(yk.numpy(), 3.0 * y2.numpy(), rtol=1e-6)
    assert int(vk) == int(v2)
    _assert_same_state(st2, stk)


def test_structure_cache_separates_trigger_const_decisions():
    """The tracker's per-structure cache never hands a same-shaped
    waveform with other trigger consts the first one's edge algebra."""
    cache = _CompileCache()
    cfg = EngineConfig(100, "fast", CPU)
    optimize = import_module("tuun_tpu_torch.optimizer").optimize

    def mk(ir, f, ph):
        return ir.Reset(ir.Sine(ir.Const(math.tau * f), ir.Const(ph)),
                        ir.Time())
    cv_zero = cache.get(optimize(mk(tir, 5, 0.0)), cfg)
    w_shift = optimize(mk(tir, 5, 0.5))
    cv_shift = cache.get(w_shift, cfg)
    assert cv_zero is not cv_shift
    P = cv_shift.params_for(w_shift)
    y, v, st, _ = cv_shift.render_block(P, cv_shift.init(P), 100)
    ref = oracle.render(mk(jir, 5, 0.5), 100, 100)
    np.testing.assert_allclose(y.numpy()[:len(ref)], ref, atol=2e-4)
    assert cache.get(optimize(mk(tir, 5.0, 0.0)), cfg) is \
        cache.get(optimize(mk(tir, 7.3, 0.0)), cfg)
    assert cache.get(optimize(mk(tir, 60.0, 0.0)), cfg) is not \
        cache.get(optimize(mk(tir, 5.0, 0.0)), cfg)


@pytest.mark.parametrize("text", ["$7 + time", "sawtooth(10) + noise * 0.1"])
def test_reconstruct_position_past_2_31_matches_the_render(text):
    """The JAX engine wraps positions at 2^31; the port's are int64 and do
    not, so the closed form follows the port's own render past 2^31: a
    block rendered from the state at 2^31 - 3 ends in the state that
    reconstruct_state gives 64 samples later, and its samples equal the
    fast path's at those absolute indices."""
    voice = _fast_voice(text)
    P = voice.params()
    lits = voice.lits_for(P)
    r = 2 ** 31 - 3
    st = (torch.tensor(r), reconstruct_state(voice.root, P, lits, r))
    y, _, st, _ = voice.render_block(P, st, 64, fast=False)
    assert int(st[0]) == r + 64 > 2 ** 31
    _assert_same_state(st[1], reconstruct_state(voice.root, P, lits, r + 64))
    yf, _, _, _ = voice.render_block(P, (torch.tensor(r), ()), 64, fast=True)
    np.testing.assert_array_equal(y.numpy(), yf.numpy())


# -- JAX state carried into the port ----------------------------------------


HANDOFF_CASES = [
    # analytic Reset (PWM tier) with a stateful (FM) inner
    "reset(pulse(0.9 + 0.05 * $(1.6), 10), sine(2*pi*(5 + 30*time), 0))",
    # a timeline (its position scalar) inside a Fin
    "<[" + ", ".join(f"$({30 + 5 * i}) * 0.2 | fin(time - 0.3) "
                     f"| seq(time - 0.3)" for i in range(8)) + "]>",
]


@pytest.mark.parametrize("text", HANDOFF_CASES)
def test_state_handoff_from_jax_fast_mode(text):
    """k blocks in JAX, then params and state carried into the port: the
    rest matches an all-JAX render (analytic Reset and timeline state)."""
    sr, block, k, total = 100, 64, 3, 6
    jv = JaxVoice(_std(text, sr, tuun_tpu), JaxConfig(sr, "fast", jit=False))
    jP = jv.params(5)
    jst = jv.init(jP)
    want = []
    for i in range(total):
        y, _, jst, _ = jv.render_block(jP, jst, block)
        want.append(np.asarray(y))
        if i == k - 1:
            handoff = jax.device_get(jst)
    tv = _fast_voice(text, sr)
    hp = jax.device_get(jP)
    tP = params_from_numpy(hp.consts, hp.fixeds, hp.seed, CPU)
    tst = state_from_numpy(handoff, CPU)
    got = []
    for _ in range(total - k):
        y, _, tst, _ = tv.render_block(tP, tst, block)
        got.append(y.numpy())
    # The FM inner's phase is a prefix sum that XLA's associative_scan
    # sums in another order: 1e-5, as test_engine.py's chirp cases.
    tol = 1e-5 if "time)" in text else JAX_TOL
    np.testing.assert_allclose(np.concatenate(got), np.concatenate(want[k:]),
                               atol=tol, rtol=0)


def test_state_handoff_from_jax_fast_path():
    """A JAX voice on its reloc fast path carries (position, untouched
    tree) into the port's fast path."""
    text = "sawtooth(12) * 0.3 + triangle(7) * 0.2 | fin(time - 5)"
    jv = JaxVoice(_std(text, 100, tuun_tpu),
                  JaxConfig(100, "fast", jit=False, reloc_fast=True))
    jP = jv.params()
    jst = jv.init(jP)
    for _ in range(3):
        _, _, jst, _ = jv.render_block(jP, jst, 64)
    yj, vj, _, _ = jv.render_block(jP, jst, 64)
    tv = _fast_voice(text, reloc_fast=True)
    hp = jax.device_get(jP)
    tP = params_from_numpy(hp.consts, hp.fixeds, hp.seed, CPU)
    yt, vt, _, _ = tv.render_block(tP, state_from_numpy(
        jax.device_get(jst), CPU), 64)
    assert int(vt) == int(vj)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=JAX_TOL,
                               rtol=0)

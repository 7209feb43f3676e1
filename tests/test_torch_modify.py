"""Live edits in the port on the CPU: Tracker.modify and carry_state.

  * carry_state against tuun_tpu.tracker.carry_state, node kind by node
    kind: the same random old state (made from one seed with numpy in
    the JAX engine's layout and moved over with state_from_numpy) and the
    same fresh state go through both, and the results agree leaf by leaf,
    bit for bit.  The port's own init must have the layout of the JAX
    engine's (shapes and dtypes, through state_from_numpy), or a carry
    would silently reset a node.  Where a sine's frequency stops being
    constant, JAX carries its u32 NCO word into the new float phase slot
    (it compares shapes only); the port compares dtypes too and keeps
    the fresh phase.
  * Twins of tests/test_tracker.py's and tests/test_timeline.py's Modify
    tests, each keeping its JAX name, at their sizes (100 Hz / 16-sample
    blocks; 8 kHz / 64 for the timeline), plus the stop ramp at 48 kHz.
  * The port's tracker against tuun_tpu's on one script of plays and
    modifies (a group member, a filter coefficient, a stop): fast mode at
    sync_interval 1 and 4 with fuse_blocking within
    test_torch_stream.py's 8 * 2e-5 and the same dispatches every block,
    exact mode within 1e-5.
  * The steps built after a modify read nothing on the host.
"""

import math
from importlib import import_module
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import test_torch_groups as ttg
import test_torch_stream as tts
import tuun_tpu
import tuun_tpu_torch
from tuun_tpu import ir as jir
from tuun_tpu import sliders as jsliders
from tuun_tpu import tracker as jtracker
from tuun_tpu.engine import CompiledVoice as JaxVoice
from tuun_tpu.engine import EngineConfig as JaxConfig
from tuun_tpu_torch import ir, sliders
from tuun_tpu_torch import tracker as T
from tuun_tpu_torch.engine import CompiledVoice, EngineConfig
from tuun_tpu_torch.engine import timeline as tl
from tuun_tpu_torch.engine.capture import flatten
from tuun_tpu_torch.engine.graph import state_from_numpy
from tuun_tpu_torch.ids import MarkId, WaveformId
from tuun_tpu_torch.player import Player, build_top_level_waveform
from tuun_tpu_torch.tracker import Tracker, carry_state

torch.set_num_threads(1)
CPU = "cpu"
P = WaveformId.program
MARK = "m"


# -- carry_state against tuun_tpu's -----------------------------------------


def _ops(I):
    C = I.Const

    def op(name):
        return lambda a, b: I.BinaryPointOp(getattr(I.Operator, name), a, b)
    add, sub, mul, merge = (op(n) for n in
                            ("ADD", "SUBTRACT", "MULTIPLY", "MERGE"))

    def tone(f):
        return I.Sine(C(math.tau * f), C(0.0))

    def marked(x=None):
        return I.Marked(MARK, C(1.0) if x is None else x)
    return C, add, sub, mul, merge, tone, marked


def _stable_fb(J):
    poles = [0.9, -0.8, 0.7, -0.6, 0.5, 0.4, -0.3, 0.2, -0.1][:J]
    return [float(x) for x in np.real(np.poly(poles))[1:]]


def _carry_case(name, I):
    """(precision, old waveform with a Marked(MARK) subtree)."""
    C, add, sub, mul, merge, tone, marked = _ops(I)
    T_ = I.Time()
    lpf = ((C(0.2), C(0.3), C(0.2)), (C(-0.5), C(0.25)))
    if name == "sine":
        return "exact", mul(tone(5), marked())
    if name == "nco_sine":
        return "fast", mul(tone(5), marked())
    if name == "fm_sine":
        return "fast", mul(I.Sine(add(C(math.tau * 5), mul(C(3.0), tone(2))),
                                  C(0.0)), marked())
    if name == "filter_j2_fast":
        return "fast", I.Filter(mul(tone(7), marked()), *lpf)
    if name == "filter_coefficient":
        return "fast", I.Filter(tone(7), (marked(C(0.2)),) + lpf[0][1:],
                                lpf[1])
    if name == "filter_j9_exact":
        return "exact", I.Filter(mul(tone(7), marked()), (C(0.5), C(0.25)),
                                 tuple(C(a) for a in _stable_fb(9)))
    if name == "reset_analytic":
        return "fast", mul(I.Reset(tone(3), mul(T_, C(2.0))), marked())
    if name == "reset_generic":
        return "fast", mul(I.Reset(mul(tone(3), tone(0.7)), mul(T_, C(2.0))),
                           marked())
    if name == "append":
        return "fast", I.Append(I.Fin(sub(T_, C(0.3)), tone(4)),
                                mul(tone(6), marked()))
    if name == "fin":
        return "fast", I.Fin(sub(T_, C(5.0)), mul(tone(4), marked()))
    if name == "merge":
        return "fast", merge(I.Fin(sub(T_, C(0.5)), tone(3)),
                             mul(tone(5), marked()))
    raise KeyError(name)


CARRY_CASES = ["sine", "nco_sine", "fm_sine", "filter_j2_fast",
               "filter_coefficient", "filter_j9_exact", "reset_analytic",
               "reset_generic", "append", "fin", "merge"]
CARRY_SR = 48000


def _random_like(tree, rng):
    """A random state tree of the JAX engine's layout and dtypes."""
    if isinstance(tree, tuple):
        return tuple(_random_like(x, rng) for x in tree)
    a = np.asarray(tree)
    if a.dtype == np.bool_:
        return rng.random(a.shape) < 0.5
    if a.dtype == np.uint32:
        return rng.integers(0, 2 ** 32, a.shape, dtype=np.uint64).astype(
            np.uint32)
    if np.issubdtype(a.dtype, np.integer):
        return rng.integers(0, 1000, a.shape).astype(a.dtype)
    return rng.standard_normal(a.shape).astype(a.dtype)


def _layout(tree):
    return [(tuple(x.shape), x.dtype) for x in flatten(tree)[1]]


def _jax_and_port(name, seed=7):
    """Both packages' (old_w, new_w, old state, fresh state, carried) for
    a carry of case `name`, the port's states built from the JAX ones."""
    out = []
    for pkg, I, sl in ((tuun_tpu, jir, jsliders), (tuun_tpu_torch, ir,
                                                   sliders)):
        prec, old_w = _carry_case(name, I)
        new_w = I.substitute(old_w, MARK, sl.make_ramp(1.0, 0.5, 0.02))
        out.append((prec, old_w, new_w))
    (prec, jold, jnew), (_, pold, pnew) = out
    jcfg = JaxConfig(CARRY_SR, prec, 0, False)
    jo, jn = JaxVoice(jold, jcfg), JaxVoice(jnew, jcfg)
    j_old_init = jax.device_get(jo.init(jo.params(seed))[1])
    j_fresh = jax.device_get(jn.init(jn.params(seed))[1])
    old_np = _random_like(j_old_init, np.random.default_rng(seed))
    j_carried = jtracker.carry_state(jold, jnew, old_np, j_fresh,
                                     replaced_mark=MARK)
    pcfg = EngineConfig(CARRY_SR, prec, CPU)
    po, pn = CompiledVoice(pold, pcfg), CompiledVoice(pnew, pcfg)
    # The port's own inits have the JAX engine's layouts.
    assert _layout(po.init(po.params(seed))[1]) == \
        _layout(state_from_numpy(j_old_init, CPU))
    assert _layout(pn.init(pn.params(seed))[1]) == \
        _layout(state_from_numpy(j_fresh, CPU))
    old = state_from_numpy(old_np, CPU)
    fresh = state_from_numpy(j_fresh, CPU)
    carried = carry_state(pold, pnew, old, fresh, replaced_mark=MARK)
    return j_carried, old, fresh, carried


@pytest.mark.parametrize("name", CARRY_CASES)
def test_carry_state_matches_tuun_tpu(name):
    j_carried, old, fresh, carried = _jax_and_port(name)
    got = flatten(carried)[1]
    want = flatten(state_from_numpy(j_carried, CPU))[1]
    assert len(got) == len(want)
    for i, (x, y) in enumerate(zip(got, want)):
        assert x.dtype == y.dtype and torch.equal(x, y), (name, i)
    # Not vacuous: something was carried, and the marked subtree (whose
    # structure changed) kept its fresh state.
    assert any(not torch.equal(x, f) for x, f in
               zip(got, flatten(fresh)[1]))
    assert len(got) != len(flatten(old)[1]) or any(
        not torch.equal(x, o) for x, o in zip(got, flatten(old)[1]))


def test_carry_state_keeps_the_fresh_phase_where_nco_becomes_float():
    """`$rate` under a slider: a constant frequency (a u32 NCO word) that
    a ramp makes dynamic (a float phase).  JAX's shape-only match carries
    the u32 word into the float slot; the port keeps the fresh phase."""
    words = []
    for I, sl in ((jir, jsliders), (ir, sliders)):
        C, add, sub, mul, merge, tone, marked = _ops(I)
        old = I.Sine(mul(C(math.tau), marked(C(5.0))), C(0.0))
        words.append((old, I.substitute(old, MARK,
                                         sl.make_ramp(5.0, 8.0, 0.02))))
    (jold, jnew), (pold, pnew) = words
    jcfg = JaxConfig(CARRY_SR, "fast", 0, False)
    jo, jn = JaxVoice(jold, jcfg), JaxVoice(jnew, jcfg)
    j_old = jax.device_get(jo.init(jo.params(0))[1])
    j_old = (np.uint32(123456789),) + tuple(j_old[1:])
    j_fresh = jax.device_get(jn.init(jn.params(0))[1])
    j_carried = jtracker.carry_state(jold, jnew, j_old, j_fresh, MARK)
    assert np.asarray(j_carried[0]).dtype == np.uint32
    assert np.asarray(j_fresh[0]).dtype == np.float32
    carried = carry_state(pold, pnew, state_from_numpy(j_old, CPU),
                          state_from_numpy(j_fresh, CPU), MARK)
    assert carried[0].dtype == torch.float32 and float(carried[0]) == 0.0


def test_mark_ids_reach_fin_lengths_and_filter_coefficients():
    C, add, sub, mul, merge, tone, marked = _ops(ir)
    w = ir.Filter(ir.Fin(ir.Marked("len", sub(ir.Time(), C(1.0))), tone(3)),
                  (ir.Marked("ff", C(0.5)),), (C(-0.5),))
    assert T._mark_ids(w) == {"len", "ff"}
    assert T._mark_ids(w) is T._mark_ids(w)  # memoized per object
    assert {m.mark_id for m in T.collect_marks(w, 100, "a", 0)} == set()


# -- twins of the JAX tracker's Modify tests ----------------------------------


def make_tracker(sr=100, block=16, **kw):
    kw.setdefault("precision", "exact")
    return Tracker(sr, block, device=CPU, **kw)


def test_modify_preserves_untouched_state():
    # A sine keeps its phase across a Modify of an unrelated mark.
    sr = 100
    t = make_tracker(sr=sr)
    w = ir.BinaryPointOp(
        ir.Operator.MULTIPLY,
        ir.Sine(ir.Const(math.tau * 5), ir.Const(0.0)),
        ir.Marked("gain", ir.Const(1.0)))
    t.play("a", w)
    t.render_block()
    t.modify("a", "gain", ir.Const(0.5))
    out2, _ = t.render_block()
    expected = 0.5 * np.sin(
        math.tau * 5 * np.arange(16, 32) / sr).astype(np.float32)
    np.testing.assert_allclose(out2, expected, atol=1e-5)
    assert t.op_log[-1][0] == "modify"
    assert set(t.op_log[-1][3]) == {"interrupt", "materialize", "splice",
                                    "carry", "marks"}
    t.stop_all()


@pytest.mark.parametrize("sr,block", [(100, 16), (48000, 1024)])
def test_stop_ramp(sr, block):
    t = make_tracker(sr=sr, block=block)
    p = Player(t, tempo=60, beats_per_measure=4)
    p.play("a", ir.Const(1.0))
    t.render_block()
    p.stop("a")
    out = t.run_to_completion(max_seconds=2.0)
    # A 50 ms ramp (5 samples at 100 Hz), then silence and retirement.
    ramp = round(0.05 * sr)
    assert not t.active
    assert out[0] == 1.0
    assert out[ramp - 1] < 1.0
    assert np.all(np.diff(out[:ramp]) < 0)
    np.testing.assert_array_equal(out[ramp:], 0.0)


def test_modify_without_the_mark_is_a_no_op():
    """A Modify whose mark is absent from the voice must not degrade it:
    a slider move fanned out to every voice must leave mark-less voices
    on exact retirement."""
    t = Tracker(100, 16, precision="fast", device=CPU)
    t.play("a", ir.Fin(ir.BinaryPointOp(
        ir.Operator.SUBTRACT, ir.Time(), ir.Const(1.0)),
        ir.Sine(ir.Const(5.0), ir.Const(0.0))))
    t.render_block()
    v = [v for v in t.active if v.id == "a"][0]
    total_before = v.total_len
    compiled_before = v.compiled
    assert total_before is not None
    logged = len(t.op_log)
    t.modify("a", "no-such-mark", ir.Const(0.5))
    assert v.total_len == total_before        # exact retirement kept
    assert v.compiled is compiled_before      # no recompile, no splice
    assert t._ends_known and len(t.op_log) == logged
    t.stop_all()


def test_fused_session_step_modify_falls_back_and_reengages():
    blocks = 6
    ref = tts._session_tracker(fuse=False)
    got_t = tts._session_tracker(fuse=True)
    for t in (ref, got_t):
        for _ in range(3):
            t.render_block()  # the fused path engaged on the fused tracker
    assert got_t.render_block()[1].dispatches == 1
    ref.render_block()
    ramp = sliders.make_ramp(1.0, 0.25, 0.16)
    want, got = [], []
    for t, out in ((ref, want), (got_t, got)):
        t.modify(P(0), MarkId.AMPLITUDE, ramp)
        for _ in range(blocks):
            out.append(t.render_block()[0])
    np.testing.assert_allclose(np.concatenate(got), np.concatenate(want),
                               atol=1e-6)
    # Re-engaged after the set stabilized again.
    assert got_t.render_block()[1].dispatches == 1
    for t in (ref, got_t):
        t.close()


def _modified_window(fuse: bool, evict: bool = False):
    """6 blocks, a modify (inside the fused tracker's window), 10 blocks."""
    ramp = sliders.make_ramp(1.0, 0.0, 0.16)
    t = tts._window_tracker(fuse=fuse, lookahead=4 if fuse else 1)
    mix = [tts.host(t.render_block()[0]) for _ in range(6)]
    assert (t._window is not None) == fuse  # mid-window on the fused one
    if evict:
        t._fused_cache.clear()  # the window's step evicted mid-window
    t.modify(P(0), MarkId.AMPLITUDE, ramp)
    assert t._window is None
    mix += [tts.host(t.render_block()[0]) for _ in range(10)]
    t.close()
    return np.concatenate(mix)


def test_lookahead_window_interrupt_modify_exact():
    """A Modify mid-window interrupts: served sub-blocks replay so the
    splice lands at exactly the commanded block boundary."""
    np.testing.assert_allclose(_modified_window(True),
                               _modified_window(False), atol=1e-6)


def test_lookahead_window_interrupt_survives_cache_eviction():
    """If the window's step disappears mid-window, the interrupt replay
    falls back to the per-block paths instead of skipping the served
    blocks (which would freeze every state while `now` advances)."""
    np.testing.assert_allclose(_modified_window(True, evict=True),
                               _modified_window(False), atol=1e-6)


def test_window_prefetch_invalidated_by_modify_between_windows():
    """A Modify at a window boundary (no interrupt: the window just
    ended) replaces the voice's params and state, so the prefetched next
    window must be discarded: adopting it would play the pre-Modify
    waveform for a whole window."""
    ramp = sliders.make_ramp(1.0, 0.5, 0.16)
    outs = []
    for fuse in (False, True):
        t = tts._window_tracker(fuse=fuse, lookahead=4 if fuse else 1)
        mix = []
        for _ in range(11):  # lands on a window boundary when fused
            mix.append(tts.host(t.render_block()[0]))
            if fuse:
                tts._drain_prefetch(t)
        if fuse:
            assert t._window is None  # no interrupt: between windows
            assert t._prefetch is not None
        t.modify(P(0), MarkId.AMPLITUDE, ramp)
        for _ in range(10):
            mix.append(tts.host(t.render_block()[0]))
            if fuse:
                tts._drain_prefetch(t)
        if fuse:
            assert t.prefetch_misses >= 1  # the stale one was rejected
        outs.append(np.concatenate(mix))
        t.close()
    np.testing.assert_allclose(outs[1], outs[0], atol=1e-6)


TL_SR = 8000


def _marked_chain(n_leaves=8, seg_samples=40, value=1.0):
    """<seg, seg, ...> in IR: each segment a Marked constant of known
    length, so that Modify can splice into a leaf."""
    def seg():
        return ir.Fin(
            ir.BinaryPointOp(ir.Operator.SUBTRACT, ir.Time(),
                             ir.Const(seg_samples / TL_SR)),
            ir.Marked("m", ir.Const(value)))
    w = seg()
    for _ in range(n_leaves - 1):
        w = ir.Append(seg(), w)
    return w


def test_tracker_modify_timeline_voice_falls_back_and_keeps_time():
    w = _marked_chain()
    t = Tracker(TL_SR, block_size=64, device=CPU)
    t.play("a", w)
    y1, _ = t.render_block()  # samples [0, 64)
    np.testing.assert_allclose(y1, 1.0)
    # Splice the marked constant: the remaining leaves play at 2.0 from
    # the current position on (the state-carrying plain-tree path).
    t.modify("a", "m", ir.Const(2.0))
    voice = t.active[0]
    assert voice.lits is None and not voice.compiled._has_timeline
    y2, _ = t.render_block()  # samples [64, 128)
    np.testing.assert_allclose(y2, 2.0)
    out = t.run_to_completion()
    np.testing.assert_allclose(out[: 8 * 40 - 128], 2.0)


def _slider_phrase(pkg, value=0.5):
    """A score of 8 notes (a timeline) whose every note is scaled by the
    slider `g`, evaluated and optimized by `pkg`'s own front end."""
    ev = _mod(pkg, "evaluator")
    expr, ids = _mod(pkg, "expr"), _mod(pkg, "ids")
    stdlib = Path(pkg.__file__).resolve().parent / "stdlib" / "v0"
    bindings = [expr.SourceBinding(expr.BOpen(("__prelude",))),
                expr.SourceBinding(expr.BOpen(("std",)))]
    _mod(pkg, "sliders").append_slider_bindings(
        [expr.Slider("g", expr.SliderLinear(value, 0.0, 1.0))], [value],
        ids.MarkId.slider, bindings)
    text = "<[" + ", ".join(f"$({200 + 40 * i}) * g | fin(time - 0.03) "
                            "| seq(time - 0.03)" for i in range(8)) + "]>"
    out = ev.Evaluator(TL_SR, 60, stdlib).evaluate_source(text, bindings)
    if isinstance(out, expr.ESeq):
        out = out.waveform
    return _mod(pkg, "optimizer").optimize(out.waveform)


def test_modify_timeline_voice_replays_its_state_like_jax():
    """A slider move on a score compiled to a timeline: both sides
    recompile as plain trees and the old tree's state is rebuilt by
    state_at's replay from sample 0 (an op_log phase), as in tuun_tpu."""
    outs = []
    for pkg, make in ((tuun_tpu, lambda: jtracker.Tracker(
            TL_SR, 64, precision="fast", jit=True)),
            (tuun_tpu_torch, lambda: Tracker(TL_SR, 64, device=CPU))):
        t = make()
        t.fuse_blocking = True
        t.play("a", _slider_phrase(pkg))
        assert t.active == [] and t.render_block()
        assert t.active[0].compiled._has_timeline
        mix = [np.asarray(t.render_block()[0]) for _ in range(4)]
        mark = _mod(pkg, "ids").MarkId.slider("g")
        t.modify("a", mark, _mod(pkg, "sliders").make_ramp(
            0.5, 0.9, 64 / TL_SR))
        assert not t.active[0].compiled._has_timeline
        assert "state_at" in t.op_log[-1][3]
        mix += [np.asarray(t.render_block()[0]) for _ in range(20)]
        outs.append(np.concatenate(mix))
        t.close()
    np.testing.assert_allclose(outs[1], outs[0], rtol=0, atol=8 * 2e-5)
    # The splice took: the last notes play at 0.9, not 0.5.
    assert np.abs(outs[1][-64 * 8:]).max() > 0.8


def test_send_current_buffer_and_mark_queries():
    t = Tracker(100, 16, precision="fast", device=CPU, sync_interval=4)
    t.play("a", build_top_level_waveform(ir.Sine(ir.Const(5.0),
                                                 ir.Const(0.0)), 0.0))
    t.play("b", build_top_level_waveform(ir.Const(1.0), 0.0), start=40)
    y, st = t.render_block()
    assert st.buffer is None
    t.send_current_buffer = True
    y, st = t.render_block()
    np.testing.assert_array_equal(st.buffer, tts.host(y))
    assert not t.send_current_buffer
    assert st.has_active_mark(16, "a", MarkId.TERMINATOR)
    assert st.has_pending_mark(16, "b", MarkId.TERMINATOR)
    assert not st.has_active_mark(16, "b", MarkId.TERMINATOR)
    t.close()


def test_jit_and_seed_keywords():
    t = Tracker(100, 16, device=CPU, jit=False, seed=41)
    assert not t.fuse
    t.play("a", ir.Noise())
    t.render_block()
    assert t.active[0].host_seed == 42
    assert int(t.active[0].params.seed) == 42


# -- the port's tracker against tuun_tpu's -------------------------------------


SCRIPT_SR = 8000
SCRIPT_BLOCK = 128


def _lpf(sr, q, fc):
    w0 = 2 * math.pi * fc / sr
    alpha = math.sin(w0) / (2 * q)
    a0 = 1 + alpha
    b = (1 - math.cos(w0)) / 2
    return [b / a0, 2 * b / a0, b / a0], [-2 * math.cos(w0) / a0,
                                          (1 - alpha) / a0]


def _mod(pkg, name):
    return import_module(f"{pkg.__name__}.{name}")


def _script_notes(pkg):
    """FM notes at two pitches (one group), a filtered saw whose first
    feed-forward coefficient is marked, and a finite FM note."""
    sr = SCRIPT_SR
    I = _mod(pkg, "ir")
    top = _mod(pkg, "player").build_top_level_waveform
    notes = []
    for j, f in enumerate((220, 277)):
        notes.append((f"fm{j}", top(ttg._std(
            f"sine(2*pi*({f} + 30*$(5)), 0) * 0.5", sr, pkg), 0.0), 37 * j))
    ff, fb = _lpf(sr, 0.7, 1200)
    saw = ttg._std("sawtooth(110)", sr, pkg)
    notes.append(("saw", top(I.Filter(
        saw, (I.Marked("ff0", I.Const(ff[0])), I.Const(ff[1]),
              I.Const(ff[2])), tuple(I.Const(a) for a in fb)), 0.0), 5))
    notes.append(("short", top(ttg._std(
        "sine(2*pi*(330 + 30*$(5)), 0) * 0.5 | fin(time - 0.3)", sr, pkg),
        0.0), 200))
    return notes


def _script_commands(pkg):
    """block -> modify arguments: a ramp on a group member's amplitude,
    a ramp on the saw's coefficient, a stop of the other group member."""
    sl, ids = _mod(pkg, "sliders"), _mod(pkg, "ids")
    ff, _ = _lpf(SCRIPT_SR, 0.7, 1200)
    dur = SCRIPT_BLOCK / SCRIPT_SR
    return {6: ("fm1", ids.MarkId.AMPLITUDE, sl.make_ramp(1.0, 0.3, dur)),
            9: ("saw", "ff0", sl.make_ramp(ff[0], 0.5 * ff[0], dur)),
            13: ("fm0", ids.MarkId.TERMINATOR,
                 _mod(pkg, "player").stop_ramp())}


def _run_script(t, pkg):
    """The notes, the commands at their blocks, 24 blocks in all:
    (mix, dispatches of every block)."""
    for wid, w, start in _script_notes(pkg):
        t.play(wid, w, start=start)
    commands = _script_commands(pkg)
    out, disp = [], []
    for k in range(24):
        if k in commands:
            t.modify(*commands[k])
        y, s = t.render_block()
        out.append(np.asarray(y, np.float64))
        disp.append(s.dispatches)
        pf = getattr(t, "_prefetch", None)
        if pf is not None:
            assert pf["done"].wait(60)
    return np.concatenate(out), disp


@pytest.mark.parametrize("precision,sync_interval", [
    ("fast", 1), ("fast", 4), ("exact", 1)])
def test_modify_script_matches_jax_tracker(precision, sync_interval):
    fast = precision == "fast"
    jt = jtracker.Tracker(SCRIPT_SR, SCRIPT_BLOCK, precision=precision,
                          jit=fast, sync_interval=sync_interval)
    jt.fuse_blocking = True
    want, jd = _run_script(jt, tuun_tpu)
    jt.close()
    pt = Tracker(SCRIPT_SR, SCRIPT_BLOCK, precision=precision, device=CPU,
                 jit=fast, sync_interval=sync_interval)
    pt.fuse_blocking = True
    got, pd = _run_script(pt, tuun_tpu_torch)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=8 * 2e-5 if fast else 1e-5)
    assert pd == jd
    # The stopped voice retired; the spliced ones left exact retirement.
    assert "fm0" not in {v.id for v in pt.active}
    assert not pt._ends_known
    ops = [op for op in pt.op_log if op[0] == "modify"]
    assert len(ops) == 3
    if fast:
        assert 1 in pd  # the fused step engaged again after the edits
    pt.close()


@pytest.mark.parametrize("sync_interval", [1, 4])
def test_post_modify_steps_read_nothing_on_the_host(sync_interval,
                                                    monkeypatch):
    """After a modify of a group member and a filter coefficient, the
    fused step and the window step of the new set read no tensor on the
    host (test_torch_stream.py's dispatch mode)."""
    t = Tracker(SCRIPT_SR, SCRIPT_BLOCK, precision="fast", device=CPU,
                sync_interval=sync_interval)
    t.fuse_blocking = True
    for wid, w, start in _script_notes(tuun_tpu_torch):
        t.play(wid, w, start=start)
    for _ in range(4):
        t.render_block()
    ff, _ = _lpf(SCRIPT_SR, 0.7, 1200)
    t.modify("fm1", MarkId.AMPLITUDE, sliders.make_ramp(1.0, 0.3, 0.016))
    t.modify("saw", "ff0", sliders.make_ramp(ff[0], 0.5 * ff[0], 0.016))
    steps = []
    build = T.make_step
    monkeypatch.setattr(tl, "_bind_per_render", lambda P: True)

    def checked(fn, *a):
        def run(*args):
            with tts._NoHostReads():
                return fn(*args)
        steps.append(fn)
        return build(run, *a)
    monkeypatch.setattr(T, "make_step", checked)
    for _ in range(8):
        t.render_block()
    assert len(steps) == (1 if sync_interval == 1 else 2)
    t.close()

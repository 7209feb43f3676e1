"""The port's timeline compilation (tuun_tpu_torch/engine/timeline.py) on
the CPU.

Twins of tests/test_timeline.py (all but the Modify test: Modify is not
ported), each keeping its JAX name and tolerance against the oracle, plus:

  * the same scores against the JAX engine's timeline (fast, jit=False);
  * bench.py's marks_4_40 and poly_16 at 48 kHz: they compile to a
    CTimeline, and their first blocks match JAX fast and the port's own
    plain-tree compile (EngineConfig(timeline=False));
  * the step sum's merged points against the broadcast formula.

Every render asks for the CPU: the port's entry points default to the
card.
"""

from importlib import import_module
from pathlib import Path

import numpy as np
import pytest
import torch

import tuun_tpu
import tuun_tpu_torch
from tuun_tpu import oracle
from tuun_tpu.engine import CompiledVoice as JaxVoice
from tuun_tpu.engine import EngineConfig as JaxConfig
from tuun_tpu_torch import ir as tir
from tuun_tpu_torch.engine import CompiledVoice, EngineConfig, render
from tuun_tpu_torch.engine.timeline import (CTimeline, _Chord, _Layer,
                                            _step_sum, _steps)
from tuun_tpu_torch.tracker import Tracker

torch.set_num_threads(1)
CPU = "cpu"
SR = 8000


def _w(expr, pkg=tuun_tpu_torch, sr=SR):
    """`expr` evaluated and optimized by `pkg`'s own front end (tempo
    120, as tests/test_timeline.py)."""
    ev = import_module(f"{pkg.__name__}.evaluator")
    lib = Path(pkg.__file__).resolve().parent / "stdlib" / "v0"
    out = ev.Evaluator(sr, 120, lib).evaluate_source(expr, opens=("std",))
    if isinstance(out, import_module(f"{pkg.__name__}.expr").ESeq):
        out = out.waveform
    return import_module(f"{pkg.__name__}.optimizer").optimize(out.waveform)


def _diff(expr, n, block=512, precision="fast", tol=1e-5):
    """The port against the oracle on the same expression, as
    tests/test_timeline.py's _diff."""
    y = render(_w(expr), n, SR, precision=precision, block=block, device=CPU)
    o = oracle.render(_w(expr, tuun_tpu), n, SR)
    assert len(y) == len(o), (len(y), len(o))
    if len(y):
        assert float(np.max(np.abs(y - o))) <= tol
    return y


def _jax(expr, n, sr=SR, block=512, timeline=True):
    voice = JaxVoice(_w(expr, tuun_tpu, sr),
                     JaxConfig(sr, "fast", 0, jit=False, timeline=timeline))
    P = voice.params()
    st = voice.init(P)
    out, total = [], 0
    while total < n:
        m = min(block, n - total)
        y, v, st, _ = voice.render_block(P, st, block, 0, m)
        out.append(np.asarray(y[:int(v)]))
        total += int(v)
        if int(v) < m:
            break
    return np.concatenate(out)


def _voice(expr, sr=SR, **kw):
    return CompiledVoice(_w(expr, sr=sr), EngineConfig(sr, "fast", CPU, **kw))


def _timelines(node, acc=None):
    acc = [] if acc is None else acc
    if isinstance(node, CTimeline):
        acc.append(node)
    for a in ("a", "b", "inner", "trigger", "pos", "neg"):
        c = getattr(node, a, None)
        if c is not None and hasattr(c, "render"):
            _timelines(c, acc)
    return acc


SEQ = "<[" + ", ".join(["0 | fin(time - 0.05) | seq(time - 0.05)"] * 8) + "]>"
MELODY = "<[" + ", ".join(f"$({200 + 40 * i}) * 0.2 | fin(time - 0.03) "
                          f"| seq(time - 0.03)" for i in range(8)) + "]>"
CHORD = "{[" + ", ".join(f"$({300 + 35 * i})" for i in range(8)) + \
    "]} | fin(time - 0.1)"
CONSTS = "<[" + ", ".join(f"{0.1 * (i + 1):.1f} | fin(time - 0.02) "
                          f"| seq(time - 0.02)" for i in range(8)) + "]>"


def test_sequence_chain_compiles_to_timeline():
    assert _voice(SEQ)._has_timeline
    _diff(SEQ, 4000)


def test_melody_stacks_same_structure_notes():
    v = _voice(MELODY)
    assert v._has_timeline
    (tl,) = _timelines(v.root)
    plan = tl._plan_for(v.params(), v.lits_for(v.params()))
    assert any(isinstance(x, _Layer) for x in plan.items)
    _diff(MELODY, 2400, tol=5e-5)


def test_chord_layers_overlapping_leaves():
    v = _voice(CHORD)
    assert v._has_timeline
    (tl,) = _timelines(v.root)
    plan = tl._plan_for(v.params(), v.lits_for(v.params()))
    assert [type(x) for x in plan.items] == [_Chord]
    _diff(CHORD, 1000, tol=3e-4)  # 8 summed NCO sines vs the f64 oracle


def test_nonzero_constant_segments_cancel_exactly():
    _diff(CONSTS, 1400, tol=1e-6)


def test_timeline_disabled_flag_compiles_plain_tree():
    assert not _voice(SEQ, timeline=False)._has_timeline


def test_block_size_invariance():
    notes = ", ".join(f"$({220 + 30 * i}) * 0.1 | fin(time - 0.021) "
                      f"| seq(time - 0.027)" for i in range(7))
    w = _w(f"<[{notes}]>")
    a = render(w, 1600, SR, precision="fast", block=64, device=CPU)
    b = render(w, 1600, SR, precision="fast", block=1024, device=CPU)
    assert len(a) == len(b)
    np.testing.assert_allclose(a, b, atol=1e-6)


def _marked_chain(ir, n_leaves=8, seg_samples=40, value=1.0):
    """<seg, seg, ...> built in IR: Marked constants of known length."""
    def seg():
        return ir.Fin(
            ir.BinaryPointOp(ir.Operator.SUBTRACT, ir.Time(),
                             ir.Const(seg_samples / SR)),
            ir.Marked("m", ir.Const(value)))
    w = seg()
    for _ in range(n_leaves - 1):
        w = ir.Append(seg(), w)
    return w


def test_tracker_timeline_voice_exact_retirement():
    t = Tracker(SR, block_size=64, device=CPU)
    t.play("a", _marked_chain(tir))
    out = t.run_to_completion()
    assert t.known_end == 8 * 40
    np.testing.assert_allclose(out[: 8 * 40], 1.0)


def test_tracker_activates_timeline_voice_with_lits():
    """A score's voice gets its literal cutoffs at activation, renders its
    schedule on the stateful path, and retires at its symbolic length."""
    t = Tracker(SR, block_size=256, device=CPU)
    t.play("a", _w(CONSTS))
    y0, _ = t.render_block()
    voice = t.active[0]
    assert voice.compiled._has_timeline and not voice.fast
    assert voice.lits == voice.compiled.lits_for(voice.params)
    assert voice.total_len == 8 * 160
    out = np.concatenate([y0, t.run_to_completion()])
    assert t.known_end == 8 * 160
    want = oracle.render(_w(CONSTS, tuun_tpu), 8 * 160, SR)
    np.testing.assert_allclose(out[:8 * 160], want, atol=1e-6)


def _render_cfg(expr, n, timeline=True, seed=0, sr=SR, block=None):
    v = CompiledVoice(_w(expr, sr=sr),
                      EngineConfig(sr, "fast", CPU, timeline=timeline))
    P = v.params(seed)
    state = v.init(P)
    block = block or n
    out = []
    for s0 in range(0, n, block):
        y, valid, state, _ = v.render_block(P, state, block, 0,
                                            min(block, n - s0))
        out.append(y.numpy()[:int(valid)])
    return np.concatenate(out)


def test_nested_merge_leaf_renders_and_matches_plain():
    """A repeated leaf holding its own Merge tree (a nested timeline)
    cannot take the stacked path: it renders on its own and matches the
    plain compile and the oracle."""
    phrase = "<[" + ", ".join(
        f"{v} | fin(time - 0.01) | seq(time - 0.01)"
        for v in (0.1, 0.2, 0.3, 0.4, 0.5, 0.6)) + "]>"
    spacers = ", ".join(["0 | fin(time - 0.02) | seq(time - 0.02)"] * 4)
    expr = f"<[{phrase} * 0.5, {spacers}, {phrase} * 0.5]>"
    got = _render_cfg(expr, 1600)
    want = _render_cfg(expr, 1600, timeline=False)
    np.testing.assert_allclose(got, want, atol=1e-6)
    _diff(expr, 1600)


def test_noise_uids_match_plain_compile():
    """Noise uids follow the plain compile's numbering: the same noise
    under timeline=True and timeline=False."""
    segs = ", ".join(["0.5 | fin(time - 0.02) | seq(time - 0.02)"] * 6)
    expr = f"<[{segs}]> + (noise * 0.25)"
    np.testing.assert_array_equal(_render_cfg(expr, 800, seed=7),
                                  _render_cfg(expr, 800, timeline=False,
                                              seed=7))


# -- against the JAX engine's timeline -------------------------------------


@pytest.mark.parametrize("expr,n,atol", [
    (SEQ, 1600, 0.0), (MELODY, 1200, 1.1e-6), (CONSTS, 1400, 1.1e-6),
    # 8 unit sines summed: f32 spacing at |y| < 8 is 4.8e-7; the two
    # libraries' sin and summation order differ by a few of those.
    (CHORD, 1000, 2e-6)], ids=["seq", "melody", "consts", "chord"])
def test_timeline_matches_jax_timeline(expr, n, atol):
    got = render(_w(expr), n, SR, precision="fast", block=512, device=CPU)
    want = _jax(expr, n)
    assert len(got) == len(want)
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


def test_timeline_exact_mode_matches_oracle():
    """Exact precision (f64 NCO phase) through the timeline: the JAX
    diff_test tolerances (1e-6 absolute, 1e-5 relative)."""
    for expr, n in ((MELODY, 2400), (CONSTS, 1400)):
        v = CompiledVoice(_w(expr), EngineConfig(SR, "exact", CPU))
        assert v._has_timeline
        got = render(_w(expr), n, SR, precision="exact", block=300,
                     device=CPU)
        ref = oracle.render(_w(expr, tuun_tpu), n, SR)
        assert len(got) == len(ref)
        np.testing.assert_allclose(got, ref, atol=1e-6, rtol=1e-5)


# -- bench.py's score workloads at 48 kHz ----------------------------------


MARKS_4_40 = "<[" + ", ".join(
    ["0 | fin(time - 0.5) | seq(time - 0.5)"] * 160) + "]>"
POLY_16 = "{[" + ", ".join(f"$({600 + 60 * i}) + $({1200 + 35 * i})"
                           for i in range(16)) + "]} | fin(time - 80)"


@pytest.mark.parametrize("expr,kind,atol", [
    (MARKS_4_40, "steps", 0.0),
    # 32 unit sines summed: f32 spacing at |y| in [16, 32) is 1.9e-6; the
    # two libraries' sin and the rows' summation order differ by up to
    # 2 of those (3.8e-6 measured), so 4 spacings.
    (POLY_16, "chord", 7.7e-6)], ids=["marks_4_40", "poly_16"])
def test_bench_score_at_48k(expr, kind, atol):
    """bench.py:87-96's expressions compile to a CTimeline (a step sum
    over 320 points; one chord of 16 stacked leaves) and their first
    blocks at 48 kHz match JAX fast and the port's plain tree."""
    sr, block, n = 48000, 16384, 32768
    v = _voice(expr, sr)
    (tl,) = _timelines(v.root)
    P = v.params()
    plan = tl._plan_for(P, v.lits_for(P))
    if kind == "steps":
        assert plan.const is not None and not plan.items
        assert plan.total == 80 * sr
    else:
        assert plan.const is None
        assert [(type(x), x.count) for x in plan.items] == [(_Chord, 16)]
    assert v.symbolic_len(P) == 80 * sr
    got = _render_cfg(expr, n, sr=sr, block=block)
    np.testing.assert_allclose(got, _jax(expr, n, sr, block), atol=atol,
                               rtol=0)
    np.testing.assert_allclose(
        got, _render_cfg(expr, n, timeline=False, sr=sr, block=block),
        atol=atol, rtol=0)


def test_step_sum_merges_points():
    """_step_sum with repeated points, points before the window and past
    it equals the broadcast sum exactly (small integers), and the same
    bits on a second call."""
    points = np.array([5, 3, 5, -4, 0, 100, 3, 9, 12, 12, 12], np.int64)
    values = torch.tensor([1., 2., -1., 4., 8., 16., 3., -2., 5., 6., 7.])
    steps = _steps(points, values)
    assert steps.points.tolist() == sorted(set(points.tolist()))
    n = 16
    for li0 in (-10, -4, 0, 3, 7, 12, 50, 200):
        li = li0 + torch.arange(n)
        want = (values[:, None] * (li[None, :] >= torch.from_numpy(
            points)[:, None]).float()).sum(0)
        got = _step_sum(torch.tensor(li0), n, steps)
        assert torch.equal(got, want), li0
        assert torch.equal(_step_sum(torch.tensor(li0), n, steps), got)

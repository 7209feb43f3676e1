"""Settled subtrees in the port's engine on the CPU (graph.fold_plan,
graph.CFold) and the tracker's settled steps.

A subtree of constants, time ramps, arithmetic and alts on the edges that
pass the voice root's range is settled from a local sample T when it
yields one value at every local sample from T on: the plan proves it by
float32 interval arithmetic over the render's own ops and decides each
Alt on the way.  A render asked for in its settled form returns such a
subtree as one value a row, and each parent reads that value as the
lanes it stands for.  Everything below holds the settled form to the
render that folds nothing, bit for bit, on every lane of y (the root's
raw lanes past [s, e) included), v, w and every state leaf; and the
tracker to asking for it only once every voice of a group is past its
T."""

import hashlib
import math
import sys
import time
from importlib import import_module
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from torch.profiler import ProfilerActivity, profile

import tuun_tpu_torch
from tuun_tpu_torch import ir
from tuun_tpu_torch import tracker as T
from tuun_tpu_torch.engine import CompiledVoice, EngineConfig, graph
from tuun_tpu_torch.engine.capture import flatten
from tuun_tpu_torch.engine.graph import Ctx, stack_params
from tuun_tpu_torch.evaluator import Evaluator

from test_torch_node_ops import CountingModelStep

PORTBENCH = Path(__file__).resolve().parent.parent / "portbench"
for _p in (str(PORTBENCH.parent), str(PORTBENCH)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import harness  # noqa: E402

torch.set_num_threads(1)
CPU = "cpu"
SR = 44100
PIANO = "let (on, off) = pm_piano_keys({k!r}, {v!r}) in on"
# drawn-like floats: an integer key or a velocity of 1 folds otherwise
KEYS = ((48.25, 0.8), (60.5, 0.45), (67.75, 0.95), (39.125, 0.3))
# env_minmax.tuun's envelopes (min and max of time ramps, std.tuun's
# alt-built min and max) on an NCO note.  ADSR ends in a fin past its
# release, and a fin stops the range, so nothing of it folds; ADS has no
# fin, and sits at its sustain level from 0.3 s on.
ENV_OPENS = ("std", "env_minmax")
ADSR = "$220 | ADSR(0.1, 0.2, 0.6, 5, 0.5)"
ENV = "$220 * (0.5 + ADS(0.1, 0.2, 0.6)(1))"


def _source(text, opens=("std", "pm_synth"), sr=SR):
    ev = import_module("tuun_tpu_torch.evaluator")
    stdlib = Path(tuun_tpu_torch.__file__).resolve().parent / "stdlib" / "v0"
    out = ev.Evaluator(sr, 90, stdlib).evaluate_source(text, opens=opens)
    if isinstance(out, import_module("tuun_tpu_torch.expr").ESeq):
        out = out.waveform
    return import_module("tuun_tpu_torch.optimizer").optimize(out.waveform)


def _piano(k=48.25, v=0.8):
    return _source(PIANO.format(k=k, v=v))


def _config_voice(config, i=0):
    cfg = harness.load_json(PORTBENCH / "configs" / f"{config}.json")
    voices = harness.draw_voices(cfg, i + 1, 4000000031)
    ev = Evaluator(SR, 90, harness.ROOT / "tuun_tpu_torch" / "stdlib" / "v0")
    return harness.compile_voices(cfg, voices, ev)[i]


VOICES = {
    "piano": _piano,
    "adsr": lambda: _source(ADSR, ENV_OPENS),
    "env": lambda: _source(ENV, ENV_OPENS),
    "fm_vibrato": lambda: _config_voice("fm_vibrato"),
    "saw_lpf": lambda: _config_voice("saw_lpf"),
}


def _cfg(precision="fast", sr=SR):
    return EngineConfig(sr, precision, CPU)


def _leaves(tree):
    return flatten(tree)[1]


def _assert_same(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


def _root_render(voice, P, rst, s, e, n, settled):
    ctx = Ctx(n, P.device, settled=settled)
    return voice.root.render(P, rst, torch.tensor(s), torch.tensor(e), ctx)


# -- the plan ------------------------------------------------------------------


def test_piano_plan_folds_its_envelopes_and_constants():
    """The piano's 8 folds: each envelope where the carrier's index reads
    it and where the stack's level reads it, the two velocity factors
    and the modulators' zero phases; both envelopes settle by 0.56 s
    (0.01 s of attack and 0.55 s of decay to the sustain level), the
    constants from sample 0, and 37 of the 48 node renders the shared
    render makes are left."""
    voice = CompiledVoice(_piano(), _cfg())
    assert len(voice.folds) == 8
    assert voice.shared_renders == 111 and voice.folded_renders == 37
    P = voice.params()
    hp = graph._host_params(P).consts.numpy()
    settles = [graph.settle_sample(f, hp, SR) for f in voice.folds]
    assert sorted(settles) == [0] * 4 + [14995] * 2 + [24697] * 2
    assert voice.settled_from(P) == 24697
    assert 0.559 < 24697 / SR < 0.561
    with_time = [f for f in voice.folds if f.times]
    assert len(with_time) == 4
    assert all(f.classes == {"CAlt", "CBinary", "CConst", "CTime"}
               for f in with_time)


@pytest.mark.parametrize("name,settles", [("piano", 24697),
                                          ("adsr", None),
                                          ("env", 13231),
                                          ("fm_vibrato", 0),
                                          ("saw_lpf", None)])
def test_each_configuration_settles_where_its_constants_say(name,
                                                            settles):
    """The ADSR's envelope sits under a fin, which stops the range, and
    the saw pad's constants under its resets and filter: neither has a
    fold.  The vibrato's three constants on the range settle at once."""
    voice = CompiledVoice(VOICES[name](), _cfg())
    assert voice.settled_from(voice.params()) == settles
    assert bool(voice.folds) == (settles is not None)
    if name == "fm_vibrato":
        assert len(voice.folds) == 3 and voice.folded_renders == 2


def _env_voice(text=ENV):
    return _source(text, ENV_OPENS, sr=8000)


def test_a_bare_envelope_settles_at_its_decay():
    voice = CompiledVoice(_env_voice(), _cfg(sr=8000))
    T = voice.settled_from(voice.params())
    assert T is not None and 0.299 * 8000 < T <= 0.301 * 8000


def test_a_voice_with_other_constants_settles_apart():
    """The plan is read from the compiled waveform's constants, and each
    voice's T from its own: a slower decay settles later, and an
    envelope that never reaches its level never settles, with the same
    compiled voice."""
    slow = _env_voice(ENV.replace("0.2, 0.6", "0.9, 0.6"))
    rising = _env_voice(ENV.replace("0.2, 0.6", "0.2, 1.5"))
    voice = CompiledVoice(_env_voice(), _cfg(sr=8000))
    assert graph.structure_key(slow, 8000) == graph.structure_key(
        _env_voice(), 8000)
    T = voice.settled_from(voice.params())
    T_slow = voice.settled_from(voice.params_for(slow))
    assert T_slow > T and 0.999 * 8000 < T_slow <= 1.001 * 8000
    assert voice.settled_from(voice.params_for(rising)) is None


# -- the settled form is the render --------------------------------------------


def _drive(voice, P, n, steps, T):
    """Renders `steps` windows of n lanes from a fresh state, the settled
    form wherever the voice's position is past T (as the tracker asks
    for it), and holds each against the render that folds nothing from
    the same state at four ranges: [0, n), from s > 0, to e < n, and
    both.  Returns the forms used."""
    rst = voice.init(P)[1]
    pos, forms = 0, []
    for _ in range(steps):
        settled = T is not None and pos >= T
        forms.append(settled)
        for s, e in ((0, n), (37, n), (0, n - 101), (37, n - 101)):
            want = _root_render(voice, P, rst, s, e, n, False)
            got = _root_render(voice, P, rst, s, e, n, settled)
            assert torch.equal(got[0], want[0])  # every lane, raw
            assert int(got[1]) == int(want[1]) and int(got[2]) == int(
                want[2])
            _assert_same(got[3], want[3])
        rst = _root_render(voice, P, rst, 0, n, n, False)[3]
        pos += n
    return forms


@pytest.mark.parametrize("name", list(VOICES))
def test_settled_form_is_the_render_before_across_and_after(name):
    voice = CompiledVoice(VOICES[name](), _cfg())
    P = voice.params()
    T = voice.settled_from(P)
    forms = _drive(voice, P, 8192, 5, T)
    if name == "piano":
        # 24697 falls in the fourth window: three before it, one across
        assert forms == [False, False, False, False, True]
    elif name == "env":
        assert forms == [False, False, True, True, True]
    else:
        assert all(forms) == (T is not None)


@pytest.mark.parametrize("precision", ["exact", "exact_df"])
def test_settled_form_is_the_render_in_the_exact_precisions(precision):
    """The folds' ops are float32 in every precision (time, constants,
    arithmetic); the exact precisions' sines are not NCOs and read the
    settled index through their phase."""
    voice = CompiledVoice(_piano(), _cfg(precision))
    P = voice.params()
    T = voice.settled_from(P)
    assert T == 24697
    rst = voice.state_at(P, T, 8192)
    for s, e in ((0, 4096), (5, 4096), (0, 3000)):
        want = _root_render(voice, P, rst, s, e, 4096, False)
        got = _root_render(voice, P, rst, s, e, 4096, True)
        assert torch.equal(got[0], want[0])
        _assert_same(got[3], want[3])


def test_settled_group_is_the_render_in_a_window_and_its_replay():
    """A group of four piano voices past T, vmapped as the tracker's
    steps render it: one window of K blocks and an interrupt's replay of
    k < K of them (e0 = k * n), each voice's lanes, valid end and state
    bit for bit the unfolded group's."""
    ws = [_piano(k, v) for k, v in KEYS]
    voice = CompiledVoice(ws[0], _cfg())
    params = [voice.params_for(w, seed=i + 1) for i, w in enumerate(ws)]
    T = max(voice.settled_from(P) for P in params)
    states = [voice.state_at(P, T + 100, 8192) for P in params]
    bp = stack_params(params)
    bs = graph.stack_tree([(torch.tensor(T + 100), st) for st in states])
    n, K = 512, 8
    starts = torch.zeros(len(ws), dtype=torch.int64)
    for e0 in (K * n, 3 * n, n):
        plain = voice.batched_render_fn(K * n, fast=False, mix=False)
        folded = voice.batched_render_fn(K * n, fast=False, mix=False,
                                         settled=True)
        want = plain(bp, bs, starts, torch.tensor(e0))
        got = folded(bp, bs, starts, torch.tensor(e0))
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        _assert_same(got[2], want[2])
    # the settled step leaves the envelopes' lanes unrendered
    counts = {}

    def count(cls):
        render = cls.render

        def counted(self, *a):
            counts[cls.__name__] = counts.get(cls.__name__, 0) + 1
            return render(self, *a)
        return counted
    saved = (graph.CTime.render, graph.CAlt.render)
    try:
        graph.CTime.render, graph.CAlt.render = (count(graph.CTime),
                                                 count(graph.CAlt))
        folded(bp, bs, starts, torch.tensor(K * n))
        assert counts == {}
        plain(bp, bs, starts, torch.tensor(K * n))
        assert counts == {"CTime": 1, "CAlt": 4}
    finally:
        graph.CTime.render, graph.CAlt.render = saved


# -- the proof -----------------------------------------------------------------


def _ramp(c0, c1):
    """std.tuun's linear(c0, c1): c0 + time * c1."""
    return ir.BinaryPointOp(ir.Operator.ADD, ir.Const(c0), ir.BinaryPointOp(
        ir.Operator.MULTIPLY, ir.Time(), ir.Const(c1)))


def _min(x, y):
    return ir.Alt(ir.BinaryPointOp(ir.Operator.SUBTRACT, x, y), y, x)


def _max(x, y):
    return ir.Alt(ir.BinaryPointOp(ir.Operator.SUBTRACT, x, y), x, y)


_NUM = st.floats(-8.0, 8.0, allow_nan=False, width=32)
# slopes of 1e-5 to 10 a second, either sign: crossings from the first
# samples to past 2^24 of them
_SLOPE = st.builds(lambda sign, u: sign * 10.0 ** u,
                   st.sampled_from([-1.0, 1.0]), st.floats(-5.0, 1.0))


@st.composite
def _envelopes(draw, depth=3):
    """min / max of ramps and constants, scaled by constants."""
    kind = draw(st.sampled_from(["const", "ramp", "min", "max", "min",
                                 "max", "scale"]
                                if depth > 0 else ["const", "ramp"]))
    if kind == "const":
        return ir.Const(draw(_NUM))
    if kind == "ramp":
        return _ramp(draw(_NUM), draw(_SLOPE))
    if kind == "scale":
        return ir.BinaryPointOp(ir.Operator.MULTIPLY,
                                draw(_envelopes(depth - 1)),
                                ir.Const(draw(_NUM)))
    op = _min if kind == "min" else _max
    return op(draw(_envelopes(depth - 1)), draw(_envelopes(depth - 1)))


def _state_at(node, t):
    """`node`'s state with every Time at local sample t, as the voice's
    position puts them (every node here is on the root's range)."""
    while isinstance(node, graph.CWrap):
        node = node.inner
    if isinstance(node, graph.CTime):
        return (torch.tensor(t),)
    return tuple(_state_at(c, t) for c in graph._fold_children(node))


SR_PROOF = 100
AT = (0, 1, 777, 2 ** 24 - 3, 2 ** 24 + 17, 2 ** 27 + 5, 2 ** 31 + 11)


@settings(max_examples=100, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(_envelopes())
def test_every_lane_takes_the_decided_branch(env):
    """Wherever the plan decides an Alt from T on, every lane of the
    trigger's unfolded render at local samples from T on (past 2^24
    too, where float32 no longer holds every sample) has the decided
    sign, and every lane of a fold is its settled value, bit for bit."""
    w = ir.BinaryPointOp(ir.Operator.MULTIPLY, ir.Sine(
        ir.Const(2 * math.pi * 3.0), ir.Const(0.0)), env)
    voice = CompiledVoice(w, _cfg(sr=SR_PROOF))
    P = voice.params()
    hp = graph._host_params(P).consts.numpy()
    n = 64
    for fold in voice.folds:
        T = graph.settle_sample(fold, hp, SR_PROOF)
        if T is None:
            continue
        value = fold.value(P)
        for t in sorted({T, T + 3} | {a for a in AT if a >= T}):
            ctx = Ctx(n, P.device)
            zero, end = torch.tensor(0), torch.tensor(n)
            for alt, positive in fold.decisions:
                y = alt.trigger.render(P, _state_at(alt.trigger, t), zero,
                                       end, ctx)[0]
                assert bool((y >= 0.0).all() if positive
                            else (y < 0.0).all()), (t, T)
            y = fold.inner.render(P, _state_at(fold.inner, t), zero, end,
                                  Ctx(n, P.device))[0]
            assert torch.equal(y, value.expand(n)), (t, T)


@pytest.mark.parametrize("slope", [-1.0, -1e-6])
def test_a_decision_is_the_least_sample_it_holds_from(slope):
    """max(1 + slope * t, 0.25): the ramp falls below its floor at local
    sample 76 (slope -1), or past 2^26 (slope -1e-6, where float32 time
    steps 8 samples at a time); one sample earlier the proof fails, and
    there the trigger is still >= 0, in the unfolded render too."""
    env = _max(_ramp(1.0, slope), ir.Const(0.25))
    voice = CompiledVoice(env, _cfg(sr=SR_PROOF))
    (fold,) = voice.folds
    assert fold.inner is voice.root.inner
    P = voice.params()
    hp = graph._host_params(P).consts.numpy()
    T = graph.settle_sample(fold, hp, SR_PROOF)
    assert T == 76 if slope == -1.0 else T > 2 ** 26
    ((alt, positive),) = fold.decisions
    assert not positive
    assert not graph._decided(alt, False, hp, T - 1, SR_PROOF)
    y = alt.trigger.render(P, _state_at(alt.trigger, T - 1),
                           torch.tensor(0), torch.tensor(64),
                           Ctx(64, CPU))[0]
    assert float(y[0]) >= 0.0 and bool((y[1:] < 0.0).all())


# -- the tracker ---------------------------------------------------------------


def _tracker(sr, block, K, fuse=True):
    t = T.Tracker(sr, block, precision="fast", device=CPU, sync_interval=K)
    t.fuse_blocking = True
    t.fuse = fuse
    return t


def _pull(t, blocks):
    flags, mixes = [], []
    for _ in range(blocks):
        key = t._fused_set_key(t.block_size) if t.fuse else None
        flags.append(None if key is None else tuple(p[-1] for p in key[2]))
        mixes.append(np.asarray(t.render_block()[0], np.float32))
    return flags, np.concatenate(mixes)


# The piano group's mix over 8 windows of 16 blocks of 512 samples, four
# voices from sample 0, held: its sha256 on the tree before the settled
# form existed (the same group, the same tracker settings).
PIANO_MIX_SHA256 = \
    "0de7908f9d1d7cbb3d48c9a8d4b03674b4b53e12f4f695e64233b69e2493c5b7"


def test_a_held_piano_group_changes_its_step_key_once():
    t = _tracker(SR, 512, 16)
    try:
        for i, (k, v) in enumerate(KEYS):
            t.play(i, _piano(k, v), start=0)
        keys = []
        mixes = []
        for _ in range(8 * 16):
            mixes.append(np.asarray(t.render_block()[0], np.float32))
            keys.append(t._fuse_key)
        (group,) = t._groups
        assert group.settle_at == 24697
        settled = {k[2][0][-1] for k in keys}
        assert settled == {False, True}
        assert sum(a != b for a, b in zip(keys, keys[1:])) == 1
        # each form's window and per-block steps, captured once each
        assert {k[1][2][0][-1] for k in t._fused_cache if k[0] == "win"} \
            == {False, True}
    finally:
        t.close()
    mix = np.concatenate(mixes)
    assert hashlib.sha256(mix.tobytes()).hexdigest() == PIANO_MIX_SHA256


def _alt_voice(sr):
    """An NCO note whose level switches from 1 to 0.5 at 0.5 s."""
    step = ir.Alt(ir.BinaryPointOp(ir.Operator.SUBTRACT, ir.Time(),
                                   ir.Const(0.5)), ir.Const(0.5),
                  ir.Const(1.0))
    return ir.BinaryPointOp(ir.Operator.MULTIPLY, ir.Sine(
        ir.Const(2 * math.pi * 110.0), ir.Const(0.0)), step)


def test_a_trigger_crossing_inside_the_window_stays_unfolded():
    """At 8 kHz the switch is at sample 4000, inside the first window of
    16 blocks of 512 (the first window opens a few blocks in, once its
    steps are captured): that window renders unfolded, and the next
    settled; the mix is the per-voice path's, which never folds."""
    sr, n = 8000, 512
    t, plain = _tracker(sr, n, 16), _tracker(sr, n, 16, fuse=False)
    try:
        for tr in (t, plain):
            tr.play(0, _alt_voice(sr), start=0)
            tr.play(1, _alt_voice(sr), start=0)
        opened, mix = [], []
        for b in range(3 * 16):
            before = t.window_opens
            mix.append(np.asarray(t.render_block()[0], np.float32))
            if t.window_opens > before:
                opened.append((b * n, t._window["key"][2][0][-1]))
        (group,) = t._groups
        assert group.settle_at == 4000
        (start, settled), later = opened[0], opened[1:]
        assert start < 4000 < start + 16 * n and not settled
        assert later and all(f for _, f in later)
        _, want = _pull(plain, 3 * 16)
        np.testing.assert_array_equal(np.concatenate(mix), want)
    finally:
        t.close()
        plain.close()


def test_a_group_with_different_starts_waits_for_its_last_voice():
    """Voices starting at 0, 3000 and 6000 settle at 4000, 7000 and
    10000: the group renders unfolded to 10000, and its mix is the one
    that never folds."""
    sr, n = 8000, 512
    t, plain = _tracker(sr, n, 4), _tracker(sr, n, 4, fuse=False)
    try:
        for tr in (t, plain):
            for i, start in enumerate((0, 3000, 6000)):
                tr.play(i, _alt_voice(sr), start=start)
        flags, mix = _pull(t, 40)
        _, want = _pull(plain, 40)
        (group,) = t._groups
        assert group.settle_at == 10000
        for b, f in enumerate(flags):
            if f is not None and b * n >= 6144:
                assert f == ((b * n >= 10000),), b
        assert (True,) in flags
        np.testing.assert_array_equal(mix, want)
    finally:
        t.close()
        plain.close()


def test_a_spliced_voice_never_folds():
    """A modify's splice starts a subtree fresh, whose time ramps then
    stand apart from the voice's position: the voice folds nothing from
    then on."""
    sr = 8000
    w = ir.BinaryPointOp(ir.Operator.ADD, _alt_voice(sr),
                         ir.Marked("m", ir.Const(0.0)))
    t = _tracker(sr, 512, 4)
    try:
        t.play(0, w, start=0)
        t.play(1, w, start=0)
        flags, _ = _pull(t, 12)
        assert flags[-1] == (True,)
        t.modify(0, "m", ir.Const(0.25))
        flags, _ = _pull(t, 8)
        assert all(v.settle_at is None for v in t.active if v.id == 0)
        assert all(f is None or not any(f) or len(f) == 2 for f in flags)
        assert all(not f[0] for f in flags if f is not None)
    finally:
        t.close()


# -- the counts and markers ----------------------------------------------------


@pytest.fixture
def counted(monkeypatch):
    monkeypatch.setattr(T, "make_step", CountingModelStep)


def test_a_settled_step_counts_and_marks_what_it_folded(counted):
    """The piano's window step captured in both forms: the settled one
    counts the 37 node renders its folds saved beside the 111 shared,
    marks `tuun.engine.folded:37` at each replay, and keeps CTime and
    CAlt at 0 operations, marked; the unsettled one folded nothing."""
    t = _tracker(SR, 2048, 4)
    try:
        for i, (k, v) in enumerate(KEYS[:3]):
            t.play(i, _piano(k, v), start=0)
        for _ in range(6 * 4):
            t.render_block()
        steps = {k[1][2][0][-1]: e["step"] for k, e in t._fused_cache.items()
                 if k[0] == "win"}
        assert set(steps) == {False, True}
        plain, folded = steps[False], steps[True]
        assert plain.folded_renders == 0 and plain.shared_renders == 111
        assert plain.node_ops["CTime"] > 0 and plain.node_ops["CAlt"] > 0
        assert folded.folded_renders == 37 and folded.shared_renders == 111
        assert folded.node_ops["CTime"] == 0 and folded.node_ops["CAlt"] == 0
        assert folded.node_ops["CSine"] == plain.node_ops["CSine"]
        assert sum(folded.node_ops.values()) < \
            sum(plain.node_ops.values()) / 2
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for _ in range(2 * 4):
                t.render_block()
                if t._prefetch is not None:
                    assert t._prefetch["done"].wait(10)
        names = {e.name for e in prof.events()}
        assert {"tuun.engine.folded:37", "tuun.engine.shared:111",
                "tuun.engine.ops.CTime:0", "tuun.engine.ops.CAlt:0"} <= names
    finally:
        t.close()


def test_the_time_alt_reader_reads_zero_in_a_settled_run(counted):
    """A tiny traced run of the piano's cell through the harness, its
    blocks long enough that the voices settle in the first: the reader
    of the time and alt operations reads 0, not nothing, and the sines'
    reader what it read before."""
    cell = harness.load_cell(harness.ROOT, "pm_piano.offline")
    tiny = {"voices": 2, "block_size": 32768, "sync_interval": 2,
            "compare_blocks": 2, "pace_blocks": 4, "trace_blocks": 4}
    res = harness.run_cell(cell, 4000000029, 0.2, True, time.perf_counter(),
                           device="cpu", overrides=tiny)
    run = res["run"]
    assert res["checks"]["correct"] is True
    read = harness.metric_reader
    assert read("engine.time_alt_ops_per_block.offline").read(run) == 0.0
    assert read("engine.sine_ops_per_block.offline").read(run) > 0
    names = {h[0] for h in run.trace.host_events}
    assert "tuun.engine.folded:37" in names

"""Shared subtrees in the port's engine on the CPU (graph.share_plan,
graph.CShared).

Within one render, an occurrence of a subtree that the compiler proves
identical to an earlier one and equally ranged with it returns the
earlier one's (y, v, w, state') and renders nothing.  Identical: the same
node types and operators over identical children, the same constants by
value (float32 bits), Fixed payloads and NCO choice; a noise never (its
key holds its uid), nor a subtree that writes a capture or holds a
timeline.  Equally ranged: each receives the voice root's (s, e) in
every render and advance.  The edges that pass the root's range on:

    CBinary          a; b when the op is MERGE or a is provably infinite
    CAlt             trigger; pos and neg when the trigger is
                     provably infinite
    CSine (NCO)      phase (its frequency never renders)
    CSine (not NCO)  frequency; phase when the frequency is provably
                     infinite
    CWrap            inner

Every other edge stops it: CAppend, CFin, CReset, CFilter, a timeline.
Provably infinite (the valid end is always the e given): Const, Time,
Noise, an NCO CSine over an infinite phase, a CBinary over two infinite
operands, a CAlt over an infinite trigger, a CWrap over an infinite
inner.  A node class in neither table stops the range and is finite: a
new class joins a table only with a test here.

Each render below is held to the same render with nothing shared
(`plan=()`) bit for bit, states included, and to tuun_tpu's (JAX, jit
off) and the port's oracle within their tolerances."""

import math
from importlib import import_module
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tuun_tpu
import tuun_tpu_torch
from tuun_tpu import ir as jir
from tuun_tpu.engine import CompiledVoice as JaxVoice
from tuun_tpu.engine import EngineConfig as JaxConfig
from tuun_tpu_torch import ir as tir
from tuun_tpu_torch import oracle
from tuun_tpu_torch.engine import CompiledVoice, EngineConfig, graph
from tuun_tpu_torch.engine.capture import flatten
from tuun_tpu_torch.engine.graph import stack_params
from tuun_tpu_torch.parallel import default_mesh, render_voices_meshed
from tuun_tpu_torch.tracker import Tracker

torch.set_num_threads(1)
CPU = "cpu"
SR = 44100
PIANO = "let (on, off) = pm_piano_keys({k!r}, {v!r}) in on"
# drawn-like floats: an integer key or a velocity of 1 folds otherwise
KEYS = ((48.25, 0.8), (60.5, 0.45), (67.75, 0.95), (39.125, 0.3))
BLOCK, WINDOW = 1024, 4096
STARTS = (0, 130, 333, 901)


def _source(text, pkg, sr=SR):
    """`text` evaluated and optimized by `pkg`'s own front end, with the
    piano's libraries open."""
    ev = import_module(f"{pkg.__name__}.evaluator")
    stdlib = Path(pkg.__file__).resolve().parent / "stdlib" / "v0"
    out = ev.Evaluator(sr, 90, stdlib).evaluate_source(
        text, opens=("std", "pm_synth"))
    if isinstance(out, import_module(f"{pkg.__name__}.expr").ESeq):
        out = out.waveform
    return import_module(f"{pkg.__name__}.optimizer").optimize(out.waveform)


def _piano(pkg=tuun_tpu_torch):
    return [_source(PIANO.format(k=k, v=v), pkg) for k, v in KEYS]


def _fast(sr=SR, **kw):
    return EngineConfig(sr, "fast", CPU, **kw)


def _renders(monkeypatch):
    """Counts each engine node class's renders (a CShared's and a
    CFold's are left out: the render of the subtree each wraps is counted
    where it runs)."""
    counts = {}
    todo = [graph.Node]
    while todo:
        cls = todo.pop()
        todo += cls.__subclasses__()
        if "render" not in cls.__dict__ or cls in (graph.CShared,
                                                   graph.CFold):
            continue

        def counted(self, *args, _f=cls.__dict__["render"], _n=cls.__name__):
            counts[_n] = counts.get(_n, 0) + 1
            return _f(self, *args)
        monkeypatch.setattr(cls, "render", counted)
    return counts


def _leaves(tree):
    return flatten(tree)[1]


def _assert_same(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


# -- the piano -----------------------------------------------------------------


def test_piano_keeps_48_of_its_159_node_renders(monkeypatch):
    """pm_piano_keys's voice: 13 members of 10 classes return a stored
    result, saving 111 of the 159 node renders; what renders is one of
    each distinct subtree, class by class (std.tuun's min and max write
    their operands twice, each envelope is applied twice)."""
    w = _piano()[0]
    shared, plain = CompiledVoice(w, _fast()), CompiledVoice(w, _fast(),
                                                             plan=())
    assert shared.shared_renders == 111 and plain.shared_renders == 0
    assert len({cls for _, cls, _ in shared.plan}) == 10
    assert len(shared.plan) == 23
    got = {}
    for voice in (shared, plain):
        counts = _renders(monkeypatch)
        P = voice.params()
        with graph.counting_shared() as saved:
            voice.render_block(P, voice.init(P), 64)
        got[voice is shared] = (dict(counts), saved[0])
        monkeypatch.undo()
    (kept, saved), (every, none) = got[True], got[False]
    assert every == {"CTime": 24, "CAlt": 12, "CBinary": 59, "CConst": 60,
                     "CSine": 4}
    assert kept == {"CTime": 1, "CAlt": 4, "CBinary": 22, "CConst": 17,
                    "CSine": 4}
    assert sum(every.values()) == 159 and sum(kept.values()) == 48
    # no member missed its class's stored result
    assert saved == 111 and none == 0


def test_every_piano_voice_has_one_plan():
    """The voices' keys and velocities are drawn floats: their constants
    coincide alike, so they share one plan and one CompiledVoice."""
    ws = _piano()
    assert len({graph.share_plan(w, _fast()) for w in ws}) == 1
    t = Tracker(SR, BLOCK, precision="fast", device=CPU)
    try:
        assert len({id(t.cache.get(w, t.cfg)) for w in ws}) == 1
    finally:
        t.close()


def _port_piano(plan, blocks):
    ws = _piano()
    voice = CompiledVoice(ws[0], _fast(), plan=plan)
    params = [voice.params_for(w, seed=i + 1) for i, w in enumerate(ws)]
    bp = stack_params(params)
    bs = voice.batched_init(bp)
    out = []
    for b, n in enumerate(blocks):
        fn = voice.batched_render_fn(n, fast=False, mix=False)
        starts = torch.tensor(STARTS if b == 0 else (0,) * len(ws))
        y, v, bs, _ = fn(bp, bs, starts, torch.tensor(n))
        out.append((y, v, bs))
    return out


def _jax_piano(blocks):
    ws = _piano(tuun_tpu)
    voice = JaxVoice(ws[0], JaxConfig(SR, "fast", 0, jit=False))
    params = [voice.params_for(w, seed=i + 1) for i, w in enumerate(ws)]
    bp = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *params)
    bs = jax.vmap(voice._init_impl)(bp)
    out = []
    for b, n in enumerate(blocks):
        fn = voice.batched_render_fn(n, fast=False, lits=None)
        starts = jnp.asarray(STARTS if b == 0 else (0,) * len(ws),
                             jnp.int32)
        y, v, bs, _ = fn(bp, bs, starts, jnp.int32(n))
        out.append((np.asarray(y, np.float64), np.asarray(v),
                    jax.tree_util.tree_leaves(bs)))
    return out


# Fast mode against tuun_tpu's fast mode: the same u32 NCOs and the same
# float32 ops, so only the two libraries' float32 sin differs (a few ulp),
# through an FM index of up to 10 into the carrier: 1e-5 a voice of the
# mix of four.  Against the oracle (float64 phase, no NCO), a voice at a
# time: the NCO's increment is its frequency rounded to 2^-32 of a turn
# and its angle keeps the phase's top 24 bits, and the index carries the
# modulator's error into the carrier, so the gap grows with the phase:
# 2.1e-6 to 5.8e-5 over these 0.16 s (the unshared render alike).
JAX_TOL = 4e-5
ORACLE_TOL = 2e-4


@pytest.fixture(scope="module")
def piano_runs():
    blocks = (BLOCK, BLOCK, BLOCK, WINDOW)  # three blocks, then a window
    return blocks, _port_piano(None, blocks), _port_piano((), blocks)


def test_piano_group_matches_unshared_state_included(piano_runs):
    """A 4-voice group, voices starting at four offsets, three blocks
    then a window: the mix, the valid ends and every state leaf after
    each block bit for bit the render with nothing shared."""
    _, shared, plain = piano_runs
    for (ys, vs, ss), (yp, vp, sp) in zip(shared, plain):
        assert torch.equal(ys, yp) and torch.equal(vs, vp)
        _assert_same(ss, sp)


def test_piano_group_matches_jax_and_the_oracle(piano_runs):
    blocks, shared, _ = piano_runs
    want = _jax_piano(blocks)
    for (y, v, st), (wy, wv, wst) in zip(shared, want):
        np.testing.assert_array_equal(v.numpy(), wv)
        np.testing.assert_allclose(y.double().numpy().sum(0), wy, rtol=0,
                                   atol=JAX_TOL)
        # the state layout is the JAX engine's: integer leaves (positions,
        # NCO words) equal, float leaves within the tolerance
        got = _leaves(st)
        assert len(got) == len(wst)
        for g, x in zip(got, wst):
            x = np.asarray(x)
            if np.issubdtype(x.dtype, np.integer):
                np.testing.assert_array_equal(g.numpy(), x.astype(np.int64))
            else:
                np.testing.assert_allclose(g.numpy(), x, rtol=0,
                                           atol=JAX_TOL)
    total = sum(blocks)
    for i, w in enumerate(_piano()):
        ref = oracle.render(w, total - STARTS[i], SR)
        got = torch.cat([y[i] for y, _, _ in shared]).numpy()
        np.testing.assert_array_equal(got[:STARTS[i]], 0.0)
        np.testing.assert_allclose(got[STARTS[i]:], ref, rtol=0,
                                   atol=ORACLE_TOL)


# -- what is not proven is not shared ------------------------------------------


def _x(ir):
    """An infinite subtree to repeat: an NCO sine times a time ramp."""
    return ir.BinaryPointOp(
        ir.Operator.MULTIPLY,
        ir.Sine(ir.Const(2 * math.pi * 110.0), ir.Const(0.0)), ir.Time())


def _twice(ir):
    """x * 2 twice over: a proven pair, the control of every case."""
    def x2():
        return ir.BinaryPointOp(ir.Operator.MULTIPLY, _x(ir), ir.Const(2.0))
    return ir.BinaryPointOp(ir.Operator.ADD, x2(), x2())


def _fin(ir, w, seconds=0.05):
    return ir.Fin(ir.BinaryPointOp(ir.Operator.SUBTRACT, ir.Time(),
                                   ir.Const(seconds)), w)


def _lpf(ir, w):
    return ir.Filter(w, (ir.Const(0.2), ir.Const(0.3)), (ir.Const(-0.4),))


# Each case adds x where no range is proven: under a fin, after an
# append, inside a filter's input, and on the b side of a finite a.
UNPROVEN = {
    "fin": lambda ir: _fin(ir, _x(ir)),
    "append": lambda ir: ir.Append(_fin(ir, ir.Const(0.5)), _x(ir)),
    "filter": lambda ir: _lpf(ir, _x(ir)),
    "finite_a": lambda ir: ir.BinaryPointOp(
        ir.Operator.MULTIPLY, _fin(ir, ir.Const(0.5)), _x(ir)),
}
SR_SMALL = 8000


def _case(ir, name):
    return ir.BinaryPointOp(ir.Operator.ADD, _twice(ir), UNPROVEN[name](ir))


@pytest.mark.parametrize("name", list(UNPROVEN))
def test_unproven_ranges_are_not_shared(name):
    """Only the control pair shares: the x of the case renders on its
    own, and the render matches the unshared one, JAX and the oracle."""
    control = CompiledVoice(_twice(tir), _fast(SR_SMALL))
    voice = CompiledVoice(_case(tir, name), _fast(SR_SMALL))
    assert control.shared_renders > 0
    assert voice.shared_renders == control.shared_renders
    plain = CompiledVoice(_case(tir, name), _fast(SR_SMALL), plan=())
    P = voice.params()
    s1, s2 = voice.init(P), plain.init(P)
    ys = []
    for n in (64, 64, 640, 64):
        y1, v1, s1, _ = voice.render_block(P, s1, 640, 0, n)
        y2, v2, s2, _ = plain.render_block(P, s2, 640, 0, n)
        assert torch.equal(y1, y2) and torch.equal(v1, v2)
        _assert_same(s1, s2)
        ys.append(y1[:int(v1)].numpy())
    got = np.concatenate(ys)
    jv = JaxVoice(_case(jir, name), JaxConfig(SR_SMALL, "fast", 0,
                                               jit=False))
    jP = jv.params(0)
    jst = jv.init(jP)
    want = []
    for n in (64, 64, 640, 64):
        y, v, jst, _ = jv.render_block(jP, jst, 640, 0, n)
        want.append(np.asarray(y[:int(v)]))
    np.testing.assert_allclose(got, np.concatenate(want), rtol=0, atol=1e-5)
    ref = oracle.render(_case(tir, name), len(got), SR_SMALL)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


def test_a_finite_subtree_shares_whole_where_both_are_ranged():
    """A member may hold any node: two identical filtered, finite
    subtrees share as a whole where both receive the root's range (the
    two operands of a merge), and not where the second is the b of the
    finite first; nothing under their filters or fins is a member."""
    def voice_ir(ir):
        f = _fin(ir, _lpf(ir, _x(ir)), 0.04)
        return ir.BinaryPointOp(ir.Operator.ADD, _x(ir),
                                ir.BinaryPointOp(ir.Operator.ADD, f, f))
    voice = CompiledVoice(voice_ir(tir), _fast(SR_SMALL))
    # x + (F + F): F's second occurrence is b of a finite F, so only the
    # outer x and F's first could pair, and they differ: nothing shares
    assert voice.plan == ()
    inner = tir.BinaryPointOp(tir.Operator.ADD, _fin(tir, _lpf(
        tir, _x(tir)), 0.04), _fin(tir, _lpf(tir, _x(tir)), 0.04))
    merged = tir.BinaryPointOp(tir.Operator.MERGE, inner.a, inner.b)
    shared = CompiledVoice(merged, _fast(SR_SMALL))
    plain = CompiledVoice(merged, _fast(SR_SMALL), plan=())
    # the merge's two operands, at uids 1 and 1 + the first's nodes
    assert [m[0] for m in shared.plan] == [
        1, 1 + sum(1 for _ in merged.a.walk())]
    P = shared.params()
    s1, s2 = shared.init(P), plain.init(P)
    for n in (100, 100, 300):
        y1, v1, s1, _ = shared.render_block(P, s1, 300, 0, n)
        y2, v2, s2, _ = plain.render_block(P, s2, 300, 0, n)
        assert torch.equal(y1, y2) and torch.equal(v1, v2)
        _assert_same(s1, s2)


# -- captures and noise --------------------------------------------------------


def test_captures_and_noises_are_never_members():
    """Two identical subtrees that write a capture both render (each
    writes it), though the x under each capture shares, and the constant
    beside it; two noises differ by their uids."""
    def cap(ir):
        def one():
            return ir.BinaryPointOp(ir.Operator.MULTIPLY,
                                    ir.Captured("x", _x(ir)), ir.Const(2.0))
        return ir.BinaryPointOp(ir.Operator.ADD, one(), one())
    voice = CompiledVoice(cap(tir), _fast(SR_SMALL))
    x_only = CompiledVoice(tir.BinaryPointOp(tir.Operator.ADD, _x(tir),
                                             _x(tir)), _fast(SR_SMALL))
    assert voice.shared_renders == x_only.shared_renders + 1 > 1
    members = [n for n in _nodes(voice.root) if isinstance(n, graph.CShared)]
    assert members and not any(n.has_capture for n in members)
    plain = CompiledVoice(cap(tir), _fast(SR_SMALL), plan=())
    P = voice.params()
    y1, v1, s1, c1 = voice.render_block(P, voice.init(P), 256)
    y2, v2, s2, c2 = plain.render_block(P, plain.init(P), 256)
    assert torch.equal(y1, y2) and set(c1) == set(c2) == {"x"}
    assert all(torch.equal(a, b) for a, b in zip(c1["x"], c2["x"]))
    _assert_same(s1, s2)

    def noisy(ir):
        def one():
            return ir.BinaryPointOp(ir.Operator.MULTIPLY, ir.Noise(),
                                    ir.Const(0.5))
        return ir.BinaryPointOp(ir.Operator.ADD, one(), one())
    voice = CompiledVoice(noisy(tir), _fast(SR_SMALL))
    members = [n for n in _nodes(voice.root) if isinstance(n, graph.CShared)]
    # only the two 0.5 constants share
    assert [type(n.inner) for n in members] == [graph.CConst] * 2
    P = voice.params(seed=7)
    y, v, _, _ = voice.render_block(P, voice.init(P), 256)
    jv = JaxVoice(noisy(jir), JaxConfig(SR_SMALL, "fast", 7, jit=False))
    jP = jv.params(7)
    jy, _, _, _ = jv.render_block(jP, jv.init(jP), 256)
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))


def _nodes(node):
    yield node
    for attr in ("a", "b", "inner", "trigger", "pos", "neg", "freq",
                 "phase", "length"):
        child = getattr(node, attr, None)
        if isinstance(child, graph.Node):
            yield from _nodes(child)


# -- the plan picks the compiled voice -----------------------------------------


def _pair(f1, f2):
    """sine(f1) + sine(f2): one structure whatever the two values."""
    return tir.BinaryPointOp(
        tir.Operator.ADD,
        tir.Sine(tir.Const(2 * math.pi * f1), tir.Const(0.0)),
        tir.Sine(tir.Const(2 * math.pi * f2), tir.Const(0.0)))


def test_constants_that_coincide_differently_compile_apart():
    """Two voices of one structure whose constants coincide differently
    (the two pitches equal in one, not in the other) land in two
    CompiledVoices, so two groups, each rendering as it would alone; the
    mesh's batch of both compiles one voice that shares nothing."""
    same, apart = _pair(220.0, 220.0), _pair(220.0, 330.0)
    cfg = _fast(SR_SMALL)
    assert graph.structure_key(same, SR_SMALL) == \
        graph.structure_key(apart, SR_SMALL)
    assert graph.share_plan(same, cfg) != graph.share_plan(apart, cfg)
    t = Tracker(SR_SMALL, 64, precision="fast", device=CPU)
    try:
        a, b = t.cache.get(same, t.cfg), t.cache.get(apart, t.cfg)
        assert a is not b and a.shared_renders > b.shared_renders
        t.play(0, same, start=0)
        t.play(1, apart, start=0)
        t.play(2, _pair(440.0, 440.0), start=0)
        mix = np.concatenate([np.asarray(t.render_block()[0])
                              for _ in range(4)])
        assert len(t._groups) + len(t._singles) == 2
        assert {id(v.compiled) for v in t.active} == {id(a), id(b)}
    finally:
        t.close()
    want = sum(_alone(w, 4 * 64) for w in
               (same, apart, _pair(440.0, 440.0)))
    np.testing.assert_allclose(mix, want, rtol=0, atol=1e-6)
    mesh = default_mesh(2, CPU)
    got = render_voices_meshed([same, apart], 256, SR_SMALL, mesh=mesh,
                               block=64, device=CPU, lane_shard=False)
    np.testing.assert_allclose(got, _alone(same, 256) + _alone(apart, 256),
                               rtol=0, atol=1e-6)


def _alone(w, n):
    voice = CompiledVoice(w, _fast(SR_SMALL), plan=())
    P = voice.params()
    y, _, _, _ = voice.render_block(P, voice.init(P), n)
    return y.numpy()


# -- a modify's splice ---------------------------------------------------------


def test_a_spliced_voice_shares_nothing():
    """time + mark(time): the twins share from the start; a modify that
    puts a fresh time under the mark leaves the two ramps at different
    positions, so the spliced voice renders each (the marked ramp from 0,
    the other on), as the reference's tracker plays it."""
    sr, n = 100, 16
    w = tir.BinaryPointOp(tir.Operator.ADD, tir.Time(),
                          tir.Marked("m", tir.Time()))
    t = Tracker(sr, n, precision="fast", device=CPU)
    try:
        t.play(0, w, start=0)
        first = [np.asarray(t.render_block()[0]) for _ in range(3)]
        (voice,) = t.active
        assert voice.compiled.shared_renders == 1
        t.modify(0, "m", tir.Time())
        (voice,) = t.active
        assert voice.compiled.plan == ()
        after = [np.asarray(t.render_block()[0]) for _ in range(2)]
    finally:
        t.close()
    lanes = np.arange(n, dtype=np.float64)
    for b, y in enumerate(first):
        np.testing.assert_allclose(y, 2 * (b * n + lanes) / sr, atol=1e-6)
    for b, y in enumerate(after):
        np.testing.assert_allclose(y, ((3 + b) * n + lanes) / sr
                                   + (b * n + lanes) / sr, atol=1e-6)

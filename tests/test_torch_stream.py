"""The tracker's streaming path in the port on the CPU: deferred sync,
the fused session step, lookahead windows and window prefetch.

  * Twins of tests/test_tracker.py's streaming tests (each keeps its JAX
    name), on the port's Tracker at the same sizes (100 Hz, 16-sample
    blocks).  On the CPU the fused step and the window run as plain
    closures, as the JAX tracker runs them without jit.  Where the
    reference interrupts a window with a Modify (not yet ported), these
    interrupt it with a play that starts inside the window.
  * The fused step bit for bit against the per-voice path; windows within
    test_tracker.py's atol=1e-6 (a window renders K*n lanes in one call,
    and the engine's block-size invariance holds to a tolerance).
  * The port's tracker against tuun_tpu's at sync_interval=4 with the
    fused step and windows on both sides (fuse_blocking), on
    test_torch_groups.py's polyphonic score and a stable set: the mix and
    every block's dispatches.
  * A prefetched window goes stale after an interrupting play and after a
    regroup, and is discarded.
  * The captured path's handling in the tracker, on a model of a CUDA
    graph replay (the captured body rerun on the step's static inputs,
    into the same output buffers): states bound to the step's buffers,
    copies in and out, a same-key set swapped in, regroups and windows.
  * Filters deeper than the affine scan's 8 coefficients, in exact mode
    and in fast mode (the linear recurrence), alone, as a voice group
    against tuun_tpu's tracker, and through a modify that carries the
    history.
"""

import functools
import importlib.util
import warnings
from importlib import import_module
from pathlib import Path

import numpy as np
import pytest
import torch

import tuun_tpu
import tuun_tpu_torch
import test_torch_groups as ttg
from tuun_tpu import ir as jir
from tuun_tpu.tracker import Tracker as JaxTracker
from tuun_tpu_torch import ir
from tuun_tpu_torch import tracker as T
from tuun_tpu_torch.engine import render
from tuun_tpu_torch.engine import timeline as tl
from tuun_tpu_torch.engine.capture import (GraphStep, flatten, tree_clone,
                                           unflatten)
from tuun_tpu_torch.engine.graph import Params
from tuun_tpu_torch.ids import WaveformId
from tuun_tpu_torch.player import build_top_level_waveform
from tuun_tpu_torch.tracker import Tracker
from tuun_tpu_torch.wav import read_wav

torch.set_num_threads(1)
CPU = "cpu"
P = WaveformId.program


def fin_const(value, seconds):
    return ir.Fin(ir.BinaryPointOp(ir.Operator.SUBTRACT, ir.Time(),
                                   ir.Const(float(seconds))),
                  ir.Const(float(value)))


def sine(f):
    return build_top_level_waveform(ir.Sine(ir.Const(f), ir.Const(0.0)), 0.0)


def make_tracker(sr=100, block=16, **kw):
    kw.setdefault("precision", "exact")
    return Tracker(sr, block, device=CPU, **kw)


def host(y):
    return np.asarray(y, np.float32)


# -- deferred sync ---------------------------------------------------------


def test_capture_survives_exact_retirement_with_deferred_syncs(tmp_path):
    # Exact retirement can finish a voice while copies holding its
    # capture slices are still queued; closing must drain them first or
    # the capture WAV loses its tail.
    t = make_tracker(captured_output_dir=tmp_path, sync_interval=4)
    t.captured_date_format = ""
    t.play("a", ir.Captured("dump", fin_const(0.25, 0.20)))
    t.run_to_completion()
    t.stop_all()
    samples, sr = read_wav(tmp_path / "dump.wav")
    np.testing.assert_array_equal(samples, np.full(20, 0.25, np.float32))
    t.close()


def test_deferred_sync_equivalence(tmp_path):
    """sync_interval > 1 pipelines blocks without host syncs; output,
    retirement and captures must match the per-block-sync tracker."""
    def run(interval, outdir):
        t = make_tracker(captured_output_dir=outdir, sync_interval=interval)
        t.captured_date_format = ""
        t.play("a", ir.Captured("cap", fin_const(0.5, 0.37)))
        t.play("b", fin_const(0.25, 0.83), start=21)
        mix = t.run_to_completion(max_seconds=3.0)
        t.close()
        return host(mix), t

    d1 = tmp_path / "s1"
    d4 = tmp_path / "s4"
    m1, t1 = run(1, d1)
    m4, t4 = run(4, d4)
    n = min(len(m1), len(m4))
    np.testing.assert_array_equal(m1[:n], m4[:n])
    assert np.all(m4[n:] == 0) and np.all(m1[n:] == 0)
    assert not t4.active and not t4.pending
    a1, _ = read_wav(d1 / "cap.wav")
    a4, _ = read_wav(d4 / "cap.wav")
    np.testing.assert_array_equal(a1, a4)


def test_deferred_mix_stays_on_the_device():
    """With deferred sync render_block returns a tensor (the device's: a
    CPU tensor here) and reads nothing until the sync point; the engine's
    valid samples are accounted from the resolved valid ends."""
    t = make_tracker(sync_interval=4)
    t.play("a", fin_const(1.0, 0.5))  # 50 samples
    y, _ = t.render_block()
    assert isinstance(y, torch.Tensor)
    voice = t.active[0]
    assert voice._pending_v and voice.produced == 0
    t.run_to_completion()
    t.stop_all()
    assert voice.produced == 50 and voice.ended
    t.close()


def test_deferred_output_delivery_sink_order():
    """run_to_completion's packed-window output delivery hands the sink
    every block, in order, exactly once (blocks resolve lazily after
    their device->host copies land)."""
    t = make_tracker(sync_interval=4)
    # A ramp makes block identity visible: sample k = k / sr.
    t.play("a", ir.Fin(
        ir.BinaryPointOp(ir.Operator.SUBTRACT, ir.Time(), ir.Const(3.0)),
        ir.Time()))
    seen = []
    mix = t.run_to_completion(max_seconds=5.0, sink=seen.append)
    got = np.concatenate([host(c) for c in seen])
    np.testing.assert_array_equal(got, host(mix))
    n_valid = int(3.0 * t.sample_rate)
    expected = np.arange(n_valid, dtype=np.float32) / t.sample_rate
    np.testing.assert_allclose(mix[:n_valid], expected, atol=1e-5)
    assert np.all(host(mix[n_valid:]) == 0.0)
    t.close()


def test_deferred_host_blocks_keep_fifo_order(monkeypatch):
    """Host blocks rendered while no voices are active (a silent gap before
    a pending voice) must not jump ahead of device blocks whose copies to
    the host are still in flight: every block routes through the same
    delivery FIFO."""
    def program(t):
        t.play("a", fin_const(1.0, 0.30))            # samples 0-29
        t.play("b", fin_const(2.0, 0.20), start=96)  # samples 96-115

    ref = make_tracker(sync_interval=1)
    program(ref)
    expected = ref.run_to_completion(max_seconds=3.0)

    real_ready = T._staged_ready

    def lagging_ready(staged):
        # Output packs (>= one block of samples) report "copy not landed":
        # the small, earlier-issued valid-end packs land first.
        if int(np.prod(staged[0].shape)) >= 16:
            return False
        return real_ready(staged)

    monkeypatch.setattr(T, "_staged_ready", lagging_ready)
    t = make_tracker(sync_interval=4)
    program(t)
    got = t.run_to_completion(max_seconds=3.0)

    n = min(len(expected), len(got))
    np.testing.assert_allclose(got[:n], expected[:n], atol=1e-6)
    assert np.all(host(got[n:]) == 0.0)
    assert np.all(host(expected[n:]) == 0.0)
    t.close()


# -- the fused session step -------------------------------------------------


def _session_tracker(fuse: bool, **kw):
    t = Tracker(100, 16, precision="fast", device=CPU, **kw)
    t.fuse = fuse
    t.fuse_blocking = True
    # Two distinct structures plus a same-structure pair (one group): the
    # full fused-step shape.
    t.play(P(0), sine(3.0))
    t.play(P(1), build_top_level_waveform(fin_const(0.25, 0.9), 0.0))
    t.play(P(2), sine(7.0))
    return t


def test_fused_session_step_matches_per_voice():
    """After fuse_after stable blocks the whole voice set renders as ONE
    step; the mix must equal the per-voice path bit for bit."""
    blocks = 12
    ref = _session_tracker(fuse=False)
    want = [ref.render_block()[0] for _ in range(blocks)]
    got_t = _session_tracker(fuse=True)
    got, dispatches = [], []
    for _ in range(blocks):
        y, status = got_t.render_block()
        got.append(y)
        dispatches.append(status.dispatches)
    np.testing.assert_array_equal(np.concatenate(got), np.concatenate(want))
    assert dispatches[0] > 1          # warming up: per-member dispatch
    assert dispatches[-1] == 1        # fused steady state
    # The finite voice retires on schedule under fusion too.
    assert all(v.id != P(1) for v in got_t.active)
    # The states too: each voice's, after the fused blocks.
    ref._materialize_groups()
    got_t._materialize_groups()
    for a, b in zip(ref.active, got_t.active):
        _, la = flatten(a.state)
        _, lb = flatten(b.state)
        assert all(torch.equal(x, y) for x, y in zip(la, lb))


def test_fused_session_step_deferred_sync_levels_and_captures(tmp_path):
    ref = Tracker(100, 16, precision="fast", device=CPU, sync_interval=4,
                  levels=True, captured_output_dir=tmp_path,
                  captured_date_format="")
    ref.fuse = False
    fus = Tracker(100, 16, precision="fast", device=CPU, sync_interval=4,
                  levels=True, captured_output_dir=tmp_path / "f",
                  captured_date_format="")
    (tmp_path / "f").mkdir()
    fus.fuse = True
    fus.fuse_blocking = True
    for t in (ref, fus):
        t.play(P(0), build_top_level_waveform(
            ir.Captured("fcap", fin_const(0.5, 0.5)), 0.0))
        t.play(P(1), sine(5.0))
    want = [ref.render_block()[0] for _ in range(16)]
    got = [fus.render_block()[0] for _ in range(16)]
    np.testing.assert_allclose(np.concatenate([host(g) for g in got]),
                               np.concatenate([host(w) for w in want]),
                               atol=1e-6)
    a = read_wav(tmp_path / "fcap.wav")[0]
    b = read_wav(tmp_path / "f" / "fcap.wav")[0]
    np.testing.assert_allclose(b, a, atol=1e-6)
    # Levels resolved for both voices through the fused deferred path.
    lv = {v.id: v.level_rms for v in fus.active}
    assert lv and all(x > 0 for x in lv.values())
    for t in (ref, fus):
        t.close()


# -- lookahead windows ------------------------------------------------------


def _window_tracker(fuse: bool, lookahead=4, **kw):
    t = Tracker(100, 16, precision="fast", device=CPU, sync_interval=4,
                **kw)
    t.fuse = fuse
    t.fuse_blocking = True
    t.lookahead = lookahead
    t.play(P(0), sine(3.0))
    t.play(P(1), build_top_level_waveform(fin_const(0.25, 1.2), 0.0))
    t.play(P(2), sine(7.0))
    return t


def test_lookahead_window_matches_per_block():
    """Steady-state streaming renders K blocks per step; the served mix
    must equal the per-block path, including a finite voice retiring
    inside a window."""
    blocks = 24
    ref = _window_tracker(fuse=False, lookahead=1)
    want = [host(ref.render_block()[0]) for _ in range(blocks)]
    t = _window_tracker(fuse=True)
    got, disp = [], []
    for _ in range(blocks):
        y, st = t.render_block()
        got.append(host(y))
        disp.append(st.dispatches)
    np.testing.assert_allclose(np.concatenate(got), np.concatenate(want),
                               atol=1e-6)
    # Windows opened: an opening block counts 1 dispatch, serves count 0.
    assert 0 in disp and disp.count(0) >= 6
    assert t.window_opens >= 2
    # The finite voice (1.2 s = 120 samples) retired.
    assert all(v.id != P(1) for v in t.active)
    t.close()


def _interrupted(fuse: bool, evict: bool = False):
    """6 blocks, then a play starting now (inside the fused tracker's
    window), then 10 blocks."""
    t = _window_tracker(fuse=fuse, lookahead=4 if fuse else 1)
    mix = [host(t.render_block()[0]) for _ in range(6)]
    assert (t._window is not None) == fuse  # mid-window on the fused one
    if evict:
        t._fused_cache.clear()  # the window's step evicted mid-window
    t.play(P(3), sine(11.0))
    assert t._window is None
    mix += [host(t.render_block()[0]) for _ in range(10)]
    t.close()
    return np.concatenate(mix)


def test_lookahead_window_interrupt_play_exact():
    """A play mid-window interrupts: the served sub-blocks replay from the
    window's inputs, so the new voice starts at exactly its block."""
    np.testing.assert_allclose(_interrupted(True), _interrupted(False),
                               atol=1e-6)


def test_lookahead_window_interrupt_survives_cache_eviction():
    """If the window's step disappears mid-window (LRU churn), the
    interrupt replay must fall back to the per-block paths instead of
    skipping the served blocks, which would freeze every voice's state
    while `now` advances."""
    np.testing.assert_allclose(_interrupted(True, evict=True),
                               _interrupted(False), atol=1e-6)


def test_lookahead_window_respects_pending_starts():
    """A pending voice starting inside the would-be window keeps the
    per-block path (no window may cross a promotion boundary)."""
    t = _window_tracker(fuse=True)
    t.play(P(3), sine(5.0), start=40)
    ref = _window_tracker(fuse=False, lookahead=1)
    ref.play(P(3), sine(5.0), start=40)
    got = np.concatenate([host(t.render_block()[0]) for _ in range(12)])
    want = np.concatenate([host(ref.render_block()[0]) for _ in range(12)])
    np.testing.assert_allclose(got, want, atol=1e-6)
    t.close()
    ref.close()


def test_window_declines_more_lanes_than_a_block_may_hold(monkeypatch):
    """K*n past graph.MAX_BLOCK: the window declines, as for an
    ineligible set, and the fused step serves every block."""
    monkeypatch.setattr(T, "MAX_BLOCK", 63)  # K*n = 64
    t = _window_tracker(fuse=True)
    disp = [t.render_block()[1].dispatches for _ in range(12)]
    assert t.window_opens == 0 and disp[-1] == 1
    t.close()


def test_window_sync_cadence_counts_blocks_not_windows():
    """_since_sync accounts for every block a window served, so finite
    renders don't gain window-multiplied trailing-zero tails."""
    la = _window_tracker(fuse=True)
    out_la = la.run_to_completion(max_seconds=5)
    ref = _window_tracker(fuse=False, lookahead=1)
    out_ref = ref.run_to_completion(max_seconds=5)
    assert abs(len(out_la) - len(out_ref)) <= 4 * 16
    n = min(len(out_la), len(out_ref))
    np.testing.assert_allclose(out_la[:n], out_ref[:n], atol=1e-6)
    la.close()
    ref.close()


def test_remove_pending_does_not_interrupt_window():
    t = _window_tracker(fuse=True)
    t.play(P(5), sine(5.0), start=10_000)
    for _ in range(4):
        t.render_block()
    assert t._window is not None
    t.remove_pending(P(5))
    assert t._window is not None  # pending edits can't touch the window
    assert all(p.id != P(5) for p in t.pending)
    # A play that can't start inside the window doesn't interrupt either.
    t.play(P(6), sine(2.0), start=10_000)
    assert t._window is not None
    t.close()


def test_windowed_streaming_steady_state_compiles_nothing():
    """Once warm, the lookahead-window streaming path builds no new step:
    no capture starts and no cache entry is added (all-infinite voices:
    a retirement is a legitimate set change)."""
    t = Tracker(100, 16, precision="fast", device=CPU, sync_interval=4)
    t.fuse = True
    t.fuse_blocking = True
    t.lookahead = 4
    for i in range(3):
        t.play(P(i), sine(3.0 + 2 * i))
    for _ in range(12):
        t.render_block()
    steps = {id(e["step"]) for e in t._fused_cache.values()}
    started = t.captures_started
    for _ in range(24):
        t.render_block()
    assert {id(e["step"]) for e in t._fused_cache.values()} == steps
    assert t.captures_started == started
    assert t.window_opens >= 6
    t.stop_all()
    t.close()


def test_interrupt_window_keeps_sync_cadence():
    """Blocks served from a window before an interrupt must count toward
    the sync cadence."""
    t = Tracker(100, 16, precision="fast", device=CPU, sync_interval=4)
    t.fuse = True
    t.fuse_blocking = True
    t.lookahead = 4
    for i in range(2):
        t.play(P(i), sine(3.0 + 2 * i))
    for _ in range(12):
        t.render_block()
    assert t._window is not None
    served = t._window["k"]
    before = t._since_sync
    t.play(P(7), sine(9.0))  # interrupts
    assert t._window is None
    assert t._since_sync == before + served
    t.stop_all()
    t.close()


def test_single_member_set_gets_lookahead_window():
    """A one-instrument session must still engage lookahead windows."""
    t = Tracker(100, 16, precision="fast", device=CPU, sync_interval=4)
    t.fuse = True
    t.fuse_blocking = True
    t.lookahead = 4
    t.play(P(0), sine(3.0))
    opened = False
    for _ in range(16):
        t.render_block()
        opened = opened or t._window is not None
    assert opened
    t.stop_all()
    t.close()


def test_window_interrupt_refreshes_levels():
    """The one-step interrupt replay keeps per-voice levels live (the
    window's level tail tracks the runtime extent, so a replay of k
    served sub-blocks reports the k-th block's levels, not the zeros past
    the extent)."""
    t = Tracker(100, 16, precision="fast", device=CPU, sync_interval=4,
                levels=True)
    t.fuse = True
    t.fuse_blocking = True
    t.lookahead = 4
    # Two same-structure sines (a group) and one distinct single.
    t.play(P(0), sine(3.0))
    t.play(P(1), sine(7.0))
    t.play(P(2), build_top_level_waveform(
        ir.BinaryPointOp(ir.Operator.MULTIPLY, ir.Noise(), ir.Const(0.5)),
        0.0))
    for _ in range(6):
        t.render_block()
    assert t._window is not None  # mid-window
    # Wipe every resolved and pending level: any nonzero below must come
    # from the interrupt replay itself.
    for v in t.active:
        v.level_rms = 0.0
        v.level_peak = 0.0
        v._pending_levels = []
    for g in t._groups:
        g._pending = []
    t.play(P(3), sine(9.0), start=10_000)
    t.play(P(4), sine(2.0))  # starts now: interrupts
    assert t._window is None
    t._sync_voices(drain=True)
    lv = {v.id: (v.level_rms, v.level_peak) for v in t.active}
    assert len(lv) == 3
    for wid in (P(0), P(1), P(2)):
        rms, peak = lv[wid]
        assert rms > 0 and peak > 0, (wid, rms, peak)
    t.close()


# -- window prefetch --------------------------------------------------------


def _drain_prefetch(t):
    pf = t._prefetch
    if pf is not None:
        assert pf["done"].wait(10)


def test_window_prefetch_adopts_and_matches_per_block():
    """Steady-state windows adopt the next window rendered on the worker
    from the previous window's end states, and the served audio stays
    the per-block path's, including a finite voice retiring inside a
    window."""
    blocks = 24
    ref = _window_tracker(fuse=False, lookahead=1)
    want = [host(ref.render_block()[0]) for _ in range(blocks)]
    t = _window_tracker(fuse=True)
    got = []
    for _ in range(blocks):
        y, _ = t.render_block()
        got.append(host(y))
        _drain_prefetch(t)  # deterministic adoption
    np.testing.assert_allclose(np.concatenate(got), np.concatenate(want),
                               atol=1e-6)
    assert t.prefetch_hits >= 2
    t.close()


def _prefetched_window(**kw):
    """A tracker of two same-pitch-structure sines and a third voice, run
    until a window is open with its prefetch rendered."""
    t = _window_tracker(fuse=True, **kw)
    for _ in range(12):
        t.render_block()
        _drain_prefetch(t)
        if t._window is not None and t._window["k"] == 1:
            break
    assert t._window is not None and t._prefetch is not None
    return t


def test_window_prefetch_invalidated_by_an_interrupting_play():
    """A play that interrupts the window replaces every member's state,
    so the prefetched next window is stale: it is discarded, and the
    audio matches the per-block path."""
    t = _prefetched_window()
    pf = t._prefetch
    k0 = t.now // 16
    t.play(P(3), sine(11.0))  # starts now: interrupts
    assert t._window is None
    ref = _window_tracker(fuse=False, lookahead=1)
    want = [host(ref.render_block()[0]) for _ in range(k0)]
    ref.play(P(3), sine(11.0))
    misses = t.prefetch_misses
    got = []
    for _ in range(8):
        got.append(host(t.render_block()[0]))
        want.append(host(ref.render_block()[0]))
        _drain_prefetch(t)
    assert t.prefetch_misses > misses and t._prefetch is not pf
    np.testing.assert_allclose(np.concatenate(got),
                               np.concatenate(want[k0:]), atol=1e-6)
    t.close()
    ref.close()


def test_window_prefetch_invalidated_by_a_regroup():
    """A prefetch built before a regroup (a voice joins at the window's
    end: the groups are new objects) is discarded at the next open."""
    t = _prefetched_window()
    end = t._window["start"] + 4 * 16
    t.play(P(3), sine(3.5), start=end)  # no interrupt: starts at the end
    assert t._window is not None
    pf = t._prefetch
    hits, misses = t.prefetch_hits, t.prefetch_misses
    while t.now < end + 8 * 16:
        t.render_block()
        _drain_prefetch(t)
    assert t.prefetch_misses > misses or (
        t.prefetch_hits == hits and t._prefetch is not pf)
    assert pf["result"] is not None  # it was rendered, then not adopted
    t.close()


def test_window_prefetch_disabled_flag():
    t = _window_tracker(fuse=True)
    t.prefetch_windows = False
    for _ in range(16):
        t.render_block()
    assert t.prefetch_hits == 0 and t._prefetch is None
    t.close()


# -- against tuun_tpu's tracker ---------------------------------------------


def _stream(tracker, notes, blocks):
    for wid, w, start in notes:
        tracker.play(wid, w, start=start)
    out, disp = [], []
    for _ in range(blocks):
        y, s = tracker.render_block()
        out.append(np.asarray(y, np.float64))
        disp.append(s.dispatches)
        pf = getattr(tracker, "_prefetch", None)
        if pf is not None:
            assert pf["done"].wait(60)
    return np.concatenate(out), disp


def _stream_notes(pkg, sr):
    """test_torch_groups.py's polyphonic score, then a stable set that
    starts once the score has ended: two FM notes (one group), a filtered
    saw and a generic-reset note, held for 24 blocks."""
    notes = ttg._score(pkg, sr)[:9]
    later = 12 * 128
    notes += [(f"hold{j}", ttg._std(text, sr, pkg), later)
              for j, text in enumerate((
                  "sine(2*pi*(200 + 30*$(5)), 0) * 0.5",
                  "sine(2*pi*(240 + 30*$(5)), 0) * 0.5",
                  "sawtooth(110) | lpf(0.7, 2000)",
                  "reset(triangle(90), time * -100) * 2"))]
    return notes


def test_stream_matches_jax_tracker_with_windows():
    sr, block, blocks = ttg.SR, 128, 40
    jt = JaxTracker(sr, block, precision="fast", jit=True, sync_interval=4)
    jt.fuse_blocking = True
    want, jd = _stream(jt, _stream_notes(tuun_tpu, sr), blocks)
    jt.close()
    pt = Tracker(sr, block, precision="fast", device=CPU, sync_interval=4)
    pt.fuse_blocking = True
    got, pd = _stream(pt, _stream_notes(tuun_tpu_torch, sr), blocks)
    np.testing.assert_allclose(got, want, rtol=0, atol=8 * 2e-5)
    assert pd == jd
    assert pt.window_opens >= 2 and pt.prefetch_hits >= 1
    assert 0 in pd and 1 in pd
    pt.close()


# -- the capture helpers' trees ---------------------------------------------


def test_flatten_round_trip_and_clone():
    P0 = Params(torch.arange(3.0), (torch.ones(2),), torch.tensor(5),
                host="mirror")
    tree = (P0, [torch.zeros(1), None], {"cap": (torch.ones(4), 2, 3)})
    spec, leaves = flatten(tree)
    assert len(leaves) == 5
    back = unflatten(spec, leaves)
    assert back[0].host == "mirror" and back[1][1] is None
    assert back[2]["cap"][1:] == (2, 3)
    c = tree_clone(tree)
    _, cl = flatten(c)
    assert all(torch.equal(a, b) and a is not b for a, b in zip(leaves, cl))


# -- filters deeper than the affine scan ------------------------------------


@functools.lru_cache(maxsize=None)
def _stable_feedback(J):
    """chip_smoke.py's stable J-deep all-pole section, the one its phases
    11 and 12 drive on the card."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_for_stream_tests",
        Path(__file__).resolve().parent.parent / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return tuple(mod.stable_feedback(J))


def _deep(irmod, J, b=(0.5, 0.25), inner=None):
    a = _stable_feedback(J)
    if inner is None:
        inner = irmod.Fin(irmod.BinaryPointOp(
            irmod.Operator.SUBTRACT, irmod.Time(), irmod.Const(40.0)),
            irmod.Time())
    return irmod.Filter(inner, tuple(irmod.Const(x) for x in b),
                        tuple(irmod.Const(float(x)) for x in a))


@pytest.mark.parametrize("J", [9, 12])
def test_exact_mode_renders_deep_feedback(J):
    """Exact mode runs the recurrence lane by lane, at any depth, like
    tuun_tpu's lax.scan: against the numpy oracle and tuun_tpu's exact
    render (test_engine.py's filter tolerance)."""
    from tuun_tpu.engine import render as jax_render
    n, sr = 60, 1
    got = render(_deep(ir, J), n, sr, precision="exact", block=16,
                 device=CPU)
    ref = tuun_tpu.oracle.render(_deep(jir, J), n, sr)
    want = np.asarray(jax_render(_deep(jir, J), n, sr, precision="exact"))
    assert len(got) == len(ref) == 40
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got, want[:len(got)], atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("J", [9, 12, 16])
def test_fast_mode_renders_deep_feedback(J, monkeypatch):
    """Fast mode runs a filter deeper than the affine scan's MAX_J on its
    deep form (tuun_tpu's fast mode on an associative scan of companion
    maps): against the numpy oracle and tuun_tpu's fast render within
    1e-5 of scale, the bound of the exact test above taken relative to
    the peak (769 to 1248 here).  J <= MAX_J keeps the affine scan."""
    from tuun_tpu.engine import render as jax_render
    from tuun_tpu_torch.engine import scan_ops
    calls = {"rec": 0, "deep": 0, "affine": 0}
    rec, affine = scan_ops.linear_recurrence, scan_ops.affine_scan_f32
    deep = scan_ops.affine_scan_deep_f32

    def counted(key, fn):
        def wrapped(*a):
            calls[key] += 1
            return fn(*a)
        return wrapped
    monkeypatch.setattr(scan_ops, "linear_recurrence", counted("rec", rec))
    monkeypatch.setattr(scan_ops, "affine_scan_deep_f32",
                        counted("deep", deep))
    monkeypatch.setattr(scan_ops, "affine_scan_f32",
                        counted("affine", affine))
    n, sr = 60, 1
    got = render(_deep(ir, J), n, sr, precision="fast", block=16,
                 device=CPU)
    ref = tuun_tpu.oracle.render(_deep(jir, J), n, sr)
    want = np.asarray(jax_render(_deep(jir, J), n, sr, precision="fast"))
    assert len(got) == len(ref) == 40
    assert calls == {"rec": 0, "deep": 3, "affine": 0}
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(got / scale, ref / scale, atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(got / scale, want[:len(got)] / scale,
                               atol=1e-5, rtol=1e-5)
    render(_deep(ir, 8), n, sr, precision="fast", block=16, device=CPU)
    assert calls == {"rec": 0, "deep": 3, "affine": 3}


DEEP_SR, DEEP_BLOCK = 100, 16


def _mod(pkg, name):
    return import_module(f"{pkg.__name__}.{name}")


def _deep_notes(pkg, J=12):
    """Four J-deep filtered sines that differ only in constants (the
    feed-forward pair and the frequency), so the group key puts them in
    one group; the first feedback coefficient marked for a modify."""
    I = _mod(pkg, "ir")
    top = _mod(pkg, "player").build_top_level_waveform
    notes = []
    for i in range(4):
        sine = I.Sine(I.Const(2 * np.pi * (5 + 2 * i)), I.Const(0.0))
        inner = I.Fin(I.BinaryPointOp(I.Operator.SUBTRACT, I.Time(),
                                      I.Const(2.5)), sine)
        f = _deep(I, J, b=(0.5 + 0.1 * i, 0.25 - 0.05 * i), inner=inner)
        fb = (I.Marked("a0", f.feedback[0]),) + tuple(f.feedback[1:])
        notes.append((f"d{i}", top(I.Filter(f.waveform, f.feed_forward, fb),
                                   0.0), 3 * i))
    return notes


def _deep_run(t, pkg, modify_at=None, factor=0.97, blocks=20):
    for wid, w, start in _deep_notes(pkg):
        t.play(wid, w, start=start)
    out, status = [], []
    for k in range(blocks):
        if k == modify_at:
            a0 = float(_stable_feedback(12)[0])
            t.modify("d2", "a0", _mod(pkg, "ir").Const(factor * a0))
        y, s = t.render_block()
        out.append(np.asarray(y, np.float64))
        status.append(s)
        pf = getattr(t, "_prefetch", None)
        if pf is not None:
            assert pf["done"].wait(60)
    return np.concatenate(out), status


@pytest.mark.parametrize("sync_interval", [1, 4])
def test_fast_deep_group_matches_jax_tracker(sync_interval, monkeypatch):
    """Four J = 12 voices in one group through the port's fast tracker,
    against tuun_tpu's at sync_interval 1 (per-call path: the group is
    one dispatch) and 4 (the fused step and windows, fuse_blocking on
    both), every warning an error (a vmap op without a batching rule
    would loop).  The group's feedback reaches the deep affine scan's
    rows form.  Per sample within 1e-5 of the mix's peak for each
    voice."""
    from tuun_tpu_torch.engine import scan_ops
    rows = []
    deep_rows = scan_ops.affine_scan_deep_rows_f32

    def counted(*a):
        rows.append(a[0].shape[0])
        return deep_rows(*a)
    monkeypatch.setattr(scan_ops, "affine_scan_deep_rows_f32", counted)
    fused = sync_interval > 1
    jt = JaxTracker(DEEP_SR, DEEP_BLOCK, precision="fast", jit=True,
                    sync_interval=sync_interval)
    jt.fuse, jt.fuse_blocking = fused, True
    want, jst = _deep_run(jt, tuun_tpu)
    jt.close()
    pt = Tracker(DEEP_SR, DEEP_BLOCK, precision="fast", device=CPU,
                 sync_interval=sync_interval)
    pt.fuse, pt.fuse_blocking = fused, True
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got, pst = _deep_run(pt, tuun_tpu_torch)
    pt.close()
    assert len(got) == len(want)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=4 * 1e-5 * scale)
    assert [s.dispatches for s in pst] == [s.dispatches for s in jst]
    assert 4 in rows
    if not fused:
        assert any(s.voices == 4 and s.dispatches == 1 for s in pst)


@pytest.mark.parametrize("sync_interval", [1, 4])
def test_fast_deep_modify_carries_history(sync_interval):
    """A modify of a grouped J = 12 voice's marked feedback coefficient:
    the voice leaves its group and keeps its filter history (carry_state),
    as tuun_tpu's does; the mix against tuun_tpu's tracker."""
    jt = JaxTracker(DEEP_SR, DEEP_BLOCK, precision="fast", jit=True,
                    sync_interval=sync_interval)
    jt.fuse_blocking = True
    want, jst = _deep_run(jt, tuun_tpu, modify_at=6)
    jt.close()
    pt = Tracker(DEEP_SR, DEEP_BLOCK, precision="fast", device=CPU,
                 sync_interval=sync_interval)
    pt.fuse_blocking = True
    got, pst = _deep_run(pt, tuun_tpu_torch, modify_at=6)
    ops = [op for op in pt.op_log if op[0] == "modify"]
    pt.close()
    assert len(ops) == 1 and "carry" in ops[0][3]
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=4 * 1e-5 * scale)
    assert [s.dispatches for s in pst] == [s.dispatches for s in jst]
    # The same modify to the coefficient's own value leaves the mix as it
    # was: a history dropped at the splice would restart the filter.
    same = Tracker(DEEP_SR, DEEP_BLOCK, precision="fast", device=CPU,
                   sync_interval=sync_interval)
    same.fuse_blocking = True
    kept, _ = _deep_run(same, tuun_tpu_torch, modify_at=6, factor=1.0)
    same.close()
    plain = Tracker(DEEP_SR, DEEP_BLOCK, precision="fast", device=CPU,
                    sync_interval=sync_interval)
    plain.fuse_blocking = True
    unmodified, _ = _deep_run(plain, tuun_tpu_torch)
    plain.close()
    np.testing.assert_allclose(kept, unmodified, rtol=0, atol=1e-6 * scale)
    assert np.abs(got - unmodified).max() > 1e-3 * scale


# -- the captured path, on a model of a replay ------------------------------


class ModelStep(GraphStep):
    """A GraphStep whose replay reruns the captured body on the static
    inputs and copies its outputs into the same output buffers, as a CUDA
    graph replay overwrites them: everything of the captured path but the
    graph itself, on the CPU."""

    def capture(self):
        self.fn(self.static_params, self.static_states, self.scalars)
        self._out_spec, self._packed, self._layout = self._body()
        self._graph = "model"

    def _replay(self):
        _, packed, _ = self._body()
        for dt, b in packed.items():
            self._packed[dt].copy_(b)


@pytest.fixture
def modelled(monkeypatch):
    monkeypatch.setattr(T, "make_step", ModelStep)


def _states(t):
    t._materialize_groups()
    return [flatten(v.state)[1] for v in t.active]


def _same_states(a, b):
    for la, lb in zip(_states(a), _states(b)):
        assert all(torch.equal(x, y) for x, y in zip(la, lb))


def test_captured_fused_step_matches_per_voice(modelled):
    ref = _session_tracker(fuse=False)
    t = _session_tracker(fuse=True)
    for _ in range(10):
        np.testing.assert_array_equal(t.render_block()[0],
                                      ref.render_block()[0])
    # The finite voice retires after block 5: a lone group is one member,
    # which fuses only with windows.
    assert t.captures_finished == 1 and t.replays == 4
    # A late voice of the retired one's structure regroups the set (the
    # group's rows were the step's buffers) back into the cached key: the
    # step replays over the new group and voice, with no new capture.
    for tr in (t, ref):
        tr.play(P(4), build_top_level_waveform(fin_const(0.75, 2.0), 0.0))
    for _ in range(6):
        np.testing.assert_array_equal(t.render_block()[0],
                                      ref.render_block()[0])
    assert t.captures_finished == 1 and t.replays >= 8
    assert t._bound is not None
    _same_states(t, ref)


def test_captured_step_replays_for_a_swapped_same_key_set(modelled):
    """Other voices of the same structures: the cached step replays over
    their params and states (copied in), with no new capture."""
    ref = _session_tracker(fuse=False)
    t = _session_tracker(fuse=True)
    for _ in range(6):
        t.render_block()
        ref.render_block()
    started, replays = t.captures_started, t.replays
    for tr in (t, ref):
        tr.stop_all()
        tr.play(P(5), sine(4.0))
        tr.play(P(6), build_top_level_waveform(fin_const(0.5, 0.9), 0.0))
        tr.play(P(7), sine(6.0))
    for _ in range(6):
        np.testing.assert_array_equal(t.render_block()[0],
                                      ref.render_block()[0])
    assert t.captures_started == started and t.replays - replays >= 4
    _same_states(t, ref)


def test_captured_windows_interrupt_and_prefetch(modelled):
    """Windows, their prefetch and an interrupting play on the captured
    path, against the per-block path."""
    ref = _window_tracker(fuse=False, lookahead=1)
    t = _window_tracker(fuse=True)
    got, want = [], []
    for i in range(20):
        if i == 10:
            for tr in (t, ref):
                tr.play(P(3), sine(11.0))
        got.append(host(t.render_block()[0]))
        want.append(host(ref.render_block()[0]))
        _drain_prefetch(t)
    np.testing.assert_allclose(np.concatenate(got), np.concatenate(want),
                               atol=1e-6)
    assert t.window_opens >= 3 and t.prefetch_hits >= 1
    t.close()


# -- no host reads in a step --------------------------------------------------


# Ops that read a tensor on the host, and indexing ops that do when an
# index is a boolean mask (its count of true lanes sizes the result).
_HOST_READS = (torch.ops.aten._local_scalar_dense.default,
               torch.ops.aten.nonzero.default,
               torch.ops.aten.is_nonzero.default,
               torch.ops.aten.masked_select.default)
_INDEXING = (torch.ops.aten.index.Tensor, torch.ops.aten.index_put.default,
             torch.ops.aten.index_put_.default)


class _NoHostReads:
    """A dispatch mode that raises on any op that reads a tensor on the
    host (what a CUDA graph capture cannot record)."""

    def __enter__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                if func in _HOST_READS or (
                        func in _INDEXING and any(
                            getattr(i, "dtype", None) == torch.bool
                            for i in args[1] if i is not None)):
                    raise AssertionError(f"host read: {func}")
                return func(*args, **(kwargs or {}))
        self._mode = Mode()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)


STEP_TEXTS = [
    "harmonica(1.0, 440)",
    "sine(2*pi*(220 + 30*$(5)), 0) * 0.5 | fin(time - 1)",
    "reset(triangle(110), time * -110) * 2 | lpf(0.7, 2000) | fin(time - 1)",
    "sawtooth(110) | lpf(0.7, 800)",
    "<[" + ", ".join(["0 | fin(time - 0.01) | seq(time - 0.01)"] * 4
                     + [f"$({200 + 50 * i}) | fin(time - 0.02) "
                        "| seq(time - 0.02)" for i in range(4)]) + "]>",
    "{[" + ", ".join(f"$({600 + 60 * i}) + $({1200 + 35 * i})"
                     for i in range(6)) + "]} | fin(time - 1)",
]


@pytest.mark.parametrize("sync_interval", [1, 4])
def test_session_steps_read_nothing_on_the_host(sync_interval, monkeypatch):
    """The fused step and the window step, over lone voices and groups
    of the std instruments and a score, read no tensor on the host: a
    graph capture could not record such a read (an index by a 0-dim
    tensor is one)."""
    sr = 8000
    t = Tracker(sr, 128, precision="fast", device=CPU,
                sync_interval=sync_interval)
    t.fuse_blocking = True
    for i, text in enumerate(STEP_TEXTS):
        t.play(P(i), ttg._std(text, sr))
    t.play(P(9), ttg._std(STEP_TEXTS[1].replace("220", "330"), sr))
    t.render_block()
    t.render_block()
    steps = []
    build = T.make_step
    # As under a capture: the timeline's plan is gathered in the render.
    monkeypatch.setattr(tl, "_bind_per_render", lambda P: True)

    def checked(fn, *a):
        def run(*args):
            with _NoHostReads():
                return fn(*args)
        steps.append(fn)
        return build(run, *a)
    monkeypatch.setattr(T, "make_step", checked)
    for _ in range(6):
        t.render_block()
    assert len(steps) == (1 if sync_interval == 1 else 2)
    assert t._groups and t._singles
    t.close()


def test_threads_stress_captured_windows(monkeypatch):
    """More serving threads than cores, each with its own tracker on the
    modelled captured path (capture, prefetch and fetch workers of its
    own, one capture at a time in the process), under a short switch
    interval: every stream equals the per-block path, and each tracker's
    adoptions add up (every window after the first adopts or misses its
    prefetch exactly once)."""
    import sys
    import threading
    monkeypatch.setattr(T, "make_step", ModelStep)
    ref = _window_tracker(fuse=False, lookahead=1)
    want = np.concatenate([host(ref.render_block()[0]) for _ in range(20)])
    results, errors = {}, []

    def run(i):
        try:
            t = _window_tracker(fuse=True)
            t.fuse_blocking = i % 2 == 0
            got = [host(t.render_block()[0]) for _ in range(20)]
            t.close()
            results[i] = (np.concatenate(got), t)
        except Exception as e:  # reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(12)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads) and not errors, errors
    assert len(results) == 12
    for got, t in results.values():
        np.testing.assert_allclose(got, want, atol=1e-6)
        if t.window_opens:
            assert t.prefetch_hits + t.prefetch_misses == \
                t.window_opens - 1

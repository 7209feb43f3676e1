"""Voice groups in the port on the CPU: the scans' voices x lanes forms,
CompiledVoice.batched_render_fn and the tracker's VoiceGroup.

  * The rows forms' plain versions against jax.vmap of the Pallas
    kernels in interpret mode (the group's batching of a pallas_call),
    and torch.func.vmap of each single entry point against its rows form.
  * The CUDA kernels' tile order (tests/test_torch_scan_ops.py's models)
    over rows: tiles and look-backs never leave their row, so every row
    has the bits of a single call on it, in any order of finishing.
  * The port's batched render against tuun_tpu's batched_render_fn (jit
    off; its scans take their plain fallbacks on the CPU), fast and exact,
    for FM, filtered, generic-Reset and timeline groups.
  * The port's Tracker against tuun_tpu.tracker.Tracker (jit on, fused
    step off, as tests/test_tracker.py's group tests run it) on a
    polyphonic score, and twins of tests/test_tracker.py's group and
    repeat tests (each keeps its JAX name).
  * The group path with warnings escalated to errors: torch.func.vmap
    warns when an op has no batching rule and it loops over the voices
    instead, so the whole group path runs with no such fallback.

Every render asks for the CPU: the port's entry points default to the
card.
"""

import warnings
from functools import partial
from importlib import import_module
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tuun_tpu
import tuun_tpu.engine.pallas_ops as po
import tuun_tpu_torch
import test_torch_scan_ops as tso
from tuun_tpu.engine import CompiledVoice as JaxVoice
from tuun_tpu.engine import EngineConfig as JaxConfig
from tuun_tpu.tracker import Tracker as JaxTracker
from tuun_tpu_torch import ir, oracle
from tuun_tpu_torch.engine import CompiledVoice, EngineConfig, scan_ops
from tuun_tpu_torch.engine.graph import stack_params, stack_tree, tree_index
from tuun_tpu_torch.ids import WaveformId
from tuun_tpu_torch.player import build_top_level_waveform
from tuun_tpu_torch.tracker import Tracker

torch.set_num_threads(1)
CPU = "cpu"


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _std(text, sr, pkg=tuun_tpu_torch):
    """`text` evaluated and optimized by `pkg`'s own front end."""
    ev = import_module(f"{pkg.__name__}.evaluator")
    stdlib = Path(pkg.__file__).resolve().parent / "stdlib" / "v0"
    out = ev.Evaluator(sr, 60, stdlib).evaluate_source(text, opens=("std",))
    if isinstance(out, import_module(f"{pkg.__name__}.expr").ESeq):
        out = out.waveform
    return import_module(f"{pkg.__name__}.optimizer").optimize(out.waveform)


# ---------------------------------------------------------------------------
# The voices x lanes scans
# ---------------------------------------------------------------------------


# Tolerances as tests/test_torch_scan_ops.py's single forms: the plain
# sum (sequential) and the Pallas kernel (Hillis-Steele) round in other
# orders, within 1e-5 relative / 1e-4 absolute here; the max is exact.
@pytest.mark.parametrize("B,n", [(3, po.LANE), (4, 4 * po.LANE)])
def test_prefix_rows_match_vmapped_pallas(B, n):
    rng = np.random.default_rng(B * n)
    x = rng.standard_normal((B, n)).astype(np.float32)
    ps = np.asarray(jax.vmap(partial(po.prefix_sum_f32, interpret=True))(
        jnp.asarray(x)))
    pm = np.asarray(jax.vmap(partial(po.prefix_max_f32, interpret=True))(
        jnp.asarray(x)))
    got_s = scan_ops.prefix_sum_rows_f32(t(x))
    got_m = scan_ops.prefix_max_rows_f32(t(x))
    np.testing.assert_allclose(got_s.numpy(), ps, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got_s.numpy(),
                               np.cumsum(x.astype(np.float64), -1),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(got_m.numpy(), pm)
    # vmap of a single entry point takes the rows form: the same bits.
    assert torch.equal(torch.func.vmap(scan_ops.prefix_sum_f32)(t(x)), got_s)
    assert torch.equal(torch.func.vmap(scan_ops.prefix_max_f32)(t(x)), got_m)
    for r in range(B):
        assert torch.equal(got_s[r], scan_ops.prefix_sum_f32(t(x[r])))


# Tolerance 1e-4 (rtol and atol), as test_torch_scan_ops.py's single
# form: float32 compositions of contracting random maps against the
# float64 recurrence and the Pallas kernel.
@pytest.mark.parametrize("B,n,J", [(3, po.LANE, 1), (2, 2 * po.LANE, 2),
                                   (3, 2 * po.LANE, 3)])
def test_affine_rows_match_vmapped_pallas(B, n, J):
    ins = [tso._affine_inputs(n, J, 10 * r + J) for r in range(B)]
    a, ff, live, h0 = (np.stack(x) for x in zip(*ins))
    ph, phist = jax.vmap(partial(po.affine_scan_f32, interpret=True))(
        jnp.asarray(a), jnp.asarray(ff), jnp.asarray(live), jnp.asarray(h0))
    y, hist = scan_ops.affine_scan_rows_f32(t(a), t(ff), t(live), t(h0))
    np.testing.assert_allclose(y.numpy(), tso._masked_y(ph, live), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(hist.numpy(), np.asarray(phist), rtol=1e-4,
                               atol=1e-4)
    for r in range(B):
        ref, h_end = tso._affine_reference(a[r], ff[r], live[r], h0[r])
        np.testing.assert_allclose(y[r].numpy(), tso._masked_y(ref, live[r]),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(hist[r].numpy(), h_end, rtol=1e-4,
                                   atol=1e-4)
    # vmap of the single entry point, an operand shared by every voice
    # (h0 not batched) included, takes the rows form.
    vh, vhist = torch.func.vmap(scan_ops.affine_scan_f32,
                                in_dims=(0, 0, 0, None))(
        t(a), t(ff), t(live), t(h0[0]))
    sh, shist = scan_ops.affine_scan_rows_f32(
        t(a), t(ff), t(live), t(np.broadcast_to(h0[0], h0.shape)))
    assert torch.equal(vh, sh) and torch.equal(vhist, shist)


def test_rows_wrappers_reject_bad_inputs():
    x = torch.ones(3, 10)
    with pytest.raises(ValueError, match="2-D"):
        scan_ops.prefix_sum_rows_f32(torch.ones(10))
    with pytest.raises(ValueError, match="float32"):
        scan_ops.prefix_max_rows_f32(x.double())
    with pytest.raises(ValueError, match="no rows"):
        scan_ops.prefix_sum_rows_f32(torch.ones(0, 10))
    a, ff = torch.ones(3, 10, 2), torch.ones(3, 10)
    live, h0 = torch.ones(3, 10, dtype=torch.bool), torch.ones(3, 2)
    scan_ops.affine_scan_rows_f32(a, ff, live, h0)
    with pytest.raises(ValueError, match="h0"):
        scan_ops.affine_scan_rows_f32(a, ff, live, torch.ones(2))
    with pytest.raises(ValueError, match="live"):
        scan_ops.affine_scan_rows_f32(a, ff, live[:2], h0)
    with pytest.raises(ValueError, match="a_rows"):
        scan_ops.affine_scan_rows_f32(a[0], ff, live, h0)


# The prefix kernel's tile map over rows (csrc/scan.cu scan_single_pass):
# global tile gt is tile t = gt % nbr of row r = gt // nbr, its lanes are
# row r's [t * tile, (t + 1) * tile), its status word slot r * nbr + t,
# and its look-back reads the slots of anchor a (the last multiple of the
# thread count below t) up to t - 1, in its own row.


def _prefix_rows_map(rows, n):
    threads, items = tso._scan_geometry()
    tile = threads * items
    nbr = -(-n // tile)
    out = []
    for gt in range(rows * nbr):
        r, t_ = divmod(gt, nbr)
        a = (t_ - 1) // threads * threads if t_ else 0
        reads = range(r * nbr + a, r * nbr + t_) if nbr > 1 else range(0)
        out.append((r, t_, (r * n + t_ * tile, r * n + min(n, (t_ + 1)
                                                           * tile)),
                    r * nbr + t_, reads))
    return out, nbr


@pytest.mark.parametrize("rows,n", [(5, 1), (3, "tile"), (3, "tile+1"),
                                    (2, "span+1"), (4, 3 * (1 << 12) + 37)])
def test_prefix_rows_tiles_stay_in_their_row(rows, n):
    n = tso._model_n(n)
    tiles, nbr = _prefix_rows_map(rows, n)
    lanes = np.zeros(rows * n, np.int64)
    slots = set()
    for r, t_, (lo, hi), slot, reads in tiles:
        assert r * n <= lo < hi <= (r + 1) * n
        lanes[lo:hi] += 1
        slots.add(slot)
        assert all(r * nbr <= s < r * nbr + t_ for s in reads)
        # The words a tile folds are those a one-row call's tile t folds.
        assert [s - r * nbr for s in reads] == list(_prefix_rows_map(
            1, n)[0][t_][4])
    assert (lanes == 1).all() and slots == set(range(rows * nbr))
    # Each row through the kernel's order of operations is its own scan.
    rng = np.random.default_rng(rows)
    x = t(rng.standard_normal((rows, n)).astype(np.float32))
    for r in range(rows):
        got = tso._model_scan(x[r], tso._sum_op, 0.0)
        assert torch.equal(got, tso._model_scan(x[r].clone(), tso._sum_op,
                                                0.0))


def _rows_inputs(B, n, J, seed):
    ins = [tso._stable_inputs(n, J, seed + r) for r in range(B)]
    return tuple(np.stack(x) for x in zip(*ins))


@pytest.mark.parametrize("J", [2, 3])
def test_affine_rows_model_row_bits_equal_single_calls(J):
    # Three rows of a length with three levels of records and a ragged
    # tail, in the small geometry, finishing in order, in reverse and in
    # two random orders, in float32: every row has the bits of a one-row
    # call, and one scratch serves all rows and is left ready.
    geom = tso.SMALL_GEOMETRY
    S, G, W, F = geom
    n = F * F * S * G * W + 3 * S * G * W + 37
    a, ff, live, h0 = _rows_inputs(3, n, J, 40)
    rng = np.random.default_rng(2)
    orders = [None, max, lambda ts: ts[rng.integers(len(ts))],
              lambda ts: ts[-1 - rng.integers(min(len(ts), 3))]]
    singles = [tso._affine_model(a[r], ff[r], live[r], h0[r], geom,
                                 dtype=np.float32)[:2] for r in range(3)]
    for order in orders:
        y, hist, scratch = tso._affine_model(a, ff, live, h0, geom, order,
                                             np.float32)
        assert scratch["counter"] == 0 and scratch["epoch"] == 1
        for r in range(3):
            assert y[r].tobytes() == singles[r][0].tobytes()
            assert hist[r].tobytes() == singles[r][1].tobytes()


@pytest.mark.parametrize("J,n", [(1, 1), (2, 1024), (3, 1025), (5, 4100),
                                 (8, 3 * 1024 + 37)])
def test_affine_rows_model_matches_reference(J, n):
    # The kernel's geometry over 3 rows, float64, against the batched
    # plain version (rounding only: 1e-9 of the scale).
    a, ff, live, h0 = _rows_inputs(3, n, J, 7 * J + n)
    y, hist, scratch = tso._affine_model(a, ff, live, h0,
                                         tso._kernel_geometry(n))
    ry, rh = scan_ops.affine_y_ref(t(a).double(), t(ff).double(), t(live),
                                   t(h0).double())
    scale = max(1.0, float(ry.abs().max()))
    np.testing.assert_allclose(y, ry.numpy(), rtol=0, atol=1e-9 * scale)
    np.testing.assert_allclose(hist, rh.numpy(), rtol=0, atol=1e-9 * scale)
    assert scratch["counter"] == 0


def test_rows_scratch_holds_every_row_tile(monkeypatch):
    # The prefix scratch is sized once; a rows call whose tiles would not
    # fit in it raises before any launch.  The affine scratch grows to
    # rows * look-back records per row.
    monkeypatch.setattr(scan_ops, "_scan_tile", 4096)
    monkeypatch.setattr(scan_ops, "_scratch_words", 2 + 64)

    class Lib:
        @staticmethod
        def tuun_prefix_sum_rows_f32(*args):
            raise AssertionError("launched")

    x = torch.empty(17, 4 * 4096)  # 68 tiles
    monkeypatch.setattr(scan_ops, "prefix_scratch",
                        lambda dev, stream: torch.zeros(1))
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda dev: 0, raising=False)
    monkeypatch.setattr(torch.Tensor, "get_device", lambda self: 0)
    with pytest.raises(ValueError, match="exceed"):
        scan_ops._prefix_launch(Lib.tuun_prefix_sum_rows_f32,
                                "prefix_sum_rows_f32", x)
    monkeypatch.setattr(scan_ops, "_affine_scratch", {})
    monkeypatch.setattr(scan_ops, "_affine_retired", [])
    made = []

    def alloc(device, records):
        made.append(records)
        return torch.zeros(1, dtype=torch.int32)
    first = scan_ops.affine_capacity(1, 1 << 20)
    need = scan_ops.affine_capacity(256, 1 << 16)  # 256 voices x 2^16
    assert need == 256 * scan_ops.affine_slots(1 << 16, 64)
    scan_ops.affine_scratch(0, 5, need, alloc)
    assert made == [max(first, need)]


# ---------------------------------------------------------------------------
# batched_render_fn against tuun_tpu's
# ---------------------------------------------------------------------------


SR = 8000
# name -> (template over a pitch f, pitches): each group's voices share a
# structure and literal cutoffs; only their consts differ.
GROUP_CASES = {
    "fm": ("sine(2*pi*({f} + 30*$(5)), 0) * 0.5 | fin(time - 0.2)",
           (220, 247, 277)),
    "filtered": ("sawtooth({f}) | lpf(0.7, 2000) | fin(time - 0.2)",
                 (110, 165, 220)),
    # The outer reset's trigger keys the structure (its consts too), so
    # the voices vary the restarted ramp's slope.
    "generic_reset": ("reset(triangle(110), time * -{f}) * 2 "
                      "| lpf(0.7, 2000) | fin(time - 0.2)", (110, 130, 150)),
    "timeline": ("<[" + ", ".join(f"$({{f}} + {40 * i}) | fin(time - 0.03) "
                                  f"| seq(time - 0.03)" for i in range(6))
                 + "]>", (200, 300, 400)),
}
GROUP_BLOCK = 512
GROUP_STARTS = (0, 130, 333)


def _jax_group(name, precision, blocks):
    template, pitches = GROUP_CASES[name]
    ws = [_std(template.format(f=f), SR, tuun_tpu) for f in pitches]
    voice = JaxVoice(ws[0], JaxConfig(SR, precision, 0, jit=False))
    params = [voice.params_for(w, seed=i + 1) for i, w in enumerate(ws)]
    lits = voice.lits_for(params[0]) if voice._has_timeline else None
    bp = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *params)
    bs = jax.vmap(voice._init_impl)(bp)
    fn = voice.batched_render_fn(GROUP_BLOCK, fast=False, lits=lits)
    out = []
    for b in range(blocks):
        starts = jnp.asarray(GROUP_STARTS if b == 0 else (0, 0, 0),
                             jnp.int32)
        y, v, bs, _ = fn(bp, bs, starts, jnp.int32(GROUP_BLOCK))
        out.append((np.asarray(y, np.float64), np.asarray(v)))
    return out


def _port_group(name, precision, blocks):
    template, pitches = GROUP_CASES[name]
    ws = [_std(template.format(f=f), SR) for f in pitches]
    voice = CompiledVoice(ws[0], EngineConfig(SR, precision, CPU))
    params = [voice.params_for(w, seed=i + 1) for i, w in enumerate(ws)]
    lits = voice.lits_for(params[0]) if voice._has_timeline else None
    assert all(voice.lits_for(P) == voice.lits_for(params[0])
               for P in params)
    bp = stack_params(params)
    bs = voice.batched_init(bp)
    fn = voice.batched_render_fn(GROUP_BLOCK, fast=False, lits=lits)
    e = torch.tensor(GROUP_BLOCK)
    out = []
    for b in range(blocks):
        starts = torch.tensor(GROUP_STARTS if b == 0 else (0, 0, 0))
        y, v, bs, _ = fn(bp, bs, starts, e)
        out.append((y.double().numpy(), v.numpy()))
    return out, voice, params, lits


# Port against JAX, per block: fast mode within 3 x 1.1e-6 (three voices,
# each within test_torch_fastpath.py's 1.1e-6 of JAX: only the two
# libraries' float32 sin differs), except FM, whose f32 phase is a
# prefix sum that the two sum in another order (16 eps of the running
# phase, ~4e-5 rad at 512 lanes, times amplitude 0.5, three voices:
# 6e-5); exact mode (float64 phase, sequential feedback) within 1e-6:
# its voices come out as float32 (an ulp apart at most) and the mix sums
# them in float32, at |y| up to 3 (2.4e-7 an ulp).
JAX_GROUP_TOL = {("fast", "fm"): 6e-5, "fast": 3.3e-6, "exact": 1e-6}


@pytest.mark.parametrize("precision", ["fast", "exact"])
@pytest.mark.parametrize("name", list(GROUP_CASES))
def test_batched_render_matches_jax(name, precision):
    blocks = 3
    want = _jax_group(name, precision, blocks)
    got, _, _, _ = _port_group(name, precision, blocks)
    tol = JAX_GROUP_TOL.get((precision, name), JAX_GROUP_TOL[precision])
    for (gy, gv), (wy, wv) in zip(got, want):
        np.testing.assert_array_equal(gv, wv)
        np.testing.assert_allclose(gy, wy, rtol=0, atol=tol)


@pytest.mark.parametrize("name", list(GROUP_CASES))
def test_batched_render_equals_single_voices(name):
    """The group's mix against each voice's own render_block, summed, and
    its states row by row: the same ops on the same values, so within
    the two summation orders of three terms (2 * 2 eps * sum|y|) and
    the states bit for bit, except the FM accumulator, which sums its
    phase increments in another order (a few ulp of the block's phase
    advance; amplitude 0.5)."""
    got, voice, params, lits = _port_group(name, "fast", 3)
    states = [voice.init(P) for P in params]
    eps = float(np.finfo(np.float32).eps)
    for b, (gy, gv) in enumerate(got):
        ref = np.zeros(GROUP_BLOCK)
        mag = np.zeros(GROUP_BLOCK)
        for i, P in enumerate(params):
            s = GROUP_STARTS[i] if b == 0 else 0
            y, v, states[i], _ = voice.render_block(
                P, states[i], GROUP_BLOCK, s, GROUP_BLOCK, fast=False,
                lits=lits)
            assert int(v) == gv[i]
            ref += y.double().numpy()
            mag += np.abs(y.double().numpy())
        extra = 2e-5 if name == "fm" else 0.0
        assert np.all(np.abs(gy - ref) <= 4 * eps * mag + extra)


def test_batched_init_and_stacking_round_trip():
    _, voice, params, _ = _port_group("filtered", "fast", 1)
    bp = stack_params(params)
    assert bp.consts.shape == (3, len(params[0].consts))
    assert bp.host is params[0].host
    bs = voice.batched_init(bp)
    for i, P in enumerate(params):
        tso_leaves = _leaves(tree_index(bs, i))
        for x, y in zip(tso_leaves, _leaves(voice.init(P))):
            assert torch.equal(x, y)
    again = stack_tree([tree_index(bs, i) for i in range(3)])
    for x, y in zip(_leaves(again), _leaves(bs)):
        assert torch.equal(x, y)


def _leaves(st):
    if isinstance(st, tuple):
        return [x for s in st for x in _leaves(s)]
    return [st]


# ---------------------------------------------------------------------------
# The tracker
# ---------------------------------------------------------------------------


def _score(pkg, sr):
    """A polyphonic score: (id, waveform, start) of FM notes at four
    pitches (one structure), filtered saws and generic-reset notes at two
    pitches each, starts staggered mid-block, lengths varied."""
    notes = []
    for j in range(8):
        d = 0.05 + 0.02 * (j % 3)
        notes.append((f"fm{j}", _std(
            f"sine(2*pi*({200 + 20 * (j % 4)} + 30*$(5)), 0) * 0.5 "
            f"| fin(time - {d})", sr, pkg), 37 * j))
        notes.append((f"saw{j}", _std(
            f"sawtooth({110 + 55 * (j % 2)}) | lpf(0.7, 2000) "
            f"| fin(time - {d + 0.01})", sr, pkg), 51 * j + 5))
        notes.append((f"rst{j}", _std(
            f"reset(triangle({90 + 30 * (j % 2)}), time * -{100 + 10 * j}) "
            f"* 2 | fin(time - {d})", sr, pkg), 23 * j + 11))
    return notes


def _run(tracker, notes, max_blocks=40):
    for wid, w, start in notes:
        tracker.play(wid, w, start=start)
    out, status = [], []
    for _ in range(max_blocks):
        y, s = tracker.render_block()
        out.append(np.asarray(y, np.float64))
        status.append(s)
        if not tracker.active and not tracker.pending:
            break
    return np.concatenate(out), status


def test_tracker_matches_jax_tracker_on_a_polyphonic_score():
    # Tolerance: per sample, the port against JAX's fast mode (1.1e-6 a
    # voice; FM 2e-5 a voice: its prefix-summed phase, as above) over
    # the at most 24 voices sounding at once.
    sr, block = SR, 128
    jt = JaxTracker(sr, block, precision="fast", jit=True)
    jt.fuse = False  # per-voice and group dispatches, as the port's
    want, jst = _run(jt, _score(tuun_tpu, sr))
    pt = Tracker(sr, block, precision="fast", device=CPU)
    pt.fuse = False  # the per-call path, as JAX's above
    got, pst = _run(pt, _score(tuun_tpu_torch, sr))
    assert len(got) == len(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=8 * 2e-5)
    assert [s.dispatches for s in pst] == [s.dispatches for s in jst]
    assert [s.voices for s in pst] == [s.voices for s in jst]
    assert max(s.dispatches for s in pst) < max(s.voices for s in pst)


def test_tracker_groups_render_once_and_read_once(monkeypatch):
    """Same-structure voices render as one group call per block, with one
    host copy of the group's valid ends per call, and the mix equals a
    tracker whose voices all render on their own."""
    from tuun_tpu_torch import tracker as T
    calls, reads = [], []
    render, resolve = T.VoiceGroup.render, T.VoiceGroup.resolve

    def spy_render(group, *a, **k):
        calls.append(len(group.voices))
        return render(group, *a, **k)

    def spy_resolve(group, *a, **k):
        reads.append(len(group.voices))
        return resolve(group, *a, **k)
    monkeypatch.setattr(T.VoiceGroup, "render", spy_render)
    monkeypatch.setattr(T.VoiceGroup, "resolve", spy_resolve)
    tr = Tracker(SR, 128, precision="fast", device=CPU)
    tr.fuse = False  # the per-call path: one render and one read a group
    got, status = _run(tr, _score(tuun_tpu_torch, SR))
    assert max(calls) >= 3 and calls == reads
    assert sum(s.dispatches for s in status) < sum(s.voices for s in status)

    alone = Tracker(SR, 128, precision="fast", device=CPU)
    alone.fuse = False

    def singles():
        alone._singles, alone._groups = list(alone.active), []
        alone._groups_dirty = False
    monkeypatch.setattr(alone, "_rebuild_groups", singles)
    want, _ = _run(alone, _score(tuun_tpu_torch, SR))
    # Sum of per-voice renders against the groups' on-device sums: the
    # summation orders of at most 24 terms, plus the FM accumulators'
    # reordered increments (2e-5 a voice, as above).
    np.testing.assert_allclose(got, want, rtol=0, atol=8 * 2e-5)


def test_tracker_levels_and_status():
    notes = _score(tuun_tpu_torch, SR)[:6]
    tr = Tracker(SR, 128, precision="fast", device=CPU, levels=True)
    _, status = _run(tr, notes)
    first = status[0]
    assert first.voice_levels and first.tracker_load > 0
    assert set(first.voice_levels) <= {wid for wid, _, _ in notes}
    for rms, peak in first.voice_levels.values():
        assert 0.0 <= rms <= peak
    assert tr.load_metric.latest() is not None
    assert tr.dispatch_metric.latest() is not None
    snap = tr.status_snapshot()
    assert snap.buffer_start == tr.now and snap.voices == len(tr.active)


def test_remove_pending():
    tr = Tracker(100, 16, precision="exact", device=CPU)
    tr.play("a", _fin_const(1.0, 0.08), start=40)
    tr.play("b", _fin_const(2.0, 0.08), start=40)
    tr.remove_pending("a")
    assert [p.id for p in tr.pending] == ["b"]
    out = np.concatenate([tr.render_block()[0] for _ in range(4)])
    np.testing.assert_array_equal(out[40:48], 2.0)


def test_group_captures_slice_each_voice(tmp_path, monkeypatch):
    """A group of capturing voices (one structure, so one stem) slices
    each voice's capture out of the batched render at its own valid span:
    the voice that retires last writes the stem's file, 10 samples of its
    own value, starting at its start (tests/test_tracker.py's
    test_capture_writes_wav, in a group)."""
    from tuun_tpu_torch import tracker as T
    sizes = []
    render = T.VoiceGroup.render

    def spy(group, *a, **k):
        sizes.append(len(group.voices))
        return render(group, *a, **k)
    monkeypatch.setattr(T.VoiceGroup, "render", spy)
    tr = _make_tracker(captured_output_dir=tmp_path)
    tr.captured_date_format = ""
    tr.play("a", ir.Captured("dump", _fin_const(0.25, 0.10)))
    tr.play("b", ir.Captured("dump", _fin_const(0.5, 0.10)), start=4)
    out = tr.run_to_completion()
    assert sizes and max(sizes) == 2
    np.testing.assert_array_equal(out[:4], 0.25)
    np.testing.assert_array_equal(out[4:10], 0.75)
    np.testing.assert_array_equal(out[10:14], 0.5)
    samples, sr = import_module("tuun_tpu_torch.wav").read_wav(
        tmp_path / "dump.wav")
    assert sr == 100
    np.testing.assert_array_equal(samples, np.full(10, 0.5, np.float32))


# -- twins of tests/test_tracker.py ---------------------------------------


def _fin_const(value, seconds):
    return ir.Fin(ir.BinaryPointOp(ir.Operator.SUBTRACT, ir.Time(),
                                   ir.Const(float(seconds))),
                  ir.Const(float(value)))


def _make_tracker(sr=100, block=16, **kw):
    kw.setdefault("precision", "exact")
    return Tracker(sr, block, device=CPU, **kw)


def test_repeat_every():
    t_ = _make_tracker()
    t_.play("a", _fin_const(1.0, 0.08), repeat_every=16)  # 8 on, 8 off
    chunks = [t_.render_block()[0] for _ in range(3)]
    for c in chunks:
        np.testing.assert_array_equal(c[:8], 1.0)
        np.testing.assert_array_equal(c[8:], 0.0)
    t_.stop_all()


def test_vmapped_voice_group_mix():
    """Same-structure voices batch into one vmapped render; the mix must
    equal the sum of individually rendered voices."""
    sr, block = 100, 16
    freqs = [5, 7, 11, 13]
    waves = [_std(f"${f} | fin(time - 1)", sr) for f in freqs]
    t_ = _make_tracker(sr=sr, block=block)
    starts = [0, 0, 8, 12]  # all inside the first block
    for i, (w, st) in enumerate(zip(waves, starts)):
        t_.play(f"v{i}", w, start=st)
    first = t_.render_block()[0]
    # After the first block all four voices share one compiled structure.
    assert len(t_._groups) == 1 and len(t_._groups[0].voices) == 4
    mix = np.concatenate([first] + [t_.render_block()[0]
                                    for _ in range(8)])[:120]

    expected = np.zeros(120, np.float32)
    for w, st in zip(waves, starts):
        y = oracle.render(w, 120, sr)
        expected[st:st + len(y)] += y[:max(0, 120 - st)]
    np.testing.assert_allclose(mix, expected, atol=1e-4)
    assert not t_.active  # all finished and retired through the group path


def test_group_survives_unrelated_retirement_without_rewind():
    """Retiring an unrelated voice regroups the survivors; grouped
    voices must NOT rewind to their last materialization point (their
    progress lives in the group's batched state)."""
    t_ = Tracker(100, 16, precision="fast", device=CPU)
    t_.play(WaveformId.program(0), build_top_level_waveform(
        ir.Sine(ir.Const(3.0), ir.Const(0.0)), 0.0))
    t_.play(WaveformId.program(2), build_top_level_waveform(
        ir.Sine(ir.Const(7.0), ir.Const(0.0)), 0.0))
    t_.play(WaveformId.program(1), build_top_level_waveform(
        ir.Fin(ir.BinaryPointOp(ir.Operator.SUBTRACT, ir.Time(),
                                ir.Const(1.2)), ir.Const(0.25)), 0.0))
    mix = np.concatenate([np.asarray(t_.render_block()[0])
                          for _ in range(24)])
    n = np.arange(len(mix))
    expect = np.sin(3.0 * n / 100) + np.sin(7.0 * n / 100)
    expect[:121] += 0.25
    np.testing.assert_allclose(mix, expect, atol=1e-5)


def test_repeat_every_zero_plays_once_no_hang():
    """A non-positive repetition period must not spin the catch-up loop
    forever (regression: repeat_every=0 hung render_block)."""
    t_ = _make_tracker()
    t_.play("a", ir.Fin(ir.BinaryPointOp(
        ir.Operator.SUBTRACT, ir.Time(), ir.Const(0.1)),
        ir.Const(1.0)), repeat_every=0)
    out = [t_.render_block()[0] for _ in range(6)]
    # Played exactly once: 10 samples of 1.0, then silence, no pending.
    y = np.concatenate(out)
    assert np.count_nonzero(y) == 10
    assert not t_.pending


def test_repeat_every_skips_missed_repetitions():
    # A repeating voice first promoted late reschedules past the block,
    # not once per missed period (tuun_tpu/tracker.py:1513-1520).
    t_ = _make_tracker()
    t_.now = 64
    t_.play("a", _fin_const(1.0, 0.04), start=3, repeat_every=10)
    t_.render_block()
    assert [p.start for p in t_.pending] == [73]


# ---------------------------------------------------------------------------
# No vmap fallback on the group path
# ---------------------------------------------------------------------------


def test_vmap_fallback_is_an_error_under_the_filter():
    # The mechanism the next test relies on: an op without a batching
    # rule (torch.take, which _value_at no longer uses) warns, and the
    # filter turns the warning into an error.
    x = torch.ones(3, 8)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with pytest.raises(Exception, match="performance drop"):
            torch.func.vmap(lambda a: torch.take(a, torch.tensor(0)))(x)


def test_group_path_runs_without_vmap_fallback():
    """Every group structure of the score above, a timeline group and a
    harmonica group (analytic Resets, a stateful inner) render through
    the tracker with every warning an error."""
    notes = _score(tuun_tpu_torch, SR)
    template = GROUP_CASES["timeline"][0]
    notes += [(f"tl{i}", _std(template.format(f=f), SR), 17 * i)
              for i, f in enumerate((200, 300, 400))]
    notes += [(f"h{i}", _std(f"harmonica({0.05 + 0.01 * i}, 440)", SR),
               29 * i) for i in range(3)]
    tr = Tracker(SR, 128, precision="fast", device=CPU, levels=True)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        out, status = _run(tr, notes)
    assert np.isfinite(out).all()
    assert max(s.voices - s.dispatches for s in status) >= 6

"""The port's mesh paths on the CPU: tuun_tpu_torch.parallel, the meshed
VoiceGroup and Tracker(mesh=), and graft_entry.

  * Twins of tests/test_parallel.py's 11 tests (each keeps its JAX name):
    the port on default_mesh(8, device="cpu"), eight positions on the one
    CPU, against tuun_tpu.parallel and tuun_tpu's Tracker(mesh=) on
    conftest's 8 virtual CPU devices, with the same waveforms, seeds and
    block sizes, each at the reference's own comparison: atol 1e-5 or
    1e-6 where it uses allclose, bit equality where it uses array_equal.
  * The port meshed against the port meshless, on (8, 1), (4, 2) and
    (1, 1) meshes: 5 voices padded to 8, shared and divergent timeline
    schedules, deferred sync, levels, a Modify carrying state (stateful
    and reloc_fast), and a group of FM, lpf and generic-Reset voices
    whose rows scans run under the mesh.  A meshed mix adds each voice
    shard's rows, then the shards in order; a meshless group sums all its
    rows at once: with more than one voice a shard the two may differ by
    that summation order, and are held within 2 float32 ulp of each
    block's peak (ORDER_ULPS).
  * The device rules: the mesh entry points default to the card and
    raise without one; a mesh of another device type than the tracker's
    raises.
"""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import test_torch_groups as tg
import tuun_tpu
import tuun_tpu_torch
from tuun_tpu import engine as jax_engine
from tuun_tpu.parallel import default_mesh as jax_mesh
from tuun_tpu.parallel import render_voices_meshed as jax_meshed
from tuun_tpu.tracker import Tracker as JaxTracker
from tuun_tpu.tracker import _CompileCache as JaxCache
from tuun_tpu_torch import graft_entry, ir
from tuun_tpu_torch.engine import CompiledVoice, EngineConfig, render
from tuun_tpu_torch.engine import scan_ops
from tuun_tpu_torch.engine.graph import stack_params
from tuun_tpu_torch.parallel import (Mesh, VoiceShards,
                                     _render_reloc_lane_sharded, default_mesh,
                                     render_voices_meshed)
from tuun_tpu_torch.tracker import Tracker

torch.set_num_threads(1)
CPU = "cpu"
REPO = Path(__file__).resolve().parent.parent
# A meshed mix against the meshless one: 2 float32 ulp of each block's
# peak (the module docstring).
ORDER_ULPS = 2
# The meshes the port is checked on against itself, as (voice, time).
SHAPES = [(8, 1), (4, 2), (1, 1)]

needs_devices = pytest.mark.skipif(
    jax.device_count() < 8, reason="needs 8 (virtual) devices")


def mesh_of(shape):
    v, t = shape
    return Mesh([[CPU] * t for _ in range(v)])


# -- the waveforms of tests/test_parallel.py, built from either package's ir


def note(irm, freq):
    return irm.Fin(
        irm.BinaryPointOp(irm.Operator.SUBTRACT, irm.Time(), irm.Const(2.0)),
        irm.Sine(irm.Const(freq), irm.Const(0.0)))


def reloc_note(irm, freq):
    return irm.BinaryPointOp(
        irm.Operator.MULTIPLY, note(irm, freq),
        irm.Fin(irm.BinaryPointOp(irm.Operator.SUBTRACT, irm.Time(),
                                  irm.Const(2.0)), irm.Const(0.5)))


def marked_note(irm, freq, mark="amp"):
    return irm.BinaryPointOp(
        irm.Operator.MULTIPLY, irm.Sine(irm.Const(freq), irm.Const(0.0)),
        irm.Marked(mark, irm.Const(1.0)))


def long_note(irm, freq):
    return irm.Fin(
        irm.BinaryPointOp(irm.Operator.SUBTRACT, irm.Time(), irm.Const(60.0)),
        irm.Sine(irm.Const(freq), irm.Const(0.0)))


def chain(pkg, values=("0.5",) * 8):
    segs = ", ".join(f"{v} | fin(time - 1) | seq(time - 1)" for v in values)
    return tg._std("<[" + segs + "]>", 8, pkg)


def port_sum(voices, n, sr, block=16):
    """The voices' own renders (seeds 0..) summed in order in float32,
    each from sample 0, to the longest's length."""
    outs = [render(w, n, sr, precision="fast", seed=i, block=block,
                   device=CPU) for i, w in enumerate(voices)]
    mix = np.zeros(max(len(o) for o in outs), np.float32)
    for o in outs:
        mix[:len(o)] += o
    return mix


def assert_order_close(got, ref, block):
    """got within ORDER_ULPS float32 ulp of each block's peak of ref."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    for b in range(0, len(ref), block):
        peak = np.float32(np.abs(ref[b:b + block]).max())
        bound = ORDER_ULPS * float(np.spacing(peak))
        err = np.abs(got[b:b + block] - ref[b:b + block]).max()
        assert err <= bound, (b, err, bound)


def port_tracker(mesh=None, **kw):
    return Tracker(8, 16, precision="fast", device=CPU, mesh=mesh, **kw)


# ---------------------------------------------------------------------------
# Twins of tests/test_parallel.py
# ---------------------------------------------------------------------------


@needs_devices
def test_meshed_mix_matches_single_device_sum():
    n, sr = 48, 8
    voices = [note(ir, 0.5 + 0.3 * i) for i in range(5)]  # pad to 8
    mix = render_voices_meshed(voices, n, sr, mesh=default_mesh(8, CPU),
                               block=16, device=CPU)
    ref = port_sum(voices, n, sr)
    assert len(mix) == len(ref)
    np.testing.assert_allclose(mix, ref, atol=1e-5)
    jv = [note(tuun_tpu.ir, 0.5 + 0.3 * i) for i in range(5)]
    want = jax_meshed(jv, n, sr, mesh=jax_mesh(8), block=16)
    np.testing.assert_allclose(mix, want, atol=1e-5)


@needs_devices
def test_graft_entry_points():
    import __graft_entry__ as g
    fn, args = graft_entry.entry(CPU)
    y, v, state, caps = fn(*args)
    assert y.shape == (8192,)
    assert int(v) == 8192
    assert np.isfinite(y.numpy()).all()
    jfn, jargs = g.entry()
    jy, jv, _, _ = jax.jit(jfn)(*jargs)
    # The flagship's lpf: the two engines' fast-mode IIRs compose their
    # feedback maps in other orders (test_torch_fastpath.py's bound for
    # a filtered voice, 1e-5 of scale).
    jy = np.asarray(jy)
    assert int(jv) == int(v)
    np.testing.assert_allclose(y.numpy(), jy, rtol=0,
                               atol=1e-5 * np.abs(jy).max())
    out = graft_entry.dryrun_multichip(8, device=CPU)
    assert out["mesh"] == {"voice": 4, "time": 2} and "lane_diff" in out
    assert out["devices"] == ["cpu"]


@needs_devices
def test_tracker_with_mesh_matches_meshless():
    def song(t, irm):
        for i in range(5):
            t.play(f"v{i}", note(irm, 0.4 + 0.3 * i), start=4 * i)
        return t.run_to_completion(max_seconds=4.0)

    ref = song(port_tracker(), ir)
    got = song(port_tracker(default_mesh(8, CPU)), ir)
    n = min(len(ref), len(got))
    np.testing.assert_allclose(got[:n], ref[:n], atol=1e-5)
    assert np.all(ref[n:] == 0) and np.all(got[n:] == 0)
    want = song(JaxTracker(8, 16, precision="fast", jit=True,
                           mesh=jax_mesh(8)), tuun_tpu.ir)
    m = min(len(want), len(got))
    np.testing.assert_allclose(got[:m], np.asarray(want[:m]), atol=1e-5)


@needs_devices
def test_lane_sharded_render_matches_voice_only():
    n, sr = 48, 8
    voices = [reloc_note(ir, 0.5 + 0.3 * i) for i in range(5)]
    mesh = default_mesh(8, CPU)
    assert mesh.shape["time"] == 2
    lane = render_voices_meshed(voices, n, sr, mesh=mesh, block=16,
                                device=CPU)
    stateful = render_voices_meshed(voices, n, sr, mesh=mesh, block=16,
                                    lane_shard=False, device=CPU)
    ref = port_sum(voices, n, sr)
    np.testing.assert_allclose(lane, stateful, atol=1e-5)
    np.testing.assert_allclose(lane, ref, atol=1e-5)
    jv = [reloc_note(tuun_tpu.ir, 0.5 + 0.3 * i) for i in range(5)]
    want = jax_meshed(jv, n, sr, mesh=jax_mesh(8), block=16)
    np.testing.assert_allclose(lane, want, atol=1e-5)


@needs_devices
def test_lane_sharded_output_is_time_sharded(monkeypatch):
    """Each time shard evaluates block / T lanes, not the whole block."""
    from tuun_tpu_torch import parallel
    mesh = default_mesh(8, CPU)
    w = reloc_note(ir, 0.7)
    voice = CompiledVoice(w, EngineConfig(8, "fast", CPU, timeline=False))
    assert voice.relocatable
    widths = []
    inner = parallel.reloc_block

    def spy(root, P, st, lanes, s, e, lits):
        widths.append(lanes.shape[-1])
        return inner(root, P, st, lanes, s, e, lits)
    monkeypatch.setattr(parallel, "reloc_block", spy)
    out = _render_reloc_lane_sharded(voice, [voice.params()], 16, mesh, 16)
    assert out.shape == (16,)
    assert widths and set(widths) == {16 // mesh.shape["time"]}
    ref = render(w, 16, 8, precision="fast", block=16, device=CPU)
    np.testing.assert_allclose(out, ref, atol=1e-5)
    want = jax_engine.render(reloc_note(tuun_tpu.ir, 0.7), 16, 8,
                             precision="fast", jit=True, block=16)
    np.testing.assert_allclose(out, want, atol=1e-5)


@needs_devices
def test_tracker_mesh_timeline_score_matches_meshless():
    w = chain(tuun_tpu_torch)

    def song(t, wave):
        t.play("score", wave)
        t.play("score2", wave, start=8)
        return t.run_to_completion(max_seconds=12.0)

    ref = song(port_tracker(), w)
    got = song(port_tracker(default_mesh(8, CPU)), w)
    n = min(len(ref), len(got))
    assert n > 0
    np.testing.assert_array_equal(got[:n], ref[:n])
    want = song(JaxTracker(8, 16, precision="fast", jit=True,
                           mesh=jax_mesh(8)), chain(tuun_tpu))
    m = min(len(want), len(got))
    np.testing.assert_array_equal(got[:m], np.asarray(want[:m]))


def _modify_song(t, irm, fast=False):
    if fast:
        t.cfg.reloc_fast = True
    for i in range(3):
        t.play(f"v{i}", marked_note(irm, 0.4 + 0.3 * i))
    out = [np.asarray(t.render_block()[0], np.float32) for _ in range(4)]
    if fast:
        assert any(v.fast for v in t.active), \
            "test premise: voices must be on the relocatable fast path"
    t.modify("v1", "amp", irm.Const(0.5))  # phases must carry
    out += [np.asarray(t.render_block()[0], np.float32) for _ in range(4)]
    t.stop_all()
    return np.concatenate(out)


@needs_devices
def test_tracker_mesh_modify_carries_state():
    ref = _modify_song(port_tracker(), ir)
    got = _modify_song(port_tracker(default_mesh(8, CPU)), ir)
    np.testing.assert_allclose(got, ref, atol=1e-6)
    want = _modify_song(JaxTracker(8, 16, precision="fast", jit=True,
                                   mesh=jax_mesh(8)), tuun_tpu.ir)
    np.testing.assert_allclose(got, want, atol=1e-6)


@needs_devices
def test_tracker_mesh_modify_on_reloc_fast_voice():
    """The state reconstructed on the host for the spliced fast voice
    regroups onto its shard's device."""
    ref = _modify_song(port_tracker(), ir, fast=True)
    got = _modify_song(port_tracker(default_mesh(8, CPU)), ir, fast=True)
    np.testing.assert_allclose(got, ref, atol=1e-6)
    want = _modify_song(JaxTracker(8, 16, precision="fast", jit=True,
                                   mesh=jax_mesh(8),
                                   compile_cache=JaxCache()),
                        tuun_tpu.ir, fast=True)
    np.testing.assert_allclose(got, want, atol=1e-6)


def _levels_song(t, irm):
    for i in range(3):
        t.play(f"v{i}", long_note(irm, 0.4 + 0.3 * i))
    for _ in range(4):
        t.render_block()
    t._sync_voices(drain=True)
    return {v.id: (v.level_rms, v.level_peak) for v in t.active}


@needs_devices
def test_tracker_mesh_levels():
    levels = _levels_song(port_tracker(default_mesh(8, CPU), levels=True),
                          ir)
    assert set(levels) == {"v0", "v1", "v2"}
    for vid, (rms, peak) in levels.items():
        assert 0.0 < rms <= peak <= 1.0, (vid, rms, peak)
    want = _levels_song(JaxTracker(8, 16, precision="fast", jit=True,
                                   mesh=jax_mesh(8), levels=True),
                        tuun_tpu.ir)
    for vid, (rms, peak) in levels.items():
        np.testing.assert_allclose((rms, peak), want[vid], atol=1e-6)


def _lane_song(t, irm, fast):
    t.cfg.reloc_fast = fast
    for i in range(5):
        t.play(f"v{i}", reloc_note(irm, 0.4 + 0.3 * i))
    return t.run_to_completion(max_seconds=4.0)


@needs_devices
def test_tracker_mesh_fast_group_lane_sharded():
    ref = _lane_song(port_tracker(), ir, False)
    mesh = default_mesh(8, CPU)
    assert mesh.shape["time"] == 2
    got = _lane_song(port_tracker(mesh), ir, True)
    n = min(len(ref), len(got))
    assert n >= 16
    np.testing.assert_allclose(got[:n], ref[:n], atol=1e-5)
    want = _lane_song(JaxTracker(8, 16, precision="fast", jit=True,
                                 mesh=jax_mesh(8), compile_cache=JaxCache()),
                      tuun_tpu.ir, True)
    m = min(len(want), len(got))
    np.testing.assert_allclose(got[:m], np.asarray(want[:m]), atol=1e-5)


@needs_devices
def test_render_voices_meshed_timeline_score():
    values = ("0.5", "0.25", "0.75", "0.5", "0.25", "0.75", "0.5", "0.25")
    w = chain(tuun_tpu_torch, values)
    probe = CompiledVoice(w, EngineConfig(8, "fast", CPU))
    assert probe._has_timeline  # the chain is long enough to timeline
    mix = render_voices_meshed([w, w, w], 64, 8, mesh=default_mesh(8, CPU),
                               block=16, device=CPU)
    ref = port_sum([w, w, w], 64, 8)
    np.testing.assert_allclose(mix, ref[:len(mix)], atol=1e-5)
    jw = chain(tuun_tpu, values)
    want = jax_meshed([jw, jw, jw], 64, 8, mesh=jax_mesh(8), block=16)
    np.testing.assert_allclose(mix, want, atol=1e-5)


# ---------------------------------------------------------------------------
# The port meshed against the port meshless
# ---------------------------------------------------------------------------


def _group_mix(voices, n, sr, block, lits=None, timeline=True):
    """The meshless group's mix of `voices` (seeds 0..), block by block:
    batched_render_fn on the stacked params, as a VoiceGroup renders."""
    voice = CompiledVoice(voices[0], EngineConfig(sr, "fast", CPU,
                                                  timeline=timeline))
    params = [voice.params_for(w, seed=i) for i, w in enumerate(voices)]
    bp = stack_params(params)
    bs = voice.batched_init(bp)
    fn = voice.batched_render_fn(block, fast=False, lits=lits)
    starts = torch.zeros(len(voices), dtype=torch.int64)
    out = []
    for _ in range(-(-n // block)):
        y, v, bs, _ = fn(bp, bs, starts, torch.tensor(block))
        out.append(y.numpy()[:int(v.max())])
    return np.concatenate(out)[:n]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_meshed_render_matches_meshless_group(shape):
    """5 voices padded to the voice axis: the stateful path against the
    meshless group, and the lane-sharded path (time axis over 1) against
    the stateful one."""
    voices = [reloc_note(ir, 0.5 + 0.3 * i) for i in range(5)]
    mesh = mesh_of(shape)
    stateful = render_voices_meshed(voices, 48, 8, mesh=mesh, block=16,
                                    lane_shard=False, device=CPU)
    assert_order_close(stateful, _group_mix(voices, 48, 8, 16), 16)
    lane = render_voices_meshed(voices, 48, 8, mesh=mesh, block=16,
                                device=CPU)
    np.testing.assert_allclose(lane, stateful, atol=1e-6)


def test_divergent_schedules_fall_back_to_the_plain_tree():
    """Voices whose timeline schedules differ (other segment lengths)
    render as plain trees: each voice at its own length, as tuun_tpu's."""
    def score(pkg, d):
        segs = ", ".join([f"0.5 | fin(time - {d}) | seq(time - {d})"] * 8)
        return tg._std("<[" + segs + "]>", 8, pkg)
    ws = [score(tuun_tpu_torch, d) for d in (1, 1.5, 2)]
    probe = CompiledVoice(ws[0], EngineConfig(8, "fast", CPU))
    assert probe._has_timeline
    assert len({probe.lits_for(probe.params_for(w)) for w in ws}) > 1
    mix = render_voices_meshed(ws, 160, 8, mesh=default_mesh(8, CPU),
                               block=16, device=CPU)
    assert len(mix) == 128
    np.testing.assert_array_equal(mix, port_sum(ws, 160, 8)[:len(mix)])
    want = jax_meshed([score(tuun_tpu, d) for d in (1, 1.5, 2)], 160, 8,
                      mesh=jax_mesh(8), block=16)
    np.testing.assert_array_equal(mix, want)


def _instrument_song(t):
    notes = tg._score(tuun_tpu_torch, tg.SR)[:12]
    mix, status = tg._run(t, notes, max_blocks=60)
    return mix, status


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_meshed_tracker_matches_meshless(shape, monkeypatch):
    """FM, lpf and generic-Reset voices (test_torch_groups.py's score):
    the meshed tracker's mix, dispatches and retirement against the
    meshless tracker's, with the plain versions of the three rows scans
    running under the mesh."""
    rows = {"prefix_sum": 0, "prefix_max": 0, "affine": 0}

    def counted(kind, fn):
        def wrapped(*a):
            rows[kind] += a[1].dim() == 2 if kind == "affine" \
                else a[0].dim() == 2
            return fn(*a)
        return wrapped
    for kind, name in (("prefix_sum", "prefix_sum_ref"),
                       ("prefix_max", "prefix_max_ref"),
                       ("affine", "affine_scan_ref")):
        monkeypatch.setattr(scan_ops, name,
                            counted(kind, getattr(scan_ops, name)))
    ref, rs = _instrument_song(Tracker(tg.SR, 128, precision="fast",
                                       device=CPU))
    before = dict(rows)
    got, gs = _instrument_song(Tracker(tg.SR, 128, precision="fast",
                                       device=CPU, mesh=mesh_of(shape)))
    assert all(rows[k] > before[k] for k in rows), (before, rows)
    assert_order_close(got, ref, 128)
    assert [s.voices for s in gs] == [s.voices for s in rs]


@pytest.mark.parametrize("shape", [(4, 2), (8, 1)], ids=str)
def test_meshed_tracker_deferred_sync(shape):
    """sync_interval=4 with meshed groups: the blocks come back on the
    device and retirement resolves at sync points, as on the meshless
    tracker's per-call path (meshed groups never fuse, so no lookahead
    window opens; fuse is off on both sides)."""
    notes = tg._score(tuun_tpu_torch, tg.SR)[:9]

    def song(mesh):
        t = Tracker(tg.SR, 128, precision="fast", device=CPU,
                    sync_interval=4, mesh=mesh)
        t.fuse = False
        for wid, w, start in notes:
            t.play(wid, w, start=start)
        out = t.run_to_completion(max_seconds=2.0)
        t.close()
        return out
    ref = song(None)
    got = song(mesh_of(shape))
    assert len(got) == len(ref)
    assert_order_close(got, ref, 128)


@pytest.mark.parametrize("fast", [False, True], ids=["stateful", "fast"])
def test_meshed_levels_match_meshless(fast):
    """Levels on the stateful meshed path reduce each row in its shard;
    on the lane-sharded path the time shards' sums of squares add."""
    def song(mesh):
        t = port_tracker(mesh, levels=True)
        t.cfg.reloc_fast = fast
        for i in range(3):
            t.play(f"v{i}", long_note(ir, 0.4 + 0.3 * i))
        out = [t.render_block() for _ in range(4)]
        t._sync_voices(drain=True)
        return out, {v.id: (v.level_rms, v.level_peak) for v in t.active}
    (ref_blocks, ref), (got_blocks, got) = song(None), song(mesh_of((4, 2)))
    for vid, lv in ref.items():
        np.testing.assert_allclose(got[vid], lv, rtol=1e-6)
    for (_, rs), (_, gs) in zip(ref_blocks, got_blocks):
        assert set(gs.voice_levels) == set(rs.voice_levels)


@pytest.mark.parametrize("fast", [False, True], ids=["stateful", "fast"])
def test_meshed_modify_matches_meshless(fast):
    """A Modify carrying state in a meshed group of 3 on a (4, 2) mesh:
    bit for bit the meshless tracker (one voice a shard)."""
    ref = _modify_song(port_tracker(), ir, fast)
    got = _modify_song(port_tracker(mesh_of((4, 2))), ir, fast)
    np.testing.assert_array_equal(got, ref)


def test_voice_shards_pad_place_and_trim():
    """5 voices on a (4, 2) mesh: 3 padding rows of voice 0 at weight 0,
    2 rows a shard on each time shard, results trimmed to 5."""
    mesh = mesh_of((4, 2))
    voice = CompiledVoice(note(ir, 1.0), EngineConfig(8, "fast", CPU))
    params = [voice.params_for(note(ir, 0.5 + 0.3 * i), seed=i)
              for i in range(5)]
    shards = VoiceShards(voice, params, mesh, CPU)
    assert (shards.pad, shards.per_shard) == (3, 2)
    weights = torch.cat([sh.weights[0] for sh in shards.shards])
    assert weights.tolist() == [1.0] * 5 + [0.0] * 3
    for sh in shards.shards:
        assert len(sh.params) == 2 and sh.params[0] is sh.params[1]
    assert torch.equal(shards.shards[3].params[0].consts[1],
                       params[0].consts)
    states = shards.stack_states([voice.init(P) for P in params])
    fn = shards.render_fn(16, False, None, levels=lambda y: (y[:, 0],
                                                             y[:, 1]))
    mix, v, states, caps, lv = fn(states, shards.args([0, 1, 2, 3, 4], 16))
    assert v.tolist() == [16] * 5 and lv[0].shape == (5,) and caps == {}
    for i, P in enumerate(params):
        st = shards.voice_state(states, i)
        _, _, want, _ = voice.render_block(P, voice.init(P), 16, i, 16)
        assert torch.equal(st[0], want[0])


def test_meshed_groups_never_fuse():
    t = port_tracker(default_mesh(8, CPU))
    for i in range(3):
        t.play(f"v{i}", long_note(ir, 0.4 + 0.3 * i))
    t.play("solo", marked_note(ir, 0.3))
    status = [t.render_block()[1] for _ in range(5)]
    assert t._fused_set_key(16) is None and t.captures_started == 0
    assert [s.dispatches for s in status] == [2] * 5
    assert t._groups[0].mesh is not None


@pytest.mark.parametrize("n", range(1, 9))
def test_default_mesh_shape_follows_the_reference(n):
    mesh = default_mesh(n, CPU)
    assert mesh.devices.shape == jax_mesh(n).devices.shape
    assert mesh.shape["voice"] * mesh.shape.get("time", 1) == n
    assert {str(d) for d in mesh.devices.flat} == {"cpu"}
    assert mesh.axis_names == ("voice", "time")


def test_mesh_rejects_bad_grids():
    with pytest.raises(ValueError):
        Mesh([])
    with pytest.raises(ValueError):
        Mesh([[CPU], [CPU, CPU]])
    with pytest.raises(ValueError):
        render_voices_meshed([note(ir, 1.0), reloc_note(ir, 1.0)], 16, 8,
                             mesh=default_mesh(2, CPU), device=CPU)


def test_mesh_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        default_mesh()
    with pytest.raises(RuntimeError, match="cuda"):
        default_mesh(4)
    with pytest.raises(RuntimeError, match="cuda"):
        Mesh([["cuda:0"]])
    with pytest.raises(RuntimeError, match="cuda"):
        render_voices_meshed([note(ir, 1.0)], 16, 8)
    with pytest.raises(RuntimeError, match="cuda"):
        graft_entry.dryrun_multichip(8)
    with pytest.raises(RuntimeError, match="cuda"):
        graft_entry.entry()


def test_mesh_of_another_device_type_raises():
    with pytest.raises(ValueError, match="cpu mesh"):
        Tracker(8, 16, device="cuda", mesh=default_mesh(8, CPU))
    with pytest.raises(ValueError, match="cpu mesh"):
        render_voices_meshed([note(ir, 1.0)], 16, 8,
                             mesh=default_mesh(2, CPU), device="cuda")


# ---------------------------------------------------------------------------
# chip_smoke.py's phase 13 at CPU scale
# ---------------------------------------------------------------------------


def test_phase13_mesh_checks_on_cpu(monkeypatch, capsys):
    """M1-M3's checks on the CPU at small sizes: G1 cut to 16 voices of
    4096 lanes, M3's session to 3 notes an instrument."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_for_mesh_tests", REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    for name, value in (("G1_VOICES", 16), ("G1_BLOCK", 4096),
                        ("G1_BLOCKS", 2), ("MESH_MODIFY_BLOCK", 3),
                        ("MESH_EXACT_VOICES", 4), ("MESH_EXACT_BLOCKS", 2),
                        ("MESH_SESSION", (1024, 3, 0.1,
                                          (0.05, 0.06, 0.07, 0.08), 1.5e-5))):
        monkeypatch.setattr(cs, name, value)
    counts = cs.phase_mesh(torch, np, scan_ops, device=CPU)
    assert not any(counts.values())  # the plain versions launch nothing
    out = capsys.readouterr().out
    for line in ('mesh M1 {"voices": 16', "mesh M3 ", "mesh exact_df ",
                 "mesh M2 ", "phase 13 seconds: M1 "):
        assert line in out
    assert '"lane_sharded": true' in out and '"modified": "fm' in out


def _load_smoke():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_for_mesh_mix", REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


@pytest.mark.parametrize("extra, passes", [
    ("silent block", True), ("sounding block", False),
    ("voiced shorter", False), ("other voice modified", False)])
def test_m3_compares_audio_not_trailing_silent_blocks(extra, passes):
    """phase_m3's comparison (check_mesh_mix) on a synthetic pair of
    deferred sessions: a meshed mix with one more trailing block than the
    meshless one passes if that block is silent and fails if it holds a
    sample; a meshed mix whose last voiced sample is zeroed, or another
    voice modified, fails."""
    cs = _load_smoke()
    n, tol = 64, 1e-5
    rng = np.random.default_rng(3)
    ref = np.concatenate([rng.standard_normal(3 * n).astype(np.float32),
                          np.zeros(n, np.float32)])
    levels = [({"fm1": (1.0, 1.0)}, 1)] * 3
    got, mod = ref.copy(), "fm1"
    if extra == "silent block":
        got = np.concatenate([ref, np.zeros(n, np.float32)])
    elif extra == "sounding block":
        got = np.concatenate([ref, np.zeros(n, np.float32)])
        got[-5] = 1e-3
    elif extra == "voiced shorter":
        got[3 * n - 1] = 0.0
    else:
        mod = "fm2"
    if passes:
        diff = cs.check_mesh_mix(np, "test", got, ref, mod, "fm1", levels,
                                 n, tol)
        assert len(diff) == len(ref) and not diff.any()
        assert cs.voiced_length(np, got) == 3 * n
    else:
        with pytest.raises(cs.SmokeFailure, match="M3 test"):
            cs.check_mesh_mix(np, "test", got, ref, mod, "fm1", levels, n,
                              tol)

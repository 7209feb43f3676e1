"""The port's top-level entry points (port of the root __graft_entry__.py).

entry():            one block-render step of the flagship voice graph, and
                    example arguments for it.
dryrun_multichip(): builds an n-position parallel.Mesh and checks the mesh
                    paths against their meshless selves: a voice batch
                    sharded over the voice axis with the mix reduced over
                    it, lane sharding on a (voice, time) mesh, and a live
                    meshed Tracker with a timeline score and a mid-stream
                    Modify.

Run as `python -m tuun_tpu_torch.graft_entry [N] [--device cpu]` (on the
card by default).  Unlike tuun_tpu's, dryrun_multichip needs no virtual
devices: positions of a mesh may repeat a device, so it never re-execs.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

from . import ir, optimizer
from .engine import CompiledVoice, EngineConfig
from .evaluator import Evaluator
from .expr import ESeq, EWaveform
from .parallel import Mesh, default_mesh, render_voices_meshed
from .tracker import Tracker

STDLIB = Path(__file__).resolve().parent / "stdlib" / "v0"
FLAGSHIP = "triangle(220) + (noise * 0.2) | lpf(0.707, 2000) | R(1.0, 1.0)"


def _flagship_waveform() -> ir.Waveform:
    """A representative synthesis voice: subtractive triangle and noise
    through an RBJ low-pass biquad with an envelope (oscillator, reset,
    noise, IIR filter and symbolic-length nodes)."""
    out = Evaluator(44100, 120, STDLIB).evaluate_source(FLAGSHIP,
                                                        opens=("std",))
    if isinstance(out, ESeq):
        out = out.waveform
    if not isinstance(out, EWaveform):
        raise TypeError(f"{FLAGSHIP!r} is not a waveform")
    return optimizer.optimize(out.waveform)


def entry(device="cuda"):
    """Returns (fn, example_args): fn(params, state, s, e) -> (samples,
    valid_end, state', captures), one 8192-lane block-render step."""
    n = 8192
    voice = CompiledVoice(_flagship_waveform(),
                          EngineConfig(44100, "fast", device))
    P = voice.params()
    fn = voice.render_fn(n, fast=False)
    s = torch.zeros((), dtype=torch.int64, device=P.device)
    e = torch.full((), n, dtype=torch.int64, device=P.device)
    return fn, (P, voice.init(P), s, e)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def _order_bound(ref: np.ndarray, block: int) -> np.ndarray:
    """Per sample, 2 float32 ulp of its block's peak in `ref`: how far a
    meshed mix may sit from the meshless one, whose voices sum in another
    order (parallel.py's docstring)."""
    out = np.empty(len(ref), np.float64)
    for b in range(0, len(ref), block):
        peak = np.float32(np.abs(ref[b:b + block]).max())
        out[b:b + block] = 2 * float(np.spacing(peak))
    return out


def _detuned(base: ir.Waveform, cents: float) -> ir.Waveform:
    ratio = 2.0 ** (cents / 1200.0)

    def scale(w):
        if isinstance(w, ir.Const) and abs(w.value - 220.0) < 1.0:
            return ir.Const(w.value * ratio)
        return w.replace_children([scale(c) for c in w.children()])
    return scale(base)


def _reloc_note(freq: float) -> ir.Waveform:
    return ir.BinaryPointOp(
        ir.Operator.MULTIPLY,
        ir.Fin(ir.BinaryPointOp(ir.Operator.SUBTRACT, ir.Time(),
                                ir.Const(0.005)),
               ir.Sine(ir.Const(freq), ir.Const(0.0))),
        ir.Const(0.5))


def _marked_note(freq: float, mark_value: float) -> ir.Waveform:
    return ir.BinaryPointOp(ir.Operator.MULTIPLY,
                            ir.Sine(ir.Const(freq), ir.Const(0.0)),
                            ir.Marked("amp", ir.Const(mark_value)))


def _live_song(mesh, device):
    """The live check's session: a timeline score and three marked notes
    (one group) at 8 Hz in 16-sample blocks, levels on, reloc_fast, a
    Modify after three blocks; (the mix, each voice's rms)."""
    seg = "0.5 | fin(time - 1) | seq(time - 1)"
    score = optimizer.optimize(Evaluator(8, 60, STDLIB).evaluate_source(
        "<[" + ", ".join([seg] * 8) + "]>", opens=("std",)).waveform.waveform)
    t = Tracker(8, 16, precision="fast", device=device, mesh=mesh,
                levels=True)
    t.cfg.reloc_fast = True  # the lane-sharded fast path
    t.play("score", score)
    for i in range(3):
        t.play(f"v{i}", _marked_note(0.4 + 0.3 * i, 1.0))
    out = []
    for j in range(6):
        if j == 3:
            t.modify("v1", "amp", ir.Const(0.5))  # a state-carrying splice
        y, _ = t.render_block()
        out.append(np.asarray(y, np.float32))
    t._sync_voices(drain=True)
    levels = {v.id: round(v.level_rms, 5) for v in t.active}
    t.stop_all()
    t.close()
    return np.concatenate(out), levels


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """Runs the mesh paths on an n_devices-position mesh of `device`'s
    type (positions cycle over the visible devices) and checks them
    against their meshless selves, as tuun_tpu's dryrun does: the meshed
    mix of n detuned flagship voices against a one-position mesh (1e-5),
    on a 2-D mesh the lane-sharded render of relocatable notes against
    the voice-axis-only path (1e-5), and a live meshed Tracker (timeline
    score, three marked notes, levels, reloc_fast, a mid-stream Modify)
    against the meshless one.  tuun_tpu asserts that last check bit for
    bit; here the two mixes may differ by summation order, within 2 ulp
    of each block's peak (a deliberate deviation).  Returns what it
    measured; raises AssertionError on a failed check."""
    mesh = default_mesh(n_devices, device)
    _check(mesh.devices.size == n_devices,
           f"need {n_devices} positions, have {mesh.devices.size}")
    base = _flagship_waveform()
    voices = [_detuned(base, 7.0 * i) for i in range(n_devices)]
    mix = render_voices_meshed(voices, 256, 44100, mesh=mesh, block=256,
                               device=device)
    _check(mix.shape == (256,) and bool(np.isfinite(mix).all()),
           f"meshed mix: shape {mix.shape}, finite {np.isfinite(mix).all()}")
    one = Mesh([[mesh.devices[0, 0]]])
    single = render_voices_meshed(voices, 256, 44100, mesh=one, block=256,
                                  device=device)
    mix_diff = float(np.abs(mix - single).max())
    _check(mix_diff <= 1e-5, f"meshed mix diverges from a one-position "
           f"mesh's: max diff {mix_diff}")
    out = dict(positions=n_devices, mesh=dict(mesh.shape),
               devices=sorted({str(d) for d in mesh.devices.flat}),
               mix_diff=mix_diff)

    if mesh.shape["time"] > 1:
        melody = [_reloc_note(220.0 * 2 ** (i / 12))
                  for i in range(n_devices)]
        lane = render_voices_meshed(melody, 256, 44100, mesh=mesh,
                                    block=256, device=device)
        ref = render_voices_meshed(melody, 256, 44100, mesh=mesh, block=256,
                                   lane_shard=False, device=device)
        _check(lane.shape == ref.shape, f"lane-sharded render: {lane.shape} "
               f"samples, voice-axis-only {ref.shape}")
        out["lane_diff"] = float(np.abs(lane - ref).max())
        _check(out["lane_diff"] <= 1e-5, "lane-sharded render diverges "
               f"from voice-axis-only render by {out['lane_diff']}")

    got, lv_mesh = _live_song(mesh, device)
    ref, _ = _live_song(None, device)
    _check(got.shape == ref.shape, f"live: {got.shape} against {ref.shape}")
    diff = np.abs(got.astype(np.float64) - ref)
    out["live_diff"] = float(diff.max())
    out["live_bits_equal"] = bool(np.array_equal(got, ref))
    _check(bool((diff <= _order_bound(ref, 16)).all()),
           f"meshed live tracker diverges: max diff {out['live_diff']}")
    _check(len(lv_mesh) >= 3 and all(v > 0 for v in lv_mesh.values()),
           f"meshed per-voice levels missing: {lv_mesh}")
    out["levels"] = lv_mesh
    print(f"dryrun_multichip: {n_devices}-position mesh {dict(mesh.shape)} "
          f"on {out['devices']} OK, mix[0:4]={mix[:4]}, matches a "
          f"one-position mesh"
          + (", lane-sharded render matches" if "lane_diff" in out else "")
          + ", live tracker (timeline score + Modify + levels) matches")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("positions", type=int, nargs="?", default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    fn, example = entry(args.device)
    y, v, _, _ = fn(*example)
    print("entry() OK:", tuple(y.shape), int(v))
    dryrun_multichip(args.positions, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The port's live-coding REPL (tuun_tpu_torch.repl) on the CPU: twins of
every test in tests/test_repl.py, each keeping its name, on
Repl(device="cpu").

Each script runs on the port's Repl and on tuun_tpu's, on the same SONG
at 100 Hz in 20-sample blocks, exact mode and jit off, as the reference's
tests run; every mix the port renders equals tuun_tpu's within exact
mode's atol=1e-5 (test_torch_modify.py's exact-mode bound), besides the
reference's own assertions.  examples/song.tuun runs one longer script
(plays, a next-measure play, slider moves, keys chords, edits, key
chords, midi gestures, undo/redo, render to WAV, view, save, status) in
fast mode at 8 kHz on both, within test_torch_stream.py's fast-mode
8 * 2e-5.  The entry points are driven through stdin in child processes:
`python -m tuun_tpu_torch.repl FILE --device cpu` and
`python -m tuun_tpu_torch --ui true FILE --device cpu`; without --device
both ask for the card, and with none they fail rather than run on the
CPU.
"""

import io
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import tuun_tpu
import tuun_tpu_torch
from tuun_tpu.repl import Repl as JaxRepl
from tuun_tpu_torch.repl import Repl
from tuun_tpu_torch.wav import read_wav

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
STDLIB = Path(tuun_tpu_torch.__file__).resolve().parent / "stdlib" / "v0"
JAX_STDLIB = Path(tuun_tpu.__file__).resolve().parent / "stdlib" / "v0"
EXACT_ATOL = 1e-5
FAST_ATOL = 8 * 2e-5

SONG = '''// live set
open std;
#{sliders=["gain:0.5:0:1"]}
_ = $10 * gain;
#{level_db=0}
_ = 1 | fin(time - 0.5);
#{color=rgb(9, 9, 9)}
_ = fn(k, v) => (v * $(@k) | fin(time - 2), 1 | fin(time - 0.05));
'''


class ReplPair:
    """The port's Repl and tuun_tpu's on copies of one source file, fed
    the same lines; the port's side is `r`."""

    def __init__(self, tmp_path, source=SONG, sample_rate=100,
                 buffer_size=20, tempo=60, precision="exact", jit=False,
                 atol=EXACT_ATOL):
        self.atol = atol
        self.sides = []
        for name, cls, stdlib, kw in (
                ("torch", Repl, STDLIB, {"device": "cpu"}),
                ("jax", JaxRepl, JAX_STDLIB, {})):
            d = tmp_path / name
            d.mkdir()
            src = d / "song.tuun"
            src.write_text(source)
            out = io.StringIO()
            r = cls(sample_rate=sample_rate, tempo=tempo,
                    buffer_size=buffer_size, library_root=stdlib,
                    precision=precision, jit=jit, out=out, **kw)
            self.sides.append((r, out, src))
        self.r, self.out, self.src = self.sides[0]
        self.dispatch(f"load {self.src}", f"load {self.sides[1][2]}")

    def dispatch(self, line, jax_line=None):
        """Feeds `line` to both (jax_line to tuun_tpu's, if given) and
        holds every mix the line rendered to tuun_tpu's."""
        counts = [len(r.rendered) for r, _, _ in self.sides]
        self.r.dispatch(line)
        self.sides[1][0].dispatch(jax_line or line)
        new = [r.rendered[n:] for (r, _, _), n in zip(self.sides, counts)]
        assert len(new[0]) == len(new[1]), line
        for got, want in zip(*new):
            assert isinstance(got, np.ndarray) and got.dtype == np.float32
            assert len(got) == len(want), line
            np.testing.assert_allclose(got, want, rtol=0, atol=self.atol,
                                       err_msg=line)

    def text(self):
        return self.out.getvalue()

    def quit(self):
        self.dispatch("quit")


def make_repl(tmp_path):
    p = ReplPair(tmp_path)
    return p, p.out, p.src


def test_load_list_play_render(tmp_path):
    p, out, _ = make_repl(tmp_path)
    assert "A1" in out.getvalue() and "A2" in out.getvalue()
    p.dispatch("play A2")
    p.dispatch("render 1.0")
    mix = p.r.rendered[-1]
    assert np.allclose(mix[:50], 1.0, atol=1e-6)
    assert np.allclose(mix[50:], 0.0)
    p.quit()


def test_slider_ramp_live(tmp_path):
    p, out, _ = make_repl(tmp_path)
    p.dispatch("play A1")
    p.dispatch("render 0.2")
    p.dispatch("slider A1 gain 0")
    p.dispatch("render 0.4")
    tail = p.r.rendered[-1][-20:]
    np.testing.assert_allclose(tail, 0.0, atol=1e-5)
    p.quit()


def test_keys_flow(tmp_path):
    p, out, _ = make_repl(tmp_path)
    p.dispatch("keys A3")
    assert "keys instrument installed" in out.getvalue()
    p.dispatch("on 69 127")
    p.dispatch("render 0.2")
    assert np.abs(p.r.rendered[-1]).max() > 0
    p.dispatch("off 69")
    p.dispatch("render 0.5")
    assert not p.r.tracker.active
    p.quit()


def test_edit_and_save(tmp_path):
    p, out, src = make_repl(tmp_path)
    p.dispatch("edit A2 0.25 | fin(time - 0.5)")
    p.dispatch("play A2")
    p.dispatch("render 0.4")
    assert np.allclose(p.r.rendered[-1], 0.25, atol=1e-6)
    p.dispatch("slider A1 gain 1")
    saved = [tmp_path / f"saved_{i}.tuun" for i in range(2)]
    p.dispatch(f"save {saved[0]}", f"save {saved[1]}")
    text = saved[0].read_text()
    assert "0.25 | fin(time - 0.5)" in text
    assert '"gain:1:0:1"' in text
    assert "// live set" in text  # comments survive
    assert text == saved[1].read_text()
    p.quit()


def test_render_to_wav_and_dump(tmp_path):
    p, out, _ = make_repl(tmp_path)
    p.dispatch("play A2")
    wavs = [tmp_path / f"mix_{i}.wav" for i in range(2)]
    p.dispatch(f"render 0.6 {wavs[0]}", f"render 0.6 {wavs[1]}")
    samples, sr = read_wav(wavs[0])
    assert sr == 100 and np.allclose(samples[:50], 1.0)
    assert len(samples) == len(p.r.rendered[-1])
    p.dispatch("dump A2")
    assert "Fin(" in out.getvalue() or "Fixed(" in out.getvalue()
    p.quit()


def test_error_paths(tmp_path):
    p, out, _ = make_repl(tmp_path)
    p.dispatch("play Z9")
    assert "no program" in out.getvalue()
    p.dispatch("bogus")
    assert "unknown command" in out.getvalue()
    p.dispatch("keys A1")  # waveform, not an instrument
    assert "not a keys instrument" in out.getvalue()
    p.dispatch("edit A2 1 + ")  # atomic failure
    assert "splice failed" in out.getvalue()
    p.quit()


def test_malformed_args_do_not_crash_session(tmp_path):
    """Malformed command arguments are usage errors, never uncaught
    exceptions that tear down the live session."""
    p, out, _ = make_repl(tmp_path)
    p.dispatch("midi connect")
    for line in ("midi encoder",        # IndexError: missing args
                 "midi encoder a b",    # ValueError: non-numeric
                 "midi nav sideways",   # KeyError: unknown direction
                 "view abc",            # ValueError: non-numeric seconds
                 "level A1 loud"):      # ValueError: non-numeric dB
        before = out.getvalue()
        p.dispatch(line)
        assert p.r.running, line
        assert "usage error" in out.getvalue()[len(before):], line
    p.dispatch("keys A3")
    p.dispatch("on notakey")  # ValueError: non-numeric key
    assert p.r.running
    assert "usage error" in out.getvalue()
    # The session still works after every malformed command.
    p.dispatch("play A2")
    p.dispatch("render 0.2")
    assert p.r.rendered
    p.quit()


def test_undo_redo(tmp_path):
    p, out, _ = make_repl(tmp_path)
    p.dispatch("edit A2 0.25 | fin(time - 0.5)")
    p.dispatch("edit A2 0.75 | fin(time - 0.5)")
    p.dispatch("undo A2")
    assert "0.25 | fin(time - 0.5)" in p.r.programs.source
    p.dispatch("redo A2")
    assert "0.75 | fin(time - 0.5)" in p.r.programs.source
    p.dispatch("undo A2")
    p.dispatch("undo A2")  # back to the original
    assert "1 | fin(time - 0.5)" in p.r.programs.source
    p.dispatch("undo A2")
    assert "nothing to undo" in out.getvalue()
    p.quit()


def test_loop_and_status(tmp_path):
    p, out, _ = make_repl(tmp_path)
    p.dispatch("loop A2 1")   # quarter=1s at tempo 60, measure=4s
    assert "looping A2" in out.getvalue()
    p.dispatch("status")
    assert "pending" in out.getvalue()
    # A measure is 400 samples at sr=100; render past the start.
    p.dispatch("render 4.5")
    mix = np.concatenate(p.r.rendered)
    assert np.abs(mix[:400]).max() == 0.0   # before the first measure
    assert np.abs(mix[400:450]).max() > 0.5  # first repetition playing
    p.dispatch("stop")
    p.quit()


def test_cli_ui_flag_launches_repl(monkeypatch, tmp_path):
    from tuun_tpu_torch import cli
    launched = {}

    class FakeRepl:
        def __init__(self, **kw):
            launched.update(kw)

        def dispatch(self, line):
            launched["loaded"] = line

        def run(self):
            launched["ran"] = True

    import tuun_tpu_torch.repl as repl_mod
    monkeypatch.setattr(repl_mod, "Repl", FakeRepl)
    src = tmp_path / "x.tuun"
    src.write_text("open std;\n#{level_db=0}\n_ = $10;\n")
    rc = cli.main(["--ui", "true", str(src), "--no-jit", "--device", "cpu"])
    assert rc == 0 and launched.get("ran")
    assert "load" in launched.get("loaded", "")
    assert launched["device"] == "cpu"


def _slow_bakes(monkeypatch, real=True, delay=None):
    import threading

    from tuun_tpu_torch.engine import precompute as precompute_mod
    baking, release = threading.Event(), threading.Event()
    original = precompute_mod.precompute

    def slow_precompute(w, sample_rate, seed=0, cfg=None):
        baking.set()
        assert release.wait(timeout=10), "test never released the bake"
        return original(w, sample_rate, seed=seed, cfg=cfg)
    monkeypatch.setattr(precompute_mod, "precompute", slow_precompute)
    return baking, release


def _port_repl(tmp_path):
    src = tmp_path / "song.tuun"
    src.write_text(SONG)
    out = io.StringIO()
    r = Repl(sample_rate=100, tempo=60, buffer_size=20,
             library_root=STDLIB, precision="exact", jit=False, out=out,
             device="cpu")
    r.dispatch(f"load {src}")
    return r


def test_async_precompute_next_measure(tmp_path, monkeypatch):
    """`play N measure` returns before the bake completes; the finished
    bake is pumped into the tracker at a later block boundary and the
    voice still starts exactly at the precomputed measure sample."""
    import time

    baking, release = _slow_bakes(monkeypatch)
    r = _port_repl(tmp_path)
    t0 = time.perf_counter()
    r.dispatch("play A2 measure")  # next measure = sample 400 (4s @ 60bpm)
    latency = time.perf_counter() - t0
    # play returned while the bake is still blocked.
    assert baking.wait(timeout=10)
    assert latency < 0.5
    assert not r.tracker.pending and not r.tracker.active
    release.set()
    assert r.player.flush_bakes() == 1
    # The voice was scheduled at the measure boundary fixed at play time.
    assert r.tracker.pending and r.tracker.pending[0].start == 400
    r.dispatch("render 5.0")
    mix = r.rendered[-1]
    # Program A2 is `1 | fin(time - 0.5)`: ones for 0.5s from sample 400.
    assert np.allclose(mix[400:450], 1.0, atol=1e-6)
    assert np.allclose(mix[:400], 0.0) and np.allclose(mix[450:], 0.0)
    r.dispatch("quit")


def test_async_precompute_bake_failure_plays_unbaked(tmp_path, monkeypatch):
    from tuun_tpu_torch.engine import precompute as precompute_mod

    def broken(w, sample_rate, seed=0, cfg=None):
        raise RuntimeError("bake exploded")

    monkeypatch.setattr(precompute_mod, "precompute", broken)
    r = _port_repl(tmp_path)
    r.dispatch("play A2 measure")
    assert r.player.flush_bakes() == 1
    r.dispatch("render 5.0")
    mix = r.rendered[-1]
    assert np.allclose(mix[400:450], 1.0, atol=1e-6)
    r.dispatch("quit")


def test_stop_cancels_inflight_async_bake(tmp_path, monkeypatch):
    """A 'stopped' program must not come back to life when its
    next-measure bake completes after the stop."""
    _, release = _slow_bakes(monkeypatch)
    r = _port_repl(tmp_path)
    r.dispatch("play A2 measure")   # bake in flight
    r.dispatch("stop")              # global stop: cancels the bake
    release.set()
    assert r.player.flush_bakes() == 0
    r.dispatch("render 5.0")
    assert np.allclose(r.rendered[-1], 0.0)
    # A fresh play after the cancellation still works.
    r.dispatch("play A2 measure")
    assert r.player.flush_bakes() == 1
    r.dispatch("quit")


def test_stop_one_cancels_only_that_programs_bake(tmp_path, monkeypatch):
    from tuun_tpu_torch.engine import precompute as precompute_mod

    monkeypatch.setattr(
        precompute_mod, "precompute",
        lambda w, sample_rate, seed=0, cfg=None: w)
    r = _port_repl(tmp_path)
    r.dispatch("play A1 measure")
    r.dispatch("play A2 measure")
    r.player._bake_in.join()        # both baked, not yet pumped
    r.dispatch("stop A2")
    assert r.player.flush_bakes() == 1  # only A1 survives
    assert [str(p.id) for p in r.tracker.pending] == ["program(0)"]
    r.dispatch("quit")


def test_midi_command_drives_controller_loop(tmp_path):
    """`midi` gestures run the full launchkey.rs <-> midi_input.rs loop:
    device bytes -> driver decode -> classify -> reducer/effects -> LED
    and display sync back to the (simulated) controller."""
    p, out, _ = make_repl(tmp_path)
    r = p.r
    p.dispatch("midi connect")
    assert "launchkey connected" in out.getvalue()
    # plugin encoder 0 moves the active program's gain slider
    p.dispatch("midi encoder 0 8")
    state = r.state
    assert state.programs.programs[0].sliders.normalized_values[0] == \
        pytest.approx(0.5 + 8 / 512.0)
    # the encoder display got the new value
    device = r._midi_device
    from tuun_tpu_torch import launchkey as lk
    d = device.displays[lk.ENCODER_DISPLAY_TARGET_OFFSET]
    assert d["fields"][0] == "gain"
    # mixer mode + encoder changes program 1's level
    p.dispatch("midi mode mixer")
    assert r.runner.launchkey.encoder_mode == lk.MIXER
    p.dispatch("midi encoder 1 -4")
    assert state.programs.programs[1].level_db == pytest.approx(-1.0)
    # pad-mode cycle into the keys installer; program 3 (an fn) lights
    p.dispatch("midi pads daw")
    assert state.daw_pad_mode == "keys_installer"
    assert device.pad_colors[lk.DAW_PAD_BOTTOM_ROW_OFFSET + 2] != (0, 0, 0)
    # install keys from pad 2, play a note through the MIDI port
    p.dispatch("midi pad bottom 2")
    assert state.keys_program == 2
    p.dispatch("midi note 60 127")
    p.dispatch("render 0.2")
    mix = np.concatenate(r.rendered)
    assert np.abs(mix).max() > 0.1  # the key is sounding
    p.dispatch("midi release 60")
    # function pad cycles repeat_after_measures and recolors itself
    p.dispatch("midi fn")
    assert state.repeat_after_measures == 1
    assert device.function_color == lk.COLOR_YELLOW_GREEN
    # The same gestures printed the same controller log on both (but
    # for the paths and the renders' timed load).
    logs = [[line for line in o.getvalue().replace(str(src), "").splitlines()
             if not line.startswith("rendered ")]
            for _, o, src in p.sides]
    assert logs[0] == logs[1]
    p.quit()


# -- examples/song.tuun, fast, at 8 kHz -------------------------------------

# Plays A1-A4 (A1 at the next measure), moves A2's cutoff, plays A5's
# pm_piano_keys chord and releases it; adds a W2g-like keys program in a
# new slot through edit mode and an FM keys program over A4 through
# `edit`, plays each alone and as a chord; edits A2 with `key` chords,
# drives a midi knob and a pad, undo/redo, stop, view, status.  (Edits
# save the source file: each side loads its own copy.)
W2G_KEYS = ("fn(k, v) => (reset(triangle(110), time * -(@k)) * 2 * v "
            "| lpf(0.7, 2000), Rw(0.2, 1.0))")
FM_KEYS = "fn(k, v) => (sine(2*pi*(@k + 30*$(5)), 0) * 0.5 * v, Rw(0.2, 1.0))"
SONG_SCRIPT = [
    "play A1 measure", "play A2", "play A3", "play A4", "render 1",
    "slider A2 cutoff 900", "render 0.5", "slider A2 cutoff 3000",
    "render 0.5", "keys A5", "on 60 100", "on 64 90", "on 67 80",
    "render 0.5", "off 64", "render 0.25", "off 60", "off 67",
    "render 0.5",
    "select A5", "key down enter", f"type {W2G_KEYS}", "key escape",
    "keys A6", "on 45 100", "render 0.25", "on 52 100", "render 0.25",
    "off 45", "off 52", "render 0.5",
    f"edit A4 {FM_KEYS}", "keys A4", "on 57 100", "render 0.25",
    "on 61 100", "render 0.25", "off 57", "off 61", "render 0.5",
    "edit A2", "key C-e backspace", "type 4", "key escape",
    "midi connect", "select A2", "midi encoder 0 20", "midi pad top 0",
    "render 0.5", "undo A2", "redo A2", "stop", "render 1",
    "view 0.5 4", "status",
]


def test_song_script_matches_jax_repl(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # A3's capture("bell") WAV lands here
    source = (REPO / "examples" / "song.tuun").read_text()
    p = ReplPair(tmp_path, source=source, sample_rate=8000,
                 buffer_size=256, tempo=90, precision="fast", jit=True,
                 atol=FAST_ATOL)
    # The per-voice path on both: tuun_tpu's fused step would compile a
    # step for every set the script makes (test_torch_session.py holds
    # the fused step against tuun_tpu's).
    for r, _, _ in p.sides:
        r.tracker.fuse = False
    for line in SONG_SCRIPT:
        p.dispatch(line)
    text = p.text()
    assert "error:" not in text and "usage error" not in text, text
    assert "updated A4" in text
    assert "keys instrument installed from A6" in text
    mix = np.concatenate(p.r.rendered)
    assert np.isfinite(mix).all() and np.abs(mix).max() > 0.05
    wavs = [tmp_path / f"song_{i}.wav" for i in range(2)]
    p.dispatch(f"render 0.5 {wavs[0]}", f"render 0.5 {wavs[1]}")
    samples, sr = read_wav(wavs[0])
    assert sr == 8000 and len(samples) == len(p.r.rendered[-1])
    p.quit()


# -- the entry points, through stdin -----------------------------------------


def _run(args, stdin, cwd, timeout=300):
    env = dict(os.environ, TUUN_PREWARM="0", PYTHONPATH=str(REPO))
    return subprocess.run([sys.executable, "-m", *args], input=stdin,
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=timeout)


@pytest.mark.parametrize("entry", [
    ["tuun_tpu_torch.repl"], ["tuun_tpu_torch", "--ui", "true",
                              "--sample_rate", "8000"]],
    ids=["repl", "cli-ui"])
def test_entry_point_runs_the_repl_through_stdin(entry, tmp_path):
    song = tmp_path / "song.tuun"
    song.write_text((REPO / "examples" / "song.tuun").read_text())
    wav = tmp_path / "out.wav"
    proc = _run(entry + [str(song), "--device", "cpu"],
                f"play A2\nrender 1 {wav}\nquit\n", cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "Playing A2" in proc.stdout
    assert "error" not in proc.stdout
    samples, sr = read_wav(wav)
    assert len(samples) == int(sr / 1024) * 1024  # `render 1`: whole blocks
    assert np.isfinite(samples).all() and np.abs(samples).max() > 0.05


@pytest.mark.parametrize("entry", [
    ["tuun_tpu_torch.repl"], ["tuun_tpu_torch", "--ui", "true"]],
    ids=["repl", "cli-ui"])
def test_entry_point_needs_the_card_by_default(entry, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    proc = _run(entry + [str(REPO / "examples" / "song.tuun")], "quit\n",
                cwd=tmp_path)
    assert proc.returncode != 0
    assert "cuda" in (proc.stderr + proc.stdout).lower()
    assert "Playing" not in proc.stdout

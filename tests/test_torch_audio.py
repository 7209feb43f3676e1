"""The port's host PCM output (tuun_tpu_torch.audio) on the CPU: twins of
every test in tests/test_audio.py, each keeping its name, on the port's
Tracker and Repl with device="cpu".

The StreamPump owns the tracker on an audio thread, drains marshaled
commands at block boundaries, paces blocks against the wall clock and
delivers landed PCM to a sink.  As in the reference's tests, blocks are
256 samples at 8 kHz (32 ms: long enough to render on a loaded CPU), and
every structure is rendered once before the paced phase.  Tolerances:
the pump's PCM equals the port's own offline render within the
reference's atol=1e-6, and tuun_tpu's offline render (fast mode, jitted
on the CPU) within test_torch_stream.py's fast-mode 8 * 2e-5.

Added: the writer reads each block from a staged host copy
(Tracker.stage_host) and waits on its event, while the audio thread
never waits and its steady renders read no tensor on the host; the
blocks of a lookahead window share one host copy.
"""

import io
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import tuun_tpu
import tuun_tpu_torch
from test_torch_stream import _NoHostReads
from tuun_tpu.evaluator import Evaluator as JaxEvaluator
from tuun_tpu.expr import ESeq as JaxESeq
from tuun_tpu.optimizer import optimize as jax_optimize
from tuun_tpu.player import build_top_level_waveform as jax_top_level
from tuun_tpu.tracker import Tracker as JaxTracker
from tuun_tpu_torch import audio
from tuun_tpu_torch import tracker as tracker_mod
from tuun_tpu_torch.evaluator import Evaluator
from tuun_tpu_torch.expr import ESeq
from tuun_tpu_torch.ids import MarkId, WaveformId
from tuun_tpu_torch.optimizer import optimize
from tuun_tpu_torch.player import build_top_level_waveform, stop_ramp
from tuun_tpu_torch.tracker import Tracker

torch.set_num_threads(1)
CPU = "cpu"
STDLIB = Path(tuun_tpu_torch.__file__).resolve().parent / "stdlib" / "v0"
JAX_STDLIB = Path(tuun_tpu.__file__).resolve().parent / "stdlib" / "v0"
SR = 8000
BLOCK = 256
BS = BLOCK / SR
FAST_ATOL = 8 * 2e-5  # test_torch_stream.py's fast-mode bound
SONG = "open std;\n#{level_db=0}\n_ = $330 * 0.5;\n"


class FakeSink(audio.AudioSink):
    def __init__(self):
        self.blocks = []
        self.times = []
        self.closed = False

    def write(self, block):
        self.blocks.append(np.asarray(block, np.float32).copy())
        self.times.append(time.perf_counter())

    def close(self):
        self.closed = True

    def pcm(self):
        return np.concatenate(self.blocks) if self.blocks else \
            np.zeros(0, np.float32)


def _wave(text):
    ev = Evaluator(SR, 120, STDLIB)
    out = ev.evaluate_source(text, opens=("std",))
    if isinstance(out, ESeq):
        out = out.waveform
    return build_top_level_waveform(optimize(out.waveform), 0.0)


def _jax_wave(text):
    ev = JaxEvaluator(SR, 120, JAX_STDLIB)
    out = ev.evaluate_source(text, opens=("std",))
    if isinstance(out, JaxESeq):
        out = out.waveform
    return jax_top_level(jax_optimize(out.waveform), 0.0)


def _tracker(**kw):
    kw.setdefault("precision", "fast")
    kw.setdefault("jit", True)
    return Tracker(SR, BLOCK, device=CPU, **kw)


def _host(y):
    return y if isinstance(y, np.ndarray) else y.numpy()


def _offline(tracker, blocks):
    return np.concatenate([np.asarray(_host(tracker.render_block()[0]),
                                      np.float32) for _ in range(blocks)])


def _jax_offline(text, blocks, warm):
    """tuun_tpu's tracker renders `text`: `blocks` blocks after `warm`."""
    t = JaxTracker(SR, BLOCK, precision="fast", jit=True)
    t.play(WaveformId.program(0), _jax_wave(text))
    for _ in range(warm):
        t.render_block()
    out = np.concatenate([np.asarray(t.render_block()[0], np.float32)
                          for _ in range(blocks)])
    t.close()
    return out


def _repl(tmp_path, monkeypatch, **kw):
    from tuun_tpu_torch.repl import Repl
    src = tmp_path / "song.tuun"
    src.write_text(SONG)
    out = io.StringIO()
    r = Repl(sample_rate=SR, tempo=60, buffer_size=BLOCK,
             library_root=STDLIB, precision="fast", jit=True, out=out,
             device=CPU, **kw)
    r.dispatch(f"load {src}")
    return r, out


def test_pump_delivers_the_same_pcm_as_an_offline_render():
    w = _wave("$330 * 0.5")
    tracker = _tracker()
    tracker.play(WaveformId.program(0), w)
    twin = _tracker()
    twin.play(WaveformId.program(0), w)
    # Render every path once on both (nothing is built inside the paced
    # phase), keeping the two trackers position-aligned.
    for t in (tracker, twin):
        for _ in range(3):
            t.render_block()
    sink = FakeSink()
    pump = audio.StreamPump(tracker, sink)
    pump.start()
    try:
        time.sleep(20 * BS)
    finally:
        pump.stop()
    assert sink.closed
    assert pump.error is None
    got = sink.pcm()
    assert len(got) >= 12 * BLOCK  # paced: ~1 block per block_secs
    np.testing.assert_allclose(got, _offline(twin, len(got) // BLOCK),
                               atol=1e-6)
    # tuun_tpu's tracker renders the same stream.
    np.testing.assert_allclose(
        got, _jax_offline("$330 * 0.5", len(got) // BLOCK, 3), rtol=0,
        atol=FAST_ATOL)
    # An idle host with a warm engine never misses its ring deadline.
    assert pump.underruns == 0
    tracker.close()
    twin.close()


def test_pump_paces_against_the_wall_clock():
    sink = FakeSink()
    tracker = _tracker()  # idle: renders host silence
    pump = audio.StreamPump(tracker, sink)
    pump.start()
    try:
        time.sleep(30 * BS)
    finally:
        pump.stop()
    n = len(sink.blocks)
    # Paced production: ~1 block per block_secs of wall time, never an
    # unbounded sprint.
    assert 20 <= n <= 38 + pump.ring
    assert pump.blocks_out == n


def test_ring_is_constant_independent_of_the_sync_window():
    """A deep lookahead (K=8) does not inflate the ring: the output
    latency is RING_BLOCKS whatever the sync window, and the delivered
    PCM still matches a plain tracker exactly."""
    w = _wave("$330 * 0.5")
    tracker = _tracker(sync_interval=8)
    tracker.play(WaveformId.program(0), w)
    twin = _tracker()
    twin.play(WaveformId.program(0), w)
    for t in (tracker, twin):
        for _ in range(3):
            t.render_block()
    sink = FakeSink()
    pump = audio.StreamPump(tracker, sink)
    assert pump.ring == audio.RING_BLOCKS
    assert pump.latency_secs == audio.RING_BLOCKS * BS
    pump.start()
    try:
        time.sleep(24 * BS)
    finally:
        pump.stop()
    assert pump.error is None and pump.underruns == 0
    got = sink.pcm()
    assert len(got) >= 16 * BLOCK
    np.testing.assert_allclose(got, _offline(twin, len(got) // BLOCK),
                               atol=1e-6)
    tracker.close()
    twin.close()


def test_commands_marshal_onto_the_audio_thread():
    w = _wave("$330 * 0.5")
    note = _wave("$392 * 0.25")
    tracker = _tracker(sync_interval=4)
    tracker.play(WaveformId.program(0), w)
    # Compile the note's structure first (the port's compile cache is
    # the tracker's own; a compile on the CPU takes milliseconds).
    tracker.cache.get(note, tracker.cfg)
    for _ in range(6):
        tracker.render_block()
    sink = FakeSink()
    pump = audio.StreamPump(tracker, sink)
    pump.start()
    try:
        time.sleep(4 * BS)
        # call(): runs on the audio thread, returns the value.
        assert pump.call(lambda: len(tracker.active)) == 1
        pump.call(lambda: tracker.play(WaveformId.key(60), note))
        time.sleep(4 * BS)
        assert pump.call(lambda: len(tracker.active)) == 2
        pump.call(lambda: tracker.modify(
            WaveformId.key(60), MarkId.TERMINATOR, stop_ramp()))
        # The stopped note (50 ms ramp at 8 kHz = 400 samples) retires.
        deadline = time.time() + 120 * BS
        while time.time() < deadline:
            if pump.call(lambda: len(tracker.active)) == 1:
                break
            time.sleep(2 * BS)
        assert pump.call(lambda: len(tracker.active)) == 1
        # Exceptions inside a command surface at the caller.
        with pytest.raises(ZeroDivisionError):
            pump.call(lambda: 1 / 0)
    finally:
        pump.stop()
    assert pump.error is None
    assert len(sink.pcm()) >= 8 * BLOCK
    tracker.close()


def test_pcm_file_sink_roundtrip(tmp_path):
    path = tmp_path / "out.pcm"
    sink = audio.PCMFileSink(path)
    data = np.linspace(-1, 1, 64, dtype=np.float32)
    sink.write(data)
    sink.close()
    back = np.frombuffer(path.read_bytes(), "<f4")
    np.testing.assert_array_equal(back, data)


def test_open_sink_prefers_pcm_path(tmp_path):
    sink, desc = audio.open_sink(SR, BLOCK, pcm_path=str(tmp_path / "a.pcm"))
    assert isinstance(sink, audio.PCMFileSink)
    assert "a.pcm" in desc
    sink.close()


def test_repl_goes_live_and_refuses_offline_renders(tmp_path, monkeypatch):
    sink = FakeSink()
    monkeypatch.setattr(audio, "open_sink",
                        lambda sr, bl, pcm_path=None: (sink, "fake sink"))
    r, out = _repl(tmp_path, monkeypatch)
    # Render the program's path once before going live.
    r.dispatch("play A1")
    r.dispatch("render 0.2")
    r.dispatch("audio start")
    try:
        assert "audio started" in out.getvalue()
        assert r.tracker.sync_interval == audio.STREAM_SYNC_INTERVAL
        time.sleep(8 * BS)
        r.dispatch("render 0.1")  # refused while live
        assert "audio is live" in out.getvalue()
        r.dispatch("audio status")
        assert "underruns" in out.getvalue()
    finally:
        r.dispatch("audio stop")
    assert "audio stopped" in out.getvalue()
    assert sink.closed
    # Live audio actually played the program (non-silent PCM landed).
    pcm = sink.pcm()
    assert len(pcm) > 0 and float(np.abs(pcm).max()) > 0.1
    # Offline rendering works again; the sync cadence is restored.
    assert r.tracker.sync_interval == 1
    r.dispatch("render 0.1")
    assert len(r.rendered[-1]) > 0
    assert isinstance(r.rendered[-1], np.ndarray)
    r.dispatch("quit")


def test_live_view_paints_from_the_delivered_pcm_tap(tmp_path,
                                                     monkeypatch):
    sink = FakeSink()
    monkeypatch.setattr(audio, "open_sink",
                        lambda sr, bl, pcm_path=None: (sink, "fake sink"))
    # Short sync windows: the tap fills one window at a time.
    monkeypatch.setattr(audio, "STREAM_SYNC_INTERVAL", 4)
    r, out = _repl(tmp_path, monkeypatch)
    r.dispatch("play A1")
    r.dispatch("render 0.2")  # render every path once before going live
    r.dispatch("audio start")
    try:
        time.sleep(12 * BS)  # let delivered PCM land in the tap
        r.dispatch("view 0.4 5")
        text = out.getvalue()
        assert "LIVE" in text            # the live dashboard painted
        assert text.count("LIVE") >= 2   # ... more than once
        assert "A1" in text and "measure" in text
        # The tap holds real delivered audio, as numpy.
        recent = r.pump.recent(4 * BLOCK)
        assert isinstance(recent, np.ndarray)
        assert len(recent) > 0 and float(np.abs(recent).max()) > 0.1
        # The audio thread kept pacing during the view.
        assert r.pump.alive
    finally:
        r.dispatch("audio stop")
    r.dispatch("quit")


def test_fifo_sink_requires_a_reader(tmp_path):
    """A FIFO with no reader must NOT hang `audio start` forever: the
    sink opens non-blocking, waits a bounded time for a reader, then
    fails with an actionable message."""
    import os

    fifo = tmp_path / "pcm.fifo"
    os.mkfifo(fifo)
    t0 = time.perf_counter()
    with pytest.raises(OSError, match="no reader on FIFO"):
        audio.PCMFileSink(fifo, wait_reader_secs=0.2)
    assert time.perf_counter() - t0 < 3.0  # bounded, not forever
    # open_sink surfaces the failure as (None, reason), not a hang.
    sink, desc = audio.open_sink(SR, BLOCK, pcm_path=str(fifo))
    assert sink is None and "no reader" in desc


def test_fifo_sink_streams_to_a_reader(tmp_path, monkeypatch):
    """With a reader attached the FIFO path works end to end, and writes
    are blocking again (pacing relies on pipe backpressure)."""
    import os

    monkeypatch.setattr(audio, "FIFO_WAIT_READER_SECS", 5.0)
    fifo = tmp_path / "pcm.fifo"
    os.mkfifo(fifo)
    got = []

    def reader():
        with open(fifo, "rb") as f:
            got.append(f.read(64 * 4))

    t = threading.Thread(target=reader, daemon=True)
    t.start()
    sink = audio.PCMFileSink(fifo)
    data = np.linspace(-1, 1, 64, dtype=np.float32)
    sink.write(data)
    sink.close()
    t.join(timeout=10)
    assert not t.is_alive()
    np.testing.assert_array_equal(np.frombuffer(got[0], "<f4"), data)


def test_call_timeout_cancels_the_command():
    """A timed-out call() must not double-land after the caller gave up
    (the audio thread skips a cancelled entry)."""
    tracker = _tracker()  # idle: renders host silence
    pump = audio.StreamPump(tracker, FakeSink())
    pump.start()
    landed = []
    try:
        # Stall the audio thread's command drain.
        pump.post(lambda: time.sleep(0.6))
        time.sleep(0.05)  # let the stall start
        with pytest.raises(TimeoutError):
            pump.call(lambda: landed.append("x"), timeout=0.1)
        time.sleep(1.0)  # the stall ends; the drain resumes
        assert landed == []  # cancelled: never executed
        # The pump is still healthy and serviceable.
        assert pump.call(lambda: 42) == 42
    finally:
        pump.stop()
    assert pump.error is None


def test_writer_surfaces_sink_errors():
    """A dying sink (FIFO reader gone, device yanked) must be VISIBLE:
    pump.error set, pump no longer alive -- not a silent thread death."""

    class DyingSink(audio.AudioSink):
        def __init__(self):
            self.n = 0

        def write(self, block):
            self.n += 1
            if self.n > 2:
                raise ValueError("write to closed file")

    tracker = _tracker()
    pump = audio.StreamPump(tracker, DyingSink())
    pump.start()
    try:
        deadline = time.time() + 10
        while time.time() < deadline and pump.error is None:
            time.sleep(2 * BS)
        assert isinstance(pump.error, ValueError)
        assert not pump.alive
        assert pump.stats()["alive"] is False
    finally:
        pump.stop()


def test_audio_restart_after_pump_death_restores_cadence(tmp_path,
                                                         monkeypatch):
    """Restarting audio over a DEAD pump must reap it (sink closed,
    offline sync cadence restored) instead of clobbering the saved
    cadence with the already-bumped value."""
    sinks = []

    def fake_open(sr, bl, pcm_path=None):
        sinks.append(FakeSink())
        return sinks[-1], "fake sink"

    monkeypatch.setattr(audio, "open_sink", fake_open)
    r, out = _repl(tmp_path, monkeypatch)
    assert r.tracker.sync_interval == 1
    r.dispatch("audio start")
    assert r.tracker.sync_interval == audio.STREAM_SYNC_INTERVAL
    # The pump dies without an `audio stop` (device error analogue).
    r.pump.stop(close_sink=False)
    assert not r.pump.alive
    r.dispatch("audio start")  # restart reaps the corpse first
    assert sinks[0].closed
    assert r.pump is not None and r.pump.alive
    assert r.tracker.sync_interval == audio.STREAM_SYNC_INTERVAL
    r.dispatch("audio stop")
    # The offline cadence survives the death/restart cycle.
    assert r.tracker.sync_interval == 1
    r.dispatch("quit")


def test_dispatch_survives_a_stalled_audio_thread(tmp_path, monkeypatch):
    """TimeoutError from the audio thread must be reported, not tear
    down the live session."""
    sink = FakeSink()
    monkeypatch.setattr(audio, "open_sink",
                        lambda sr, bl, pcm_path=None: (sink, "fake sink"))
    r, out = _repl(tmp_path, monkeypatch)
    r.dispatch("audio start")
    try:
        def stalled_call(fn, timeout=120.0, **kw):
            raise TimeoutError("audio thread did not pick up the command")

        monkeypatch.setattr(r.pump, "call", stalled_call)
        r.dispatch("list")
        assert "audio thread busy" in out.getvalue()
        assert r.running  # the session survived
    finally:
        monkeypatch.undo()
        r.dispatch("audio stop")
    r.dispatch("quit")


# -- the real-device sink path, via a module-injected mock sounddevice --


class _PortAudioError(Exception):
    pass


class _FakeStream:
    def __init__(self, fail_after=None, stop_raises=False, **kw):
        self.kw = kw
        self.started = False
        self.stopped = False
        self.closed = False
        self.writes = []
        self.fail_after = fail_after
        self.stop_raises = stop_raises

    def start(self):
        self.started = True

    def stop(self):
        self.stopped = True
        if self.stop_raises:
            raise _PortAudioError("stream already aborted")

    def close(self):
        self.closed = True

    def write(self, arr):
        if self.fail_after is not None and \
                len(self.writes) >= self.fail_after:
            raise _PortAudioError("device unplugged")
        assert arr.dtype == np.float32 and arr.flags["C_CONTIGUOUS"]
        self.writes.append(np.array(arr))


def _mock_sounddevice(monkeypatch, fail_after=None, broken=False,
                      stop_raises=False):
    import sys
    import types
    mod = types.ModuleType("sounddevice")
    streams = []

    def OutputStream(**kw):
        if broken:
            raise _PortAudioError("no default output device")
        st = _FakeStream(fail_after=fail_after, stop_raises=stop_raises,
                         **kw)
        streams.append(st)
        return st

    mod.OutputStream = OutputStream
    mod.PortAudioError = _PortAudioError
    monkeypatch.setitem(sys.modules, "sounddevice", mod)
    return streams


def test_sounddevice_sink_open_write_close_sequencing(monkeypatch):
    streams = _mock_sounddevice(monkeypatch)
    sink = audio.SoundDeviceSink(SR, BLOCK)
    st = streams[0]
    assert st.kw == {"samplerate": SR, "channels": 1,
                     "dtype": "float32", "blocksize": BLOCK}
    assert st.started
    # Writes land contiguous float32 regardless of the input dtype.
    sink.write(np.arange(BLOCK, dtype=np.float64) / BLOCK)
    sink.write(np.zeros(BLOCK, np.float32))
    assert len(st.writes) == 2
    assert np.allclose(st.writes[0], np.arange(BLOCK) / BLOCK, atol=1e-6)
    sink.close()
    assert st.stopped and st.closed


def test_sounddevice_sink_close_closes_even_when_stop_raises(monkeypatch):
    streams = _mock_sounddevice(monkeypatch, stop_raises=True)
    sink = audio.SoundDeviceSink(SR, BLOCK)
    with pytest.raises(_PortAudioError):
        sink.close()
    assert streams[0].closed  # the try/finally held


def test_open_sink_prefers_explicit_pcm_path_then_sounddevice(
        monkeypatch, tmp_path):
    streams = _mock_sounddevice(monkeypatch)
    # No path: the real device wins when sounddevice can open one.
    sink, desc = audio.open_sink(SR, BLOCK)
    assert isinstance(sink, audio.SoundDeviceSink)
    assert "sounddevice" in desc
    assert len(streams) == 1
    sink.close()
    # An explicit PCM path wins over an available device.
    sink, desc = audio.open_sink(SR, BLOCK, pcm_path=str(tmp_path / "a.pcm"))
    assert isinstance(sink, audio.PCMFileSink)
    assert len(streams) == 1  # no second device open
    sink.close()


def test_open_sink_reports_reason_when_no_device(monkeypatch):
    _mock_sounddevice(monkeypatch, broken=True)
    sink, desc = audio.open_sink(SR, BLOCK)
    assert sink is None
    assert "_PortAudioError" in desc
    assert "audio start PCM_PATH" in desc  # actionable fallback


def test_device_error_mid_stream_surfaces_in_audio_status(
        tmp_path, monkeypatch):
    """Audio goes live on the sounddevice sink, the device dies
    mid-stream, and `audio status` names the error instead of a silent
    dead thread."""
    _mock_sounddevice(monkeypatch, fail_after=3)
    r, out = _repl(tmp_path, monkeypatch)
    r.dispatch("play A1")
    r.dispatch("render 0.2")  # render the path once before going live
    r.dispatch("audio start")
    try:
        assert "audio started -> sounddevice" in out.getvalue()
        deadline = time.time() + 10
        while time.time() < deadline and \
                (r.pump is None or r.pump.error is None):
            time.sleep(BS)
        assert isinstance(r.pump.error, _PortAudioError)
        r.dispatch("audio status")
        text = out.getvalue()
        assert "alive=False" in text
        assert "audio error: _PortAudioError('device unplugged')" in text
    finally:
        r.dispatch("audio stop")
    r.dispatch("quit")


# -- stall / command-wait feedback ----------------------------------------


def test_stall_notes_fire_while_a_render_holds_the_audio_thread():
    """A first kernel build or a capture can hold the audio thread inside
    one render; on_stall must fire periodically meanwhile and go quiet
    once blocks flow."""
    tracker = _tracker()
    tracker.play(WaveformId.program(0), _wave("$330 * 0.5"))
    tracker.render_block()  # later blocks are fast
    orig = tracker.render_block
    stall_once = threading.Event()

    def slow_render():
        if not stall_once.is_set():
            stall_once.set()
            time.sleep(0.6)
        return orig()

    tracker.render_block = slow_render
    notes = []
    pump = audio.StreamPump(tracker, FakeSink())
    pump.stall_note_after = 0.1
    pump.stall_note_every = 0.1
    pump.on_stall = notes.append
    pump.start()
    try:
        deadline = time.time() + 10
        while time.time() < deadline and len(notes) < 2:
            time.sleep(0.02)
        assert len(notes) >= 2, notes
        assert notes == sorted(notes)  # waited grows across notes
        assert notes[0] >= 0.1
        # Once the stall clears, notes stop accumulating.
        time.sleep(0.4)
        n = len(notes)
        time.sleep(0.4)
        assert len(notes) - n <= 1  # at most one in-flight straggler
    finally:
        pump.stop()
    tracker.close()


def test_call_progress_fires_while_a_command_waits():
    tracker = _tracker()
    tracker.play(WaveformId.program(0), _wave("$330 * 0.5"))
    tracker.render_block()
    pump = audio.StreamPump(tracker, FakeSink())
    pump.start()
    try:
        pump.post(lambda: time.sleep(0.5))  # occupies the audio thread
        waits = []
        got = pump.call(lambda: 42, timeout=10.0,
                        progress=waits.append, progress_interval=0.05)
        assert got == 42
        assert waits and waits == sorted(waits)
        assert waits[-1] >= 0.1  # it really waited behind the sleeper
    finally:
        pump.stop()
    tracker.close()


def test_repl_logs_compile_progress_while_play_holds_audio(
        tmp_path, monkeypatch):
    """A first play that holds the audio thread (on the card: the first
    nvcc build, a capture) says so, with elapsed seconds."""
    sink = FakeSink()
    monkeypatch.setattr(audio, "open_sink",
                        lambda sr, bl, pcm_path=None: (sink, "fake sink"))
    r, out = _repl(tmp_path, monkeypatch)
    r.dispatch("play A1")
    r.dispatch("render 0.2")
    r.dispatch("audio start")
    try:
        r.pump.stall_note_after = 0.1
        r.pump.stall_note_every = 0.1
        # The writer's wait in progress was armed with the old interval
        # (stall_note_after / 2 = 1 s): let a few blocks re-arm it.
        time.sleep(4 * BS)
        orig = r.tracker.render_block
        stalled = threading.Event()

        def compile_like_stall():
            if not stalled.is_set():
                stalled.set()
                time.sleep(0.5)
            return orig()

        r.tracker.render_block = compile_like_stall
        deadline = time.time() + 10
        while time.time() < deadline and \
                "compiling voice structure" not in out.getvalue():
            time.sleep(0.02)
        text = out.getvalue()
        assert "compiling voice structure" in text
        assert "nvcc" in text  # names what holds the thread on the card
    finally:
        r.dispatch("audio stop")
    r.dispatch("quit")


# -- the per-block handoff -------------------------------------------------


class _Event:
    """A staged copy's event on the CPU: records the threads that wait."""

    def __init__(self, waits):
        self.waits = waits

    def synchronize(self):
        self.waits.append(threading.current_thread().name)

    def query(self):
        return True


@pytest.mark.parametrize("sync_interval", [4, 8])
def test_writer_reads_staged_copies_and_the_audio_thread_never_waits(
        sync_interval, monkeypatch):
    """Every device block reaches the sink through a staged host copy
    (Tracker.stage_host on the audio thread, _staged_host on the writer):
    the only waits on a copy's event are the writer's, one a block, and
    the audio thread's steady renders read no tensor on the host.  The
    served blocks of a lookahead window share one copy."""
    waits, copies = [], []

    def staged_copy(x):
        copies.append((threading.current_thread().name, x.shape[0]))
        return (x.clone(), _Event(waits), x)

    monkeypatch.setattr(tracker_mod, "_start_host_copies", staged_copy)
    w = _wave("$330 * 0.5")
    tracker = _tracker(sync_interval=sync_interval)
    tracker.fuse_blocking = True
    tracker.play(WaveformId.program(0), w)
    twin = _tracker()
    twin.play(WaveformId.program(0), w)
    for t in (tracker, twin):
        for _ in range(3):
            t.render_block()
    render = tracker.render_block

    def checked():
        with _NoHostReads():
            return render()
    tracker.render_block = checked
    checked()  # the first dispatch mode in a process imports for seconds
    twin.render_block()
    waits.clear()
    copies.clear()
    sink = FakeSink()
    pump = audio.StreamPump(tracker, sink)
    pump.start()
    try:
        time.sleep(20 * BS)
    finally:
        pump.stop()
    assert pump.error is None
    n = pump.blocks_out
    assert n >= 12
    assert "tuun-audio" not in waits
    assert waits.count("tuun-pcm-writer") == n
    # The audio thread's copies: one a window (K blocks), not one a block.
    staged = [size for name, size in copies if name == "tuun-audio"]
    assert tracker.window_opens > 0
    assert any(size == sync_interval * BLOCK for size in staged)
    assert len(staged) < n
    np.testing.assert_allclose(sink.pcm(), _offline(twin, n), atol=1e-6)
    # The tap holds numpy that owns its memory.
    assert all(b.base is None for b in pump.tap)
    tracker.close()
    twin.close()


def test_stage_host_shares_a_window_copy():
    """Tracker.stage_host: a window's served blocks are slices of one
    staged copy; a host block is its own copy."""
    tracker = _tracker(sync_interval=4)
    tracker.fuse_blocking = True
    y, _ = tracker.render_block()  # no voice: host silence
    staged, lo, hi = tracker.stage_host(y)
    assert staged[0] is y and (lo, hi) == (0, BLOCK)
    tracker.play(WaveformId.program(0), _wave("$330 * 0.5"))
    handles = []
    for _ in range(16):
        y, _ = tracker.render_block()
        handles.append((tracker.stage_host(y), y))
    assert tracker.window_opens > 0
    by_copy = {}
    for (staged, lo, hi), y in handles:
        by_copy.setdefault(id(staged), []).append((lo, hi))
        np.testing.assert_array_equal(
            tracker_mod._staged_host(staged)[lo:hi], _host(y))
    windows = [spans for spans in by_copy.values() if len(spans) > 1]
    assert windows
    for spans in windows:
        assert spans == [(k * BLOCK, (k + 1) * BLOCK)
                         for k in range(len(spans))]
    tracker.close()

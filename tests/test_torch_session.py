"""The port's live session on the CPU: TuunSession, the Player's
scheduling and bakes, and the web session server.

  * Twins of every test in tests/test_session.py, of
    tests/test_reference_behaviors.py's note-off-at-release test, of
    tests/test_tracker.py's test_player_measures and test_level_db, and
    of tests/test_repl.py's async-bake flows (driven through the Player
    directly: sample rate 100, tempo 60, 20-sample blocks, as the REPL's
    tests run), each keeping its name.
  * The port's TuunSession against tuun_tpu's on one command script at
    8 kHz: the slider demos' vibrato, filter and gain programs with
    slider moves and a stop, and pm_piano_keys notes on and off.  Fast
    mode, the fused step on both sides (fuse_blocking): the mix within
    test_torch_stream.py's 8 * 2e-5 and the same dispatches every block.
  * Twins of tests/test_web_demo.py against the port's server on the CPU
    (device="cpu"), the same HTTP calls.
"""

import http.client
import json
import math
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import tuun_tpu
import tuun_tpu_torch
from tuun_tpu.session import TuunSession as JaxSession
from tuun_tpu_torch import ir
from tuun_tpu_torch.engine import precompute as precompute_mod
from tuun_tpu_torch.expr import TuunError
from tuun_tpu_torch.ids import MarkId, WaveformId
from tuun_tpu_torch.player import Player, db_to_amplitude
from tuun_tpu_torch.session import TuunSession
from tuun_tpu_torch.tools.web_demo import WEB_ROOT, TuunWebServer
from tuun_tpu_torch.tracker import Tracker

torch.set_num_threads(1)
CPU = "cpu"
STDLIB = Path(tuun_tpu_torch.__file__).resolve().parent / "stdlib" / "v0"
JAX_STDLIB = Path(tuun_tpu.__file__).resolve().parent / "stdlib" / "v0"


def make_session(sr=100, block=16, tempo=60, **kw):
    kw.setdefault("precision", "exact")
    kw.setdefault("jit", False)
    return TuunSession(sample_rate=sr, tempo=tempo, block_size=block,
                       library_root=STDLIB, device=CPU, **kw)


# -- twins of tests/test_session.py -----------------------------------------


def test_install_and_process():
    s = make_session()
    kind = s.install("$10 | fin(time - 1)")
    assert kind == "waveform"
    total = []
    while True:
        block = s.process()
        if block is None:
            break
        assert isinstance(block, np.ndarray) and block.dtype == np.float32
        total.append(block)
    mix = np.concatenate(total)
    expected = np.sin(math.tau * 10 * np.arange(100) / 100)
    np.testing.assert_allclose(mix[:100], expected, atol=1e-4)
    np.testing.assert_array_equal(mix[100:], 0.0)


def test_install_rejects_non_waveform():
    s = make_session()
    with pytest.raises(TuunError):
        s.install("42")


def test_install_replaces_previous():
    s = make_session()
    s.install("1 | fin(time - 10)")
    s.install("0.5 | fin(time - 1)")
    block = s.process()
    np.testing.assert_allclose(block, 0.5, atol=1e-6)


@pytest.mark.parametrize("sync_interval", [1, 4])
def test_slider_ramp(sync_interval):
    s = make_session(sync_interval=sync_interval)
    s.install("$10 * gain", sliders='["gain:1:0:1"]')
    b0 = s.process()
    s.update_slider("gain", 0.0)
    b1 = s.process()  # ramp block
    b2 = s.process()  # fully at 0
    assert isinstance(b1, np.ndarray)
    assert np.abs(b0).max() > 0.1
    np.testing.assert_allclose(b2, 0.0, atol=1e-6)
    # The ramp block interpolates: it ends near 0.
    assert np.abs(b1[-1]) < np.abs(b0).max()
    s.tracker.close()


def test_user_defined_slider_function():
    s = make_session()
    s.install("$freq", sliders='["freq:0.5:fn(x) => 10 + 10 * x"]')
    b = s.process()
    assert b is not None
    # freq at normalized 0.5 -> 15 Hz: about 2 * 15 crossings a second.
    chunks = [b] + [s.process() for _ in range(5)]
    mix = np.concatenate([c for c in chunks if c is not None])
    crossings = np.sum(np.diff(mix >= 0))
    assert crossings >= 20


def test_keys_note_on_off():
    s = make_session()
    kind = s.install(
        "fn(k, v) => (v * $(@k), 1 | fin(time - 0.1))", opens=("std",))
    assert kind == "keys"
    s.note_on(69, 127)  # A440 at full velocity (aliased at 100 Hz, fine)
    b = s.process()
    assert b is not None and np.abs(b).max() > 0
    s.note_off(69)
    # The note_off waveform (finite) splices under Terminator: voice ends.
    s.render_all(max_seconds=5)
    assert not s.tracker.active
    s.note_off(69)  # again: a no-op


def test_keys_requires_install():
    s = make_session()
    with pytest.raises(TuunError):
        s.note_on(60, 100)


def test_pm_piano_keys_instrument():
    s = make_session()
    kind = s.install("pm_piano_keys", opens=("std", "pm_synth"))
    assert kind == "keys"
    s.note_on(60, 100)
    b = s.process()
    assert b is not None
    s.note_off(60)
    s.render_all(max_seconds=3)
    assert not s.tracker.active


def test_parse_sliders_helper():
    from tuun_tpu_torch.session import parse_sliders
    out = parse_sliders(
        '["gain:0.5:0:1", "cutoff:0.5:fn(x) => 100 * pow(100, x)"]')
    assert out[0] == {"type": "linear", "label": "gain",
                      "initial_value": 0.5, "min": 0.0, "max": 1.0}
    u = out[1]
    assert u["type"] == "user-defined" and u["label"] == "cutoff"
    assert abs(u["initial_value"] - 1000.0) < 1.0
    assert abs(u["value_at_0"] - 100.0) < 0.01
    assert abs(u["value_at_1"] - 10000.0) < 1.0


def test_evaluate_slider_helper():
    from tuun_tpu_torch.session import evaluate_slider
    assert abs(evaluate_slider("fn(x) => 100 * pow(100, x)", 0.5)
               - 1000.0) < 1.0
    assert abs(evaluate_slider("fn(x) => x * 2", 0.25) - 0.5) < 1e-6


@pytest.mark.parametrize("sync_interval", [1, 4])
def test_session_steady_state_compiles_nothing(sync_interval):
    """Once an installed instrument is warm, process() builds nothing
    per block: no compiled structure, no session step, no capture (the
    port's counterpart of jax.log_compiles staying silent)."""
    s = TuunSession(sample_rate=100, tempo=60, block_size=16,
                    library_root=STDLIB, precision="fast", device=CPU,
                    sync_interval=sync_interval)
    s.tracker.fuse_blocking = True
    s.install("$10")
    for _ in range(8):
        s.process(16)
    t = s.tracker
    steps = {id(e["step"]) for e in t._fused_cache.values()}
    compiled, started = len(t.cache._cache), t.captures_started
    for _ in range(20):
        s.process(16)
    assert {id(e["step"]) for e in t._fused_cache.values()} == steps
    assert len(t.cache._cache) == compiled and t.captures_started == started
    s.stop()
    t.close()


# -- tests/test_reference_behaviors.py and test_tracker.py's Player tests ----


def test_note_off_reflects_slider_value_at_release_time():
    s = make_session()
    # The release tail's level tracks the `tail` slider at release time.
    s.install("fn(k, v) => (v * $(@k), tail | fin(time - 0.3))",
              sliders='["tail:1:0:1"]')
    s.note_on(60, 127)
    s.process()
    # Move the slider before releasing: the stored note_off must pick up
    # the value as of note_off(), not note_on().
    s.sliders.normalized_values[0] = 0.0
    s.note_off(60)
    out = s.render_all(max_seconds=2)
    assert len(out) >= 16
    assert np.abs(out).max() == 0.0
    assert not s.tracker.active


def fin_const(value, seconds):
    return ir.Fin(ir.BinaryPointOp(ir.Operator.SUBTRACT, ir.Time(),
                                   ir.Const(float(seconds))),
                  ir.Const(float(value)))


def make_tracker(sr=100, block=16, **kw):
    kw.setdefault("precision", "exact")
    return Tracker(sr, block, device=CPU, **kw)


def test_level_db():
    t = make_tracker()
    p = Player(t, 60, 4)
    p.play("a", fin_const(1.0, 0.16), level_db=-6.0)
    out, _ = t.render_block()
    np.testing.assert_allclose(out[0], db_to_amplitude(-6.0), rtol=1e-6)
    t.stop_all()


def test_player_measures():
    t = make_tracker(sr=100, block=10)
    p = Player(t, tempo=60, beats_per_measure=4)  # measure = 400 samples
    assert p.next_measure_start() == 400
    t.now = 400
    assert p.next_measure_start() == 800
    marks = p.beat_marks()
    assert any(m.mark_id == MarkId.TOP_LEVEL for m in marks)
    assert [m.start for m in marks if m.mark_id == MarkId.user(2)] == \
        [500, 900, 1300]


def test_play_at_next_measure_repeats():
    t = make_tracker(sr=100, block=20)
    p = Player(t, tempo=60, beats_per_measure=1)  # measure = 100 samples
    t.render_block()
    p.play("a", fin_const(1.0, 0.1), start_at_next_measure=True,
           repeat_after_measures=1)
    assert t.pending[0].start == 100 and t.pending[0].repeat_every == 100
    mix = np.concatenate([t.render_block()[0] for _ in range(14)])
    for k in (1, 2):  # samples 100-109 and 200-209 of the whole stream
        np.testing.assert_array_equal(mix[100 * k - 20:100 * k - 10], 1.0)
    assert np.count_nonzero(mix) == 20
    p.stop_all()
    assert not t.active and not t.pending


# -- the async bake flows of tests/test_repl.py ------------------------------


A1 = "$10 * 0.5"
A2 = "1 | fin(time - 0.5)"  # ones for 0.5 s


def _program(text):
    from tuun_tpu_torch.evaluator import Evaluator
    out = Evaluator(100, 60, STDLIB).evaluate_source(text, opens=("std",))
    return out.waveform


def make_player():
    """The REPL's setup: 100 Hz, tempo 60 (a 400-sample measure), 20-sample
    blocks, bakes on a worker."""
    t = make_tracker(sr=100, block=20)
    return Player(t, 60, 4, precompute=True, async_precompute=True)


def render(p, seconds):
    """The REPL's `render`: finished bakes pumped at every block boundary."""
    t = p.tracker
    out = []
    for _ in range(int(seconds * t.sample_rate) // t.block_size):
        p.pump()
        out.append(t.render_block()[0])
    return np.concatenate(out)


def test_async_precompute_next_measure(monkeypatch):
    """A next-measure play returns before its bake completes; the bake is
    pumped into the tracker at a later block boundary and the voice
    starts exactly at the measure fixed at play time."""
    baking = threading.Event()
    release = threading.Event()
    real = precompute_mod.precompute

    def slow_precompute(w, sample_rate, seed=0, cfg=None):
        baking.set()
        assert release.wait(timeout=10), "test never released the bake"
        return real(w, sample_rate, seed=seed, cfg=cfg)

    monkeypatch.setattr(precompute_mod, "precompute", slow_precompute)
    p = make_player()
    t0 = time.perf_counter()
    p.play(WaveformId.program(1), _program(A2), start_at_next_measure=True)
    latency = time.perf_counter() - t0
    assert baking.wait(timeout=10)
    assert latency < 0.5
    assert not p.tracker.pending and not p.tracker.active
    assert p.pending_bakes() == [(WaveformId.program(1), 400)]
    release.set()
    assert p.flush_bakes() == 1
    assert p.pending_bakes() == []
    assert p.tracker.pending and p.tracker.pending[0].start == 400
    mix = render(p, 5.0)
    assert np.allclose(mix[400:450], 1.0, atol=1e-6)
    assert np.allclose(mix[:400], 0.0) and np.allclose(mix[450:], 0.0)
    p.close()


def test_async_precompute_bake_failure_plays_unbaked(monkeypatch):
    def broken(w, sample_rate, seed=0, cfg=None):
        raise RuntimeError("bake exploded")

    monkeypatch.setattr(precompute_mod, "precompute", broken)
    p = make_player()
    p.play(WaveformId.program(1), _program(A2), start_at_next_measure=True)
    assert p.flush_bakes() == 1
    mix = render(p, 5.0)
    assert np.allclose(mix[400:450], 1.0, atol=1e-6)
    p.close()


def test_stop_cancels_inflight_async_bake(monkeypatch):
    """A stopped program must not come back to life when its next-measure
    bake completes after the stop."""
    release = threading.Event()
    real = precompute_mod.precompute

    def slow_precompute(w, sample_rate, seed=0, cfg=None):
        assert release.wait(timeout=10)
        return real(w, sample_rate, seed=seed, cfg=cfg)

    monkeypatch.setattr(precompute_mod, "precompute", slow_precompute)
    p = make_player()
    p.play(WaveformId.program(1), _program(A2), start_at_next_measure=True)
    p.stop_all()  # a global stop cancels the bake
    release.set()
    assert p.flush_bakes() == 0
    assert np.allclose(render(p, 5.0), 0.0)
    # A fresh play after the cancellation still works.
    p.play(WaveformId.program(1), _program(A2), start_at_next_measure=True)
    assert p.flush_bakes() == 1
    p.close()


def test_stop_one_cancels_only_that_programs_bake(monkeypatch):
    monkeypatch.setattr(precompute_mod, "precompute",
                        lambda w, sample_rate, seed=0, cfg=None: w)
    p = make_player()
    p.play(WaveformId.program(0), _program(A1), start_at_next_measure=True)
    p.play(WaveformId.program(1), _program(A2), start_at_next_measure=True)
    p._bake_in.join()  # both baked, not yet pumped
    p.stop(WaveformId.program(1))
    assert p.flush_bakes() == 1  # only the first survives
    assert [str(q.id) for q in p.tracker.pending] == ["program(0)"]
    p.close()


# -- the port's session against tuun_tpu's ------------------------------------


SESSION_SR = 8000
SESSION_BLOCK = 256
# The slider demos (examples/slider-demos.tuun): (expression, sliders,
# opens, moves as (block, label, normalized)).  The vibrato moves `depth`
# only: a `rate` move turns a constant frequency into a ramp, where the
# two packages' carries differ by design (test_torch_modify.py).
SESSION_SCRIPT = [
    ("sine(2*pi * 330, depth * sine(2*pi * $rate, 0))",
     '["rate:5:0.5:12", "depth:0.3:0:1"]', ("std",),
     [(3, "depth", 0.8), (7, "depth", 0.1)]),
    ("sawtooth(110) | lpf(Q, cutoff)",
     '["cutoff:0.5:fn(x) => 80 * pow(100, x)", "Q:0.707:0.2:2"]', ("std",),
     [(3, "cutoff", 0.3), (6, "Q", 0.9), (9, "cutoff", 0.6)]),
    ("$330 * gain", '["gain:0.4:0:1"]', ("std",),
     [(3, "gain", 0.9), (7, "gain", 0.2)]),
]
KEYS_SCRIPT = [(0, "on", 60), (0, "on", 64), (0, "on", 67), (4, "off", 64),
               (6, "off", 60), (7, "on", 72), (9, "off", 67), (10, "off", 72)]


def _drive(s):
    """Runs the command script: (mix, dispatches of every block)."""
    s.tracker.fuse_blocking = True
    out, disp = [], []
    render_block = s.tracker.render_block

    def recorded():
        y, status = render_block()
        disp.append(status.dispatches)
        return y, status
    s.tracker.render_block = recorded

    def block():
        y = s.process()
        if y is None:
            return False
        out.append(np.asarray(y, np.float64))
        return True

    for text, sliders, opens, moves in SESSION_SCRIPT:
        s.install(text, sliders=sliders, opens=opens)
        for k in range(12):
            for when, label, norm in moves:
                if when == k:
                    s.update_slider_normalized(label, norm)
            block()
        for wid in [v.id for v in s.tracker.active]:
            s.player.stop(wid)  # the package's own program id
        while block():
            pass
    s.install("pm_piano_keys", opens=("std", "pm_synth"))
    for k in range(14):
        for when, what, key in KEYS_SCRIPT:
            if when == k:
                s.note_on(key, 100) if what == "on" else s.note_off(key)
        block()
    while block():
        pass
    return np.concatenate(out), disp


def test_session_script_matches_jax_session():
    js = JaxSession(sample_rate=SESSION_SR, block_size=SESSION_BLOCK,
                    library_root=JAX_STDLIB, precision="fast", jit=True)
    want, jd = _drive(js)
    js.tracker.close()
    ps = TuunSession(sample_rate=SESSION_SR, block_size=SESSION_BLOCK,
                     precision="fast", device=CPU)
    got, pd = _drive(ps)
    assert len(got) == len(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=8 * 2e-5)
    assert pd == jd
    assert 1 in pd and not ps.tracker.active
    modifies = [op for op in ps.tracker.op_log if op[0] == "modify"]
    assert len(modifies) >= 10
    ps.tracker.close()


# -- twins of tests/test_web_demo.py ----------------------------------------


SR = 8000
BLOCK = 256


@pytest.fixture(scope="module")
def server():
    srv = TuunWebServer(("127.0.0.1", 0), sample_rate=SR, block_size=BLOCK,
                        precision="exact", jit=False, device=CPU)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield srv
    srv.shutdown()
    srv.server_close()


def conn(server):
    return http.client.HTTPConnection("127.0.0.1", server.server_port,
                                      timeout=30)


def post(server, path, body):
    c = conn(server)
    c.request("POST", path, json.dumps(body),
              {"Content-Type": "application/json"})
    r = c.getresponse()
    out = json.loads(r.read())
    c.close()
    return r.status, out


def read_stream(server, iid, n_samples):
    c = conn(server)
    c.request("GET", f"/api/stream?id={iid}")
    r = c.getresponse()
    data = b""
    while len(data) < 4 * n_samples:
        chunk = r.read(4 * BLOCK)
        if not chunk:
            break
        data += chunk
    c.close()
    return np.frombuffer(data[:4 * n_samples], dtype="<f4")


def test_static_pages(server):
    c = conn(server)
    c.request("GET", "/")
    r = c.getresponse()
    page = r.read().decode()
    assert r.status == 200 and "<tuun-synth" in page
    c.request("GET", "/tuun-synth.js")
    r = c.getresponse()
    js = r.read().decode()
    assert r.status == 200 and "registerProcessor" in js
    c.close()
    # The served assets are the repo's web/ files.
    assert WEB_ROOT == Path(tuun_tpu.__file__).resolve().parent.parent / "web"
    assert (WEB_ROOT / "index.html").exists()


def test_install_and_stream_matches_direct_session(server):
    status, out = post(server, "/api/install",
                       {"id": "t1", "expression": "$440 | fin(time - 0.5)"})
    assert status == 200
    assert out == {"kind": "waveform", "sliders": [], "sample_rate": SR}
    got = read_stream(server, "t1", SR // 2)
    assert len(got) == SR // 2
    expected = np.sin(math.tau * 440 * np.arange(SR // 2) / SR)
    np.testing.assert_allclose(got, expected, atol=1e-4)
    s = TuunSession(sample_rate=SR, block_size=BLOCK, precision="exact",
                    jit=False, device=CPU)
    s.install("$440 | fin(time - 0.5)")
    blocks = []
    while (b := s.process()) is not None:
        blocks.append(b)
    direct = np.concatenate(blocks)
    np.testing.assert_array_equal(got, direct[:SR // 2])


def test_stream_ends_when_the_piece_finishes(server):
    post(server, "/api/install",
         {"id": "t2", "expression": "1 | fin(time - 0.1)"})
    c = conn(server)
    c.request("GET", "/api/stream?id=t2")
    r = c.getresponse()
    data = r.read()  # must terminate on its own
    c.close()
    samples = np.frombuffer(data, dtype="<f4")
    assert np.count_nonzero(samples) == int(0.1 * SR)


def test_slider_install_reports_values_and_updates_ramp(server):
    status, out = post(server, "/api/install", {
        "id": "t3",
        "expression": "gain | fin(time - 10)",
        "sliders": '["gain:0.25:0:1"]'})
    assert status == 200 and out["kind"] == "waveform"
    assert out["sliders"] == [
        {"label": "gain", "normalized": 0.25, "value": 0.25}]
    # One stream across the slider change: 0.25 before, a one-block
    # monotonic ramp, then 1.0 (where the ramp lands depends on how far
    # the server has rendered ahead; its shape does not).
    c = conn(server)
    c.request("GET", "/api/stream?id=t3")
    r = c.getresponse()
    first = np.frombuffer(r.read(4 * BLOCK), dtype="<f4")
    np.testing.assert_allclose(first, 0.25, atol=1e-6)
    status, out = post(server, "/api/slider",
                       {"id": "t3", "label": "gain", "normalized": 1.0})
    assert status == 200 and out["value"] == pytest.approx(1.0)
    chunks = [first]
    for _ in range(50):
        chunk = np.frombuffer(r.read(4 * BLOCK), dtype="<f4")
        chunks.append(chunk)
        if len(chunk) and chunk[-1] == pytest.approx(1.0, abs=1e-6):
            break
    c.close()
    got = np.concatenate(chunks)
    assert got[-1] == pytest.approx(1.0, abs=1e-6)
    assert np.all(got >= 0.25 - 1e-6) and np.all(got <= 1.0 + 1e-6)
    assert np.all(np.diff(got) >= -1e-6)  # click-free: monotonic ramp up


def test_keys_install_note_on_off(server):
    status, out = post(server, "/api/install", {
        "id": "t4",
        "expression": "fn(k, v) => ($(110 * v) | fin(time - 5),"
                      " 0 | fin(time - 0))"})
    assert status == 200 and out["kind"] == "keys"
    status, _ = post(server, "/api/note_on",
                     {"id": "t4", "key": 60, "velocity": 127})
    assert status == 200
    got = read_stream(server, "t4", BLOCK)
    expected = np.sin(math.tau * 110 * np.arange(BLOCK) / SR)
    np.testing.assert_allclose(got, expected, atol=1e-4)
    status, _ = post(server, "/api/note_off", {"id": "t4", "key": 60})
    assert status == 200


def test_stop_supersedes_stream(server):
    post(server, "/api/install", {"id": "t5", "expression": "$220"})
    got = read_stream(server, "t5", BLOCK)
    assert np.abs(got).max() > 0.5
    status, out = post(server, "/api/stop", {"id": "t5"})
    assert status == 200 and out == {"ok": True}
    # A fresh stream for the stopped instance ends at once.
    c = conn(server)
    c.request("GET", "/api/stream?id=t5")
    r = c.getresponse()
    assert len(r.read()) == 0
    c.close()


def test_install_error_is_reported(server):
    status, out = post(server, "/api/install",
                       {"id": "t6", "expression": "1 +"})
    assert status == 400 and "error" in out


def test_matches_reference_web_example(server):
    """The repo's web/index.html lpf example installs and streams."""
    status, out = post(server, "/api/install", {
        "id": "t7",
        "expression": "square(220) | lpf(Q, cutoff)",
        "sliders": '["Q:0.707:0.1:1",'
                   '"cutoff:0.5886:fn(x) => 200 * pow(50, x)"]',
        "opens": ["std"]})
    assert status == 200 and out["kind"] == "waveform"
    labels = [s["label"] for s in out["sliders"]]
    assert labels == ["Q", "cutoff"]
    assert out["sliders"][1]["value"] == pytest.approx(
        200 * 50 ** 0.5886, rel=1e-3)
    got = read_stream(server, "t7", 2 * BLOCK)
    session = TuunSession(sample_rate=SR, block_size=BLOCK,
                          precision="exact", jit=False, device=CPU)
    session.install("square(220) | lpf(Q, cutoff)",
                    sliders='["Q:0.707:0.1:1",'
                            '"cutoff:0.5886:fn(x) => 200 * pow(50, x)"]')
    ref = np.concatenate([session.process(), session.process()])
    np.testing.assert_allclose(got, ref, atol=1e-6)


def test_unknown_id_is_404_and_creates_no_session(server):
    before = set(server.instances)
    status, out = post(server, "/api/slider",
                       {"id": "ghost", "label": "x", "normalized": 0.5})
    assert status == 404
    c = conn(server)
    c.request("GET", "/api/stream?id=ghost2")
    r = c.getresponse()
    assert r.status == 404
    r.read()
    c.close()
    assert set(server.instances) == before  # no sessions leaked


def test_keys_stream_carries_silence_between_notes(server):
    """A keys instrument idles between notes; its stream survives the
    gaps (carrying silence), so a note_on never races a stream
    restart."""
    status, out = post(server, "/api/install", {
        "id": "t8",
        "expression": "fn(k, v) => ($(220) * v | fin(time - 5),"
                      " 0 | fin(time - 0))"})
    assert status == 200 and out["kind"] == "keys"
    c = conn(server)
    c.request("GET", "/api/stream?id=t8")
    r = c.getresponse()
    quiet = np.frombuffer(r.read(4 * BLOCK), dtype="<f4")
    assert len(quiet) == BLOCK and np.all(quiet == 0.0)  # silence, not EOF
    post(server, "/api/note_on", {"id": "t8", "key": 60, "velocity": 127})
    for _ in range(20):
        got = np.frombuffer(r.read(4 * BLOCK), dtype="<f4")
        if np.abs(got).max() > 0.1:
            break
    else:
        raise AssertionError("note never reached the stream")
    post(server, "/api/note_off", {"id": "t8", "key": 60})
    c.close()


def test_instance_cap_evicts_oldest(server):
    from tuun_tpu_torch.tools import web_demo
    old_cap = web_demo.MAX_INSTANCES
    web_demo.MAX_INSTANCES = 4
    try:
        for i in range(6):
            post(server, "/api/install",
                 {"id": f"cap{i}", "expression": "$100 | fin(time - 9)"})
        assert len(server.instances) <= 4
        assert "cap0" not in server.instances
        # The survivor still streams.
        c = conn(server)
        c.request("GET", "/api/stream?id=cap5")
        r = c.getresponse()
        assert len(r.read(4 * BLOCK)) == 4 * BLOCK
        c.close()
    finally:
        web_demo.MAX_INSTANCES = old_cap


def test_concurrent_streams_stay_isolated(server):
    """Three elements streaming at once: each stream carries its own
    session's audio (per-instance locks serialize process(), sessions
    must not cross-talk)."""
    freqs = {"c1": 200, "c2": 300, "c3": 400}
    for iid, f in freqs.items():
        post(server, "/api/install",
             {"id": iid, "expression": f"${f} | fin(time - 4)"})
    results = {}
    errors = []

    def reader(iid):
        try:
            results[iid] = read_stream(server, iid, SR // 4)
        except Exception as exc:  # pragma: no cover
            errors.append((iid, exc))

    threads = [threading.Thread(target=reader, args=(iid,))
               for iid in freqs]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors
    for iid, f in freqs.items():
        got = results[iid]
        expected = np.sin(math.tau * f * np.arange(SR // 4) / SR)
        np.testing.assert_allclose(got, expected, atol=1e-4,
                                   err_msg=f"stream {iid} cross-talked")


def test_server_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        TuunWebServer(("127.0.0.1", 0))
    with pytest.raises(RuntimeError, match="cuda"):
        TuunSession()
    from tuun_tpu_torch.tools import web_demo
    assert web_demo.main(["--port", "0"]) == 2

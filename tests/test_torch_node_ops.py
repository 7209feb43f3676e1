"""The count of a captured step's device operations by engine node class
(engine/capture.py's NodeOps, `GraphStep.node_ops`), its markers
`tuun.engine.ops.<Class>:<n>` at each replay, and the benchmark's two
readers of them (portbench/metrics/engine.*_ops_per_block.offline.py).

On the CPU a step is a model of a CUDA graph capture (the captured body
recorded as GraphStep records it, then rerun at each replay), on the
benchmark's own configurations at a small size: the vibrato (three
sines, no envelope), in fast mode and in exact_df (its phases in
double-single arithmetic, counted apart as `GraphStep.df32_ops`), and the
PM piano (four sines, two min/max envelopes of time ramps)."""

import collections
import sys
import threading
import time
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

from tuun_tpu_torch import spans
from tuun_tpu_torch import tracker as T
from tuun_tpu_torch.engine import capture, df32
from tuun_tpu_torch.engine.capture import GraphStep
from tuun_tpu_torch.evaluator import Evaluator

PORTBENCH = Path(__file__).resolve().parent.parent / "portbench"
for _p in (str(PORTBENCH.parent), str(PORTBENCH)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import harness  # noqa: E402

torch.set_num_threads(1)
SR, BLOCK, K, VOICES = 44100, 64, 4, 3
MARKER = "tuun.engine.ops."


class AllOps(TorchDispatchMode):
    """Counts every operator dispatched on its thread that enqueues work
    on the CPU, as a CUDA graph holds a node for each kernel, copy or set:
    all but views and bare allocations.  With `attribute`, also by the
    class of the innermost engine node whose method is on the stack (an
    attribution independent of NodeOps' profile function: the innermost
    frame of a node's `render`)."""

    NO_WORK = ("empty", "empty_strided", "empty_like", "_unsafe_view",
               "lift_fresh")

    def __init__(self, attribute=False):
        super().__init__()
        self.n = 0
        self.attribute = attribute
        self.by_class = collections.Counter()
        self.in_df32 = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view and \
                func.overloadpacket.__name__ not in self.NO_WORK:
            self.n += 1
            if self.attribute:
                self.by_class[_innermost_node()] += 1
                self.in_df32 += _inside_df32()
        return out


def _inside_df32():
    """Whether a function of engine/df32.py is on the stack."""
    frame = sys._getframe(2)
    while frame is not None:
        if frame.f_code.co_filename == df32.__file__:
            return True
        frame = frame.f_back
    return False


def _innermost_node():
    frame = sys._getframe(2)
    while frame is not None:
        owner = frame.f_locals.get("self")
        if frame.f_code.co_name == "render" and \
                isinstance(owner, capture.Node):
            return type(owner).__name__
        frame = frame.f_back
    return capture.OTHER


class CountingModelStep(GraphStep):
    """A GraphStep on the CPU: the capture records the body as a CUDA
    graph capture does (GraphStep._recording), its operations counted by
    AllOps in the place of the graph's nodes, and each replay reruns the
    body on the static inputs into the same output buffers."""

    def capture(self):
        self.fn(self.static_params, self.static_states, self.scalars)
        with AllOps() as ops, self._recording(lambda: ops.n) as count:
            with count:
                self._out_spec, self._packed, self._layout = self._body()
        self._graph = "model"
        self.capture_seconds = 0.0

    def _replay(self):
        _, packed, _ = self._body()
        for dt, b in packed.items():
            self._packed[dt].copy_(b)


@pytest.fixture
def counted(monkeypatch):
    monkeypatch.setattr(T, "make_step", CountingModelStep)


def _tracker(config, blocks=4 * K):
    """VOICES voices of a benchmark configuration held from sample 0 in a
    Tracker with windows of K blocks (captures inline), `blocks` pulled."""
    cfg = harness.load_json(PORTBENCH / "configs" / f"{config}.json")
    voices = harness.draw_voices(cfg, VOICES, 4000000021)
    ev = Evaluator(SR, 90, harness.ROOT / "tuun_tpu_torch" / "stdlib" / "v0")
    t = T.Tracker(SR, BLOCK, precision=cfg["precision"], device="cpu",
                  sync_interval=K)
    t.fuse_blocking = True
    for i, w in enumerate(harness.compile_voices(cfg, voices, ev)):
        t.play(i, w, start=0)
    for _ in range(blocks):
        t.render_block()
    return t


def _window(t):
    """The captured window step (K blocks of lanes)."""
    wins = [e["step"] for k, e in t._fused_cache.items() if k[0] == "win"]
    assert len(wins) == 1 and wins[0].node_ops
    return wins[0]


@pytest.mark.parametrize("config", ["fm_vibrato", "pm_piano", "saw_lpf",
                                    "fm_vibrato_exact_df"])
def test_per_class_counts_add_up_to_every_operation(counted, config):
    """The per-class counts add up to every operation the step's body
    enqueues, and each class's count is what an attribution of each
    operator to the innermost node on the stack gives; the double-single
    count is what the operators dispatched with a df32 function on the
    stack give."""
    t = _tracker(config)
    try:
        step = _window(t)
        everything = AllOps(attribute=True)
        with everything:
            step._body()
        assert sum(step.node_ops.values()) == everything.n > 0
        assert step.node_ops == dict(everything.by_class)
        assert step.node_ops[capture.OTHER] > 0  # the mix and the packing
        assert step.df32_ops == everything.in_df32
    finally:
        t.close()


@pytest.mark.parametrize("config,df", [("fm_vibrato_exact_df", True),
                                       ("fm_vibrato", False),
                                       ("pm_piano", False)])
def test_df32_count_leaves_the_class_counts_as_they_were(counted, config,
                                                         df, monkeypatch):
    """The exact_df vibrato's step counts operations inside the
    double-single helpers, all of them under CSine (its three sines'
    phases); the fast steps count none.  A capture that watches no df32
    function counts every class as the one that watches them."""
    t = _tracker(config)
    try:
        step = _window(t)
        if df:
            assert 0 < step.df32_ops <= step.node_ops["CSine"]
        else:
            assert step.df32_ops == 0
        with_df = dict(step.node_ops)
    finally:
        t.close()
    monkeypatch.setattr(capture, "_df32_codes", set)
    t = _tracker(config)
    try:
        step = _window(t)
        assert step.node_ops == with_df and step.df32_ops == 0
    finally:
        t.close()


def test_df32_helpers_count_once_at_their_outermost_call():
    """A helper's operations count once, however deep the helpers nest
    (df_mod_tau calls df_mul and df_add, which call two_prod and
    two_sum), and a node's render counts them as its own too."""
    grown = [0]

    class Sine(capture.Node):
        def render(self):
            x = torch.ones(3)
            with AllOps() as ops:
                hi, lo = df32.df_mod_tau(x * 7.0, x * 1e-9)
                df32.df_sin(hi, lo)
            grown[0] += ops.n
            grown[0] += 2  # the render's own operations

    with capture.NodeOps(lambda: grown[0]) as count:
        Sine(None).render()
    assert count.counts == {"Sine": grown[0]}
    assert count.df32 == 0  # the growth came after the helpers returned
    assert _tools_free()

    with AllOps() as ops, capture.NodeOps(lambda: ops.n) as count:
        x = torch.ones(3)
        h, l = x * 7.0, x * 1e-9
        before = ops.n
        hi, lo = df32.df_mod_tau(h, l)
        df32.df_sin(hi, lo)
        inside = ops.n - before
        h + l  # outside every helper
    assert count.df32 == inside > 0
    assert count.counts == {capture.OTHER: ops.n}
    assert _tools_free()


def test_fm_counts_its_sines_and_no_envelope(counted):
    t = _tracker("fm_vibrato")
    try:
        ops = _window(t).node_ops
        assert ops["CSine"] > 0 and ops["CBinary"] > 0
        assert "CTime" not in ops and "CAlt" not in ops
        # the vibrato's running phase: one scan under CSine
        assert _window(t).scan_calls == (
            ("prefix_sum_rows_f32", VOICES, K * BLOCK, None),)
    finally:
        t.close()


def test_piano_counts_its_envelopes(counted):
    t = _tracker("pm_piano")
    try:
        step = _window(t)
        ops = step.node_ops
        # two envelopes of 12 time ramps and 6 alts each, four sines; the
        # shared subtrees leave one time ramp and four alts to render
        # (tests/test_torch_share.py), and count what they saved
        assert ops["CTime"] > 0 and ops["CAlt"] > 0 and ops["CSine"] > 0
        assert ops["CAlt"] % 4 == 0
        assert step.shared_renders == 111
        assert step.scan_calls == ()
    finally:
        t.close()


@pytest.mark.parametrize("config,saved", [("pm_piano", 111),
                                          ("fm_vibrato", 1),
                                          ("saw_lpf", 0)])
def test_replays_mark_the_renders_shared_subtrees_saved(counted, config,
                                                        saved):
    """The capture counts the node renders a window step's shared
    subtrees saved (a stored result returned counts its subtree's
    nodes), the compiled voice's own count for its one group render,
    and each replay under a session marks it as
    `tuun.engine.shared:<n>`, 0 included."""
    t = _tracker(config)
    try:
        step = _window(t)
        (group,) = t._groups
        assert step.shared_renders == group.compiled.shared_renders == saved
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for _ in range(2 * K):
                t.render_block()
                if t._prefetch is not None:
                    assert t._prefetch["done"].wait(10)
        got = [e.name for e in prof.events()
               if e.name.startswith("tuun.engine.shared:")]
        assert got and set(got) == {f"tuun.engine.shared:{saved}"}
    finally:
        t.close()


def test_nested_renders_count_their_own_operations():
    """A node's count is what the counter grew by in its render less its
    children's renders; the growth outside every render is OTHER's, and
    nothing is counted where the counter reads None."""
    grown = [0]

    class Outer(capture.Node):
        def render(self, inner):
            grown[0] += 2
            inner.render()
            inner.render()
            grown[0] += 1

    class Inner(capture.Node):
        def render(self):
            grown[0] += 3

    with capture.NodeOps(lambda: grown[0]) as count:
        grown[0] += 4
        Outer(None).render(Inner(None))
    assert count.counts == {"Outer": 3, "Inner": 6, capture.OTHER: 4}
    assert _tools_free()
    with capture.NodeOps(lambda: None) as idle:
        Outer(None).render(Inner(None))
    assert idle.counts == {} and _tools_free()
    # a counter that stops reading midway counts nothing
    reads = iter([0, 1, None, 5, 6, 7])
    with capture.NodeOps(lambda: next(reads)) as lost:
        Inner(None).render()
    assert lost.counts == {} and _tools_free()


def test_renders_on_another_thread_count_nothing():
    """A capture counts its own thread's renders: the thread serving
    blocks meanwhile adds nothing."""
    grown = [0]

    class Busy(capture.Node):
        def render(self):
            grown[0] += 1

    with capture.NodeOps(lambda: grown[0]) as count:
        other = threading.Thread(target=Busy(None).render)
        other.start()
        other.join(timeout=10)
        assert not other.is_alive()
    assert count.counts == {capture.OTHER: 1}


def _tools_free():
    return all(sys.monitoring.get_tool(i) is None for i in (3, 4))


def _markers(prof):
    return [e.name[len(MARKER):] for e in prof.events()
            if e.name.startswith(MARKER)]


def test_replays_under_a_session_mark_one_marker_per_class(counted):
    t = _tracker("pm_piano")
    try:
        step = _window(t)
        want = sorted(f"{c}:{n}" for c, n in step.node_ops.items())
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            step.mark()
        assert sorted(_markers(prof)) == want
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for _ in range(2 * K):
                t.render_block()
                if t._prefetch is not None:
                    assert t._prefetch["done"].wait(10)
        got = collections.Counter(_markers(prof))
        # each window handed to the prefetch (or replayed inline) marks
        # every class once, with the capture's count
        assert got and set(got) == set(want)
        assert len(set(got.values())) == 1
    finally:
        t.close()


@pytest.mark.parametrize("config", ["fm_vibrato_exact_df", "pm_piano"])
def test_replays_mark_the_df32_count_beside_the_classes(counted, config):
    """Each window handed to the prefetch, or replayed inline, marks
    `tuun.engine.df32:<n>` once with the capture's count: 0 in a fast
    step, not nothing."""
    t = _tracker(config)
    try:
        step = _window(t)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for _ in range(2 * K):
                t.render_block()
                if t._prefetch is not None:
                    assert t._prefetch["done"].wait(10)
        names = [e.name for e in prof.events()]
        df = [n for n in names if n.startswith("tuun.engine.df32:")]
        assert df and set(df) == {f"tuun.engine.df32:{step.df32_ops}"}
        assert len(df) == names.count(f"{MARKER}CSine:"
                                      f"{step.node_ops['CSine']}")
        assert (step.df32_ops > 0) == (config == "fm_vibrato_exact_df")
    finally:
        t.close()


def test_no_session_marks_nothing_and_counts_nothing(counted, monkeypatch):
    t = _tracker("pm_piano")
    try:
        step = _window(t)
        before = dict(step.node_ops)
        marked = []
        monkeypatch.setattr(spans, "mark", marked.append)
        for _ in range(2 * K):
            t.render_block()
        assert t.replays > 0 and marked == []
        assert step.node_ops == before
        # no counting hook is left
        assert _tools_free()
    finally:
        t.close()


# -- the readers -------------------------------------------------------------

SERVE, WORKER = 1, 2


def _run(host, slice_us=(0.0, 1000.0), window_lanes=1 << 20):
    run = harness.Run(
        cell="pm_piano.offline", config={}, traffic={}, sample_rate=44100,
        block_size=65536, voices=256, window_lanes=window_lanes,
        device_kind="x", setup_s=1.0, frontend_s=0.1, capture_seconds=[0.2],
        blocks=64, wall_s=1.0, block_latencies_s=[], counters={},
        peaks={"hbm_bytes_per_s": 3.35e12})
    host = [("portbench.slice", *slice_us, SERVE)] + list(host)
    run.trace = harness.Trace([], host, slice_us, 64, {})
    return run


def _read(name, run):
    return harness.metric_reader(name).read(run)


def _window_markers(at, ops):
    return [(f"{MARKER}{c}:{n}", at, at, SERVE) for c, n in ops.items()]


PIANO = {"CSine": 124, "CTime": 216, "CAlt": 48, "CBinary": 236,
         "other": 10}


@pytest.mark.parametrize("windows", [4, 5])
def test_readers_on_a_synthetic_slice(windows):
    """Four windows marked at their submit, or five where one window was
    replayed inline: the same reading, the ops of one window over its 16
    blocks; markers outside the slice count nothing."""
    host = [m for i in range(windows)
            for m in _window_markers(100.0 + 150 * i, PIANO)]
    host += _window_markers(1500.0, {"CSine": 999, "CTime": 999})
    host += [("tuun.scan.prefix_sum_rows_f32:256x1048576", 50.0, 50.0,
              SERVE), ("tuun.engine.replay", 10.0, 20.0, SERVE)]
    run = _run(host)
    assert _read("engine.sine_ops_per_block.offline", run) == 124 / 16
    assert _read("engine.time_alt_ops_per_block.offline", run) == \
        (216 + 48) / 16


def test_readers_read_nothing_without_markers():
    """The parent's program, or a cell whose voices hold no such node."""
    bare = _run([("tuun.engine.replay", 10.0, 20.0, SERVE)])
    assert _read("engine.sine_ops_per_block.offline", bare) is None
    assert _read("engine.time_alt_ops_per_block.offline", bare) is None
    fm = _run(_window_markers(100.0, {"CSine": 75, "CBinary": 8}))
    assert _read("engine.sine_ops_per_block.offline", fm) == 75 / 16
    assert _read("engine.time_alt_ops_per_block.offline", fm) is None
    untraced = _run([])
    untraced.trace = None
    assert _read("engine.sine_ops_per_block.offline", untraced) is None


def test_readers_read_a_recorded_run(counted):
    """A tiny traced run of the piano's cell through the harness on the
    CPU, its windows captured as a model: the readers read the markers
    the program left, at the window step's own counts."""
    cell = harness.load_cell(harness.ROOT, "pm_piano.offline")
    tiny = {"voices": VOICES, "block_size": BLOCK, "sync_interval": K,
            "compare_blocks": 4, "pace_blocks": 8, "trace_blocks": 4 * K}
    res = harness.run_cell(cell, 4000000023, 0.2, True, time.perf_counter(),
                           device="cpu", overrides=tiny)
    run = res["run"]
    assert res["checks"]["correct"] is True
    sine = _read("engine.sine_ops_per_block.offline", run)
    time_alt = _read("engine.time_alt_ops_per_block.offline", run)
    names = [h[0] for h in run.trace.host_events
             if h[0].startswith(MARKER)]
    counts = {}
    for name in names:
        cls, _, n = name[len(MARKER):].rpartition(":")
        counts.setdefault(cls, set()).add(int(n))
    assert all(len(v) == 1 for v in counts.values())
    one = {c: v.pop() for c, v in counts.items()}
    assert sine == one["CSine"] / K
    assert time_alt == (one["CTime"] + one["CAlt"]) / K
    line = harness.result_line(cell, res, trace=True)
    assert {"engine.sine_ops_per_block.offline",
            "engine.time_alt_ops_per_block.offline"} <= set(line["metrics"])

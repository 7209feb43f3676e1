"""The port's spans on the profiler's clock (tuun_tpu_torch/spans.py), on
the CPU.

  * With no profiler session a span enters no record_function, and the
    tracker's op_log keeps its phases (the activation's `build` split
    into compile, params and init).
  * Under a CPU profile() session a tiny offline run_to_completion shows
    the tracker's spans nested as the tracker's docstring lists them,
    one window_open per window opened, and its scan markers carry the
    shapes of the run: (voices, block lanes) per block, (voices, K x
    block lanes) per window.
  * A session that records every thread keeps the workers' spans.
  * On the modelled captured path (a GraphStep whose replay reruns the
    captured body), a capture keeps its scan calls, and the serving
    thread marks them where it hands a window to the prefetch worker.
  * tools/profile.py's CPU census counts the same operators with a span
    around the block.
"""

import collections

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from test_torch_stream import ModelStep, fin_const
from tuun_tpu_torch import ir, spans
from tuun_tpu_torch import tracker as T
from tuun_tpu_torch.engine import kernels, scan_ops
from tuun_tpu_torch.ids import WaveformId
from tuun_tpu_torch.player import build_top_level_waveform
from tuun_tpu_torch.tools import profile as profile_tool
from tuun_tpu_torch.tracker import Tracker

torch.set_num_threads(1)
CPU = "cpu"
P = WaveformId.program
BLOCK = 16
K = 4

# Where each tracker span may sit: its nearest tuun. ancestor (None: at
# the top of the serving thread).
PARENTS = {
    "tracker.run_to_completion": {None},
    "tracker.render_block": {"tracker.run_to_completion", None},
    "tracker.flush": {"tracker.run_to_completion"},
    "tracker.concat": {"tracker.run_to_completion"},
    "tracker.copy_wait": {"tracker.run_to_completion", "tracker.sync",
                          "tracker.materialize"},
    "tracker.stage_host": {None},
    "tracker.activate": {"tracker.render_block"},
    "tracker.compile": {"tracker.activate"},
    "tracker.params": {"tracker.activate"},
    "tracker.init": {"tracker.activate"},
    "tracker.lits": {"tracker.activate"},
    "tracker.length": {"tracker.activate"},
    "tracker.materialize": {"tracker.render_block"},
    "tracker.regroup": {"tracker.render_block"},
    "tracker.window_open": {"tracker.render_block"},
    "tracker.prefetch_wait": {"tracker.window_open"},
    "tracker.window_dispatch": {"tracker.window_open"},
    "tracker.prefetch_submit": {"tracker.window_open"},
    "tracker.window_serve": {"tracker.render_block"},
    "tracker.window_finalize": {"tracker.render_block"},
    "tracker.fused_render": {"tracker.render_block"},
    "tracker.pervoice_render": {"tracker.render_block"},
    "tracker.group_render": {"tracker.pervoice_render"},
    "tracker.sync": {"tracker.render_block"},
    "tracker.stage_pending": {"tracker.sync", "tracker.materialize"},
    "tracker.retire": {"tracker.sync", "tracker.materialize"},
    "tracker.play": {None},
    "tracker.marks": {"tracker.play"},
    "capture.step": {"tracker.fused_render", "tracker.window_open",
                     "tracker.render_block"},
    "engine.replay": {"tracker.fused_render", "tracker.window_dispatch"},
}


def fm(f):
    """A voice whose phase is a running sum (its frequency moves): fast
    mode's prefix-sum scan."""
    freq = ir.BinaryPointOp(ir.Operator.ADD, ir.Const(f),
                            ir.Sine(ir.Const(2.0), ir.Const(0.0)))
    return build_top_level_waveform(ir.Sine(freq, ir.Const(0.0)), 0.0)


def _tracker():
    """Two FM voices (one group) and a finite voice that retires after
    block 7; windows of K blocks."""
    t = Tracker(100, BLOCK, precision="fast", device=CPU, sync_interval=K)
    t.fuse_blocking = True
    t.play(P(0), fm(3.0))
    t.play(P(1), fm(7.0))
    t.play(P(2), build_top_level_waveform(fin_const(0.25, 1.2), 0.0))
    return t


def _tuun(prof):
    """Every tuun. event of the session, with its nearest tuun. ancestor's
    name (None at the top), both without the prefix."""
    out = []
    for e in prof.events():
        if not e.name.startswith(spans.PREFIX):
            continue
        p = e.cpu_parent
        while p is not None and not p.name.startswith(spans.PREFIX):
            p = p.cpu_parent
        out.append((e.name[len(spans.PREFIX):],
                    None if p is None else p.name[len(spans.PREFIX):]))
    return out


def _markers(events, parent=None):
    return collections.Counter(
        name for name, p in events if name.startswith("scan.")
        and (parent is None or p == parent))


def test_span_times_its_phase_and_enters_nothing_without_a_session(
        monkeypatch):
    entered = []
    monkeypatch.setattr(spans, "record_function",
                        lambda *a: entered.append(a))
    phases = {}
    for _ in range(2):
        with spans.span("tracker.carry", phases):
            pass
    with spans.span("tracker.prefetch_wait", phases, "adopt", 3):
        pass
    spans.mark("scan.x:1x1")
    assert set(phases) == {"carry", "adopt"} and phases["carry"] > 0
    assert entered == [] and not spans.traced()
    # a span that times nothing is one shared no-op without a session
    assert spans.span("tracker.sync") is spans.span("tracker.flush")
    # the serving thread's whole path: plays, activations, windows, a
    # modify, a retirement, the host copies
    t = _tracker()
    mix = t.run_to_completion(max_seconds=1.0)
    t.modify(P(0), "none", ir.Const(1.0))  # no mark: a no-op
    t.play(P(3), fm(5.0), start=0)  # late: it catches up at activation
    y, _ = t.render_block()
    t.stage_host(y)
    t.close()
    assert mix.size and entered == []
    keys = collections.defaultdict(set)
    for op, _, total, phases in t.op_log:
        assert total >= sum(phases.values()) - 1e-9
        keys[op].add(frozenset(phases))
    assert keys["play"] == {frozenset({"marks"})}
    assert keys["activate"] == {
        frozenset({"compile", "params", "init", "lits", "length"}),
        frozenset({"compile", "params", "init", "lits", "length",
                   "catchup"})}
    assert all(k <= {"adopt", "dispatch"} for k in keys["window"])


def test_modify_phases_are_its_spans():
    t = Tracker(100, BLOCK, precision="fast", device=CPU)
    t.play("a", build_top_level_waveform(ir.BinaryPointOp(
        ir.Operator.MULTIPLY, ir.Sine(ir.Const(5.0), ir.Const(0.0)),
        ir.Marked("gain", ir.Const(1.0))), 0.0))
    t.render_block()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t.modify("a", "gain", ir.Const(0.5))
    t.close()
    phases = t.op_log[-1][3]
    assert set(phases) == {"interrupt", "materialize", "splice", "carry",
                           "marks"}
    got = collections.Counter(p for name, p in _tuun(prof)
                              if name[len("tracker."):] in phases)
    assert got == {"tracker.modify": len(phases)}


def test_offline_run_shows_the_spans_nested_as_listed():
    t = _tracker()
    opens = t.window_opens
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        mix = t.run_to_completion(max_seconds=2.0)
        t.play(P(4), fm(5.0))
        y, _ = t.render_block()
        t.stage_host(y)
    t.close()
    assert mix.size == 13 * BLOCK  # max_seconds: 2 s at 100 Hz
    events = _tuun(prof)
    names = collections.Counter(name for name, _ in events)
    for name, parent in events:
        if not name.startswith("scan."):
            assert parent in PARENTS[name], (name, parent)
    # every span of the offline path ran (the first window renders
    # inline: no prefetch ran before it)
    assert set(PARENTS) - {"capture.step", "engine.replay"} <= set(names)
    assert names["tracker.run_to_completion"] == 1
    assert names["tracker.concat"] == 1 and names["tracker.retire"] >= 1
    assert names["tracker.window_open"] == t.window_opens - opens >= 2
    assert names["tracker.window_open"] == names["tracker.prefetch_wait"]
    # the scans' shapes: the group of two voices by K blocks in a window;
    # by the block on the per-voice path, two voices and then three once
    # the last play joins the group
    assert _markers(events, "tracker.window_dispatch") and set(
        _markers(events, "tracker.window_dispatch")) == {
        f"scan.prefix_sum_rows_f32:2x{K * BLOCK}"}
    assert set(_markers(events, "tracker.group_render")) == {
        f"scan.prefix_sum_rows_f32:2x{BLOCK}",
        f"scan.prefix_sum_rows_f32:3x{BLOCK}"}


def test_a_session_of_every_thread_keeps_the_workers_spans():
    """The prefetch and fetch workers enter their spans under any
    session; a default session does not record their threads, one that
    records every thread does."""
    t = _tracker()
    config = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=config) as prof:
        t.run_to_completion(max_seconds=2.0)
    t.close()
    by_thread = collections.defaultdict(set)
    for e in prof.events():
        if e.name.startswith(spans.PREFIX):
            by_thread[e.thread].add(e.name[len(spans.PREFIX):])
    serve = [th for th, names in by_thread.items()
             if "tracker.run_to_completion" in names]
    assert len(serve) == 1
    workers = set().union(*(names for th, names in by_thread.items()
                            if th != serve[0]))
    assert {"prefetch.window", "fetch.copy_wait"} <= workers
    assert not any(n.startswith("tracker.") for n in workers)


class RecordingModelStep(ModelStep):
    """ModelStep whose capture keeps the scan calls it recorded, as a
    GraphStep's does."""

    def capture(self):
        self.fn(self.static_params, self.static_states, self.scalars)
        with kernels.graph_scope(self._scratch_owner, record=True) as rec:
            self._out_spec, self._packed, self._layout = self._body()
        self._graph = "model"
        self.scan_calls = tuple(rec)


def test_captured_windows_mark_their_scans_at_submit(monkeypatch):
    monkeypatch.setattr(T, "make_step", RecordingModelStep)
    t = _tracker()
    t.play(P(3), fm(11.0), start=200)  # after the finite voice retires
    for _ in range(20):  # past the retirement: a steady set of three
        t.render_block()
    window = [s for s in t._fused_cache.values()
              if s["step"].scan_calls and s["step"].scan_calls[0][1:3] ==
              (3, K * BLOCK)]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(4 * K):
            t.render_block()
            if t._prefetch is not None:
                assert t._prefetch["done"].wait(10)
    t.close()
    # the capture kept its one scan call
    assert [s["step"].scan_calls for s in window] == [
        (("prefix_sum_rows_f32", 3, K * BLOCK, None),)]
    events = _tuun(prof)
    names = collections.Counter(name for name, _ in events)
    at_submit = _markers(events, "tracker.prefetch_submit")
    assert names["tracker.prefetch_submit"] >= 3
    assert at_submit == {f"scan.prefix_sum_rows_f32:3x{K * BLOCK}":
                         names["tracker.prefetch_submit"]}
    assert t.prefetch_hits >= 3


def test_profile_census_counts_the_operators_under_a_span():
    x = torch.arange(64, dtype=torch.float32)

    def block():
        torch.cumsum(x * 2 + 1, 0).sum()

    def spanned():
        with spans.span("tracker.render_block"):
            with spans.span("tracker.pervoice_render"):
                block()

    plain = profile_tool.block_census(torch, kernels, block,
                                      torch.device(CPU))
    inner = profile_tool.block_census(torch, kernels, spanned,
                                      torch.device(CPU))
    assert plain["events"] == inner["events"] >= 4
    assert plain["top"] == inner["top"]


def test_scan_calls_mark_their_shapes():
    x = torch.ones(3, 40)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        scan_ops.prefix_sum_rows_f32(x)
        scan_ops.prefix_max_f32(x[0])
        scan_ops.affine_scan_f32(torch.zeros(40, 2), x[0],
                                 torch.ones(40, dtype=torch.bool),
                                 torch.zeros(2))
        torch.func.vmap(scan_ops.prefix_sum_f32)(x)
    got = _markers(_tuun(prof))
    assert got == {"scan.prefix_sum_rows_f32:3x40": 2,
                   "scan.prefix_max_f32:1x40": 1,
                   "scan.affine_scan_f32:1x40:J2": 1}
    with kernels.graph_scope(object(), record=True) as rec:
        scan_ops.prefix_sum_rows_f32(x)
    assert rec == [("prefix_sum_rows_f32", 3, 40, None)]
    assert kernels.call_marker(("linear_recurrence_f64", 1, 7, 12)) == \
        "scan.linear_recurrence_f64:1x7:J12"
    np.testing.assert_array_equal(scan_ops.prefix_sum_rows_f32(x)[:, -1],
                                  np.full(3, 40.0))

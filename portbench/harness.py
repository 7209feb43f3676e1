"""The port's benchmark: one run of one cell of BENCHMARK.json.

A cell names a configuration (`configs/<config>.json`: an instrument
program of Tuun source, its per-voice parameters, sample rate and
precision) and a traffic mix (`traffic/<mix>.json`: how many voices,
the block size, the sync interval, how blocks are pulled).  A run

  1. loads the cell's files by name;
  2. draws every voice's parameters from --seed;
  3. compiles each voice's source through the port's front end, plays
     every voice on a `tuun_tpu_torch.tracker.Tracker` built as the CLI
     builds it, at sample 0, and pulls blocks as the mix does until the
     steady path is engaged (the fused step and the lookahead window
     captured, windows opening from the prefetch);
  4. pulls blocks for --seconds as the mix says (an offline render: one
     `run_to_completion` of as many blocks as the set-up's pace fills
     the time with; a live loop: one block at a time until the time is
     up), every block's mix read on the host, with no capture inside;
  5. judges a sample of the window's blocks, drawn from the seed over
     the whole window, and its last block, against the configuration's
     plain reference (`reference/<config>.py`), by the limits of
     `limits/<cell>.json`;
  6. prints the result: with --trace 0 the cell's end-to-end metrics,
     with --trace 1 its per-layer metrics, each read by its own reader
     `metrics/<metric>.py` from a `Run`.

Everything a later cell, mix or metric needs is a file of its own that
this module finds by name; nothing here names a cell.
"""

from __future__ import annotations

import collections
import dataclasses
import gc
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
for _p in (str(ROOT), str(HERE)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import census  # noqa: E402
# Top-level module names that may not be loaded in a run, compared whole.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "tuun_tpu")
# The harness's host spans in a trace are named with this prefix.
SPAN_PREFIX = "portbench."
# Set-up pulls at most this many blocks before it gives up on the steady
# path.
MAX_WARM_BLOCKS = 2000


class BenchError(RuntimeError):
    """A run that cannot produce a result (exit code 1)."""


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """The module in `path`, loaded under `name` (file names of metrics
    hold dots, so they are loaded by path)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise BenchError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """One workload of BENCHMARK.json with its files loaded."""
    name: str
    spec: Dict[str, Any]
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    limits: Dict[str, Any]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]


def _reports(metric: Dict[str, Any], cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: Path, name: str) -> Cell:
    """The workload `name` of root/BENCHMARK.json, its configuration,
    traffic mix and limits, and the metrics it reports."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise BenchError(f"no workload {name!r} in BENCHMARK.json")
    spec = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / configs[spec["config"]]["file"])
    traffic = load_json(HERE / "traffic" / f"{spec['traffic']}.json")
    limits = load_json(HERE / "limits" / f"{name}.json")
    return Cell(name, spec, config, traffic, limits,
                [m for m in bench["end_to_end"] if _reports(m, name)],
                [m for m in bench["per_layer"] if _reports(m, name)])


def metric_reader(name: str):
    return load_module(HERE / "metrics" / f"{name}.py",
                       f"portbench_metric_{name.replace('.', '_')}")


def reference_module(config: str):
    return load_module(HERE / "reference" / f"{config}.py",
                       f"portbench_reference_{config}")


# -- the voices -----------------------------------------------------------


def draw_voices(config: Dict[str, Any], count: int, seed: int
                ) -> List[Dict[str, float]]:
    """Each voice's parameters, from the seed: every parameter of the
    configuration drawn for all voices at once, in the order the file
    lists them, each rounded to float32 (the language's numbers)."""
    rng = np.random.default_rng(seed % (1 << 64))
    columns = {}
    for pname, rule in config["params"].items():
        lo, hi = rule["range"]
        u = rng.uniform(lo, hi, count)
        if rule["kind"] == "midi":
            u = 440.0 * 2.0 ** ((u - 69.0) / 12.0)
        elif rule["kind"] != "uniform":
            raise BenchError(f"unknown parameter kind {rule['kind']!r}")
        columns[pname] = u.astype(np.float32)
    return [{p: float(col[i]) for p, col in columns.items()}
            for i in range(count)]


def voice_source(config: Dict[str, Any], voice: Dict[str, float]) -> str:
    """The voice's program: the configuration's source with each
    parameter written as the float32 it holds (repr round-trips)."""
    return config["program"].format(**{k: repr(v) for k, v in voice.items()})


def compile_voices(config, voices, evaluator):
    """Each voice's source as optimized IR, as the CLI turns an
    expression into what it plays."""
    from tuun_tpu_torch import optimizer
    from tuun_tpu_torch.expr import ESeq, EWaveform
    out = []
    opens = tuple(config.get("opens", ("std",)))
    for v in voices:
        value = evaluator.evaluate_source(voice_source(config, v), opens=opens)
        if isinstance(value, ESeq):
            value = value.waveform
        if not isinstance(value, EWaveform):
            raise BenchError("a voice's program is not a waveform")
        out.append(optimizer.optimize(value.waveform))
    return out


# -- what a run measured, for the metric readers --------------------------


@dataclasses.dataclass
class Trace:
    """The traced slice at the start of the window: device events as
    (name, start_us, end_us) on the profiler's clock, the slice's own
    span on that clock, and the blocks it pulled."""
    device_events: List[tuple]
    host_events: List[tuple]
    slice_us: tuple
    blocks: int
    launches: Dict[str, int]

    @property
    def wall_s(self) -> float:
        return (self.slice_us[1] - self.slice_us[0]) / 1e6


@dataclasses.dataclass
class Run:
    """Everything a metric reader may read."""
    cell: str
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    sample_rate: int
    block_size: int
    voices: int
    window_lanes: int            # lanes a lookahead window renders (the
                                 # tracker's default: sync_interval blocks)
    device_kind: str
    setup_s: float
    frontend_s: float
    capture_seconds: List[float]
    blocks: int                  # blocks of the window on the host
    wall_s: float                # the window, from its first pull to the
                                 # last block on the host
    block_latencies_s: List[float]
    counters: Dict[str, float]   # the program's counters over the window
    trace: Optional[Trace] = None
    peaks: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def audio_s(self) -> float:
        return self.blocks * self.block_size / self.sample_rate


# -- pulling blocks -------------------------------------------------------


@dataclasses.dataclass
class Pulled:
    """The blocks of one pull: the sample index of the first, each
    block's mix on the host [blocks, n], and for a closed loop each
    block's latency and the program's dispatches."""
    start: int
    mix: np.ndarray
    latencies: List[float]
    dispatches: int


def pull_whole(tracker, blocks: int, span=None, clock=None) -> Pulled:
    """`blocks` blocks as an offline render pulls them: one
    Tracker.run_to_completion, as the CLI's --render-out calls it (every
    voice here is held, so it renders all of them).  `clock(rows)` is
    called as each block lands on the host."""
    n, sr = tracker.block_size, tracker.sample_rate
    k0 = tracker.now
    with (span or _no_span)(SPAN_PREFIX + "run_to_completion"):
        mix = tracker.run_to_completion(
            max_seconds=(blocks - 0.5) * n / sr,
            sink=None if clock is None else lambda row: clock(1))
    if mix.size != blocks * n:
        raise BenchError(f"run_to_completion rendered {mix.size} samples, "
                         f"not {blocks} blocks of {n}")
    return Pulled(k0, mix.reshape(blocks, n), [], 0)


def pull_closed_loop(tracker, blocks: Optional[int] = None,
                     until: Optional[float] = None, span=None,
                     clock=None) -> Pulled:
    """Blocks one at a time, as an audio pump's producer renders ahead:
    render_block, stage_host and the block read on the host before the
    next is asked for, `blocks` of them or until the host clock reads
    `until`.  A block's latency runs from its render_block call to its
    samples on the host."""
    from tuun_tpu_torch.tracker import _staged_host
    span = span or _no_span
    k0 = tracker.now
    rows: List[np.ndarray] = []
    latencies: List[float] = []
    dispatches = 0
    while True:
        t0 = time.perf_counter()
        if (blocks is not None and len(rows) >= blocks) or \
                (until is not None and t0 >= until):
            break
        with span(SPAN_PREFIX + "render_block"):
            y, status = tracker.render_block()
        with span(SPAN_PREFIX + "stage_host"):
            staged, lo, hi = tracker.stage_host(y)
        with span(SPAN_PREFIX + "read_host"):
            rows.append(np.array(_staged_host(staged)[lo:hi], np.float32))
        latencies.append(time.perf_counter() - t0)
        dispatches += status.dispatches
        if clock is not None:
            clock(1)
    mix = np.stack(rows) if rows else np.zeros((0, tracker.block_size),
                                               np.float32)
    return Pulled(k0, mix, latencies, dispatches)


PULLS = {"run_to_completion": pull_whole, "closed_loop": pull_closed_loop}


class _NoSpan:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _no_span(name: str):
    return _NoSpan()


def compared_blocks(blocks: int, k: int, seed: int) -> List[int]:
    """The indices of the window's blocks to compare: `k` drawn from the
    seed without replacement over the whole window, and its last."""
    if blocks <= 0:
        return []
    rng = np.random.default_rng((seed + 0x5EED) % (1 << 64))
    drawn = rng.choice(blocks, min(k, blocks), replace=False)
    return sorted(set(int(i) for i in drawn) | {blocks - 1})


class Ticks:
    """Blocks on the host by each second of the window."""

    def __init__(self, t0: float):
        self.done = 0
        self.next = t0 + 1.0
        self.per_second: List[int] = []

    def __call__(self, rows: int) -> None:
        self.done += rows
        now = time.perf_counter()
        while now >= self.next:
            self.per_second.append(self.done)
            self.next += 1.0


# -- the device's trace ---------------------------------------------------


def short_name(name: str) -> str:
    """A device kernel's name without its return type, namespaces and
    argument list (copied from tuun_tpu_torch/tools/profile.py)."""
    for junk in ("void ", "at::native::", "(anonymous namespace)::",
                 "std::"):
        name = name.replace(junk, "")
    depth = 0
    for i, c in enumerate(name):
        depth += (c == "<") - (c == ">")
        if c == "(" and depth == 0:
            name = name[:i].rstrip()
            break
    return name if len(name) <= 72 else name[:69] + "..."


def collect_trace(prof, blocks: int, launches: Dict[str, int]) -> Trace:
    """The traced slice's device and host events from a finished
    torch.profiler session.  The profiler mirrors each host span
    (record_function) onto the device's timeline as a user annotation:
    those are not device work and are left out."""
    from torch.autograd import DeviceType
    device, host = [], []
    slice_us = None
    for e in prof.events():
        tr = e.time_range
        if e.device_type == DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False) and \
                    not e.name.startswith(SPAN_PREFIX):
                device.append((e.name, tr.start, tr.end))
        elif e.device_type == DeviceType.CPU:
            if e.name == SPAN_PREFIX + "slice":
                slice_us = (tr.start, tr.end)
            host.append((e.name, tr.start, tr.end, e.thread))
    if slice_us is None:
        raise BenchError("the trace holds no portbench.slice span")
    return Trace(device, host, slice_us, blocks, launches)


def breakdown(trace: Trace) -> Dict[str, List[list]]:
    """The device operations that took most time, and the longest idle
    gaps named by what the serving thread was doing in them (the
    innermost host event of the slice's thread covering the gap's
    middle)."""
    by_name: Dict[str, float] = collections.defaultdict(float)
    lo, hi = trace.slice_us
    for name, a, b in trace.device_events:
        a, b = max(a, lo), min(b, hi)
        if b > a:
            by_name[short_name(name)] += (b - a) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    main = [h for h in trace.host_events if h[0] == SPAN_PREFIX + "slice"]
    thread = main[0][3] if main else None
    host = [h for h in trace.host_events if h[3] == thread
            and h[0] != SPAN_PREFIX + "slice"]
    gaps = []
    for a, b in census.idle_gaps(
            [(s, e) for _, s, e in trace.device_events], lo, hi)[:10]:
        mid = (a + b) / 2
        covering = [h for h in host if h[1] <= mid <= h[2]]
        covering.sort(key=lambda h: h[2] - h[1])
        label = " < ".join(h[0] for h in covering[:2]) or "idle"
        gaps.append([label, (b - a) / 1e6])
    return {"device_ops": [list(kv) for kv in ops], "idle_gaps": gaps}


# -- the run ----------------------------------------------------------------


def forbidden_loaded() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN_MODULES))


def power_limit_w() -> Optional[float]:
    """The card's power limit, as nvidia-smi reads it (a roofline share
    is stated beside it), or None where it cannot be read."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30).stdout.split()
        return float(out[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        return None


def _peak_table(kind: str) -> Dict[str, Any]:
    return load_json(HERE / "peaks.json").get(kind, {})


def _warm(tracker, mix: Dict[str, Any], captured: bool) -> None:
    """Pulls as the mix does until the steady path serves: every capture
    started has finished (on the card at least two: the fused step and
    the window), and three windows have opened since, so the next
    window's prefetch has been adopted.  Only the tracker's public
    counters are read."""
    pull = PULLS[mix["pull"]]
    step = int(mix["sync_interval"])
    seen = None
    for _ in range(0, MAX_WARM_BLOCKS, step):
        pull(tracker, blocks=step)
        busy = tracker.captures_started != tracker.captures_finished
        if busy or (captured and tracker.captures_finished < 2):
            seen = None
            continue
        if seen is None:
            seen = tracker.window_opens
        elif tracker.window_opens - seen >= 3:
            return
    raise BenchError(f"the steady path was not engaged after "
                     f"{MAX_WARM_BLOCKS} blocks")


def _window_blocks(tracker, mix: Dict[str, Any], seconds: float) -> int:
    """The blocks an offline window renders: the pace of `pace_blocks`
    blocks pulled as the window pulls them, times `seconds`, in whole
    sync windows.  The window is a fixed amount of audio, so the timed
    work does not hang on the host clock's reading of when to stop."""
    step = int(mix["sync_interval"])
    b = int(mix["pace_blocks"])
    t0 = time.perf_counter()
    pull_whole(tracker, b)
    pace = b / max(time.perf_counter() - t0, 1e-9)
    return max(step, step * math.ceil(pace * seconds / step))


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             t_start: float, device: str = "cuda",
             overrides: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """One run of `cell`; returns the result's fields (see main).
    `overrides` replaces entries of the traffic mix (tests run cells at
    a tiny size on the CPU with it)."""
    import torch
    from tuun_tpu_torch.engine import scan_ops
    from tuun_tpu_torch.evaluator import Evaluator
    from tuun_tpu_torch.tracker import Tracker

    config = cell.config
    traffic = dict(cell.traffic, **(overrides or {}))
    sr = int(config["sample_rate"])
    n = int(traffic["block_size"])
    V = int(traffic["voices"])
    cuda = device != "cpu"
    dev = torch.device(device)
    closed = traffic["pull"] == "closed_loop"
    if traffic["pull"] not in PULLS:
        raise BenchError(f"unknown pull {traffic['pull']!r}")

    voices = draw_voices(config, V, seed)
    t0 = time.perf_counter()
    evaluator = Evaluator(sr, 90, ROOT / "tuun_tpu_torch" / "stdlib" / "v0")
    programs = compile_voices(config, voices, evaluator)
    frontend_s = time.perf_counter() - t0

    # as the CLI builds it: the tracker's defaults but for the block size
    # and the sync interval
    tracker = Tracker(sr, n, precision=config["precision"], device=dev,
                      sync_interval=int(traffic["sync_interval"]))
    for i, w in enumerate(programs):
        tracker.play(i, w, start=0)
    try:
        _warm(tracker, traffic, captured=cuda)
        if not closed:
            blocks = _window_blocks(tracker, traffic, seconds)
        if cuda:
            torch.cuda.synchronize(dev)

        trace_result = None
        if trace:
            from torch.profiler import ProfilerActivity, profile, \
                record_function
            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if cuda else [])
            trace_blocks = int(traffic["trace_blocks"])
            l0 = dict(scan_ops.launches)
            with profile(activities=acts) as prof:
                with record_function(SPAN_PREFIX + "slice"):
                    PULLS[traffic["pull"]](tracker, blocks=trace_blocks,
                                           span=record_function)
                    if cuda:
                        torch.cuda.synchronize(dev)
            trace_result = (prof, trace_blocks,
                            {k: scan_ops.launches[k] - l0[k] for k in l0})

        before = _counters(tracker)
        t_window = time.perf_counter()
        setup_s = t_window - t_start
        ticks = Ticks(t_window)
        if closed:
            window = pull_closed_loop(tracker, until=t_window + seconds,
                                      clock=ticks)
        else:
            window = pull_whole(tracker, blocks, clock=ticks)
        wall_s = time.perf_counter() - t_window

        after = _counters(tracker)
        if after["captures_started"] != before["captures_started"]:
            raise BenchError("a capture started inside the timed window")
        counters = {k: after[k] - before[k] for k in after}
        counters["dispatches"] = window.dispatches
        capture_seconds = list(tracker.capture_seconds)
        memory_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
        kind = torch.cuda.get_device_name(dev) if cuda else "cpu"
    finally:
        tracker.close()
    del tracker, programs
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    done = window.mix.shape[0]
    run = Run(cell=cell.name, config=config, traffic=traffic,
              sample_rate=sr, block_size=n, voices=V,
              window_lanes=n * int(traffic["sync_interval"]),
              device_kind=kind,
              setup_s=setup_s, frontend_s=frontend_s,
              capture_seconds=capture_seconds, blocks=done,
              wall_s=wall_s, block_latencies_s=window.latencies,
              counters=counters,
              peaks=_peak_table(kind))
    if trace_result is not None:
        prof, tb, tl = trace_result
        run.trace = collect_trace(prof, tb, tl)

    print(f"portbench: counters {json.dumps(counters)}; blocks on the host "
          f"by each second {ticks.per_second}", file=sys.stderr)
    t_ref = time.perf_counter()
    idx = compared_blocks(done, int(traffic["compare_blocks"]), seed)
    starts = [window.start + i * n for i in idx]
    got = window.mix[idx]
    del window
    checks = judge(cell, voices, starts, got, n, sr, device)
    print(f"portbench: window {wall_s:.3f} s, {done} blocks; "
          f"reference {time.perf_counter() - t_ref:.3f} s", file=sys.stderr)
    return {"run": run, "checks": checks, "voices": voices,
            "memory_peak": memory_peak, "attempted": done,
            "failed": checks["failed"]}


def _counters(tracker) -> Dict[str, float]:
    """The tracker's public counters of its session steps."""
    return {"captures_started": tracker.captures_started,
            "captures_finished": tracker.captures_finished,
            "replays": tracker.replays,
            "window_opens": tracker.window_opens}


# -- correctness ------------------------------------------------------------


def mix_error(program: np.ndarray, reference: np.ndarray) -> float:
    """The widest gap between the program's mix and the reference's over
    the compared blocks, as a share of the reference mix's rms there."""
    rms = math.sqrt(float(np.mean(np.square(reference))))
    return float(np.max(np.abs(program - reference))) / max(rms, 1e-30)


def judge(cell: Cell, voices, starts: Sequence[int], got: np.ndarray,
          n: int, sr: int, device: str,
          reference: Optional[np.ndarray] = None) -> Dict[str, Any]:
    """Compares the blocks `got` [len(starts), n], which start at the
    samples `starts`, with the configuration's reference (computed here
    unless given)."""
    limit = float(cell.limits["mix_err"])
    if not len(starts):
        return {"mix_err": math.inf, "limit": limit, "blocks": 0,
                "starts": [], "reference": None, "correct": False,
                "failed": 1}
    if reference is None:
        reference = reference_module(cell.config["name"]).mix_blocks(
            voices, starts, n, sr, device=device)
    got = np.asarray(got, np.float64)
    finite = bool(np.isfinite(got).all())
    err = mix_error(got, reference) if finite else math.inf
    per_block = [mix_error(g, w) for g, w in zip(got, reference)] \
        if finite else [math.inf] * len(starts)
    return {"mix_err": err, "limit": limit, "blocks": len(starts),
            "starts": list(starts), "reference": reference,
            "correct": finite and err <= limit,
            "failed": sum(not e <= limit for e in per_block)}


# -- the result -------------------------------------------------------------


def metrics_of(run: Run, metrics: Sequence[Dict[str, Any]]
               ) -> Dict[str, Dict[str, Any]]:
    """Each metric its reader finds something to read for."""
    out = {}
    for m in metrics:
        value = metric_reader(m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def result_line(cell: Cell, res: Dict[str, Any], trace: bool
                ) -> Dict[str, Any]:
    run: Run = res["run"]
    checks = res["checks"]
    device = {"platform": "gpu" if run.device_kind != "cpu" else "cpu",
              "kind": run.device_kind, "count": int(cell.spec["chips"]),
              "memory_peak_bytes": int(res["memory_peak"])}
    line: Dict[str, Any] = {"correct": bool(checks["correct"]),
                            "attempted": int(res["attempted"]),
                            "failed": int(res["failed"])}
    if trace:
        tr = run.trace
        device["busy_s"] = census.busy_seconds(
            [(s, e) for _, s, e in tr.device_events], *tr.slice_us)
        device["window_s"] = tr.wall_s
        if run.device_kind != "cpu":
            device["power_limit_w"] = power_limit_w()
        line["metrics"] = metrics_of(run, cell.per_layer)
        line["breakdown"] = breakdown(tr)
    else:
        line["metrics"] = metrics_of(run, cell.end_to_end)
    line["device"] = device
    line["check"] = {"mix_err": {"value": checks["mix_err"],
                                 "limit": checks["limit"]}}
    return line


def print_checks(checks: Dict[str, Any]) -> None:
    print(f"compared {checks['blocks']} blocks", file=sys.stderr)
    print(f"mix_err {checks['mix_err']!r} limit {checks['limit']!r}",
          file=sys.stderr)


def main(args, t_start: float) -> int:
    import torch
    try:
        cell = load_cell(ROOT, args.workload)
    except (OSError, KeyError, ValueError, BenchError) as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 1
    chips = int(cell.spec["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    try:
        res = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                       t_start)
    except BenchError as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 1
    loaded = forbidden_loaded()
    if loaded:
        print(f"portbench: forbidden modules loaded: {', '.join(loaded)}",
              file=sys.stderr)
        return 3
    line = result_line(cell, res, bool(args.trace))
    print_checks(res["checks"])
    sys.stdout.flush()
    print(json.dumps(line))
    return 0

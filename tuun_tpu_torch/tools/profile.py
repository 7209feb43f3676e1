"""Block-timing and launch-structure profiler for engine graphs.

Port of tuun_tpu/tools/profile.py, redesigned for torch: where the JAX
tool reads the compiled module's HLO, this one counts what one block
launches under torch.profiler.

Usage:
    python -m tuun_tpu_torch.tools.profile --expr 'harmonica(1.0, 440)' \
        --open std [--block 131072] [--sample_rate 48000] [--blocks 12] \
        [--precision fast] [--device cpu]

Prints, for the block render of the expression (on the card unless
--device cpu asks for the CPU):
  * the first block's time, which includes building the kernels;
  * steady-state block timing (--blocks pipelined calls, one sync) and
    the implied throughput / x-realtime at --sample_rate;
  * one block's launch structure, the analogue of the HLO census: the
    device events it ran (kernels, copies, sets; on the CPU the top-level
    operators) and the six most frequent names; the hand-written kernels
    it launched, by their wrappers' counts (engine/kernels.py), beside
    the number of those kernels the profiler saw; the device's busy time
    against the block's wall time under the profiler.
The census is taken in a second profiler session after a warm one: a
process's first session has lost a kernel record.
"""

from __future__ import annotations

import argparse
import collections
import json
import sys
import time
from pathlib import Path

def short_name(name: str) -> str:
    """A device kernel's name without its return type, namespaces and
    argument list (CUDA kernels' names carry their whole signature)."""
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


def _sync(torch, device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def block_census(torch, kernels, block, device) -> dict:
    """One call of block() under torch.profiler, after a warm session:
    the device events (or outermost CPU aten operators) and their most
    frequent names (short_name), the wrappers' launches, the hand-written
    kernels the profiler saw, busy and wall milliseconds."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    cuda = device.type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    for _ in range(2):  # the first session warms the profiler
        before = dict(kernels.launches)
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            block()
            _sync(torch, device)
            wall = time.perf_counter() - t0
    launched = {k: c - before[k] for k, c in kernels.launches.items()
                if c != before[k]}
    events = prof.events()
    if cuda:
        work = [e for e in events if e.device_type == DeviceType.CUDA]
    else:
        # The outermost aten operators: under a span (spans.py) or
        # another non-aten range an operator still counts, as it does
        # at the top level.
        work = [e for e in events if e.device_type == DeviceType.CPU
                and e.name.startswith("aten::")
                and not (e.cpu_parent is not None
                         and e.cpu_parent.name.startswith("aten::"))]
    spans = sorted((e.time_range.start, e.time_range.end) for e in work)
    busy, end = 0.0, float("-inf")
    for a, b in spans:  # the union of the intervals, in microseconds
        if b > end:
            busy += b - max(a, end)
            end = b
    names = collections.Counter(short_name(e.name) for e in work)
    symbols = set(kernels.KERNEL_SYMBOLS.values())
    seen = sum(c for name, c in names.items()
               if any(k in name for k in symbols))
    return {"events": len(work),
            "top": dict(names.most_common(6)),
            "launched": launched, "profiler_saw": seen,
            "busy_ms": busy / 1e3, "wall_ms": wall * 1e3}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tuun-tpu-torch-profile")
    p.add_argument("--expr", required=True)
    p.add_argument("--open", action="append", default=None, dest="opens")
    p.add_argument("--block", type=int, default=1 << 17)
    p.add_argument("--sample_rate", type=int, default=48000)
    p.add_argument("--blocks", type=int, default=12)
    p.add_argument("--precision", default="fast",
                   choices=("fast", "exact", "exact_df"))
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)

    import torch

    from .. import optimizer
    from ..engine import kernels
    from ..engine.graph import CompiledVoice, EngineConfig
    from ..evaluator import Evaluator
    from ..expr import ESeq, EWaveform

    lib = Path(__file__).resolve().parent.parent / "stdlib" / "v0"
    ev = Evaluator(args.sample_rate, 120, lib)
    value = ev.evaluate_source(args.expr,
                               opens=tuple(args.opens or ("std",)))
    if isinstance(value, ESeq):
        value = value.waveform
    if not isinstance(value, EWaveform):
        print("expression did not evaluate to a waveform", file=sys.stderr)
        return 1
    w = optimizer.optimize(value.waveform)

    cfg = EngineConfig(args.sample_rate, args.precision, args.device)
    voice = CompiledVoice(w, cfg)
    device = cfg.device
    P = voice.params()
    n = args.block
    fn = voice.render_fn(n, P=P)
    s = torch.zeros((), dtype=torch.int64, device=device)
    e = torch.full((), n, dtype=torch.int64, device=device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"

    t0 = time.perf_counter()
    state = voice.init(P)
    y, v, state, _ = fn(P, state, s, e)
    _sync(torch, device)
    print(f"compile+first block: {time.perf_counter() - t0:.1f}s "
          f"(device={name})")

    state = voice.init(P)
    t0 = time.perf_counter()
    for _ in range(args.blocks):
        y, v, state, _ = fn(P, state, s, e)
    _sync(torch, device)
    dt = (time.perf_counter() - t0) / args.blocks
    sps = n / dt
    print(f"steady block: {dt * 1e3:.3f} ms -> {sps / 1e6:.1f} Msamples/s "
          f"({sps / args.sample_rate:.0f}x realtime@{args.sample_rate})")

    box = [state]

    def block():
        box[0] = fn(P, box[0], s, e)[2]
    c = block_census(torch, kernels, block, device)
    what = "device events" if device.type == "cuda" else "cpu operators"
    print(f"{what}: {c['events']}/block  top: {json.dumps(c['top'])}")
    print(f"hand-written kernels: {json.dumps(c['launched'])}  "
          f"profiler saw: {c['profiler_saw']} of "
          f"{sum(c['launched'].values())}")
    print(f"device busy: {c['busy_ms']:.3f} ms of {c['wall_ms']:.3f} ms "
          f"wall ({100 * c['busy_ms'] / max(c['wall_ms'], 1e-9):.1f}%)")
    return 0


if __name__ == "__main__":
    sys.exit(main())

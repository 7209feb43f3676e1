"""Command-line batch renderer on PyTorch.

Port of tuun_tpu/cli.py with the same flags (main.rs:33-66 plus the
TPU build's extensions), except that `--platform` becomes
`--device {cuda,cpu}` (default cuda; a CUDA request without a card is an
error, never a silent CPU run).  Parses the input file or `--expr`,
plays each program on the tracker, and renders blocks until every
waveform finishes; captures stream to float32 WAVs, `--render-out` writes
the mix.

The tracker streams at sync_interval=16, as tuun_tpu/cli.py:135 runs its
jitted path: valid ends resolve every 16 blocks, the fused session step
and 16-block lookahead windows engage once the voice set is stable (on
the card, as CUDA graph replays).

`--ui true` launches the live-coding REPL (repl.py) on `--device`, as
tuun_tpu/cli.py:112-124 does.  `--precision` picks one of the engine's
three precisions, on either device: fast (the default: u32 NCO, f32 FM
phase, the affine-scan IIR), exact (the reference's f64 phase and its
sequential IIR) or exact_df (the exact semantics in float32: a
double-single phase and the sequential IIR).  `--no-jit` is accepted for
flag parity and has no effect: the port has no unjitted debug path to
select.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

from . import eval as eval_mod
from . import ir, optimizer, parser
from .diagnostics import Source
from .evaluator import Evaluator
from .expr import BOpen, ESeq, EWaveform, SourceBinding
from .ids import WaveformId
from .player import Player
from .programs import ProgramSet
from .tracker import Tracker
from .wav import write_wav_f32

DEFAULT_LIBRARY = Path(__file__).resolve().parent / "stdlib" / "v0"
# Blocks between host syncs of the batch render (tuun_tpu/cli.py:135).
STREAM_SYNC_INTERVAL = 16


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tuun-tpu-torch", description="Tuun batch renderer on PyTorch")
    p.add_argument("--tempo", type=int, default=90)
    p.add_argument("--beats_per_measure", type=int, default=4)
    p.add_argument("--sample_rate", type=int, default=44100)
    p.add_argument("--buffer_size", type=int, default=1024)
    p.add_argument("--date_format", default="_%Y-%m-%d_%H-%M-%S")
    p.add_argument("--precompute", default="true", choices=["true", "false"])
    p.add_argument("--ui", default="false", choices=["true", "false"],
                   help="true: the live-coding REPL instead of a batch "
                        "render")
    p.add_argument("--library_root", type=Path, default=None)
    p.add_argument("input_file", nargs="?", default=None)
    p.add_argument("-O", "--output_dir", default=".")
    p.add_argument("-p", "--expr", default=None,
                   help="render this expression instead of an input file")
    p.add_argument("--open", action="append", default=None, dest="opens",
                   help="modules to open for --expr (default: std)")
    p.add_argument("--all-bindings", action="store_true")
    p.add_argument("--render-out", default=None)
    p.add_argument("--duration", type=float, default=600.0,
                   help="maximum seconds to render")
    p.add_argument("--precision", default="fast",
                   choices=["fast", "exact", "exact_df"],
                   help="fast: u32 NCO, f32 FM phase, the affine-scan IIR; "
                        "exact: f64 phase and the sequential IIR; "
                        "exact_df: double-single (two-float) phase and the "
                        "sequential IIR")
    p.add_argument("--no-jit", action="store_true",
                   help="accepted for flag parity; no effect")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--dump", action="store_true")
    p.add_argument("--quiet", action="store_true")
    return p


def resolve_library_root(args) -> Path:
    if args.library_root is not None:
        return args.library_root
    local = Path("./lib/v0")
    if local.is_dir():
        return local
    return DEFAULT_LIBRARY


def _as_waveform(value):
    if isinstance(value, ESeq):
        value = value.waveform
    return value.waveform if isinstance(value, EWaveform) else None


def main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("error: --device cuda requested but torch.cuda.is_available() "
              "is false (use --device cpu for a CPU render)", file=sys.stderr)
        return 2
    if args.input_file is None and args.expr is None:
        print("error: provide an input file or --expr", file=sys.stderr)
        return 2

    if args.ui == "true":
        # The interactive surface is the live-coding REPL (the
        # reference's --ui launches its SDL2 window).
        from .repl import Repl
        repl = Repl(sample_rate=args.sample_rate, tempo=args.tempo,
                    beats_per_measure=args.beats_per_measure,
                    buffer_size=args.buffer_size,
                    library_root=resolve_library_root(args),
                    precision=args.precision, jit=not args.no_jit,
                    device=args.device)
        if args.input_file:
            repl.dispatch(f"load {args.input_file}")
        repl.run()
        return 0

    evaluator = Evaluator(args.sample_rate, args.tempo,
                          resolve_library_root(args))
    tracker = Tracker(args.sample_rate, args.buffer_size,
                      captured_output_dir=args.output_dir,
                      captured_date_format=args.date_format,
                      precision=args.precision, device=args.device,
                      sync_interval=STREAM_SYNC_INTERVAL)
    try:
        return _run(args, evaluator, tracker)
    finally:
        # Stops the tracker's workers and waits for a capture in progress.
        tracker.close()


def _run(args, evaluator, tracker) -> int:
    log = (lambda *a: None) if args.quiet else print
    player = Player(tracker, args.tempo, args.beats_per_measure,
                    precompute=args.precompute == "true")

    played = 0
    opens = tuple(args.opens) if args.opens else ("std",)
    if args.expr is not None:
        try:
            value = evaluator.evaluate_source(args.expr, opens=opens)
        except Exception as e:
            print(f"Error: {e}", file=sys.stderr)
            return 1
        w = _as_waveform(value)
        if w is None:
            print("Error: expression did not evaluate to a waveform",
                  file=sys.stderr)
            return 1
        if args.dump:
            print(ir.format_waveform(optimizer.optimize(w)))
        log("Playing expression")
        player.play(WaveformId.program(0), w)
        played += 1
    elif args.input_file.endswith(".tuunp"):
        # A program-list file: one expression per line, `//` comments and
        # blank lines skipped.
        try:
            lines = Path(args.input_file).read_text().split("\n")
        except OSError as e:
            print(f"Failed to read input_file: {e}", file=sys.stderr)
            return 1
        for lineno, line in enumerate(lines, 1):
            text = line.strip()
            if not text or text.startswith("//"):
                continue
            try:
                value = evaluator.evaluate_source(text, opens=opens)
            except Exception as e:
                print(f"{args.input_file}:{lineno}: Error: {e}",
                      file=sys.stderr)
                continue
            w = _as_waveform(value)
            if w is None:
                log(f"line {lineno} did not evaluate to a waveform")
                continue
            log(f"Playing line {lineno}: {text[:60]}")
            if args.dump:
                print(ir.format_waveform(optimizer.optimize(w)))
            player.play(WaveformId.program(lineno), w)
            played += 1
    else:
        try:
            source = Path(args.input_file).read_text()
        except OSError as e:
            print(f"Failed to read input_file: {e}", file=sys.stderr)
            return 1
        program_set, message = ProgramSet.from_source(
            source, Path(args.input_file), all_bindings=args.all_bindings)
        log("Starting in non-UI mode")
        if message:
            print(message)
        for index, program in enumerate(program_set.programs):
            if program.is_empty():
                continue
            name = program_set.display_name(index)
            log(f"Playing program {name}: {program.text}")
            bindings = [SourceBinding(BOpen(("__prelude",)))]
            bindings += [SourceBinding(BOpen(tuple(o.split("."))))
                         for o in (args.opens or [])]
            bindings += program_set.evaluation_bindings(index)
            try:
                expr = parser.parse_program(program.text, Source.program())
                value = eval_mod.evaluate(evaluator.resolve, bindings, expr)
            except Exception as e:
                diag = evaluator.diagnose(
                    e, program_text=program.text, file_text=source) \
                    if hasattr(e, "span") else None
                print(f"Error: {diag if diag else e}", file=sys.stderr)
                return 1
            w = _as_waveform(value)
            if w is None:
                log(f"Program {name} did not evaluate to a waveform")
                continue
            if args.dump:
                print(ir.format_waveform(optimizer.optimize(w)))
            player.play(WaveformId.program(index), w,
                        level_db=program.level_db,
                        sliders=program.sliders.configs,
                        normalized=program.sliders.normalized_values)
            played += 1

    if played == 0:
        log("Nothing to play")
        return 0

    chunks = []
    sink = chunks.append if args.render_out else None
    mixed = tracker.run_to_completion(max_seconds=args.duration, sink=sink)
    # Voices still running at the duration cap: stop them so captures
    # flush to their WAV files.
    tracker.stop_all()
    # Trim to the exact final sample when every voice's length was known,
    # else keep one buffer past the last non-zero sample.
    end = tracker.known_end
    if end:
        mixed = mixed[:min(len(mixed), end)]
    else:
        nz = np.nonzero(mixed)[0]
        if len(nz):
            mixed = mixed[:min(len(mixed),
                               int(nz[-1]) + 1 + args.buffer_size)]
    log(f"All waveforms finished ({len(mixed)} samples, "
        f"{len(mixed) / args.sample_rate:.2f}s)")
    if args.render_out:
        write_wav_f32(args.render_out, mixed, args.sample_rate)
        log(f"Wrote {args.render_out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

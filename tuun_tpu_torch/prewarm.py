"""Background pre-warming for time-to-first-sound.

Port of tuun_tpu/prewarm.py.  A brand-new session's first `play` of a
structure pays, on the audio thread, for whatever has not happened yet
in the process: on the card the first load of the scan kernels (an
`nvcc` build of csrc/scan.cu when tuun_tpu_torch/_build lacks it), the
CompiledVoice build of the structure, and the first launches.  The REPL
therefore pre-warms the stdlib's common voice STRUCTURES in the
background at launch: const leaves are runtime params (compiled voices
are shared per structure), so warming `$440 * Qw` once serves every
`$f * beats` note, whatever the constants.

The warm path mirrors the real first-play route -- evaluate -> optimize
-> build_top_level_waveform -> the tracker's own compile cache -> one
block-sized render on the tracker's device, with the fast-mode tiers and
literal cutoffs the tracker would choose -- so the caches end up keyed
the way a user's `play` will look them up.

A failure never takes the session down, but it is never hidden either:
prewarm_structures returns each failure beside the count, and the REPL
logs them.
"""

from __future__ import annotations

import threading
from typing import Iterable, List, Optional, Tuple

import torch

from . import optimizer
from .expr import ESeq, ETuple, EWaveform
from .player import build_top_level_waveform

# The structures a fresh session is most likely to play first (the
# reference's list, unchanged).  The first three are the shapes of a
# first improvised note (NCO note with symbolic length, filtered
# oscillator, enveloped key-style note); the rest are the docs corpus's
# most-frequent voice structures (plain infinite sine, square through
# lpf, finite plain note, the DTMF dual tone), then the pm_synth
# instrument shapes (examples/song.tuun's brass line and the keys
# instrument the REPL installs with `keys`).
COMMON_EXPRS = (
    "$440 * Qw",
    "sawtooth(110) | lpf(0.9, 1800)",
    "$440 | ADSR(0.01, 0.2, 0.6, 3000.0, 0.5)",
    "$220",
    "square(220) | lpf(0.707, 2000)",
    "$261.63 | fin(time - 1.75)",
    "($440 + $550) * 0.5",
    "pm_brass(@60, 0.5)",
    "pm_piano_keys(60, 100)",
)


def _warm_one(tracker, waveform) -> None:
    """One block of `waveform` through the tracker's cache on its device,
    as Tracker._activate and _render_voice would render it; waits for the
    card, so that a fault surfaces here."""
    w = build_top_level_waveform(optimizer.optimize(waveform), 0.0)
    voice = tracker.cache.get(w, tracker.cfg)
    P = voice.params()
    state = voice.init(P)
    fast = voice.fast_default
    lits = voice.lits_for(P) if fast or voice._has_timeline else None
    n = tracker.block_size
    y, _, state, _ = voice.render_block(P, state, n, 0, n, fast=fast,
                                        lits=lits)
    if y.is_cuda:
        torch.cuda.current_stream(y.device).synchronize()


def prewarm_structures(tracker, evaluator,
                       exprs: Iterable[str] = COMMON_EXPRS,
                       opens=("std", "pm_synth")
                       ) -> Tuple[int, List[Tuple[str, Exception]]]:
    """Compiles each expression's voice structure through `tracker`'s
    own cache and renders one block-sized dispatch.  Returns (the number
    of structures warmed, [(expression, exception)] for each expression
    that failed).  Never raises: a failure must not take down the session
    it is trying to speed up, and is reported instead."""
    warmed = 0
    failures: List[Tuple[str, Exception]] = []
    for text in exprs:
        try:
            out = evaluator.evaluate_source(text, opens=tuple(opens))
            if isinstance(out, ESeq):
                out = out.waveform
            # Keys instruments return (note_on, note_off) tuples; warm
            # every waveform element (the note_on body is the expensive
            # structure, the note_off release is cheap but free to bake).
            parts = out.exprs if isinstance(out, ETuple) else (out,)
            n = 0
            for part in parts:
                if isinstance(part, ESeq):
                    part = part.waveform
                if isinstance(part, EWaveform):
                    _warm_one(tracker, part.waveform)
                    n += 1
            if n == 0:
                raise TypeError(f"{text!r} evaluates to no waveform")
            warmed += n
        except Exception as e:  # reported, not raised: see the docstring
            failures.append((text, e))
    return warmed, failures


def start_background(tracker, evaluator,
                     exprs: Iterable[str] = COMMON_EXPRS,
                     on_done=None) -> Optional[threading.Thread]:
    """Runs prewarm_structures on a daemon thread (registered with the
    shutdown registry so interpreter exit never tears it down mid-build)
    and calls on_done(warmed, failures) when it ends.  Returns the
    thread."""
    from . import _threads
    from .evaluator import Evaluator

    def run():
        # A PRIVATE Evaluator for this thread: the session's evaluator
        # mutates its module cache / diagnostics on every evaluate, and
        # the session may be evaluating concurrently (live audio runs
        # commands on its own thread).  Structure keys don't depend on
        # tempo (const leaves are runtime params), so any tempo warms
        # the same compiled voices.
        ev = Evaluator(tracker.sample_rate, 120, evaluator.library_root,
                       print_fn=lambda s: None)
        warmed, failures = prewarm_structures(tracker, ev, exprs)
        if on_done is not None:
            on_done(warmed, failures)

    t = threading.Thread(target=run, daemon=True, name="tuun-prewarm")
    _threads.track_thread(t)
    t.start()
    return t

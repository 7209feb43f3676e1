"""Host-side schedule builder -- the tracker's client.

Port of tuun_tpu/player.py (player.rs): wraps program waveforms with the
standard top-level marks (Amplitude at the program level, Terminator for
stopping), substitutes slider values, and schedules playback on measure
boundaries.  Musical time (beats/measures) is pure sample arithmetic
here -- no silent beats voices are needed, but beats marks are
synthesized for parity with the reference's `Beats` waveforms.
"""

from __future__ import annotations

import math
import queue
import sys
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np

from . import _threads, ir, optimizer
from .engine import precompute as precompute_mod
from .ids import MarkId, WaveformId
from .sliders import denormalize
from .tracker import Mark, Tracker

STOP_DURATION_SECS = 0.05


# db_to_amplitude, build_top_level_waveform, stop_ramp and
# substitute_slider_values are copied from tuun_tpu/player.py:29-69, which
# imports the JAX tracker.
def db_to_amplitude(db: float) -> float:
    return float(np.float32(10.0) ** (np.float32(db) / np.float32(20.0)))


def build_top_level_waveform(w: ir.Waveform, level_db: float) -> ir.Waveform:
    """Marked(TopLevel, (w * Marked(Amplitude, amp)) * Marked(Terminator, 1))
    (player.rs:265-288)."""
    return ir.Marked(
        MarkId.TOP_LEVEL,
        ir.BinaryPointOp(
            ir.Operator.MULTIPLY,
            ir.BinaryPointOp(
                ir.Operator.MULTIPLY, w,
                ir.Marked(MarkId.AMPLITUDE,
                          ir.Const(db_to_amplitude(level_db)))),
            ir.Marked(MarkId.TERMINATOR, ir.Const(1.0))))


def stop_ramp() -> ir.Waveform:
    """A 50ms down-ramp substituted under Terminator to stop a voice
    (player.rs:141-166)."""
    return ir.Fin(
        ir.BinaryPointOp(ir.Operator.SUBTRACT, ir.Time(),
                         ir.Const(STOP_DURATION_SECS)),
        ir.BinaryPointOp(
            ir.Operator.SUBTRACT, ir.Const(1.0),
            ir.BinaryPointOp(ir.Operator.MULTIPLY, ir.Time(),
                             ir.Const(1.0 / STOP_DURATION_SECS))))


def substitute_slider_values(w: ir.Waveform, sliders: Sequence,
                             normalized: Sequence[float]
                             ) -> Tuple[ir.Waveform, List[Tuple[str, float]]]:
    """Substitutes each slider's current value into Marked(Slider(label))
    nodes (player.rs:32-47)."""
    values = []
    for config, norm in zip(sliders, normalized):
        value = denormalize(config.function, norm)
        values.append((config.label, value))
        w = ir.substitute(w, MarkId.slider(config.label), ir.Const(value))
    return w, values


class Player:
    """Schedules program playback on a Tracker using a sample clock."""

    def __init__(self, tracker: Tracker, tempo: int, beats_per_measure: int,
                 precompute: bool = False, async_precompute: bool = False):
        self.tracker = tracker
        self.tempo = tempo
        self.beats_per_measure = beats_per_measure
        self.precompute = precompute
        # Async precompute (the reference's bake thread for next-measure
        # playback, main.rs:209-250): play() returns at once, a worker
        # bakes finite subtrees, and pump() hands the finished command to
        # the tracker at the next block boundary (tracker.rs:321-329).
        self.async_precompute = async_precompute
        self._bake_in: Optional[queue.Queue] = None
        self._bake_out: queue.Queue = queue.Queue()
        self._bake_thread: Optional[threading.Thread] = None
        # Cancellation: a stop must also kill the bakes still in flight
        # for that voice.  Items carry an increasing token; pump drops any
        # whose token predates the voice's cancellation mark.
        self._bake_token = 0
        self._bake_cancelled: dict = {}
        # token -> (wid, start) for bakes not yet pumped: plays the tracker
        # cannot see yet, surfaced as pending marks.
        self._bake_inflight: dict = {}

    @property
    def sample_rate(self) -> int:
        return self.tracker.sample_rate

    def samples_per_beat(self) -> float:
        return 60.0 / self.tempo * self.sample_rate

    def samples_per_measure(self) -> float:
        return self.samples_per_beat() * self.beats_per_measure

    def next_measure_start(self) -> int:
        spm = self.samples_per_measure()
        now = self.tracker.now
        return int(math.ceil((now + 1) / spm) * spm)

    def beat_marks(self, horizon_measures: int = 2) -> List[Mark]:
        """Synthesized beats marks (the reference keeps two silent Beats
        voices for this; here they are arithmetic)."""
        spb = self.samples_per_beat()
        spm = self.samples_per_measure()
        now = self.tracker.now
        measure0 = int(now // spm)
        marks = []
        for mi in range(measure0, measure0 + horizon_measures + 1):
            base = int(mi * spm)
            marks.append(Mark(WaveformId.beats(mi % 2 == 0), MarkId.TOP_LEVEL,
                              base, int(spm)))
            for b in range(self.beats_per_measure):
                marks.append(Mark(WaveformId.beats(mi % 2 == 0),
                                  MarkId.user(b + 1),
                                  base + int(b * spb), int(spb)))
        return marks

    def play(self, wid, w: ir.Waveform, level_db: float = 0.0,
             sliders: Sequence = (), normalized: Sequence[float] = (),
             start_at_next_measure: bool = False,
             repeat_after_measures: Optional[int] = None) -> None:
        """Optimizes, substitutes sliders, wraps with top-level marks, and
        schedules (player.rs:79-125)."""
        w = optimizer.optimize(w)
        w, _ = substitute_slider_values(w, sliders, normalized)
        start = self.next_measure_start() if start_at_next_measure else None
        repeat = None
        if repeat_after_measures is not None:
            repeat = int(repeat_after_measures * self.samples_per_measure())
        if self.precompute:
            if self.async_precompute and start is not None:
                # Only next-measure playback goes through the bake worker
                # (player.rs:1-8); its start is fixed now, and a bake that
                # overshoots the boundary is absorbed by late-start
                # catch-up.
                self._ensure_worker()
                self._bake_token += 1
                self._bake_inflight[self._bake_token] = (wid, start)
                self._bake_in.put((self._bake_token, wid, w, level_db,
                                   start, repeat))
                return
            w = precompute_mod.precompute(w, self.sample_rate,
                                          cfg=self.tracker.cfg)
        self.tracker.play(wid, build_top_level_waveform(w, level_db),
                          start=start, repeat_every=repeat)

    # -- async precompute ----------------------------------------------

    def _ensure_worker(self) -> None:
        if self._bake_thread is None or not self._bake_thread.is_alive():
            self._bake_in = queue.Queue()
            self._bake_thread = threading.Thread(
                target=self._bake_worker, daemon=True, name="tuun-bake")
            _threads.track_closer(self)  # close() before interpreter exit
            self._bake_thread.start()

    def _bake_worker(self) -> None:
        while True:
            item = self._bake_in.get()
            if item is None:
                self._bake_in.task_done()
                return
            token, wid, w, level_db, start, repeat = item
            try:
                baked = precompute_mod.precompute(w, self.sample_rate,
                                                  cfg=self.tracker.cfg)
            except Exception:
                baked = w  # a failed bake plays unbaked, never silently
            self._bake_out.put((token, wid, baked, level_db, start, repeat))
            self._bake_in.task_done()

    def cancel_bakes(self, wid=None) -> None:
        """Cancels in-flight next-measure bakes (all of them, or one
        voice's): a stopped program must not come back to life when its
        bake completes."""
        mark = self._bake_token
        if wid is None:
            self._bake_cancelled = {None: mark}
            self._bake_inflight.clear()
        else:
            self._bake_cancelled[wid] = mark
            for token, (w_, _) in list(self._bake_inflight.items()):
                if w_ == wid and token <= mark:
                    self._bake_inflight.pop(token, None)

    def pump(self) -> int:
        """Hands finished bakes to the tracker; call at each block
        boundary (the audio callback's command drain).  Returns the number
        of plays submitted (cancelled bakes are dropped)."""
        n = 0
        while True:
            try:
                token, wid, w, level_db, start, repeat = \
                    self._bake_out.get_nowait()
            except queue.Empty:
                return n
            self._bake_inflight.pop(token, None)
            cut = max(self._bake_cancelled.get(None, 0),
                      self._bake_cancelled.get(wid, 0))
            if token <= cut:
                continue
            self.tracker.play(wid, build_top_level_waveform(w, level_db),
                              start=start, repeat_every=repeat)
            n += 1

    def pending_bakes(self):
        """(wid, start) for every bake still in flight: plays the tracker
        cannot see yet."""
        return list(self._bake_inflight.values())

    def flush_bakes(self) -> int:
        """Waits for every outstanding bake and pumps it (deterministic
        rendering for tests and batch mode)."""
        if self._bake_in is not None:
            self._bake_in.join()
        return self.pump()

    def close(self) -> None:
        # Bounded join: a bake torn down inside a render at interpreter
        # exit may abort the process, but a wedged worker must not hang
        # exit forever.
        if self._bake_thread is not None and self._bake_thread.is_alive():
            self._bake_in.put(None)
            self._bake_thread.join(timeout=_threads.SHUTDOWN_JOIN_SECONDS)
            if self._bake_thread.is_alive():  # pragma: no cover - wedged
                print("tuun_tpu_torch: bake worker still running at close; "
                      "abandoning", file=sys.stderr)

    def play_note(self, key: int, w: ir.Waveform, level_db: float = 0.0
                  ) -> None:
        self.tracker.play(WaveformId.key(key),
                          build_top_level_waveform(w, level_db))

    def stop(self, wid) -> None:
        """Fades the voice out over a short ramp."""
        self.cancel_bakes(wid)
        self.tracker.modify(wid, MarkId.TERMINATOR, stop_ramp())
        self.tracker.remove_pending(wid)

    def stop_all(self) -> None:
        """Stops everything, including bakes still in flight."""
        self.cancel_bakes()
        self.tracker.stop_all()

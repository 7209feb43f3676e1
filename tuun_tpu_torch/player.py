"""Host-side schedule builder -- the tracker's client.

Port of the synchronous part of tuun_tpu/player.py (player.rs:79-125):
optimizes a program's waveform, substitutes slider values, bakes finite
subtrees through the engine, wraps it in the standard top-level marks and
plays it.  Next-measure scheduling, async bakes and stopping single
voices wait with the app layer (ROADMAP.md queue 1).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from . import ir, optimizer
from .engine.precompute import precompute as engine_precompute
from .ids import MarkId
from .sliders import denormalize
from .tracker import Tracker


# db_to_amplitude, build_top_level_waveform and substitute_slider_values
# are copied from tuun_tpu/player.py:29-69, which imports the JAX tracker.
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
    """Plays programs on a Tracker."""

    def __init__(self, tracker: Tracker, precompute: bool = False):
        self.tracker = tracker
        self.precompute = precompute

    def play(self, wid, w: ir.Waveform, level_db: float = 0.0,
             sliders: Sequence = (), normalized: Sequence[float] = ()) -> None:
        """Optimizes, substitutes sliders, bakes, wraps with the top-level
        marks, and plays now."""
        w = optimizer.optimize(w)
        w, _ = substitute_slider_values(w, sliders, normalized)
        if self.precompute:
            w = engine_precompute(w, self.tracker.sample_rate,
                                  cfg=self.tracker.cfg)
        self.tracker.play(wid, build_top_level_waveform(w, level_db))

    def stop_all(self) -> None:
        self.tracker.stop_all()

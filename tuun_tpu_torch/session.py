"""Streaming session runtime.

Port of tuun_tpu/session.py: the reference's web/WASM runtime (wasm.rs,
the JS `Tuun` class with install/process/update_slider/stop) together
with the MIDI keys flow of the effects runner (effects.rs:176-248:
PlayNoteOn applies the installed `(note, velocity) -> (note_on,
note_off)` function, PlayNoteOff splices the stored release under the
Terminator mark).

The `install -> process` loop is the AudioWorklet's pump
(web/tuun-processor.js:46-69), pulling blocks from the port's tracker on
the card (device="cuda", the default) or on the CPU (device="cpu").
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from . import ir, optimizer, parser
from .evaluator import Evaluator
from .expr import (BOpen, EBuiltIn, EFloat, EFunction, ESeq, EWaveform, Expr,
                   Slider, SliderLinear, SliderUserDefined, SourceBinding,
                   TuunError)
from .ids import MarkId, WaveformId
from .player import Player, substitute_slider_values
from .programs import ProgramSliders
from .sliders import (append_slider_bindings, denormalize, denormalize_or_zero,
                      make_ramp)
from .tracker import Tracker

DEFAULT_LIBRARY = Path(__file__).resolve().parent / "stdlib" / "v0"


class TuunSession:
    """A single streaming Tuun runtime: install programs, pump blocks."""

    def __init__(self, sample_rate: int = 44100, tempo: int = 120,
                 block_size: int = 128,
                 library_root: Union[str, Path, None] = None,
                 precision: str = "fast", jit: bool = True,
                 level_db: float = 0.0, sync_interval: int = 1,
                 device="cuda"):
        self.sample_rate = sample_rate
        self.block_size = block_size
        self.level_db = level_db
        self.evaluator = Evaluator(sample_rate, tempo,
                                   library_root or DEFAULT_LIBRARY)
        # sync_interval > 1 turns on deferred sync (and, with a stable
        # voice set, the fused step and lookahead windows): production
        # serving passes 16-32; the default 1 keeps one block's latency
        # lowest.
        self.tracker = Tracker(sample_rate, block_size, precision=precision,
                               device=device, jit=jit,
                               sync_interval=sync_interval)
        self.player = Player(self.tracker, tempo, 4)
        self.sliders = ProgramSliders()
        self.keys_function: Optional[Expr] = None
        self._note_offs: Dict[int, ir.Waveform] = {}
        self._last_slider_values: Dict[str, float] = {}

    # ------------------------------------------------------------------

    def install(self, expression: str,
                sliders: Union[str, Sequence[Slider], None] = None,
                opens: Sequence[str] = ("std",)) -> str:
        """Evaluates `expression` and starts it (waveform) or installs it
        as a keys instrument (function).  Returns "waveform" or "keys"
        (wasm.rs:184-266)."""
        if isinstance(sliders, str):
            self.sliders = ProgramSliders.from_configs(
                parser.parse_sliders(sliders))
        elif sliders:
            self.sliders = ProgramSliders.from_configs(list(sliders))
        else:
            self.sliders = ProgramSliders()
        self._last_slider_values = {
            c.label: denormalize_or_zero(c.function, n)
            for c, n in zip(self.sliders.configs,
                            self.sliders.normalized_values)}

        bindings = [SourceBinding(BOpen(("__prelude",)))]
        for o in opens:
            bindings.append(SourceBinding(BOpen(tuple(o.split(".")))))
        append_slider_bindings(self.sliders.configs,
                               self.sliders.normalized_values,
                               MarkId.slider, bindings)
        value = self.evaluator.evaluate_source(expression, bindings)
        if isinstance(value, ESeq):
            value = value.waveform
        if isinstance(value, EWaveform):
            self.stop()
            self.player.play(WaveformId.program(0), value.waveform,
                             level_db=self.level_db,
                             sliders=self.sliders.configs,
                             normalized=self.sliders.normalized_values)
            return "waveform"
        if isinstance(value, (EFunction, EBuiltIn)):
            # Sanity-invoke with dummy args, as the evaluator does.
            self.evaluator.apply_note_function(
                value, [EFloat(60.0), EFloat(0.7)])
            self.keys_function = value
            return "keys"
        raise TuunError("Expression is not a waveform or keys instrument")

    def process(self, n: Optional[int] = None) -> Optional[np.ndarray]:
        """Renders the next block of audio; None once everything finished
        (wasm.rs:309-322, the worklet's render quantum).

        Always numpy: with sync_interval > 1 the tracker returns the mix
        on the device to keep blocks pipelined, but this surface feeds
        audio sinks; with a lookahead window open the copy waits on the
        card once per window."""
        if not self.tracker.active and not self.tracker.pending:
            return None
        out, _ = self.tracker.render_block()
        if isinstance(out, torch.Tensor):
            out = out.cpu().numpy()
        return np.asarray(out, np.float32)

    def render_all(self, max_seconds: float = 120.0) -> np.ndarray:
        return self.tracker.run_to_completion(max_seconds=max_seconds)

    def stop(self) -> None:
        self.tracker.stop_all()

    # ------------------------------------------------------------------
    # live parameters (wasm.rs:278-291, main.rs slider worker)

    def update_slider(self, label: str, value: float) -> None:
        """Splices a one-buffer linear ramp to `value` under the slider's
        mark in every live voice: click-free."""
        last = self._last_slider_values.get(label, 0.0)
        ramp = make_ramp(last, value,
                         self.block_size / float(self.sample_rate))
        self._last_slider_values[label] = value
        ids = {v.id for v in self.tracker.active} | \
            {p.id for p in self.tracker.pending}
        for wid in ids:
            self.tracker.modify(wid, MarkId.slider(label), ramp)

    def update_slider_normalized(self, label: str, normalized: float) -> None:
        for i, c in enumerate(self.sliders.configs):
            if c.label == label:
                self.sliders.normalized_values[i] = normalized
                self.update_slider(
                    label, denormalize_or_zero(c.function, normalized))
                return
        raise KeyError(label)

    # ------------------------------------------------------------------
    # keys instrument (effects.rs:176-248)

    def note_on(self, key: int, velocity: float) -> None:
        if self.keys_function is None:
            raise TuunError("No keys instrument installed")
        note_on, note_off = self.evaluator.apply_note_function(
            self.keys_function,
            [EFloat(float(key)), EFloat(velocity / 127.0)])
        note_on = optimizer.optimize(note_on)
        self._note_offs[key] = optimizer.optimize(note_off)
        note_on, _ = substitute_slider_values(
            note_on, self.sliders.configs, self.sliders.normalized_values)
        self.player.play_note(key, note_on, level_db=self.level_db)

    def note_off(self, key: int) -> None:
        w = self._note_offs.pop(key, None)
        if w is None:
            return
        w, _ = substitute_slider_values(
            w, self.sliders.configs, self.sliders.normalized_values)
        self.tracker.modify(WaveformId.key(key), MarkId.TERMINATOR, w)
        self.tracker.remove_pending(WaveformId.key(key))


def parse_sliders(text: str) -> List[dict]:
    """Parses a slider-list literal (the `["label:init:min:max", ...]`
    form of annotations) into UI-ready descriptors: the reference's wasm
    parseSliders (wasm.rs:374-413), as dicts."""
    out = []
    for s in parser.parse_sliders(text):
        f = s.function
        if isinstance(f, SliderLinear):
            out.append({"type": "linear", "label": s.label,
                        "initial_value": f.initial_value,
                        "min": f.min, "max": f.max})
        elif isinstance(f, SliderUserDefined):
            out.append({
                "type": "user-defined", "label": s.label,
                "normalized_initial_value": f.normalized_initial_value,
                "function_source": f.function_source,
                "initial_value": denormalize_or_zero(
                    f, f.normalized_initial_value),
                "value_at_0": denormalize_or_zero(f, 0.0),
                "value_at_1": denormalize_or_zero(f, 1.0)})
    return out


def evaluate_slider(function_source: str, normalized_value: float) -> float:
    """A user-defined slider function at a normalized value, e.g.
    evaluate_slider("fn(x) => 100 * pow(100, x)", 0.5) ~= 1000
    (wasm.rs evaluateSlider, :417-425)."""
    return denormalize(SliderUserDefined(0.0, function_source),
                       normalized_value)

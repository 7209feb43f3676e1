"""Effect runner: executes reducer Effects against the world.

Port of tuun_tpu/effects.py (reference/src/lib/effects.rs), its logic
unchanged, on the port's Player, Tracker, Status and Mark: owns the
Player, Evaluator, and Tracker; `dispatch(action)` runs the pure reducer
and then executes
each returned Effect — evaluating programs, splicing source, playing and
stopping voices, striking and releasing keys (with stored note-off
waveforms), and fanning slider changes out to live voices as click-free
ramps.  I/O-dependent state mutation (evaluation results, keys install)
happens here, not in the reducer.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from . import actions as A
from . import ir, optimizer
from .evaluator import Evaluation, Evaluator
from .expr import EFloat
from .ids import MarkId, WaveformId
from .player import Player, substitute_slider_values
from .sliders import denormalize, make_ramp
from .tracker import Status, Tracker


class EffectRunner:
    """Wires the reducer to a real Player/Evaluator/Tracker."""

    def __init__(self, state: A.AppState, evaluator: Evaluator,
                 player: Player, log=None):
        self.state = state
        self.evaluator = evaluator
        self.player = player
        self.log = log or (lambda msg: None)
        # Most recent rendered Status (refreshed by the render loop via
        # observe_status); context() prefers a live tracker snapshot —
        # same-thread, so no cross-thread staleness like the reference.
        self.last_status = Status(buffer_start=0)
        # Cached evaluation per program index, invalidated on source
        # change (the reference caches Evaluation on the Program).
        self._evaluations: Dict[int, Evaluation] = {}
        # Installed keys function + per-held-key note-off waveforms
        # (keys.rs:12-27).
        self._keys_fn = None
        self._note_offs: Dict[int, ir.Waveform] = {}
        # Last value per (program, slider) for ramp starts.
        self._slider_values: Dict[tuple, float] = {}
        # Optional Launchkey controller handle (launchkey.Launchkey);
        # the reference threads it as World.launchkey (effects.rs:39).
        self.launchkey = None

    @property
    def tracker(self) -> Tracker:
        return self.player.tracker

    # -- world snapshots -----------------------------------------------

    def observe_status(self, status: Status) -> None:
        self.last_status = status

    def context(self) -> A.Context:
        from .tracker import Mark
        status = self.tracker.status_snapshot()
        # Bakes still in flight are plays the tracker cannot see yet;
        # surface them as pending marks so the reducer's toggle/remove
        # logic reaches them (removal then cancels the bake).
        for wid, start in self.player.pending_bakes():
            status.marks.append(Mark(wid, MarkId.TOP_LEVEL, start, 0))
        return A.Context(status=status, now=self.tracker.now,
                         evaluator=self.evaluator)

    # -- dispatch -------------------------------------------------------

    def dispatch(self, *actions) -> None:
        for action in actions:
            for effect in A.apply(self.state, self.context(), action):
                self.run_effect(effect)

    def invalidate(self, index: Optional[int] = None) -> None:
        if index is None:
            self._evaluations.clear()
        else:
            self._evaluations.pop(index, None)

    def evaluation(self, index: int) -> Evaluation:
        ev = self._evaluations.get(index)
        if ev is None:
            ps = self.state.programs
            ev = self.evaluator.evaluate_program(
                ps.programs[index].text, ps.evaluation_bindings(index))
            self._evaluations[index] = ev
        return ev

    # -- effect execution ----------------------------------------------

    def run_effect(self, effect) -> None:
        state = self.state
        ps = state.programs

        if isinstance(effect, A.EPlayProgram):
            i = effect.program_index
            ev = self.evaluation(i)
            if ev.kind != "waveform":
                if ev.kind == "invalid":
                    self._show("\n".join(str(d) for d in ev.diagnostics))
                return
            program = ps.programs[i]
            self.player.play(
                WaveformId.program(i), ev.value,
                level_db=program.level_db,
                sliders=program.sliders.configs,
                normalized=program.sliders.normalized_values,
                start_at_next_measure=effect.start_at_next_measure,
                repeat_after_measures=effect.repeat_after_measures)
            for c, n in zip(program.sliders.configs,
                            program.sliders.normalized_values):
                self._slider_values[(i, c.label)] = \
                    denormalize(c.function, n)
            self._show(f"Playing {ps.display_name(i)}")
        elif isinstance(effect, A.EStopProgram):
            self.player.stop(WaveformId.program(effect.program_index))
        elif isinstance(effect, A.ERemovePendingProgram):
            self.player.cancel_bakes(
                WaveformId.program(effect.program_index))
            self.tracker.remove_pending(
                WaveformId.program(effect.program_index))
        elif isinstance(effect, A.EModifyWaveform):
            self.tracker.modify(effect.id, effect.mark_id, effect.waveform)
        elif isinstance(effect, A.EEvaluateProgram):
            i = effect.program_index
            self.invalidate(i)
            # An empty program is a deletion in progress, not a parse
            # error: succeed so the editor leaves Edit mode and the
            # following EUpdateSource removes the binding
            # (programs.rs evaluate_and_record).
            if not ps.programs[i].text.strip():
                state.mode = A.Select()
                return
            ev = self.evaluation(i)
            if ev.kind == "invalid":
                state.mode = effect.mode_on_failure
                self._show("\n".join(str(d) for d in ev.diagnostics))
            else:
                state.mode = A.Select()
        elif isinstance(effect, A.EUpdateSource):
            i = effect.program_index
            # Padding slots splice too: editing an empty slot inserts a
            # fresh binding; clearing an existing program deletes it
            # (both with skip_slots compensation, programs.rs:998-1103).
            err = ps.splice(i, ps.programs[i].text)
            if err:
                self._show(f"splice failed (source unchanged): {err}")
                return
            self.invalidate()
            if ps.input_path is not None:
                try:
                    ps.save()
                except OSError as e:
                    self._show(f"Save failed: {e}")
        elif isinstance(effect, A.EInstallKeys):
            i = effect.program_index
            ev = self.evaluation(i)
            if ev.kind != "keys":
                self._show(f"{ps.display_name(i)} is not a keys instrument")
                return
            state.keys_program = i
            self._keys_fn = ev.value
            self._show(f"keys instrument installed from "
                       f"{ps.display_name(i)}")
        elif isinstance(effect, A.EPlayNoteOn):
            self._play_note_on(effect.key, effect.velocity)
        elif isinstance(effect, A.EPlayNoteOff):
            self._play_note_off(effect.key)
        elif isinstance(effect, A.EUpdateSlider):
            self._update_slider(effect.id, effect.slider, effect.value)
        elif isinstance(effect, A.EUpdateActiveKeySliders):
            ramp_len = self.tracker.block_size / self.tracker.sample_rate
            for key in list(self._note_offs):
                last = self._slider_values.get(("key", key, effect.slider),
                                               effect.value)
                self._slider_values[("key", key, effect.slider)] = \
                    effect.value
                self.tracker.modify(
                    WaveformId.key(key), MarkId.slider(effect.slider),
                    make_ramp(last, effect.value, ramp_len))
        elif isinstance(effect, A.EModifyActiveKeysAmplitude):
            for key in list(self._note_offs):
                self.tracker.modify(WaveformId.key(key), MarkId.AMPLITUDE,
                                    ir.Const(effect.amplitude))
        elif isinstance(effect, A.ESaveAll):
            # Any divergence persists — slider positions AND runtime
            # level changes on slider-less programs (programs.rs
            # non_active_program_divergence_persists_on_any_save);
            # persist_annotations itself is a no-op without divergence.
            for w in ps.persist_all():
                self._show(f"warning: {w}")
            if ps.input_path is not None:
                ps.save()
                self._show(f"saved {ps.input_path}")
        elif isinstance(effect, A.EReloadFile):
            if ps.input_path is None:
                self._show("no file to reload")
                return
            fresh, message = type(ps).from_source(
                ps.input_path.read_text(), ps.input_path,
                all_bindings=ps._all_bindings)
            state.programs = fresh
            state.keys_program = None
            self._keys_fn = None
            self.invalidate()
            self._show(message or f"reloaded {ps.input_path}")
        elif isinstance(effect, A.ESetLaunchkeyEncoderMode):
            lk = self.launchkey
            if lk is not None and lk.encoder_mode != effect.mode:
                lk.encoder_mode = effect.mode
                # The device resets the relative-output feature on every
                # encoder-mode switch; re-assert it, then re-sync the
                # displays for the new mode (effects.rs:294-305).  A
                # same-mode repeat is a no-op (effects.rs:295-297) —
                # real hardware emits no CC for selecting the mode it is
                # already in, so the feature was not dropped.
                lk.set_encoder_relative_output()
                self._sync_encoders()
        elif isinstance(effect, A.ESetLaunchkeyPadMode):
            if self.launchkey is not None:
                self.launchkey.pad_mode = effect.mode
        elif isinstance(effect, A.ESetDawModeDisplay):
            if self.launchkey is not None:
                self.launchkey.set_daw_mode_display(effect.label)
        elif isinstance(effect, A.ESyncEncoders):
            self._sync_encoders()
        elif isinstance(effect, A.ESetEncoderDisplay):
            lk = self.launchkey
            if lk is not None and (effect.mode is None
                                   or effect.mode == lk.encoder_mode):
                lk.set_encoder_display(
                    effect.index, effect.name, effect.value)
        elif isinstance(effect, A.EShowMessage):
            self._show(effect.message)
        elif isinstance(effect, A.EDumpActiveWaveform):
            i = state.active_program_index
            ev = self.evaluation(i)
            if ev.kind == "waveform":
                self.log(ir.format_waveform(optimizer.optimize(ev.value)))
            else:
                self._show(f"{ps.display_name(i)} is not a waveform")
        elif isinstance(effect, A.EExit):
            state.should_exit = True
        else:
            raise TypeError(f"unknown effect: {effect!r}")

    def keys_candidate(self, index: int) -> bool:
        """Whether program `index` evaluates to a keys instrument right
        now — the evaluation oracle behind the keys-installer pad LEDs
        (the reference's Program::keys_instrument(), midi_input.rs:267)."""
        try:
            return self.evaluation(index).kind == "keys"
        except Exception:
            return False

    # -- controller sync -------------------------------------------------

    def _sync_encoders(self) -> None:
        """Pushes the active bank/program's encoder names+values to the
        controller displays (effects.rs sync_encoders, :340-377): Plugin
        mode maps the 8 encoders to the active program's sliders, Mixer
        mode to the bank's per-program levels."""
        from . import launchkey as LK
        lk = self.launchkey
        if lk is None:
            return
        state = self.state
        ps = state.programs
        if lk.encoder_mode == LK.PLUGIN:
            if state.active_program_index >= len(ps.programs):
                return
            program = ps.programs[state.active_program_index]
            for i in range(LK.NUM_ENCODERS):
                if i < len(program.sliders.normalized_values):
                    from .sliders import denormalize_or_zero
                    config = program.sliders.configs[i]
                    value = denormalize_or_zero(
                        config.function,
                        program.sliders.normalized_values[i])
                    lk.set_encoder_display(i, config.label, f"{value:.3g}")
                else:
                    lk.set_encoder_display(i, "", "")
            return
        bank_start = state.bank_start()
        for i in range(LK.NUM_ENCODERS):
            index = bank_start + i
            if index < len(ps.programs):
                lk.set_encoder_display(
                    i, "level", f"{ps.programs[index].level_db:.3g} dB")
            else:
                # Blank the trailing strips, or a Plugin->Mixer switch in
                # a short bank leaves the old mode's slider text showing.
                lk.set_encoder_display(i, "", "")

    # -- notes / sliders -----------------------------------------------

    def _keys_sliders(self):
        """The installed keys program's sliders — empty when the
        instrument was uninstalled/reloaded while keys are still held
        (their stored note-offs must keep working)."""
        i = self.state.keys_program
        if i is None or i >= len(self.state.programs.programs):
            return None, (), ()
        program = self.state.programs.programs[i]
        return program, program.sliders.configs, \
            program.sliders.normalized_values

    def _play_note_on(self, key: int, velocity: int) -> None:
        if self._keys_fn is None:
            return
        program, configs, normalized = self._keys_sliders()
        if program is None:
            return
        note_on, note_off = self.evaluator.apply_note_function(
            self._keys_fn, [EFloat(float(key)),
                            EFloat(float(velocity) / 127.0)])
        note_on = optimizer.optimize(note_on)
        # Store the optimized note-off; it is substituted with the
        # sliders live at RELEASE time (effects.rs:226-248).
        self._note_offs[key] = optimizer.optimize(note_off)
        note_on, values = substitute_slider_values(note_on, configs,
                                                   normalized)
        for label, value in values:
            self._slider_values[("key", key, label)] = value
        self.player.play_note(key, note_on, level_db=program.level_db)

    def _play_note_off(self, key: int) -> None:
        w = self._note_offs.pop(key, None)
        if w is None:
            return
        _, configs, normalized = self._keys_sliders()
        w, _ = substitute_slider_values(w, configs, normalized)
        self.tracker.modify(WaveformId.key(key), MarkId.TERMINATOR, w)
        self.tracker.remove_pending(WaveformId.key(key))

    def _update_slider(self, wid: WaveformId, label: str,
                       value: float) -> None:
        """Splices a one-buffer ramp from the previous value into the
        live voice (the reference's slider-worker coalescing pipeline,
        slider.rs:85, main.rs:284-360)."""
        key = (wid.index, label)
        last = self._slider_values.get(key, value)
        self._slider_values[key] = value
        ramp = make_ramp(last, value,
                         self.tracker.block_size / self.tracker.sample_rate)
        self.tracker.modify(wid, MarkId.slider(label), ramp)

    def _show(self, message: str) -> None:
        self.state.message = message
        self.log(message)

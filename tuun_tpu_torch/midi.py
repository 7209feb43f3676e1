"""MIDI input classifier: raw MIDI messages -> pure Actions.

The TPU build's counterpart of reference/src/lib/midi_input.rs,
minus the Launchkey hardware driver (launchkey.rs talks midir/SysEx to a
specific controller; here any source of standard MIDI bytes — a file, a
network stream, a virtual port — feeds `classify`).  The event mapping
mirrors the reference:

  * note on / note off          -> NoteOn / NoteOff (note-on velocity 0
                                   is a note-off, per the MIDI spec)
  * CC 21..28 ("encoders")      -> SetSliderNormalized on the active
                                   program (absolute 0..127 -> 0..1)
  * CC 7 (channel volume)       -> SetLevelDb on the active program
                                   (0..127 -> -60..+6 dB, the reference
                                   mixer-encoder range)
  * program change              -> SelectProgram (bank-relative)
  * CC 115/116 (transport prev/next used as track keys) -> AdvanceProgram

`classify_bytes` accepts a raw status/data message; `classify` takes a
decoded (kind, a, b) event for callers that already parse framing.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from . import actions as A
from .programs import PROGRAMS_PER_BANK

# CC numbers: 21-28 are the common "user knob" block (Launchkey,
# MiniLab, nanoKONTROL all land here in their default maps).
SLIDER_CCS = range(21, 29)
CC_VOLUME = 7
CC_PREV_TRACK = 115
CC_NEXT_TRACK = 116

LEVEL_DB_MIN, LEVEL_DB_MAX = -60.0, 6.0


def decode(status: int, data1: int, data2: int
           ) -> Optional[Tuple[str, int, int]]:
    """Raw MIDI message -> (kind, a, b) event, or None for unhandled
    kinds (aftertouch, pitch bend, system messages)."""
    kind = status & 0xF0
    if kind == 0x90:
        if data2 == 0:  # running-status note-off
            return ("note_off", data1, 0)
        return ("note_on", data1, data2)
    if kind == 0x80:
        return ("note_off", data1, data2)
    if kind == 0xB0:
        return ("cc", data1, data2)
    if kind == 0xC0:
        return ("program_change", data1, 0)
    return None


def classify(state: A.AppState, event: Tuple[str, int, int]
             ) -> List[object]:
    """Decoded MIDI event -> Actions against the current app state."""
    kind, a, b = event
    i = state.active_program_index

    if kind == "note_on":
        if b == 0:  # velocity-0 note-on IS a note-off (MIDI spec)
            return [A.NoteOff(key=a)]
        return [A.NoteOn(key=a, velocity=b)]
    if kind == "note_off":
        return [A.NoteOff(key=a)]

    if kind == "program_change":
        index = state.bank_start() + a
        if a < PROGRAMS_PER_BANK and index < len(state.programs.programs):
            return [A.SelectProgram(index)]
        return []

    if kind == "cc":
        if a in SLIDER_CCS:
            slider_index = a - SLIDER_CCS.start
            program = state.programs.programs[i]
            if slider_index >= len(program.sliders.configs):
                return []
            return [A.SetSliderNormalized(i, slider_index, b / 127.0)]
        if a == CC_VOLUME:
            level = LEVEL_DB_MIN + (b / 127.0) * (LEVEL_DB_MAX
                                                  - LEVEL_DB_MIN)
            return [A.SetLevelDb(i, level)]
        if a == CC_PREV_TRACK and b > 0:
            return [A.AdvanceProgram(-1)]
        if a == CC_NEXT_TRACK and b > 0:
            return [A.AdvanceProgram(1)]
        return []

    return []


def classify_bytes(state: A.AppState, status: int, data1: int = 0,
                   data2: int = 0) -> List[object]:
    """Raw MIDI bytes -> Actions (decode + classify)."""
    event = decode(status, data1, data2)
    if event is None:
        return []
    return classify(state, event)


# ---------------------------------------------------------------------------
# Launchkey event classification (midi_input.rs:14-95)
# ---------------------------------------------------------------------------

# One full detent of an encoder = 1/(ENCODER_ROTATIONS*128) of the slider
# range (midi_input.rs:10-31).
ENCODER_ROTATIONS = 4.0


def classify_launchkey(state: A.AppState, event) -> Optional[List[object]]:
    """Launchkey Event -> Actions, mirroring midi_input.rs::classify.

    Returns None (like the reference's Option) when the event targets a
    program or slider that doesn't exist; [] when the event is valid but
    a no-op in the current mode."""
    from . import launchkey as lk

    programs = state.programs.programs
    i = state.active_program_index
    bank_start = state.bank_start()

    if isinstance(event, lk.PluginEncoderChange):
        # Relative output: one detent == one unit of `delta`.
        if i >= len(programs):
            return None
        program = programs[i]
        if event.index >= len(program.sliders.normalized_values):
            return None
        current = program.sliders.normalized_values[event.index]
        normalized = current + event.delta / (ENCODER_ROTATIONS * 128.0)
        return [A.SetSliderNormalized(i, event.index,
                                      max(0.0, min(1.0, normalized)))]
    if isinstance(event, lk.MixerEncoderChange):
        # ~0.5 dB per detent; four turns span -60..+6 dB
        # (midi_input.rs:38-47).
        index = bank_start + event.index
        if index >= len(programs):
            return None
        level = programs[index].level_db + event.delta * 0.25
        return [A.SetLevelDb(index, max(-60.0, min(6.0, level)))]

    if isinstance(event, lk.EncoderModeChanged):
        return [A.SetEncoderMode(event.mode)]

    if isinstance(event, lk.NextTrackDown):
        return [A.AdvanceProgram(1)]
    if isinstance(event, lk.PreviousTrackDown):
        return [A.AdvanceProgram(-1)]
    if isinstance(event, lk.NextTrackBankDown):
        return [A.AdvanceProgram(PROGRAMS_PER_BANK)]
    if isinstance(event, lk.PreviousTrackBankDown):
        return [A.AdvanceProgram(-PROGRAMS_PER_BANK)]

    if isinstance(event, lk.DAWTopPadDown):
        index = bank_start + event.index
        if state.daw_pad_mode == "clip_launcher":
            if index >= len(programs):
                return None
            return [A.ToggleProgramPlayback(index)]
        return []  # top row idle in the keys installer
    if isinstance(event, lk.DAWBottomPadDown):
        index = bank_start + event.index
        if index >= len(programs):
            return None
        if state.daw_pad_mode == "clip_launcher":
            return [A.ToggleProgramPendingPlayback(index)]
        return [A.ToggleInstalledKeys(index)]

    if isinstance(event, lk.PadFunctionDown):
        return [A.CycleRepeatAfterMeasures()]

    if isinstance(event, lk.NoteOn):
        return [A.NoteOn(key=event.key, velocity=event.velocity)]
    if isinstance(event, lk.NoteOff):
        return [A.NoteOff(key=event.key)]

    if isinstance(event, lk.PadModeChanged):
        return [A.PadModeChanged(event.previous, event.current)]
    return None


# ---------------------------------------------------------------------------
# Controller LED/display sync (midi_input.rs:100-290)
# ---------------------------------------------------------------------------


def current_beat_info(now: int, status) -> Tuple[int, int, int]:
    """(beat, beat_start, beat_duration) in samples, from the Beats
    marks in the Status (renderer.rs:800-827; our marks are synthesized
    by player.beat_marks from sample arithmetic)."""
    beat, start, duration = 0, now, 1
    for mark in status.marks:
        if (getattr(mark.waveform_id, "kind", None) == "beats"
                and getattr(mark.mark_id, "kind", None) == "user"
                and mark.start <= now < mark.start + mark.duration):
            beat, start, duration = (mark.mark_id.index, mark.start,
                                     mark.duration)
    return beat, start, max(duration, 1)


def _pad_color_for(program) -> Tuple[int, int, int]:
    """7-bit pad color: the program's configured color at half
    intensity, or the cyan default (midi_input.rs:160-167)."""
    if program.color is not None:
        r, g, b = program.color
        return r // 2, g // 2, b // 2
    return 0, 127, 127


def _pulsed(color, now, beat_start, beat_duration):
    """Fades toward black over the current beat (midi_input.rs:171-183)."""
    fraction = max(0.0, min(1.0, (now - beat_start) / beat_duration))
    return tuple(max(0, c - int(fraction * c)) for c in color)


def update_launchkey_state(state: A.AppState, status, launchkey,
                           now: int, keys_candidate=None) -> None:
    """Pushes app state out to the controller: the pad-function color
    for repeat_after_measures, and per-pad colors for the active bank
    (midi_input.rs:100-155).  `now` is the sample clock (the reference
    uses Instant; musical time here is sample arithmetic).

    `keys_candidate(index) -> bool` answers whether the program can be
    installed as a keys instrument right now — the reference asks the
    cached Evaluation (midi_input.rs:267); EffectRunner.keys_candidate
    is that oracle.  Without one, a text heuristic approximates it."""
    from . import launchkey as lk
    from .ids import WaveformId, MarkId

    function_color = {None: lk.COLOR_BRIGHT_GREEN,
                      1: lk.COLOR_YELLOW_GREEN,
                      2: lk.COLOR_GOLDEN_ORANGE}.get(
        state.repeat_after_measures)
    if function_color is not None:
        launchkey.set_pad_function_color(function_color)

    _, beat_start, beat_duration = current_beat_info(now, status)
    if launchkey.pad_mode != lk.PAD_MODE_DAW:
        # Some other layout (Drum, Custom...) owns the pads — leave the
        # LEDs alone so we don't fight it (midi_input.rs:128-133).
        return
    bank_start = state.bank_start()
    programs = state.programs.programs
    if keys_candidate is None:
        keys_candidate = lambda i: _keys_candidate_text(programs[i])

    def program_at(index):
        return programs[index] if index < len(programs) else None

    for pad in range(lk.NUM_DAW_PADS_PER_ROW):
        index = bank_start + pad
        program = program_at(index)
        installed = state.keys_program == index
        if state.daw_pad_mode == "keys_installer":
            # Keys installer: top row dark; bottom row shows installable
            # programs, pulsing the installed one.  The INSTALLED program
            # lights regardless of its current text — the installed
            # function is what's actually playing (midi_input.rs:267-273).
            launchkey.set_daw_top_pad_color(pad, 0, 0, 0)
            if program is None or (not installed
                                   and (program.is_empty()
                                        or not keys_candidate(index))):
                launchkey.set_daw_bottom_pad_color(pad, 0, 0, 0)
                continue
            color = _pad_color_for(program)
            if installed:
                color = _pulsed(color, now, beat_start, beat_duration)
            launchkey.set_daw_bottom_pad_color(pad, *color)
            continue
        # Clip launcher (midi_input.rs:185-245).  Playback marks are
        # checked BEFORE emptiness: a still-sounding voice pulses its
        # pad even if the program text was just cleared
        # (midi_input.rs:200-212 orders it this way).
        if program is None:
            launchkey.set_daw_top_pad_color(pad, 0, 0, 0)
            launchkey.set_daw_bottom_pad_color(pad, 0, 0, 0)
            continue
        color = _pad_color_for(program)
        playing = status.has_active_mark(now, WaveformId.program(index),
                                         MarkId.TOP_LEVEL)
        keys_active = installed and any(
            getattr(m.waveform_id, "kind", None) == "key"
            for m in status.marks)
        if playing or keys_active:
            launchkey.set_daw_top_pad_color(
                pad, *_pulsed((0, lk.U7_MAX, 0), now, beat_start,
                              beat_duration))
        elif installed or program.is_empty():
            launchkey.set_daw_top_pad_color(pad, 0, 0, 0)
        else:
            launchkey.set_daw_top_pad_color(pad, *color)
        if status.has_pending_mark(now, WaveformId.program(index),
                                   MarkId.TOP_LEVEL):
            launchkey.set_daw_bottom_pad_color(pad, 0, 127, 0)
        elif installed:
            launchkey.set_daw_bottom_pad_color(
                pad, *_pulsed(color, now, beat_start, beat_duration))
        elif program.is_empty():
            launchkey.set_daw_bottom_pad_color(pad, 0, 0, 0)
        else:
            launchkey.set_daw_bottom_pad_color(pad, *color)


def _keys_candidate_text(program) -> bool:
    """Text-heuristic fallback for keys-installability (used only when
    no evaluation oracle is supplied): a function definition or a bare
    identifier reference could both evaluate to a keys instrument."""
    text = program.text.strip()
    return text.startswith("fn") or text.replace("_", "").isalnum()

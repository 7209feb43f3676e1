"""Keyboard input classifier: key chords -> pure Actions per mode.

The TPU build's counterpart of reference/src/lib/sdl2_input.rs.
Instead of SDL scancode/keymod events, keys arrive as chord strings
("enter", "C-a", "M-backspace", "S-M-enter", single characters), the
notation the REPL's `key` command and tests speak.  Modifier letters:
`C-` control, `M-` meta (the reference's cmd/gui), `S-` shift.

The classification table mirrors the reference keymap (README.md:55-83):
select-mode navigation and playback chords, emacs-style edit-mode cursor
and kill ops (char/line ops on Ctrl, word ops on Meta), completion on
M-/, undo/redo on C-z / S-C-z, and the computer-keyboard piano in Keys
mode (lower QWERTY row = white keys from C4, row above = sharps).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from . import actions as A
from .programs import PROGRAMS_PER_BANK

# QWERTY piano (sdl2_input.rs:15-37): z-row white keys, home-row sharps.
PIANO_KEYS: Dict[str, int] = {
    "z": 60, "s": 61, "x": 62, "d": 63, "c": 64, "v": 65, "g": 66,
    "b": 67, "h": 68, "n": 69, "j": 70, "m": 71, ",": 72, "l": 73,
    ".": 74, ";": 75, "/": 76,
}


def parse_chord(chord: str) -> Tuple[str, bool, bool, bool]:
    """Splits "S-C-M-key" into (key, ctrl, meta, shift)."""
    ctrl = meta = shift = False
    while len(chord) > 2 and chord[1] == "-":
        mod, chord = chord[0], chord[2:]
        if mod == "C":
            ctrl = True
        elif mod == "M":
            meta = True
        elif mod == "S":
            shift = True
        else:
            break
    return chord, ctrl, meta, shift


def classify_key(state: A.AppState, chord: str,
                 repeat: bool = False) -> List[object]:
    """Classifies a key-down chord into Actions for the current mode."""
    key, ctrl, meta, shift = parse_chord(chord)
    mode = state.mode
    i = state.active_program_index

    # Keys mode: piano notes (no retrigger on auto-repeat), escape out,
    # C-c still exits.
    if isinstance(mode, A.Keys):
        if key == "c" and ctrl:
            return [A.Exit()]
        if key == "escape":
            return [A.EnterSelectMode()]
        if repeat:
            return []
        note = PIANO_KEYS.get(key)
        if note is not None:
            # Computer keyboards have no velocity; mf.
            return [A.NoteOn(key=note, velocity=64)]
        return []

    if key == "c" and ctrl:
        return [A.Exit()]

    if isinstance(mode, A.Select):
        if key == "up":
            return [A.AdvanceProgram(-1)]
        if key == "down":
            return [A.AdvanceProgram(1)]
        if key == "right":
            return [A.AdvanceProgram(PROGRAMS_PER_BANK)]
        if key == "left":
            return [A.AdvanceProgram(-PROGRAMS_PER_BANK)]
        if key == "alt":
            return [A.EnterMoveSlidersMode()]
        if key == "escape":
            if meta:
                return [A.RemovePendingProgram(i), A.StopProgram(i)]
            return [A.RemovePendingProgram(i)]
        if key == "enter":
            if meta:
                return [A.PlayProgram(i, start_at_next_measure=True,
                                      repeat_after_measures=2 if shift
                                      else 1)]
            return [A.EnterEditMode()]
        if key == "D":
            return [A.DumpActiveWaveform()]
        if key == "K":
            return [A.ToggleInstalledKeys(i)]
        if key == "k":
            return [A.EnterKeysMode()]
        if key == "S":
            return [A.SaveAll()]
        if key in ("R", "L"):
            return [A.ReloadFile()]
        if key.isdigit() and 1 <= int(key) <= PROGRAMS_PER_BANK:
            return [A.SelectProgram(state.bank_start() + int(key) - 1)]
        return []

    if isinstance(mode, A.Edit):
        if key == "escape":
            if meta:
                # Stop the active waveform but stay in Edit mode.
                return [A.StopProgram(i)]
            return [A.EvaluateAndLeaveEditMode(mode_on_failure=A.Select())]
        if key == "enter":
            repeat_m = (2 if shift else 1) if meta else None
            return [A.EvaluateAndLeaveEditMode(mode_on_failure=mode),
                    A.PlayProgram(i, start_at_next_measure=True,
                                  repeat_after_measures=repeat_m)]
        # Char- and line-level ops on Ctrl, word ops on Meta (emacs).
        if ctrl:
            table = {"a": A.MoveCursorToStart(), "e": A.MoveCursorToEnd(),
                     "f": A.MoveCursorBy(1), "b": A.MoveCursorBy(-1),
                     "d": A.DeleteCharAfterCursor(),
                     "k": A.DeleteToEndOfLine()}
            if key in table:
                return [table[key]]
        if meta:
            table = {"f": A.MoveCursorToNextWord(),
                     "b": A.MoveCursorToPreviousWord(),
                     "d": A.DeleteWordAfterCursor(),
                     "backspace": A.DeleteWordBeforeCursor(),
                     "/": A.Complete()}
            if key in table:
                return [table[key]]
        if key == "z" and (ctrl or meta):
            return [A.Redo() if shift else A.Undo()]
        if key == "left":
            return [A.MoveCursorBy(-1)]
        if key == "right":
            return [A.MoveCursorBy(1)]
        if key == "home":
            return [A.MoveCursorToStart()]
        if key == "end":
            return [A.MoveCursorToEnd()]
        if key == "backspace":
            return [A.DeleteCharBeforeCursor()]
        if key == "delete":
            return [A.DeleteCharAfterCursor()]
        if key == "space":
            return [A.InsertText(" ")]
        if len(key) == 1 and not ctrl and not meta:
            return [A.InsertText(key)]
        return []

    if isinstance(mode, A.MoveSliders):
        return []

    return []


def classify_keyup(state: A.AppState, key: str) -> List[object]:
    """Key releases: piano NoteOff in ANY mode (avoids stuck notes when
    leaving Keys mode with a key held); alt release leaves slider mode."""
    note = PIANO_KEYS.get(key)
    if note is not None:
        return [A.NoteOff(key=note)]
    if isinstance(state.mode, A.MoveSliders) and key == "alt":
        return [A.EnterSelectMode()]
    return []


def classify_text(state: A.AppState, text: str) -> List[object]:
    """Raw text entry: inserted verbatim in Edit mode, ignored elsewhere
    (select-mode single characters route through classify_key)."""
    if isinstance(state.mode, A.Edit):
        return [A.InsertText(text)]
    return []

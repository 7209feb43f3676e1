"""Novation Launchkey MK4 protocol driver (hardware-free).

The TPU build's counterpart of reference/src/lib/launchkey.rs.  The
reference drives the controller through midir/midly OS MIDI ports; this
module speaks the same byte-level protocol over *abstract* ports — the
driver is constructed with a ``send(bytes)`` callable for the DAW-In port
and exposes ``feed_daw``/``feed_midi`` for bytes arriving on the DAW-Out
and MIDI-Out ports.  Any transport (a file of captured messages, a
network stream, a test harness, or a real OS MIDI binding supplied by
the embedder) can carry it; the protocol knowledge — the DAW-mode
handshake, relative-encoder feature toggle, pad RGB SysEx, display
strips, and the event decoding state machine — lives here, exactly
mirroring the reference driver:

  * DAW mode enter/exit handshake        launchkey.rs:180-186, drop (:666)
  * "DAW Encoder Relative output" toggle launchkey.rs:264-277
  * pad RGB SysEx (index + row offset)   launchkey.rs:279-303
  * pad-function button color CC         launchkey.rs:297-305
  * display configure / text fields      launchkey.rs:307-365
  * DAW-port decode (encoder/pad modes,
    navigation, relative encoders, pads) launchkey.rs:406-538
  * MIDI-port decode (notes)             launchkey.rs:546-580

Events are plain frozen dataclasses with the reference's taxonomy
(launchkey.rs:56-100); ``midi.classify_launchkey`` maps them to reducer
Actions like midi_input.rs:14 does.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Callable, Deque, Iterable, List, Optional

# -- modes (launchkey.rs:26-41) ---------------------------------------------

PLUGIN = "plugin"
MIXER = "mixer"

PAD_MODE_DAW = "daw"
PAD_MODE_OTHER = "other"

# -- protocol constants (launchkey.rs:116-166) --------------------------------

NUM_ENCODERS = 8
ENCODER_ABSOLUTE_CC_OFFSET = 21
ENCODER_DISPLAY_TARGET_OFFSET = ENCODER_ABSOLUTE_CC_OFFSET
ENCODER_RELATIVE_CC_OFFSET = 85
ENCODER_CHANNEL = 15            # channel 16, 0-indexed
ENCODER_RELATIVE_PIVOT = 0x40   # relative CC value 64 == no movement

FEATURE_CONTROL_CHANNEL = 6     # channel 7, 0-indexed
FEATURE_DAW_ENCODER_RELATIVE = 0x45

DAW_PAD_TOP_ROW_OFFSET = 96
DAW_PAD_BOTTOM_ROW_OFFSET = 112
NUM_DAW_PADS_PER_ROW = 8

ENCODER_MODE_CC = 30            # on channel 7
ENCODER_MODE_CHANNEL = 6
PAD_MODE_CC = 29                # 0x1D, same channel
PAD_MODE_DAW_VALUE = 2

PAD_FUNCTION_OFFSET = 105

DAW_MODE_DISPLAY_TARGET = 34

# Display arrangements (launchkey.rs:147-162).
DISPLAY_NAME_AND_TEXT = 1
DISPLAY_TRIGGER = 31
DISPLAY_ON_CHANGE = 1 << 6
DISPLAY_ON_TOUCH = 1 << 5
DISPLAY_ON_CHANGE_OR_TOUCH = DISPLAY_ON_CHANGE | DISPLAY_ON_TOUCH

# SysEx payload prefixes (launchkey.rs:163-167).
STANDARD_SKU_PREFIX = (0, 32, 41, 2, 20)
PAD_RGB_COLOR = (1, 67)
CONFIGURE_DISPLAY = (4,)
SET_DISPLAY_TEXT_FIELD = (6,)

# The controller's standard 128-entry color palette, by index
# (launchkey.rs:582-843 names all 128; the app itself uses these three
# for the pad-function button, midi_input.rs:108-118).
COLOR_BRIGHT_GREEN = 21
COLOR_YELLOW_GREEN = 85
COLOR_GOLDEN_ORANGE = 96

# Maximum 7-bit color channel the pads accept (midi_input.rs:158).
U7_MAX = 127


# -- events (launchkey.rs:56-100) ---------------------------------------------


@dataclass(frozen=True)
class NoteOn:
    key: int
    velocity: int


@dataclass(frozen=True)
class NoteOff:
    key: int


@dataclass(frozen=True)
class NextTrackDown:
    pass


@dataclass(frozen=True)
class PreviousTrackDown:
    pass


@dataclass(frozen=True)
class NextTrackBankDown:
    pass


@dataclass(frozen=True)
class PreviousTrackBankDown:
    pass


@dataclass(frozen=True)
class PluginEncoderChange:
    index: int
    delta: int  # positive = clockwise


@dataclass(frozen=True)
class MixerEncoderChange:
    index: int
    delta: int


@dataclass(frozen=True)
class DAWTopPadDown:
    index: int


@dataclass(frozen=True)
class DAWBottomPadDown:
    index: int


@dataclass(frozen=True)
class EncoderModeChanged:
    mode: str  # PLUGIN / MIXER


@dataclass(frozen=True)
class PadModeChanged:
    """Carries `previous` so the classifier can tell a same-mode
    re-selection (DAW -> DAW, the sub-mode cycling trigger) from a real
    transition (launchkey.rs:88-97)."""

    previous: str
    current: str


@dataclass(frozen=True)
class PadFunctionDown:
    pass


# -- the driver ----------------------------------------------------------------


def sysex(payload: Iterable[int]) -> bytes:
    """Frames a 7-bit payload as a complete SysEx message."""
    return bytes([0xF0, *(b & 0x7F for b in payload), 0xF7])


def _ascii(text: str) -> bytes:
    return bytes(ord(c) for c in text if ord(c) < 128)


class Launchkey:
    """Protocol state machine for one controller.

    ``daw_send`` carries bytes to the controller's "DAW In" port (the
    only port the reference writes to).  Incoming bytes are pushed via
    ``feed_daw`` / ``feed_midi``; decoded events queue on ``events``.

    ``encoder_mode`` / ``pad_mode`` are the *main-thread mirrors* the
    runner consults and updates (launchkey.rs:16-24); the decoder keeps
    its own independent state like the reference's DAWState.
    """

    def __init__(self, daw_send: Callable[[bytes], None]):
        self._send = daw_send
        self.events: Deque[object] = deque()
        # Main-side mirrors (launchkey.rs:231-239): entering DAW mode
        # resets pads to the DAW layout and encoders default to Plugin.
        self.encoder_mode = PLUGIN
        self.pad_mode = PAD_MODE_DAW
        # Decoder-side state (DAWState, launchkey.rs:44-49).
        self._daw_encoder_mode = PLUGIN
        self._daw_pad_mode = PAD_MODE_DAW
        # Enter DAW mode (launchkey.rs:180: note-on ch16, key 0x0C,
        # vel 0x7F) and switch the encoders to relative output.
        self._send(bytes([0x9F, 0x0C, 0x7F]))
        self.set_encoder_relative_output()

    # -- output ----------------------------------------------------------

    def close(self) -> None:
        """Reverts encoders to absolute output and leaves DAW mode
        (launchkey.rs Drop, :661-674)."""
        self._send(bytes([0xB0 | FEATURE_CONTROL_CHANNEL,
                          FEATURE_DAW_ENCODER_RELATIVE, 0]))
        self._send(bytes([0x9F, 0x0C, 0x00]))

    def set_encoder_relative_output(self) -> None:
        """(Re-)enables relative encoder deltas; the device resets this
        feature on every encoder-mode switch (launchkey.rs:264-271)."""
        self._send(bytes([0xB0 | FEATURE_CONTROL_CHANNEL,
                          FEATURE_DAW_ENCODER_RELATIVE, 127]))

    def _pad_color(self, pad_id: int, r: int, g: int, b: int) -> None:
        self._send(sysex([*STANDARD_SKU_PREFIX, *PAD_RGB_COLOR, pad_id,
                          min(r, 127), min(g, 127), min(b, 127)]))

    def set_daw_top_pad_color(self, index: int, r: int, g: int, b: int
                              ) -> None:
        self._pad_color(index + DAW_PAD_TOP_ROW_OFFSET, r, g, b)

    def set_daw_bottom_pad_color(self, index: int, r: int, g: int, b: int
                                 ) -> None:
        self._pad_color(index + DAW_PAD_BOTTOM_ROW_OFFSET, r, g, b)

    def set_pad_function_color(self, color: int) -> None:
        """Plain CC, not SysEx: the function button takes a palette
        index (launchkey.rs:297-305)."""
        self._send(bytes([0xB0, PAD_FUNCTION_OFFSET, color & 0x7F]))

    def _configure_display(self, target: int, arrangement: int) -> None:
        self._send(sysex([*STANDARD_SKU_PREFIX, *CONFIGURE_DISPLAY,
                          target, arrangement]))

    def _display_text(self, target: int, field: int, text: str) -> None:
        self._send(sysex([*STANDARD_SKU_PREFIX, *SET_DISPLAY_TEXT_FIELD,
                          target, field, *_ascii(text)]))

    def set_daw_mode_display(self, name: str) -> None:
        """Shows `name` on the DAW-mode display strip: configure, store
        the text, then trigger a redraw (launchkey.rs:307-333)."""
        self._configure_display(DAW_MODE_DISPLAY_TARGET,
                                DISPLAY_NAME_AND_TEXT)
        self._display_text(DAW_MODE_DISPLAY_TARGET, 0, name)
        self._configure_display(DAW_MODE_DISPLAY_TARGET, DISPLAY_TRIGGER)

    def set_encoder_display(self, index: int, name: str, value: str) -> None:
        """Name+value strip for one encoder, shown on touch or change
        (launchkey.rs:335-364)."""
        target = ENCODER_DISPLAY_TARGET_OFFSET + index
        self._configure_display(
            target, DISPLAY_NAME_AND_TEXT | DISPLAY_ON_CHANGE_OR_TOUCH)
        self._display_text(target, 0, name)
        self._display_text(target, 1, value)

    # -- input -----------------------------------------------------------

    def feed_daw(self, message: bytes) -> Optional[object]:
        """Decodes one message from the DAW-Out port; queues and returns
        the event (launchkey.rs DAWState::decode, :406-538)."""
        event = self._decode_daw(bytes(message))
        if event is not None:
            self.events.append(event)
        return event

    def feed_midi(self, message: bytes) -> Optional[object]:
        """Decodes one message from the MIDI-Out port (keys): note-on
        velocity 0 is a note-off; real note-off messages are ignored,
        matching the reference (launchkey.rs:560-575)."""
        message = bytes(message)
        if len(message) == 3 and message[0] & 0xF0 == 0x90:
            key, vel = message[1], message[2]
            event = NoteOn(key, vel) if vel > 0 else NoteOff(key)
            self.events.append(event)
            return event
        return None

    def drain(self) -> List[object]:
        out = list(self.events)
        self.events.clear()
        return out

    def _decode_daw(self, m: bytes) -> Optional[object]:
        if len(m) != 3:
            return None
        status, d1, d2 = m
        kind, ch = status & 0xF0, status & 0x0F
        if kind == 0xB0:
            # Encoder-mode report: channel 7, CC 30 (launchkey.rs:420).
            if ch == ENCODER_MODE_CHANNEL and d1 == ENCODER_MODE_CC:
                mode = {1: MIXER, 2: PLUGIN}.get(d2)
                if mode is None:
                    return None
                self._daw_encoder_mode = mode
                return EncoderModeChanged(mode)
            # Pad-mode report: same channel, CC 0x1D (launchkey.rs:439).
            if ch == ENCODER_MODE_CHANNEL and d1 == PAD_MODE_CC:
                new = (PAD_MODE_DAW if d2 == PAD_MODE_DAW_VALUE
                       else PAD_MODE_OTHER)
                previous, self._daw_pad_mode = self._daw_pad_mode, new
                return PadModeChanged(previous, new)
            # Navigation buttons fire on press only (launchkey.rs:452).
            if d2 == 127:
                nav = {102: NextTrackDown, 103: PreviousTrackDown,
                       108: NextTrackBankDown, 109: PreviousTrackBankDown}
                if d1 in nav:
                    return nav[d1]()
                if d1 == PAD_FUNCTION_OFFSET:
                    return PadFunctionDown()
            # Relative encoders: channel 16, CC 85-92 carry 64+delta
            # (launchkey.rs:462-481); route by the decoder's mode.
            if (ch == ENCODER_CHANNEL
                    and ENCODER_RELATIVE_CC_OFFSET <= d1
                    < ENCODER_RELATIVE_CC_OFFSET + NUM_ENCODERS):
                index = d1 - ENCODER_RELATIVE_CC_OFFSET
                delta = d2 - ENCODER_RELATIVE_PIVOT
                cls = (PluginEncoderChange
                       if self._daw_encoder_mode == PLUGIN
                       else MixerEncoderChange)
                return cls(index, delta)
            return None
        if kind == 0x90 and d2 > 0:
            # Pad presses arrive as note-ons; only the DAW layout owns
            # the pads (launchkey.rs:499-528).
            if self._daw_pad_mode != PAD_MODE_DAW:
                return None
            if (DAW_PAD_TOP_ROW_OFFSET <= d1
                    < DAW_PAD_TOP_ROW_OFFSET + NUM_DAW_PADS_PER_ROW):
                return DAWTopPadDown(d1 - DAW_PAD_TOP_ROW_OFFSET)
            if (DAW_PAD_BOTTOM_ROW_OFFSET <= d1
                    < DAW_PAD_BOTTOM_ROW_OFFSET + NUM_DAW_PADS_PER_ROW):
                return DAWBottomPadDown(d1 - DAW_PAD_BOTTOM_ROW_OFFSET)
        return None

"""Waveform and mark identifiers (port of reference/src/lib/ids.rs)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class WaveformId:
    kind: str  # "beats" | "program" | "key"
    index: int = 0

    @staticmethod
    def beats(even: bool) -> "WaveformId":
        return WaveformId("beats", int(even))

    @staticmethod
    def program(i: int) -> "WaveformId":
        return WaveformId("program", i)

    @staticmethod
    def key(note: int) -> "WaveformId":
        return WaveformId("key", note)

    @property
    def is_beats(self) -> bool:
        return self.kind == "beats"

    def __str__(self):
        return f"{self.kind}({self.index})"


@dataclass(frozen=True)
class MarkId:
    kind: str  # "top_level" | "slider" | "amplitude" | "terminator" | "user"
    label: Optional[str] = None
    index: int = 0

    TOP_LEVEL: "MarkId" = None  # set below
    AMPLITUDE: "MarkId" = None
    TERMINATOR: "MarkId" = None

    @staticmethod
    def slider(label: str) -> "MarkId":
        return MarkId("slider", label)

    @staticmethod
    def user(i: int) -> "MarkId":
        return MarkId("user", None, i)

    def __str__(self):
        if self.kind == "slider":
            return f'slider("{self.label}")'
        if self.kind == "user":
            return str(self.index)
        return {"top_level": "top-level", "amplitude": "amplitude",
                "terminator": "terminator"}.get(self.kind, self.kind)


MarkId.TOP_LEVEL = MarkId("top_level")
MarkId.AMPLITUDE = MarkId("amplitude")
MarkId.TERMINATOR = MarkId("terminator")

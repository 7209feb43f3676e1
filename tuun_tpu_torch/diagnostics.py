"""Error-source taxonomy and rustc-style snippet rendering.

Port of reference/src/lib/diagnostics.rs: spans carry a Source
identity (the program text, the surrounding file, or a numbered module) so
errors can be rendered with a caret snippet against the right text.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

from .expr import TuunError, line_col


@dataclass(frozen=True)
class Source:
    """Identity of a piece of parsed text."""

    kind: str  # "program" | "file" | "module"
    module_id: int = -1

    @staticmethod
    def program() -> "Source":
        return Source("program")

    @staticmethod
    def file() -> "Source":
        return Source("file")

    @staticmethod
    def module(module_id: int) -> "Source":
        return Source("module", module_id)


@dataclass
class Diagnostic:
    message: str
    file: Optional[str] = None
    position: Optional[Tuple[int, int]] = None  # 1-based (line, col)
    snippet: Optional[str] = None

    def __str__(self):
        loc = ""
        if self.file:
            loc += self.file
        if self.position:
            loc += f":{self.position[0]}:{self.position[1]}"
        if loc:
            return f"{loc}: {self.message}"
        return self.message


def render_snippet(source: str, start: int, end: int) -> str:
    """A rustc-style caret snippet for source[start:end]
    (diagnostics.rs:138-169)."""
    start = max(0, min(start, len(source)))
    end = max(start, min(end, len(source)))
    line_start = source.rfind("\n", 0, start) + 1
    line_end = source.find("\n", start)
    if line_end < 0:
        line_end = len(source)
    line_no, col = line_col(source, start)
    line_text = source[line_start:line_end]
    prefix = f"{line_no} | "
    width = max(1, min(end, line_end) - start)
    caret = " " * (len(prefix) + (start - line_start)) + "^" * width
    return f"{prefix}{line_text}\n{caret}"


def diagnose(error: TuunError, *, program_text: str = "",
             file_text: str = "", module_sources=None,
             module_names=None) -> Diagnostic:
    """Maps an error's span to the text it indexes into and renders a
    snippet (evaluator.rs:262-302)."""
    span = error.span
    if span is None or span.source is None:
        return Diagnostic(error.message)
    src: Source = span.source
    if src.kind == "program" and program_text:
        return Diagnostic(error.message, None, line_col(program_text, span.start),
                          render_snippet(program_text, span.start, span.end))
    if src.kind == "file" and file_text:
        return Diagnostic(error.message, None, line_col(file_text, span.start),
                          render_snippet(file_text, span.start, span.end))
    if src.kind == "module" and module_sources and \
            0 <= src.module_id < len(module_sources):
        text = module_sources[src.module_id]
        name = module_names[src.module_id] if module_names else None
        return Diagnostic(error.message, name, line_col(text, span.start),
                          render_snippet(text, span.start, span.end))
    return Diagnostic(error.message)

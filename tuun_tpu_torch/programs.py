"""Source-file program model.

Port of the batch-relevant parts of reference/src/lib/programs.rs:
a .tuun source file is a module whose *annotated* bindings are UI programs,
laid out in source order into 8 banks x 8 slots (with `skip_slots` gaps).
Each program carries its text, slider configs (with normalized positions),
color and level; evaluation context is the file's preceding bindings minus
`_` definitions plus the slider bindings.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

from . import parser
from .diagnostics import Source
from .expr import (ALevel, ASkipSlots, ASliders, AColor, BDef,
                   PIdent, Slider, SliderLinear, SliderUserDefined,
                   SourceBinding, TuunError)
from .ids import MarkId
from .sliders import append_slider_bindings

NUM_PROGRAM_BANKS = 8
PROGRAMS_PER_BANK = 8


@dataclass
class ProgramSliders:
    configs: List[Slider] = field(default_factory=list)
    normalized_values: List[float] = field(default_factory=list)

    @staticmethod
    def from_configs(configs: Sequence[Slider]) -> "ProgramSliders":
        normalized = []
        for c in configs:
            if isinstance(c.function, SliderLinear):
                f = c.function
                span = f.max - f.min
                normalized.append((f.initial_value - f.min) / span
                                  if span else 0.0)
            elif isinstance(c.function, SliderUserDefined):
                normalized.append(c.function.normalized_initial_value)
            else:
                normalized.append(0.0)
        return ProgramSliders(list(configs), normalized)


@dataclass
class Program:
    text: str
    span: Optional[Tuple[int, int]]
    binding_index: int
    sliders: ProgramSliders = field(default_factory=ProgramSliders)
    color: Optional[Tuple[int, int, int]] = None
    level_db: float = 0.0

    def is_empty(self) -> bool:
        return not self.text.strip()


class ProgramSet:
    """The parsed source file plus its slot-mapped programs."""

    def __init__(self, source: str, bindings: List[SourceBinding],
                 programs: List[Program], input_path: Optional[Path] = None,
                 all_bindings: bool = False):
        self.source = source
        self.bindings = bindings
        self.programs = programs
        self.input_path = input_path
        self._all_bindings = all_bindings

    @staticmethod
    def from_source(source: str, input_path: Optional[Path] = None,
                    all_bindings: bool = False
                    ) -> Tuple["ProgramSet", str]:
        """Parses the file; annotated bindings become programs
        (programs.rs:529-576). With all_bindings=True every definition is a
        program (for un-annotated corpus files like dtmf.tuun)."""
        bindings, errors = parser.parse_module(source, Source.file())
        message = ""
        if errors:
            more = f" (+{len(errors) - 1} more)" if len(errors) > 1 else ""
            message = f"Parse error: {errors[0].message}{more}"
        total = NUM_PROGRAM_BANKS * PROGRAMS_PER_BANK
        programs: List[Program] = [Program("", None, len(bindings))
                                   for _ in range(total)]
        position = 0
        for binding_index, sb in enumerate(bindings):
            program = _program_from_binding(sb, binding_index, source,
                                            all_bindings)
            if program is None:
                continue
            position += _read_skip_slots(sb)
            if position < total:
                programs[position] = program
            position += 1
        return (ProgramSet(source, bindings, programs, input_path,
                           all_bindings), message)

    def display_name(self, index: int) -> str:
        bank = index // PROGRAMS_PER_BANK
        slot = index % PROGRAMS_PER_BANK
        return f"{chr(ord('A') + bank)}{slot + 1}"

    # -- splice / persistence (programs.rs:980-1220) --------------------

    def _ui_neighbors(self, index: int
                      ) -> Tuple[Optional[int], Optional[int]]:
        """Slot positions of the nearest UI programs before and after
        `index` (programs with a source binding)."""
        prev_pos = next((i for i in range(index - 1, -1, -1)
                         if self.programs[i].span is not None), None)
        next_pos = next((i for i in range(index + 1, len(self.programs))
                         if self.programs[i].span is not None), None)
        return prev_pos, next_pos

    def _annotation_edits(self, slot: int, skip_slots: Optional[int] = None,
                          force: bool = False) -> List[Tuple[int, int, str]]:
        """Source edits rewriting slot `slot`'s annotation group(s) from
        the program's live state.  The first parsed `#{...}` group (by its
        parse-time span — a regex over the binding text truncates at a
        '}' inside a sliders string) is replaced with the regenerated set;
        any additional groups are deleted (the regenerated set already
        carries every annotation).  An un-annotated binding gains a fresh
        group line only when there is something to say."""
        program = self.programs[slot]
        sb = self.bindings[program.binding_index]
        if sb.span is None:
            return []
        has_group = bool(sb.anno_spans)
        new_anno = self.annotation_text(slot, skip_slots=skip_slots,
                                        force=force or has_group)
        if has_group:
            s, e = sb.anno_spans[0]
            edits = [(s, e, new_anno)]
            edits += [(s2, e2, "") for (s2, e2) in sb.anno_spans[1:]]
            return edits
        if not new_anno:
            return []
        # Un-annotated binding (all_bindings corpora): insert a fresh
        # annotation line before the first non-trivia char of the binding.
        text = self.source[sb.span.start:sb.span.end]
        pos = sb.span.start + _trivia_len(text)
        return [(pos, pos, new_anno + "\n")]

    def _annotation_group_edit(self, slot: int, skip_slots: int
                               ) -> List[Tuple[int, int, str]]:
        """Edits that rewrite slot `slot`'s annotation group so it carries
        `skip_slots` (the reference's skip_slots_edit,
        programs.rs:808-840); empty when the binding already does (any
        runtime divergence is then the divergence pass's job).  `level_db`
        is force-emitted so the regenerated group is never empty and the
        binding keeps its any-annotation-makes-a-UI-program status."""
        sb = self.bindings[self.programs[slot].binding_index]
        if _read_skip_slots(sb) == skip_slots:
            return []
        if not sb.anno_spans and skip_slots <= 0:
            return []
        return self._annotation_edits(slot, skip_slots=skip_slots,
                                      force=True)

    def _diverged(self, index: int) -> bool:
        """Does program `index`'s runtime state (level, color, slider
        positions) differ from what its source annotations parse back to?
        (The reference's ANNOTATION_EPSILON contract: a save never
        rewrites a binding whose runtime state still matches its
        source.)"""
        program = self.programs[index]
        sb = self.bindings[program.binding_index]
        base = _program_from_binding(sb, program.binding_index, self.source,
                                     self._all_bindings)
        if base is None:
            return True
        eps = 1e-4
        return not (abs(base.level_db - program.level_db) <= eps
                    and base.color == program.color
                    and len(base.sliders.normalized_values)
                    == len(program.sliders.normalized_values)
                    and all(abs(a - b) <= eps for a, b in
                            zip(base.sliders.normalized_values,
                                program.sliders.normalized_values)))

    def splice(self, index: int, new_text: str) -> Optional[str]:
        """Replaces program `index`'s expression text in the source and
        re-parses. Atomic: on a parse failure neither source nor programs
        change and the error message is returned (None on success).

        Padding slots (no source binding) are treated as brand-new
        programs: a fresh `_ = <text>;` binding with a
        `#{skip_slots=..., level_db=...}` annotation is inserted between
        its source-order neighbors and the following program's
        `skip_slots` is adjusted so its absolute slot stays stable.
        Splicing EMPTY text into an existing program deletes the whole
        binding (annotations included) and grows the following program's
        `skip_slots` to compensate (programs.rs:998-1103)."""
        program = self.programs[index]
        # Semicolons are never valid inside an expression and defeat the
        # parser's error recovery if spliced in (programs.rs:1001-1003).
        new_text = new_text.replace(";", "")
        is_new = program.span is None
        is_deletion = (not is_new) and not new_text.strip()

        edits: List[Tuple[int, int, str]] = []
        rewritten = set()  # slots whose annotation group is already edited
        if is_new:
            if not new_text.strip():
                return None  # padding slot still empty — nothing to do
            prev_pos, next_pos = self._ui_neighbors(index)
            new_skip = index - prev_pos - 1 if prev_pos is not None \
                else index
            parts = []
            if new_skip > 0:
                parts.append(f"skip_slots={new_skip}")
            # Always emit level_db so the new binding carries at least one
            # annotation (the "any annotation -> UI program" invariant);
            # a level set on the padding slot at runtime persists here.
            parts.append(f"level_db={_fmt(program.level_db)}")
            anno = "#{" + ",".join(parts) + "}"
            if next_pos is not None:
                nb = self.bindings[self.programs[next_pos].binding_index]
                anchor = nb.span.start
                more = self._annotation_group_edit(
                    next_pos, next_pos - index - 1)
                if more:
                    edits.extend(more)
                    rewritten.add(next_pos)
            else:
                anchor = len(self.source)
            prefix = "" if anchor == 0 or self.source[anchor - 1] == "\n" \
                else "\n"
            suffix = "" if anchor == len(self.source) \
                or self.source[anchor] == "\n" else "\n"
            edits.append((anchor, anchor,
                          f"{prefix}{anno}\n_ = {new_text};{suffix}"))
        elif is_deletion:
            # Remove the whole binding: leading trivia, annotations,
            # definition, terminating `;` and one trailing newline.
            sb = self.bindings[program.binding_index]
            if sb.span is None:
                return "binding has no span"
            end = sb.span.end
            if end < len(self.source) and self.source[end] == ";":
                end += 1
            # The trailing newline stays: it is the next binding's leading
            # trivia (spans start at leading trivia) and the separation
            # that remains after this binding's own leading "\n" goes.
            edits.append((sb.span.start, end, ""))
            rewritten.add(index)
            prev_pos, next_pos = self._ui_neighbors(index)
            if next_pos is not None:
                next_skip = next_pos - prev_pos - 1 \
                    if prev_pos is not None else next_pos
                more = self._annotation_group_edit(next_pos, next_skip)
                if more:
                    edits.extend(more)
                    rewritten.add(next_pos)
        else:
            start, end = program.span
            edits.append((start, end, new_text))

        # The reference persists every program's diverged runtime
        # annotations as part of splice (programs.rs annotation_edits,
        # ~:1148-1158) and realigns Program objects in place; this model
        # rebuilds from the re-parsed source, so divergence (level, color,
        # slider moves) must land in the source or the rebuild resets it.
        for i, p in enumerate(self.programs):
            if i in rewritten or p.span is None or p.is_empty():
                continue
            if self._diverged(i):
                edits.extend(self._annotation_edits(i))

        new_source = self.source
        for start, end, replacement in sorted(edits, reverse=True):
            new_source = (new_source[:start] + replacement +
                          new_source[end:])
        try:
            bindings, errors = parser.parse_module(new_source, Source.file())
        except TuunError as e:
            return e.message
        if errors:
            return errors[0].message
        fresh, _ = ProgramSet.from_source(new_source, self.input_path,
                                          all_bindings=self._all_bindings)
        # Carry exact runtime state across the rebuild (slots are stable
        # by construction: skip_slots compensation above).  The annotation
        # edits above already put the values in the source, but _fmt
        # rounds floats; the live objects keep full precision.  Slider
        # positions carry by label so a splice that renames a slider gets
        # the fresh initial value.
        for old_p, new_p in zip(self.programs, fresh.programs):
            by_label = dict(zip((c.label for c in old_p.sliders.configs),
                                old_p.sliders.normalized_values))
            for i, c in enumerate(new_p.sliders.configs):
                if c.label in by_label:
                    new_p.sliders.normalized_values[i] = by_label[c.label]
            if old_p.span is not None and new_p.span is not None:
                new_p.level_db = old_p.level_db
                new_p.color = old_p.color
        self.source = fresh.source
        self.bindings = fresh.bindings
        self.programs = fresh.programs
        return None

    def annotation_text(self, index: int, skip_slots: Optional[int] = None,
                        force: bool = False) -> str:
        """The #{...} annotation set reflecting the program's current
        state (sliders at their live values, level, color).  `skip_slots`
        overrides the binding's current value (None = keep it); with
        `force`, `level_db` is always emitted — a regenerated set is
        never empty, so the binding stays a UI program."""
        program = self.programs[index]
        parts = []
        if skip_slots is None and program.binding_index < len(self.bindings):
            skip_slots = _read_skip_slots(self.bindings[program.binding_index])
        if skip_slots:
            parts.append(f"skip_slots={skip_slots}")
        if program.color is not None:
            r, g, b = program.color
            parts.append(f"color=rgb({r}, {g}, {b})")
        if program.sliders.configs:
            entries = []
            for c, norm in zip(program.sliders.configs,
                               program.sliders.normalized_values):
                if isinstance(c.function, SliderLinear):
                    f = c.function
                    value = f.min + norm * (f.max - f.min)
                    entries.append(f'"{c.label}:{_fmt(value)}:{_fmt(f.min)}'
                                   f':{_fmt(f.max)}"')
                elif isinstance(c.function, SliderUserDefined):
                    entries.append(f'"{c.label}:{_fmt(norm)}'
                                   f':{c.function.function_source}"')
            parts.append("sliders=[" + ", ".join(entries) + "]")
        if program.level_db or force:
            parts.append(f"level_db={_fmt(program.level_db)}")
        return "#{" + ",".join(parts) + "}" if parts else ""

    def persist_annotations(self, index: int) -> Optional[str]:
        """Rewrites program `index`'s annotation set in the source so live
        slider/level changes survive a reload (the reference's S-key save
        path). Returns an error message or None."""
        program = self.programs[index]
        sb = self.bindings[program.binding_index]
        if sb.span is None:
            return "binding has no span"
        # No divergence from the parsed annotations -> no edit (the
        # reference's ANNOTATION_EPSILON contract: a save never rewrites
        # a binding whose runtime state still matches its source).
        if not self._diverged(index):
            return None
        # An existing group never vanishes (_annotation_edits forces
        # level_db then): dropping the last annotation would silently
        # demote the binding from UI program.
        edits = self._annotation_edits(index)
        if not edits:
            return None
        new_source = self.source
        for start, end, replacement in sorted(edits, reverse=True):
            new_source = (new_source[:start] + replacement +
                          new_source[end:])
        try:
            bindings, errors = parser.parse_module(new_source, Source.file())
        except TuunError as e:
            return e.message
        if errors:
            return errors[0].message
        fresh, _ = ProgramSet.from_source(new_source, self.input_path,
                                          all_bindings=self._all_bindings)
        for old_p, new_p in zip(self.programs, fresh.programs):
            new_p.sliders.normalized_values = list(
                old_p.sliders.normalized_values)
            if old_p.span is not None and new_p.span is not None:
                new_p.level_db = old_p.level_db
                new_p.color = old_p.color
        self.source = fresh.source
        self.bindings = fresh.bindings
        self.programs = fresh.programs
        return None

    def persist_all(self) -> List[str]:
        """persist_annotations for every non-empty program — any runtime
        divergence (slider positions, level changes on slider-less
        programs) lands in the source; no-divergence programs are
        untouched. Returns warning messages."""
        warnings = []
        for i, p in enumerate(self.programs):
            if not p.is_empty():
                err = self.persist_annotations(i)
                if err:
                    warnings.append(err)
        return warnings

    def save(self, path: Optional[Path] = None) -> None:
        """Writes the (possibly spliced) source back to disk."""
        target = path or self.input_path
        if target is None:
            raise ValueError("no path to save to")
        Path(target).write_text(self.source)

    def evaluation_bindings(self, index: int) -> List[SourceBinding]:
        """Context for evaluating program `index`: the file's bindings that
        precede it, minus `_` definitions, plus its slider bindings."""
        program = self.programs[index]
        out: List[SourceBinding] = []
        for i, sb in enumerate(self.bindings):
            if i >= program.binding_index:
                break
            if isinstance(sb.binding, BDef) and \
                    isinstance(sb.binding.pattern, PIdent) and \
                    sb.binding.pattern.name == "_":
                continue
            out.append(sb)
        append_slider_bindings(program.sliders.configs,
                               program.sliders.normalized_values,
                               MarkId.slider, out)
        return out


def _fmt(v: float) -> str:
    from .expr import fmt_f32
    return fmt_f32(v)


def _program_from_binding(sb: SourceBinding, binding_index: int, source: str,
                          all_bindings: bool) -> Optional[Program]:
    if not sb.annotations and not all_bindings:
        return None
    if not isinstance(sb.binding, BDef):
        return None
    sliders = ProgramSliders()
    color = None
    level_db = 0.0
    for anno in sb.annotations:
        if isinstance(anno, ASliders):
            sliders = ProgramSliders.from_configs(anno.sliders)
        elif isinstance(anno, AColor):
            color = (anno.r, anno.g, anno.b)
        elif isinstance(anno, ALevel):
            level_db = anno.level_db
    e = sb.binding.expr
    if e.span is None or e.span.end > len(source):
        return None
    text = source[e.span.start:e.span.end]
    return Program(text, (e.span.start, e.span.end), binding_index, sliders,
                   color, level_db)


def _trivia_len(text: str) -> int:
    """Length of the leading trivia (whitespace and `//` comments) of a
    binding's source text."""
    i = 0
    while i < len(text):
        if text[i].isspace():
            i += 1
        elif text.startswith("//", i):
            nl = text.find("\n", i)
            i = len(text) if nl < 0 else nl + 1
        else:
            break
    return i


def _read_skip_slots(sb: SourceBinding) -> int:
    for anno in sb.annotations:
        if isinstance(anno, ASkipSlots):
            return anno.count
    return 0


class EditHistory:
    """Undo/redo stack for one program's text (port of programs.rs's
    EditHistory): capped at 100 entries, with consecutive single-character
    insertions coalesced into one undo unit."""

    CAP = 100

    def __init__(self, initial: str):
        self._undo: List[str] = [initial]
        self._redo: List[str] = []
        self._coalescing = False

    @property
    def current(self) -> str:
        return self._undo[-1]

    def record(self, text: str, coalesce: bool = False) -> None:
        """Pushes a new state. With coalesce=True, a run of consecutive
        coalesced edits (e.g. typing) collapses into one undo step."""
        if text == self.current:
            return
        if coalesce and self._coalescing:
            self._undo[-1] = text
        else:
            self._undo.append(text)
            if len(self._undo) > self.CAP:
                self._undo.pop(0)
        self._coalescing = coalesce
        self._redo = []

    def undo(self) -> Optional[str]:
        if len(self._undo) < 2:
            return None
        self._redo.append(self._undo.pop())
        self._coalescing = False
        return self.current

    def redo(self) -> Optional[str]:
        if not self._redo:
            return None
        self._undo.append(self._redo.pop())
        self._coalescing = False
        return self.current

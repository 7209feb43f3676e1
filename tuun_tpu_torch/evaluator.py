"""App-level evaluation environment: prelude + module cache.

Port of reference/src/lib/evaluator.rs: the prelude holds the
built-ins plus environment-derived definitions (`tempo`, `sample_rate`,
`mark`, `debug`); modules resolve from `<library_root>/<path>.tuun` with an
mtime-checked cache, and every module/program gets an implicit leading
`open __prelude`.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from . import builtins as builtins_mod
from . import eval as eval_mod
from . import ir, parser
from .diagnostics import Diagnostic, Source, diagnose
from .expr import (BOpen, EBuiltIn, EError, EFloat, EFunction, ESeq,
                   EWaveform, Expr, SourceBinding, TuunError, definition)
from .ids import MarkId


def _mark_builtin(arguments: List[Expr]) -> Expr:
    """`mark(N)` wraps a waveform in Marked(UserDefined(N))
    (evaluator.rs:26-42)."""
    if len(arguments) == 1 and isinstance(arguments[0], EFloat) \
            and arguments[0].value >= 1.0 \
            and float(arguments[0].value).is_integer():
        n = int(round(arguments[0].value))
        return builtins_mod._curry(
            lambda w: ir.Marked(MarkId.user(n), w), f"mark({n})")
    return EError("Invalid argument for mark")


class Evaluator:
    """Owns the prelude and the module cache."""

    def __init__(self, sample_rate: int, tempo: int,
                 library_root: os.PathLike | str,
                 print_fn: Callable[[str], None] = print):
        prelude: List[SourceBinding] = []
        builtins_mod.add_bindings(prelude)
        prelude.append(definition("tempo", EFloat(float(tempo))))
        prelude.append(definition("sample_rate", EFloat(float(sample_rate))))
        prelude.append(definition("mark", EBuiltIn("mark", _mark_builtin)))
        prelude.append(definition("debug", builtins_mod.debug(print_fn)))
        self.prelude = prelude
        self.library_root = Path(library_root)
        # path -> (mtime, bindings)
        self._modules: Dict[Tuple[str, ...], Tuple[float, List[SourceBinding]]] = {}
        # module id -> (path, latest source)
        self.module_info: List[Tuple[Tuple[str, ...], str]] = []

    # ------------------------------------------------------------------

    def module_file_path(self, path: Sequence[str]) -> Path:
        return self.library_root.joinpath(*path[:-1], path[-1] + ".tuun")

    def resolve(self, path: Tuple[str, ...]) -> List[SourceBinding]:
        """Module resolver (evaluator.rs:156-229)."""
        if path == ("__prelude",):
            return self.prelude
        file_path = self.module_file_path(path)
        display = "/".join(path) + ".tuun"
        try:
            mtime = file_path.stat().st_mtime
        except OSError as e:
            raise TuunError(f"Failed to stat module {display}: {e}")
        cached = self._modules.get(tuple(path))
        if cached is not None and cached[0] == mtime:
            return cached[1]
        try:
            contents = file_path.read_text()
        except OSError as e:
            raise TuunError(f"Failed to read module {display}: {e}")
        module_id = self._record_module_info(tuple(path), contents)
        bindings, errors = parser.parse_module(contents, Source.module(module_id))
        if errors:
            raise errors[0]
        bindings.insert(0, SourceBinding(BOpen(("__prelude",))))
        self._modules[tuple(path)] = (mtime, bindings)
        return bindings

    def _record_module_info(self, path: Tuple[str, ...], source: str) -> int:
        for i, (p, _) in enumerate(self.module_info):
            if p == path:
                self.module_info[i] = (path, source)
                return i
        self.module_info.append((path, source))
        return len(self.module_info) - 1

    # ------------------------------------------------------------------

    def evaluate_source(self, text: str,
                        bindings: Optional[Sequence[SourceBinding]] = None,
                        opens: Sequence[str] = ()) -> Expr:
        """Parses and evaluates `text` under `bindings` (defaults to an
        implicit `open __prelude`, plus any module names in `opens`)."""
        if bindings is None:
            bindings = [SourceBinding(BOpen(("__prelude",)))]
            bindings += [SourceBinding(BOpen(tuple(o.split("."))))
                         for o in opens]
        expr = parser.parse_program(text, Source.program())
        return eval_mod.evaluate(self.resolve, bindings, expr)

    def evaluate_program(self, text: str,
                         extra_bindings: Sequence[SourceBinding] = ()
                         ) -> "Evaluation":
        """Evaluates program text and classifies the result
        (evaluator.rs:325-375)."""
        bindings = [SourceBinding(BOpen(("__prelude",)))]
        bindings.extend(extra_bindings)
        try:
            value = self.evaluate_source(text, bindings)
        except TuunError as e:
            return Evaluation.invalid([self.diagnose(e, program_text=text)])
        if isinstance(value, EWaveform):
            return Evaluation.waveform(value.waveform)
        if isinstance(value, ESeq):
            if isinstance(value.waveform, EWaveform):
                return Evaluation.waveform(value.waveform.waveform)
            return Evaluation.invalid([Diagnostic(
                "Program is not a waveform or keys instrument")])
        if isinstance(value, (EFunction, EBuiltIn)):
            # Sanity check: invoke with dummy note/velocity arguments.
            try:
                self.apply_note_function(value, [EFloat(60.0), EFloat(0.7)])
            except TuunError as e:
                return Evaluation.invalid([self.diagnose(e, program_text=text)])
            return Evaluation.keys(value)
        return Evaluation.invalid([Diagnostic(
            "Program is not a waveform or keys instrument")])

    def program_context(self, program_set, index: int
                        ) -> List[Tuple[str, Expr]]:
        """The evaluated (name, value) context a program's expression sees
        — prelude, preceding file bindings, slider bindings — most
        recently bound last.  Used by identifier completion and parameter
        hints (the reference's evaluator::program_context)."""
        bindings = [SourceBinding(BOpen(("__prelude",)))]
        bindings += program_set.evaluation_bindings(index)
        return eval_mod.evaluate_bindings(self.resolve, bindings)

    def apply_note_function(self, function: Expr, args: List[Expr]
                            ) -> Tuple[ir.Waveform, ir.Waveform]:
        """Evaluates `(note, velocity) -> (note_on, note_off)`
        (evaluator.rs:400-446)."""
        from .expr import EApply, ETuple
        result = eval_mod.evaluate_closed(EApply(function, args))
        def as_wf(e: Expr) -> ir.Waveform:
            if isinstance(e, EWaveform):
                return e.waveform
            if isinstance(e, ESeq) and isinstance(e.waveform, EWaveform):
                return e.waveform.waveform
            if isinstance(e, EFloat):
                return ir.Const(e.value)
            raise TuunError("Note function must return waveforms")
        if isinstance(result, ETuple) and len(result.exprs) == 2:
            return as_wf(result.exprs[0]), as_wf(result.exprs[1])
        # A single waveform is treated as note_on with a trivial note_off.
        return as_wf(result), ir.Const(1.0)

    def diagnose(self, error: TuunError, program_text: str = "",
                 file_text: str = "") -> Diagnostic:
        return diagnose(
            error, program_text=program_text, file_text=file_text,
            module_sources=[s for _, s in self.module_info],
            module_names=["/".join(p) + ".tuun" for p, _ in self.module_info])


class Evaluation:
    """Result of evaluating a program (evaluator.rs Evaluation enum)."""

    def __init__(self, kind: str, value: Any = None,
                 diagnostics: Optional[List[Diagnostic]] = None):
        self.kind = kind  # "waveform" | "keys" | "invalid"
        self.value = value
        self.diagnostics = diagnostics or []

    @staticmethod
    def waveform(w: ir.Waveform) -> "Evaluation":
        return Evaluation("waveform", w)

    @staticmethod
    def keys(fn: Expr) -> "Evaluation":
        return Evaluation("keys", fn)

    @staticmethod
    def invalid(diags: List[Diagnostic]) -> "Evaluation":
        return Evaluation("invalid", None, diags)

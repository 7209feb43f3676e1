"""Expression AST for the Tuun language.

Mirrors the reference AST (reference/src/lib/expr.rs:152-196): values
(bool/float/string/waveform/function/builtin/seq), if-then-else, variables,
applications with named arguments, tuples, lists, and error placeholders.
Spans are byte ranges into the source text plus a source identity tag, used
for diagnostics; the precedence-aware printer round-trips with the parser.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional, Tuple

import numpy as np

from . import ir

F32 = np.float32


def f32(x) -> float:
    """Rounds to f32 precision — all language-level floats are f32."""
    return float(F32(x))


# ---------------------------------------------------------------------------
# Spans & errors
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Span:
    start: int
    end: int
    source: Any = None  # stamped source identity (see diagnostics.Source)

    def stamped(self, source) -> "Span":
        return Span(self.start, self.end, source)


class TuunError(Exception):
    """An evaluation or parse error with an optional source span."""

    def __init__(self, message: str, span: Optional[Span] = None):
        super().__init__(message)
        self.message = message
        self.span = span

    def __repr__(self):
        return f"TuunError({self.message!r}, {self.span})"

    def __str__(self):
        return self.message


# ---------------------------------------------------------------------------
# Patterns
# ---------------------------------------------------------------------------


class Pattern:
    __slots__ = ()


@dataclass(frozen=True)
class PIdent(Pattern):
    name: str

    def __str__(self):
        return self.name


@dataclass(frozen=True)
class PTuple(Pattern):
    patterns: Tuple[Pattern, ...]

    def __str__(self):
        return "(" + ", ".join(str(p) for p in self.patterns) + ")"


def pattern_names(p: Pattern, out: List[str]) -> None:
    if isinstance(p, PIdent):
        out.append(p.name)
    else:
        for q in p.patterns:
            pattern_names(q, out)


# ---------------------------------------------------------------------------
# Expressions
# ---------------------------------------------------------------------------


class Expr:
    """Base class. `span` is set by the parser; synthesized nodes carry None."""

    __slots__ = ("span",)

    def __init__(self):
        self.span: Optional[Span] = None

    def with_span(self, start: int, end: int) -> "Expr":
        self.span = Span(start, end)
        return self

    def __repr__(self):  # pragma: no cover
        return f"{type(self).__name__}({format_expr(self)})"


class EBool(Expr):
    __slots__ = ("value",)

    def __init__(self, value: bool):
        super().__init__()
        self.value = value


class EFloat(Expr):
    __slots__ = ("value",)

    def __init__(self, value: float):
        super().__init__()
        self.value = f32(value)


class EString(Expr):
    __slots__ = ("value",)

    def __init__(self, value: str):
        super().__init__()
        self.value = value


class EWaveform(Expr):
    __slots__ = ("waveform",)

    def __init__(self, waveform: ir.Waveform):
        super().__init__()
        self.waveform = waveform


class ESeq(Expr):
    """A sequence-able waveform: (offset waveform, payload waveform).

    In value form both components are EWaveform (expr.rs:171-175)."""

    __slots__ = ("offset", "waveform")

    def __init__(self, offset: Expr, waveform: Expr):
        super().__init__()
        self.offset = offset
        self.waveform = waveform


class EFunction(Expr):
    __slots__ = ("positional", "named", "body")

    def __init__(self, positional, named, body):
        super().__init__()
        self.positional: List[Pattern] = list(positional)
        self.named: List[Tuple[str, Expr]] = list(named)
        self.body: Expr = body


class EBuiltIn(Expr):
    __slots__ = ("name", "fn")

    def __init__(self, name: str, fn: Callable[[List[Expr]], Expr]):
        super().__init__()
        self.name = name
        self.fn = fn


class EIf(Expr):
    __slots__ = ("condition", "then", "else_")

    def __init__(self, condition, then, else_):
        super().__init__()
        self.condition = condition
        self.then = then
        self.else_ = else_


class EVar(Expr):
    __slots__ = ("name",)

    def __init__(self, name: str):
        super().__init__()
        self.name = name


class EApply(Expr):
    __slots__ = ("function", "positional", "named")

    def __init__(self, function, positional, named=()):
        super().__init__()
        self.function: Expr = function
        self.positional: List[Expr] = list(positional)
        self.named: List[Tuple[str, Expr]] = list(named)


class ETuple(Expr):
    __slots__ = ("exprs",)

    def __init__(self, exprs):
        super().__init__()
        self.exprs: List[Expr] = list(exprs)


class EList(Expr):
    __slots__ = ("exprs",)

    def __init__(self, exprs):
        super().__init__()
        self.exprs: List[Expr] = list(exprs)


class EError(Expr):
    __slots__ = ("message",)

    def __init__(self, message: str):
        super().__init__()
        self.message = message


def error_placeholder() -> EError:
    return EError("_")


# ---------------------------------------------------------------------------
# Bindings & annotations
# ---------------------------------------------------------------------------


@dataclass
class SliderFunction:
    pass


@dataclass
class SliderLinear(SliderFunction):
    initial_value: float
    min: float
    max: float


@dataclass
class SliderUserDefined(SliderFunction):
    normalized_initial_value: float
    function_source: str


@dataclass
class Slider:
    label: str
    function: SliderFunction


class Annotation:
    pass


@dataclass
class ASliders(Annotation):
    sliders: List[Slider]


@dataclass
class AColor(Annotation):
    r: int
    g: int
    b: int


@dataclass
class ALevel(Annotation):
    level_db: float


@dataclass
class ASkipSlots(Annotation):
    count: int


class Binding:
    pass


@dataclass
class BOpen(Binding):
    path: Tuple[str, ...]


@dataclass
class BDef(Binding):
    pattern: Pattern
    expr: Expr


@dataclass
class BEmpty(Binding):
    """Trailing-trivia placeholder (anchors comments at end of file)."""


@dataclass
class SourceBinding:
    binding: Binding
    annotations: List[Annotation] = field(default_factory=list)
    span: Optional[Span] = None
    # Absolute (start, end) of each `#{...}` annotation group in the
    # source, in parse order.  Annotation rewrites (splice/persist) edit
    # these spans directly — a regex scan over the binding text truncates
    # at the first '}' inside a sliders string (the reference keeps
    # parsed per-annotation spans for the same reason, programs.rs:729).
    anno_spans: List[Tuple[int, int]] = field(default_factory=list)


def definition(name: str, expr: Expr) -> SourceBinding:
    return SourceBinding(BDef(PIdent(name), expr))


# ---------------------------------------------------------------------------
# Printer (precedence-aware; round-trips with the parser)
# ---------------------------------------------------------------------------

# Precedence levels, higher binds tighter (expr.rs:601-611).
P_FOLLOWED = 10
P_REVERSE_APP = 20
P_RELATIONAL = 30
P_ADDITIVE = 40
P_MULTIPLICATIVE = 50
P_UNARY = 60
P_APPLICATION = 70
P_ATOM = 80

_BINOP_PREC = {
    "*": P_MULTIPLICATIVE, "/": P_MULTIPLICATIVE, "~*": P_MULTIPLICATIVE,
    "+": P_ADDITIVE, "-": P_ADDITIVE, "&": P_ADDITIVE,
    "==": P_RELATIONAL, "!=": P_RELATIONAL, "<": P_RELATIONAL,
    "<=": P_RELATIONAL, ">": P_RELATIONAL, ">=": P_RELATIONAL,
    "|": P_REVERSE_APP, "\\": P_FOLLOWED,
}

_UNARY_OPS = frozenset("!@$%-?")


def fmt_f32(v: float) -> str:
    x = F32(v)
    if np.isnan(x):
        return "NaN"
    if np.isinf(x):
        return "inf" if x > 0 else "-inf"
    if x == int(x) and abs(x) < 1e10:
        return str(int(x))
    return np.format_float_positional(x, unique=True, trim="-")


def _as_let_binding(e: EApply):
    """Single-binding function-literal application <=> `let` (expr.rs:687-706)."""
    f = e.function
    if (isinstance(f, EFunction) and not e.named and not f.named
            and len(f.positional) == 1 and len(e.positional) == 1):
        return f.positional[0], e.positional[0], f.body
    return None


def _sugar_kind(e: Expr) -> Optional[str]:
    """"chord" / "sequence" when `e` is the sugar desugaring `{x}` ->
    __chord(x) / `<x>` -> __sequence(x) (parser.rs:706,719), else None."""
    if isinstance(e, EApply) and isinstance(e.function, EVar) \
            and not e.named and len(e.positional) == 1 \
            and e.function.name in ("__chord", "__sequence"):
        return e.function.name[2:]
    return None


def expr_precedence(e: Expr) -> int:
    if isinstance(e, (EBool, EFloat, EString, EVar, EWaveform, EBuiltIn,
                      ETuple, EList, EError)):
        return P_ATOM
    if isinstance(e, ESeq):
        return P_APPLICATION
    if isinstance(e, EApply):
        if _sugar_kind(e) is not None:
            return P_ATOM  # {...} / <...> print self-delimited
        if e.named:
            return P_APPLICATION
        if isinstance(e.function, EVar):
            op = e.function.name
            if len(e.positional) == 2 and op in _BINOP_PREC:
                return _BINOP_PREC[op]
            if len(e.positional) == 1 and op in _UNARY_OPS:
                return P_UNARY
        if _as_let_binding(e) is not None:
            return P_FOLLOWED
        if len(e.positional) == 1 and isinstance(e.function, EApply):
            return P_REVERSE_APP
        return P_APPLICATION
    if isinstance(e, (EFunction, EIf)):
        return P_FOLLOWED
    return P_ATOM


def format_expr(e: Expr) -> str:
    return _fmt(e)


def _paren(e: Expr, parent_prec: int, *, strict: bool = False) -> str:
    # Sequence sugar is ALWAYS parenthesized in operator contexts: printed
    # bare, its closing `>` is swallowed on re-parse whenever the next
    # token can start an expression (`<[a]> - b` parses the body as
    # `[a] > -b` — the grammar quirk shared with the reference).  Bare
    # placement is safe only in delimited positions (list/tuple/call
    # elements, sugar bodies, if/let keyword boundaries, top level),
    # which call _fmt directly.
    if _sugar_kind(e) == "sequence":
        return f"({_fmt(e)})"
    p = expr_precedence(e)
    need = p < parent_prec or (strict and p == parent_prec)
    s = _fmt(e)
    return f"({s})" if need else s


def _fmt(e: Expr) -> str:
    if isinstance(e, EBool):
        return "true" if e.value else "false"
    if isinstance(e, EFloat):
        return fmt_f32(e.value)
    if isinstance(e, EString):
        return f'"{e.value}"'
    if isinstance(e, EWaveform):
        return ir.format_waveform(e.waveform)
    if isinstance(e, ESeq):
        return f"seq({_fmt(e.offset)})({_fmt(e.waveform)})"
    if isinstance(e, EBuiltIn):
        return e.name
    if isinstance(e, EVar):
        return e.name
    if isinstance(e, EError):
        return f"error({e.message!r})"
    if isinstance(e, EFunction):
        params = [str(p) for p in e.positional]
        params += [f"{n} = {_fmt(v)}" for n, v in e.named]
        return f"fn({', '.join(params)}) => {_fmt(e.body)}"
    if isinstance(e, EIf):
        return (f"if {_fmt(e.condition)} then {_fmt(e.then)} "
                f"else {_fmt(e.else_)}")
    if isinstance(e, ETuple):
        return "(" + ", ".join(_fmt(x) for x in e.exprs) + ")"
    if isinstance(e, EList):
        return "[" + ", ".join(_fmt(x) for x in e.exprs) + "]"
    if isinstance(e, EApply):
        sugar = _sugar_kind(e)
        if sugar == "chord":
            return "{" + _fmt(e.positional[0]) + "}"
        if sugar == "sequence":
            return "<" + _fmt(e.positional[0]) + ">"
        # let-shaped chains
        lb = _as_let_binding(e)
        if lb is not None:
            bindings = []
            while lb is not None:
                pat, arg, body = lb
                bindings.append(f"{pat} = {_fmt(arg)}")
                nxt = _as_let_binding(body) if isinstance(body, EApply) else None
                if nxt is None:
                    return (f"let {', '.join(bindings)} in {_fmt(body)}")
                lb = nxt
        if isinstance(e.function, EVar) and not e.named:
            op = e.function.name
            if len(e.positional) == 2 and op in _BINOP_PREC:
                prec = _BINOP_PREC[op]
                # An open-ended construct (let/fn/if swallows everything
                # to its right when re-parsed) must be parenthesized as
                # a LHS even at equal precedence: `(let v = b in c) \ d`
                # printed bare re-parses with `\ d` inside the let body.
                # (At strictly-higher parent precedence _paren already
                # parenthesizes it, and same-op chains are right-closed
                # by the strict rhs below.)
                lhs_e = e.positional[0]
                open_ended = isinstance(lhs_e, (EIf, EFunction)) or (
                    isinstance(lhs_e, EApply)
                    and _as_let_binding(lhs_e) is not None)
                lhs = _paren(lhs_e, prec, strict=open_ended)
                rhs = _paren(e.positional[1], prec, strict=True)
                return f"{lhs} {op} {rhs}"
            if len(e.positional) == 1 and op in _UNARY_OPS:
                # A unary operand is grammatically a PRIMITIVE (the
                # reference's parse_unary_application takes
                # parse_primitive): an application operand must be
                # parenthesized or `%(f(x))` reprints as `%f(x)`, which
                # re-parses as `(%f)(x)`.
                operand = e.positional[0]
                p = expr_precedence(operand)
                s = _fmt(operand)
                if (p != P_ATOM and p != P_UNARY) \
                        or _sugar_kind(operand) == "sequence":
                    s = f"({s})"
                return f"{op}{s}"
        # single-argument application of an application prints as a pipe
        if len(e.positional) == 1 and not e.named and \
                isinstance(e.function, EApply):
            arg = _paren(e.positional[0], P_REVERSE_APP)
            # `|` parses left-associative, so a pipe-shaped FUNCTION
            # operand needs parens: `?x | ((a, b) | f)` printed bare
            # re-parses as `(?x | (a, b)) | f`.
            fn = _paren(e.function, P_REVERSE_APP, strict=True)
            return f"{arg} | {fn}"
        fn = _paren(e.function, P_APPLICATION)
        args = [_fmt(a) for a in e.positional]
        args += [f"{n} = {_fmt(v)}" for n, v in e.named]
        return f"{fn}({', '.join(args)})"
    return object.__repr__(e)


def line_col(source: str, offset: int) -> Tuple[int, int]:
    """1-based (line, column) of a byte offset."""
    line = source.count("\n", 0, offset) + 1
    nl = source.rfind("\n", 0, offset)
    return line, offset - nl

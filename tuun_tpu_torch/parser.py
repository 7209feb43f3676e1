"""Recursive-descent parser for the Tuun expression language.

Grammar and behavior mirror the reference parser
(reference/src/lib/parser.rs): precedence `\\` < `|` < relational <
`+ - &` < `* / ~*` < application < unary < atoms; `{e}` desugars to
`__chord(e)`, `<e>` to `__sequence(e)`, `let p = e, ... in b` to nested
single-parameter applications; `//` line comments are trivia; annotations
`#{sliders=[...], color=rgb(..), level_db=.., skip_slots=N}` attach to
bindings; recoverable errors (missing delimiters / expressions) are recorded
and parsing continues with placeholders.
"""

from __future__ import annotations

import re
from typing import Any, Callable, List, Optional, Tuple

from .expr import (AColor, ALevel, ASkipSlots, ASliders, Annotation, BDef,
                   BEmpty, BOpen, EApply, EError, EFloat, EFunction,
                   EIf, EList, EString, ETuple, EVar, Expr, PIdent, PTuple,
                   Pattern, Slider, SliderLinear, SliderUserDefined,
                   SourceBinding, Span, TuunError, error_placeholder, f32)

_KEYWORDS = frozenset(["fn", "let", "in", "if", "then", "else", "open"])
_UNARY_OPS = "!@$%-?"

_FLOAT_RE = re.compile(r"(\d+(\.\d*)?|\.\d+)([eE][+-]?\d+)?")
_SIGNED_FLOAT_RE = re.compile(r"[+-]?(\d+(\.\d*)?|\.\d+)([eE][+-]?\d+)?")
_IDENT_RE = re.compile(r"(_?[A-Za-z0-9][A-Za-z0-9_#]*)")
_IDENT_CONT_RE = re.compile(r"[A-Za-z0-9_#]")


class _Fail(Exception):
    """Internal soft-failure for backtracking; never escapes the parser."""


class Parser:
    def __init__(self, src: str, source: Any = None):
        self.src = src
        self.pos = 0
        self.errors: List[TuunError] = []
        self.source = source

    # ------------------------------------------------------------------
    # low-level machinery
    # ------------------------------------------------------------------

    def _span(self, start: int, end: Optional[int] = None) -> Span:
        return Span(start, self.pos if end is None else end, self.source)

    def fail(self) -> "_Fail":
        return _Fail()

    def attempt(self, fn: Callable[[], Any]):
        """Runs fn; on soft failure restores position and returns None."""
        save = self.pos
        nerr = len(self.errors)
        try:
            return fn()
        except _Fail:
            self.pos = save
            del self.errors[nerr:]
            return None

    def expect(self, fn: Callable[[], Any], message: str):
        """nom-style `expect`: record a recoverable error and continue."""
        save = self.pos
        try:
            return fn()
        except _Fail:
            self.pos = save
            self.errors.append(TuunError(message, self._span(save, save)))
            return None

    def report(self, message: str, start: int, end: int) -> None:
        self.errors.append(TuunError(message, Span(start, end, self.source)))

    def eof(self) -> bool:
        return self.pos >= len(self.src)

    def peek(self) -> str:
        return self.src[self.pos] if self.pos < len(self.src) else ""

    def tag(self, s: str) -> str:
        if self.src.startswith(s, self.pos):
            self.pos += len(s)
            return s
        raise self.fail()

    def keyword(self, s: str) -> str:
        """A tag that must not be followed by an identifier character."""
        if self.src.startswith(s, self.pos):
            nxt = self.pos + len(s)
            if nxt >= len(self.src) or not _IDENT_CONT_RE.match(self.src[nxt]):
                self.pos = nxt
                return s
        raise self.fail()

    def trivia0(self) -> None:
        src, n = self.src, len(self.src)
        while self.pos < n:
            c = src[self.pos]
            if c.isspace():
                self.pos += 1
            elif src.startswith("//", self.pos):
                nl = src.find("\n", self.pos)
                self.pos = n if nl < 0 else nl
            else:
                return

    def trivia1(self) -> None:
        start = self.pos
        self.trivia0()
        if self.pos == start:
            raise self.fail()

    def sep_list(self, item: Callable[[], Any], sep: Callable[[], Any],
                 at_least_one: bool = False) -> List[Any]:
        out = []
        first = self.attempt(item)
        if first is None:
            if at_least_one:
                raise self.fail()
            return out
        out.append(first)
        while True:
            save = self.pos

            def step():
                sep()
                r = item()
                return r
            nxt = self.attempt(step)
            if nxt is None:
                self.pos = save
                return out
            out.append(nxt)

    def comma_ws(self) -> None:
        self.trivia0()
        self.tag(",")
        self.trivia0()

    # ------------------------------------------------------------------
    # atoms
    # ------------------------------------------------------------------

    def parse_float(self) -> Expr:
        start = self.pos
        m = _FLOAT_RE.match(self.src, self.pos)
        if not m:
            raise self.fail()
        self.pos = m.end()
        e = EFloat(float(m.group(0)))
        e.span = self._span(start)
        return e

    def parse_string(self) -> Expr:
        start = self.pos
        self.tag('"')
        end = self.src.find('"', self.pos)
        if end < 0:
            raise self.fail()
        value = self.src[self.pos:end]
        self.pos = end + 1
        e = EString(value)
        e.span = self._span(start)
        return e

    def parse_identifier(self) -> str:
        m = _IDENT_RE.match(self.src, self.pos)
        if m and not m.group(0).startswith("__"):
            name = m.group(0)
            if name not in _KEYWORDS:
                self.pos = m.end()
                return name
        c = self.peek()
        if c and c in _UNARY_OPS:
            self.pos += 1
            return c
        # A lone underscore (bindable, not referencable).
        if c == "_":
            nxt = self.src[self.pos + 1:self.pos + 2]
            if not nxt or not (_IDENT_CONT_RE.match(nxt)):
                self.pos += 1
                return "_"
        raise self.fail()

    def parse_pattern(self) -> Pattern:
        c = self.peek()
        if c == "(":
            self.tag("(")
            self.trivia0()
            pats = self.sep_list(self.parse_pattern,
                                 lambda: (self.trivia0(), self.tag(","),
                                          self.trivia0()))
            self.trivia0()
            self.expect(lambda: self.tag(")"),
                        "expected ')' at end of tuple pattern")
            return PTuple(tuple(pats))
        return PIdent(self.parse_identifier())

    # ------------------------------------------------------------------
    # functions / let / if
    # ------------------------------------------------------------------

    def parse_named_item(self, missing: str) -> Tuple[str, Expr]:
        name = self.parse_identifier()
        self.trivia0()
        self.tag("=")
        if self.peek() == "=":  # reject `==`
            raise self.fail()
        self.trivia0()
        value = self.expect(self.parse_expr, missing)
        return name, value if value is not None else error_placeholder()

    def parse_function(self) -> Expr:
        start = self.pos
        self.keyword("fn")
        self.trivia0()
        self.tag("(")
        self.trivia0()

        def parameter():
            pstart = self.pos
            named = self.attempt(lambda: self.parse_named_item(
                "expected default expression after '=' in parameter"))
            if named is not None:
                return (pstart, self.pos, "named", named)
            return (pstart, self.pos, "pos", self.parse_pattern())

        params = self.sep_list(parameter, self.comma_ws)
        self.trivia0()
        self.expect(lambda: self.tag(")"),
                    "expected ')' at end of parameter list")
        self.trivia0()
        self.expect(lambda: self.tag("=>"), "expected '=>'")
        self.trivia0()
        body = self.parse_expr()
        end = self.pos

        positional: List[Pattern] = []
        named: List[Tuple[str, Expr]] = []
        names: List[str] = []
        from .expr import pattern_names
        for pstart, pend, kind, item in params:
            if kind == "pos":
                if named:
                    msg = "positional arguments should appear before named ones"
                    self.report(msg, pstart, pend)
                    e = EError(msg)
                    e.span = self._span(start, end)
                    return e
                pattern_names(item, names)
                positional.append(item)
            else:
                nm, val = item
                if nm in names:
                    msg = f'named parameter "{nm}" appears more than once'
                    self.report(msg, pstart, pend)
                    e = EError(msg)
                    e.span = self._span(start, end)
                    return e
                names.append(nm)
                named.append((nm, val))
        e = EFunction(positional, named, body)
        e.span = self._span(start, end)
        return e

    def parse_import_path(self) -> Tuple[str, ...]:
        parts = self.sep_list(self.parse_identifier, lambda: self.tag("."),
                              at_least_one=True)
        return tuple(parts)

    def parse_binding(self) -> SourceBinding:
        start = self.pos  # includes leading trivia (parser.rs:368-371)
        self.trivia0()
        if self.pos == len(self.src):
            raise self.fail()
        annos: List[Annotation] = []
        anno_spans: List[Tuple[int, int]] = []
        while True:
            aset_start = self.pos
            got = self.attempt(self.parse_annotation_set)
            if got is None:
                break
            annos.extend(got)
            anno_spans.append((aset_start, self.pos))
            self.trivia0()

        def open_binding():
            self.keyword("open")
            self.trivia1()
            return BOpen(self.parse_import_path())

        binding = self.attempt(open_binding)
        if binding is None:
            pattern = self.parse_pattern()
            self.trivia0()
            self.expect(lambda: self.tag("="), "expected '=' in definition")
            self.trivia0()
            expr = self.attempt(self.parse_expr)
            if expr is None:
                # Consume everything up to ';' as a recoverable error.
                estart = self.pos
                semi = self.src.find(";", self.pos)
                self.pos = len(self.src) if semi < 0 else semi
                msg = "expected expression in definition"
                self.report(msg, estart, self.pos)
                expr = EError(msg)
                expr.span = self._span(estart)
            binding = BDef(pattern, expr)
        self.trivia0()
        return SourceBinding(binding, annos, self._span(start), anno_spans)

    def parse_let(self) -> Expr:
        start = self.pos
        self.keyword("let")
        bindings = self.sep_list(self.parse_binding, lambda: self.tag(","),
                                 at_least_one=True)
        self.attempt(lambda: (self.tag(","), self.trivia0()))
        self.expect(lambda: self.keyword("in"), "expected 'in'")
        self.trivia1()
        self.trivia0()
        # No trailing-trivia consumption: `let` is a primitive, and a
        # caller like parse_if needs the whitespace before its own
        # following keyword (`... then let x = 1 in x else ...` must
        # leave the space before `else` for the if's trivia1).
        body = self.expect(self.parse_expr, "expected expression after 'in'")
        end = self.pos
        if body is None:
            body = error_placeholder()
        definitions = []
        for sb in bindings:
            if isinstance(sb.binding, BDef):
                definitions.append((sb.binding.pattern, sb.binding.expr))
            elif isinstance(sb.binding, BOpen):
                self.errors.append(TuunError(
                    "`open` is not allowed inside `let`; use it at the top level",
                    sb.span))
        expr = body
        for pattern, value in reversed(definitions):
            expr = EApply(EFunction([pattern], [], expr), [value])
        expr.span = self._span(start, end)
        return expr

    def parse_if(self) -> Expr:
        start = self.pos
        self.keyword("if")
        self.trivia1()
        condition = self.parse_expr()
        self.trivia1()
        self.keyword("then")
        self.trivia1()
        then = self.parse_expr()
        self.trivia1()
        self.keyword("else")
        self.trivia1()
        else_ = self.parse_expr()
        e = EIf(condition, then, else_)
        e.span = self._span(start)
        return e

    # ------------------------------------------------------------------
    # primitives and applications
    # ------------------------------------------------------------------

    def parse_unary_application(self) -> Expr:
        start = self.pos
        c = self.peek()
        if not c or c not in _UNARY_OPS:
            raise self.fail()
        self.pos += 1
        op = EVar(c)
        op.span = self._span(start, start + 1)
        operand = self.parse_primitive()
        e = EApply(op, [operand])
        e.span = self._span(start)
        return e

    def parse_variable(self) -> Expr:
        start = self.pos
        # `__`-prefixed names may be referenced but not bound.
        m = re.compile(r"__[A-Za-z0-9_#]*").match(self.src, self.pos)
        if m:
            self.pos = m.end()
            name = m.group(0)
        else:
            name = self.parse_identifier()
        if name == "_":
            raise self.fail()
        e = EVar(name)
        e.span = self._span(start)
        return e

    def parse_chord(self) -> Expr:
        return self._bracketed("{", "}", "__chord",
                               "expected '}' at end of chord")

    def parse_sequence(self) -> Expr:
        return self._bracketed("<", ">", "__sequence",
                               "expected '>' at end of sequence")

    def _bracketed(self, open_c, close_c, fn_name, err) -> Expr:
        start = self.pos
        self.tag(open_c)
        self.trivia0()
        inner = self.parse_expr()
        self.trivia0()
        self.expect(lambda: self.tag(close_c), err)
        e = EApply(EVar(fn_name), [inner])
        e.span = self._span(start)
        return e

    def parse_tuple(self) -> Expr:
        start = self.pos
        self.tag("(")
        self.trivia0()
        exprs = self.sep_list(self.parse_expr, self.comma_ws)
        self.trivia0()
        self.expect(lambda: self.tag(")"), "expected ')' at end of tuple")
        if len(exprs) == 1:
            return exprs[0]
        e = ETuple(exprs)
        e.span = self._span(start)
        return e

    def parse_list(self) -> Expr:
        start = self.pos
        self.tag("[")
        self.trivia0()
        exprs = self.sep_list(self.parse_expr, self.comma_ws)
        self.trivia0()
        self.expect(lambda: self.tag("]"), "expected ']' at end of list")
        e = EList(exprs)
        e.span = self._span(start)
        return e

    def parse_primitive(self) -> Expr:
        for fn in (self.parse_float, self.parse_string, self.parse_function,
                   self.parse_let, self.parse_if,
                   self.parse_unary_application, self.parse_variable,
                   self.parse_chord, self.parse_sequence, self.parse_tuple,
                   self.parse_list):
            got = self.attempt(fn)
            if got is not None:
                return got
        raise self.fail()

    def parse_arguments(self) -> Tuple[List[Expr], List[Tuple[str, Expr]]]:
        args_start = self.pos
        self.tag("(")
        self.trivia0()

        def argument():
            astart = self.pos
            named = self.attempt(lambda: self.parse_named_item(
                "expected expression after '=' in named argument"))
            if named is not None:
                return (astart, self.pos, "named", named)
            return (astart, self.pos, "pos", self.parse_expr())

        arguments = self.sep_list(argument, self.comma_ws)
        self.trivia0()
        self.expect(lambda: self.tag(")"), "expected ')' at end of arguments")
        args_end = self.pos

        positional: List[Expr] = []
        named: List[Tuple[str, Expr]] = []
        for astart, aend, kind, item in arguments:
            if kind == "pos":
                if named:
                    msg = "positional arguments should appear before named ones"
                    self.report(msg, astart, aend)
                    e = EError(msg)
                    e.span = self._span(args_start, args_end)
                    return [e], []
                positional.append(item)
            else:
                nm, val = item
                if any(n == nm for n, _ in named):
                    msg = f'named parameter "{nm}" appears more than once'
                    self.report(msg, astart, aend)
                    e = EError(msg)
                    e.span = self._span(args_start, args_end)
                    return [e], []
                named.append((nm, val))
        return positional, named

    def parse_application(self) -> Expr:
        start = self.pos
        result = self.parse_primitive()
        while True:
            def step():
                self.trivia0()
                return self.parse_arguments()
            got = self.attempt(step)
            if got is None:
                return result
            positional, named = got
            result = EApply(result, positional, named)
            result.span = self._span(start)

    def _fold_binary(self, operand: Callable[[], Expr],
                     ops: Tuple[str, ...]) -> Expr:
        start = self.pos
        expr = operand()
        while True:
            save = self.pos

            def step():
                self.trivia0()
                for op in ops:
                    if self.src.startswith(op, self.pos):
                        # `<` must not swallow `<=`; ops are ordered
                        # longest-first so prefixes are safe.
                        op_start = self.pos
                        self.pos += len(op)
                        self.trivia0()
                        return op, op_start
                raise self.fail()
            got = self.attempt(step)
            if got is None:
                self.pos = save
                return expr
            op, op_start = got
            rhs = self.expect(operand, "expected expression after operator")
            if rhs is None:
                rhs = error_placeholder()
            op_var = EVar(op)
            op_var.span = self._span(op_start, op_start + len(op))
            expr = EApply(op_var, [expr, rhs])
            expr.span = self._span(start)

    def parse_multiplicative(self) -> Expr:
        return self._fold_binary(self.parse_application, ("~*", "*", "/"))

    def parse_additive(self) -> Expr:
        return self._fold_binary(self.parse_multiplicative, ("+", "-", "&"))

    def parse_relational(self) -> Expr:
        # No error recovery on missing rhs (mirrors parse_relational's plain
        # parse_additive call).
        start = self.pos
        expr = self.parse_additive()
        while True:
            save = self.pos

            def step():
                self.trivia0()
                for op in ("==", "!=", "<=", ">=", "<", ">"):
                    if self.src.startswith(op, self.pos):
                        op_start = self.pos
                        self.pos += len(op)
                        self.trivia0()
                        rhs = self.parse_additive()
                        return op, op_start, rhs
                raise self.fail()
            got = self.attempt(step)
            if got is None:
                self.pos = save
                return expr
            op, op_start, rhs = got
            op_var = EVar(op)
            op_var.span = self._span(op_start, op_start + len(op))
            expr = EApply(op_var, [expr, rhs])
            expr.span = self._span(start)

    def parse_reverse_application(self) -> Expr:
        start = self.pos
        argument = self.parse_relational()
        while True:
            save = self.pos

            def step():
                self.trivia0()
                self.tag("|")
                self.trivia0()
                return True
            if self.attempt(step) is None:
                self.pos = save
                return argument
            function = self.expect(self.parse_relational,
                                   "expected expression after | operator")
            if function is None:
                function = error_placeholder()
            argument = EApply(function, [argument])
            argument.span = self._span(start)

    def parse_expr(self) -> Expr:
        start = self.pos
        expr = self.parse_reverse_application()
        while True:
            save = self.pos

            def step():
                self.trivia0()
                self.tag("\\")
                self.trivia0()
                return True
            if self.attempt(step) is None:
                self.pos = save
                return expr
            rhs = self.expect(self.parse_reverse_application,
                              "expected expression after \\ operator")
            if rhs is None:
                rhs = error_placeholder()
            expr = EApply(EVar("\\"), [expr, rhs])
            expr.span = self._span(start)

    # ------------------------------------------------------------------
    # annotations
    # ------------------------------------------------------------------

    def parse_annotation_set(self) -> List[Annotation]:
        self.tag("#")
        self.trivia0()
        self.tag("{")
        self.trivia0()
        annos = self.sep_list(self.parse_annotation,
                              lambda: (self.trivia0(), self.tag(","),
                                       self.trivia0()))
        self.trivia0()
        self.tag("}")
        return annos

    def parse_annotation(self) -> Annotation:
        for fn in (self.parse_sliders_anno, self.parse_color,
                   self.parse_level, self.parse_skip_slots):
            got = self.attempt(fn)
            if got is not None:
                return got
        raise self.fail()

    def _signed_float(self) -> float:
        m = _SIGNED_FLOAT_RE.match(self.src, self.pos)
        if not m:
            raise self.fail()
        self.pos = m.end()
        return f32(float(m.group(0)))

    def parse_sliders_anno(self) -> Annotation:
        self.tag("sliders=")
        self.trivia0()
        self.tag("[")
        self.trivia0()
        sliders = self.sep_list(self.parse_slider,
                                lambda: (self.trivia0(), self.tag(","),
                                         self.trivia0()))
        self.trivia0()
        self.tag("]")
        return ASliders(sliders)

    def parse_slider(self) -> Slider:
        """`"label:initial:min:max"` (linear) or `"label:initial:fn-expr"`."""
        self.tag('"')
        m = re.compile(r'[^:"\],\s]+').match(self.src, self.pos)
        if not m:
            raise self.fail()
        label = m.group(0)
        self.pos = m.end()
        self.tag(":")
        init_start = self.pos
        initial = self._signed_float()
        self.tag(":")
        nxt = self.peek()
        if nxt.isdigit() or nxt in "-.":
            mn = self._signed_float()
            self.tag(":")
            mx = self._signed_float()
            if mn > initial or mx < initial:
                self.report(
                    f"initial value {initial} is not between min {mn} and "
                    f"max {mx}", init_start, self.pos)
                raise self.fail()
            self.tag('"')
            return Slider(label, SliderLinear(initial, mn, mx))
        end = self.src.find('"', self.pos)
        if end < 0:
            raise self.fail()
        fn_source = self.src[self.pos:end].strip()
        self.pos = end + 1
        return Slider(label, SliderUserDefined(initial, fn_source))

    def parse_color(self) -> Annotation:
        self.tag("color=rgb(")
        self.trivia0()
        r = int(self._signed_float())
        self.trivia0()
        self.tag(",")
        self.trivia0()
        g = int(self._signed_float())
        self.trivia0()
        self.tag(",")
        self.trivia0()
        b = int(self._signed_float())
        self.trivia0()
        self.tag(")")
        for v in (r, g, b):
            if not 0 <= v <= 255:
                raise self.fail()
        return AColor(r, g, b)

    def parse_level(self) -> Annotation:
        self.tag("level_db=")
        return ALevel(self._signed_float())

    def parse_skip_slots(self) -> Annotation:
        self.tag("skip_slots=")
        m = re.compile(r"\d+").match(self.src, self.pos)
        if not m:
            raise self.fail()
        self.pos = m.end()
        return ASkipSlots(int(m.group(0)))


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def _unexpected_input(src: str, pos: int) -> str:
    rest = src[pos:]
    first_line = rest.split("\n", 1)[0]
    text = first_line[:30]
    if not text:
        return "unexpected end of input"
    if len(text) < len(first_line):
        text += "…"
    return f"unexpected input '{text}'"


def parse_program(src: str, source: Any = None) -> Expr:
    """Parses one expression; raises TuunError (carrying all recoverable
    errors via `.all_errors`) on failure. (parser.rs:848-871)"""
    p = Parser(src, source)
    p.trivia0()
    expr = p.attempt(p.parse_expr)
    p.trivia0()
    if expr is None or not p.eof():
        err = TuunError(_unexpected_input(src, p.pos),
                        Span(p.pos, len(src), source))
        err.all_errors = p.errors + [err]
        raise err
    if p.errors:
        err = p.errors[0]
        err.all_errors = p.errors
        raise err
    return expr


def parse_module(src: str, source: Any = None
                 ) -> Tuple[List[SourceBinding], List[TuunError]]:
    """Parses `binding ; ...`, returning bindings plus recoverable errors.
    Raises TuunError on a hard failure. (parser.rs:879-935)"""
    p = Parser(src, source)
    bindings: List[SourceBinding] = []
    while True:
        save = p.pos

        def step():
            b = p.parse_binding()
            p.tag(";")
            return b
        got = p.attempt(step)
        if got is None:
            p.pos = save
            break
        if got.span is not None:
            got.span = Span(got.span.start, got.span.end + 1, source)
        bindings.append(got)
    trivia_start = p.pos
    p.trivia0()
    if not p.eof():
        raise TuunError(_unexpected_input(src, p.pos),
                        Span(p.pos, len(src), source))
    if p.pos > trivia_start:
        bindings.append(SourceBinding(BEmpty(), [],
                                      Span(trivia_start, p.pos, source)))
    return bindings, p.errors


def parse_sliders(src: str) -> List[Slider]:
    """Parses a bare `["label:init:min:max", ...]` list (web-component API)."""
    p = Parser("sliders=" + src)
    anno = p.parse_sliders_anno()
    p.trivia0()
    if not p.eof():
        raise TuunError(_unexpected_input(p.src, p.pos))
    return anno.sliders

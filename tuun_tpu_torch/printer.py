"""Source-preserving (Recast-style) printer.

Port of the reference's `print_preserving` / `print_preserving_module`
(expr.rs:992-1075): reproduce an expression using the original source text
verbatim for every subtree whose nodes all still carry spans, and fall
back to the structural precedence printer for regions synthesized or
mutated in memory — recursing so that clean sub-subtrees still splice
their original text (whitespace and comments included).

The structural fallback loses trivia inside the dirty region (we no
longer know where in the source it sat) but always emits syntactically
valid text that re-parses to the same AST.
"""

from __future__ import annotations

from typing import List, Optional

from .expr import (Annotation, BDef, BEmpty, BOpen, EApply, EBool, EBuiltIn,
                   EError, EFloat, EFunction, EIf, EList, ESeq, EString,
                   ETuple, EVar, EWaveform, Expr, SourceBinding, format_expr)
from . import expr as _e


def _children(e: Expr) -> List[Expr]:
    if isinstance(e, EApply):
        return [e.function, *e.positional, *(v for _, v in e.named)]
    if isinstance(e, EFunction):
        return [*(v for _, v in e.named), e.body]
    if isinstance(e, EIf):
        return [e.condition, e.then, e.else_]
    if isinstance(e, (ETuple, EList)):
        return list(e.exprs)
    if isinstance(e, ESeq):
        return [e.offset, e.waveform]
    return []


def is_clean(e: Expr) -> bool:
    """True when `e` and every node under it still carry parse spans —
    i.e. the subtree is untouched since parsing and its original source
    text can be spliced verbatim (expr.rs:940-985)."""
    if e.span is None:
        return False
    return all(is_clean(c) for c in _children(e))


def print_preserving(e: Expr, source: str) -> str:
    if e.span is not None and is_clean(e):
        return source[e.span.start:e.span.end]
    return _structural(e, source)


def _pp(e: Expr, source: str, parent_prec: int, *, strict: bool = False
        ) -> str:
    """Child renderer for the structural fallback: splice when clean,
    recurse otherwise, parenthesizing by precedence either way."""
    # Sequence sugar always parenthesizes in operator contexts — printed
    # bare its closing `>` is swallowed when the following token can
    # start an expression (same rule as expr._paren).
    if _e._sugar_kind(e) == "sequence":
        if e.span is not None and is_clean(e):
            return f"({source[e.span.start:e.span.end]})"
        return f"({_structural(e, source)})"
    if e.span is not None and is_clean(e):
        # Spliced source text carries its own grouping only when the span
        # included parens; re-wrap when precedence demands it.
        p = _e.expr_precedence(e)
        txt = source[e.span.start:e.span.end]
        if p < parent_prec or (strict and p == parent_prec):
            return f"({txt})"
        return txt
    p = _e.expr_precedence(e)
    txt = _structural(e, source)
    if p < parent_prec or (strict and p == parent_prec):
        return f"({txt})"
    return txt


def _structural(e: Expr, source: str) -> str:
    if isinstance(e, (EBool, EFloat, EString, EWaveform, EBuiltIn, EVar,
                      EError)):
        return format_expr(e)
    if isinstance(e, ESeq):
        return (f"seq({print_preserving(e.offset, source)})"
                f"({print_preserving(e.waveform, source)})")
    if isinstance(e, EFunction):
        params = [str(p) for p in e.positional]
        params += [f"{n} = {print_preserving(v, source)}"
                   for n, v in e.named]
        return (f"fn({', '.join(params)}) => "
                f"{print_preserving(e.body, source)}")
    if isinstance(e, EIf):
        return (f"if {print_preserving(e.condition, source)} then "
                f"{print_preserving(e.then, source)} else "
                f"{print_preserving(e.else_, source)}")
    if isinstance(e, ETuple):
        return "(" + ", ".join(print_preserving(x, source)
                               for x in e.exprs) + ")"
    if isinstance(e, EList):
        return "[" + ", ".join(print_preserving(x, source)
                               for x in e.exprs) + "]"
    if isinstance(e, EApply):
        sugar = _e._sugar_kind(e)
        if sugar == "chord":
            return "{" + print_preserving(e.positional[0], source) + "}"
        if sugar == "sequence":
            return "<" + print_preserving(e.positional[0], source) + ">"
        if isinstance(e.function, EVar) and not e.named:
            op = e.function.name
            if len(e.positional) == 2 and op in _e._BINOP_PREC:
                prec = _e._BINOP_PREC[op]
                # Open-ended LHS (let/fn/if) needs parens even at equal
                # precedence — same rule as format_expr: printed bare it
                # swallows ` op rhs` into its body on re-parse.
                lhs_e = e.positional[0]
                open_ended = isinstance(lhs_e, (EIf, EFunction)) or (
                    isinstance(lhs_e, EApply)
                    and _e._as_let_binding(lhs_e) is not None)
                lhs = _pp(lhs_e, source, prec, strict=open_ended)
                rhs = _pp(e.positional[1], source, prec, strict=True)
                return f"{lhs} {op} {rhs}"
            if len(e.positional) == 1 and op in _e._UNARY_OPS:
                # A unary operand is grammatically a primitive: any
                # non-atom, non-unary operand must parenthesize
                # (`%(f(x))` printed `%f(x)` re-parses as `(%f)(x)`).
                operand = e.positional[0]
                p_op = _e.expr_precedence(operand)
                if p_op == _e.P_ATOM or p_op == _e.P_UNARY:
                    return op + _pp(operand, source, _e.P_UNARY,
                                    strict=True)
                return f"{op}({print_preserving(operand, source)})"
        fn = _pp(e.function, source, _e.P_APPLICATION)
        args = [print_preserving(a, source) for a in e.positional]
        args += [f"{n} = {print_preserving(v, source)}" for n, v in e.named]
        return f"{fn}({', '.join(args)})"
    return format_expr(e)


def _clean_span(b: SourceBinding) -> Optional[tuple]:
    """The binding's verbatim span, or None when anything inside was
    mutated since parsing (expr.rs:1043-1056). Binding spans include the
    leading `#{...}` annotation set, so annotations splice with them."""
    if b.span is None:
        return None
    if isinstance(b.binding, BDef) and not is_clean(b.binding.expr):
        return None
    return (b.span.start, b.span.end)


def print_preserving_module(bindings: List[SourceBinding],
                            source: str) -> str:
    """Round-trips a module's bindings back to source text: untouched
    bindings splice verbatim (keeping comments/whitespace inside their
    spans); mutated ones re-emit structurally as valid `;`-terminated
    forms (expr.rs:1005-1040)."""
    out: List[str] = []
    for b in bindings:
        span = _clean_span(b)
        if span is not None:
            out.append(source[span[0]:span[1]])
            continue
        if b.annotations:
            parts = [_annotation_to_text(a) for a in b.annotations]
            out.append(f"#{{{', '.join(parts)}}}\n")
        if isinstance(b.binding, BDef):
            out.append(f"{b.binding.pattern} = "
                       f"{print_preserving(b.binding.expr, source)};\n")
        elif isinstance(b.binding, BOpen):
            out.append(f"open {'.'.join(b.binding.path)};\n")
        elif isinstance(b.binding, BEmpty):
            pass  # annotations (if any) were emitted above
    return "".join(out)


def _annotation_to_text(a: Annotation) -> str:
    from .expr import (AColor, ALevel, ASkipSlots, ASliders, SliderLinear,
                       SliderUserDefined, fmt_f32)
    if isinstance(a, ASliders):
        entries = []
        for s in a.sliders:
            f = s.function
            if isinstance(f, SliderLinear):
                entries.append(f'"{s.label}:{fmt_f32(f.initial_value)}:'
                               f'{fmt_f32(f.min)}:{fmt_f32(f.max)}"')
            elif isinstance(f, SliderUserDefined):
                entries.append(
                    f'"{s.label}:{fmt_f32(f.normalized_initial_value)}:'
                    f'{f.function_source}"')
        return f"sliders=[{', '.join(entries)}]"
    if isinstance(a, AColor):
        return f"color=rgb({a.r}, {a.g}, {a.b})"
    if isinstance(a, ALevel):
        return f"level_db={fmt_f32(a.level_db)}"
    if isinstance(a, ASkipSlots):
        return f"skip_slots={a.count}"
    return ""

"""Call-by-value evaluation by substitution.

Port of the reference evaluator (reference/src/lib/eval.rs): a context
of (name, closed value) entries is substituted into an expression, which is
then reduced.  Named parameter defaults are evaluated once — when the
function value is created — and call sites may override them by name.
`open` resolves through a caller-supplied module resolver and does not
re-export what the opened module merely opened itself.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

from .expr import (BDef, BEmpty, BOpen, EApply, EBool, EBuiltIn, EError,
                   EFloat, EFunction, EIf, EList, ESeq, EString, ETuple, EVar,
                   EWaveform, Expr, PIdent, PTuple, Pattern, SourceBinding,
                   TuunError)

Context = List[Tuple[str, Expr]]


def _extend_trivial(context: Context, pattern: Pattern) -> None:
    """Binds each name in the pattern to itself (shadowing outer entries)."""
    if isinstance(pattern, PIdent):
        context.append((pattern.name, EVar(pattern.name)))
    else:
        for p in pattern.patterns:
            _extend_trivial(context, p)


def substitute(context: Sequence[Tuple[str, Expr]], e: Expr) -> Expr:
    """Substitutes closed values for variables (eval.rs:39-161)."""
    if isinstance(e, (EBool, EFloat, EString, EWaveform, EBuiltIn, EError)):
        return e
    if isinstance(e, ESeq):
        return _respan(ESeq(substitute(context, e.offset),
                            substitute(context, e.waveform)), e)
    if isinstance(e, EFunction):
        # Named defaults see the incoming context, not the parameters.
        named = [(n, substitute(context, v)) for n, v in e.named]
        inner = list(context)
        for p in e.positional:
            _extend_trivial(inner, p)
        for n, _ in named:
            inner.append((n, EVar(n)))
        return _respan(EFunction(e.positional, named,
                                 substitute(inner, e.body)), e)
    if isinstance(e, EVar):
        for name, value in reversed(context):
            if name == e.name:
                return value
        return _respan(EError(f"Variable '{e.name}' not found in context"), e)
    if isinstance(e, EIf):
        return _respan(EIf(substitute(context, e.condition),
                           substitute(context, e.then),
                           substitute(context, e.else_)), e)
    if isinstance(e, EApply):
        return _respan(EApply(
            substitute(context, e.function),
            [substitute(context, a) for a in e.positional],
            [(n, substitute(context, v)) for n, v in e.named]), e)
    if isinstance(e, ETuple):
        return _respan(ETuple([substitute(context, x) for x in e.exprs]), e)
    if isinstance(e, EList):
        return _respan(EList([substitute(context, x) for x in e.exprs]), e)
    raise TypeError(f"unknown expr {type(e)}")


def _respan(new: Expr, old: Expr) -> Expr:
    new.span = old.span
    return new


def _extend_context(context: Context, pattern: Pattern, argument: Expr) -> None:
    if isinstance(pattern, PIdent):
        context.append((pattern.name, argument))
        return
    if isinstance(pattern, PTuple) and isinstance(argument, ETuple):
        if len(pattern.patterns) != len(argument.exprs):
            raise TuunError(
                f"Mismatched number of elements in pattern {pattern} and "
                f"arguments {argument}", argument.span)
        for p, a in zip(pattern.patterns, argument.exprs):
            _extend_context(context, p, a)
        return
    raise TuunError(
        f"Pattern {pattern} does not match actual expression", argument.span)


def evaluate_closed(e: Expr) -> Expr:
    """Reduces a closed expression to a value (eval.rs:212-405)."""
    if isinstance(e, (EBool, EFloat, EString, EWaveform, EBuiltIn)):
        return e
    if isinstance(e, EFunction):
        # Defaults are evaluated once, here.
        named = [(n, evaluate_closed(v)) for n, v in e.named]
        return _respan(EFunction(e.positional, named, e.body), e)
    if isinstance(e, EVar):
        raise TuunError(f"Variable '{e.name}' not found in context", e.span)
    if isinstance(e, ESeq):
        return _respan(ESeq(evaluate_closed(e.offset),
                            evaluate_closed(e.waveform)), e)
    if isinstance(e, EIf):
        condition = evaluate_closed(e.condition)
        if isinstance(condition, EBool):
            return evaluate_closed(e.then if condition.value else e.else_)
        raise TuunError("Expected boolean condition", e.condition.span)
    if isinstance(e, ETuple):
        return _respan(ETuple([evaluate_closed(x) for x in e.exprs]), e)
    if isinstance(e, EList):
        return _respan(EList([evaluate_closed(x) for x in e.exprs]), e)
    if isinstance(e, EError):
        raise TuunError(e.message, e.span)
    if isinstance(e, EApply):
        function = evaluate_closed(e.function)
        pos_args = [evaluate_closed(a) for a in e.positional]
        named_args = [(n, evaluate_closed(v)) for n, v in e.named]
        if isinstance(function, EFunction):
            for i, (name, _) in enumerate(named_args):
                if any(n == name for n, _ in named_args[:i]):
                    raise TuunError(
                        f'named parameter "{name}" appears more than once',
                        e.span)
                if not any(n == name for n, _ in function.named):
                    raise TuunError(f'no named parameter "{name}"', e.span)
            if len(pos_args) > len(function.positional):
                raise TuunError("extra positional parameter", e.span)
            if len(pos_args) < len(function.positional):
                missing = function.positional[len(pos_args)]
                raise TuunError(f'missing parameter "{missing}"', e.span)
            context: Context = []
            for param, argument in zip(function.positional, pos_args):
                _extend_context(context, param, argument)
            for name, default in function.named:
                value = next((v for n, v in named_args if n == name), default)
                context.append((name, value))
            return evaluate_closed(substitute(context, function.body))
        if isinstance(function, EBuiltIn):
            if named_args:
                raise TuunError(
                    f'named argument "{named_args[0][0]}" is not supported by '
                    f'built-in "{function.name}"', e.span)
            result = function.fn(pos_args)
            if isinstance(result, EError):
                raise TuunError(result.message, e.span)
            return _respan(result, e)
        from .expr import format_expr
        raise TuunError(f"Invalid application: {format_expr(function)}", e.span)
    raise TypeError(f"unknown expr {type(e)}")


Resolver = Callable[[Tuple[str, ...]], Sequence[SourceBinding]]


def evaluate_bindings(resolve: Resolver,
                      bindings: Sequence[SourceBinding]) -> Context:
    """Evaluates bindings in order into a context (eval.rs:435-495)."""
    context: Context = []
    _build_context(resolve, bindings, context)
    return context


def _build_context(resolve: Resolver, bindings: Sequence[SourceBinding],
                   context: Context) -> Context:
    own: Context = []
    for sb in bindings:
        b = sb.binding
        if isinstance(b, BOpen):
            module = resolve(tuple(b.path))
            module_context: Context = []
            exports = _build_context(resolve, module, module_context)
            context.extend(exports)
        elif isinstance(b, BDef):
            value = evaluate_closed(substitute(context, b.expr))
            before = len(context)
            _extend_context(context, b.pattern, value)
            own.extend(context[before:])
        elif isinstance(b, BEmpty):
            pass
    return own


def evaluate(resolve: Resolver, bindings: Sequence[SourceBinding],
             e: Expr) -> Expr:
    """Evaluates `e` in the context of `bindings` (eval.rs:416-428)."""
    context = evaluate_bindings(resolve, bindings)
    return evaluate_closed(substitute(context, e))

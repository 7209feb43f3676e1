"""The Tuun prelude built-ins.

Port of reference/src/lib/builtins.rs: arithmetic overloaded over
floats, waveforms and sequences; list helpers (map/reduce/unfold/append/nth);
waveform constructors (sine/fixed/fin/seq/unseq/filter/reset/alt/capture);
`\\` (followed-by) with symbolic offset addition; `{e}` chord and `<e>`
sequence desugarings.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional

import numpy as np

from . import ir, optimizer
from .expr import (EApply, EBool, EBuiltIn, EError, EFloat, EList, ESeq,
                   EString, EWaveform, Expr, SourceBinding, definition, f32)

F32 = np.float32


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _as_waveform(e: Expr) -> Optional[ir.Waveform]:
    if isinstance(e, EWaveform):
        return e.waveform
    if isinstance(e, EFloat):
        return ir.Const(e.value)
    return None


def _unary_op(arguments, name, float_op, waveform_op) -> Expr:
    if len(arguments) != 1:
        return EError(f"Expected one argument for {name}")
    a = arguments[0]
    if isinstance(a, EFloat):
        return EFloat(float_op(a.value))
    if isinstance(a, EWaveform):
        return EWaveform(waveform_op(a.waveform))
    return EError(f"Invalid argument for {name}")


def _binary_op(arguments, name, float_op, waveform_op) -> Expr:
    if len(arguments) != 2:
        return EError(f"Expected two arguments for {name}")
    a, b = arguments

    def mk_seq(offset, wa, wb):
        return ESeq(offset, EWaveform(waveform_op(wa, wb)))

    if isinstance(a, EFloat) and isinstance(b, EFloat):
        return EFloat(float_op(a.value, b.value))
    if isinstance(a, (EFloat, EWaveform)) and isinstance(b, (EFloat, EWaveform)):
        return EWaveform(waveform_op(_as_waveform(a), _as_waveform(b)))
    if isinstance(a, ESeq) and isinstance(b, (EFloat, EWaveform)):
        wa = _as_waveform(a.waveform)
        if wa is None:
            return EError(f"Invalid argument to seq in {name}")
        return mk_seq(a.offset, wa, _as_waveform(b))
    if isinstance(a, (EFloat, EWaveform)) and isinstance(b, ESeq):
        wb = _as_waveform(b.waveform)
        if wb is None:
            return EError(f"Invalid argument to seq in {name}")
        return mk_seq(b.offset, _as_waveform(a), wb)
    return EError(f"Invalid arguments for {name}")


def _float_add(a, b):
    return f32(F32(a) + F32(b))


def _float_sub(a, b):
    return f32(F32(a) - F32(b))


def _float_mul(a, b):
    return f32(F32(a) * F32(b))


def _float_div(a, b):
    with np.errstate(divide="ignore", invalid="ignore"):
        return f32(np.divide(F32(a), F32(b)))


def _binop_ctor(op):
    return lambda a, b: ir.BinaryPointOp(op, a, b)


# ---------------------------------------------------------------------------
# arithmetic
# ---------------------------------------------------------------------------


def plus(arguments):
    return _binary_op(arguments, "+", _float_add, _binop_ctor(ir.Operator.ADD))


def minus(arguments):
    if len(arguments) == 1:
        return _unary_op(
            arguments, "-", lambda a: f32(-F32(a)),
            lambda w: ir.BinaryPointOp(ir.Operator.MULTIPLY, ir.Const(-1.0), w))
    return _binary_op(arguments, "-", _float_sub,
                      _binop_ctor(ir.Operator.SUBTRACT))


def times(arguments):
    return _binary_op(arguments, "*", _float_mul,
                      _binop_ctor(ir.Operator.MULTIPLY))


def divide(arguments):
    return _binary_op(arguments, "/", _float_div,
                      _binop_ctor(ir.Operator.DIVIDE))


def merge(arguments):
    # Two floats promote to constant waveforms (builtins.rs:154-167).
    if len(arguments) == 2 and all(isinstance(x, EFloat) for x in arguments):
        return EWaveform(ir.BinaryPointOp(
            ir.Operator.MERGE, ir.Const(arguments[0].value),
            ir.Const(arguments[1].value)))
    return _binary_op(arguments, "&", _float_add,
                      _binop_ctor(ir.Operator.MERGE))


def power(arguments):
    def float_pow(a, b):
        with np.errstate(invalid="ignore"):
            return f32(np.power(F32(a), F32(b), dtype=np.float32))
    return _binary_op(arguments, "pow", float_pow,
                      _binop_ctor(ir.Operator.POWER))


def log(arguments):
    if len(arguments) == 2 and all(isinstance(x, EFloat) for x in arguments):
        value, base = arguments[0].value, arguments[1].value
        return EFloat(f32(math.log(value) / math.log(base)))
    return EError("Invalid arguments for log")


def sqrt(arguments):
    if len(arguments) == 1 and isinstance(arguments[0], EFloat) \
            and arguments[0].value >= 0.0:
        return EFloat(f32(math.sqrt(arguments[0].value)))
    return EError("Invalid argument for sqrt")


def exp(arguments):
    if len(arguments) == 1 and isinstance(arguments[0], EFloat):
        return EFloat(f32(np.exp(F32(arguments[0].value))))
    return EError("Invalid argument for exp")


def sine(arguments):
    """sine(frequency_rad_per_sec, phase_rad) (builtins.rs:344-376)."""
    if len(arguments) != 2:
        return EError("Expected two arguments for sine")
    freq, phase = arguments
    if isinstance(freq, EFloat) and isinstance(phase, EFloat):
        if F32(freq.value) == 0.0:
            return EFloat(f32(math.sin(F32(phase.value))))
        return EWaveform(ir.Sine(ir.Const(freq.value), ir.Const(phase.value)))
    wf = _as_waveform(freq)
    wp = _as_waveform(phase)
    if wf is None or wp is None:
        return EError("Invalid arguments for sine")
    return EWaveform(ir.Sine(wf, wp))


def cos(arguments):
    if len(arguments) == 1 and isinstance(arguments[0], EFloat):
        return EFloat(f32(math.cos(F32(arguments[0].value))))
    if len(arguments) == 1 and isinstance(arguments[0], EWaveform):
        return EWaveform(ir.Sine(
            ir.Const(0.0),
            ir.BinaryPointOp(ir.Operator.ADD, arguments[0].waveform,
                             ir.Const(f32(math.pi / 2)))))
    return EError("Invalid argument for cos")


# ---------------------------------------------------------------------------
# comparisons
# ---------------------------------------------------------------------------


def _comparison(name, op, types):
    def fn(arguments):
        if len(arguments) == 2:
            a, b = arguments
            for t in types:
                if isinstance(a, t) and isinstance(b, t):
                    return EBool(op(a.value, b.value))
        return EError(f"Invalid arguments for {name}")
    return fn


equals = _comparison("==", lambda a, b: a == b, (EBool, EFloat, EString))
not_equals = _comparison("!=", lambda a, b: a != b, (EBool, EFloat, EString))
less_than = _comparison("<", lambda a, b: a < b, (EFloat,))
less_than_equals = _comparison("<=", lambda a, b: a <= b, (EFloat,))
greater_than = _comparison(">", lambda a, b: a > b, (EFloat,))
greater_than_equals = _comparison(">=", lambda a, b: a >= b, (EFloat,))


# ---------------------------------------------------------------------------
# lists
# ---------------------------------------------------------------------------


def _apply_value(function: Expr, args: List[Expr]) -> Expr:
    from .eval import evaluate_closed
    return evaluate_closed(EApply(function, args))


def map_(arguments):
    if len(arguments) == 2 and isinstance(arguments[1], EList):
        function, exprs = arguments[0], arguments[1].exprs
        results = []
        for e in exprs:
            try:
                results.append(_apply_value(function, [e]))
            except Exception as err:  # mirror: errors become error elements
                results.append(EError(str(err)))
        return EList(results)
    return EError("Invalid arguments for map")


def reduce_(arguments):
    if len(arguments) == 3 and isinstance(arguments[2], EList):
        function, acc, exprs = arguments[0], arguments[1], arguments[2].exprs
        for e in exprs:
            try:
                acc = _apply_value(function, [acc, e])
            except Exception as err:
                return EError(str(err))
        return acc
    return EError("Invalid arguments for reduce")


def unfold(arguments):
    if len(arguments) == 3 and isinstance(arguments[2], EFloat) \
            and arguments[2].value >= 0.0 \
            and float(arguments[2].value).is_integer():
        function, seed, n = arguments[0], arguments[1], int(arguments[2].value)
        results = []
        current = seed
        for _ in range(n):
            results.append(current)
            try:
                current = _apply_value(function, [current])
            except Exception as err:
                return EError(str(err))
        return EList(results)
    return EError("Invalid arguments for unfold")


def append(arguments):
    if arguments and isinstance(arguments[0], EList):
        result = list(arguments[0].exprs)
        for b in arguments[1:]:
            if not isinstance(b, EList):
                return EError("Expected more lists as arguments for append")
            result.extend(b.exprs)
        return EList(result)
    if arguments and isinstance(arguments[0], EWaveform):
        result = arguments[0].waveform
        for b in arguments[1:]:
            if not isinstance(b, EWaveform):
                return EError("Expected more waveforms as arguments for append")
            result = ir.Append(result, b.waveform)
        return EWaveform(result)
    return EError("Invalid arguments for append")


def nth(arguments):
    if len(arguments) == 2 and isinstance(arguments[0], EFloat) \
            and isinstance(arguments[1], EList):
        i = int(arguments[0].value)
        exprs = arguments[1].exprs
        if 0 <= i < len(exprs):
            return exprs[i]
        return EError(f"No element with index {arguments[0].value}")
    return EError("Invalid arguments for nth")


# ---------------------------------------------------------------------------
# waveform constructors
# ---------------------------------------------------------------------------


def fixed(arguments):
    if len(arguments) == 1 and isinstance(arguments[0], EList):
        samples = []
        for s in arguments[0].exprs:
            if not isinstance(s, EFloat):
                return EError("Invalid sample in fixed waveform")
            samples.append(s.value)
        return EWaveform(ir.Fixed(samples))
    return EError("Invalid argument for fixed waveform")


def _curry(f: Callable[[ir.Waveform], ir.Waveform], name: str) -> Expr:
    """A builtin that maps a waveform (or seq payload) through f
    (builtins.rs:614-641)."""
    def apply(arguments):
        if len(arguments) != 1:
            return EError("Expected waveform")
        a = arguments[0]
        if isinstance(a, (EWaveform, EFloat)):
            return EWaveform(f(_as_waveform(a)))
        if isinstance(a, ESeq):
            wa = _as_waveform(a.waveform)
            if wa is None:
                return EError("Expected waveform as argument to seq")
            return ESeq(a.offset, EWaveform(f(wa)))
        return EError("Expected waveform, seq, or float")
    return EBuiltIn(name, apply)


def fin(arguments):
    if len(arguments) != 1:
        return EError(f"Expected one argument for fin, got {len(arguments)}")
    a = arguments[0]
    length = _as_waveform(a)
    if length is None:
        return EError("Invalid arguments for fin")
    return _curry(lambda w: ir.Fin(length, w),
                  f"fin({ir.format_waveform(length)})")


def seq(arguments):
    if len(arguments) != 1:
        return EError(f"Expected one argument for seq, got {len(arguments)}")
    offset = _as_waveform(arguments[0])
    if offset is None:
        return EError("Invalid argument for seq")

    def apply(args):
        if len(args) != 1:
            return EError("Expected one argument for seq(..)")
        w = _as_waveform(args[0])
        if w is None:
            return EError("Expected argument to seq to be a waveform or float")
        return ESeq(EWaveform(offset), EWaveform(w))
    return EBuiltIn(f"seq({ir.format_waveform(offset)})", apply)


def unseq(arguments):
    if arguments:
        return EError(f"Expected no arguments for unseq, got {len(arguments)}")

    def apply(args):
        if len(args) != 1:
            return EError("Expected argument for unseq()")
        if isinstance(args[0], ESeq):
            return args[0].waveform
        return EError("Expected seq as argument to unseq")
    return EBuiltIn("unseq()", apply)


def waveform_filter(arguments):
    if len(arguments) != 2:
        return EError("Expected two lists of waveforms for filter")

    def coerce(e, what):
        if not isinstance(e, EList):
            return None
        out = []
        for x in e.exprs:
            w = _as_waveform(x)
            if w is None:
                return None
            out.append(w)
        return out

    feed_forward = coerce(arguments[0], "feed_forward")
    if not feed_forward:
        return EError("Filter requires at least one feed-forward coefficient")
    feedback = coerce(arguments[1], "feedback")
    if feedback is None:
        return EError("Feedback argument to filter must be a list")
    ff_s = ", ".join(ir.format_waveform(w) for w in feed_forward)
    fb_s = ", ".join(ir.format_waveform(w) for w in feedback)
    return _curry(lambda w: ir.Filter(w, feed_forward, feedback),
                  f"filter([{ff_s}], [{fb_s}])")


def reset(arguments):
    if len(arguments) != 2:
        return EError("Expected two waveforms")
    if not isinstance(arguments[0], EWaveform):
        return EError("First argument must be a waveform")
    w = _as_waveform(arguments[1])
    if w is None:
        return EError("Second argument must be a waveform or a float")
    return EWaveform(ir.Reset(arguments[0].waveform, w))


def alt(arguments):
    if len(arguments) != 3:
        return EError("Expected three waveforms")
    ws = [_as_waveform(a) for a in arguments]
    if any(w is None for w in ws):
        return EError("Arguments to alt must be waveforms or floats")
    return EWaveform(ir.Alt(*ws))


def capture(arguments):
    if len(arguments) != 1 or not isinstance(arguments[0], EString):
        return EError("Expected a string argument to capture")
    stem = arguments[0].value
    return _curry(lambda w: ir.Captured(stem, w), f"capture({stem})")


# ---------------------------------------------------------------------------
# followed-by / chord / sequence
# ---------------------------------------------------------------------------


def _add_offsets(a: ir.Waveform, b: ir.Waveform) -> Expr:
    """Adds two offset waveforms symbolically; each must be linear in Time
    (builtins.rs:179-206)."""
    ra = optimizer.first_root(a)
    rb = optimizer.first_root(b)
    if ra is None or rb is None:
        return EError(
            "Cannot add offsets that are not linear functions of Time")
    total = optimizer.optimize(ir.BinaryPointOp(
        ir.Operator.MULTIPLY,
        ir.BinaryPointOp(ir.Operator.ADD, ra, rb), ir.Const(-1.0)))
    return EWaveform(ir.BinaryPointOp(ir.Operator.ADD, ir.Time(), total))


def followed_by(arguments):
    """`a \\ b`: a is a seq; b starts at a's offset (builtins.rs:208-299)."""
    if len(arguments) != 2:
        return EError("Expected two arguments to \\")
    a, b = arguments
    if not isinstance(a, ESeq):
        return EError("Expected seq as first argument to \\")
    a_offset = _as_waveform(a.offset)
    wa = _as_waveform(a.waveform)
    if a_offset is None or wa is None:
        return EError("Invalid seq as first argument to \\")

    def merged(wb: ir.Waveform) -> ir.Waveform:
        return ir.BinaryPointOp(
            ir.Operator.MERGE, wa,
            ir.Append(ir.Fin(a_offset, ir.Const(0.0)), wb))

    if isinstance(b, (EFloat, EWaveform)):
        return EWaveform(merged(_as_waveform(b)))
    if isinstance(b, ESeq):
        b_offset = _as_waveform(b.offset)
        wb = _as_waveform(b.waveform)
        if b_offset is None or wb is None:
            return EError("Invalid seq as second argument to \\")
        total = _add_offsets(a_offset, b_offset)
        if isinstance(total, EError):
            return total
        return ESeq(total, EWaveform(merged(wb)))
    return EError(
        "Expected second argument to \\ to be a float, waveform or seq")


def chord(arguments):
    """`{[a, b, ...]}`: right-fold of Merge (builtins.rs:921-944)."""
    if len(arguments) == 1 and isinstance(arguments[0], EList):
        result: ir.Waveform = ir.Fin(ir.Const(0.0), ir.Const(0.0))
        for e in reversed(arguments[0].exprs):
            w = _as_waveform(e)
            if w is None:
                return EError("Invalid element in chord")
            result = ir.BinaryPointOp(ir.Operator.MERGE, w, result)
        return EWaveform(result)
    return EError("Invalid argument for chord")


def sequence(arguments):
    """`<[a, b, ...]>`: fold of followed-by (builtins.rs:946-973).

    The reference right-folds, producing a chain as deep as the list; since
    `\\` is associative (offsets add), we fold as a balanced tree instead —
    sample-equivalent, but compiled control flow nests log(n) deep, which
    matters for long songs on the TPU engine (each sequence level carries
    an empty-region skip branch).
    """
    if len(arguments) != 1 or not isinstance(arguments[0], EList):
        return EError("Invalid argument for sequence")
    exprs = list(arguments[0].exprs)
    if not exprs:
        return EWaveform(ir.Fixed([]))
    if len(exprs) == 1:
        w = _as_waveform(exprs[0])
        if w is None:
            return EError("Invalid argument for sequence")
        return EWaveform(w)

    def fold(items):
        if len(items) == 1:
            return items[0]
        mid = len(items) // 2
        left = fold(items[:mid])
        if isinstance(left, EError):
            return left
        right = fold(items[mid:])
        if isinstance(right, EError):
            return right
        return followed_by([left, right])
    return fold(exprs)


# ---------------------------------------------------------------------------
# debug + registration
# ---------------------------------------------------------------------------


def debug(print_fn: Callable[[str], None]) -> Expr:
    """`debug(a, b, ...)` logs its arguments and evaluates to the last one
    (builtins.rs:989-1006)."""
    from .expr import format_expr

    def apply(arguments):
        rendered = ", ".join(format_expr(a) for a in arguments)
        print_fn(f"debug: [{rendered}]")
        return arguments[-1] if arguments else EList([])
    return EBuiltIn("debug", apply)


def add_bindings(bindings: List[SourceBinding]) -> None:
    """Appends the full prelude builtin table (builtins.rs:1008-1074)."""
    bindings.append(definition("true", EBool(True)))
    bindings.append(definition("false", EBool(False)))
    bindings.append(definition("time", EWaveform(ir.Time())))
    bindings.append(definition("noise", EWaveform(ir.Noise())))
    table = [
        ("+", plus), ("-", minus), ("*", times), ("/", divide), ("&", merge),
        ("\\", followed_by), ("==", equals), ("!=", not_equals),
        ("<", less_than), ("<=", less_than_equals), (">", greater_than),
        (">=", greater_than_equals), ("pow", power), ("log", log),
        ("sqrt", sqrt), ("exp", exp), ("sine", sine), ("cos", cos),
        ("map", map_), ("reduce", reduce_), ("unfold", unfold),
        ("append", append), ("nth", nth), ("fixed", fixed), ("fin", fin),
        ("seq", seq), ("unseq", unseq), ("filter", waveform_filter),
        ("reset", reset), ("alt", alt), ("capture", capture),
        ("__chord", chord), ("__sequence", sequence),
    ]
    for name, fn in table:
        bindings.append(definition(name, EBuiltIn(name, fn)))

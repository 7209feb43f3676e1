"""Algebraic rewrites over the Waveform IR.

Port of the reference optimizer (reference/src/lib/optimizer.rs):
constant folding, commuting constants right, re-association, distribution,
divide->multiply-by-reciprocal, Fin pull-up/merging, zero-length
canonicalization to Fixed([]), Alt const-trigger elimination.

For the TPU engine this doubles as the graph canonicalizer: it shrinks the
structural compile key (fewer shapes to jit) and pushes lengths into the
symbolic `first_root` form that the engine resolves without generating the
length waveform.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

from .ir import (Alt, Append, BinaryPointOp, Captured, Const, Filter, Fin,
                 Fixed, Marked, Noise, Operator, Reset, Sine, Time, Waveform)

F32 = np.float32


def first_root(w: Waveform) -> Optional[Waveform]:
    """First non-negative time at which `w` reaches zero, for waveforms that
    are linear in Time (optimizer.rs:9-43). Returns None otherwise."""
    if isinstance(w, Const):
        if F32(w.value) == 0.0:
            return Const(0.0)
        return None
    if isinstance(w, Time):
        return Const(0.0)
    if isinstance(w, BinaryPointOp) and w.op == Operator.ADD:
        if isinstance(w.a, Time):
            return optimize(BinaryPointOp(Operator.MULTIPLY, w.b, Const(-1.0)))
        if isinstance(w.b, Time):
            return optimize(BinaryPointOp(Operator.MULTIPLY, w.a, Const(-1.0)))
        return None
    if isinstance(w, BinaryPointOp) and w.op == Operator.SUBTRACT:
        return first_root(BinaryPointOp(
            Operator.ADD, w.a,
            optimize(BinaryPointOp(Operator.MULTIPLY, w.b, Const(-1.0)))))
    return None


def _roots_equal(a: Optional[Waveform], b: Optional[Waveform]) -> bool:
    return a is not None and b is not None and a == b


def optimize(w: Waveform) -> Waveform:
    """Rewrites `w` into an equivalent, cheaper waveform (optimizer.rs:52-442)."""
    if isinstance(w, (Const, Time, Noise, Fixed)):
        return w

    if isinstance(w, Fin):
        length = optimize(w.length)
        if isinstance(length, Const) and F32(length.value) >= 0.0:
            return Fixed([])
        if isinstance(length, Fixed) and len(length.samples) > 0 \
                and length.samples[0] >= 0.0:
            return Fixed([])
        if isinstance(length, Time):
            return Fixed([])
        inner = optimize(w.waveform)
        if isinstance(inner, Fin):
            ra, rb = first_root(length), first_root(inner.length)
            if isinstance(ra, Const) and isinstance(rb, Const):
                # Nested Fins: keep the shorter bound.
                m = min(F32(ra.value), F32(rb.value))
                return Fin(
                    optimize(BinaryPointOp(Operator.SUBTRACT, Time(), Const(float(m)))),
                    inner.waveform)
        return Fin(length, inner)

    if isinstance(w, Append):
        a, b = optimize(w.a), optimize(w.b)
        if isinstance(a, Fixed) and len(a.samples) == 0:
            return b
        if isinstance(b, Fixed) and len(b.samples) == 0:
            return a
        if isinstance(a, Fixed) and isinstance(b, Fixed):
            return Fixed(np.concatenate([a.samples, b.samples]))
        return Append(a, b)

    if isinstance(w, Sine):
        freq, phase = optimize(w.frequency), optimize(w.phase)
        if isinstance(freq, Const) and F32(freq.value) == 0.0:
            if isinstance(phase, Const):
                return Const(float(F32(math.sin(F32(phase.value)))))
            if isinstance(phase, Fixed):
                return Fixed(np.sin(phase.samples).astype(np.float32))
        return Sine(freq, phase)

    if isinstance(w, Filter):
        return Filter(optimize(w.waveform),
                      tuple(optimize(c) for c in w.feed_forward),
                      tuple(optimize(c) for c in w.feedback))

    if isinstance(w, BinaryPointOp):
        return _optimize_binop(w)

    if isinstance(w, Reset):
        return Reset(optimize(w.trigger), optimize(w.waveform))

    if isinstance(w, Alt):
        t = optimize(w.trigger)
        pos = optimize(w.positive)
        neg = optimize(w.negative)
        if isinstance(t, Const):
            return pos if F32(t.value) >= 0.0 else neg
        return Alt(t, pos, neg)

    if isinstance(w, Marked):
        return Marked(w.id, optimize(w.waveform))
    if isinstance(w, Captured):
        return Captured(w.file_stem, optimize(w.waveform))
    raise TypeError(f"unknown waveform {type(w)}")


def _is_empty_fixed(x: Waveform) -> bool:
    return isinstance(x, Fixed) and len(x.samples) == 0


def _optimize_binop(w: BinaryPointOp) -> Waveform:
    op = w.op

    if op == Operator.ADD:
        a, b = optimize(w.a), optimize(w.b)
        if _is_empty_fixed(a) or _is_empty_fixed(b):
            return Fixed([])
        if isinstance(a, Const) and isinstance(b, Const):
            return Const(float(F32(a.value) + F32(b.value)))
        if isinstance(b, Const) and F32(b.value) == 0.0:
            return a
        if isinstance(a, Const):
            return optimize(BinaryPointOp(Operator.ADD, b, a))
        if isinstance(a, BinaryPointOp) and a.op == Operator.ADD \
                and isinstance(b, Const):
            return BinaryPointOp(
                Operator.ADD, a.a,
                optimize(BinaryPointOp(Operator.ADD, a.b, b)))
        if isinstance(a, Fin) and isinstance(b, Fin) \
                and _roots_equal(first_root(a.length), first_root(b.length)):
            return Fin(a.length,
                       optimize(BinaryPointOp(Operator.ADD, a.waveform, b.waveform)))
        return BinaryPointOp(Operator.ADD, a, b)

    if op == Operator.SUBTRACT:
        return optimize(BinaryPointOp(
            Operator.ADD, w.a,
            optimize(BinaryPointOp(Operator.MULTIPLY, w.b, Const(-1.0)))))

    if op == Operator.MERGE:
        a, b = optimize(w.a), optimize(w.b)
        if _is_empty_fixed(a):
            return b
        if _is_empty_fixed(b):
            return a
        if isinstance(a, Const) and isinstance(b, Const):
            return Const(float(F32(a.value) + F32(b.value)))
        if isinstance(a, (Time, Noise)) and isinstance(b, Const) \
                and F32(b.value) == 0.0:
            return a
        if isinstance(a, Const):
            return optimize(BinaryPointOp(Operator.MERGE, b, a))
        # `w | fin(t) | seq(t)` fusion: Merge(Fin(t, a), Append(Fin(t, b), c))
        # -> Append(Fin(t, Merge(a, b)), c) (optimizer.rs:210-270).
        if isinstance(a, Fin) and isinstance(b, Append) \
                and isinstance(b.a, Fin) \
                and _roots_equal(first_root(a.length), first_root(b.a.length)):
            return optimize(Append(
                Fin(a.length,
                    BinaryPointOp(Operator.MERGE, a.waveform, b.a.waveform)),
                b.b))
        if isinstance(a, Marked) and isinstance(b, Append) \
                and isinstance(a.waveform, Fin) and isinstance(b.a, Fin) \
                and _roots_equal(first_root(a.waveform.length),
                                 first_root(b.a.length)):
            return optimize(Append(
                Marked(a.id,
                       Fin(a.waveform.length,
                           BinaryPointOp(Operator.MERGE,
                                         a.waveform.waveform, b.a.waveform))),
                b.b))
        return BinaryPointOp(Operator.MERGE, a, b)

    if op == Operator.MULTIPLY:
        a, b = optimize(w.a), optimize(w.b)
        if _is_empty_fixed(a) or _is_empty_fixed(b):
            return Fixed([])
        if isinstance(b, Const) and F32(b.value) == 1.0:
            return a
        if isinstance(a, Const) and isinstance(b, Const):
            return Const(float(F32(a.value) * F32(b.value)))
        if isinstance(a, Fixed) and isinstance(b, Const):
            return Fixed((a.samples * F32(b.value)).astype(np.float32))
        if isinstance(a, Const):
            return optimize(BinaryPointOp(Operator.MULTIPLY, b, a))
        if isinstance(b, Const):
            if isinstance(a, BinaryPointOp) and a.op == Operator.MULTIPLY:
                return BinaryPointOp(
                    Operator.MULTIPLY, a.a,
                    optimize(BinaryPointOp(Operator.MULTIPLY, a.b, b)))
            if isinstance(a, BinaryPointOp) and a.op == Operator.ADD:
                return BinaryPointOp(
                    Operator.ADD,
                    optimize(BinaryPointOp(Operator.MULTIPLY, a.a, b)),
                    optimize(BinaryPointOp(Operator.MULTIPLY, a.b, b)))
            if isinstance(a, BinaryPointOp) and a.op == Operator.DIVIDE:
                return BinaryPointOp(
                    Operator.DIVIDE,
                    optimize(BinaryPointOp(Operator.MULTIPLY, a.a, b)), a.b)
        if isinstance(a, Fin):
            return optimize(Fin(
                a.length,
                optimize(BinaryPointOp(Operator.MULTIPLY, a.waveform, b))))
        if isinstance(b, Fin):
            return optimize(Fin(
                b.length,
                optimize(BinaryPointOp(Operator.MULTIPLY, a, b.waveform))))
        return BinaryPointOp(Operator.MULTIPLY, a, b)

    if op == Operator.DIVIDE:
        a, b = optimize(w.a), optimize(w.b)
        if _is_empty_fixed(b):
            return Fixed([])
        if isinstance(b, Const):
            # Prefer multiplication by the reciprocal.
            recip = F32(1.0) / F32(b.value) if F32(b.value) != 0.0 else F32(np.inf)
            return optimize(BinaryPointOp(Operator.MULTIPLY, a, Const(float(recip))))
        if isinstance(a, BinaryPointOp) and a.op == Operator.DIVIDE:
            return BinaryPointOp(
                Operator.DIVIDE, a.a,
                optimize(BinaryPointOp(Operator.MULTIPLY, a.b, b)))
        if isinstance(b, BinaryPointOp) and b.op == Operator.DIVIDE:
            return BinaryPointOp(
                Operator.DIVIDE,
                optimize(BinaryPointOp(Operator.MULTIPLY, a, b.b)), b.a)
        if isinstance(a, Fin):
            return optimize(Fin(
                a.length,
                optimize(BinaryPointOp(Operator.DIVIDE, a.waveform, b))))
        if isinstance(b, Fin):
            return optimize(Fin(
                b.length,
                optimize(BinaryPointOp(Operator.DIVIDE, a, b.waveform))))
        return BinaryPointOp(Operator.DIVIDE, a, b)

    if op == Operator.POWER:
        a, b = optimize(w.a), optimize(w.b)
        if _is_empty_fixed(a) or _is_empty_fixed(b):
            return Fixed([])
        if isinstance(a, Const) and isinstance(b, Const) and F32(b.value) == 0.0:
            return Const(1.0)
        if isinstance(b, Const) and F32(b.value) == 1.0:
            return a
        if isinstance(a, Const) and isinstance(b, Const):
            with np.errstate(invalid="ignore"):
                return Const(float(np.power(F32(a.value), F32(b.value),
                                            dtype=np.float32)))
        if isinstance(a, Fixed) and isinstance(b, Const):
            with np.errstate(invalid="ignore"):
                return Fixed(np.power(a.samples, F32(b.value), dtype=np.float32))
        return BinaryPointOp(Operator.POWER, a, b)

    raise ValueError(op)

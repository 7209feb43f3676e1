"""Waveform IR: the compact intermediate representation of a stream of samples.

This mirrors the 13-node IR of the reference implementation
(reference/src/lib/waveform.rs:22-100) but is designed as an immutable
Python tree that compiles to JAX/XLA block-render programs (see
tuun_tpu.engine) and is interpreted per-sample by the NumPy oracle
(tuun_tpu.oracle).

Unlike the reference, nodes carry no inline mutable state: generation state
lives in separate functional state structures keyed by node path, which is
what makes the IR directly usable as a jit/vmap-able computation graph.
"""

from __future__ import annotations

import enum
import math
from dataclasses import dataclass
from typing import Any, Callable, Iterator, Optional, Tuple

import numpy as np


class Operator(enum.Enum):
    """Point-wise binary operators (reference: waveform.rs:4-19)."""

    ADD = "Add"
    SUBTRACT = "Subtract"
    MULTIPLY = "Multiply"
    DIVIDE = "Divide"  # yields 0 when the divisor is 0
    MERGE = "Merge"  # add; extends the shorter input with zeros
    POWER = "Power"


class Waveform:
    """Base class for IR nodes. All nodes are immutable."""

    __slots__ = ()

    # -- structural helpers -------------------------------------------------

    def children(self) -> Tuple["Waveform", ...]:
        return ()

    def replace_children(self, kids: Tuple["Waveform", ...]) -> "Waveform":
        assert not kids
        return self

    def walk(self) -> Iterator["Waveform"]:
        yield self
        for child in self.children():
            yield from child.walk()

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return format_waveform(self)


@dataclass(frozen=True, repr=False)
class Const(Waveform):
    """An infinite stream of one constant value."""

    __slots__ = ("value",)
    value: float


@dataclass(frozen=True, repr=False)
class Time(Waveform):
    """Elapsed seconds since the start of this waveform: sample n is n/sr."""

    __slots__ = ()


@dataclass(frozen=True, repr=False)
class Noise(Waveform):
    """Uniform random samples in [-1, 1).

    The reference uses a global thread-local PRNG (generator.rs:113-118); we
    use a counter-based hash keyed on (seed, node id, sample index) so that
    output is reproducible, identical between the oracle and the JAX engine,
    and independent of block size.  Output therefore differs sample-by-sample
    from the Rust reference and is compared statistically.
    """

    __slots__ = ()


class Fixed(Waveform):
    """A finite sequence of concrete samples."""

    __slots__ = ("samples",)

    def __init__(self, samples):
        arr = np.asarray(samples, dtype=np.float32)
        arr.setflags(write=False)
        object.__setattr__(self, "samples", arr)

    def __eq__(self, other):
        return isinstance(other, Fixed) and np.array_equal(self.samples, other.samples)

    def __hash__(self):
        return hash((Fixed, self.samples.tobytes()))

    def __repr__(self) -> str:  # pragma: no cover
        return format_waveform(self)


@dataclass(frozen=True, repr=False)
class Fin(Waveform):
    """Truncates `waveform` at the first point where `length` is >= 0.

    E.g. Fin(Time - 2.0, w) is the first 2 seconds of w (waveform.rs:35-38).
    """

    __slots__ = ("length", "waveform")
    length: Waveform
    waveform: Waveform

    def children(self):
        return (self.length, self.waveform)

    def replace_children(self, kids):
        return Fin(*kids)


@dataclass(frozen=True, repr=False)
class Append(Waveform):
    """All samples of `a`, then all samples of `b`."""

    __slots__ = ("a", "b")
    a: Waveform
    b: Waveform

    def children(self):
        return (self.a, self.b)

    def replace_children(self, kids):
        return Append(*kids)


@dataclass(frozen=True, repr=False)
class Sine(Waveform):
    """DDS oscillator: sin(integral of `frequency` + `phase`).

    `frequency` is instantaneous angular frequency (radians/second),
    integrated with an f64 accumulator exactly as the reference does
    (generator.rs:198-221, docs/sine.md); `phase` is an instantaneous
    angular offset in radians.  Length is min(len(frequency), len(phase));
    the accumulator advances by len(frequency) increments.
    """

    __slots__ = ("frequency", "phase")
    frequency: Waveform
    phase: Waveform

    def children(self):
        return (self.frequency, self.phase)

    def replace_children(self, kids):
        return Sine(*kids)


@dataclass(frozen=True, repr=False)
class Filter(Waveform):
    """Direct-form impulse-response filter (generator.rs:382-515, docs/filter.md).

    y[n] = sum_i ff[i][n] * w[n + (K-1-i)] - sum_j fb[j][n] * y[n-1-j]

    with K = len(feed_forward) (>= 1); the input is consumed K-1 samples
    ahead and zero-extended by K-1 samples at the end, so the output length
    equals the input length.  Feedback history is bootstrapped with zeros.
    Coefficients are arbitrary waveforms, zero-extended if they run out.
    """

    __slots__ = ("waveform", "feed_forward", "feedback")
    waveform: Waveform
    feed_forward: Tuple[Waveform, ...]
    feedback: Tuple[Waveform, ...]

    def __init__(self, waveform, feed_forward, feedback):
        object.__setattr__(self, "waveform", waveform)
        object.__setattr__(self, "feed_forward", tuple(feed_forward))
        object.__setattr__(self, "feedback", tuple(feedback))
        if not self.feed_forward:
            raise ValueError("Filter requires at least one feed-forward coefficient")

    def children(self):
        return (self.waveform,) + self.feed_forward + self.feedback

    def replace_children(self, kids):
        k = len(self.feed_forward)
        return Filter(kids[0], kids[1 : 1 + k], kids[1 + k :])


@dataclass(frozen=True, repr=False)
class BinaryPointOp(Waveform):
    """Point-wise combination of two waveforms.

    Length is min(a, b) for everything except MERGE, which zero-extends the
    shorter side and yields max(a, b) (generator.rs:520-570).
    """

    __slots__ = ("op", "a", "b")
    op: Operator
    a: Waveform
    b: Waveform

    def children(self):
        return (self.a, self.b)

    def replace_children(self, kids):
        return BinaryPointOp(self.op, *kids)


@dataclass(frozen=True, repr=False)
class Reset(Waveform):
    """Restarts `waveform` whenever `trigger` flips negative -> non-negative.

    Length is the trigger's length; if the inner waveform runs out before the
    next restart, zeros are emitted (generator.rs:273-318).
    """

    __slots__ = ("trigger", "waveform")
    trigger: Waveform
    waveform: Waveform

    def children(self):
        return (self.trigger, self.waveform)

    def replace_children(self, kids):
        return Reset(*kids)


@dataclass(frozen=True, repr=False)
class Alt(Waveform):
    """Selects `positive` where trigger >= 0 else `negative`; trigger-length."""

    __slots__ = ("trigger", "positive", "negative")
    trigger: Waveform
    positive: Waveform
    negative: Waveform

    def children(self):
        return (self.trigger, self.positive, self.negative)

    def replace_children(self, kids):
        return Alt(*kids)


@dataclass(frozen=True, repr=False)
class Marked(Waveform):
    """Transparent wrapper carrying a mark id for status reporting and live
    modification (Command.Modify substitutes the subtree under a mark)."""

    __slots__ = ("id", "waveform")
    id: Any
    waveform: Waveform

    def children(self):
        return (self.waveform,)

    def replace_children(self, kids):
        return Marked(self.id, kids[0])


@dataclass(frozen=True, repr=False)
class Captured(Waveform):
    """Transparent wrapper that also streams its samples to a WAV file whose
    name begins with `file_stem` (the reference's golden-output mechanism)."""

    __slots__ = ("file_stem", "waveform")
    file_stem: str
    waveform: Waveform

    def children(self):
        return (self.waveform,)

    def replace_children(self, kids):
        return Captured(self.file_stem, kids[0])


# ---------------------------------------------------------------------------
# Tree utilities
# ---------------------------------------------------------------------------


def substitute(waveform: Waveform, mark_id: Any, new_waveform: Waveform) -> Waveform:
    """Replaces the contents of every Marked node whose id == mark_id.

    Functional counterpart of waveform.rs:397-463; does not recurse into a
    replaced subtree.
    """
    if isinstance(waveform, Marked):
        if waveform.id == mark_id:
            return Marked(waveform.id, new_waveform)
        return Marked(waveform.id, substitute(waveform.waveform, mark_id, new_waveform))
    kids = waveform.children()
    if not kids:
        return waveform
    return waveform.replace_children(
        tuple(substitute(k, mark_id, new_waveform) for k in kids)
    )


def map_waveform(waveform: Waveform, fn: Callable[[Waveform], Optional[Waveform]]) -> Waveform:
    """Bottom-up rewrite: children first, then `fn` on the rebuilt node.

    `fn` may return None to keep the node unchanged.
    """
    kids = waveform.children()
    if kids:
        waveform = waveform.replace_children(
            tuple(map_waveform(k, fn) for k in kids)
        )
    out = fn(waveform)
    return waveform if out is None else out


def count_nodes(waveform: Waveform) -> int:
    return sum(1 for _ in waveform.walk())


def format_waveform(w: Waveform, max_fixed: int = 10) -> str:
    """Human-readable rendering matching the reference's Display
    (waveform.rs:102-176)."""
    if isinstance(w, Const):
        return f"Const({_fmt_float(w.value)})"
    if isinstance(w, Time):
        return "Time"
    if isinstance(w, Noise):
        return "Noise"
    if isinstance(w, Fixed):
        vals = w.samples
        if len(vals) <= max_fixed:
            return "Fixed([" + ", ".join(_fmt_float(v) for v in vals) + "])"
        head = ", ".join(_fmt_float(v) for v in vals[:max_fixed])
        return f"Fixed([{head}, ...], len={len(vals)})"
    if isinstance(w, Fin):
        return f"Fin({format_waveform(w.length)}, {format_waveform(w.waveform)})"
    if isinstance(w, Append):
        return f"Append({format_waveform(w.a)}, {format_waveform(w.b)})"
    if isinstance(w, Sine):
        return f"Sine({format_waveform(w.frequency)}, {format_waveform(w.phase)})"
    if isinstance(w, Filter):
        ff = ", ".join(format_waveform(x) for x in w.feed_forward)
        fb = ", ".join(format_waveform(x) for x in w.feedback)
        return f"Filter({format_waveform(w.waveform)}, [{ff}], [{fb}])"
    if isinstance(w, BinaryPointOp):
        return f"{w.op.value}({format_waveform(w.a)}, {format_waveform(w.b)})"
    if isinstance(w, Reset):
        return f"Reset({format_waveform(w.trigger)}, {format_waveform(w.waveform)})"
    if isinstance(w, Alt):
        return (
            f"Alt({format_waveform(w.trigger)}, {format_waveform(w.positive)}, "
            f"{format_waveform(w.negative)})"
        )
    if isinstance(w, Marked):
        return f"Marked({w.id}, {format_waveform(w.waveform)})"
    if isinstance(w, Captured):
        return f"Captured({w.file_stem}, {format_waveform(w.waveform)})"
    return object.__repr__(w)


def _fmt_float(v: float) -> str:
    f = float(v)
    if math.isfinite(f) and f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)

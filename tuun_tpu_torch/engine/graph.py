"""Compiles Waveform IR into PyTorch block-render programs.

Port of tuun_tpu/engine/graph.py (the reference engine, which stays as it
is).  Each waveform compiles into a tree of nodes with

    render(P, state, s, e, ctx) -> (samples[N], valid_end, written_end, state')

over blocks of N lanes; `[s, e)` is the active interval, `written_end`
how far the node wrote (consumers read written-but-invalid samples, as
the reference's shared buffers do).  The semantics, state layouts and op
orders are the JAX engine's; see its module docstring and
tuun_tpu/oracle.py for the per-sample ground truth.  The port covers the
JAX engine's fast mode: the stateful interval path (leaves, arithmetic,
Append, Fin, NCO and FM sines, filters, Reset, Alt, captures), literal
Fin cutoffs (`lits`), the relocatable fast path (`reloc_block`, closed-
form state, `note_fn`), the analytic Reset tiers and the timeline form of
Merge/Append trees (timeline.py); and its two verification precisions,
exact (f64 phase) and exact_df (double-single phase, df32.py), each with
the sequential IIR.

Decisions where the JAX engine's form was a fact of XLA or the TPU:

  * uint32 arithmetic.  torch's CPU build has no uint32 `+` or `>>`, so
    the NCO phase rides in int64 masked to 32 bits after every op.  A
    product of a lane offset (< 2^24) and an increment (< 2^32) stays
    below 2^63; a product of an absolute index and an increment, both up
    to 2^32, need not, so those go through `_mul_u32` (16-bit halves, as
    noisegen.py does), and the closed-form state multiplies Python ints.
  * Interval ends s, e, v, w are 0-dim int64 tensors on the voice's
    device, as the eager JAX path keeps them traced: no node reads one on
    the host or branches on it, so a block render never waits for the
    device.  The JAX engine's lax.cond gating of empty regions is an
    XLA-only optimisation (its eager path skips it too) and is dropped.
    Positions, ages and cursors are int64 (the JAX int32 ones wrap after
    2^31 samples; these do not, and reconstruct_state follows the port's
    render).
  * Literal Fin cutoffs (`lits`): the JAX engine fetched them to the host
    because traced thresholds de-vectorize Mosaic fusions.  Here they
    exist because the timeline's schedule (leaf offsets, layers) is built
    on the host from literal offsets once per (params, lits); lits_for,
    symbolic_len and state_at evaluate on CPU tensors from the host
    mirror of the params, never on the card.  Reloc lengths are Python
    ints, int64 tensors or None, and every length mask compares integers.
  * f32 lane indices (`fidx`) existed because int32 reductions are slow
    on the TPU.  Reductions here use int64 lane indices; `fidx` remains
    only as the input of the float32 running-max kernel, exact below
    2^24 lanes, so Ctx refuses larger blocks (MAX_BLOCK).
  * The masked-sum gather of `_value_at` becomes a gather at a clamped
    index (not torch.take, which has no batching rule under vmap, nor
    an index by a 0-dim tensor, which reads it on the host);
    dynamic_slice + roll windows (Fixed playback, the filter's delay
    line) become gathers at clamped indices.
  * Voice groups (batched_render_fn) run the same render under
    torch.func.vmap, as the JAX engine vmaps it: every op of the render
    has a batching rule, the scans' and the gates' is their voices x
    lanes kernels (kernels.vmapped), and nothing in a render reads a
    tensor on the host.
  * Interval gates.  The JAX engine writes each node's gate as
    where((idx >= s) & (idx < e), a, b) and XLA fuses the mask into what
    reads it; eager PyTorch runs it as four full-width kernels (two
    broadcast int64 compares, their `&`, the `where`).  On the card
    `_gate` and `_mask` launch one hand-written kernel instead
    (lane_ops.py, csrc/lanes.cu) that tests the interval in the thread
    and selects in the same pass; under vmap it hands the kernel each
    operand's voice axis as a row stride, so nothing shared is copied.
    On the CPU lane_ops runs the same operands through its plain
    version, the expression itself.
  * The BIGF sentinel (2e9) stays only as NO_EDGE, the running-max value
    of lanes without a reset edge: exact in f32 and below every lane.
  * Division by a constant divides by a 0-dim tensor on the operand's
    device (`_div`): on CUDA torch divides by a host scalar as a multiply
    by its reciprocal, which rounds differently from JAX and the oracle.
  * jnp.mod is a floor mod: torch.remainder, the same sign rule.
  * The analytic Reset tiers take edges from the NCO phase's top bit,
    the generic tiers from sign(sin(angle)): the two agree because
    sin's sign equals that bit at all 2^24 grid angles, which
    chip_smoke.py checks for CUDA's sin on every run (a failure fails
    the run).  Their compile-time sign verifications sample the trigger
    on CPU tensors.
  * The timeline's step sums scatter each block's deltas at points that
    are host ints merged on the host, so no two deltas meet in one slot
    and the scatter needs no float atomics: the same bits every call.
  * Shared subtrees.  XLA's common-subexpression pass merges identical
    computations of the jitted render (std.tuun's `min` and `max` write
    their operands twice; an envelope applied twice is one computation).
    The eager render merges nothing, so the compiler plans it
    (share_plan): an occurrence proven identical to, and equally ranged
    with, an earlier one is a CShared, and one render enqueues each such
    class once.
  * Folded subtrees.  XLA folds constants only where they are constants
    of the program; an envelope that has reached its sustain level is a
    constant of the voice's position, which no compiler sees.  The fold
    plan (fold_plan) proves on the host, by float32 interval arithmetic
    over the render's own ops, from which local sample a subtree yields
    one value, and the compiler wraps it in a CFold.  A render asked for
    in its settled form (the tracker asks once every voice of a group is
    past that sample) returns such a subtree as one value a row instead
    of its lanes, and each parent that reads it does what the lanes
    would have given it, bit for bit.
  * Exact-mode IIR feedback (both exact precisions) runs the linear
    recurrence kernel (a lax.scan in JAX), in float32 as the JAX engine
    and the oracle run it; exact_df's phase prefix sum runs the df prefix
    sum kernel (an associative_scan of df_add in JAX).  Fast mode runs the
    affine-scan kernel up to 8 feedback coefficients and its deep form up
    to 16 (an associative_scan of companion maps in JAX past the Pallas
    kernel's 4), and the recurrence beyond (scan_ops.py).
"""

from __future__ import annotations

import contextlib
import math
import struct
import threading
import weakref
from dataclasses import dataclass
from functools import partial
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import ir
from ..noisegen import noise_torch
from . import df32, lane_ops, scan_ops

TAU = math.tau
f32 = torch.float32
f64 = torch.float64
I64 = torch.int64
M32 = 0xFFFFFFFF
BIG = 2 ** 30  # "never" for symbolic lengths (the JAX engine's BIG_LIT)
MAX_BLOCK = 1 << 24  # lanes whose index float32 holds exactly
NO_EDGE = -2.0e9
_NO_LANE = 1 << 62


def _div(x: torch.Tensor, v: float) -> torch.Tensor:
    """x / v with v rounded to x's dtype and divided on x's device."""
    return x / torch.full((), v, dtype=x.dtype, device=x.device)


def _tmin(a, b):
    if isinstance(a, int) and isinstance(b, int):
        return min(a, b)
    if isinstance(a, int):
        a, b = b, a
    return torch.clamp(a, max=b) if isinstance(b, int) else torch.minimum(a, b)


def _tmax(a, b):
    if isinstance(a, int) and isinstance(b, int):
        return max(a, b)
    if isinstance(a, int):
        a, b = b, a
    return torch.clamp(a, min=b) if isinstance(b, int) else torch.maximum(a, b)


def _len_min(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return _tmin(a, b)


def _len_max(a, b):
    if a is None or b is None:
        return None
    return _tmax(a, b)


def _len_add(a, b):
    if a is None or b is None:
        return None
    return _tmin(a + b, BIG)


def _len_mask(li, y, L):
    """Zero y wherever li >= L (no-op for infinite L)."""
    if L is None:
        return y
    return torch.where(li < L, y, 0.0)


@dataclass
class EngineConfig:
    sample_rate: int
    # "exact": f64 phase + sequential IIR (comparable with the oracle).
    # "exact_df": the exact semantics in float32 only -- double-single
    #         (two-float) phase accumulation (df32.py, ~48 bits) + the
    #         sequential IIR.
    # "fast": the production mode -- u32 NCO, f32 FM prefix sum, the
    #         affine-scan IIR.
    precision: str = "exact"
    # Where every tensor of a render lives; the scan kernels run exactly
    # when this is a CUDA device.  The card unless the caller asks for the
    # CPU: a voice compiled for a missing card raises (check_device).
    device: Any = "cuda"
    # Compile large Merge/Append trees to timeline form (timeline.py).
    # Off: the plain tree, which needs no literal lits.
    timeline: bool = True
    # Opt-in: render relocatable voices through root.reloc (one pure
    # function of the absolute index) instead of the interval machinery.
    # The JAX engine's default (off) was measured on a TPU; chip_smoke.py
    # times both on the card (PERF.md).
    reloc_fast: bool = False

    def __post_init__(self):
        if self.precision not in ("exact", "exact_df", "fast"):
            raise ValueError(f"unknown precision {self.precision!r}")
        self.device = torch.device(self.device)

    @property
    def phase_dtype(self):
        return f64 if self.precision == "exact" else f32

    @property
    def df_phase(self) -> bool:
        """Double-single (two-float) phase accumulation (exact_df)."""
        return self.precision == "exact_df"

    @property
    def sequential_iir(self) -> bool:
        return self.precision in ("exact", "exact_df")


def check_device(device: torch.device) -> None:
    """Raises when `device` is a CUDA device and no card is visible: a
    render asked for on the card never goes on quietly on the CPU."""
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but torch.cuda.is_available() is "
            f"false (pass device='cpu' for a CPU render)")


@dataclass
class Params:
    """Per-voice runtime parameters for one compiled structure."""

    consts: torch.Tensor               # f32[n_consts]: lifted Const leaves
    fixeds: Tuple[torch.Tensor, ...]   # payloads of Fixed nodes
    seed: torch.Tensor                 # int64 scalar in [0, 2^32): noise id
    # Host (numpy) mirror of the same leaves: symbolic lengths evaluate
    # on it instead of reading the device.
    host: Optional["Params"] = None

    @property
    def device(self) -> torch.device:
        return self.consts.device

    def to(self, device) -> "Params":
        """These params on `device`, with the same host mirror: a mesh
        shard's copy (a leaf already there is not copied)."""
        return Params(self.consts.to(device),
                      tuple(x.to(device) for x in self.fixeds),
                      self.seed.to(device), host=self.host)


def params_from_numpy(consts, fixeds, seed, device) -> Params:
    """Params on `device` from host values: a JAX engine Params after
    jax.device_get, or the compiler's own lists."""
    consts_np = np.asarray(consts, np.float32).reshape(-1)
    fixeds_np = tuple(np.asarray(x, np.float32) for x in fixeds)
    seed_i = int(np.asarray(seed)) & M32
    return Params(torch.from_numpy(consts_np.copy()).to(device),
                  tuple(torch.from_numpy(x.copy()).to(device)
                        for x in fixeds_np),
                  torch.full((), seed_i, dtype=I64, device=device),
                  host=Params(consts_np, fixeds_np, np.uint32(seed_i)))


def state_from_numpy(tree, device):
    """A state tree on `device` from a host one (e.g. a JAX engine state
    after jax.device_get), keeping its nesting: integer leaves (uint32
    NCO accumulators, int32 positions and ages) become int64, bool and
    float leaves keep their dtype.  That covers every state the engine
    carries: the interval path's, an analytic Reset's (sign, age, trigger
    state holding its u32 accumulator, inner), a timeline's position, and
    the fast path's (position, untouched tree)."""
    if isinstance(tree, tuple):
        return tuple(state_from_numpy(x, device) for x in tree)
    a = np.asarray(tree)
    if a.dtype == np.bool_:
        return torch.from_numpy(a.copy()).to(device)
    if np.issubdtype(a.dtype, np.integer):
        return torch.from_numpy(a.astype(np.int64)).to(device)
    if a.dtype in (np.float32, np.float64):
        return torch.from_numpy(a.copy()).to(device)
    raise TypeError(f"unsupported state leaf dtype {a.dtype}")


def stack_params(params: List[Params]) -> Params:
    """A voice group's params: consts [B, C], each Fixed payload [B, L],
    seeds [B].  Voices group by (structure, fast, lits), so voice 0's host
    mirror drives what is read on the host (schedules, lengths)."""
    return Params(torch.stack([P.consts for P in params]),
                  tuple(torch.stack(xs) for xs in
                        zip(*[P.fixeds for P in params])),
                  torch.stack([P.seed for P in params]),
                  host=params[0].host)


def stack_tree(trees: List[Any]):
    """Same-shaped state trees stacked leaf by leaf on a new leading
    voice axis."""
    if isinstance(trees[0], tuple):
        return tuple(stack_tree(list(xs)) for xs in zip(*trees))
    return torch.stack(trees)


def tree_index(tree, i: int):
    """Row i of a stacked state tree."""
    if isinstance(tree, tuple):
        return tuple(tree_index(x, i) for x in tree)
    return tree[i]


def _host_params(P: Params) -> Params:
    """P as CPU tensors, from its host mirror when it has one."""
    if P.host is not None:
        h = P.host
        return Params(torch.from_numpy(np.array(h.consts, np.float32)),
                      tuple(torch.from_numpy(np.array(x, np.float32))
                            for x in h.fixeds),
                      torch.tensor(int(h.seed), dtype=I64))
    return Params(P.consts.cpu(), tuple(x.cpu() for x in P.fixeds),
                  P.seed.cpu())


def _zero_i(P: Params) -> torch.Tensor:
    return torch.zeros((), dtype=I64, device=P.device)


class Ctx:
    """Per-render context for one block of n lanes."""

    def __init__(self, n: int, device, allow_captures: bool = True,
                 lits: Optional[Tuple[int, ...]] = None,
                 settled: bool = False):
        if not 1 <= n <= MAX_BLOCK:
            raise ValueError(f"block of {n} lanes outside [1, {MAX_BLOCK}]")
        self.n = n
        self.device = device
        self.idx = torch.arange(n, dtype=I64, device=device)
        self.zero = torch.zeros((), dtype=I64, device=device)
        self.end = torch.full((), n, dtype=I64, device=device)
        # stem -> (samples[N], start, end) accumulated during the render
        self.captures: Dict[str, Tuple] = {}
        self.allow_captures = allow_captures
        # Host-computed literal Fin cutoffs, when the caller has them:
        # timeline nodes build their schedules from these.
        self.lits = lits
        # Share class -> the (y, v, w, state') its first member rendered
        # in this render (CShared); one root render per Ctx.
        self.shared: Dict[int, Tuple] = {}
        # The settled form: every CFold returns its one value a row (the
        # caller has checked that each voice is past its fold plan's
        # local sample).
        self.settled = settled

    @property
    def fidx(self) -> torch.Tensor:
        """float32 lane indices: the running-max kernel's input."""
        return self.idx.to(f32)


def _mask(ctx: Ctx, s, e):
    """Lanes of [s, e): on the card one kernel (lane_ops.py)."""
    return lane_ops.interval_mask(ctx.idx, s, e)


def _gate(ctx: Ctx, s, e, a, b):
    """torch.where(_mask(ctx, s, e), a, b): on the card one kernel that
    tests the interval in the thread and selects in the same pass."""
    return lane_ops.interval_gate(ctx.idx, s, e, a, b)


def _raw(y):
    """An operand's samples as its parent reads them past the operand's
    valid end.  A settled operand (a CFold's one value a row) is infinite,
    and its lanes are 0 past [s, e)."""
    return 0.0 if y.dim() == 0 else y


def _ceil_target(c, sample_rate: int):
    """ceil(c * sr) with f32 arithmetic (generator.rs:813)."""
    return torch.ceil(c * float(sample_rate)).to(I64)


def _cumsum(x):
    """Inclusive prefix sum: the scan kernel for float32 (fast mode),
    torch.cumsum for the float64 exact-mode phase."""
    if x.dtype == f32:
        return scan_ops.prefix_sum_f32(x)
    return torch.cumsum(x, 0)


def _running_max_f32(x):
    return scan_ops.prefix_max_f32(x)


def _first_lane(ctx, cond, e):
    """First lane index where cond holds, else e."""
    first = torch.where(cond, ctx.idx, _NO_LANE).min()
    return torch.minimum(first, e)


def _last_lane(ctx, cond, default):
    """Largest lane index where cond holds, at least `default`."""
    last = torch.where(cond, ctx.idx, -_NO_LANE).max()
    return torch.maximum(last, default)


def _value_at(ctx, lane_values, lane, default):
    """lane_values[lane] when 0 <= lane < n, else default.  A gather: an
    index by a 0-dim tensor would read it on the host."""
    picked = lane_values.gather(
        0, lane.clamp(0, ctx.n - 1).reshape(1)).reshape(())
    hit = (lane >= 0) & (lane < ctx.n)
    return torch.where(hit, picked, default)


def _tree_where(cond, a, b):
    """where(cond, a, b) leaf by leaf over two state trees of one shape."""
    if isinstance(a, tuple):
        return tuple(_tree_where(cond, x, y) for x, y in zip(a, b))
    return torch.where(cond, a, b)


def tree_to(tree, device):
    """A state tree with every leaf moved to `device`."""
    if isinstance(tree, tuple):
        return tuple(tree_to(x, device) for x in tree)
    return tree.to(device)


def _path_get(tree, path):
    """Fetch a leaf from a nested state tuple by index path."""
    for i in path:
        tree = tree[i]
    return tree


def _path_set(tree, path, v):
    """Return `tree` with the leaf at index `path` replaced by `v`."""
    if not path:
        return v
    i = path[0]
    return tree[:i] + (_path_set(tree[i], path[1:], v),) + tree[i + 1:]


def _mul_u32(a, b):
    """(a * b) mod 2^32 as int64, for any int64 `a` (taken mod 2^32) and
    `b` in [0, 2^32): split into 16-bit halves of b, every partial
    product stays below 2^49, where a plain product of two values up to
    2^32 can pass 2^63."""
    a = a & M32
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (a * (b & 0xFFFF) + hi) & M32


def _bcast(c, li):
    """The scalar (or per-lane, or per-row [S, 1]) value c broadcast
    against the lane indices li."""
    return c.expand(torch.broadcast_shapes(c.shape, li.shape))


# ---------------------------------------------------------------------------
# Node compilers
# ---------------------------------------------------------------------------


class Node:
    """A compiled IR node: init / render / advance plus optional reloc."""

    # reloc: None, or fn(P, local_idx[N], lits=None) -> (samples[N],
    # length) for nodes that are a pure function of time-since-start (the
    # JAX engine's contract: y[i] == 0 wherever li[i] >= length;
    # unspecified for li[i] < 0).  length is a Python int (always, when
    # `lits` carries the host-computed Fin cutoffs), an int64 tensor, or
    # None for infinite.
    reloc: Optional[Callable] = None
    # const_expr: None, or fn(P) -> f32 scalar (is_const semantics)
    const_expr: Optional[Callable] = None
    # static_len: None, or fn(P) -> the node's length as an int64 scalar
    # (CFin, CFixed).
    static_len: Optional[Callable] = None
    # Whether the compiled subtree holds a capture (set by the compiler).
    has_capture: bool = False

    def __init__(self, cfg: EngineConfig):
        self.cfg = cfg

    def init(self, P: Params):
        raise NotImplementedError

    def render(self, P, st, s, e, ctx: Ctx):
        raise NotImplementedError

    def advance(self, P, st, s, e, ctx: Ctx):
        """length()-style advancement: returns (valid_end, state')."""
        raise NotImplementedError


class CConst(Node):
    def __init__(self, cfg, index: int):
        super().__init__(cfg)
        self.index = index
        self.const_expr = lambda P: P.consts[index]
        self.reloc = lambda P, li, lits=None: (_bcast(P.consts[index], li),
                                                None)

    def init(self, P):
        return ()

    def render(self, P, st, s, e, ctx):
        y = _gate(ctx, s, e, P.consts[self.index], 0.0)
        return y, e, e, st

    def advance(self, P, st, s, e, ctx):
        return e, st


class CTime(Node):
    def __init__(self, cfg):
        super().__init__(cfg)
        sr = float(cfg.sample_rate)
        self.reloc = lambda P, li, lits=None: (_div(li.to(f32), sr), None)

    def init(self, P):
        return (_zero_i(P),)

    def render(self, P, st, s, e, ctx):
        pos = st[0]
        local = pos + ctx.idx - s
        y = _gate(ctx, s, e,
                  _div(local.to(f32), float(self.cfg.sample_rate)), 0.0)
        return y, e, e, (pos + (e - s).clamp(min=0),)

    def advance(self, P, st, s, e, ctx):
        return e, (st[0] + (e - s).clamp(min=0),)


class CNoise(Node):
    def __init__(self, cfg, uid: int):
        super().__init__(cfg)
        self.uid = uid
        self.reloc = lambda P, li, lits=None: (
            noise_torch(P.seed, uid, li.clamp(min=0)), None)

    def init(self, P):
        return (_zero_i(P),)

    def render(self, P, st, s, e, ctx):
        pos = st[0]
        local = (pos + ctx.idx - s).clamp(min=0)
        y = _gate(ctx, s, e, noise_torch(P.seed, self.uid, local), 0.0)
        return y, e, e, (pos + (e - s).clamp(min=0),)

    def advance(self, P, st, s, e, ctx):
        return e, (st[0] + (e - s).clamp(min=0),)


class CFixed(Node):
    def __init__(self, cfg, index: int, length: int):
        super().__init__(cfg)
        self.index = index
        self.length = length

        def reloc(P, li, lits=None):
            if length == 0:
                return torch.zeros(li.shape, dtype=f32, device=li.device), 0
            data = P.fixeds[index]
            return _len_mask(li, data[li.clamp(0, length - 1)], length), length
        self.reloc = reloc

    def init(self, P):
        return (_zero_i(P),)

    def _take(self, pos, s, e):
        return torch.minimum((self.length - pos).clamp(min=0),
                             (e - s).clamp(min=0))

    def render(self, P, st, s, e, ctx):
        pos = st[0]
        L = self.length
        take = self._take(pos, s, e)
        v = s + take
        if L == 0:
            y = torch.zeros(ctx.n, dtype=f32, device=ctx.device)
        else:
            # Lane i plays data[pos + i - s] (a clamped gather; lanes
            # outside [s, v) are masked).
            data = P.fixeds[self.index]
            win = data[(pos + ctx.idx - s).clamp(0, L - 1)]
            y = _gate(ctx, s, v, win, 0.0)
        return y, v, v, (pos + take,)

    def advance(self, P, st, s, e, ctx):
        pos = st[0]
        take = self._take(pos, s, e)
        return s + take, (pos + take,)


class CAppend(Node):
    def __init__(self, cfg, a: Node, b: Node):
        super().__init__(cfg)
        self.a, self.b = a, b
        if a.reloc is not None and b.reloc is not None:
            def reloc(P, li, lits=None):
                ya, la = a.reloc(P, li, lits)
                if la is None:
                    # Infinite a: b never plays (matches the stateful path).
                    return ya, None
                yb, lb = b.reloc(P, li - la, lits)
                return torch.where(li < la, ya, yb), _len_add(la, lb)
            self.reloc = reloc

    def init(self, P):
        return (torch.zeros((), dtype=torch.bool, device=P.device),
                self.a.init(P), self.b.init(P))

    def render(self, P, st, s, e, ctx):
        a_done, sa, sb = st
        ea = torch.where(a_done, s, e)
        ya, va, wa, sa = self.a.render(P, sa, s, ea, ctx)
        a_done = a_done | (va < ea)
        bs = torch.where(va < e, va, e)
        yb, vb, wb, sb = self.b.render(P, sb, bs, e, ctx)
        # b overwrites the shared buffer from va; a's overrun writes
        # survive where b didn't write (reference buffer behavior).
        l = ctx.idx
        y = torch.where(l < va, ya, torch.where(
            l < wb, yb, torch.where(l < wa, ya, 0.0)))
        return (y, torch.where(va < e, vb, va), torch.maximum(wa, wb),
                (a_done, sa, sb))

    def advance(self, P, st, s, e, ctx):
        a_done, sa, sb = st
        ea = torch.where(a_done, s, e)
        va, sa = self.a.advance(P, sa, s, ea, ctx)
        a_done = a_done | (va < ea)
        bs = torch.where(va < e, va, e)
        vb, sb = self.b.advance(P, sb, bs, e, ctx)
        return torch.where(va < e, vb, va), (a_done, sa, sb)


class CBinary(Node):
    def __init__(self, cfg, op: ir.Operator, a: Node, b: Node):
        super().__init__(cfg)
        self.op, self.a, self.b = op, a, b
        if a.const_expr is not None and b.const_expr is not None:
            ca, cb = a.const_expr, b.const_expr
            self.const_expr = lambda P: _apply_op(op, ca(P), cb(P))
        if a.reloc is not None and b.reloc is not None:
            def reloc(P, li, lits=None):
                ya, la = a.reloc(P, li, lits)
                yb, lb = b.reloc(P, li, lits)
                if op == ir.Operator.MERGE:
                    # Operands are zero past their own lengths by the reloc
                    # contract, so zero-extension is a plain add.
                    return ya + yb, _len_max(la, lb)
                v = _len_min(la, lb)
                return _len_mask(li, _apply_op(op, ya, yb), v), v
            self.reloc = reloc

        # b's valid end is always the e it is given (the result's is then
        # a's): a settled a's raw lanes past the result are then 0.
        self.b_inf = _infinite(b)

    def init(self, P):
        return (self.a.init(P), self.b.init(P))

    def render(self, P, st, s, e, ctx):
        sa, sb = st
        ya, va, wa, sa = self.a.render(P, sa, s, e, ctx)
        merge = self.op == ir.Operator.MERGE
        eb = e if merge else va
        yb, vb, wb, sb = self.b.render(P, sb, s, eb, ctx)
        raw_a = ya
        if ya.dim() == 0:
            # a settled (one value a row, valid to e): its raw lanes hold
            # that value on [s, e) and 0 past it, read past v only where
            # b may end first.
            raw_a = 0.0 if merge or self.b_inf else _gate(ctx, s, e, ya, 0.0)
        if merge:
            v = torch.maximum(va, vb)
            # [va, v) of the shared buffer is zero-filled before the op, so
            # a's overrun writes vanish inside the result but survive
            # beyond it (generator.rs:543,560-566).
            a_z = ya if ya.dim() == 0 else torch.where(ctx.idx < va, ya, 0.0)
            y = _gate(ctx, s, v, a_z + yb, raw_a)
        else:
            v = torch.minimum(va, vb)
            y = _gate(ctx, s, v, _apply_op(self.op, ya, yb), raw_a)
        return y, v, torch.maximum(wa, v), (sa, sb)

    def advance(self, P, st, s, e, ctx):
        sa, sb = st
        va, sa = self.a.advance(P, sa, s, e, ctx)
        vb, sb = self.b.advance(P, sb, s, e, ctx)
        v = torch.maximum(va, vb) if self.op == ir.Operator.MERGE \
            else torch.minimum(va, vb)
        return v, (sa, sb)


def _nco_angle(ph):
    """NCO phase (int64 holding a u32 in turns scaled 2^32) -> f32
    radians via its top 24 bits, which float32 holds exactly."""
    return (ph >> 8).to(f32) * CSine.NCO_TO_RAD


def _nco_inc_host(freq_v, sample_rate: int) -> int:
    """Host replication of CSine._nco_inc in exact f32 arithmetic: the
    u32 phase increment the NCO uses for `freq_v` rad/s."""
    fc = np.float32(freq_v) / np.float32(sample_rate * TAU)
    frac = np.float32(fc - np.floor(fc))
    x = frac * np.float32(2.0 ** 32)
    if x >= np.float32(2 ** 31):
        return int(np.uint32(np.int32(np.float32(
            x - np.float32(2 ** 31)))) + np.uint32(2 ** 31))
    return int(np.int32(x))


class CSine(Node):
    """DDS oscillator.

    Fast mode: a 32-bit NCO for constant frequencies (integer wrap-around
    is the exact mod-tau reduction; per-lane phase is one multiply), and
    for dynamic frequencies an f32 phase integrated with the prefix-sum
    kernel.  Exact mode: the reference's f64 radian accumulator.  exact_df:
    the same accumulator as a double-single (hi, lo) pair, integrated
    with the df prefix-sum kernel and reduced mod 2 pi in df before the
    sin (tuun_tpu graph.py:635-648, 670-677, 699-718)."""

    NCO_SCALE = float(2.0 ** 32)
    NCO_TO_RAD = float(TAU / 2.0 ** 24)

    def __init__(self, cfg, freq: Node, phase: Node):
        super().__init__(cfg)
        self.freq, self.phase = freq, phase
        self.nco = cfg.precision == "fast" and freq.const_expr is not None
        if freq.const_expr is not None and phase.reloc is not None:
            pd = cfg.phase_dtype
            sr = float(cfg.sample_rate)
            if self.nco:
                def reloc(P, li, lits=None):
                    yp, lp = phase.reloc(P, li, lits)
                    # li is an absolute index here, not a lane offset.
                    ph = _mul_u32(li, self._nco_inc(P))
                    y = torch.sin(_nco_angle(ph) + yp)
                    return _len_mask(li, y, lp), lp
            elif cfg.df_phase:
                def reloc(P, li, lits=None):
                    # li * (f/sr) mod 2 pi in double-single (li is exact
                    # in f32 below 2^24 lanes, as on the fast path).
                    fc = freq.const_expr(P).to(f32)
                    fh, fl = df32.df_div_f32(
                        fc, torch.full((), sr, dtype=f32, device=fc.device))
                    yp, lp = phase.reloc(P, li, lits)
                    lif = li.to(f32)
                    ph, pl = df32.df_mul(lif, torch.zeros_like(lif), fh, fl)
                    ph, pl = df32.df_add(ph, pl, yp, torch.zeros_like(yp))
                    ph, pl = df32.df_mod_tau(ph, pl)
                    return _len_mask(li, df32.df_sin(ph, pl), lp), lp
            else:
                def reloc(P, li, lits=None):
                    inc = _div(freq.const_expr(P).to(pd), sr)
                    yp, lp = phase.reloc(P, li, lits)
                    acc = torch.remainder(li.to(pd) * inc, TAU)
                    y = torch.sin(acc + yp.to(pd)).to(f32)
                    return _len_mask(li, y, lp), lp
            self.reloc = reloc

    def _nco_inc(self, P):
        """u32 phase increment per sample (as int64) for the constant
        frequency, in the JAX engine's exact f32 arithmetic."""
        fc = _div(self.freq.const_expr(P),
                  float(np.float32(self.cfg.sample_rate * TAU)))
        frac = fc - torch.floor(fc)  # cycles/sample in [0, 1)
        x = frac * self.NCO_SCALE
        big = x >= 2.0 ** 31
        xm = torch.where(big, x - 2.0 ** 31, x)
        return (xm.to(I64) + torch.where(big, 2 ** 31, 0)) & M32

    def init(self, P):
        if self.cfg.df_phase and not self.nco:
            acc = (torch.zeros((), dtype=f32, device=P.device),
                   torch.zeros((), dtype=f32, device=P.device))
        else:
            dtype = I64 if self.nco else self.cfg.phase_dtype
            acc = torch.zeros((), dtype=dtype, device=P.device)
        return (acc, self.freq.init(P), self.phase.init(P))

    def render(self, P, st, s, e, ctx):
        acc, sf, sp = st
        if self.nco:
            # Constant frequency: the frequency subtree is a constant
            # expression (its state advancement is a no-op), so skip it.
            yp, vp, wp, sp = self.phase.render(P, sp, s, e, ctx)
            inc = self._nco_inc(P)
            ph = (acc + (ctx.idx - s) * inc) & M32
            # Written across the whole region (the reference loops to the
            # frequency's length, which is infinite here), with the phase
            # buffer's contents as written (generator.rs:208-220).
            y = _gate(ctx, s, e, torch.sin(_nco_angle(ph) + yp), 0.0)
            acc = (acc + (e - s).clamp(min=0) * inc) & M32
            return y, vp, e, (acc, sf, sp)
        pd = self.cfg.phase_dtype
        yf, vf, wf, sf = self.freq.render(P, sf, s, e, ctx)
        yp, vp, wp, sp = self.phase.render(P, sp, s, vf, ctx)
        if self.cfg.df_phase:
            # Per-lane phases reduce mod 2 pi before the sin: an f32 hi
            # word at a large absolute phase has an ulp far above the
            # resolution the reference keeps.
            fv = _gate(ctx, s, vf, yf, 0.0)
            ih, il = df32.df_div_f32(fv, torch.full(
                (), float(self.cfg.sample_rate), dtype=f32, device=fv.device))
            ch, cl = df32.df_cumsum(ih, il)          # inclusive prefix
            ah, al = acc
            ph, pl = df32.df_add(ch, cl, -ih, -il)   # exclusive prefix
            ph, pl = df32.df_add(ph, pl, ah, al)
            ph, pl = df32.df_add(ph, pl, yp, torch.zeros_like(yp))
            ph, pl = df32.df_mod_tau(ph, pl)
            y = _gate(ctx, s, vf, df32.df_sin(ph, pl), _raw(yf))
            nh, nl = df32.df_add(ah, al, ch[-1], cl[-1])
            nh, nl = df32.df_mod_tau(nh, nl)
            return y, vp, torch.maximum(wf, vf), ((nh, nl), sf, sp)
        inc = _div(_gate(ctx, s, vf, yf, 0.0).to(pd),
                   float(self.cfg.sample_rate))
        pre = _cumsum(inc) - inc
        y = torch.sin(acc + pre + yp.to(pd)).to(f32)
        # Sine overwrites the frequency's buffer up to the frequency's
        # returned length; beyond that the frequency's own overrun writes
        # remain (shared-buffer semantics).
        y = _gate(ctx, s, vf, y, _raw(yf))
        acc = torch.remainder(acc + inc.sum(), TAU)
        return y, vp, torch.maximum(wf, vf), (acc, sf, sp)

    def advance(self, P, st, s, e, ctx):
        acc, sf, sp = st
        vf, sf = self.freq.advance(P, sf, s, e, ctx)
        vp, sp = self.phase.advance(P, sp, s, e, ctx)
        return torch.minimum(vf, vp), (acc, sf, sp)


class CFilter(Node):
    def __init__(self, cfg, inner: Node, ffs: List[Node], fbs: List[Node],
                 ff_consts: List[Optional[Callable]],
                 fb_consts: List[Optional[Callable]]):
        super().__init__(cfg)
        self.inner = inner
        self.ffs, self.fbs = ffs, fbs
        self.ff_consts, self.fb_consts = ff_consts, fb_consts
        self.K = len(ffs)
        self.J = len(fbs)

    def init(self, P):
        inner_st = self.inner.init(P)
        K, J = self.K, self.J
        dev = P.device
        delay = torch.zeros(max(K - 1, 1), dtype=f32, device=dev)
        real = _zero_i(P)
        if K > 1:
            # Prime the input delay line with the first K-1 inner samples
            # (generator.rs:223-252), keeping only the valid prefix.
            pctx = Ctx(K - 1, dev)
            y, v, w, inner_st = self.inner.render(P, inner_st, pctx.zero,
                                                  pctx.end, pctx)
            delay = torch.where(pctx.idx < v, y, 0.0)
            real = v
        hist = torch.zeros(max(J, 1), dtype=f32, device=dev)
        return (delay, real, hist, inner_st,
                tuple(c.init(P) for c in self.ffs),
                tuple(c.init(P) for c in self.fbs))

    def render(self, P, st, s, e, ctx):
        delay, real, hist, si, sffs, sfbs = st
        K, J = self.K, self.J
        idx = ctx.idx

        wy_raw, wv, ww, si = self.inner.render(P, si, s, e, ctx)
        # generator.rs:404-405 zero-fills beyond the inner's returned
        # length before filtering, overwriting any of its overrun writes.
        wy = _gate(ctx, s, wv, wy_raw, 0.0)
        out_end = torch.minimum(e, wv + real)

        ff_vals, sffs = self._coeffs(P, self.ffs, self.ff_consts, sffs,
                                     s, out_end, ctx)
        fb_vals, sfbs = self._coeffs(P, self.fbs, self.fb_consts, sfbs,
                                     s, out_end, ctx)

        # Feed-forward: y_ff[i] = sum_m b_m[i] * w_stream[i - m]; lanes
        # before s come from the carried delay line.  Accumulation order
        # matches the oracle (x*b0, then += b_m * w in m order).
        acc = wy * ff_vals[0]
        for m in range(1, K):
            d = idx - m - s  # negative -> delay line
            dval = delay[(d + (K - 1)).clamp(0, K - 2)]
            shifted = torch.where(d < 0, dval, torch.roll(wy, m))
            acc = acc + ff_vals[m] * shifted

        live = _mask(ctx, s, out_end)
        acc = _gate(ctx, s, out_end, acc, 0.0)
        if J > 0:
            y, hist = self._feedback(acc, fb_vals, hist, live)
        else:
            y = acc

        # Carry the next window's K-1 preceding extended-stream samples
        # (zero past the block, the delay line before s).
        if K > 1:
            lanes = out_end - (K - 1) + torch.arange(K - 1, dtype=I64,
                                                     device=ctx.device)
            wvals = torch.where(lanes < ctx.n,
                                wy[lanes.clamp(0, ctx.n - 1)], 0.0)
            dvals = delay[(K - 1 + lanes - s).clamp(0, K - 2)]
            delay = torch.where(lanes < s, dvals, wvals)
        real = (real + wv - out_end).clamp(0, K - 1)
        # Beyond out_end the buffer keeps the zero-fill.
        return y, out_end, e, (delay, real, hist, si, sffs, sfbs)

    def _coeffs(self, P, nodes, consts, states, s, out_end, ctx):
        vals = []
        new_states = []
        for node, cexpr, st in zip(nodes, consts, states):
            if cexpr is not None:
                vals.append(cexpr(P).expand(ctx.n))
            else:
                # The reference reads the raw coefficient buffer to out_len
                # regardless of the coefficient's returned length.
                y, v, w, st = node.render(P, st, s, out_end, ctx)
                vals.append(y)
            new_states.append(st)
        return vals, tuple(new_states)

    def _feedback(self, ff, fb_vals, hist, live):
        """y[i] = ff[i] - sum_j a_j[i] * y[i-1-j]; hist[j] = y[-1-j].

        The exact precisions: the linear recurrence kernel, in the
        reference's op order (tuun_tpu graph.py:852-864), in float32 as
        the JAX engine's scan and the oracle run it.  Fast mode, over
        composed companion maps as tuun_tpu's parallel scan
        (graph.py:865-897): up to scan_ops.MAX_J coefficients the
        affine-scan kernel, up to scan_ops.MAX_DEEP_J its deep form
        (tuun_tpu runs an associative scan past its Pallas kernel's 4),
        each returning y (0 on dead lanes) and the history.  A deeper fast
        filter runs the recurrence kernel, which rounds in the reference's
        op order, so it is at least as accurate."""
        J = self.J
        a_rows = torch.stack(fb_vals, dim=1)  # [N, J]
        h0 = hist[:J].contiguous()
        if self.cfg.sequential_iir or J > scan_ops.MAX_DEEP_J:
            y, hist_out = scan_ops.linear_recurrence(a_rows, ff, live, h0)
        elif J > scan_ops.MAX_J:
            y, hist_out = scan_ops.affine_scan_deep_f32(a_rows, ff, live, h0)
        else:
            y, hist_out = scan_ops.affine_scan_f32(a_rows, ff, live, h0)
        return y, _pad_hist(hist_out, J)

    def advance(self, P, st, s, e, ctx):
        delay, real, hist, si, sffs, sfbs = st
        v, si = self.inner.advance(P, si, s, e, ctx)
        sffs = tuple(
            c.advance(P, cs, s, e, ctx)[1] if cx is None else cs
            for c, cx, cs in zip(self.ffs, self.ff_consts, sffs))
        sfbs = tuple(
            c.advance(P, cs, s, e, ctx)[1] if cx is None else cs
            for c, cx, cs in zip(self.fbs, self.fb_consts, sfbs))
        return v, (delay, real, hist, si, sffs, sfbs)


def _pad_hist(h, J):
    if h.shape[0] == max(J, 1):
        return h
    return torch.cat([h, h.new_zeros(max(J, 1) - h.shape[0])])


class CFin(Node):
    fin_slot: Optional[int] = None  # index into the literal cutoffs (lits)

    def __init__(self, cfg, length: Node, inner: Node,
                 ge0: Optional[Callable]):
        super().__init__(cfg)
        self.length = length
        self.inner = inner
        self.ge0 = ge0  # fn(P, lpos, maxn) -> rel cutoff in [0, maxn]
        if ge0 is not None and inner.reloc is not None:
            def reloc(P, li, lits=None):
                # The literal cutoff when the caller computed the lits.
                rel = lits[self.fin_slot] if lits is not None \
                    else ge0(P, _zero_i(P), BIG)
                yi, lin = inner.reloc(P, li, lits)
                v = _len_min(lin, rel)
                return _len_mask(li, yi, v), v
            self.reloc = reloc
            self.static_len = lambda P: _tmin(
                ge0(P, _zero_i(P), BIG),
                inner.static_len(P) if inner.static_len is not None
                else BIG)

    def init(self, P):
        return (_zero_i(P), self.length.init(P), self.inner.init(P))

    def _cutoff_render(self, P, lpos, sl, s, e, ctx):
        """Returns (cutoff_lane, lpos', length_state') for a generate()-arm
        resolution (generator.rs:133-168)."""
        maxn = (e - s).clamp(min=0)
        if self.ge0 is not None:
            rel = self.ge0(P, lpos, maxn)
            _, sl = self.length.advance(P, sl, s, e, ctx)
            return s + torch.minimum(rel, maxn), lpos + maxn, sl
        # Value path: render the length waveform and find the first lane
        # with a non-negative value (or its end).
        ly, lv, lw, sl = self.length.render(P, sl, s, e, ctx)
        cond = (_mask(ctx, s, lv) & (ly >= 0.0)) | _mask(ctx, lv, e)
        return _first_lane(ctx, cond, e), lpos + maxn, sl

    def render(self, P, st, s, e, ctx):
        lpos, sl, si = st
        cutoff, lpos, sl = self._cutoff_render(P, lpos, sl, s, e, ctx)
        yi, vi, wi, si = self.inner.render(P, si, s, cutoff, ctx)
        # Advance the inner past the truncation point (length-only).
        _, si = self.inner.advance(P, si, cutoff, e, ctx)
        return yi, vi, wi, (lpos, sl, si)

    def advance(self, P, st, s, e, ctx):
        lpos, sl, si = st
        maxn = (e - s).clamp(min=0)
        if self.ge0 is not None:
            rel = self.ge0(P, lpos, maxn)
            vi, si = self.inner.advance(P, si, s, e, ctx)
            _, sl = self.length.advance(P, sl, s, e, ctx)
            return torch.minimum(s + torch.minimum(rel, maxn), vi), \
                (lpos + maxn, sl, si)
        ly, lv, lw, sl = self.length.render(P, sl, s, e, ctx)
        vi, si = self.inner.advance(P, si, s, e, ctx)
        cond = (_mask(ctx, s, lv) & (ly >= 0.0)) | _mask(ctx, lv, e) | \
            _mask(ctx, vi, e)
        return _first_lane(ctx, cond, e), (lpos + maxn, sl, si)


class CReset(Node):
    """Reset(trigger, inner): restart `inner` at each -..+ trigger crossing.

    Analytic-edge tiers (fast mode, tuun_tpu graph.py:983-1513): when the
    trigger is an NCO sine with a structurally zero phase (`$f`, tier 0),
    or a pointwise tree over one such Reset whose per-period sign pattern
    is verified on the host at compile time (composite hard-sync and PWM
    tiers), its rising edges are exactly the base NCO's phase wraps, so
    the age of each lane since the last edge is the integer identity

        age(i) = (i·inc mod 2^32) // inc,

    with no trigger render and no running max.  The node is then
    relocatable.  The sign rule behind it (sin >= 0 iff the phase is
    below 2^31 at every grid angle) is checked on the card by
    chip_smoke.py.

    Otherwise the generic sampled-sign tiers: the trigger renders, edges
    are its sign crossings, and the last edge at or before each lane is a
    running max over edge lane indices (the prefix-max kernel).  A
    relocatable inner is then evaluated at each lane's age; a stateful
    inner renders once from a fresh state over the block and is gathered
    at the ages (tuun_tpu graph.py:1515-1588).  Both tiers give the same
    bits.
    """

    def __init__(self, cfg, trigger: Node, inner: Node,
                 compiler: "Compiler"):
        super().__init__(cfg)
        self.trigger = trigger
        self.inner = inner
        self.inner_reloc = inner.reloc
        # Composite-trigger info: (base CSine, acc path into the trigger
        # state tree, positive-prefix length k in samples or None, LFO
        # leaves ((CSine, acc path), ...), base CReset, trigger root); None
        # for the plain-sine tier.  k is None for PWM triggers, whose
        # last-lane sign is evaluated in closed form at run time.
        self._trig = None
        self.analytic = self._analytic_ok(trigger, compiler)
        if not self.analytic:
            self._trig = self._wrap_edge_info(trigger, compiler)
            if self._trig is None:
                self._trig = self._wrap_edge_info_pwm(trigger, compiler)
            self.analytic = self._trig is not None
        if self.analytic and inner.reloc is not None:
            inner_reloc = inner.reloc

            def reloc(P, li, lits=None):
                age = self._analytic_age(self._inc(P), li.clamp(min=0))
                yi, _ = inner_reloc(P, age, lits)
                return yi, None  # the trigger (= validity) is infinite
            self.reloc = reloc

    # -- analytic-trigger plumbing ---------------------------------------
    # The trigger's NCO accumulator is strg[0] for a plain sine trigger;
    # for a composite trigger it lives at _trig's recorded path inside
    # the (never otherwise touched) trigger state tree.

    def _inc(self, P):
        """Phase increment of the NCO whose wraps are the reset edges."""
        if self._trig is None:
            return self.trigger._nco_inc(P)
        return self._trig[0]._nco_inc(P)

    def _acc_path(self):
        return (0,) if self._trig is None else self._trig[1]

    def _acc_get(self, strg):
        return _path_get(strg, self._acc_path())

    def _acc_set(self, strg, v):
        return _path_set(strg, self._acc_path(), v)

    @staticmethod
    def _analytic_ok(trigger: Node, compiler: "Compiler") -> bool:
        """Tier 0: a fast-mode NCO sine whose phase is a structural Const
        0 and whose frequency is a structural Const in (0, Nyquist) at
        compile time (tuun_tpu graph.py:1057-1079; structure_key keys
        these decisions, so a same-structure params swap keeps them)."""
        if not (isinstance(trigger, CSine) and trigger.nco):
            return False
        if not (isinstance(trigger.phase, CConst)
                and isinstance(trigger.freq, CConst)):
            return False
        phase_v = float(compiler.const_values[trigger.phase.index])
        freq_v = float(compiler.const_values[trigger.freq.index])
        fc = freq_v / (trigger.cfg.sample_rate * TAU)  # cycles/sample
        # The lower bound keeps inc comfortably non-zero: the inc == 0
        # branch of _age_from_phase is exact only for absolute indices.
        return phase_v == 0.0 and 2.0 ** -20 < fc < 0.5

    @staticmethod
    def _base_period(base_sine: "CSine", compiler: "Compiler"):
        """A = the largest age within one period of the base NCO, or None
        when the period is outside [2, 2^21] samples."""
        freq_v = np.float32(compiler.const_values[base_sine.freq.index])
        inc = _nco_inc_host(freq_v, base_sine.cfg.sample_rate)
        if inc <= 0:
            return None
        A = (2 ** 32 - 1) // inc
        return A if 2 <= A <= 2 ** 21 else None

    @classmethod
    def _wrap_edge_info(cls, trigger: Node, compiler: "Compiler"):
        """Composite analytic triggers (tuun_tpu graph.py:1081-1175): a
        tree of Const/Binary/Alt/markers over exactly one tier-0 Reset
        (sawtooth, pulse, and their hard-sync uses) is a function of that
        Reset's age.  If its sign over one base period, sampled on the
        host with the current consts, is a non-negative prefix of k lanes
        then a strictly negative tail, its rising edges are the base
        NCO's wraps.  Returns (base_sine, acc_path, k, (), None, None) or
        None."""
        if trigger.has_capture or trigger.reloc is None:
            return None
        found = []

        def walk(node, path):
            while isinstance(node, CWrap):
                if node.capture_stem is not None:
                    return False
                node = node.inner  # state passthrough: no tuple level
            if isinstance(node, CConst):
                return True
            if isinstance(node, CBinary):
                return walk(node.a, path + (0,)) \
                    and walk(node.b, path + (1,))
            if isinstance(node, CAlt):
                return walk(node.trigger, path + (0,)) \
                    and walk(node.pos, path + (1,)) \
                    and walk(node.neg, path + (2,))
            if isinstance(node, CReset) and node.analytic \
                    and node._trig is None \
                    and node.inner_reloc is not None \
                    and isinstance(node.trigger, CSine):
                found.append((node, path))
                return True
            return False

        if not walk(trigger, ()) or len(found) != 1:
            return None
        base_reset, path = found[0]
        base_sine = base_reset.trigger
        A = cls._base_period(base_sine, compiler)
        if A is None:
            return None
        # One period's sign pattern through the trigger's own reloc (ages
        # equal local indices before the first wrap), on CPU tensors.
        try:
            y, _ = trigger.reloc(_compile_params(compiler),
                                 torch.arange(A + 1, dtype=I64))
        except IndexError:  # a Fixed payload: no compile-time params
            return None
        g = y.numpy()
        if not np.isfinite(g).all():
            return None
        pos = g >= 0.0
        neg = np.signbit(g)
        if not pos[0] or neg[0]:
            return None
        k = int(np.argmin(pos)) if not pos.all() else len(pos)
        # g[A-1] and g[A] strictly negative (the pre-wrap lane is one of
        # them, by the phase residue) and no rise inside the period.
        if k > A - 1 or pos[k:].any() or not neg[k:].all() \
                or neg[:k].any():
            return None
        return (base_sine, path + (2, 0), k, (), None, None)

    # Margin (in trigger-value units) by which the interval-arithmetic
    # PWM verification must clear zero: far above f32 rounding, below
    # real pulse widths' margins.
    PWM_EPS = 1e-3

    @classmethod
    def _wrap_edge_info_pwm(cls, trigger: Node, compiler: "Compiler"):
        """Modulated-width composite triggers (tuun_tpu graph.py:1184-
        1285): `pulse(w, f)` with a width of const-frequency NCO sine LFOs
        (std.tuun's harmonica `breathy`), or any affine combination of one
        tier-0 Reset with such LFOs.  Its rising edges are still the base
        NCO's wraps provided each period's sign is a non-negative prefix
        then a strictly negative tail for every value the LFOs can take,
        which _pwm_verify proves with interval arithmetic.  The carried
        sign is evaluated at run time in closed form (_trig_value_last).
        Returns (base_sine, base_acc_path, None, lfos, base_reset,
        trigger) or None; lfos = ((CSine, acc_path), ...)."""
        if trigger.has_capture or trigger.reloc is None:
            return None
        # Peel markers; a root alt(X, p, n) with structural consts
        # p >= 0 > n only shapes the sign of X, so verify X.
        core, core_path = trigger, ()
        while isinstance(core, CWrap):
            if core.capture_stem is not None:
                return None
            core = core.inner
        if isinstance(core, CAlt):
            pv = cls._struct_const(core.pos, compiler)
            nv = cls._struct_const(core.neg, compiler)
            if pv is None or nv is None or not (pv >= 0.0 > nv):
                return None
            core, core_path = core.trigger, (0,)
        bases: list = []
        lfos: list = []

        def walk(node, path):
            while isinstance(node, CWrap):
                if node.capture_stem is not None:
                    return False
                node = node.inner
            if isinstance(node, CConst):
                return True
            if isinstance(node, CBinary):
                if node.op not in (ir.Operator.ADD, ir.Operator.SUBTRACT,
                                   ir.Operator.MULTIPLY):
                    return False
                return walk(node.a, path + (0,)) \
                    and walk(node.b, path + (1,))
            if isinstance(node, CReset) and node.analytic \
                    and node._trig is None \
                    and node.inner_reloc is not None \
                    and isinstance(node.trigger, CSine):
                bases.append((node, path))
                return True
            if isinstance(node, CSine) and node.nco \
                    and isinstance(node.phase, CConst):
                lfos.append((node, path))
                return True
            return False

        if not walk(core, core_path) or len(bases) != 1 or not lfos:
            return None
        if cls._subtree_has_fin(trigger):
            # A Fin inside the trigger makes its value depend on lengths
            # the closed-form evaluation cannot see.
            return None
        base_reset, base_path = bases[0]
        base_sine = base_reset.trigger
        A = cls._base_period(base_sine, compiler)
        if A is None:
            return None
        if not cls._pwm_verify(core, base_reset, lfos, compiler, A):
            return None
        return (base_sine, base_path + (2, 0), None,
                tuple((sn, pth + (0,)) for sn, pth in lfos),
                base_reset, trigger)

    @staticmethod
    def _struct_const(node: Node, compiler: "Compiler"):
        """float value of a structural Const subtree (markers peeled),
        else None."""
        while isinstance(node, CWrap):
            node = node.inner
        if isinstance(node, CConst):
            return float(compiler.const_values[node.index])
        return None

    @staticmethod
    def _subtree_has_fin(node: Node) -> bool:
        todo = [node]
        while todo:
            n = todo.pop()
            if isinstance(n, CFin):
                return True
            for attr in ("a", "b", "inner", "trigger", "pos", "neg",
                         "freq", "phase", "length"):
                c = getattr(n, attr, None)
                if isinstance(c, Node):
                    todo.append(c)
            for lst in (getattr(n, "ffs", ()), getattr(n, "fbs", ())):
                todo.extend(c for c in lst if isinstance(c, Node))
        return False

    @classmethod
    def _pwm_verify(cls, core: Node, base_reset: "CReset", lfos,
                    compiler: "Compiler", A: int) -> bool:
        """Sound per-period sign-pattern check (tuun_tpu graph.py:1316-
        1408): decompose the trigger as X(a, t) = d(a) + H(t), d sampled
        per age over one base period on the host, H bounded by [lo, hi]
        with per-sample slope <= s, then require d[0] + lo >= eps, d[A-1]
        + hi <= -eps and d[A] + hi <= -eps, and d falling by more than
        s + eps per sample through the band where the sign is open."""
        sr = base_reset.cfg.sample_rate
        P0 = _compile_params(compiler)
        try:
            yb, _ = base_reset.reloc(P0, torch.arange(A + 1, dtype=I64))
        except IndexError:  # a Fixed payload: no compile-time params
            return False
        gbase = yb.numpy().astype(np.float64)
        lfo_info = {id(sn): abs(float(sn.freq.const_expr(P0))) / sr
                    for sn, _ in lfos}  # rad (= max dy) per sample
        if not np.isfinite(gbase).all():
            return False

        class Reject(Exception):
            pass

        def const_of(x):
            return None if isinstance(x, np.ndarray) else float(x)

        def dec(node):
            """-> (g, lo, hi, slope): X = g(age) + H(t), H in [lo, hi],
            |H(t+1) - H(t)| <= slope."""
            while isinstance(node, CWrap):
                node = node.inner
            if node is base_reset:
                return gbase, 0.0, 0.0, 0.0
            if id(node) in lfo_info:
                return 0.0, -1.0, 1.0, lfo_info[id(node)]
            if isinstance(node, CConst):
                return float(compiler.const_values[node.index]), \
                    0.0, 0.0, 0.0
            if isinstance(node, CBinary):
                ga, la, ha, sa = dec(node.a)
                gb, lb, hb, sb = dec(node.b)
                if node.op == ir.Operator.ADD:
                    return ga + gb, la + lb, ha + hb, sa + sb
                if node.op == ir.Operator.SUBTRACT:
                    return ga - gb, la - hb, ha - lb, sa + sb
                # MULTIPLY: const scaling, age*age and lfo*lfo.
                for (gc, lc, hc, sc), (go, lo, ho, so) in \
                        (((ga, la, ha, sa), (gb, lb, hb, sb)),
                         ((gb, lb, hb, sb), (ga, la, ha, sa))):
                    c = const_of(gc)
                    if c is not None and lc == hc == 0.0 and sc == 0.0:
                        if c >= 0.0:
                            return go * c, lo * c, ho * c, so * c
                        return go * c, ho * c, lo * c, so * (-c)
                if la == ha == 0.0 == lb == hb and sa == sb == 0.0:
                    return ga * gb, 0.0, 0.0, 0.0  # both pure-age
                if const_of(ga) == 0.0 and const_of(gb) == 0.0:
                    prods = [la * lb, la * hb, ha * lb, ha * hb]
                    mag_a = max(abs(la), abs(ha))
                    mag_b = max(abs(lb), abs(hb))
                    return 0.0, min(prods), max(prods), \
                        mag_a * sb + mag_b * sa
                raise Reject
            raise Reject

        try:
            d, lo, hi, slope = dec(core)
        except Reject:
            return False
        if not isinstance(d, np.ndarray):
            return False  # no age dependence: no wraps to ride
        eps = cls.PWM_EPS
        if not (d[0] + lo >= eps):
            return False
        if not (d[A - 1] + hi <= -eps and d[A] + hi <= -eps):
            return False
        pos_m = d + lo >= eps   # sign decided positive for every H
        neg_m = d + hi <= -eps  # sign decided negative for every H
        p = int(np.argmin(pos_m)) - 1 if not pos_m.all() else A
        # q = start of the trailing all-negative-decided suffix.
        q = 0 if neg_m.all() else A + 1 - int(np.argmin(neg_m[::-1]))
        band = np.diff(d)[p:q]
        return bool((band <= -(slope + eps)).all())

    def _trig_value_last(self, P, strg, age_last, n_adv):
        """The trigger's value at the last rendered lane, in closed form:
        the base Reset contributes inner_reloc(age), each LFO sine its NCO
        phase read from the (analytically advanced) trigger state.  The
        same ops as the sampled trigger render at that lane."""
        _, _, _, lfos, base, root = self._trig
        off = (n_adv - 1).clamp(min=0)
        phases = {id(sn): (_path_get(strg, pth) + off * sn._nco_inc(P)) & M32
                  for sn, pth in lfos}
        return _scalar_trig_value(root, base, P, age_last.clamp(min=0),
                                  phases)

    @staticmethod
    def _age_from_phase(inc, ph, liu):
        """Exact samples since the last edge given the NCO phase `ph` at
        the lane (== liu*inc mod 2^32); edges are wraps, so age = ph //
        inc.  inc == 0 (a frequency that quantizes to zero) means one edge
        at sample 0: age = the sample index."""
        safe = inc.clamp(min=1)
        return torch.where(inc == 0, liu,
                           torch.div(ph, safe, rounding_mode="floor"))

    @classmethod
    def _analytic_age(cls, inc, liu):
        return cls._age_from_phase(inc, _mul_u32(liu, inc), liu)

    def init(self, P):
        return (torch.full((), -1.0, dtype=f32, device=P.device), _zero_i(P),
                self.trigger.init(P), self.inner.init(P))

    def _render_analytic(self, P, st, s, e, ctx):
        """Interval render with closed-form edges (tuun_tpu graph.py:1441-
        1513): no trigger render (its validity is infinite and its state
        is one u32 accumulator, plus the LFOs' for PWM), no cross-lane
        scan.  The same bits as the generic tier below."""
        sign, age, strg, sinn = st
        acc = self._acc_get(strg)  # the base NCO's phase accumulator
        inc = self._inc(P)
        # Lanes before s are masked out; clamping them keeps local * inc
        # below 2^56.
        local = (ctx.idx - s).clamp(min=0)
        ph = (acc + local * inc) & M32  # absolute NCO phase per lane
        ageL = self._age_from_phase(inc, ph, local)
        n_adv = (e - s).clamp(min=0)
        nonempty = e > s
        # Trigger state, sign and age bookkeeping: scalar arithmetic.
        ph_last = (acc + (n_adv - 1).clamp(min=0) * inc) & M32
        age_last = self._age_from_phase(inc, ph_last, ph_last)
        new_acc = (acc + n_adv * inc) & M32
        if self._trig is None:
            # Sine trigger: non-negative exactly while phase < half turn.
            pos_last = ph_last < 2 ** 31
        elif self._trig[2] is not None:
            # Composite trigger: non-negative exactly on the verified
            # k-lane positive prefix of each period.
            pos_last = age_last < self._trig[2]
        else:
            # PWM trigger: the prefix varies per period; evaluate the
            # trigger at the last lane in closed form.
            pos_last = self._trig_value_last(
                P, strg, age_last, n_adv) >= 0.0
        sign = torch.where(nonempty, torch.where(pos_last, 1.0, -1.0), sign)
        new_age = torch.where(nonempty, age_last + 1, age)
        strg = self._acc_set(strg, new_acc)
        if self._trig is not None and self._trig[2] is None:
            # Advance the LFO accumulators as their sampled renders would
            # (acc += n*inc); the rest of the trigger state stays frozen.
            for sn, pth in self._trig[3]:
                strg = _path_set(strg, pth, (_path_get(strg, pth)
                                             + n_adv * sn._nco_inc(P)) & M32)

        if self.inner_reloc is not None:
            yi, _ = self.inner_reloc(P, ageL, ctx.lits)
            y = _gate(ctx, s, e, yi, 0.0)
            return y, e, e, (sign, new_age, strg, sinn)

        # Stateful inner: the generic tier's three renders, with the edge
        # vector and carry scalars in closed form.
        inner = self.inner
        fresh = inner.init(P)
        nctx = Ctx(ctx.n, ctx.device, allow_captures=False, lits=ctx.lits)
        # A lane is at/after an in-block edge iff its age fits since s.
        restarted = _mask(ctx, s, e) & (ctx.idx - ageL >= s)
        any_edge = restarted.any()
        y0, v0, _, st0 = inner.render(P, sinn, s, e, nctx)
        y0 = _gate(nctx, s, v0, y0, 0.0)
        yb, vb, _, _ = inner.render(P, fresh, nctx.zero, nctx.end, nctx)
        yb = torch.where(nctx.idx < vb, yb, 0.0)
        y = torch.where(restarted, yb[ageL.clamp(0, ctx.n - 1)], y0)
        y = _gate(ctx, s, e, y, 0.0)
        k = torch.where(nonempty, age_last + 1, 0).clamp(0, ctx.n)
        _, _, _, st_last = inner.render(P, fresh, nctx.zero, k, nctx)
        sinn = _tree_where(any_edge, st_last, st0)
        return y, e, e, (sign, new_age, strg, sinn)

    def render(self, P, st, s, e, ctx):
        if self.analytic:
            return self._render_analytic(P, st, s, e, ctx)
        sign, age, strg, sinn = st
        yt, vt, wt, strg = self.trigger.render(P, strg, s, e, ctx)
        m = _mask(ctx, s, vt)
        sg = torch.where(torch.signbit(yt), -1.0, 1.0)
        prev_neg = torch.where(ctx.idx == s, sign < 0.0,
                               torch.roll(sg, 1) < 0.0)
        edge = m & prev_neg & (yt >= 0.0)
        # Lane index of the last edge at or before each lane (NO_EDGE
        # before the first one).
        last_f = _running_max_f32(torch.where(edge, ctx.fidx, NO_EDGE))
        nonempty = vt > s
        sign_last = _value_at(ctx, sg, vt - 1, sign)

        if self.inner_reloc is not None:
            # A virtual last-edge lane at s - age encodes the carried age.
            base = s - age
            last = torch.maximum(last_f.to(I64), base)
            yi, _ = self.inner_reloc(P, ctx.idx - last, ctx.lits)
            # Lanes beyond the trigger's validity keep the trigger's raw
            # writes (the reset reuses the trigger's buffer).
            y = _gate(ctx, s, vt, yi, yt)
            lastN = _last_lane(ctx, edge & (ctx.idx < vt), base)
            age = torch.where(nonempty, vt - lastN, age)
            sign = torch.where(nonempty, sign_last, sign)
            return y, vt, torch.maximum(wt, vt), (sign, age, strg, sinn)

        # Stateful inner: the restarted inner is a pure function of its
        # age, so one render from a fresh state over [0, n) gives every
        # post-edge lane as base[age] -- O(n) per block for any number of
        # edges.
        inner = self.inner
        fresh = inner.init(P)
        nctx = Ctx(ctx.n, ctx.device, allow_captures=False, lits=ctx.lits)
        any_edge = edge.any()

        # Continued segment [s, first edge) from the carried state.
        y0, v0, _, st0 = inner.render(P, sinn, s, vt, nctx)
        y0 = _gate(nctx, s, v0, y0, 0.0)
        # The restarted waveform over ages 0..n-1 (zeros once it ends).
        yb, vb, _, _ = inner.render(P, fresh, nctx.zero, nctx.end, nctx)
        yb = torch.where(nctx.idx < vb, yb, 0.0)

        restarted = last_f >= 0.0  # lane is at/after an edge in this block
        age_i = (ctx.idx - last_f.to(I64)).clamp(0, ctx.n - 1)
        y = torch.where(restarted, yb[age_i], y0)
        y = _gate(ctx, s, vt, y, yt)  # trigger's raw writes beyond validity

        # Carry: the state after (vt - last edge) samples from fresh (one
        # bounded render); without an edge, the continued state.
        lastN = _last_lane(ctx, edge & (ctx.idx < vt), s)
        k = (vt - lastN).clamp(0, ctx.n)
        _, _, _, st_last = inner.render(P, fresh, nctx.zero, k, nctx)
        sinn = _tree_where(any_edge, st_last, st0)
        sign = torch.where(nonempty, sign_last, sign)
        return y, vt, torch.maximum(wt, vt), (sign, age, strg, sinn)

    def advance(self, P, st, s, e, ctx):
        sign, age, strg, sinn = st
        vt, strg = self.trigger.advance(P, strg, s, e, ctx)
        return vt, (sign, age, strg, sinn)


class CAlt(Node):
    def __init__(self, cfg, trigger: Node, pos: Node, neg: Node):
        super().__init__(cfg)
        self.trigger, self.pos, self.neg = trigger, pos, neg
        if all(n.reloc is not None for n in (trigger, pos, neg)):
            def reloc(P, li, lits=None):
                yt, lt = trigger.reloc(P, li, lits)
                yp, _ = pos.reloc(P, li, lits)
                yn, _ = neg.reloc(P, li, lits)
                # Branches are already zero past their own lengths.
                return _len_mask(li, torch.where(yt >= 0.0, yp, yn), lt), lt
            self.reloc = reloc

    def init(self, P):
        return (self.trigger.init(P), self.pos.init(P), self.neg.init(P))

    def render(self, P, st, s, e, ctx):
        stt, stp, stn = st
        yt, vt, wt, stt = self.trigger.render(P, stt, s, e, ctx)
        yp, vp, wp, stp = self.pos.render(P, stp, s, vt, ctx)
        yn, vn, wn, stn = self.neg.render(P, stn, s, vt, ctx)
        # Branches are read raw to the trigger's length; beyond it the
        # trigger's own raw writes remain.
        y = _gate(ctx, s, vt, torch.where(yt >= 0.0, yp, yn), _raw(yt))
        return y, vt, torch.maximum(wt, vt), (stt, stp, stn)

    def advance(self, P, st, s, e, ctx):
        stt, stp, stn = st
        vt, stt = self.trigger.advance(P, stt, s, e, ctx)
        _, stp = self.pos.advance(P, stp, s, e, ctx)
        _, stn = self.neg.advance(P, stn, s, e, ctx)
        return vt, (stt, stp, stn)


class CWrap(Node):
    """Marked / Captured passthrough."""

    def __init__(self, cfg, inner: Node, capture_stem: Optional[str] = None):
        super().__init__(cfg)
        self.inner = inner
        self.capture_stem = capture_stem
        self.reloc = inner.reloc
        self.const_expr = inner.const_expr

    def init(self, P):
        return self.inner.init(P)

    def render(self, P, st, s, e, ctx):
        y, v, w, st = self.inner.render(P, st, s, e, ctx)
        if self.capture_stem is not None and ctx.allow_captures:
            # Captures write only the valid prefix (generator.rs:366-371).
            ctx.captures[self.capture_stem] = (
                _gate(ctx, s, v, y, 0.0), s, v)
        return y, v, w, st

    def advance(self, P, st, s, e, ctx):
        return self.inner.advance(P, st, s, e, ctx)


class CShared(CWrap):
    """A member of a share class (share_plan): an occurrence proven
    identical to, and equally ranged with, the class's other members.
    It holds its own compiled copy (`inner`) and its own state slot, so
    the state tree's layout is the unshared one.  The first member a
    render reaches renders its copy and stores the result in the Ctx;
    every later member returns that result, its state' included, which
    the plan's invariant makes equal to what its own copy would give.
    The class's last member takes the result out of the Ctx, so the
    samples live no longer than the last member that reads them.
    `size` is the node renders a member that returns a stored result
    saves (counted where counting_shared() is active).  Every other
    path (advance, reloc, state reconstruction) goes to the copy.  A
    later member that finds nothing stored (in a settled render, where
    its class's first member folded and it did not) renders its copy."""

    def __init__(self, cfg, inner: Node, cls: int, size: int, last: bool,
                 first: bool):
        super().__init__(cfg, inner)
        self.cls, self.size, self.last, self.first = cls, size, last, first
        self.static_len = inner.static_len
        self.has_capture = inner.has_capture

    def render(self, P, st, s, e, ctx):
        out = ctx.shared.pop(self.cls, None) if self.last \
            else ctx.shared.get(self.cls)
        if out is not None:
            _tally("shared", self.size)
            return out
        out = self.inner.render(P, st, s, e, ctx)
        if not self.first:
            _tally("folded", -self.size)  # the fold saved this much less
        if not self.last:
            ctx.shared[self.cls] = out
        return out


class CFold(CWrap):
    """A subtree the fold plan proved settled (fold_plan): from a local
    sample on, which the plan's `decisions` fix for each voice's
    constants (CompiledVoice.settled_from), it yields one value, and
    `value(P)` computes that value by the ops its lanes would take, on
    one value a row.  In a settled render (Ctx.settled) it returns that
    value, valid to e, and advances its state as its render would: every
    Time position inside by e - s (they all hold the voice's position,
    the plan's edges being the root's range).  Its parent reads the value
    as the lanes it stands for.  Otherwise it renders its subtree.

    `size` is the node renders a settled render saves, `shared` the
    renders the shared members inside would have saved, and `classes`
    the engine node classes inside (counted where counting_folded() and
    counting_shared() are active)."""

    def __init__(self, cfg, inner: Node, value: Callable,
                 decisions: Tuple[Tuple["CAlt", bool], ...]):
        super().__init__(cfg, inner)
        self.value, self.decisions = value, decisions
        self.static_len = inner.static_len
        self.times: List[Tuple[int, ...]] = []  # state paths of Time pos
        self.consts: List[int] = []  # constant indices the proofs read
        self.classes = set()
        self.size = self.shared = 0
        self._survey(inner, (), True)

    def _survey(self, node, path, live):
        """Adds the subtree at `node` (its state at `path`); `live`: the
        unfolded render renders it (no shared member returns it)."""
        if isinstance(node, CShared) and not node.first:
            if live:
                self.shared += node.size
            live = False
        if isinstance(node, CWrap):
            if live and type(node) is CWrap:
                self.size += 1  # a marker renders
            return self._survey(node.inner, path, live)
        self.size += live
        self.classes.add(type(node).__name__)
        if isinstance(node, CConst):
            self.consts.append(node.index)
        elif isinstance(node, CTime):
            self.times.append(path + (0,))
        for i, child in enumerate(_fold_children(node)):
            self._survey(child, path + (i,), live)

    def render(self, P, st, s, e, ctx):
        if not ctx.settled:
            return self.inner.render(P, st, s, e, ctx)
        _tally("shared", self.shared)
        _tally("folded", self.size, self.classes)
        if self.times:
            pos = _path_get(st, self.times[0]) + (e - s).clamp(min=0)
            for path in self.times:
                st = _path_set(st, path, pos)
        return self.value(P), e, e, st


_TALLY = threading.local()


def _tally(name: str, n: int, classes=()) -> None:
    box = getattr(_TALLY, name, None)
    if box is not None:
        box[0] += n
        box[1].update(classes)


@contextlib.contextmanager
def _counting(name: str):
    box = [0, set()]
    prev = getattr(_TALLY, name, None)
    setattr(_TALLY, name, box)
    try:
        yield box
    finally:
        setattr(_TALLY, name, prev)


def counting_shared():
    """Yields a list whose [0] counts, while the block runs, the node
    renders that shared results saved on this thread (each stored result
    a CShared returned counts its `size`, and a settled CFold the shared
    members inside it)."""
    return _counting("shared")


def counting_folded():
    """Yields [renders, classes]: the node renders that settled CFolds
    saved on this thread while the block runs, and the engine node
    classes inside them."""
    return _counting("folded")


def _apply_op(op, a, b):
    if op in (ir.Operator.ADD, ir.Operator.MERGE):
        return a + b
    if op == ir.Operator.SUBTRACT:
        return a - b
    if op == ir.Operator.MULTIPLY:
        return a * b
    if op == ir.Operator.DIVIDE:
        return torch.where(b == 0.0, 0.0, a / torch.where(b == 0.0, 1.0, b))
    if op == ir.Operator.POWER:
        return torch.pow(a, b)
    raise ValueError(op)


def _scalar_trig_value(node, base, P, age, phases):
    """Scalar closed-form evaluation of a PWM composite trigger at one
    lane: `age` is the base Reset's age there, `phases` maps each LFO
    CSine (by id) to its u32 NCO phase at the lane.  The ops the sampled
    trigger render performs per lane (tuun_tpu graph.py:1675-1699)."""
    while isinstance(node, CWrap):
        node = node.inner
    if node is base:
        yi, _ = base.inner_reloc(P, age)
        return yi
    if isinstance(node, CSine) and id(node) in phases:
        return torch.sin(_nco_angle(phases[id(node)])
                         + node.phase.const_expr(P))
    if isinstance(node, CConst):
        return node.const_expr(P)
    if isinstance(node, CBinary):
        return _apply_op(node.op,
                         _scalar_trig_value(node.a, base, P, age, phases),
                         _scalar_trig_value(node.b, base, P, age, phases))
    if isinstance(node, CAlt):
        yt = _scalar_trig_value(node.trigger, base, P, age, phases)
        yp = _scalar_trig_value(node.pos, base, P, age, phases)
        yn = _scalar_trig_value(node.neg, base, P, age, phases)
        return torch.where(yt >= 0.0, yp, yn)
    raise TypeError(f"unexpected PWM trigger node {type(node)}")


def _compile_params(compiler: "Compiler") -> Params:
    """CPU Params of the consts compiled so far (no Fixed payloads), for
    the compile-time trigger verifications: they never touch the card."""
    return Params(torch.from_numpy(
        np.asarray(compiler.const_values, np.float32).reshape(-1)), (),
        torch.zeros((), dtype=I64))


# ---------------------------------------------------------------------------
# The fold plan: subtrees settled from a local sample on
# ---------------------------------------------------------------------------
#
# A subtree of Const, Time, arithmetic and Alt nodes on the edges that
# pass the voice root's range (every Time in it then holds the voice's own
# position) is settled from local sample T when it yields one value at
# every local sample t >= T.  The proof is float32 interval arithmetic
# over the ops exactly as the render performs them: each is monotone in
# each operand and rounds monotonically, so its values over a box of
# operands lie between its values at the box's corners, computed here as
# the render computes them.  An Alt is decided where its trigger's
# interval lies wholly >= 0 or wholly < 0, and then yields its branch.
# Local samples are bounded by _LOCAL_END, so every interval is finite
# unless an op overflows; a bound that is not finite proves nothing.

_LOCAL_END = 2 ** 62  # past every local sample a voice renders
_SETTLE_BY = 2 ** 61  # a fold must settle by this local sample
_FOLD_OPS = (ir.Operator.ADD, ir.Operator.SUBTRACT, ir.Operator.MULTIPLY,
             ir.Operator.DIVIDE, ir.Operator.MERGE)
_F32 = struct.Struct("f")
Interval = Optional[Tuple[float, float]]


def _f32(x: float) -> float:
    """x rounded to float32 (to nearest, ties to even; inf past its
    range).  Each op below takes float32 operands in float64 and rounds
    once: float64 holds more than twice float32's digits, so that is the
    float32 op's own rounding."""
    try:
        return _F32.unpack(_F32.pack(x))[0]
    except OverflowError:
        return math.copysign(math.inf, x)


def _infinite(node: Node) -> bool:
    """Whether `node`'s valid end is always the e it is given (Const,
    Time, Noise, an NCO sine over an infinite phase, arithmetic over two
    infinite operands, an Alt over an infinite trigger, a marker over an
    infinite inner): share_plan's "provably infinite", on compiled
    nodes."""
    while isinstance(node, CWrap):
        node = node.inner
    if isinstance(node, (CConst, CTime, CNoise)):
        return True
    if isinstance(node, CSine):
        return node.nco and _infinite(node.phase)
    if isinstance(node, CBinary):
        return _infinite(node.a) and _infinite(node.b)
    if isinstance(node, CAlt):
        return _infinite(node.trigger)
    return False


def _fold_children(node: Node) -> Tuple[Node, ...]:
    """A foldable node's children, in the order of its state tuple."""
    if isinstance(node, CBinary):
        return (node.a, node.b)
    if isinstance(node, CAlt):
        return (node.trigger, node.pos, node.neg)
    return ()


def _foldable(node: Node) -> bool:
    """Whether every node of the subtree is a Const, a Time, arithmetic
    of _FOLD_OPS, an Alt or a marker: nodes whose valid end is always e,
    whose lanes are 0 past [s, e), and whose advance leaves the state
    their render leaves."""
    while isinstance(node, CWrap):
        if node.capture_stem is not None:
            return False
        node = node.inner
    if isinstance(node, (CConst, CTime)):
        return True
    if isinstance(node, CBinary) and node.op not in _FOLD_OPS:
        return False
    if isinstance(node, (CBinary, CAlt)):
        return all(_foldable(c) for c in _fold_children(node))
    return False


def _interval(node: Node, consts, t0: int, sr: int) -> Interval:
    """[lo, hi] of the float32 values a foldable `node` takes at every
    local sample in [t0, _LOCAL_END], as its render computes them; None
    where not finite or not known."""
    while isinstance(node, CWrap):
        node = node.inner
    out: Interval = None
    if isinstance(node, CConst):
        c = float(consts[node.index])
        out = (c, c)
    elif isinstance(node, CTime):
        # _div(local.to(f32), sr): the int64 -> float32 cast, then the
        # float32 division, both monotone in the local sample.
        sr32 = float(np.float32(sr))
        out = tuple(_f32(float(np.int64(t).astype(np.float32)) / sr32)
                    for t in (t0, _LOCAL_END))
    elif isinstance(node, CBinary):
        a = _interval(node.a, consts, t0, sr)
        b = _interval(node.b, consts, t0, sr)
        if a is None or b is None:
            return None
        op = node.op
        if op in (ir.Operator.ADD, ir.Operator.MERGE):
            out = (_f32(a[0] + b[0]), _f32(a[1] + b[1]))
        elif op == ir.Operator.SUBTRACT:
            out = (_f32(a[0] - b[1]), _f32(a[1] - b[0]))
        elif op == ir.Operator.MULTIPLY or (
                op == ir.Operator.DIVIDE and (b[0] > 0.0 or b[1] < 0.0)):
            corners = [_f32(x * y if op == ir.Operator.MULTIPLY else x / y)
                       for x in a for y in b]
            out = (min(corners), max(corners))
    elif isinstance(node, CAlt):
        t = _interval(node.trigger, consts, t0, sr)
        p = _interval(node.pos, consts, t0, sr)
        n = _interval(node.neg, consts, t0, sr)
        if t is not None and t[0] >= 0.0:
            out = p
        elif t is not None and t[1] < 0.0:
            out = n
        elif p is not None and n is not None:
            out = (min(p[0], n[0]), max(p[1], n[1]))
    if out is None or not (math.isfinite(out[0]) and math.isfinite(out[1])):
        return None
    return out


def _decided(alt: "CAlt", positive: bool, consts, t0: int, sr: int) -> bool:
    """Whether `alt`'s trigger is >= 0 (positive) or < 0 at every local
    sample from t0 on, in every lane."""
    t = _interval(alt.trigger, consts, t0, sr)
    return t is not None and (t[0] >= 0.0 if positive else t[1] < 0.0)


def _settled(node: Node, consts, t0: int, sr: int):
    """(value, decisions) where the foldable `node` yields one value at
    every local sample from t0 on with these constants: `value(P)` the
    ops of its lanes on one value a row, `decisions` each (Alt, its
    trigger >= 0) on the way.  Settled: a Const; arithmetic over two
    settled operands; an Alt whose trigger is decided, over the settled
    branch it picks; a marker over a settled inner.  Else None."""
    while isinstance(node, CWrap):
        node = node.inner
    if isinstance(node, CConst):
        i = node.index
        return (lambda P: P.consts[i]), ()
    if isinstance(node, CBinary):
        a = _settled(node.a, consts, t0, sr)
        b = _settled(node.b, consts, t0, sr)
        if a is None or b is None:
            return None
        op, (fa, da), (fb, db) = node.op, a, b
        return (lambda P: _apply_op(op, fa(P), fb(P))), da + db
    if isinstance(node, CAlt):
        for positive, branch in ((True, node.pos), (False, node.neg)):
            if _decided(node, positive, consts, t0, sr):
                got = _settled(branch, consts, t0, sr)
                if got is None:
                    return None
                return got[0], ((node, positive),) + got[1]
    return None


def settle_sample(fold: "CFold", consts, sr: int) -> Optional[int]:
    """The least local sample from which `fold`'s decisions hold with
    these constants (their proofs are monotone in it: a later start is a
    narrower interval), or None where they do not hold by _SETTLE_BY."""
    def holds(t):
        return all(_decided(alt, positive, consts, t, sr)
                   for alt, positive in fold.decisions)
    if not fold.decisions:
        return 0  # constants alone
    if not holds(_SETTLE_BY):
        return None
    lo, hi = -1, _SETTLE_BY
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if holds(mid):
            hi = mid
        else:
            lo = mid
    return hi


def fold_plan(root: Node, consts, sr: int) -> Tuple[Node, Tuple["CFold",
                                                                ...]]:
    """Wraps in a CFold each largest foldable subtree that settles with
    these constants (the compiled voice's own) and whose parent reads it
    only as lanes, on the edges that pass the voice root's range; returns
    the root (itself a CFold where the whole voice settles) and the
    CFolds in pre-order.

    The edges, as share_plan's: CBinary's a, and b when the op is MERGE
    or a is provably infinite; CAlt's trigger, and pos and neg when the
    trigger is provably infinite; an NCO CSine's phase; a non-NCO
    CSine's frequency, and its phase when the frequency is provably
    infinite; a marker's inner.  A capture, a later member of a share
    class (it renders nothing of its own) and every other edge stop it.
    Every parent above reads a settled operand (one value a row) as the
    lanes it stands for, but a POWER: pow is not exactly rounded, so its
    operands stay lanes, as the render that folds nothing gives them."""
    folds: List[CFold] = []

    def visit(node: Node, reads: bool) -> Node:
        if reads and _foldable(node):
            got = _settled(node, consts, _SETTLE_BY, sr)
            if got is not None:
                folds.append(CFold(node.cfg, node, *got))
                return folds[-1]
        if isinstance(node, CShared) and not node.first:
            return node
        if isinstance(node, CWrap):
            if node.capture_stem is None:
                node.inner = visit(node.inner, reads)
        elif isinstance(node, CBinary):
            reads = node.op != ir.Operator.POWER
            node.a = visit(node.a, reads)
            if node.op == ir.Operator.MERGE or _infinite(node.a):
                node.b = visit(node.b, reads)
        elif isinstance(node, CAlt):
            node.trigger = visit(node.trigger, True)
            if _infinite(node.trigger):
                node.pos = visit(node.pos, True)
                node.neg = visit(node.neg, True)
        elif isinstance(node, CSine):
            if node.nco:
                node.phase = visit(node.phase, True)
            else:
                node.freq = visit(node.freq, True)
                if _infinite(node.freq):
                    node.phase = visit(node.phase, True)
        return node

    root = visit(root, True)
    return root, tuple(folds)


# ---------------------------------------------------------------------------
# Closed-form state for relocatable trees (tuun_tpu graph.py:1710-1882)
# ---------------------------------------------------------------------------
#
# A relocatable voice renders on the fast path without advancing its node
# tree; a later stateful render (a Modify splice) needs the tree's state at
# the current position.  Every such node's interval-path state is a closed
# form of (samples rendered r, samples advanced past adv): positions
# (r + adv), NCO accumulators (r*inc mod 2^32), Append done flags and the
# analytic Reset's sign and age.  The u32 products are Python ints here,
# so nothing overflows.


class FastStateUnsupported(Exception):
    """Raised when a node's state is not closed-form (a stateful subtree,
    exact-precision accumulators); callers fall back to replay."""


def _reloc_len(node: Node, P, lits) -> Optional[int]:
    """The node's literal produced length (None = infinite)."""
    if node.reloc is None:
        raise FastStateUnsupported(type(node).__name__)
    _, L = node.reloc(P, torch.zeros(1, dtype=I64, device=P.device), lits)
    if L is None or isinstance(L, int):
        return L
    raise FastStateUnsupported("length not literal")


def reloc_block(root: Node, P, state, lanes, s, e, lits):
    """The relocatable render contract (tuun_tpu graph.py:1752-1768): the
    root's reloc at the absolute indices pos + lanes - s, its literal
    length clamped at BIG, validity masked to [s, v), the position
    advanced by the whole region."""
    pos, rst = state
    y, L = root.reloc(P, pos + lanes - s, lits)
    if isinstance(L, int):
        L = min(L, BIG)
    v = e if L is None else torch.minimum(torch.maximum(s + L - pos, s), e)
    y = torch.where((lanes >= s) & (lanes < v), y, 0.0)
    return y, v, (pos + (e - s).clamp(min=0), rst)


def _i64(v) -> torch.Tensor:
    return torch.tensor(v, dtype=I64)


def reconstruct_state(node: Node, P, lits, r: int, adv: int = 0):
    """The state tree that interval-rendering [0, r) and then advancing
    [r, r+adv) leaves in a fast-mode relocatable node, as CPU tensors
    (evaluate with host params).  Positions are int64 and never wrap, as
    the port's render does not."""
    if isinstance(node, CWrap):
        return reconstruct_state(node.inner, P, lits, r, adv)
    if isinstance(node, CConst):
        return ()
    if isinstance(node, (CTime, CNoise)):
        return (_i64(r + adv),)
    if isinstance(node, CFixed):
        # CFixed advances by `take`, clipped at the payload length.
        return (_i64(min(r + adv, node.length)),)
    from .timeline import CTimeline
    if isinstance(node, CTimeline):
        return (_i64(r + adv),)
    if isinstance(node, CSine):
        if not node.nco:
            raise FastStateUnsupported("non-NCO sine")
        inc = int(node._nco_inc(P))
        # The NCO render never touches the (const-expr) frequency
        # subtree; the phase subtree renders the full region.
        return (_i64((r * inc) & M32), node.freq.init(P),
                reconstruct_state(node.phase, P, lits, r, adv))
    if isinstance(node, CBinary):
        la = _reloc_len(node.a, P, lits)
        if node.op == ir.Operator.MERGE or la is None:
            rb = r
        else:
            rb = min(r, la)  # b renders only to a's valid end
        return (reconstruct_state(node.a, P, lits, r, adv),
                reconstruct_state(node.b, P, lits, rb, adv))
    if isinstance(node, CAppend):
        la = _reloc_len(node.a, P, lits)
        if la is None:
            return (torch.tensor(False),
                    reconstruct_state(node.a, P, lits, r, adv),
                    node.b.init(P))
        ra = min(r, la)
        adv_a = max(min(r + adv, la) - ra, 0)
        rb = max(r - la, 0)
        adv_b = max(adv - max(la - r, 0), 0)
        return (torch.tensor(r + adv > la),
                reconstruct_state(node.a, P, lits, ra, adv_a),
                reconstruct_state(node.b, P, lits, rb, adv_b))
    if isinstance(node, CFin):
        if node.fin_slot is None:
            raise FastStateUnsupported("value-path Fin")
        c = lits[node.fin_slot]
        rc = min(r, c)
        return (_i64(r + adv),
                reconstruct_state(node.length, P, lits, 0, r + adv),
                reconstruct_state(node.inner, P, lits, rc, (r - rc) + adv))
    if isinstance(node, CAlt):
        lt = _reloc_len(node.trigger, P, lits)
        rb = r if lt is None else min(r, lt)
        # Branches render only to the trigger's valid end and are never
        # advanced past it by CAlt.render: the plain advance region.
        return (reconstruct_state(node.trigger, P, lits, r, adv),
                reconstruct_state(node.pos, P, lits, rb, adv),
                reconstruct_state(node.neg, P, lits, rb, adv))
    if isinstance(node, CReset):
        if not node.analytic or node.inner_reloc is None:
            raise FastStateUnsupported("non-analytic reset")
        inc = int(node._inc(P))
        if r > 0:
            ph_last = ((r - 1) * inc) & M32
            age = (ph_last // inc if inc else r - 1) + 1
            if node._trig is None:
                positive = ph_last < 2 ** 31
            elif node._trig[2] is not None:
                positive = age - 1 < node._trig[2]
            else:
                # PWM trigger: its closed-form value at lane r-1, where
                # each LFO's phase is (r-1)*inc.
                phases = {id(sn): _i64(((r - 1) * int(sn._nco_inc(P)))
                                       & M32)
                          for sn, _ in node._trig[3]}
                positive = float(_scalar_trig_value(
                    node._trig[5], node._trig[4], P, _i64(max(age - 1, 0)),
                    phases)) >= 0.0
            sign = 1.0 if positive else -1.0
        else:
            sign, age = -1.0, 0
        # The analytic render leaves the trigger's state untouched apart
        # from the base NCO accumulator and, for PWM, the LFOs'.
        strg = node._acc_set(node.trigger.init(P), _i64((r * inc) & M32))
        if node._trig is not None and node._trig[2] is None:
            for sn, pth in node._trig[3]:
                strg = _path_set(strg, pth,
                                 _i64((r * int(sn._nco_inc(P))) & M32))
        return (torch.tensor(sign, dtype=f32), _i64(age), strg,
                node.inner.init(P))
    raise FastStateUnsupported(type(node).__name__)


# ---------------------------------------------------------------------------
# The compiler
# ---------------------------------------------------------------------------


class Compiler:
    def __init__(self, cfg: EngineConfig, plan: "SharePlan" = ()):
        self.cfg = cfg
        # uid -> (share class, size, last member, first member) of each
        # occurrence that compiles to a CShared (share_plan): members
        # render in uid order.
        first, last = {}, {}
        for uid, cls, _ in plan:
            first.setdefault(cls, uid)
            last[cls] = uid
        self.share = {uid: (cls, size, last[cls] == uid, first[cls] == uid)
                      for uid, cls, size in plan}
        self.const_values: List[np.float32] = []
        self.fixed_values: List[np.ndarray] = []
        self.uid = 0
        self.captures: List[str] = []
        # CFin nodes with symbolic cutoffs, in slot order: their cutoffs
        # are computed on the host once per params (CompiledVoice.lits_for)
        # and passed as the literal `lits`.
        self.fins: List[CFin] = []
        # Set when a Merge subtree compiled to timeline form.
        self.has_timeline = False

    def _const_index(self, value: float) -> int:
        self.const_values.append(np.float32(value))
        return len(self.const_values) - 1

    def compile(self, w: ir.Waveform) -> Node:
        share = self.share.get(self.uid)
        node = self._compile(w)
        node.has_capture = any(isinstance(n, ir.Captured) for n in w.walk())
        if share is not None:
            node = CShared(self.cfg, node, *share)
        return node

    def _compile(self, w: ir.Waveform) -> Node:
        cfg = self.cfg
        uid = self.uid  # pre-order numbering, matching oracle.initialize
        self.uid += 1
        if isinstance(w, ir.Const):
            return CConst(cfg, self._const_index(w.value))
        if isinstance(w, ir.Time):
            return CTime(cfg)
        if isinstance(w, ir.Noise):
            return CNoise(cfg, uid)
        if isinstance(w, ir.Fixed):
            self.fixed_values.append(np.asarray(w.samples, np.float32))
            node = CFixed(cfg, len(self.fixed_values) - 1, len(w.samples))
            node.static_len = lambda P, L=len(w.samples): torch.full(
                (), L, dtype=I64, device=P.device)
            return node
        if isinstance(w, ir.Fin):
            length = self.compile(w.length)
            inner = self.compile(w.waveform)
            ge0 = self._ge0_static(w.length, length)
            node = CFin(cfg, length, inner, ge0)
            if node.reloc is not None:
                node.fin_slot = len(self.fins)
                self.fins.append(node)
            return node
        if isinstance(w, ir.Append):
            return CAppend(cfg, self.compile(w.a), self.compile(w.b))
        if isinstance(w, ir.Sine):
            return CSine(cfg, self.compile(w.frequency),
                         self.compile(w.phase))
        if isinstance(w, ir.Filter):
            inner = self.compile(w.waveform)
            ffs = [self.compile(c) for c in w.feed_forward]
            fbs = [self.compile(c) for c in w.feedback]
            ff_consts = [n.const_expr if isinstance(c, ir.Const) else None
                         for n, c in zip(ffs, w.feed_forward)]
            fb_consts = [n.const_expr if isinstance(c, ir.Const) else None
                         for n, c in zip(fbs, w.feedback)]
            return CFilter(cfg, inner, ffs, fbs, ff_consts, fb_consts)
        if isinstance(w, ir.BinaryPointOp):
            if w.op == ir.Operator.MERGE:
                # Large Merge/Append trees (sequences, chords, scores)
                # compile to timeline form: O(active structure) per block
                # instead of O(segments).
                from .timeline import try_compile_timeline
                node = try_compile_timeline(self, w)
                if node is not None:
                    return node
            return CBinary(cfg, w.op, self.compile(w.a), self.compile(w.b))
        if isinstance(w, ir.Reset):
            trigger = self.compile(w.trigger)
            inner = self.compile(w.waveform)
            return CReset(cfg, trigger, inner, self)
        if isinstance(w, ir.Alt):
            return CAlt(cfg, self.compile(w.trigger),
                        self.compile(w.positive), self.compile(w.negative))
        if isinstance(w, ir.Marked):
            return CWrap(cfg, self.compile(w.waveform))
        if isinstance(w, ir.Captured):
            self.captures.append(w.file_stem)
            return CWrap(cfg, self.compile(w.waveform),
                         capture_stem=w.file_stem)
        raise TypeError(f"unknown waveform {type(w)}")

    # -- symbolic length analysis (mirrors greater_or_equals_at) ----------

    def _ge0_static(self, w: ir.Waveform, node: Node) -> Optional[Callable]:
        """Builds fn(P, lpos, maxn) -> relative cutoff (clamped to maxn; BIG
        when the length waveform never reaches zero), or None when only
        the render-the-length value path applies (generator.rs:787-862).
        Const thresholds read through Params, so slider substitutions keep
        symbolic lengths correct without recompiling."""
        plan = self._ge0_plan(w, node)
        if plan is None:
            return None

        def fn(P, lpos, maxn):
            zero = torch.zeros((), dtype=f32, device=P.device)
            return _tmin(plan(P, lpos, zero), maxn)
        return fn

    def _ge0_plan(self, w: ir.Waveform, node: Node) -> Optional[Callable]:
        """fn(P, lpos, value) -> rel (int64; BIG = never), or None."""
        sr = self.cfg.sample_rate

        if node.const_expr is not None:
            cx = node.const_expr

            def const_plan(P, lpos, value):
                return torch.where(cx(P) >= value, 0, BIG)
            return const_plan

        if isinstance(w, ir.Time):
            def time_plan(P, lpos, value):
                current = _div(lpos.to(f32), float(sr))
                target = _ceil_target(value, sr)
                return torch.where(current >= value, 0,
                                   (target - lpos).clamp(min=0))
            return time_plan

        if isinstance(w, ir.BinaryPointOp) and w.op in (
                ir.Operator.ADD, ir.Operator.SUBTRACT):
            # Only structurally-literal Const operands shift the threshold
            # (a Marked const forces the value path, generator.rs:840-855).
            ca = node.a.const_expr if isinstance(w.a, ir.Const) else None
            cb = node.b.const_expr if isinstance(w.b, ir.Const) else None
            if w.op == ir.Operator.ADD:
                if ca is not None:
                    sub = self._ge0_plan(w.b, node.b)
                    if sub is None:
                        return None
                    return lambda P, lpos, value: sub(P, lpos, value - ca(P))
                if cb is not None:
                    sub = self._ge0_plan(w.a, node.a)
                    if sub is None:
                        return None
                    return lambda P, lpos, value: sub(P, lpos, value - cb(P))
            elif cb is not None:
                sub = self._ge0_plan(w.a, node.a)
                if sub is None:
                    return None
                return lambda P, lpos, value: sub(P, lpos, value + cb(P))
        return None


# ---------------------------------------------------------------------------
# Top-level voice API
# ---------------------------------------------------------------------------


class CompiledVoice:
    """A waveform compiled for block rendering on cfg.device.

    Const values travel in Params, so same-structure waveforms (slider
    moves, per-voice frequencies) share one compiled voice when they
    also share its sharing plan (`plan`: share_plan(w, cfg) by default;
    () renders every occurrence, for states not proven equal across
    a class, as a modify's splice leaves them).

    Its fold plan (fold_plan, `folds`) is read from `w`'s own constants;
    each voice's constants say from which local sample it holds for that
    voice (settled_from), and from there on a render may be asked for in
    its settled form (render_fn's and batched_render_fn's `settled`):
    the same bits, the folds' values one a row."""

    def __init__(self, w: ir.Waveform, cfg: EngineConfig,
                 plan: Optional[SharePlan] = None):
        check_device(cfg.device)
        self.cfg = cfg
        self.waveform = w
        self.plan = share_plan(w, cfg) if plan is None else plan
        # Node renders a root render saves by returning stored results:
        # every member but the first of each class.
        firsts = {cls for _, cls, _ in self.plan}
        self.shared_renders = 0
        for _, cls, size in self.plan:
            if cls in firsts:
                firsts.discard(cls)
            else:
                self.shared_renders += size
        compiler = Compiler(cfg, self.plan)
        self.root, self.folds = fold_plan(compiler.compile(w),
                                          compiler.const_values,
                                          cfg.sample_rate)
        # Node renders a settled root render saves beyond the shared ones.
        self.folded_renders = sum(f.size for f in self.folds)
        self._settle_memo: Dict[Tuple, Optional[int]] = {}
        self.capture_stems = compiler.captures
        # A relocatable root is a pure function of the absolute sample
        # index: its length composes symbolically (symbolic_len), its
        # state has a closed form (state_at), and it may render through
        # reloc_block.
        self.relocatable = (self.root.reloc is not None
                            and not compiler.captures)
        # New voices render through reloc_block only when the config opts
        # in (EngineConfig.reloc_fast).
        self.fast_default = self.relocatable and cfg.reloc_fast
        self._base_consts = np.asarray(compiler.const_values, np.float32) \
            if compiler.const_values else np.zeros((0,), np.float32)
        self._base_fixeds = tuple(compiler.fixed_values)
        self._fins = compiler.fins
        self._has_timeline = compiler.has_timeline
        self._lits_cache: Dict[int, Tuple[int, ...]] = {}
        self._symlen_cache: Dict[Tuple, Optional[int]] = {}
        self._arg_cache: Dict[Tuple, Tuple] = {}

    def lits_for(self, P) -> Tuple[int, ...]:
        """The literal Fin cutoffs for this parameter set, one per
        Compiler.fins slot (() when the structure has none, or is neither
        relocatable nor timeline-bearing).  Evaluated once per P on CPU
        tensors from P's host mirror: no device round trip."""
        if not self._fins or not (self.relocatable or self._has_timeline):
            return ()
        key = id(P)
        lits = self._lits_cache.get(key)
        if lits is None:
            hp = _host_params(P)
            zero = torch.zeros((), dtype=I64)
            lits = tuple(int(f.ge0(hp, zero, BIG)) for f in self._fins)
            # id(P) is only P's while P lives: evict with it.
            weakref.finalize(P, self._lits_cache.pop, key, None)
            self._lits_cache[key] = lits
        return lits

    def symbolic_len(self, P, lits: Optional[Tuple[int, ...]] = None
                     ) -> Optional[int]:
        """Total producible length of a relocatable voice, or None when
        infinite or not relocatable (callers fall back to the oracle's
        length(), generator.rs:620-782).  Evaluates a 1-lane reloc on CPU
        tensors from P's host mirror, memoized per lits (lengths compose
        from lits and structure), so it runs at every note-on cheaply."""
        if not self.relocatable:
            return None
        if lits is None:
            lits = self.lits_for(P)
        cached = self._symlen_cache.get(lits, False)
        if cached is not False:
            return cached
        _, L = self.root.reloc(_host_params(P), torch.zeros(1, dtype=I64),
                               lits)
        out = None if L is None or int(L) >= BIG else int(L)
        self._symlen_cache[lits] = out
        return out

    def settled_from(self, P) -> Optional[int]:
        """The local sample from which every fold of the plan holds for
        P's constants (its host mirror), found by bisection over the local
        sample and memoized by the constants each fold reads; None where
        one never does, or the plan has no fold."""
        if not self.folds:
            return None
        consts = _host_params(P).consts.numpy()
        if len(self._settle_memo) > 4096:
            self._settle_memo.clear()
        out = 0
        for i, fold in enumerate(self.folds):
            if not fold.decisions:
                continue  # constants alone: settled from 0
            key = (i, consts[fold.consts].tobytes())
            t = self._settle_memo.get(key, -1)
            if t == -1:
                t = self._settle_memo[key] = settle_sample(
                    fold, consts, self.cfg.sample_rate)
            if t is None:
                return None
            out = max(out, t)
        return out

    # -- params ---------------------------------------------------------

    def params(self, seed: int = 0) -> Params:
        return params_from_numpy(self._base_consts, self._base_fixeds, seed,
                                  self.cfg.device)

    def params_for(self, w2: ir.Waveform, seed: int = 0) -> Params:
        """Params extracted from a same-structure waveform (e.g. after a
        slider substitution)."""
        c2 = Compiler(self.cfg)
        c2.compile(w2)
        return params_from_numpy(c2.const_values, c2.fixed_values, seed,
                                 self.cfg.device)

    # -- state ----------------------------------------------------------

    def init(self, P: Params):
        # Voice state = (stream position, per-node state tree).  The
        # fast path renders from the position alone and leaves the tree.
        return (_zero_i(P), self.root.init(P))

    def state_at(self, P, pos: int, n: int = 8192):
        """The per-node state tree at stream position `pos` (for a voice
        that rendered on the fast path, whose tree never advanced).

        Relocatable fast-mode trees reconstruct in closed form on CPU
        tensors from P's host mirror, then move to P's device (O(tree),
        no replay).  Anything else replays from init in n-lane blocks:
        the JAX engine's semantics, not a device fallback."""
        if self.relocatable and self.cfg.precision == "fast":
            try:
                st = reconstruct_state(self.root, _host_params(P),
                                       self.lits_for(P), pos)
                return tree_to(st, P.device)
            except FastStateUnsupported:
                pass
        # Full renders, output discarded: advance() leaves phase and
        # sample state untouched (it mirrors the reference's length()
        # lookahead), so reconstruction replays real render steps.
        ctx = Ctx(n, P.device, allow_captures=False,
                  lits=self.lits_for(P) if self._has_timeline else None)
        st = self.root.init(P)
        done = 0
        while done < pos:
            k = min(n, pos - done)
            e = ctx.end if k == n else torch.full((), k, dtype=I64,
                                                  device=P.device)
            ctx.shared.clear()  # one root render per memo
            _, _, _, st = self.root.render(P, st, ctx.zero, e, ctx)
            done += k
        return st

    # -- rendering ------------------------------------------------------

    def _render_impl(self, n, fast, lits, settled, P, state, s, e):
        ctx = Ctx(n, P.device, lits=lits, settled=settled)
        if fast:
            # A pure function of the absolute sample index: no state
            # threading, no per-node interval bookkeeping, and the valid
            # end is scalar arithmetic on a literal length.
            y, v, state = reloc_block(self.root, P, state, ctx.idx, s, e,
                                      lits)
            return y, v, state, ctx.captures
        pos, rst = state
        y, v, w, rst = self.root.render(P, rst, s, e, ctx)
        # Consumers (the tracker mix, WAV writers) see only valid samples;
        # written-but-invalid overruns are an internal buffer matter.
        y = _gate(ctx, s, v, y, 0.0)
        return y, v, (pos + (e - s).clamp(min=0), rst), ctx.captures

    def _resolve_fast(self, fast, P, lits):
        """(fast, lits) normalization: the fast path needs the literal
        cutoffs; compute them from P when the caller gave none.

        Timeline-bearing structures want lits on the stateful path too
        (their schedules): computed only on `fast=None` default calls, so
        an explicit `lits=None` keeps a lits-free render."""
        auto = fast is None
        if fast is None:
            fast = self.fast_default
        fast = bool(fast) and self.relocatable
        if not fast:
            if self._has_timeline and auto and lits is None \
                    and P is not None:
                lits = self.lits_for(P)
            elif not self._has_timeline:
                lits = None
            return False, lits
        if lits is None and P is not None:
            lits = self.lits_for(P)
        return True, lits

    def render_fn(self, n: int, fast: Optional[bool] = None,
                  lits: Optional[Tuple[int, ...]] = None,
                  P=None, settled: bool = False) -> Callable:
        """fn(P, state, s, e) -> (y[n], valid_end, state', captures) with
        s and e int64 scalars on P's device.  fast=None takes the
        config's default path; a voice that is no longer a pure function
        of the absolute index passes fast=False.  settled=True: the
        settled form, for a voice at or past settled_from(P) at s."""
        fast, lits = self._resolve_fast(fast, P, lits)
        return partial(self._render_impl, n, fast, lits, settled)

    def note_fn(self, sizes: Tuple[int, ...], n: Optional[int] = None,
                fast: Optional[bool] = None,
                lits: Optional[Tuple[int, ...]] = None, P=None,
                passes: int = 1) -> Callable:
        """fn(P) -> (last_y, last_v, state): renders a whole finite piece
        from a fresh state, block by block in the given sizes (the JAX
        engine traces the same loop into one executable).  With
        passes > 1, that many independent passes run, y is the sum of
        their last blocks, and v and the state come from the last."""
        sizes = tuple(int(m) for m in sizes)
        if n is None:
            n = 1 << (max(sizes) - 1).bit_length()
        fast, lits = self._resolve_fast(fast, P, lits)

        def impl(P):
            dev = P.device
            s = torch.zeros((), dtype=I64, device=dev)
            ends = {m: torch.full((), m, dtype=I64, device=dev)
                    for m in set(sizes)}
            acc = None
            for _ in range(passes):
                st = self.init(P)
                for m in sizes:
                    y, v, st, _ = self._render_impl(n, fast, lits, False,
                                                    P, st, s, ends[m])
                acc = y if acc is None else acc + y
            return (acc if passes > 1 else y), v, st
        return impl

    def batched_init(self, bP: Params):
        """init under torch.func.vmap over a stacked Params (stack_params):
        a group's fresh state, [B, ...] on every leaf."""
        def one(consts, fixeds, seed):
            return self.init(Params(consts, fixeds, seed, host=bP.host))
        return torch.func.vmap(one)(bP.consts, bP.fixeds, bP.seed)

    def batched_render_fn(self, n: int, fast: Optional[bool] = None,
                          lits: Optional[Tuple[int, ...]] = None,
                          mix: bool = True, settled: bool = False
                          ) -> Callable:
        """fn(bP, bstate, starts, e) -> (mix[n], v[B], bstate', caps): one
        render of a whole voice group (tuun_tpu graph.py:2446-2470).
        _render_impl runs under torch.func.vmap over (params, state,
        start) with e shared, and the mix sums on the device (mix=False:
        the voices' samples [B, n] instead).  The scans take their voices
        x lanes kernels, one launch per call site for the whole group.
        The voices must share `lits` (the tracker groups by them); on the
        fast path without them, each voice evaluates its own Fin cutoffs
        on the device, as render_fn does without P.  settled=True: the
        settled form, for voices each at or past its settled_from."""
        fast, lits = self._resolve_fast(fast, None, lits)
        render = partial(self._render_impl, n, fast, lits, settled)

        def one(consts, fixeds, seed, state, s, e, host=None):
            return render(Params(consts, fixeds, seed, host=host), state, s, e)

        vmapped = torch.func.vmap(one, in_dims=(0, 0, 0, 0, 0, None))

        def batched(bP, bstate, starts, e):
            y, v, st, caps = vmapped(bP.consts, bP.fixeds, bP.seed, bstate,
                                     starts, e, host=bP.host)
            return (y.sum(0) if mix else y), v, st, caps
        return batched

    def render_block(self, P, state, n: int, s=0, e=None,
                     fast: Optional[bool] = None,
                     lits: Optional[Tuple[int, ...]] = None):
        if e is None:
            e = n
        dev = P.device
        if not isinstance(s, torch.Tensor) and not isinstance(e, torch.Tensor):
            # Device scalars for the common calls, made once.
            key = (int(s), int(e), dev)
            cached = self._arg_cache.get(key)
            if cached is None:
                cached = tuple(torch.full((), x, dtype=I64, device=dev)
                               for x in key[:2])
                if len(self._arg_cache) < 64:
                    self._arg_cache[key] = cached
            s, e = cached
        else:
            if not isinstance(s, torch.Tensor):
                s = torch.full((), int(s), dtype=I64, device=dev)
            if not isinstance(e, torch.Tensor):
                e = torch.full((), int(e), dtype=I64, device=dev)
        return self.render_fn(n, fast, lits, P)(P, state, s, e)


def compile_voice(w: ir.Waveform, cfg: EngineConfig) -> CompiledVoice:
    return CompiledVoice(w, cfg)


def _trigger_key(t: ir.Waveform, sample_rate: Optional[int]) -> Tuple:
    """Fingerprint of the compile-time decisions a Reset trigger bakes
    (tuun_tpu graph.py:2477-2496, kept so that both engines share one
    structure key)."""
    if isinstance(t, ir.Sine) and isinstance(t.frequency, ir.Const) \
            and isinstance(t.phase, ir.Const):
        fv = float(t.frequency.value)
        pv = float(t.phase.value)
        if sample_rate:
            fc = fv / (sample_rate * TAU)
            return ("T0", pv == 0.0, bool(2.0 ** -20 < fc < 0.5))
        return ("T0?", pv == 0.0, fv)
    return structure_key(t, sample_rate, in_trigger=True)


def structure_key(w: ir.Waveform, sample_rate: Optional[int] = None,
                  in_trigger: bool = False) -> Tuple:
    """A hashable key identifying the compiled structure of a waveform:
    node types, operators, Fixed lengths, filter aritys -- everything
    except Const values and Fixed payloads, and, inside Reset triggers,
    the decisions the JAX engine's analytic tiers bake on const values."""
    if isinstance(w, ir.Const):
        return ("C", float(w.value)) if in_trigger else ("C",)
    if isinstance(w, ir.Fixed):
        return ("X", len(w.samples))
    if isinstance(w, ir.BinaryPointOp):
        return ("B", w.op.value) + tuple(
            structure_key(c, sample_rate, in_trigger) for c in w.children())
    if isinstance(w, ir.Filter):
        return ("F", len(w.feed_forward), len(w.feedback)) + tuple(
            structure_key(c, sample_rate, in_trigger) for c in w.children())
    if isinstance(w, ir.Marked):
        return ("M", str(w.id),
                structure_key(w.waveform, sample_rate, in_trigger))
    if isinstance(w, ir.Captured):
        return ("K", w.file_stem,
                structure_key(w.waveform, sample_rate, in_trigger))
    if isinstance(w, ir.Reset):
        tk = (structure_key(w.trigger, sample_rate, True) if in_trigger
              else _trigger_key(w.trigger, sample_rate))
        return ("Reset", tk,
                structure_key(w.waveform, sample_rate, in_trigger))
    return (type(w).__name__,) + tuple(
        structure_key(c, sample_rate, in_trigger) for c in w.children())


# (uid, share class, size) of each CShared occurrence, in uid order.
SharePlan = Tuple[Tuple[int, int, int], ...]


def _timeline_candidate(w: ir.Waveform, cfg: EngineConfig) -> bool:
    """Whether Compiler._compile hands this Merge to the timeline pass."""
    if not (cfg.timeline and isinstance(w, ir.BinaryPointOp)
            and w.op == ir.Operator.MERGE):
        return False
    from .timeline import MIN_LEAVES, _flatten
    leaves: List[ir.Waveform] = []
    _flatten(w, leaves)
    return len(leaves) >= MIN_LEAVES


def _const_ir(w: ir.Waveform, cfg: EngineConfig) -> bool:
    """Whether `w` compiles to a node with a const_expr."""
    if isinstance(w, ir.Const):
        return True
    if isinstance(w, (ir.Marked, ir.Captured)):
        return _const_ir(w.waveform, cfg)
    if isinstance(w, ir.BinaryPointOp):
        return not _timeline_candidate(w, cfg) and _const_ir(w.a, cfg) \
            and _const_ir(w.b, cfg)
    return False


def share_plan(w: ir.Waveform, cfg: EngineConfig) -> SharePlan:
    """The occurrences of `w` that compile to a CShared: (uid, class,
    size) each, uid the compiler's pre-order number, class the index of
    its share class in order of first member, size the node renders of
    its subtree (its nodes but an NCO sine's frequency, which never
    renders).  Two occurrences share a class when both hold:

      * Identical.  The same node types and operators over identical
        children, with the same constants (their float32 bits), Fixed
        payloads and NCO choice.  A Noise's key holds its uid, so no two
        noises share.  A subtree that holds a capture (its render writes
        the Ctx) or a timeline (a Merge tree the timeline pass takes) is
        in no class.
      * Equally ranged.  Each receives, in every render and advance, the
        voice root's (s, e).  The edges that pass the root's range on:
        CBinary's a; its b when the op is MERGE or a is provably
        infinite; CAlt's trigger, and its pos and neg when the trigger
        is provably infinite; an NCO CSine's phase (its frequency never
        renders); a non-NCO CSine's frequency, and its phase when the
        frequency is provably infinite; CWrap's inner.  Every other edge
        stops it: CAppend's b (and a, which ends), CFin, CReset,
        CFilter, a timeline.  Provably infinite: a node whose valid end
        is always the e it was given: Const, Time, Noise, an NCO CSine
        over an infinite phase, a CBinary over two infinite operands, a
        CAlt over an infinite trigger, a CWrap over an infinite inner.
        A node class that is in neither list is a stop and finite.

    From equal inits, equal ranges and equal constants, the members of a
    class hold equal states and render the same (y, v, w, state') at
    every block, by induction.  Along these edges a render reaches the
    members in pre-order, once each; a class is kept when a member
    follows another, and an occurrence inside a member that returns a
    stored result is never rendered, so it is left out."""
    fast = cfg.precision == "fast"
    keys: Dict[Tuple, int] = {}
    # [uid, key id (None: in no class), size, uid past its subtree] of
    # each equally ranged occurrence, in pre-order.
    ranged: List[list] = []
    counter = [0]

    def visit(node, flag):
        """-> (key id, size, provably infinite, shareable)."""
        me = counter[0]
        counter[0] += 1
        entry = [me, None, 0, 0]
        if flag:
            ranged.append(entry)
        ok = True
        if isinstance(node, ir.Const):
            key = ("C", np.float32(node.value).tobytes())
            size, inf = 1, True
        elif isinstance(node, ir.Time):
            key, size, inf = ("T",), 1, True
        elif isinstance(node, ir.Noise):
            key, size, inf = ("N", me), 1, True
        elif isinstance(node, ir.Fixed):
            key = ("X", np.asarray(node.samples, np.float32).tobytes())
            size, inf = 1, False
        elif _timeline_candidate(node, cfg):
            counter[0] = me + sum(1 for _ in node.walk())
            key, size, inf, ok = ("#", me), 0, False, False
        elif isinstance(node, ir.BinaryPointOp):
            a = visit(node.a, flag)
            b = visit(node.b, flag and (node.op == ir.Operator.MERGE
                                        or a[2]))
            key = ("B", node.op.value, a[0], b[0])
            size, inf, ok = 1 + a[1] + b[1], a[2] and b[2], a[3] and b[3]
        elif isinstance(node, ir.Sine):
            nco = fast and _const_ir(node.frequency, cfg)
            f = visit(node.frequency, flag and not nco)
            p = visit(node.phase, flag and (nco or f[2]))
            key = ("S", nco, f[0], p[0])
            size = 1 + p[1] + (0 if nco else f[1])
            inf, ok = nco and p[2], f[3] and p[3]
        elif isinstance(node, ir.Alt):
            t = visit(node.trigger, flag)
            pos = visit(node.positive, flag and t[2])
            neg = visit(node.negative, flag and t[2])
            key = ("Alt", t[0], pos[0], neg[0])
            size, inf = 1 + t[1] + pos[1] + neg[1], t[2]
            ok = t[3] and pos[3] and neg[3]
        elif isinstance(node, (ir.Marked, ir.Captured)):
            i = visit(node.waveform, flag)
            captured = isinstance(node, ir.Captured)
            key = ("#", me) if captured else ("M", str(node.id), i[0])
            size, inf, ok = 1 + i[1], i[2], i[3] and not captured
        else:  # Fin, Append, Filter, Reset: every edge stops the range
            kids = [visit(c, False) for c in node.children()]
            shape = (len(node.feed_forward), len(node.feedback)) \
                if isinstance(node, ir.Filter) else ()
            key = (type(node).__name__,) + shape + tuple(k[0] for k in kids)
            size, inf = 1 + sum(k[1] for k in kids), False
            ok = all(k[3] for k in kids)
        kid = keys.setdefault(key, len(keys))
        if ok:
            entry[1:] = [kid, size, counter[0]]
        return kid, size, inf, ok

    visit(w, True)
    first: Dict[int, Tuple[int, int]] = {}  # key id -> (uid, size)
    hits: List[Tuple[int, int, int]] = []
    past = -1
    for me, kid, size, end in ranged:
        if kid is None or me < past:
            continue
        if kid in first:
            hits.append((me, kid, size))
            past = end
        else:
            first[kid] = (me, size)
    classes: Dict[int, int] = {}
    for kid in sorted({kid for _, kid, _ in hits}, key=lambda k: first[k]):
        classes[kid] = len(classes)
    members = [(first[kid][0], kid, first[kid][1]) for kid in classes]
    return tuple(sorted((me, classes[kid], size)
                        for me, kid, size in members + hits))


def render(w: ir.Waveform, n: int, sample_rate: int, *,
           precision: str = "exact", seed: int = 0,
           block: Optional[int] = None, device="cuda") -> np.ndarray:
    """Renders up to n samples, driving the block renderer to completion.
    Returns the valid prefix as float32 numpy."""
    cfg = EngineConfig(sample_rate, precision, device)
    voice = CompiledVoice(w, cfg)
    P = voice.params(seed)
    state = voice.init(P)
    if block is None:
        block = max(64, min(n, 1 << 16))
    out = []
    total = 0
    while total < n:
        m = min(block, n - total)
        y, v, state, _ = voice.render_block(P, state, block, 0, m)
        v = int(v)
        out.append(y[:v].cpu().numpy())
        total += v
        if v < m:
            break
    if not out:
        return np.zeros((0,), np.float32)
    return np.concatenate(out)[:n]

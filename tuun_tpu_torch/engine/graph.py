"""Compiles Waveform IR into PyTorch block-render programs.

Port of tuun_tpu/engine/graph.py (the reference engine, which stays as it
is).  Each waveform compiles into a tree of nodes with

    render(P, state, s, e, ctx) -> (samples[N], valid_end, written_end, state')

over blocks of N lanes; `[s, e)` is the active interval, `written_end`
how far the node wrote (consumers read written-but-invalid samples, as
the reference's shared buffers do).  The semantics, state layouts and op
orders are the JAX engine's; see its module docstring and
tuun_tpu/oracle.py for the per-sample ground truth.  The port covers the
stateful interval path: leaves, arithmetic, Append, Fin, NCO and FM
sines, filters, Reset (generic tiers), Alt and captures.

Decisions where the JAX engine's form was a fact of XLA or the TPU:

  * uint32 arithmetic.  torch's CPU build has no uint32 `+` or `>>`, so
    the NCO phase rides in int64 masked to 32 bits after every op.  Its
    products stay far below 2^63 (lane offset < 2^24 times inc < 2^32).
    Noise does the same (noisegen.py).
  * Interval ends s, e, v, w are 0-dim int64 tensors on the voice's
    device, as the eager JAX path keeps them traced: no node reads one on
    the host or branches on it, so a block render never waits for the
    device.  The JAX engine's lax.cond gating of empty regions is an
    XLA-only optimisation (its eager path skips it too) and is dropped.
    Positions, ages and cursors are int64 (the JAX int32 ones wrap after
    2^31 samples; these do not).
  * Literal Fin thresholds (`lits`) exist because traced thresholds
    de-vectorize Mosaic fusions; they belong to the reloc fast path,
    which waits (ROADMAP.md).  Reloc lengths here are Python ints, int64
    tensors or None, and every length mask compares integers.
  * f32 lane indices (`fidx`) existed because int32 reductions are slow
    on the TPU.  Reductions here use int64 lane indices; `fidx` remains
    only as the input of the float32 running-max kernel, exact below
    2^24 lanes, so Ctx refuses larger blocks (MAX_BLOCK).
  * The masked-sum gather of `_value_at` becomes torch.take at a clamped
    index; dynamic_slice + roll windows (Fixed playback, the filter's
    delay line) become gathers at clamped indices.
  * The BIGF sentinel (2e9) stays only as NO_EDGE, the running-max value
    of lanes without a reset edge: exact in f32 and below every lane.
  * Division by a constant divides by a 0-dim tensor on the operand's
    device (`_div`): on CUDA torch divides by a host scalar as a multiply
    by its reciprocal, which rounds differently from JAX and the oracle.
  * jnp.mod is a floor mod: torch.remainder, the same sign rule.
  * Reset compiles to the generic sampled-sign tiers only: the analytic
    tiers rest on sign(sin(angle)) matching the NCO phase's top bit,
    which chip_smoke.py reports for CUDA's sin at all 2^24 grid angles;
    porting those tiers waits (ROADMAP.md).  The JAX suite pins both
    tiers as bit-identical, so no sample changes.
  * Exact-mode IIR feedback is a Python loop over lanes (a lax.scan in
    JAX): fine for tests on the CPU, slow on the card.  Fast mode runs the
    affine-scan kernel (scan_ops.py).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import ir
from ..noisegen import noise_torch
from . import scan_ops

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
    # "fast": the production mode -- u32 NCO, f32 FM prefix sum, the
    #         affine-scan IIR.
    precision: str = "exact"
    # Where every tensor of a render lives; the scan kernels run exactly
    # when this is a CUDA device.  The card unless the caller asks for the
    # CPU: a voice compiled for a missing card raises (check_device).
    device: Any = "cuda"

    def __post_init__(self):
        if self.precision == "exact_df":
            raise NotImplementedError(
                "precision 'exact_df' is not yet ported (ROADMAP.md queue 1: "
                "df32 and exact_df)")
        if self.precision not in ("exact", "fast"):
            raise ValueError(f"unknown precision {self.precision!r}")
        self.device = torch.device(self.device)

    @property
    def phase_dtype(self):
        return f64 if self.precision == "exact" else f32

    @property
    def sequential_iir(self) -> bool:
        return self.precision == "exact"


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
    NCO accumulators, int32 positions) become int64, bool and float leaves
    keep their dtype."""
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

    def __init__(self, n: int, device, allow_captures: bool = True):
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

    @property
    def fidx(self) -> torch.Tensor:
        """float32 lane indices: the running-max kernel's input."""
        return self.idx.to(f32)


def _mask(ctx: Ctx, s, e):
    return (ctx.idx >= s) & (ctx.idx < e)


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
    """lane_values[lane] when 0 <= lane < n, else default."""
    picked = torch.take(lane_values, lane.clamp(0, ctx.n - 1))
    hit = (lane >= 0) & (lane < ctx.n)
    return torch.where(hit, picked, default)


def _tree_where(cond, a, b):
    """where(cond, a, b) leaf by leaf over two state trees of one shape."""
    if isinstance(a, tuple):
        return tuple(_tree_where(cond, x, y) for x, y in zip(a, b))
    return torch.where(cond, a, b)


# ---------------------------------------------------------------------------
# Node compilers
# ---------------------------------------------------------------------------


class Node:
    """A compiled IR node: init / render / advance plus optional reloc."""

    # reloc: None, or fn(P, local_idx[N]) -> (samples[N], length) for nodes
    # that are a pure function of time-since-start (the JAX engine's
    # contract: y[i] == 0 wherever li[i] >= length; unspecified for
    # li[i] < 0).  length is a Python int, an int64 scalar, or None for
    # infinite.
    reloc: Optional[Callable] = None
    # const_expr: None, or fn(P) -> f32 scalar (is_const semantics)
    const_expr: Optional[Callable] = None

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
        self.reloc = lambda P, li: (P.consts[index].expand(li.shape), None)

    def init(self, P):
        return ()

    def render(self, P, st, s, e, ctx):
        y = torch.where(_mask(ctx, s, e), P.consts[self.index], 0.0)
        return y, e, e, st

    def advance(self, P, st, s, e, ctx):
        return e, st


class CTime(Node):
    def __init__(self, cfg):
        super().__init__(cfg)
        sr = float(cfg.sample_rate)
        self.reloc = lambda P, li: (_div(li.to(f32), sr), None)

    def init(self, P):
        return (_zero_i(P),)

    def render(self, P, st, s, e, ctx):
        pos = st[0]
        local = pos + ctx.idx - s
        y = torch.where(_mask(ctx, s, e),
                        _div(local.to(f32), float(self.cfg.sample_rate)), 0.0)
        return y, e, e, (pos + (e - s).clamp(min=0),)

    def advance(self, P, st, s, e, ctx):
        return e, (st[0] + (e - s).clamp(min=0),)


class CNoise(Node):
    def __init__(self, cfg, uid: int):
        super().__init__(cfg)
        self.uid = uid
        self.reloc = lambda P, li: (
            noise_torch(P.seed, uid, li.clamp(min=0)), None)

    def init(self, P):
        return (_zero_i(P),)

    def render(self, P, st, s, e, ctx):
        pos = st[0]
        local = (pos + ctx.idx - s).clamp(min=0)
        y = torch.where(_mask(ctx, s, e),
                        noise_torch(P.seed, self.uid, local), 0.0)
        return y, e, e, (pos + (e - s).clamp(min=0),)

    def advance(self, P, st, s, e, ctx):
        return e, (st[0] + (e - s).clamp(min=0),)


class CFixed(Node):
    def __init__(self, cfg, index: int, length: int):
        super().__init__(cfg)
        self.index = index
        self.length = length

        def reloc(P, li):
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
            y = torch.where(_mask(ctx, s, v), win, 0.0)
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
            def reloc(P, li):
                ya, la = a.reloc(P, li)
                if la is None:
                    # Infinite a: b never plays (matches the stateful path).
                    return ya, None
                yb, lb = b.reloc(P, li - la)
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
            def reloc(P, li):
                ya, la = a.reloc(P, li)
                yb, lb = b.reloc(P, li)
                if op == ir.Operator.MERGE:
                    # Operands are zero past their own lengths by the reloc
                    # contract, so zero-extension is a plain add.
                    return ya + yb, _len_max(la, lb)
                v = _len_min(la, lb)
                return _len_mask(li, _apply_op(op, ya, yb), v), v
            self.reloc = reloc

    def init(self, P):
        return (self.a.init(P), self.b.init(P))

    def render(self, P, st, s, e, ctx):
        sa, sb = st
        ya, va, wa, sa = self.a.render(P, sa, s, e, ctx)
        merge = self.op == ir.Operator.MERGE
        eb = e if merge else va
        yb, vb, wb, sb = self.b.render(P, sb, s, eb, ctx)
        if merge:
            v = torch.maximum(va, vb)
            # [va, v) of the shared buffer is zero-filled before the op, so
            # a's overrun writes vanish inside the result but survive
            # beyond it (generator.rs:543,560-566).
            a_z = torch.where(ctx.idx < va, ya, 0.0)
            y = torch.where(_mask(ctx, s, v), a_z + yb, ya)
        else:
            v = torch.minimum(va, vb)
            y = torch.where(_mask(ctx, s, v), _apply_op(self.op, ya, yb), ya)
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


class CSine(Node):
    """DDS oscillator.

    Fast mode: a 32-bit NCO for constant frequencies (integer wrap-around
    is the exact mod-tau reduction; per-lane phase is one multiply), and
    for dynamic frequencies an f32 phase integrated with the prefix-sum
    kernel.  Exact mode: the reference's f64 radian accumulator."""

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
                def reloc(P, li):
                    yp, lp = phase.reloc(P, li)
                    ph = (li * self._nco_inc(P)) & M32
                    y = torch.sin(_nco_angle(ph) + yp)
                    return _len_mask(li, y, lp), lp
            else:
                def reloc(P, li):
                    inc = _div(freq.const_expr(P).to(pd), sr)
                    yp, lp = phase.reloc(P, li)
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
            y = torch.where(_mask(ctx, s, e),
                            torch.sin(_nco_angle(ph) + yp), 0.0)
            acc = (acc + (e - s).clamp(min=0) * inc) & M32
            return y, vp, e, (acc, sf, sp)
        pd = self.cfg.phase_dtype
        yf, vf, wf, sf = self.freq.render(P, sf, s, e, ctx)
        yp, vp, wp, sp = self.phase.render(P, sp, s, vf, ctx)
        inc = _div(torch.where(_mask(ctx, s, vf), yf, 0.0).to(pd),
                   float(self.cfg.sample_rate))
        pre = _cumsum(inc) - inc
        y = torch.sin(acc + pre + yp.to(pd)).to(f32)
        # Sine overwrites the frequency's buffer up to the frequency's
        # returned length; beyond that the frequency's own overrun writes
        # remain (shared-buffer semantics).
        y = torch.where(_mask(ctx, s, vf), y, yf)
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
        if len(fbs) > scan_ops.MAX_J:
            raise NotImplementedError(
                f"filter with {len(fbs)} feedback coefficients: the affine "
                f"scan takes at most {scan_ops.MAX_J} (deeper filters: "
                f"ROADMAP.md queue 2)")
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
        wy = torch.where(_mask(ctx, s, wv), wy_raw, 0.0)
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
        acc = torch.where(live, acc, 0.0)
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
        """y[i] = ff[i] - sum_j a_j[i] * y[i-1-j]; hist[j] = y[-1-j]."""
        J = self.J
        if self.cfg.sequential_iir:
            return self._feedback_sequential(ff, fb_vals, hist, live)
        a_rows = torch.stack(fb_vals, dim=1)  # [N, J]
        hs, hist_out = scan_ops.affine_scan_f32(a_rows, ff, live,
                                                hist[:J].contiguous())
        y = torch.where(live, hs[:, 0], 0.0)
        return y, _pad_hist(hist_out, J)

    def _feedback_sequential(self, ff, fb_vals, hist, live):
        """Exact mode: the recurrence lane by lane in the reference's op
        order (tuun_tpu graph.py:852-864)."""
        J = self.J
        ffl = ff.unbind(0)
        lvl = live.unbind(0)
        cols = [c.unbind(0) for c in fb_vals]
        h = list(hist[:J].unbind(0))
        ys = []
        for i in range(ff.shape[0]):
            lv = lvl[i]
            acc = ffl[i]
            for j in range(J):
                acc = acc - cols[j][i] * h[j]
            acc = torch.where(lv, acc, 0.0)
            h = [torch.where(lv, acc, h[0])] + [
                torch.where(lv, h[j - 1], h[j]) for j in range(1, J)]
            ys.append(acc)
        return torch.stack(ys), _pad_hist(torch.stack(h), J)

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
    def __init__(self, cfg, length: Node, inner: Node,
                 ge0: Optional[Callable]):
        super().__init__(cfg)
        self.length = length
        self.inner = inner
        self.ge0 = ge0  # fn(P, lpos, maxn) -> rel cutoff in [0, maxn]
        if ge0 is not None and inner.reloc is not None:
            def reloc(P, li):
                rel = ge0(P, _zero_i(P), BIG)
                yi, lin = inner.reloc(P, li)
                v = _len_min(lin, rel)
                return _len_mask(li, yi, v), v
            self.reloc = reloc

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
        cond = (_mask(ctx, s, lv) & (ly >= 0.0)) | \
            ((ctx.idx >= lv) & (ctx.idx < e))
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
        cond = (_mask(ctx, s, lv) & (ly >= 0.0)) | \
            ((ctx.idx >= lv) & (ctx.idx < e)) | \
            ((ctx.idx >= vi) & (ctx.idx < e))
        return _first_lane(ctx, cond, e), (lpos + maxn, sl, si)


class CReset(Node):
    """Reset(trigger, inner): restart `inner` at each -..+ trigger crossing.

    The generic sampled-sign tiers of the JAX engine: the trigger renders,
    edges are its sign crossings, and the last edge at or before each lane
    is a running max over edge lane indices (the prefix-max kernel).  A
    relocatable inner is then evaluated at each lane's age; a stateful
    inner renders once from a fresh state over the block and is gathered
    at the ages (tuun_tpu graph.py:1515-1588).  The analytic tiers wait
    (see the module docstring), so a Reset is never itself relocatable.
    """

    def __init__(self, cfg, trigger: Node, inner: Node):
        super().__init__(cfg)
        self.trigger = trigger
        self.inner = inner
        self.inner_reloc = inner.reloc

    def init(self, P):
        return (torch.full((), -1.0, dtype=f32, device=P.device), _zero_i(P),
                self.trigger.init(P), self.inner.init(P))

    def render(self, P, st, s, e, ctx):
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
            yi, _ = self.inner_reloc(P, ctx.idx - last)
            # Lanes beyond the trigger's validity keep the trigger's raw
            # writes (the reset reuses the trigger's buffer).
            y = torch.where(m, yi, yt)
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
        nctx = Ctx(ctx.n, ctx.device, allow_captures=False)
        any_edge = edge.any()

        # Continued segment [s, first edge) from the carried state.
        y0, v0, _, st0 = inner.render(P, sinn, s, vt, nctx)
        y0 = torch.where(_mask(nctx, s, v0), y0, 0.0)
        # The restarted waveform over ages 0..n-1 (zeros once it ends).
        yb, vb, _, _ = inner.render(P, fresh, nctx.zero, nctx.end, nctx)
        yb = torch.where(nctx.idx < vb, yb, 0.0)

        restarted = last_f >= 0.0  # lane is at/after an edge in this block
        age_i = (ctx.idx - last_f.to(I64)).clamp(0, ctx.n - 1)
        y = torch.where(restarted, yb[age_i], y0)
        y = torch.where(m, y, yt)  # trigger's raw writes beyond validity

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
            def reloc(P, li):
                yt, lt = trigger.reloc(P, li)
                yp, _ = pos.reloc(P, li)
                yn, _ = neg.reloc(P, li)
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
        y = torch.where(_mask(ctx, s, vt),
                        torch.where(yt >= 0.0, yp, yn), yt)
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
                torch.where(_mask(ctx, s, v), y, 0.0), s, v)
        return y, v, w, st

    def advance(self, P, st, s, e, ctx):
        return self.inner.advance(P, st, s, e, ctx)


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


# ---------------------------------------------------------------------------
# The compiler
# ---------------------------------------------------------------------------


class Compiler:
    def __init__(self, cfg: EngineConfig):
        self.cfg = cfg
        self.const_values: List[np.float32] = []
        self.fixed_values: List[np.ndarray] = []
        self.uid = 0
        self.captures: List[str] = []

    def _const_index(self, value: float) -> int:
        self.const_values.append(np.float32(value))
        return len(self.const_values) - 1

    def compile(self, w: ir.Waveform) -> Node:
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
            return CFixed(cfg, len(self.fixed_values) - 1, len(w.samples))
        if isinstance(w, ir.Fin):
            length = self.compile(w.length)
            inner = self.compile(w.waveform)
            return CFin(cfg, length, inner, self._ge0_static(w.length, length))
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
            # Merge compiles to CBinary: the timeline form waits.
            return CBinary(cfg, w.op, self.compile(w.a), self.compile(w.b))
        if isinstance(w, ir.Reset):
            return CReset(cfg, self.compile(w.trigger),
                          self.compile(w.waveform))
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
    moves, per-voice frequencies) share one compiled voice."""

    def __init__(self, w: ir.Waveform, cfg: EngineConfig):
        check_device(cfg.device)
        self.cfg = cfg
        self.waveform = w
        compiler = Compiler(cfg)
        self.root = compiler.compile(w)
        self.capture_stems = compiler.captures
        # A relocatable root is a pure function of the absolute sample
        # index: its length composes symbolically (symbolic_len).
        self.relocatable = (self.root.reloc is not None
                            and not compiler.captures)
        self._base_consts = np.asarray(compiler.const_values, np.float32) \
            if compiler.const_values else np.zeros((0,), np.float32)
        self._base_fixeds = tuple(compiler.fixed_values)

    def symbolic_len(self, P) -> Optional[int]:
        """Total producible length of a relocatable voice, or None when
        infinite, unresolvable, or not relocatable (callers fall back to
        the oracle's length(), generator.rs:620-782).  Evaluates a 1-lane
        reloc on CPU tensors from P's host mirror: no device round trip."""
        if not self.relocatable:
            return None
        _, L = self.root.reloc(_host_params(P), torch.zeros(1, dtype=I64))
        if L is None:
            return None
        L = int(L)
        return None if L >= BIG else L

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
        # Voice state = (stream position, per-node state tree).
        return (_zero_i(P), self.root.init(P))

    # -- rendering ------------------------------------------------------

    def _render_impl(self, n, P, state, s, e):
        ctx = Ctx(n, P.device)
        pos, rst = state
        y, v, w, rst = self.root.render(P, rst, s, e, ctx)
        # Consumers (the tracker mix, WAV writers) see only valid samples;
        # written-but-invalid overruns are an internal buffer matter.
        y = torch.where(_mask(ctx, s, v), y, 0.0)
        return y, v, (pos + (e - s).clamp(min=0), rst), ctx.captures

    def render_fn(self, n: int) -> Callable:
        """fn(P, state, s, e) -> (y[n], valid_end, state', captures) with
        s and e int64 scalars on P's device."""
        return partial(self._render_impl, n)

    def render_block(self, P, state, n: int, s=0, e=None):
        if e is None:
            e = n
        dev = P.device
        if not isinstance(s, torch.Tensor):
            s = torch.full((), int(s), dtype=I64, device=dev)
        if not isinstance(e, torch.Tensor):
            e = torch.full((), int(e), dtype=I64, device=dev)
        return self.render_fn(n)(P, state, s, e)


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

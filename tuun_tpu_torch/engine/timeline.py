"""Timeline compilation: Merge/Append trees as data, not code.

Port of tuun_tpu/engine/timeline.py.  The `<[...]>` sequence and `{[...]}`
chord builders desugar to balanced trees of Merge and Append nodes
(`a \\ b` -> `a & append(0|fin(off), b)`).  Compiled as a tree, a
160-segment score renders or masks every segment on every block.  This
pass flattens such a tree into a timeline: leaf waveforms with literal
start offsets, evaluated in O(active structure) per block:

  * constant-content leaves (`Fin(len, Const)`: the silent spacers of
    every sequence, constant drones) fold into one step sum over the
    leaf table;
  * simultaneous same-structure leaves (a chord) evaluate once, with
    each leaf's consts as a row of an [S, C] table broadcast against the
    lanes (the JAX engine vmaps over the rows);
  * other same-structure leaves (the notes of a melody) split into
    non-overlapping layers, each evaluated once with per-lane consts
    gathered from the layer's table;
  * anything else evaluates on its own at its offset.

Offsets come from the literal Fin cutoffs (CompiledVoice.lits_for), so
the schedule is host ints.  Everything the evaluation needs on the
device is built once per lits (the step points, the const indices each
table gathers) and gathered once per params (the step values, the
parameter tables), so a block makes no host-to-device copy.  A voice
group's params are batched by vmap for one render only, so its tables
are gathered on the device in every render.
The step sums scatter deltas at host-merged points, one per slot, so a
block gives the same bits on every call (no float atomics).

Reference semantics preserved (generator.rs Append/Merge): Append plays
`b` when `a` ends (an infinite `a` drops every later leaf); Merge
zero-extends to the longer operand.
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import ir
from .graph import (BIG, I64, CAppend, CBinary, Node, Params, _cumsum,
                    _host_params, _len_mask, _mask, f32, structure_key)

MIN_LEAVES = 6  # below this the plain compiled tree is just as good
_NEVER = 1 << 62  # an end past every lane (an infinite leaf)


# ---------------------------------------------------------------------------
# Flattening (compile time, IR level)
# ---------------------------------------------------------------------------


def _flatten(w: ir.Waveform, leaves: List[ir.Waveform]):
    """Lossless decomposition of a Merge/Append tree into a description
    tree of ("leaf", idx) / ("seq", a, b) / ("par", a, b)."""
    if isinstance(w, ir.BinaryPointOp) and w.op == ir.Operator.MERGE:
        return ("par", _flatten(w.a, leaves), _flatten(w.b, leaves))
    if isinstance(w, ir.Append):
        return ("seq", _flatten(w.a, leaves), _flatten(w.b, leaves))
    leaves.append(w)
    return ("leaf", len(leaves) - 1)


def _contains(w: ir.Waveform, kinds) -> bool:
    return any(isinstance(n, kinds) for n in w.walk())


def _const_content_index(lw: ir.Waveform, c0: int, c1: int) -> Optional[int]:
    """For constant-content leaves (`Const` or `Fin(len, Const)`), the
    index of the content value in the voice's const vector: the inner
    Const compiles last, so it is c1 - 1."""
    if isinstance(lw, ir.Const):
        return c1 - 1
    if isinstance(lw, ir.Fin) and isinstance(lw.waveform, ir.Const):
        return c1 - 1
    return None


@dataclass
class LeafInfo:
    node: Node              # the compiled leaf (reloc-capable)
    w: ir.Waveform
    c0: int                 # const index range [c0, c1)
    c1: int
    f0: int                 # fin slot range [f0, f1)
    f1: int
    const_idx: Optional[int]   # constant-content value index, or None
    stackable: bool         # safe to batch with same-structure leaves


def try_compile_timeline(compiler, w: ir.Waveform) -> Optional[Node]:
    """Called by Compiler._compile at a Merge node.  Returns a CTimeline,
    the equivalent plain tree when the timeline form does not apply, or
    None to compile the Merge normally.

    Leaves compile in the same pre-order as the recursive compile, so
    const and fin registration order (params_for compatibility) and
    noise uids are unchanged."""
    if not compiler.cfg.timeline:
        return None
    leaves_ir: List[ir.Waveform] = []
    desc = _flatten(w, leaves_ir)
    if len(leaves_ir) < MIN_LEAVES:
        return None

    infos_by_index: Dict[int, LeafInfo] = {}

    def walk_compile(d, is_root: bool) -> None:
        if d[0] == "leaf":
            i = d[1]
            lw = leaves_ir[i]
            c0 = len(compiler.const_values)
            f0 = len(compiler.fins)
            had_tl = compiler.has_timeline
            compiler.has_timeline = False
            node = compiler.compile(lw)
            nested_tl = compiler.has_timeline
            compiler.has_timeline = had_tl or nested_tl
            c1 = len(compiler.const_values)
            infos_by_index[i] = LeafInfo(
                node=node, w=lw, c0=c0, c1=c1, f0=f0, f1=len(compiler.fins),
                const_idx=_const_content_index(lw, c0, c1),
                # Noise (per-leaf uids), Fixed payloads and nested
                # timelines cannot take per-lane parameter tables.
                stackable=not _contains(lw, (ir.Noise, ir.Fixed))
                and not nested_tl)
            return
        # Every interior Merge/Append takes one uid, as in the plain
        # compile (the top node's was taken by _compile).
        if not is_root:
            compiler.uid += 1
        walk_compile(d[1], False)
        walk_compile(d[2], False)

    walk_compile(desc, True)
    infos = [infos_by_index[i] for i in range(len(leaves_ir))]

    fallback = _build_fallback(compiler.cfg, desc, infos)
    # Every leaf must be a pure function of local time.
    if any(n.node.reloc is None or n.node.has_capture for n in infos):
        return fallback
    # Same-structure groups that would stack must be parameter-pure.
    by_key: Dict[Tuple, List[int]] = {}
    for i, inf in enumerate(infos):
        if inf.const_idx is None:
            by_key.setdefault(
                structure_key(inf.w, compiler.cfg.sample_rate), []).append(i)
    for idxs in by_key.values():
        if len(idxs) >= 2 and not all(infos[i].stackable for i in idxs):
            return fallback
    compiler.has_timeline = True
    return CTimeline(compiler.cfg, desc, infos)


def _build_fallback(cfg, desc, infos: List[LeafInfo]) -> Node:
    """The plain compiled tree (the normal compile's semantics) rebuilt
    from the flattened description."""
    kind = desc[0]
    if kind == "leaf":
        return infos[desc[1]].node
    a = _build_fallback(cfg, desc[1], infos)
    b = _build_fallback(cfg, desc[2], infos)
    if kind == "seq":
        return CAppend(cfg, a, b)
    return CBinary(cfg, ir.Operator.MERGE, a, b)


# ---------------------------------------------------------------------------
# Per-lane and per-row parameter views for stacked leaf evaluation
# ---------------------------------------------------------------------------


class _LaneConsts:
    """Stands in for Params.consts inside a layer's evaluation: indices in
    the representative leaf's const range resolve to per-lane gathers
    from the layer's [S, C] table at each lane's layer position; other
    indices fall through to the real vector."""

    def __init__(self, base, c0: int, table, pos):
        self._base = base
        self._c0 = c0
        self._table = table      # [S, C] on the device
        self._pos = pos          # [n] layer position per lane (int64)
        self._cache: Dict[int, torch.Tensor] = {}

    @property
    def device(self):
        return self._base.device

    def __getitem__(self, j):
        c = j - self._c0
        if 0 <= c < self._table.shape[1]:
            got = self._cache.get(c)
            if got is None:
                got = self._cache[c] = self._table[:, c][self._pos]
            return got
        return self._base[j]


class _RowConsts:
    """Stands in for Params.consts inside a chord's evaluation: indices in
    the representative leaf's const range read column [S, 1] of the
    chord's table, so the leaf evaluates on [S, n] broadcast tensors, one
    row per leaf; other indices fall through."""

    def __init__(self, base, c0: int, table):
        self._base = base
        self._c0 = c0
        self._table = table      # [S, C]

    @property
    def device(self):
        return self._base.device

    def __getitem__(self, j):
        c = j - self._c0
        if 0 <= c < self._table.shape[1]:
            return self._table[:, c, None]
        return self._base[j]


class _LaneLits:
    """Stands in for the lits tuple: slots in the representative leaf's
    fin range resolve to per-lane gathers from the layer's [S, F] cutoff
    table."""

    def __init__(self, base, f0: int, table, pos):
        self._base = base
        self._f0 = f0
        self._table = table      # [S, F] int64 on the device
        self._pos = pos
        self._cache: Dict[int, torch.Tensor] = {}

    def __getitem__(self, slot):
        f = slot - self._f0
        if 0 <= f < self._table.shape[1]:
            got = self._cache.get(f)
            if got is None:
                got = self._cache[f] = self._table[:, f][self._pos]
            return got
        return self._base[slot]


@dataclass
class _Steps:
    """A step function sum_j values[j] * (li >= points[j]) with its
    points merged on the host: `points` int64 [G], strictly increasing;
    `values` f32 [G], the values of equal points summed in their order."""
    points: torch.Tensor
    values: torch.Tensor


@dataclass
class _StepMerge:
    """How _steps merges S points into G: the merged points, and for each
    d the index of member d of every group in the values (S: none)."""
    points: torch.Tensor
    members: List[torch.Tensor]


def _step_merge(points: np.ndarray, dev) -> _StepMerge:
    order = np.argsort(points, kind="stable")
    uniq, first, counts = np.unique(points[order], return_index=True,
                                    return_counts=True)
    S = len(points)
    members = [torch.as_tensor(
        np.where(counts > d, order[np.minimum(first + d, S - 1)], S),
        device=dev) for d in range(int(counts.max()))]
    return _StepMerge(torch.as_tensor(uniq, dtype=I64, device=dev), members)


def _steps(points: np.ndarray, values: torch.Tensor) -> _Steps:
    """Merges equal points; `values` [S] is on the evaluation device."""
    return _merged_steps(_step_merge(points, values.device), values)


def _merged_steps(merge: _StepMerge, values: torch.Tensor) -> _Steps:
    """The step function of `values` [S] at the merged points: the values
    of equal points summed in their order, by device gathers only."""
    vz = torch.cat([values, torch.zeros(1, dtype=values.dtype,
                                        device=values.device)])
    merged = None
    for idx in merge.members:
        col = vz[idx]
        merged = col if merged is None else merged + col
    return _Steps(merge.points, merged)


def _step_sum(li0, n: int, steps: _Steps) -> torch.Tensor:
    """The step function at li = li0 + [0, n) (tuun_tpu timeline.py:252-
    265): each point's delta lands at its lane, the points at or before
    li0 are summed into lane 0, then one prefix sum -- O(n + G) instead
    of the O(G * n) broadcast.  Merged points give distinct lanes, so the
    scatter writes each slot once and no float atomics are involved.  The
    scatter is out of place (a voice group vmaps it)."""
    t = steps.points - li0
    inside = (t > 0) & (t < n)
    # Points outside (0, n) write zero into the spare slot n.
    delta = torch.zeros(n + 1, dtype=f32, device=t.device).index_put(
        (torch.where(inside, t, n),), torch.where(inside, steps.values, 0.0))
    head = torch.where(t <= 0, steps.values, 0.0).sum()
    return _cumsum(torch.cat([head[None], delta[1:n]]))


def _layer_partition(entries: List[Tuple[int, int, Optional[int]]]):
    """Greedy interval partitioning of (leaf, off, end|None) into
    non-overlapping layers (sorted by offset within each layer)."""
    layers: List[List[Tuple[int, int, Optional[int]]]] = []
    ends: List[Optional[int]] = []
    for item in sorted(entries, key=lambda t: t[1]):
        placed = False
        for li, end in enumerate(ends):
            if end is not None and end <= item[1]:
                layers[li].append(item)
                ends[li] = item[2]
                placed = True
                break
        if not placed:
            layers.append([item])
            ends.append(item[2])
    return layers


# ---------------------------------------------------------------------------
# The node
# ---------------------------------------------------------------------------


@dataclass
class _Chord:
    """S same-structure leaves at one offset with equal cutoffs."""
    node: Node
    off: int
    count: int
    c0: int
    table: Optional[torch.Tensor]   # [S, C] consts, None when C == 0


@dataclass
class _Layer:
    """Non-overlapping same-structure leaves, evaluated once."""
    node: Node
    offs: torch.Tensor              # [S] int64
    first: int                      # the smallest offset
    starts: _Steps                  # how many leaves start at or before
    c0: int
    table: Optional[torch.Tensor]   # [S, C] consts
    f0: int
    ftable: Optional[torch.Tensor]  # [S, F] int64 cutoffs


@dataclass
class _Plan:
    """What one (params, lits) evaluation needs on the device."""
    total: Optional[int]
    const: Optional[_Steps]
    # The same constant leaves for arbitrary lanes: offs, ends, values.
    const_bcast: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]
    items: List  # _Chord, _Layer, or (node, off) for a lone leaf


@dataclass
class _Layout:
    """The part of a plan that depends on lits alone, on the device: the
    const indices each table gathers from the params.  `items` hold
    _Chord / _Layer with an int64 index tensor in place of `table`."""
    total: Optional[int]
    const_merge: Optional[_StepMerge]
    const_vidx: Optional[torch.Tensor]   # [S] const index of each value
    # Which of the S leaves end (int64 positions: a boolean mask would be
    # counted on the host at every gather).
    const_fin: Optional[torch.Tensor]
    const_offs_ends: Optional[Tuple[torch.Tensor, torch.Tensor]]
    items: List


class CTimeline(Node):
    """A compiled Merge/Append tree in timeline form.

    Relocatable (a pure function of the stream position).  Its stateful
    render keeps only a position scalar and needs the literal lits
    (Ctx.lits; CompiledVoice computes them for timeline-bearing
    structures); compile with EngineConfig(timeline=False) for a
    lits-free tree."""

    def __init__(self, cfg, desc, infos: List[LeafInfo]):
        super().__init__(cfg)
        self.desc = desc
        self.infos = infos
        self._sched_cache: Dict[Tuple, Optional[Tuple]] = {}
        self._plans: Dict[Tuple, _Plan] = {}
        self._layouts: Dict[Tuple, _Layout] = {}
        self.reloc = self._reloc

    # -- schedule (host side, once per lits) ---------------------------

    def _schedule(self, P, lits):
        """(entries [(leaf, off, end|None)], total|None), all literal, or
        None when a leaf's length is not literal."""
        lens: Dict[int, Optional[int]] = {}
        hp = _host_params(P)
        zero = torch.zeros(1, dtype=I64)

        def leaf_len(i):
            if i not in lens:
                _, L = self.infos[i].node.reloc(hp, zero, lits)
                if L is not None and not isinstance(L, int):
                    raise _NotLiteral
                lens[i] = None if L is None else min(L, BIG)
            return lens[i]

        def walk(d, base):
            if d[0] == "leaf":
                L = leaf_len(d[1])
                return [(d[1], base, None if L is None else base + L)], L
            ea, La = walk(d[1], base)
            if d[0] == "seq":
                if La is None:  # infinite a: b never plays
                    return ea, None
                eb, Lb = walk(d[2], base + La)
                return ea + eb, None if Lb is None else min(La + Lb, BIG)
            eb, Lb = walk(d[2], base)
            total = None if La is None or Lb is None else max(La, Lb)
            return ea + eb, total

        try:
            return walk(self.desc, 0)
        except _NotLiteral:
            return None

    def _sched_for(self, P, lits):
        if lits not in self._sched_cache:
            self._sched_cache[lits] = self._schedule(P, lits)
        sched = self._sched_cache[lits]
        if sched is None:
            raise RuntimeError(
                "timeline schedule not literal for these lits; compile "
                "with EngineConfig(timeline=False)")
        return sched

    def _plan_for(self, P, lits) -> _Plan:
        """The plan for (P, lits): cached per params for a voice of its
        own, gathered anew from the layout where `_bind_per_render`."""
        if _bind_per_render(P):
            return self._bind(self._layout_for(P, lits), P)
        key = (id(P), lits)
        plan = self._plans.get(key)
        if plan is None:
            plan = self._plans[key] = self._bind(self._layout_for(P, lits),
                                                 P)
            # id(P) is only P's while P lives: evict with it.
            weakref.finalize(P, self._plans.pop, key, None)
        return plan

    def _layout_for(self, P, lits) -> _Layout:
        # Per device too: lengths evaluate on CPU copies of the params.
        key = (lits, P.device)
        layout = self._layouts.get(key)
        if layout is None:
            layout = self._layouts[key] = self._build_layout(P, lits)
        return layout

    @staticmethod
    def _bind(layout: _Layout, P) -> _Plan:
        """A plan from a layout: every table gathered from P.consts."""
        const, const_bcast = None, None
        if layout.const_merge is not None:
            vals = P.consts[layout.const_vidx]                   # [S]
            const = _merged_steps(
                layout.const_merge, torch.cat([vals, -vals[layout.const_fin]]))
            const_bcast = layout.const_offs_ends + (vals,)
        items = []
        for item in layout.items:
            if isinstance(item, (_Chord, _Layer)) and item.table is not None:
                item = replace(item, table=P.consts[item.table])
            items.append(item)
        return _Plan(layout.total, const, const_bcast, items)

    def _build_layout(self, P, lits) -> _Layout:
        """The grouping of tuun_tpu timeline.py:387-443, with every index
        on P's device."""
        entries, total = self._sched_for(P, lits)
        dev = P.device

        def consts_table(group):
            idx = np.stack([np.arange(self.infos[i].c0, self.infos[i].c1)
                            for (i, _, _) in group])          # [S, C]
            return torch.as_tensor(idx, device=dev)

        const_merge = const_vidx = const_fin = const_offs_ends = None
        const_entries = [(i, off, end) for (i, off, end) in entries
                         if self.infos[i].const_idx is not None]
        if const_entries:
            offs = np.array([off for (_, off, _) in const_entries], np.int64)
            ends = np.array([_NEVER if end is None else end
                             for (_, _, end) in const_entries], np.int64)
            const_vidx = torch.as_tensor(
                [self.infos[i].const_idx for (i, _, _) in const_entries],
                device=dev)
            # An infinite leaf never steps down: no -v point.
            fin = ends < _NEVER
            const_fin = torch.as_tensor(np.flatnonzero(fin), device=dev)
            const_merge = _step_merge(np.concatenate([offs, ends[fin]]), dev)
            const_offs_ends = (torch.as_tensor(offs, device=dev),
                               torch.as_tensor(ends, device=dev))

        # Structured leaves grouped by structure; simultaneous leaves of a
        # group (a chord) evaluate once, the rest layer by overlap.
        items: List = []
        by_key: Dict[Tuple, List[Tuple[int, int, Optional[int]]]] = {}
        for (i, off, end) in entries:
            if self.infos[i].const_idx is None:
                by_key.setdefault(structure_key(
                    self.infos[i].w, self.cfg.sample_rate), []).append(
                        (i, off, end))
        for group in by_key.values():
            rest: List[Tuple[int, int, Optional[int]]] = []
            sim: Dict[Tuple, List[Tuple[int, int, Optional[int]]]] = {}
            for (i, off, end) in group:
                inf = self.infos[i]
                fl = tuple(lits[s] for s in range(inf.f0, inf.f1))
                sim.setdefault((off, end, fl), []).append((i, off, end))
            for (off, _, _), sg in sim.items():
                if len(sg) >= 2 and all(self.infos[i].stackable
                                        for (i, _, _) in sg):
                    rep = self.infos[sg[0][0]]
                    items.append(_Chord(
                        rep.node, off, len(sg), rep.c0,
                        consts_table(sg) if rep.c1 > rep.c0 else None))
                else:
                    rest.extend(sg)
            for layer in _layer_partition(rest):
                if len(layer) == 1:
                    i, off, _ = layer[0]
                    items.append((self.infos[i].node, off))
                    continue
                rep = self.infos[layer[0][0]]
                offs = np.array([off for (_, off, _) in layer], np.int64)
                ftable = None
                if rep.f1 > rep.f0:
                    ftable = torch.as_tensor(np.stack([
                        np.array([lits[s] for s in range(
                            self.infos[i].f0, self.infos[i].f1)], np.int64)
                        for (i, _, _) in layer]), device=dev)    # [S, F]
                items.append(_Layer(
                    rep.node, torch.as_tensor(offs, device=dev),
                    int(offs.min()),
                    _steps(offs, torch.ones(len(layer), dtype=f32,
                                            device=dev)),
                    rep.c0, consts_table(layer) if rep.c1 > rep.c0 else None,
                    rep.f0, ftable))
        return _Layout(total, const_merge, const_vidx, const_fin,
                       const_offs_ends, items)

    # -- evaluation -----------------------------------------------------

    def _reloc(self, P, li, lits=None, li0=None, n=None):
        """The timeline at lane indices `li` (1-D).  When the caller knows
        li == li0 + arange(n) (the render path), the step functions take
        the scatter + prefix-sum form."""
        if lits is None:
            raise RuntimeError(
                "timeline render requires literal lits; compile with "
                "EngineConfig(timeline=False) for a lits-free tree")
        plan = self._plan_for(P, lits)
        y = None

        def add(part):
            return part if y is None else y + part

        if plan.const is not None:
            if li0 is not None:
                y = add(_step_sum(li0, n, plan.const))
            else:
                offs, ends, vals = plan.const_bcast
                inr = (li[None, :] >= offs[:, None]) & \
                    (li[None, :] < ends[:, None])
                y = add((vals[:, None] * inr.to(f32)).sum(0))
        for item in plan.items:
            if isinstance(item, _Chord):
                y = add(self._eval_chord(P, li, lits, item))
            elif isinstance(item, _Layer):
                y = add(self._eval_layer(P, li, lits, item, li0, n))
            else:
                node, off = item
                ys, _ = node.reloc(P, li - off, lits)
                y = add(torch.where(li >= off, ys, 0.0))
        if y is None:
            y = torch.zeros(li.shape, dtype=f32, device=li.device)
        return (_len_mask(li, y, plan.total) if plan.total is not None
                else y), plan.total

    @staticmethod
    def _eval_chord(P, li, lits, chord: _Chord):
        """One evaluation of S same-structure leaves that share an offset
        and cutoffs: each leaf's consts are a row of the table, so the
        representative evaluates on [S, n] and the rows sum (Merge is
        additive)."""
        local = li - chord.off
        if chord.table is None:
            # No per-leaf parameters: S identical leaves.
            ys, _ = chord.node.reloc(P, local, lits)
            y = ys * float(chord.count)
        else:
            rows = Params(_RowConsts(P.consts, chord.c0, chord.table),
                          P.fixeds, P.seed)
            ys, _ = chord.node.reloc(rows, local, lits)
            y = ys.sum(0) if ys.dim() > local.dim() \
                else ys * float(chord.count)
        return torch.where(li >= chord.off, y, 0.0)

    @staticmethod
    def _eval_layer(P, li, lits, layer: _Layer, li0, n):
        S = layer.offs.shape[0]
        # Per-lane layer position: how many layer leaves start at or
        # before the lane, minus one.
        if li0 is not None:
            pos = _step_sum(li0, n, layer.starts).to(I64) - 1
        else:
            pos = (li[None, :] >= layer.offs[:, None]).sum(0) - 1
        pos = pos.clamp(0, S - 1)
        local = li - layer.offs[pos]
        laneP = P
        if layer.table is not None:
            laneP = Params(_LaneConsts(P.consts, layer.c0, layer.table, pos),
                           P.fixeds, P.seed)
        lane_lits = lits
        if layer.ftable is not None:
            lane_lits = _LaneLits(lits, layer.f0, layer.ftable, pos)
        ys, _ = layer.node.reloc(laneP, local, lane_lits)
        return torch.where(li >= layer.first, ys, 0.0)

    # -- Node protocol ---------------------------------------------------

    def init(self, P):
        return (torch.zeros((), dtype=I64, device=P.device),)

    def _valid_end(self, P, lits, pos, s, e):
        _, total = self._sched_for(P, lits)
        if total is None:
            return e
        return torch.minimum(torch.maximum(s + total - pos, s), e)

    def render(self, P, st, s, e, ctx):
        (pos,) = st
        y, _ = self._reloc(P, pos + ctx.idx - s, ctx.lits, li0=pos - s,
                           n=ctx.n)
        v = self._valid_end(P, ctx.lits, pos, s, e)
        y = torch.where(_mask(ctx, s, e), y, 0.0)
        return y, v, e, (pos + (e - s).clamp(min=0),)

    def advance(self, P, st, s, e, ctx):
        (pos,) = st
        return self._valid_end(P, ctx.lits, pos, s, e), \
            (pos + (e - s).clamp(min=0),)


def _bind_per_render(P) -> bool:
    """Whether a render gathers its plan from P anew: for a voice group,
    whose params are batched by vmap and live only for one render, and
    in a render that a CUDA graph captures, whose replays must gather
    from whatever params are copied into the graph's inputs then."""
    return torch._C._functorch.is_batchedtensor(P.consts) or (
        P.consts.is_cuda and torch.cuda.is_current_stream_capturing())


class _NotLiteral(Exception):
    """A leaf's length is not a literal for the given lits."""

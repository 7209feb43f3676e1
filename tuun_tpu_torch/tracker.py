"""The tracker: a batched polyphonic block renderer.

Port of tuun_tpu/tracker.py: pending voices promote when their start
sample is reached (late starts catch up by rendering and discarding,
tracker.rs:514-537; repeat_every reschedules a fresh copy, skipping
missed repetitions), and each block renders every active voice and mixes
on the device.  Voices of one compiled structure, `fast` flag and literal
Fin cutoffs (`lits`) form a VoiceGroup once two or more are active: the
group renders as one call (CompiledVoice.batched_render_fn,
torch.func.vmap over the voices, the scans on their voices x lanes
kernels).  Voices with an exactly known length retire at their end sample
without a read.  Each voice carries its `fast` flag and `lits`, resolved
at activation as tuun_tpu/tracker.py:846-897 does.

The streaming path, with the reference's names and rules:

  * Deferred sync (sync_interval > 1): valid ends, levels and capture
    slices queue on the device and resolve every sync_interval blocks,
    packed into one tensor whose copy to pinned host memory runs
    asynchronously (a CUDA event marks it landed; a fetch worker waits on
    it), and render_block returns the mix on the device.
    run_to_completion delivers blocks through one FIFO of such copies.
  * The fused session step: once the voice set has kept its structure
    for `fuse_after` blocks, every lone voice and every group renders in
    one step.  On the CPU the step runs as a plain closure, as JAX runs
    it unjitted; on CUDA it is captured once per voice-set key into a
    torch.cuda.CUDAGraph (engine/capture.py) and each block is one
    replay.  The capture runs on a worker (inline with fuse_blocking)
    while the per-voice path serves; a capture that fails raises on the
    thread that serves blocks.  The graph writes each member's new state
    back into its own inputs, so the members' states are its buffers
    between replays, and any path that keeps a state past a later
    replay clones it first (`_detach_states`).
  * Lookahead windows (deferred sync, K = lookahead or sync_interval):
    one render of K*n lanes per member serves the next K blocks; a play
    that starts inside the window, a modify or a stop interrupts it,
    replaying the served blocks from the window's untouched inputs.  A
    window never spans more than engine.graph.MAX_BLOCK lanes.
  * Window prefetch: the next window renders on a worker from this
    window's end states, and is adopted only if every member still has
    the params, state object and state generation it was built from.

Spans (spans.py): under a torch.profiler session the serve thread's
work is named on the profiler's clock: `tuun.tracker.run_to_completion`
(flush, copy_wait, concat), `tuun.tracker.render_block` (activate,
materialize, regroup; window_open holding prefetch_wait, window_dispatch
and prefetch_submit; window_serve, window_finalize; fused_render;
pervoice_render with a group_render per group or lone voice; sync with
stage_pending, copy_wait and retire), `tuun.tracker.stage_host`, and the
commands' phases (play, modify).  A window's spans carry its first
block's index.  The workers (prefetch, fetch, capture) enter spans of
their own, which only a session that records every thread keeps.  The
command phases of
`op_log` are the same spans' seconds.

Live edits (tuun_tpu/tracker.py:198-254, 715-825): Modify substitutes the
subtree under a mark and carries the state of every structurally
unchanged node into the recompiled voice (carry_state), so a slider ramp
or a note-off splices in without a click.  It interrupts an open window,
takes the groups' states back onto their voices (cloned off any captured
step's buffers first), and reads the stream position from the host.  A
spliced voice leaves the fast path, its literal cutoffs and exact
retirement: it retires by its valid end.  carry_state compares leaves by
shape and dtype; the JAX tracker compares shapes only, so where a sine's
frequency stops being constant (its u32 NCO phase becomes a float
phase) JAX carries the u32 word into the float slot and the port keeps
the fresh phase.

The mesh (tuun_tpu/tracker.py:302-519, parallel.py): Tracker(mesh=) lays
each group over a parallel.Mesh's voice axis (parallel.VoiceShards):
padded with voice 0 at weight 0, each voice shard's params and state on
its device, the partial mixes added on the tracker's device in shard
order.  A fast relocatable group on a time axis over 1 renders
lane-sharded.  Meshed groups never fuse, so a meshed tracker opens no
lookahead window while a group is live.
"""

from __future__ import annotations

import collections as _collections
import dataclasses as _dataclasses
import queue as _queue
import threading as _threading
import time as _time
from dataclasses import dataclass, field
from functools import partial
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import _threads, ir, native, oracle
from .spans import span, spanned
from .engine import CompiledVoice, EngineConfig, share_plan, structure_key
from .engine.capture import flatten, make_step, tree_clone
from .engine.graph import (MAX_BLOCK, check_device, stack_params, stack_tree,
                           tree_index)
from .metric import Metric
from .parallel import Mesh, VoiceShards
from .wav import write_wav_f32

# The helpers below are copied from tuun_tpu/tracker.py:40-166, which
# imports jax at module top.
MARK_LENGTH_CAP_SECONDS = 10  # tracker.rs process_marked's 10 * sample_rate
# Exact-retirement length probe cap (the native oracle resolves symbolic
# lengths in O(tree); a value-path Fin pays a generate pass to this cap).
RETIRE_LENGTH_CAP_SECONDS = 120
# Cached session steps (fused steps and windows), least recently used
# first out (tuun_tpu/tracker.py:1061).
STEP_CACHE_SIZE = 64


@dataclass
class Mark:
    waveform_id: Any
    mark_id: Any
    start: int       # absolute sample index
    duration: int    # samples


@dataclass
class Status:
    buffer_start: int
    marks: List[Mark] = field(default_factory=list)
    # A copy of the block's mix, when the tracker's send_current_buffer
    # was set for it (the reference UI's scope).
    buffer: Optional[np.ndarray] = None
    # Host seconds of the block's render over the block's audio seconds.
    tracker_load: Optional[float] = None
    voices: int = 0
    # Render calls issued this block: one per lone voice and one per
    # group, one for a fused step, one for the block that opens a
    # lookahead window and none for a block it serves (the reference's
    # allocations_per_sample analogue, tracker.rs:342-345).
    dispatches: int = 0
    # Per-voice (rms, peak), resolved at sync points, when the tracker was
    # built with levels=True.
    voice_levels: Dict[Any, Tuple[float, float]] = field(default_factory=dict)

    def has_pending_mark(self, when: int, wid, mark) -> bool:
        return any(m.waveform_id == wid and m.mark_id == mark and
                   m.start > when for m in self.marks)

    def has_active_mark(self, when: int, wid, mark) -> bool:
        return any(m.waveform_id == wid and m.mark_id == mark and
                   m.start <= when for m in self.marks)


def _subtree_length(node: ir.Waveform, sample_rate: int, cap: int) -> int:
    """Producible length of a fresh copy of `node`, up to cap samples,
    from the native C++ oracle when it builds, else the Python one."""
    if native.native_available():
        return native.NativeOracle(node, sample_rate).length(cap)
    o = oracle.Oracle(sample_rate)
    return o.length(oracle.initialize(node), cap)


def _voice_total_length(w: ir.Waveform, sample_rate: int) -> Optional[int]:
    """Exact producible length of a fresh voice, or None when infinite,
    longer than the retirement cap, or the native oracle is missing."""
    if not native.native_available():
        return None
    cap = RETIRE_LENGTH_CAP_SECONDS * sample_rate
    ln = native.NativeOracle(w, sample_rate).length(cap)
    return None if ln >= cap else int(ln)


def collect_marks(w: ir.Waveform, sample_rate: int, waveform_id,
                  start: int) -> List[Mark]:
    """Walks the IR collecting Marked spans (port of process_marked)."""
    out: List[Mark] = []
    cap = MARK_LENGTH_CAP_SECONDS * sample_rate

    def walk(node: ir.Waveform, start: int) -> None:
        if isinstance(node, (ir.Const, ir.Time, ir.Noise, ir.Fixed)):
            return
        if isinstance(node, ir.Append):
            walk(node.a, start)
            walk(node.b, start + _subtree_length(node.a, sample_rate, cap))
            return
        if isinstance(node, ir.Marked):
            ln = _subtree_length(node.waveform, sample_rate, cap)
            out.append(Mark(waveform_id, node.id, start, ln))
            walk(node.waveform, start)
            return
        if isinstance(node, (ir.Reset, ir.Alt)):
            walk(node.trigger, start)
            return
        if isinstance(node, (ir.Fin, ir.Filter)):
            # Only the inner waveform is walked (tracker.rs:246-253).
            walk(node.waveform, start)
            return
        for child in node.children():
            walk(child, start)

    walk(w, start)
    return out


# Mark-id sets memoized by waveform object identity: a slider move calls
# modify() once per live voice, and the no-op guard must not walk each
# voice's whole tree per call.  An entry holds the waveform, so its id()
# key stays valid while the entry lives; the dict is bounded, oldest out.
_MARK_IDS_CACHE: Dict[int, Tuple[ir.Waveform, frozenset]] = {}
_MARK_IDS_CACHE_MAX = 512


def _mark_ids(w: ir.Waveform) -> frozenset:
    """All Marked ids anywhere in `w`, Fin lengths and filter
    coefficients included (collect_marks skips those for Status parity,
    but they are valid Modify targets)."""
    key = id(w)
    hit = _MARK_IDS_CACHE.get(key)
    if hit is not None and hit[0] is w:
        return hit[1]
    ids = frozenset(x.id for x in w.walk() if isinstance(x, ir.Marked))
    if len(_MARK_IDS_CACHE) >= _MARK_IDS_CACHE_MAX:
        _MARK_IDS_CACHE.pop(next(iter(_MARK_IDS_CACHE)))
    _MARK_IDS_CACHE[key] = (w, ids)
    return ids


class _CompileCache:
    """Per-structure compile cache: same-shaped waveforms with the same
    sharing plan (engine share_plan: which of their subtrees render once)
    share one CompiledVoice.  get() may run on more than one thread (the
    reference compiles ahead on a prewarm worker beside the serve
    thread), so two racing threads converge on one CompiledVoice."""

    def __init__(self):
        self._cache: Dict[Tuple, CompiledVoice] = {}
        self._lock = _threading.Lock()

    def get(self, w: ir.Waveform, cfg: EngineConfig,
            plan=None) -> CompiledVoice:
        """The CompiledVoice of `w`; `plan` as CompiledVoice takes it."""
        if plan is None:
            plan = share_plan(w, cfg)
        key = (structure_key(w, cfg.sample_rate), plan, cfg.sample_rate,
               cfg.precision, str(cfg.device), cfg.timeline, cfg.reloc_fast)
        voice = self._cache.get(key)
        if voice is None:
            voice = CompiledVoice(w, cfg, plan)
            with self._lock:
                voice = self._cache.setdefault(key, voice)
        return voice


def _shapes_match(a, b) -> bool:
    """Whether two state trees have the same leaves in shape and dtype."""
    la, lb = flatten(a)[1], flatten(b)[1]
    return len(la) == len(lb) and all(
        x.shape == y.shape and x.dtype == y.dtype for x, y in zip(la, lb))


def carry_state(old_w: ir.Waveform, new_w: ir.Waveform, old_state,
                new_state, replaced_mark=None):
    """Maps generation state from an old waveform's tree onto a new one:
    structurally matching nodes keep their state, the subtree under the
    substituted mark (and any changed subtree) keeps the fresh state.
    The functional analogue of the reference's in-place substitute on a
    stateful tree (tracker.rs:415-460): untouched nodes play on without a
    click.  The node layouts are the engine's: a node's own fields first,
    its children's states after in children() order, and the filter's
    (delay, real, hist, inner, ffs, fbs)."""
    if type(old_w) is not type(new_w):
        return new_state
    if isinstance(new_w, (ir.Marked, ir.Captured)):
        if isinstance(new_w, ir.Marked) and replaced_mark is not None \
                and new_w.id == replaced_mark:
            return new_state  # the substituted subtree starts fresh
        return carry_state(old_w.waveform, new_w.waveform, old_state,
                           new_state, replaced_mark)
    ok = old_w.children()
    nk = new_w.children()
    if len(ok) != len(nk):
        return new_state
    if isinstance(new_w, ir.Filter):
        delay, real, hist, osi, osffs, osfbs = old_state
        ndelay, nreal, nhist, nsi, nsffs, nsfbs = new_state
        si = carry_state(old_w.waveform, new_w.waveform, osi, nsi,
                         replaced_mark)
        sffs = tuple(carry_state(o, nw, os_, ns_, replaced_mark)
                     for o, nw, os_, ns_ in zip(
                         old_w.feed_forward, new_w.feed_forward, osffs, nsffs))
        sfbs = tuple(carry_state(o, nw, os_, ns_, replaced_mark)
                     for o, nw, os_, ns_ in zip(
                         old_w.feedback, new_w.feedback, osfbs, nsfbs))
        keep = _shapes_match((delay, real, hist), (ndelay, nreal, nhist))
        own = (delay, real, hist) if keep else (ndelay, nreal, nhist)
        return own + (si, sffs, sfbs)
    if not isinstance(new_state, tuple) or not isinstance(old_state, tuple) \
            or len(old_state) != len(new_state):
        return new_state
    n_own = len(new_state) - len(nk)
    out = []
    for i, (os_, ns_) in enumerate(zip(old_state, new_state)):
        if i < n_own:
            out.append(os_ if _shapes_match(os_, ns_) else ns_)
        else:
            ci = i - n_own
            out.append(carry_state(ok[ci], nk[ci], os_, ns_, replaced_mark))
    return tuple(out)


@dataclass
class Voice:
    """One active waveform on the tracker."""

    id: Any
    waveform: ir.Waveform
    compiled: CompiledVoice
    params: Any
    state: Any
    start: int
    marks: List[Mark]
    captures: Dict[str, List[np.ndarray]] = field(default_factory=dict)
    finished: bool = False
    # Exact total length in samples when known: the voice retires at
    # start + total_len without reading its valid end.
    total_len: Optional[int] = None
    # Renders through the relocatable fast path (reloc_block).
    fast: bool = False
    # Literal Fin cutoffs: the fast path's lengths and timeline schedules.
    lits: Optional[Tuple[int, ...]] = None
    # Host copy of the seed, set at activation: Modify reads it instead of
    # params.seed, which lives on the card.
    host_seed: Optional[int] = None
    # Last resolved output levels (levels=True trackers).
    level_rms: float = 0.0
    level_peak: float = 0.0
    # Valid samples the engine reported for this voice: v - s summed over
    # its resolved renders, up to and including the first that ended
    # short of its extent (`ended`).
    produced: int = 0
    ended: bool = False
    # Bumped on every change of `state`, in place (a fused replay) or not.
    gen: int = 0
    # The absolute sample from which the voice renders in its settled
    # form (CompiledVoice.settled_from past its start), or None: never
    # (no fold, the fast path, a splice).
    settle_at: Optional[int] = None
    # Deferred-sync queues: (valid_end, s, e) device scalars, capture
    # dicts and (rms, peak) pairs awaiting the next sync point.
    _pending_v: List = field(default_factory=list)
    _pending_caps: List = field(default_factory=list)
    _pending_levels: List = field(default_factory=list)


@dataclass
class Pending:
    id: Any
    waveform: ir.Waveform
    start: int
    repeat_every: Optional[int]
    marks: List[Mark]


def _append_capture(voice: Voice, stem: str, cy, cs, cv) -> None:
    """Appends one capture window's valid slice [cs, cv) to the voice's
    stem buffers."""
    cs_i, cv_i = int(cs), int(cv)
    if cv_i > cs_i:
        voice.captures.setdefault(stem, []).append(
            cy[cs_i:cv_i].cpu().numpy())


def _levels(y: torch.Tensor, dim=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rms, peak) of a block's samples, on the device."""
    if dim is None:
        return torch.sqrt(torch.mean(y * y)), torch.max(torch.abs(y))
    return (torch.sqrt(torch.mean(y * y, dim=dim)),
            torch.max(torch.abs(y), dim=dim).values)


def _note_valid(voice: Voice, v, s: int, e: int) -> None:
    """Accounts one resolved render of `voice`: v its valid end, [s, e)
    the interval it was asked for."""
    if not voice.ended:
        voice.produced += max(int(v) - int(s), 0)
        voice.ended = int(v) < int(e)
    if int(v) < int(e):
        voice.finished = True


def _resolve_single(voice: Voice, v, s: int, e: int, caps, lv=None) -> None:
    """Finish detection, levels and capture slicing for one rendered
    block: one host read of the voice's valid end (and its levels)."""
    if lv is None:
        vv = int(v)
    else:
        vv, voice.level_rms, voice.level_peak = torch.stack(
            [v.double(), lv[0].double(), lv[1].double()]).tolist()
    _note_valid(voice, vv, s, e)
    for stem, (cy, cs, cv) in caps.items():
        _append_capture(voice, stem, cy, cs, cv)


def _start_host_copies(x: torch.Tensor):
    """Starts the copy of `x` to host memory without waiting for it:
    (host tensor, event, x), the event recorded after the copy into
    pinned memory, and `x` kept referenced until the event has passed.
    On the CPU, x is its own host copy and there is no event."""
    if not x.is_cuda:
        return (x, None, None)
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    host.copy_(x, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return (host, event, x)


def _staged_ready(staged) -> bool:
    """Non-blocking: has the staged copy landed?  (A host block, with no
    event, always has.)"""
    event = staged[1] if len(staged) > 1 else None
    return event is None or event.query()


def _staged_host(staged) -> np.ndarray:
    """The staged copy as numpy, once it has landed (blocking)."""
    host = staged[0]
    event = staged[1] if len(staged) > 1 else None
    if event is not None:
        event.synchronize()
    return host.numpy() if isinstance(host, torch.Tensor) else host


def _pack(xs: List[torch.Tensor]) -> torch.Tensor:
    """The deferred scalars (valid ends, levels) as one float64 vector:
    valid ends are at most MAX_BLOCK, exact in float32 and float64."""
    return torch.cat([x.reshape(-1) for x in xs]).to(torch.float64)


def _params_of(m):
    return m.params if isinstance(m, Voice) else m.bparams


def _state_of(m):
    return m.state if isinstance(m, Voice) else m.bstate


def _set_state(m, state) -> None:
    if isinstance(m, Voice):
        m.state = state
    else:
        m.bstate = state
    m.gen += 1


def _settled(member, fast: bool, block_start: int) -> bool:
    """Whether a lone voice or a group renders in its settled form from
    block_start on (never on the fast path, which renders no node)."""
    return not fast and member.settle_at is not None \
        and block_start >= member.settle_at


class VoiceGroup:
    """Same-structure voices rendered as one call (tuun_tpu/tracker.py:302-
    519).

    Params and states stay stacked between blocks; membership changes
    (activation, retirement) rebuild the group.  The mix sums on the
    device, so a block costs one render call whatever the polyphony, and
    the group's valid ends come back in one host copy.  With a mesh the
    voices lay out over its voice axis (parallel.VoiceShards): `shards`
    holds each voice shard's params and weights on its devices, bstate is
    a tuple of the shards' states, and a block costs one render call per
    shard (per time shard on the lane-sharded path)."""

    def __init__(self, compiled: CompiledVoice, voices: List[Voice],
                 mesh: Optional[Mesh] = None):
        self.compiled = compiled
        self.voices = voices
        self.fast = all(v.fast for v in voices)
        # Voices group by (compiled, fast, lits), so lits is uniform; it
        # also drives the stateful timeline-schedule path (non-fast).
        self.lits = voices[0].lits
        self.mesh = mesh
        if mesh is None:
            self.shards = None
            self.bparams = stack_params([v.params for v in voices])
            self.bstate = stack_tree([v.state for v in voices])
        else:
            self.shards = VoiceShards(compiled, [v.params for v in voices],
                                      mesh, compiled.cfg.device)
            self.bparams = None  # the shards hold them
            self.bstate = self.shards.stack_states([v.state for v in voices])
        self.gen = 0
        # Every voice settled from this sample on (None: some never).
        ends = [v.settle_at for v in voices]
        self.settle_at = None if None in ends else max(ends)
        # (valid_end[B], caps, levels, starts, e) per deferred render (e:
        # the render's extent, block_size or K*n for a window).
        self._pending: List = []
        self._fns: Dict[Tuple[int, bool], Callable] = {}
        self._args = None  # ((starts, e), device starts, device e)

    def render(self, n: int, starts, e: int, levels: bool = False):
        """(mix[n], v[B], captures, (rms[B], peak[B]) or None)."""
        if self.mesh is not None:
            return self._render_meshed(n, starts, e, levels)
        fn = self._fns.get((n, levels))
        if fn is None:
            fn = self._fns[(n, levels)] = self._levels_render_fn(n) \
                if levels else self.compiled.batched_render_fn(
                    n, fast=self.fast, lits=self.lits)
        key = (tuple(starts), e)
        if self._args is None or self._args[0] != key:
            dev = self.bparams.device
            self._args = (key, torch.tensor(key[0], dtype=torch.int64,
                                            device=dev),
                          torch.full((), e, dtype=torch.int64, device=dev))
        _, starts_dev, e_dev = self._args
        lv = None
        if levels:
            y_sum, v, bstate, caps, rms, peak = fn(
                self.bparams, self.bstate, starts_dev, e_dev)
            lv = (rms, peak)
        else:
            y_sum, v, bstate, caps = fn(self.bparams, self.bstate,
                                        starts_dev, e_dev)
        _set_state(self, bstate)
        return y_sum, v, caps, lv

    def _levels_render_fn(self, n: int):
        """The batched render that also reduces each voice's rms and peak
        on the device (one extra pair of reductions per block)."""
        compiled = self.compiled
        render = compiled.batched_render_fn(n, fast=self.fast, lits=self.lits,
                                            mix=False)

        def batched(bp, bs, starts, e):
            y, v, st, caps = render(bp, bs, starts, e)
            rms, peak = _levels(y, dim=1)
            return y.sum(0), v, st, caps, rms, peak
        return batched

    def _render_meshed(self, n: int, starts, e: int, levels: bool):
        """The mesh branch of render: lane-sharded exactly when
        tuun_tpu's condition holds (tuun_tpu/tracker.py:354-360), v and
        the levels trimmed to the real voices."""
        fn = self._fns.get((n, levels))
        if fn is None:
            T = self.mesh.shape.get("time", 1)
            lane = (self.fast and self.compiled.relocatable
                    and isinstance(self.lits, tuple) and T > 1
                    and n % T == 0)
            fn = self._fns[(n, levels)] = self._meshed_fast_fn(n, levels) \
                if lane else self._meshed_render_fn(n, levels)
        key = (tuple(starts), e)
        if self._args is None or self._args[0] != key:
            self._args = (key, self.shards.args(starts, e))
        y_sum, v, bstate, caps, lv = fn(self.bstate, self._args[1])
        _set_state(self, bstate)
        return y_sum, v, caps, lv

    def _meshed_fast_fn(self, n: int, levels: bool):
        """The lane-sharded render of a fast relocatable group: each time
        shard evaluates the group's reloc at its own lane window; levels
        add the time shards' sums of squares and take their max."""
        return self.shards.lane_fn(n, self.lits, levels)

    def _meshed_render_fn(self, n: int, levels: bool = False):
        """The group's render with the voice axis sharded: each voice
        shard renders its rows on its device and the partial mixes add in
        shard order; levels reduce each row within its shard."""
        return self.shards.render_fn(
            n, self.fast, self.lits,
            partial(_levels, dim=1) if levels else None)

    def resolve(self, v, caps, starts, e: int, lv=None) -> None:
        """Finish detection, levels and captures for every member from
        one host copy of the group's valid ends (and levels)."""
        rows = [v.double()]
        if lv is not None:
            rows += [lv[0].double(), lv[1].double()]
        data = torch.stack(rows).tolist()
        for i, voice in enumerate(self.voices):
            _note_valid(voice, data[0][i], starts[i], e)
            if lv is not None:
                voice.level_rms, voice.level_peak = data[1][i], data[2][i]
            for stem, (cy, cs, cv) in caps.items():
                _append_capture(voice, stem, cy[i], cs[i], cv[i])

    def materialize_states(self) -> None:
        """Each voice's row of the group's state, onto the voice: on a
        mesh, copied from its shard to the tracker's device."""
        for i, voice in enumerate(self.voices):
            _set_state(voice, tree_index(self.bstate, i) if self.mesh is None
                       else self.shards.voice_state(self.bstate, i))


class Tracker:
    """Owns active + pending voices and renders mixed blocks."""

    def __init__(self, sample_rate: int, block_size: int = 1024,
                 captured_output_dir: str | Path = ".",
                 captured_date_format: str = "_%Y-%m-%d_%H-%M-%S",
                 precision: str = "fast", device="cuda",
                 levels: bool = False, sync_interval: int = 1,
                 jit: bool = True, seed: int = 0,
                 mesh: Optional[Mesh] = None):
        self.sample_rate = sample_rate
        self.block_size = block_size
        self.captured_output_dir = Path(captured_output_dir)
        self.captured_date_format = captured_date_format
        self.cfg = EngineConfig(sample_rate, precision, device)
        if mesh is not None and mesh.device_type != self.cfg.device.type:
            raise ValueError(f"a {mesh.device_type} mesh for a tracker on "
                             f"{self.cfg.device}")
        check_device(self.cfg.device)
        # Optional parallel.Mesh: voice groups lay their voices over its
        # voice axis; the mix stays on cfg.device.
        self.mesh = mesh
        self.cache = _CompileCache()
        self.active: List[Voice] = []
        self.pending: List[Pending] = []
        self.now: int = 0  # next sample to be rendered
        # Set to copy the next block's mix into its Status.buffer.
        self.send_current_buffer = False
        # Voice seeds seed+1, seed+2, ... as in tuun_tpu.  Only the thread
        # that renders blocks takes them (a Player's bakes take none).
        self._seed_counter = seed
        self._groups: List[VoiceGroup] = []
        self._singles: List[Voice] = []
        self._groups_dirty = True
        # Blocks to pipeline between host syncs (> 1: streaming mode;
        # retirement and captures resolve lazily).
        self.sync_interval = max(1, sync_interval)
        self._since_sync = 0
        # While every activated voice had a known total length, known_end
        # is the last sample any voice produces.
        self._ends_known = True
        self._last_end = 0
        # Per-voice rms/peak of every block (the reference UI's levels);
        # off by default: one more reduction pair per render call.
        self.report_levels = levels
        # Ring-buffer series of tracker_load and dispatches per block (the
        # reference's HUD graphs, tracker.rs:342-345).
        self.load_metric = Metric()
        self.dispatch_metric = Metric()
        # The fused session step: once the set keeps its structure for
        # fuse_after blocks, the whole set renders as one step, one CUDA
        # graph replay on the card.  Any set change falls back to the
        # per-voice path at once; the step stays cached per set key.
        # jit=False turns it off, as the JAX tracker's unjitted mode does
        # (the port has no jit to turn off).
        self.fuse = jit
        self.fuse_after = 2
        # True: capture inline instead of on a worker (deterministic
        # engagement for tests; live streams keep False).
        self.fuse_blocking = False
        self._fuse_key = None
        self._fuse_count = 0
        self._fused_cache: Dict[Any, Dict[str, Any]] = {}
        # Evicted steps, closed once the card is past their last replay.
        self._retired_steps: List[Dict[str, Any]] = []
        self._capture_threads: List[_threading.Thread] = []
        # The captured fused step whose state buffers the members of
        # _bound_members hold as their states (see _detach_states).
        self._bound = None
        self._bound_members: List = []
        # Lookahead: steady-state streaming renders this many blocks per
        # render (None: sync_interval); a play that starts inside the
        # window interrupts it with exact block granularity.
        self.lookahead: Optional[int] = None
        self._window: Optional[Dict[str, Any]] = None
        # Window prefetch: the next window renders on a worker as soon as
        # one opens, and is adopted only if its inputs are still current.
        self.prefetch_windows = True
        self._prefetch: Optional[Dict[str, Any]] = None
        # Counters of the session steps: captures started and finished,
        # graph replays (the prefetch worker's included), windows opened,
        # and windows adopted from the prefetch (hits) or rendered inline
        # after a prefetch was found stale or not yet started (misses).
        self.captures_started = 0
        self.captures_finished = 0
        self.capture_seconds: List[float] = []  # each finished capture's
        self.replays = 0
        self.window_opens = 0
        self.prefetch_hits = 0
        self.prefetch_misses = 0
        self._count_lock = _threading.Lock()
        # Command-path phase log: every play, modify, activation and costly
        # window open appends (op, block_index, total_seconds,
        # {phase: seconds}), each phase timed by its span.
        self.op_log: _collections.deque = _collections.deque(maxlen=256)
        self._staged_q: List = []
        # (window, block, k) of the block render_block last served from a
        # lookahead window, for stage_host.
        self._served = None
        self._fetch_thread: Optional[_threading.Thread] = None
        self._prefetch_thread: Optional[_threading.Thread] = None

    @property
    def known_end(self) -> Optional[int]:
        """The exact final sample of everything played so far, when every
        voice's length was statically known; None otherwise."""
        return self._last_end if self._ends_known else None

    def status_snapshot(self) -> Status:
        """A Status of the current voice tables without rendering a
        block."""
        return self._status(self.now)

    def _status(self, buffer_start: int) -> Status:
        status = Status(buffer_start=buffer_start, voices=len(self.active))
        for voice in self.active:
            status.marks.extend(voice.marks)
        for p in self.pending:
            status.marks.extend(p.marks)
        return status

    def _count(self, name: str, k: int = 1) -> None:
        with self._count_lock:
            setattr(self, name, getattr(self, name) + k)

    # -- commands ------------------------------------------------------

    @spanned("tracker.play")
    def play(self, wid, waveform: ir.Waveform, start: Optional[int] = None,
             repeat_every: Optional[int] = None) -> None:
        if repeat_every is not None and repeat_every <= 0:
            # A non-positive period would spin the missed-repetition
            # catch-up loop forever: play once instead.
            repeat_every = None
        start = self.now if start is None else start
        t0 = _time.perf_counter()
        phases: Dict[str, float] = {}
        if self._window is not None and start < \
                self._window["start"] + self._window["K"] * self.block_size:
            with span("tracker.interrupt", phases):
                self._interrupt_window()
        with span("tracker.marks", phases):
            marks = collect_marks(waveform, self.sample_rate, wid, start)
        self.pending.append(Pending(wid, waveform, start, repeat_every,
                                    marks))
        self.pending.sort(key=lambda p: p.start)
        self.op_log.append(("play", self.now // self.block_size,
                            _time.perf_counter() - t0, phases))

    @spanned("tracker.modify")
    def modify(self, wid, mark_id, new_waveform: ir.Waveform) -> None:
        """Replaces the subtree under `mark_id` in voice `wid` (active and
        pending), carrying the state of every unchanged node.

        A voice whose waveform does not hold the mark is untouched:
        callers fan commands out (a slider move reaches every live id),
        and a no-op splice would still drop the voice off the fast path
        and exact retirement for good."""

        def has_mark(w):
            return mark_id in _mark_ids(w)

        if not any(v.id == wid and has_mark(v.waveform)
                   for v in self.active) and \
                not any(p.id == wid and has_mark(p.waveform)
                        for p in self.pending):
            return
        t0 = _time.perf_counter()
        phases: Dict[str, float] = {}
        with span("tracker.interrupt", phases):
            self._interrupt_window()
        # The states, not the valid ends in flight: those go to the fetch
        # worker (a voice whose end is still in flight gets a harmless
        # splice: it renders zeros and retires at a later sync).  The
        # groups' states come back onto their voices, cloned off any
        # captured step's buffers, so no later replay reaches what is
        # carried below.
        with span("tracker.materialize", phases):
            self._materialize_groups(drain=False)
        for voice in self.active:
            if voice.id != wid or not has_mark(voice.waveform):
                continue
            with span("tracker.splice", phases):
                new_w = ir.substitute(voice.waveform, mark_id, new_waveform)
                # The splice starts the new subtree fresh and carries the
                # rest: the twins of a share class may then hold unequal
                # states, so the spliced voice shares nothing.
                compiled = self.cache.get(new_w, self.cfg, plan=())
                # and folds nothing: the fresh subtree's Time nodes stand
                # at other positions than the voice's.
                voice.settle_at = None
                old_compiled = voice.compiled
                needs_replay = voice.fast or old_compiled._has_timeline
                if old_compiled._has_timeline or compiled._has_timeline:
                    # A timeline keeps one position per score, and a
                    # subtree that starts fresh mid-stream has no place in
                    # a literal schedule: compile both sides as plain trees
                    # (the same const order, so params and carry_state line
                    # up) and rebuild the old tree's state by replay.
                    plain = _dataclasses.replace(self.cfg, timeline=False)
                    compiled = self.cache.get(new_w, plain, plan=())
                    old_compiled = self.cache.get(voice.waveform, plain)
                params = compiled.params_for(new_w, seed=voice.host_seed)
            old_pos, old_rst = voice.state
            if needs_replay:
                # The fast path and the timeline schedule never advance
                # the node tree: rebuild it at the stream position, which
                # the host knows (every render advances it by its extent,
                # a late start catches up at activation, and the
                # interrupt above replayed to the serve point).  Replay in
                # large blocks (block-size invariance is an engine
                # contract): one render a served block since sample 0
                # would cost a long-lived voice's first edit dearly.
                with span("tracker.state_at", phases):
                    old_rst = old_compiled.state_at(
                        voice.params, self.now - voice.start,
                        max(8192, self.block_size))
                voice.fast = False
            voice.lits = None
            with span("tracker.carry", phases):
                _, fresh_rst = compiled.init(params)
                _set_state(voice, (old_pos, carry_state(
                    voice.waveform, new_w, old_rst, fresh_rst,
                    replaced_mark=mark_id)))
            voice.waveform = new_w
            voice.compiled = compiled
            voice.params = params
            with span("tracker.marks", phases):
                voice.marks = collect_marks(new_w, self.sample_rate,
                                            voice.id, voice.start)
            # A subtree that starts mid-stream makes the voice's length
            # unreadable from the IR (a stop ramp shortens it): retire by
            # the valid end.
            voice.total_len = None
            self._ends_known = False
        for p in self.pending:
            if p.id == wid and has_mark(p.waveform):
                p.waveform = ir.substitute(p.waveform, mark_id, new_waveform)
                p.marks = collect_marks(p.waveform, self.sample_rate, p.id,
                                        p.start)
        self.op_log.append(("modify", self.now // self.block_size,
                            _time.perf_counter() - t0, phases))

    def remove_pending(self, wid) -> None:
        # No window interrupt: a window opens only when every pending
        # voice starts at or after its end.
        self.pending = [p for p in self.pending if p.id != wid]

    def stop_all(self) -> None:
        self._interrupt_window()
        self._sync_voices()
        self._detach_states()
        for voice in self.active:
            self._close_voice(voice)
        self.active = []
        self.pending = []
        self._groups = []
        self._singles = []
        self._groups_dirty = True

    # -- rendering -----------------------------------------------------

    @spanned("tracker.activate")
    def _activate(self, p: Pending, block_start: int) -> Voice:
        """The voice of `p`, its phases logged: compile (the structure's
        CompiledVoice, built on a cache miss), params, init, lits, length
        and, for a late start, catchup."""
        t0 = _time.perf_counter()
        phases: Dict[str, float] = {}
        with span("tracker.compile", phases):
            compiled = self.cache.get(p.waveform, self.cfg)
        with span("tracker.params", phases):
            self._seed_counter += 1
            params = compiled.params_for(p.waveform, seed=self._seed_counter)
        with span("tracker.init", phases):
            state = compiled.init(params)
        with span("tracker.lits", phases):
            fast = compiled.fast_default
            lits = compiled.lits_for(params) \
                if fast or compiled._has_timeline else None
            voice = Voice(p.id, p.waveform, compiled, params, state, p.start,
                          list(p.marks), fast=fast, lits=lits,
                          host_seed=self._seed_counter)
            # The fold plan's local sample, like the lits read on the host
            # from the params.
            settled = None if fast else compiled.settled_from(params)
            voice.settle_at = None if settled is None else p.start + settled
        # Exact retirement: the symbolic length of a relocatable
        # structure, else the oracle's length() (generator.rs:787-862).
        with span("tracker.length", phases):
            total = compiled.symbolic_len(params, lits)
            if total is None:
                total = _voice_total_length(p.waveform, self.sample_rate)
        voice.total_len = total
        if total is None:
            self._ends_known = False
        else:
            self._last_end = max(self._last_end, p.start + total)
        delta = block_start - p.start
        if delta > 0:
            # Late start: render and discard the missed span
            # (tracker.rs:514-537); captures are kept.
            with span("tracker.catchup", phases):
                off = 0
                while off < delta and not voice.finished:
                    m = min(self.block_size, delta - off)
                    self._render_voice(voice, m, 0)
                    off += m
        self.op_log.append(("activate", block_start // self.block_size,
                            _time.perf_counter() - t0, phases))
        return voice

    def _render_voice(self, voice: Voice, e: int, s: int,
                      defer: bool = False) -> torch.Tensor:
        """One block for one voice; returns its samples on the device.
        With defer=True nothing is read: the valid end, levels and
        capture slices queue on the voice until the next sync point
        (samples past a voice's end are zeros, so the mix needs no
        host-side finish knowledge)."""
        y, v, state, caps = voice.compiled.render_block(
            voice.params, voice.state, self.block_size, s, e,
            fast=voice.fast, lits=voice.lits)
        _set_state(voice, state)
        if defer:
            voice._pending_v.append((v, s, e))
            if self.report_levels:
                voice._pending_levels.append(_levels(y))
            if caps:
                voice._pending_caps.append(caps)
            return y
        _resolve_single(voice, v, s, e, caps,
                        _levels(y) if self.report_levels else None)
        return y

    def _materialize_groups(self, drain: bool = True) -> None:
        """Writes each group's stacked state back onto its voices and
        drops the groups; the next block regroups (tuun_tpu/tracker.py:
        700-713).  drain=False leaves the staged valid ends to the fetch
        worker: a voice whose finish is still in flight stays active a
        few blocks longer, rendering zeros, and retires at the next sync."""
        self._sync_voices(drain=drain)
        self._detach_states()
        for g in self._groups:
            g.materialize_states()
        self._groups = []
        self._singles = []
        self._groups_dirty = True

    def _rebuild_groups(self) -> None:
        """Regroups the active voices by (compiled structure, fast, lits):
        groups of two or more render as one call, a lone voice on its own
        (tuun_tpu/tracker.py:1832-1856).  Existing groups write their
        stacked state back first, or a regroup would rewind them."""
        self._detach_states()
        for g in self._groups:
            g.materialize_states()
        by_key: Dict[Tuple, List[Voice]] = {}
        for voice in self.active:
            by_key.setdefault((id(voice.compiled), voice.fast, voice.lits),
                              []).append(voice)
        self._groups = []
        self._singles = []
        for voices in by_key.values():
            if len(voices) >= 2:
                self._groups.append(VoiceGroup(voices[0].compiled, voices,
                                               mesh=self.mesh))
            else:
                self._singles.extend(voices)
        self._groups_dirty = False

    def _members(self) -> List:
        return list(self._singles) + list(self._groups)

    def _detach_states(self) -> None:
        """Gives every member that holds the bound fused step's state
        buffers as its state a clone of them, so that no later replay of
        the step (for this set or another of its key) changes a state
        that something else holds: a group's materialized rows are views
        of its state."""
        step, self._bound = self._bound, None
        for m, static in zip(self._bound_members,
                             step.static_states if step else ()):
            if _state_of(m) is static:
                _set_state(m, tree_clone(static))
        self._bound_members = []

    # -- the fused session step ------------------------------------------

    def _group_fast_lits(self, g: VoiceGroup):
        """The (fast, lits) normalization batched_render_fn applies."""
        return g.compiled._resolve_fast(g.fast, None, g.lits)

    def _fused_set_key(self, n: int):
        """The identity of the current voice set's structure for the
        fused step, or None when fusing does not apply (meshed groups
        keep their own renders; a lone member saves no dispatch, unless
        lookahead windows can engage).  Each member's part ends with
        whether it renders in its settled form from the next block on
        (one comparison a member): a set's key changes once as its
        members settle, and its settled steps are captured beside the
        others."""
        if any(g.mesh is not None for g in self._groups):
            return None
        members = len(self._singles) + len(self._groups)
        if members == 0:
            return None
        if members < 2 and self._lookahead() <= 1:
            return None
        block_start = self.now
        parts = []
        for v in self._singles:
            fast, lits = v.compiled._resolve_fast(v.fast, v.params, v.lits)
            parts.append(("s", id(v.compiled), fast, lits,
                          _settled(v, fast, block_start)))
        for g in self._groups:
            fast, lits = self._group_fast_lits(g)
            parts.append(("g", id(g.compiled), fast, lits, len(g.voices),
                          _settled(g, fast, block_start)))
        return (n, self.report_levels, tuple(parts))

    def _member_impls(self, n: int, key):
        """Each member's render of n lanes with its slice of the scalars
        vector [e, starts...], in the form its part of `key` says:
        (kind, render, first, end)."""
        impls = []
        i = 1
        settled = iter(part[-1] for part in key[2])
        for v in self._singles:
            fast, lits = v.compiled._resolve_fast(v.fast, v.params, v.lits)
            impls.append(("s", v.compiled.render_fn(
                n, fast, lits, settled=next(settled)), i, i + 1))
            i += 1
        for g in self._groups:
            fast, lits = self._group_fast_lits(g)
            B = len(g.voices)
            impls.append(("g", g.compiled.batched_render_fn(
                n, fast=fast, lits=lits, mix=False, settled=next(settled)),
                i, i + B))
            i += B
        return impls

    def _build_fused_step(self, n: int, key):
        """One step rendering every current member (lone voices, then
        groups under torch.func.vmap, as batched_render_fn does) and
        mixing in member order on the device, so its bits are the
        per-voice path's (tuun_tpu/tracker.py:989-1036)."""
        impls = self._member_impls(n, key)
        levels = self.report_levels

        def step(params, states, sc):
            e = sc[0]
            acc = None
            new, outs = [], []
            for (kind, impl, a, b), P, st in zip(impls, params, states):
                if kind == "s":
                    y, v, st2, caps = impl(P, st, sc[a], e)
                    mixed = y
                else:
                    y, v, st2, caps = impl(P, st, sc[a:b], e)
                    mixed = y.sum(0)
                acc = mixed if acc is None else acc + mixed
                lv = _levels(y, None if kind == "s" else 1) \
                    if levels else None
                new.append(st2)
                outs.append((v, caps, lv))
            return tuple(new), (acc, outs)
        return step

    def _async_compiled(self, cache_key, build, carry: bool,
                        scalars: Tuple[int, ...]) -> Optional[Any]:
        """The session step of `cache_key`, or None while its CUDA graph
        is being captured (the caller serves through the per-voice path
        meanwhile, tuun_tpu/tracker.py:1038-1091).  The closure and the
        graph's static inputs are built on the calling thread; only the
        warm-up and capture run on the worker.  On the CPU the step is the
        plain closure, at once.  A failed capture raises here."""
        ent = self._fused_cache.get(cache_key)
        if ent is not None:
            # True LRU: the entry in use is never the next victim.
            self._fused_cache[cache_key] = self._fused_cache.pop(cache_key)
        else:
            self._collect_retired()
            if len(self._fused_cache) >= STEP_CACHE_SIZE:
                victim = next(iter(self._fused_cache))
                self._retire_step(self._fused_cache.pop(victim))
            members = self._members()
            step = make_step(build(), tuple(_params_of(m) for m in members),
                             tuple(_state_of(m) for m in members), scalars,
                             carry)
            ent = {"fn": None, "error": None, "step": step}
            self._fused_cache[cache_key] = ent
            if not step.captured:
                ent["fn"] = step
                return step
            self._count("captures_started")

            def work():
                try:
                    with span("capture.step"):
                        step.capture()
                    ent["fn"] = step
                    self._count("captures_finished")
                    self.capture_seconds.append(step.capture_seconds)
                except Exception as e:  # raised on the serve thread
                    ent["error"] = e

            if self.fuse_blocking:
                work()
            else:
                t = _threading.Thread(target=work, daemon=True,
                                      name="tuun-capture")
                # Joined at interpreter shutdown: a capture torn down
                # inside CUDA would abort the process.
                _threads.track_thread(t)
                self._capture_threads = [
                    x for x in self._capture_threads if x.is_alive()] + [t]
                t.start()
        if ent["error"] is not None:
            raise RuntimeError("capturing a session step failed") \
                from ent["error"]
        return ent["fn"]

    def _retire_step(self, ent: Dict[str, Any]) -> None:
        if ent["step"] is self._bound:
            self._bound, self._bound_members = None, []
        self._retired_steps.append(ent)

    def _collect_retired(self) -> None:
        """Closes each evicted step once its capture has ended, the card
        is past its last replay and no prefetch job holds it."""
        keep = []
        held = self._prefetch["fn"] if self._prefetch is not None else None
        for ent in self._retired_steps:
            step = ent["step"]
            captured = ent["fn"] is not None or ent["error"] is not None
            if (captured or not step.captured) and step.idle() \
                    and step is not held:
                step.close()
            else:
                keep.append(ent)
        self._retired_steps = keep

    def _fused_fn(self, key, n: int, scalars) -> Optional[Any]:
        return self._async_compiled(
            key, lambda: self._build_fused_step(n, key), True, scalars)

    def _block_scalars(self, n: int, block_start: int) -> Tuple[int, ...]:
        """[e, every member's start offset] of a block."""
        sc = [n]
        for v in self._singles:
            sc.append(max(v.start - block_start, 0))
        for g in self._groups:
            sc += [max(v.start - block_start, 0) for v in g.voices]
        return tuple(sc)

    def _render_all_fused(self, key, n: int, block_start: int, defer: bool):
        """Renders the whole set through the fused step, or returns None
        while its graph is being captured (the caller falls back to the
        per-voice path for this block).  Every member's valid end,
        levels and captures queue for the next sync point: with
        sync_interval=1 that is the end of this block, so all of them
        come back in one host copy."""
        scalars = self._block_scalars(n, block_start)
        step = self._fused_fn(key, n, scalars)
        if step is None:
            return None
        members = self._members()
        new, (mix, outs) = step(tuple(_params_of(m) for m in members),
                                tuple(_state_of(m) for m in members),
                                scalars)
        if step.captured:
            self._count("replays")
            self._bound, self._bound_members = step, members
        i = 1
        for m, st, (v, caps, lv) in zip(members, new, outs):
            _set_state(m, st)
            if isinstance(m, Voice):
                m._pending_v.append((v, scalars[i], n))
                if lv is not None:
                    m._pending_levels.append(lv)
                if caps:
                    m._pending_caps.append(caps)
                i += 1
            else:
                B = len(m.voices)
                m._pending.append((v, caps, lv, scalars[i:i + B], n))
                i += B
        return mix

    def _render_all_pervoice(self, n: int, block_start: int, defer: bool):
        """Every lone voice and every group, one render call each
        (tuun_tpu/tracker.py:1141-1158); returns the mix on the device.
        Without defer each call's valid ends are read at once."""
        acc = None
        for voice in self._singles:
            with span("tracker.group_render"):
                s = max(voice.start - block_start, 0)
                y = self._render_voice(voice, n, s, defer=defer)
                acc = y if acc is None else acc + y
        for group in self._groups:
            with span("tracker.group_render"):
                starts = [max(v.start - block_start, 0)
                          for v in group.voices]
                y_sum, v_arr, caps, lv = group.render(
                    n, starts, n, levels=self.report_levels)
                if defer:
                    group._pending.append((v_arr, caps, lv, tuple(starts),
                                           n))
                else:
                    group.resolve(v_arr, caps, starts, n, lv)
                acc = y_sum if acc is None else acc + y_sum
        return acc

    # -- lookahead windows ---------------------------------------------
    #
    # Steady-state streaming renders K blocks ahead in one step and serves
    # the sub-blocks: a block's host cost drops to a handoff.  A play that
    # starts inside the window, a modify or a stop interrupts it: the
    # served sub-blocks replay from the window's inputs (which the window
    # step never changes) to rebuild the states at the consume point.

    def _lookahead(self) -> int:
        return self.lookahead if self.lookahead is not None \
            else self.sync_interval

    def _build_window_step(self, n: int, K: int, key):
        """One render of K*n lanes per member, not K renders: the engine
        renders any block size (block-size invariance is a tested
        contract), so the window multiplies the work per launch instead
        of the launches (tuun_tpu/tracker.py:1170-1233).  scalars[0] is
        the runtime extent e0: K*n for a full window, k*n when an
        interrupt replays k served sub-blocks."""
        impls = self._member_impls(n * K, key)
        levels = self.report_levels

        def win(params, states, sc):
            e0 = sc[0]
            acc = None
            finals, vs, lvs = [], [], []
            for (kind, impl, a, b), P, st in zip(impls, params, states):
                if kind == "s":
                    y, v, st2, _ = impl(P, st, sc[a], e0)
                    mixed = y
                else:
                    y, v, st2, _ = impl(P, st, sc[a:b], e0)
                    mixed = y.sum(0)
                acc = mixed if acc is None else acc + mixed
                vs.append(v)
                if levels:
                    # The last served sub-block's levels: at the runtime
                    # extent, so that an interrupt replay reports them.
                    lanes = (e0 - n) + torch.arange(n, device=y.device)
                    lvs.append(_levels(y.index_select(-1, lanes),
                                       None if kind == "s" else 1))
                finals.append(st2)
            return tuple(finals), (acc, vs, lvs)
        return win

    def _window_fn(self, key, n: int, K: int, scalars) -> Optional[Any]:
        """The K-block window step; its graph never changes its inputs."""
        return self._async_compiled(
            ("win", key, K), lambda: self._build_window_step(n, K, key),
            False, scalars)

    def _window_scalars(self, e0: int) -> Tuple[int, ...]:
        return (e0,) + (0,) * (len(self._singles)
                               + sum(len(g.voices) for g in self._groups))

    def _open_window(self, key, n: int, block_start: int):
        """Opens a lookahead window when the set is eligible, returning
        the first served sub-block (None: ineligible, or its step is still
        being captured)."""
        K = self._lookahead()
        if K <= 1 or K * n > MAX_BLOCK:
            return None
        window_end = block_start + K * n
        if any(v.start > block_start for v in self.active):
            return None
        if any(p.start < window_end for p in self.pending):
            return None
        members = self._members()
        if any(m.compiled.root.has_capture for m in members):
            return None
        # The per-block fused step must be live for interrupt replays
        # (refresh its LRU slot: it must outlive the window).
        fent = self._fused_cache.get(key)
        if fent is None or fent["fn"] is None:
            return None
        self._fused_cache[key] = self._fused_cache.pop(key)
        scalars = self._window_scalars(K * n)
        step = self._window_fn(key, n, K, scalars)
        if step is None:
            return None
        first = block_start // n
        phases: Dict[str, float] = {}
        with span("tracker.window_open", args=first):
            with span("tracker.prefetch_wait", phases, "adopt", first):
                res = self._adopt_prefetch(key, K, block_start)
            if res is None:
                with span("tracker.window_dispatch", phases, "dispatch",
                          first):
                    res = step(tuple(_params_of(m) for m in members),
                               tuple(_state_of(m) for m in members), scalars)
                    if step.captured:
                        self._count("replays")
            if sum(phases.values()) > 0.002:
                self.op_log.append(("window", first, sum(phases.values()),
                                    phases))
            finals, (acc, vs, lvs) = res
            self._count("window_opens")
            self._window = {"acc": acc, "vs": vs, "lvs": lvs,
                            "finals": finals, "k": 0, "K": K, "key": key,
                            "start": block_start,
                            "singles": list(self._singles),
                            "groups": list(self._groups)}
            if self.prefetch_windows:
                with span("tracker.prefetch_submit", args=first):
                    self._submit_prefetch(key, K, step, finals, window_end,
                                          scalars)
        return self._serve_window()

    def _adopt_prefetch(self, key, K: int, block_start: int):
        """The speculative next window's result if it was rendered from
        exactly the current inputs: the same key, K, start and member
        lists, and every member still holding the params, state object
        and state generation that the job was built from (any retirement,
        regroup or interrupt since breaks one of them), else None
        (tuun_tpu/tracker.py:1298-1333)."""
        pf, self._prefetch = self._prefetch, None
        if pf is None:
            return None

        def same(a, b):  # element identity, not dataclass field ==
            return len(a) == len(b) and all(x is y for x, y in zip(a, b))
        valid = (pf["key"] == key and pf["K"] == K
                 and pf["start"] == block_start
                 and same(pf["singles"], self._singles)
                 and same(pf["groups"], self._groups)
                 and all(_params_of(m) is p and _state_of(m) is s
                         and m.gen == g for m, p, s, g in pf["refs"]))
        with pf["lock"]:
            started = pf["state"] != "queued"
            if not started:
                # Not picked up yet: rendering inline is faster than
                # waiting in line.
                pf["state"] = "abandoned"
        if not valid or not started:
            self._count("prefetch_misses")
            return None
        if not pf["done"].wait(timeout=120):  # pragma: no cover
            self._count("prefetch_misses")
            return None
        if pf["error"] is not None:
            raise RuntimeError("the window prefetch failed") from pf["error"]
        self._count("prefetch_hits")
        return pf["result"]

    def _submit_prefetch(self, key, K: int, step, finals, start: int,
                         scalars) -> None:
        """Renders the next window from this window's end states on the
        prefetch worker.  The window step never changes its inputs, so an
        unadopted prefetch is only discarded output.  Each member's state
        generation is expected one higher at adoption: the finalize of
        this window sets it to `finals`.  Under a profiler session the
        step's scan calls and node operations are marked here
        (`step.mark()`), on the serving thread, which the session
        records."""
        members = self._members()
        params = tuple(_params_of(m) for m in members)
        refs = [(m, p, f, m.gen + 1) for m, p, f in zip(members, params,
                                                          finals)]
        stream = torch.cuda.current_stream(self.cfg.device) \
            if self.cfg.device.type == "cuda" else None
        job = {"lock": _threading.Lock(), "state": "queued",
               "done": _threading.Event(), "fn": step,
               "args": (params, tuple(finals), scalars), "stream": stream,
               "result": None, "error": None, "key": key, "K": K,
               "start": start, "singles": list(self._singles),
               "groups": list(self._groups), "refs": refs}
        step.mark()
        self._prefetch = job
        self._ensure_prefetcher()
        self._prefetch_q.put(job)

    def _ensure_prefetcher(self) -> None:
        if self._prefetch_thread is not None \
                and self._prefetch_thread.is_alive():
            return
        self._prefetch_q: _queue.Queue = _queue.Queue()

        def work():
            while True:
                job = self._prefetch_q.get()
                if job is None:
                    return
                with job["lock"]:
                    if job["state"] == "abandoned":
                        job["done"].set()
                        continue
                    job["state"] = "running"
                try:
                    with span("prefetch.window", args=job["start"] //
                              self.block_size):
                        if job["stream"] is not None:
                            # The serve thread's stream: its replays and
                            # this one never overlap on the card.
                            with torch.cuda.stream(job["stream"]):
                                job["result"] = job["fn"](*job["args"])
                            self._count("replays")
                        else:
                            job["result"] = job["fn"](*job["args"])
                except Exception as e:  # raised at adoption
                    job["error"] = e
                job["done"].set()

        self._prefetch_thread = _threading.Thread(
            target=work, daemon=True, name="tuun-window-prefetch")
        _threads.track_closer(self)
        self._prefetch_thread.start()

    def _serve_window(self):
        w = self._window
        n = self.block_size
        first = w["start"] // n
        with span("tracker.window_serve", args=first):
            y = w["acc"][w["k"] * n:(w["k"] + 1) * n]
            self._served = (w, y, w["k"])
            w["k"] += 1
        if w["k"] >= w["K"]:
            with span("tracker.window_finalize", args=first):
                self._finalize_window()
        return y

    def _queue_window(self, w, finals, vs, lvs, e: int) -> None:
        """Adopts a window render's end states and queues its valid ends
        and levels (the last served sub-block's: a finished voice keeps
        reporting v < e, so finish detection holds)."""
        for m, st, v, lv in zip(w["singles"] + w["groups"], finals, vs,
                                lvs if self.report_levels
                                else [None] * len(vs)):
            _set_state(m, st)
            if isinstance(m, Voice):
                m._pending_v.append((v, 0, e))
                if lv is not None:
                    m._pending_levels.append(lv)
            else:
                m._pending.append((v, {}, lv, (0,) * len(m.voices), e))

    def _finalize_window(self) -> None:
        w = self._window
        self._window = None
        # The window served K blocks while _since_sync was frozen: count
        # them, so the sync cadence stays per block (the finalize block
        # itself adds the last one).
        self._since_sync += w["K"] - 1
        self._queue_window(w, w["finals"], w["vs"], w["lvs"],
                           self.block_size * w["K"])

    def _interrupt_window(self) -> None:
        """A command arrived mid-window (a play that starts inside it, a
        modify, a stop): discard the unserved tail and replay the k served
        sub-blocks as one render of the window step with extent k*n from
        its untouched inputs, so states and bookkeeping stand exactly at
        the consume point (tuun_tpu/tracker.py:1434-
        1491)."""
        w = self._window
        if w is None:
            return
        self._window = None
        # The k served blocks were never counted toward the sync cadence.
        self._since_sync += w["k"]
        if w["k"] == 0:
            return
        n = self.block_size
        ent = self._fused_cache.get(("win", w["key"], w["K"]))
        step = ent["fn"] if ent is not None else None
        if step is not None:
            e = w["k"] * n
            members = w["singles"] + w["groups"]
            finals, (_acc, vs, lvs) = step(
                tuple(_params_of(m) for m in members),
                tuple(_state_of(m) for m in members),
                self._window_scalars(e))
            if step.captured:
                self._count("replays")
            self._queue_window(w, finals, vs, lvs, e)
            return
        # The window step was evicted mid-window: a skipped replay would
        # freeze every state while `now` advances, so replay per block
        # through the fused or the per-voice path.
        for j in range(w["k"]):
            bs = w["start"] + j * n
            if self._render_all_fused(w["key"], n, bs, True) is None:
                self._render_all_pervoice(n, bs, True)

    @spanned("tracker.render_block")
    def render_block(self):
        """Renders the next block of `block_size` samples (the audio
        callback: tracker.rs:321-368 + generate:484-644).  Returns (mix,
        Status): the mix as numpy with sync_interval=1, else on the
        device (a torch tensor), as the JAX tracker returns a device
        array; a block with no voice is numpy zeros either way."""
        t0 = _time.perf_counter()
        n = self.block_size
        block_start = self.now
        block_end = block_start + n
        self._served = None

        still_pending: List[Pending] = []
        for p in self.pending:
            if p.start < block_end:
                self.active.append(self._activate(p, block_start))
                # The regroup below stacks voice states: take the groups'
                # progress back onto their voices first, without waiting
                # on the card for valid ends still in flight.
                with span("tracker.materialize"):
                    self._materialize_groups(drain=False)
                if p.repeat_every is not None:
                    nxt = p.start + p.repeat_every
                    while nxt < block_start:  # skip missed repetitions
                        nxt += p.repeat_every
                    marks = collect_marks(p.waveform, self.sample_rate,
                                          p.id, nxt)
                    still_pending.append(Pending(p.id, p.waveform, nxt,
                                                 p.repeat_every, marks))
            else:
                still_pending.append(p)
        self.pending = sorted(still_pending, key=lambda q: q.start)

        if self._groups_dirty:
            with span("tracker.regroup"):
                self._rebuild_groups()

        defer = self.sync_interval > 1
        acc = None
        served = opened = fused = False
        if self._window is not None:
            acc = self._serve_window()
            served = True
        if not served:
            fused_key = self._fused_set_key(n) if self.fuse else None
            if fused_key is not None and fused_key == self._fuse_key:
                self._fuse_count += 1
            else:
                self._fuse_key, self._fuse_count = fused_key, 0
            fused = fused_key is not None and \
                self._fuse_count >= self.fuse_after
            if fused and defer:
                acc = self._open_window(fused_key, n, block_start)
                if acc is not None:
                    served = opened = True
            if not served and fused:
                with span("tracker.fused_render"):
                    acc = self._render_all_fused(fused_key, n, block_start,
                                                 defer)
                fused = acc is not None  # None: still being captured
            if not served and not fused:
                with span("tracker.pervoice_render"):
                    acc = self._render_all_pervoice(n, block_start, defer)
        # Exact retirement: voices with a known total length finish the
        # moment their final block has been rendered, without a read.
        for voice in self.active:
            if voice.total_len is not None and \
                    voice.start + voice.total_len <= block_end:
                voice.finished = True
        # Count dispatches before the sync prunes voices that finished in
        # this very block.
        if served:
            dispatches = 1 if opened else 0
        elif fused:
            dispatches = 1
        else:
            dispatches = len(self._singles) + len(self._groups)
        self.now = block_end
        if self._window is None:
            # No sync while a window is open: the voice lists stay frozen
            # until its states are adopted at finalize.
            self._since_sync += 1
            if not defer:
                with span("tracker.sync"):
                    self._sync_voices(drain=True)
            elif self._since_sync >= self.sync_interval:
                with span("tracker.sync"):
                    self._sync_voices(drain=False)
        if acc is None:
            out = np.zeros(n, np.float32)
        else:
            out = acc if defer else acc.cpu().numpy()

        status = self._status(block_start)
        status.dispatches = dispatches
        if self.report_levels:
            status.voice_levels = {v.id: (v.level_rms, v.level_peak)
                                   for v in self.active}
        if self.send_current_buffer:
            status.buffer = np.array(
                out.cpu() if isinstance(out, torch.Tensor) else out,
                np.float32)
            self.send_current_buffer = False
        status.tracker_load = (_time.perf_counter() - t0) * \
            self.sample_rate / n
        self.load_metric.set(status.tracker_load)
        self.dispatch_metric.set(float(status.dispatches))
        return out, status

    @spanned("tracker.stage_host")
    def stage_host(self, y):
        """Starts the copy to host memory of the block that render_block
        has just returned, for a reader on another thread, without
        waiting for it: (staged, lo, hi), the block being
        `_staged_host(staged)[lo:hi]`, which waits on the copy's event.
        The blocks of a lookahead window share one copy of the window,
        started with its first staged block, so no block is copied twice;
        a host block is its own copy."""
        if isinstance(y, np.ndarray):
            return (y, None, None), 0, len(y)
        served = self._served
        if served is not None and served[1] is y:
            w, _, k = served
            if "staged" not in w:
                w["staged"] = _start_host_copies(w["acc"])
            n = self.block_size
            return w["staged"], k * n, (k + 1) * n
        return _start_host_copies(y), 0, y.shape[0]

    # -- deferred sync ---------------------------------------------------

    def _stage_pending(self):
        """Packs every queued valid end and level into one tensor and
        starts its copy to host memory; returns (staged, plan), plan
        saying how to unpack it, or None when nothing is queued
        (tuun_tpu/tracker.py:1629-1674).  The read happens at a later
        sync, so the copy overlaps with rendering."""
        flat: List[torch.Tensor] = []
        plan: List = []
        for voice in self._singles:
            for (v, s, e) in voice._pending_v:
                flat.append(v)
                plan.append(("single", voice, (s, e)))
            for (r, pk) in voice._pending_levels:
                flat += [r, pk]
                plan.append(("slevel", voice, None))
            for caps in voice._pending_caps:
                plan.append(("caps", voice, caps))
            voice._pending_v = []
            voice._pending_caps = []
            voice._pending_levels = []
        for group in self._groups:
            for (v_arr, caps, lv, starts, e) in group._pending:
                flat.append(v_arr)
                plan.append(("group", group, (caps, starts, e)))
                if lv is not None:
                    flat += [lv[0], lv[1]]
                    plan.append(("glevel", group, None))
            group._pending = []
        if not flat:
            return None
        return _start_host_copies(_pack(flat)), plan

    def _resolve_staged(self, staged) -> None:
        if staged is None:
            return
        copy, plan = staged
        with span("tracker.copy_wait"):
            data = _staged_host(copy)
        self._apply_resolved(data, plan)

    def _apply_resolved(self, data: np.ndarray, plan) -> None:
        cursor = 0
        for kind, target, extra in plan:
            if kind == "single":
                s, e = extra
                _note_valid(target, data[cursor], s, e)
                cursor += 1
            elif kind == "group":
                b = len(target.voices)
                v_np = data[cursor:cursor + b]
                cursor += b
                caps, starts, e = extra
                for i, voice in enumerate(target.voices):
                    for stem, (cy, cs, cv) in caps.items():
                        _append_capture(voice, stem, cy[i], cs[i], cv[i])
                    _note_valid(voice, v_np[i], starts[i], e)
            elif kind == "slevel":
                target.level_rms = float(data[cursor])
                target.level_peak = float(data[cursor + 1])
                cursor += 2
            elif kind == "glevel":
                b = len(target.voices)
                rms = data[cursor:cursor + b]
                peak = data[cursor + b:cursor + 2 * b]
                cursor += 2 * b
                for i, voice in enumerate(target.voices):
                    voice.level_rms = float(rms[i])
                    voice.level_peak = float(peak[i])
            else:  # caps on a lone voice
                for stem, (cy, cs, cv) in extra.items():
                    _append_capture(target, stem, cy, cs, cv)

    def _ensure_fetcher(self) -> None:
        if self._fetch_thread is not None and self._fetch_thread.is_alive():
            return
        self._fetch_q: _queue.Queue = _queue.Queue()
        self._fetched_q: _queue.Queue = _queue.Queue()
        self._fetch_outstanding = 0

        def work():
            while True:
                item = self._fetch_q.get()
                if item is None:
                    return
                copy, plan = item
                try:
                    with span("fetch.copy_wait"):
                        data = _staged_host(copy)  # waits on its event
                except Exception:
                    data = None
                self._fetched_q.put((data, plan))

        self._fetch_thread = _threading.Thread(target=work, daemon=True,
                                               name="tuun-fetch")
        # close() runs before interpreter teardown: the worker waits on
        # CUDA events, which is unsafe to kill mid-call.
        _threads.track_closer(self)
        self._fetch_thread.start()

    def close(self) -> None:
        """Stops the fetch and prefetch workers, waits for captures in
        progress and, once the card is past their replays, frees every
        cached session step's graph (idempotent; the tracker stays
        usable: the workers respawn and the steps are captured again on
        demand)."""
        t = self._fetch_thread
        if t is not None and t.is_alive():
            self._fetch_q.put(None)
            t.join(timeout=_threads.SHUTDOWN_JOIN_SECONDS)
        t = self._prefetch_thread
        if t is not None and t.is_alive():
            self._prefetch_q.put(None)
            t.join(timeout=_threads.SHUTDOWN_JOIN_SECONDS)
        for t in self._capture_threads:
            t.join(timeout=_threads.SHUTDOWN_JOIN_SECONDS)
        self._capture_threads = []
        self._prefetch = None
        self._bound, self._bound_members = None, []
        for ent in list(self._fused_cache.values()) + self._retired_steps:
            if ent["fn"] is not None or ent["error"] is not None:
                ent["step"].wait()
                ent["step"].close()
        self._fused_cache.clear()
        self._retired_steps = []

    def _apply_fetched(self, block: bool = False) -> None:
        """Applies completed background fetches on the calling thread;
        with block=True waits for every outstanding fetch."""
        while self._fetch_outstanding:
            try:
                if block:
                    with span("tracker.copy_wait"):
                        data, plan = self._fetched_q.get(timeout=60)
                else:
                    data, plan = self._fetched_q.get(timeout=0)
            except _queue.Empty:
                if block:
                    raise RuntimeError("staged fetch worker stalled")
                return
            self._fetch_outstanding -= 1
            if data is not None:
                self._apply_resolved(data, plan)

    def _sync_voices(self, drain: bool = True) -> None:
        """Resolves queued valid ends, levels and capture slices, and
        retires finished voices (tuun_tpu/tracker.py:1782-1830).  With
        drain=False the blocking wait for the host copy runs on the fetch
        worker and its results apply at a later sync; drain=True resolves
        everything now."""
        self._since_sync = 0
        self._ensure_fetcher()
        queue = self._staged_q
        with span("tracker.stage_pending"):
            staged = self._stage_pending()
        if staged is not None:
            queue.append(staged)
        self._apply_fetched(block=drain)
        if drain:
            for st in queue:
                self._resolve_staged(st)
        else:
            for st in queue:
                self._fetch_q.put(st)
                self._fetch_outstanding += 1
        queue.clear()
        finished = [v for v in self.active if v.finished]
        if finished and self._fetch_outstanding and any(
                v.captures or v.compiled.capture_stems for v in finished):
            # A voice can finish (exact retirement) while copies holding
            # its capture slices are still in flight: resolve them before
            # closing, or its capture WAV would lose its tail.  Voices
            # without captures retire without this wait.
            self._apply_fetched(block=True)
        if finished:
            with span("tracker.retire"):
                self._detach_states()
                for group in self._groups:
                    if any(v.finished for v in group.voices):
                        group.materialize_states()
                self._groups_dirty = True
                for voice in finished:
                    self._close_voice(voice)
                self.active = [v for v in self.active if not v.finished]
                self._singles = [v for v in self._singles
                                 if not v.finished]

    def _close_voice(self, voice: Voice) -> None:
        if not voice.captures:
            return
        datetime = _time.strftime(self.captured_date_format)
        for stem, chunks in voice.captures.items():
            samples = np.concatenate(chunks) if chunks else \
                np.zeros(0, np.float32)
            self.captured_output_dir.mkdir(parents=True, exist_ok=True)
            write_wav_f32(self.captured_output_dir / f"{stem}{datetime}.wav",
                          samples, self.sample_rate)
        voice.captures = {}

    # -- convenience ---------------------------------------------------

    @spanned("tracker.run_to_completion")
    def run_to_completion(self, max_seconds: float = 120.0,
                          sink: Optional[Callable[[np.ndarray], None]] = None
                          ) -> np.ndarray:
        """Renders blocks until no active or pending voices remain.

        In deferred-sync mode the blocks stay on the device; each sync
        window's blocks stack into one tensor whose copy to host starts at
        once and is read when it has landed, in one FIFO with host blocks,
        so no block overtakes another (tuun_tpu/tracker.py:1872-1935)."""
        chunks: List[np.ndarray] = []
        window: List[torch.Tensor] = []
        in_flight: List = []  # staged copies of [k, block] stacks

        def flush_window():
            if not window:
                return
            with span("tracker.flush"):
                packed = window[0][None] if len(window) == 1 \
                    else torch.stack(window)
                window.clear()
                in_flight.append(_start_host_copies(packed))

        def resolve(limit: Optional[int] = None):
            while in_flight and (
                    (limit is not None and len(in_flight) > limit)
                    or _staged_ready(in_flight[0])):
                with span("tracker.copy_wait"):
                    host = _staged_host(in_flight.pop(0))
                arr = np.asarray(host, np.float32).reshape(
                    -1, self.block_size)
                for row in arr:
                    chunks.append(row)
                    if sink is not None:
                        sink(row)

        max_blocks = int(max_seconds * self.sample_rate / self.block_size) + 1
        for _ in range(max_blocks):
            y, _ = self.render_block()
            if isinstance(y, np.ndarray):
                # A host block (no voice active, or sync_interval=1) joins
                # the same FIFO, behind every device block before it.
                flush_window()
                in_flight.append((y.reshape(1, -1), None))
                resolve(limit=32)
            else:
                window.append(y)
                if self._since_sync == 0:
                    flush_window()
                    resolve(limit=32)
            # Termination is only decidable at sync points.
            if self._since_sync == 0 and not self.active and not self.pending:
                break
        flush_window()
        resolve(limit=0)
        if not chunks:
            return np.zeros(0, np.float32)
        with span("tracker.concat"):
            return np.concatenate(chunks)

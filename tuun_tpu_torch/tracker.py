"""The tracker: a batched polyphonic block renderer.

Port of tuun_tpu/tracker.py with sync_interval=1 and no fused step:
pending voices promote when their start sample is reached (late starts
catch up by rendering and discarding, tracker.rs:514-537; repeat_every
reschedules a fresh copy, skipping missed repetitions), and each block
renders every active voice and mixes on the device until the one host
copy per block.  Voices of one compiled structure, `fast` flag and
literal Fin cutoffs (`lits`) form a VoiceGroup once two or more are
active: the group renders as one call (CompiledVoice.batched_render_fn,
torch.func.vmap over the voices, the scans on their voices x lanes
kernels), its mix summed on the device, its valid ends read on the host
in one copy.  A lone voice renders on its own, with one read of its
valid end.  Voices with an exactly known length retire at their end
sample without a read.

Each voice carries its `fast` flag and `lits`, resolved at activation as
tuun_tpu/tracker.py:846-897 does: timeline-bearing structures render
their literal schedules, relocatable ones take the fast path when
EngineConfig.reloc_fast asks for it, and a relocatable voice's exact
length comes from its symbolic length.  Deferred sync, the fused session
step, lookahead windows, prefetch, Modify and the mesh wait (ROADMAP.md
queue 1).
"""

from __future__ import annotations

import time as _time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import ir, native, oracle
from .engine import CompiledVoice, EngineConfig, structure_key
from .engine.graph import check_device, stack_params, stack_tree, tree_index
from .metric import Metric
from .wav import write_wav_f32

# The helpers below are copied from tuun_tpu/tracker.py:40-166, which
# imports jax at module top.
MARK_LENGTH_CAP_SECONDS = 10  # tracker.rs process_marked's 10 * sample_rate
# Exact-retirement length probe cap (the native oracle resolves symbolic
# lengths in O(tree); a value-path Fin pays a generate pass to this cap).
RETIRE_LENGTH_CAP_SECONDS = 120


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
    # Host seconds of the block's render over the block's audio seconds.
    tracker_load: Optional[float] = None
    voices: int = 0
    # Render calls issued this block: one per lone voice, one per group
    # (the reference's allocations_per_sample analogue, tracker.rs:342-345).
    dispatches: int = 0
    # Per-voice (rms, peak) of the block, when the tracker was built with
    # levels=True.
    voice_levels: Dict[Any, Tuple[float, float]] = field(default_factory=dict)


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


class _CompileCache:
    """Per-structure compile cache: same-shaped waveforms share one
    CompiledVoice."""

    def __init__(self):
        self._cache: Dict[Tuple, CompiledVoice] = {}

    def get(self, w: ir.Waveform, cfg: EngineConfig) -> CompiledVoice:
        key = (structure_key(w, cfg.sample_rate), cfg.sample_rate,
               cfg.precision, str(cfg.device), cfg.timeline, cfg.reloc_fast)
        voice = self._cache.get(key)
        if voice is None:
            voice = self._cache[key] = CompiledVoice(w, cfg)
        return voice


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
    # Last resolved output levels (levels=True trackers).
    level_rms: float = 0.0
    level_peak: float = 0.0


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


def _resolve_single(voice: Voice, v, e: int, caps, lv=None) -> None:
    """Finish detection, levels and capture slicing for one rendered
    block: one host read of the voice's valid end (and its levels)."""
    if lv is None:
        vv = int(v)
    else:
        vv, voice.level_rms, voice.level_peak = torch.stack(
            [v.double(), lv[0].double(), lv[1].double()]).tolist()
    if vv < e:
        voice.finished = True
    for stem, (cy, cs, cv) in caps.items():
        _append_capture(voice, stem, cy, cs, cv)


class VoiceGroup:
    """Same-structure voices rendered as one call (tuun_tpu/tracker.py:302-
    420, without the mesh).

    Params and states stay stacked between blocks; membership changes
    (activation, retirement) rebuild the group.  The mix sums on the
    device, so a block costs one render call whatever the polyphony, and
    the group's valid ends come back in one host copy."""

    def __init__(self, compiled: CompiledVoice, voices: List[Voice]):
        self.compiled = compiled
        self.voices = voices
        self.fast = all(v.fast for v in voices)
        # Voices group by (compiled, fast, lits), so lits is uniform; it
        # also drives the stateful timeline-schedule path (non-fast).
        self.lits = voices[0].lits
        self.bparams = stack_params([v.params for v in voices])
        self.bstate = stack_tree([v.state for v in voices])
        self._fns: Dict[Tuple[int, bool], Callable] = {}
        self._args = None  # ((starts, e), device starts, device e)

    def render(self, n: int, starts, e: int, levels: bool = False):
        """(mix[n], v[B], captures, (rms[B], peak[B]) or None)."""
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
            y_sum, v, self.bstate, caps, rms, peak = fn(
                self.bparams, self.bstate, starts_dev, e_dev)
            lv = (rms, peak)
        else:
            y_sum, v, self.bstate, caps = fn(self.bparams, self.bstate,
                                             starts_dev, e_dev)
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

    def resolve(self, v, caps, e: int, lv=None) -> None:
        """Finish detection, levels and captures for every member from
        one host copy of the group's valid ends (and levels)."""
        rows = [v.double()]
        if lv is not None:
            rows += [lv[0].double(), lv[1].double()]
        data = torch.stack(rows).tolist()
        for i, voice in enumerate(self.voices):
            if data[0][i] < e:
                voice.finished = True
            if lv is not None:
                voice.level_rms, voice.level_peak = data[1][i], data[2][i]
            for stem, (cy, cs, cv) in caps.items():
                _append_capture(voice, stem, cy[i], cs[i], cv[i])

    def materialize_states(self) -> None:
        for i, voice in enumerate(self.voices):
            voice.state = tree_index(self.bstate, i)


class Tracker:
    """Owns active + pending voices and renders mixed blocks."""

    def __init__(self, sample_rate: int, block_size: int = 1024,
                 captured_output_dir: str | Path = ".",
                 captured_date_format: str = "_%Y-%m-%d_%H-%M-%S",
                 precision: str = "fast", device="cuda",
                 levels: bool = False):
        self.sample_rate = sample_rate
        self.block_size = block_size
        self.captured_output_dir = Path(captured_output_dir)
        self.captured_date_format = captured_date_format
        self.cfg = EngineConfig(sample_rate, precision, device)
        check_device(self.cfg.device)
        self.cache = _CompileCache()
        self.active: List[Voice] = []
        self.pending: List[Pending] = []
        self.now: int = 0  # next sample to be rendered
        self._seed_counter = 0  # voice seeds 1, 2, ... as in tuun_tpu
        self._groups: List[VoiceGroup] = []
        self._singles: List[Voice] = []
        self._groups_dirty = True
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

    # -- commands ------------------------------------------------------

    def play(self, wid, waveform: ir.Waveform, start: Optional[int] = None,
             repeat_every: Optional[int] = None) -> None:
        if repeat_every is not None and repeat_every <= 0:
            # A non-positive period would spin the missed-repetition
            # catch-up loop forever: play once instead.
            repeat_every = None
        start = self.now if start is None else start
        marks = collect_marks(waveform, self.sample_rate, wid, start)
        self.pending.append(Pending(wid, waveform, start, repeat_every,
                                    marks))
        self.pending.sort(key=lambda p: p.start)

    def remove_pending(self, wid) -> None:
        self.pending = [p for p in self.pending if p.id != wid]

    def stop_all(self) -> None:
        self._sync_voices()
        for voice in self.active:
            self._close_voice(voice)
        self.active = []
        self.pending = []
        self._groups = []
        self._singles = []
        self._groups_dirty = True

    # -- rendering -----------------------------------------------------

    def _activate(self, p: Pending, block_start: int) -> Voice:
        compiled = self.cache.get(p.waveform, self.cfg)
        self._seed_counter += 1
        params = compiled.params_for(p.waveform, seed=self._seed_counter)
        fast = compiled.fast_default
        lits = compiled.lits_for(params) \
            if fast or compiled._has_timeline else None
        voice = Voice(p.id, p.waveform, compiled, params,
                      compiled.init(params), p.start, list(p.marks),
                      fast=fast, lits=lits)
        # Exact retirement: the symbolic length of a relocatable
        # structure, else the oracle's length() (generator.rs:787-862).
        total = compiled.symbolic_len(params, lits)
        if total is None:
            total = _voice_total_length(p.waveform, self.sample_rate)
        voice.total_len = total
        if total is None:
            self._ends_known = False
        else:
            self._last_end = max(self._last_end, p.start + total)
        delta = block_start - p.start
        off = 0
        while off < delta and not voice.finished:
            # Late start: render and discard the missed span
            # (tracker.rs:514-537); captures are kept.
            m = min(self.block_size, delta - off)
            self._render_voice(voice, m, 0)
            off += m
        return voice

    def _render_voice(self, voice: Voice, e: int, s: int) -> torch.Tensor:
        """One block for one voice; returns its samples on the device."""
        y, v, voice.state, caps = voice.compiled.render_block(
            voice.params, voice.state, self.block_size, s, e,
            fast=voice.fast, lits=voice.lits)
        _resolve_single(voice, v, e, caps,
                        _levels(y) if self.report_levels else None)
        return y

    def _materialize_groups(self) -> None:
        """Writes each group's stacked state back onto its voices and
        drops the groups; the next block regroups (tuun_tpu/tracker.py:
        700-713, whose every sync drains at sync_interval=1)."""
        self._sync_voices()
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
                self._groups.append(VoiceGroup(voices[0].compiled, voices))
            else:
                self._singles.extend(voices)
        self._groups_dirty = False

    def _render_all_pervoice(self, n: int, block_start: int):
        """Every lone voice and every group, one render call each
        (tuun_tpu/tracker.py:1141-1158); returns the mix on the device."""
        acc = None
        for voice in self._singles:
            y = self._render_voice(voice, n, max(voice.start - block_start, 0))
            acc = y if acc is None else acc + y
        for group in self._groups:
            starts = [max(v.start - block_start, 0) for v in group.voices]
            y_sum, v_arr, caps, lv = group.render(
                n, starts, n, levels=self.report_levels)
            group.resolve(v_arr, caps, n, lv)
            acc = y_sum if acc is None else acc + y_sum
        return acc

    def render_block(self) -> Tuple[np.ndarray, Status]:
        """Renders the next block of `block_size` samples (the audio
        callback: tracker.rs:321-368 + generate:484-644)."""
        t0 = _time.perf_counter()
        n = self.block_size
        block_start = self.now
        block_end = block_start + n

        still_pending: List[Pending] = []
        for p in self.pending:
            if p.start < block_end:
                self.active.append(self._activate(p, block_start))
                # The regroup below stacks voice states: take the groups'
                # progress back onto their voices first.
                self._materialize_groups()
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
            self._rebuild_groups()
        acc = self._render_all_pervoice(n, block_start)
        dispatches = len(self._singles) + len(self._groups)
        for voice in self.active:
            if voice.total_len is not None and \
                    voice.start + voice.total_len <= block_end:
                voice.finished = True
        self.now = block_end
        self._sync_voices()
        out = np.zeros(n, np.float32) if acc is None else acc.cpu().numpy()

        status = self._status(block_start)
        status.dispatches = dispatches
        if self.report_levels:
            status.voice_levels = {v.id: (v.level_rms, v.level_peak)
                                   for v in self.active}
        status.tracker_load = (_time.perf_counter() - t0) * \
            self.sample_rate / n
        self.load_metric.set(status.tracker_load)
        self.dispatch_metric.set(float(status.dispatches))
        return out, status

    def _sync_voices(self) -> None:
        """Retires finished voices, writing their captures; a group that
        loses a member writes its state back and the next block regroups
        (tuun_tpu/tracker.py:1808-1830)."""
        finished = [v for v in self.active if v.finished]
        if not finished:
            return
        for group in self._groups:
            if any(v.finished for v in group.voices):
                group.materialize_states()
        self._groups_dirty = True
        for voice in finished:
            self._close_voice(voice)
        self.active = [v for v in self.active if not v.finished]
        self._singles = [v for v in self._singles if not v.finished]

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

    def run_to_completion(self, max_seconds: float = 120.0,
                          sink: Optional[Callable[[np.ndarray], None]] = None
                          ) -> np.ndarray:
        """Renders blocks until no active or pending voices remain."""
        chunks: List[np.ndarray] = []
        max_blocks = int(max_seconds * self.sample_rate / self.block_size) + 1
        for _ in range(max_blocks):
            y, _ = self.render_block()
            chunks.append(y)
            if sink is not None:
                sink(y)
            if not self.active and not self.pending:
                break
        if not chunks:
            return np.zeros(0, np.float32)
        return np.concatenate(chunks)

"""The tracker: renders and mixes voices block by block.

Port of the per-voice path of tuun_tpu/tracker.py: pending voices promote
when their start sample is reached (late starts catch up by rendering and
discarding, tracker.rs:514-537), each active voice renders one block
through its CompiledVoice, and the block's mix stays on the device until
the one host copy per block.  Each voice's valid end is read on the host
once per block -- the JAX tracker with sync_interval=1.  Voices with an
exactly known length retire at their end sample without a read.

Each voice carries its `fast` flag and literal Fin cutoffs (`lits`),
resolved at activation as tuun_tpu/tracker.py:846-897 does: timeline-
bearing structures render their literal schedules, relocatable ones take
the fast path when EngineConfig.reloc_fast asks for it, and a relocatable
voice's exact length comes from its symbolic length.  Voice groups, the
fused session step, lookahead windows, Modify and level reporting wait
(ROADMAP.md queue 1).
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
from .engine.graph import check_device
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
    voices: int = 0


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


@dataclass
class Pending:
    id: Any
    waveform: ir.Waveform
    start: int
    marks: List[Mark]


def _append_capture(voice: Voice, stem: str, cy, cs, cv) -> None:
    """Appends one capture window's valid slice [cs, cv) to the voice's
    stem buffers."""
    cs_i, cv_i = int(cs), int(cv)
    if cv_i > cs_i:
        voice.captures.setdefault(stem, []).append(
            cy[cs_i:cv_i].cpu().numpy())


def _resolve_single(voice: Voice, v, e: int, caps) -> None:
    """Finish detection and capture slicing for one rendered block: the
    one host read of the voice's valid end."""
    if int(v) < e:
        voice.finished = True
    for stem, (cy, cs, cv) in caps.items():
        _append_capture(voice, stem, cy, cs, cv)


class Tracker:
    """Owns active + pending voices and renders mixed blocks."""

    def __init__(self, sample_rate: int, block_size: int = 1024,
                 captured_output_dir: str | Path = ".",
                 captured_date_format: str = "_%Y-%m-%d_%H-%M-%S",
                 precision: str = "fast", device="cuda"):
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
        # While every activated voice had a known total length, known_end
        # is the last sample any voice produces.
        self._ends_known = True
        self._last_end = 0

    @property
    def known_end(self) -> Optional[int]:
        """The exact final sample of everything played so far, when every
        voice's length was statically known; None otherwise."""
        return self._last_end if self._ends_known else None

    # -- commands ------------------------------------------------------

    def play(self, wid, waveform: ir.Waveform,
             start: Optional[int] = None) -> None:
        start = self.now if start is None else start
        marks = collect_marks(waveform, self.sample_rate, wid, start)
        self.pending.append(Pending(wid, waveform, start, marks))
        self.pending.sort(key=lambda p: p.start)

    def stop_all(self) -> None:
        self._sync_voices()
        for voice in self.active:
            self._close_voice(voice)
        self.active = []
        self.pending = []

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
        _resolve_single(voice, v, e, caps)
        return y

    def render_block(self) -> Tuple[np.ndarray, Status]:
        """Renders the next block of `block_size` samples (the audio
        callback: tracker.rs:321-368 + generate:484-644)."""
        n = self.block_size
        block_start = self.now
        block_end = block_start + n

        still_pending: List[Pending] = []
        for p in self.pending:
            if p.start < block_end:
                self.active.append(self._activate(p, block_start))
            else:
                still_pending.append(p)
        self.pending = sorted(still_pending, key=lambda q: q.start)

        acc = None
        for voice in self.active:
            y = self._render_voice(voice, n, max(voice.start - block_start, 0))
            acc = y if acc is None else acc + y
        for voice in self.active:
            if voice.total_len is not None and \
                    voice.start + voice.total_len <= block_end:
                voice.finished = True
        self.now = block_end
        self._sync_voices()
        out = np.zeros(n, np.float32) if acc is None else acc.cpu().numpy()

        status = Status(buffer_start=block_start, voices=len(self.active))
        for voice in self.active:
            status.marks.extend(voice.marks)
        for p in self.pending:
            status.marks.extend(p.marks)
        return out, status

    def _sync_voices(self) -> None:
        """Retires finished voices, writing their captures."""
        finished = [v for v in self.active if v.finished]
        for voice in finished:
            self._close_voice(voice)
        if finished:
            self.active = [v for v in self.active if not v.finished]

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

"""Voice rendering over a mesh of devices (port of tuun_tpu/parallel.py).

The JAX package shards a batch of same-structure voices over a
jax.sharding.Mesh: shard_map and psum split one program over the mesh's
devices.  The port keeps that single controller.  One process holds the
batch; each voice shard's stacked params and state live on that shard's
device, where the shard renders its rows through the engine's voices x
lanes path (CompiledVoice.batched_render_fn, the scans' rows kernels on
a card); and the cross-shard reduction copies each shard's partial mix
to the output device and adds the partials in shard order.  A "time"
axis over 1 splits a block's lanes for relocatable voices: time shard k
evaluates the voices' reloc at its own lane window only.

A mesh's positions may repeat a device: default_mesh(8, "cpu") is eight
shards on the one CPU, and default_mesh(4) on a single card is four
shards on cuda:0, issued one after another on its stream.  Such a mesh
exercises what a mesh adds (padding, per-shard state, lane windows, the
cross-shard mix and levels) but cannot show a tensor left on the wrong
card.

Summation order: a meshed mix adds each shard's weighted rows, then the
shards in order; a meshless group sums all its rows at once (y.sum(0)).
With one voice a shard the two orders agree on the CPU; otherwise they
may differ in the last bits.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from . import ir
from .engine.graph import (CompiledVoice, EngineConfig, Params, check_device,
                           reloc_block, stack_params, stack_tree, structure_key,
                           tree_index, tree_to)

AXES = ("voice", "time")


class Mesh:
    """A (voice, time) grid of torch devices: the surface of
    jax.sharding.Mesh that the mesh paths read.  `devices` is an object
    array of torch.device shaped (voice, time); `shape` maps each axis
    name to its size.  Positions may repeat a device.  A CUDA mesh
    without a card raises."""

    axis_names = AXES

    def __init__(self, devices):
        rows = [[torch.device(d) for d in row] for row in devices]
        if not rows or not rows[0] or any(len(r) != len(rows[0])
                                          for r in rows):
            raise ValueError("a mesh is a non-empty (voice, time) grid")
        grid = np.empty((len(rows), len(rows[0])), dtype=object)
        for i, row in enumerate(rows):
            grid[i, :] = row
        types = {d.type for d in grid.flat}
        if len(types) != 1:
            raise ValueError(f"a mesh of mixed device types {types}")
        self.device_type = types.pop()
        check_device(torch.device(self.device_type))
        self.devices = grid
        self.shape = dict(zip(AXES, grid.shape))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.flat]})"


def default_mesh(n_devices: Optional[int] = None, device="cuda") -> Mesh:
    """A (voice, time) mesh of n_devices positions (default: one per
    visible device of `device`'s type): (n/2, 2) when n >= 4 and n is
    even, else (n, 1), as tuun_tpu's.  The positions are the visible
    devices cuda:0..count-1 (a device with an index: that one), or the
    one CPU, and cycle over them when n_devices is more: positions may
    repeat a device.  Unlike tuun_tpu's, it never falls back to the CPU:
    a CUDA mesh without a card raises."""
    dev = torch.device(device)
    check_device(dev)
    if dev.type == "cuda" and dev.index is None:
        base = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    else:
        base = [dev]
    n = n_devices or len(base)
    positions = [base[i % len(base)] for i in range(n)]
    if n >= 4 and n % 2 == 0:
        return Mesh([positions[i:i + 2] for i in range(0, n, 2)])
    return Mesh([[d] for d in positions])


def _on(device: torch.device):
    """Makes `device` current while a shard launches: the scan wrappers
    launch on the current device's stream."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _sum_in_order(parts: List[torch.Tensor], device) -> torch.Tensor:
    """The cross-shard reduction: each partial copied to `device`, added
    in shard order."""
    acc = None
    for p in parts:
        p = p.to(device)
        acc = p if acc is None else acc + p
    return acc


@dataclass
class _Shard:
    rows: slice                   # its rows of the padded batch
    devices: List[torch.device]   # its time shards' devices
    params: List[Params]          # its stacked params on each of them
    weights: List[torch.Tensor]   # 1 a real voice, 0 a padding row


class VoiceShards:
    """A same-structure voice batch laid out over a mesh's voice axis
    (tuun_tpu/tracker.py:312-348, parallel.py:167-189): padded with
    voice 0 at weight 0 to a multiple of the voice axis, each voice
    shard's params stacked on every device of its time shards (one copy
    a device), and per-voice results gathered on `out_device`.  States
    are a tuple over voice shards, each on its first time shard's
    device."""

    def __init__(self, compiled: CompiledVoice, params: Sequence[Params],
                 mesh: Mesh, out_device):
        self.compiled = compiled
        self.mesh = mesh
        self.out_device = torch.device(out_device)
        vsize = mesh.shape["voice"]
        self.n = len(params)
        self.pad = (-self.n) % vsize
        self.per_shard = (self.n + self.pad) // vsize
        padded = list(params) + [params[0]] * self.pad
        weights = torch.tensor([1.0] * self.n + [0.0] * self.pad)
        self.shards: List[_Shard] = []
        for i in range(vsize):
            rows = slice(i * self.per_shard, (i + 1) * self.per_shard)
            stacked = stack_params(padded[rows])
            devices = list(mesh.devices[i])
            copies = {}
            for d in devices:
                if d not in copies:
                    copies[d] = (stacked.to(d), weights[rows].to(d))
            self.shards.append(_Shard(rows, devices,
                                      [copies[d][0] for d in devices],
                                      [copies[d][1] for d in devices]))

    # -- states ------------------------------------------------------------

    def stack_states(self, states: Sequence) -> tuple:
        """The voices' own states, padded and stacked per shard."""
        padded = list(states) + [states[0]] * self.pad
        return tuple(tree_to(stack_tree(padded[sh.rows]), sh.devices[0])
                     for sh in self.shards)

    def init_states(self) -> tuple:
        """A fresh state per shard (batched init on its device)."""
        out = []
        for sh in self.shards:
            with _on(sh.devices[0]):
                out.append(self.compiled.batched_init(sh.params[0]))
        return tuple(out)

    def voice_state(self, states: tuple, i: int):
        """Voice i's state, on the output device."""
        shard, row = divmod(i, self.per_shard)
        return tree_to(tree_index(states[shard], row), self.out_device)

    # -- arguments -----------------------------------------------------------

    def args(self, starts: Sequence[int], e: int) -> list:
        """Per shard, per time shard, (starts[rows], e) as int64 tensors
        on that time shard's device; padding rows start at 0."""
        padded = list(starts) + [0] * self.pad
        out = []
        for sh in self.shards:
            made = {}
            for d in sh.devices:
                if d not in made:
                    made[d] = (torch.tensor(padded[sh.rows],
                                            dtype=torch.int64, device=d),
                               torch.full((), e, dtype=torch.int64,
                                          device=d))
            out.append([made[d] for d in sh.devices])
        return out

    # -- gathers -------------------------------------------------------------

    def _gather(self, xs: List[torch.Tensor]) -> torch.Tensor:
        """Per-shard [rows] results as one [n] tensor on the output
        device, the padding rows dropped."""
        return torch.cat([x.to(self.out_device) for x in xs])[:self.n]

    def _gather_caps(self, caps: List[dict]) -> dict:
        return {stem: tuple(torch.cat([c[stem][j].to(self.out_device)
                                       for c in caps])
                            for j in range(3))
                for stem in caps[0]}

    # -- renders -------------------------------------------------------------

    def render_fn(self, n: int, fast, lits, levels: Optional[Callable] = None
                  ) -> Callable:
        """fn(states, args) -> (mix[n], v[n_voices], states', caps, lv):
        each voice shard renders its rows on its first time shard's
        device through batched_render_fn(mix=False), its weighted rows
        sum there, and the partials add on the output device in shard
        order.  levels(y) -> (rms, peak) per row, or None."""
        rows_fn = self.compiled.batched_render_fn(n, fast=fast, lits=lits,
                                                  mix=False)

        def fn(states, args):
            parts, vs, new, caps, lvs = [], [], [], [], []
            for sh, st, a in zip(self.shards, states, args):
                with _on(sh.devices[0]):
                    y, v, st2, cp = rows_fn(sh.params[0], st, *a[0])
                    parts.append((y * sh.weights[0][:, None]).sum(0))
                    if levels is not None:
                        lvs.append(levels(y))
                vs.append(v)
                new.append(st2)
                caps.append(cp)
            lv = None if levels is None else (
                self._gather([x[0] for x in lvs]),
                self._gather([x[1] for x in lvs]))
            return (_sum_in_order(parts, self.out_device), self._gather(vs),
                    tuple(new), self._gather_caps(caps), lv)
        return fn

    def lane_fn(self, n: int, lits, levels: bool = False) -> Callable:
        """The lane-sharded render of relocatable voices on the fast path
        (tuun_tpu/tracker.py:422-478): time shard k evaluates
        reloc_block at lanes k*n/T .. (k+1)*n/T - 1 of the block only,
        each voice shard's weighted rows sum on that device, the partials
        of one window add on the output device in voice-shard order, and
        the windows concatenate.  Every time shard computes the same valid
        ends and next state: time shard 0's are kept.  Levels: the sum of
        squares adds over the time shards, the peak is their max."""
        T = self.mesh.shape["time"]
        if n % T:
            raise ValueError(f"{n} lanes do not split over {T} time shards")
        n_loc = n // T
        root = self.compiled.root

        def one(consts, fixeds, seed, st, s, e, lanes, host=None):
            return reloc_block(root, Params(consts, fixeds, seed, host=host),
                               st, lanes, s, e, lits)
        vmapped = torch.func.vmap(one, in_dims=(0, 0, 0, 0, 0, None, None))
        lanes = {}

        def fn(states, args):
            windows = [[] for _ in range(T)]
            vs, new, lvs = [], [], []
            for sh, (pos, rst), a in zip(self.shards, states, args):
                sq = peak = None
                for k, d in enumerate(sh.devices):
                    if (k, d) not in lanes:
                        lanes[(k, d)] = k * n_loc + torch.arange(
                            n_loc, dtype=torch.int64, device=d)
                    P = sh.params[k]
                    with _on(d):
                        y, v, st2 = vmapped(P.consts, P.fixeds, P.seed,
                                            (pos.to(d), rst), *a[k],
                                            lanes[(k, d)], host=P.host)
                        windows[k].append((y * sh.weights[k][:, None]).sum(0))
                    if k == 0:
                        vs.append(v)
                        new.append(st2)
                    if levels:
                        home = sh.devices[0]
                        s2 = (y * y).sum(1).to(home)
                        pk = y.abs().amax(1).to(home)
                        sq = s2 if sq is None else sq + s2
                        peak = pk if peak is None else torch.maximum(peak, pk)
                if levels:
                    lvs.append((torch.sqrt(sq / n), peak))
            mix = torch.cat([_sum_in_order(w, self.out_device)
                             for w in windows])
            lv = None if not levels else (
                self._gather([x[0] for x in lvs]),
                self._gather([x[1] for x in lvs]))
            return mix, self._gather(vs), tuple(new), {}, lv
        return fn


def _render_reloc_lane_sharded(voice: CompiledVoice, params, n_samples: int,
                               mesh: Mesh, block: int, lits=None
                               ) -> np.ndarray:
    """Lane-sharded render of relocatable voices over the whole (voice,
    time) mesh (tuun_tpu/parallel.py:43-109): each time shard evaluates
    the voices' reloc at its own lane window of every block, each voice
    shard holds a slice of the batch, and the mix reduces over the
    voice shards.  `block` rounds down to a multiple of the time axis.
    The output is the valid prefix, the longest voice's length at most."""
    tsize = mesh.shape["time"]
    block = max(block - block % tsize, tsize)
    shards = VoiceShards(voice, params, mesh, voice.cfg.device)
    fn = shards.lane_fn(block, lits)
    states = shards.init_states()
    # Finiteness is structural (all same-structure voices share it), so
    # one voice answers the None check; the total is the longest voice.
    lens = [voice.symbolic_len(p, lits) for p in params]
    total = n_samples if lens[0] is None else min(n_samples, max(lens))
    args = shards.args([0] * len(params), block)
    out: List[np.ndarray] = []
    done = 0
    while done < total:
        # Each call advances every voice's position by the block, so a
        # block starts at `done`.
        mix, _, states, _, _ = fn(states, args)
        take = min(block, total - done)
        out.append(mix[:take].cpu().numpy().astype(np.float32))
        done += take
    return np.concatenate(out) if out else np.zeros(0, np.float32)


def render_voices_meshed(waveforms: Sequence[ir.Waveform], n_samples: int,
                         sample_rate: int, *, mesh: Optional[Mesh] = None,
                         precision: str = "fast", block: int = 8192,
                         seed: int = 0, lane_shard: Optional[bool] = None,
                         device="cuda") -> np.ndarray:
    """Renders a batch of same-structure voices data-parallel over a
    device mesh and returns the mixed output (valid prefix) as float32
    numpy (tuun_tpu/parallel.py:112-215).

    All waveforms must share a compiled structure (same shape, different
    Const values): the tracker's VoiceGroup condition.  Voice i takes
    seed + i.  Relocatable structures render lane-sharded over the
    mesh's "time" axis when it is over 1 (_render_reloc_lane_sharded);
    lane_shard=False forces the voice-axis-only stateful path.  `device`
    holds the compiled voice and the mix; the mesh (default_mesh over
    `device`'s type) must be of the same device type."""
    if not waveforms:
        raise ValueError("empty voice batch")
    if len({structure_key(w, sample_rate) for w in waveforms}) != 1:
        raise ValueError("render_voices_meshed needs same-structure voices")
    if mesh is None:
        mesh = default_mesh(device=device)
    cfg = EngineConfig(sample_rate, precision, device)
    if mesh.device_type != cfg.device.type:
        raise ValueError(f"a {mesh.device_type} mesh for a render on "
                         f"{cfg.device}")

    # Timeline schedules are literal per parameter set: when every voice
    # resolves the same schedule (one score, detuned parameters), the
    # timeline compile is shared; otherwise the plain tree.
    voice = CompiledVoice(waveforms[0], cfg)
    params = [voice.params_for(w, seed=seed + i)
              for i, w in enumerate(waveforms)]
    lits = None
    if voice._has_timeline:
        all_lits = {voice.lits_for(p) for p in params}
        if len(all_lits) == 1:
            lits = all_lits.pop()
        else:
            cfg = EngineConfig(sample_rate, precision, device, timeline=False)
            voice = CompiledVoice(waveforms[0], cfg)
            params = [voice.params_for(w, seed=seed + i)
                      for i, w in enumerate(waveforms)]
    if lane_shard is None:
        lane_shard = voice.relocatable and mesh.shape["time"] > 1
    if lane_shard:
        if not voice.relocatable:
            raise ValueError("lane sharding needs a relocatable voice")
        return _render_reloc_lane_sharded(voice, params, n_samples, mesh,
                                          block, lits)
    shards = VoiceShards(voice, params, mesh, cfg.device)
    fn = shards.render_fn(block, False, lits)
    states = shards.init_states()
    out: List[np.ndarray] = []
    total = 0
    while total < n_samples:
        m = min(block, n_samples - total)
        mix, v, states, _, _ = fn(states, shards.args([0] * len(params), m))
        vmax = int(v.max())
        out.append(mix[:vmax].cpu().numpy().astype(np.float32))
        total += vmax
        if vmax < m:
            break
    return np.concatenate(out)[:n_samples] if out else \
        np.zeros(0, np.float32)

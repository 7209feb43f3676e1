"""Session steps as CUDA graphs: the port's counterpart of jax.jit for the
tracker's fused step and lookahead windows (tuun_tpu/tracker.py:989-1091,
1170-1240).

A step is `fn(params, states, scalars) -> (new_states, outs)`: params a
tuple of Params (a voice's own, or a group's stacked ones), states the
matching tuple of state trees, scalars an int64 vector of the host ints
the step reads (extents and start offsets), outs any tree of tensors
(the mix, valid ends, levels, capture slices).

On the CPU, `EagerStep` calls fn as it is, as the JAX package calls an
unjitted step.  On CUDA, `GraphStep` captures fn once into a
torch.cuda.CUDAGraph over static input buffers, and each call replays it:

  * Inputs.  A GraphStep owns clones of the params, states and scalars it
    was built from.  A call copies in a member's params only when they
    are other objects than the last ones copied in, its state unless it
    is the step's own state buffer (carry, below), both in one
    torch._foreach_copy_, and the scalars only when their host values
    changed (one copy from pinned memory).
  * carry=True (the per-block step): the graph ends by writing the new
    states into its own state inputs, so a steady run of replays copies
    no state, and a call returns those buffers as the new states.  They
    are the step's: whatever must hold a state across a later replay
    clones it first (the tracker's `_detach_states`).
  * carry=False (a window): the graph leaves its inputs untouched (an
    interrupt replays from them) and the new states are outputs.
  * Outputs.  Every output leaf, and the new states when carry=False, is
    packed inside the graph into one flat buffer per dtype.  A call
    clones those buffers (one launch per dtype) and returns views of the
    clones, so nothing it returns is overwritten by a later replay.
  * Capture.  The warm-up (one eager run on the static inputs, which
    fills every lazy cache of the render: timeline layouts, the scans'
    custom ops, their scratch) and the capture run on a stream of their
    own, inside scan_ops.graph_scope: the scans use scratch of this step's
    own, which no other call, warm-up or replay shares, freed when the step
    is closed or collected.  One capture runs at a time in the process,
    with capture_error_mode="thread_local", so that another thread may serve
    blocks on the card meanwhile.  A scan launch recorded by the capture is
    counted at every replay (scan_ops.count_launches), and the shapes of
    the scan calls it recorded (`scan_calls`) are marked on the profiler's
    clock at every replay under a session (scan_ops.mark_calls).
  * A call replays on the caller's current stream, under the step's own
    lock (a window's prefetch worker and the serve thread both call it),
    inside the span `tuun.engine.replay` (spans.py).
"""

from __future__ import annotations

import collections
import threading
import time
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from .. import spans
from . import scan_ops
from .graph import Params

_capture_lock = threading.Lock()


def flatten(tree) -> Tuple[Any, List[torch.Tensor]]:
    """(spec, tensor leaves) of a tree of tuples, lists, dicts, Params and
    tensors; any other value is kept in the spec as a constant."""
    leaves: List[torch.Tensor] = []

    def go(x):
        if isinstance(x, torch.Tensor):
            leaves.append(x)
            return ("T",)
        if isinstance(x, tuple):
            return ("tuple", tuple(go(y) for y in x))
        if isinstance(x, list):
            return ("list", tuple(go(y) for y in x))
        if isinstance(x, dict):
            return ("dict", tuple(x), tuple(go(y) for y in x.values()))
        if isinstance(x, Params):
            return ("P", go((x.consts, x.fixeds, x.seed)), x.host)
        return ("C", x)
    return go(tree), leaves


def unflatten(spec, leaves) -> Any:
    """The tree of `spec` with its tensors taken in order from `leaves`."""
    it = iter(leaves)

    def go(s):
        kind = s[0]
        if kind == "T":
            return next(it)
        if kind == "tuple":
            return tuple(go(y) for y in s[1])
        if kind == "list":
            return [go(y) for y in s[1]]
        if kind == "dict":
            return dict(zip(s[1], (go(y) for y in s[2])))
        if kind == "P":
            consts, fixeds, seed = go(s[1])
            return Params(consts, fixeds, seed, host=s[2])
        return s[1]
    return go(spec)


def tree_clone(tree):
    """A copy of `tree` whose tensors are clones (one launch a leaf)."""
    spec, leaves = flatten(tree)
    return unflatten(spec, [x.clone() for x in leaves])


def _pack(leaves: List[torch.Tensor]):
    """One flat buffer per dtype holding every leaf, and each leaf's
    (dtype, offset, shape) in it."""
    parts: Dict[torch.dtype, List[torch.Tensor]] = {}
    sizes: Dict[torch.dtype, int] = {}
    layout = []
    for x in leaves:
        off = sizes.get(x.dtype, 0)
        layout.append((x.dtype, off, tuple(x.shape)))
        sizes[x.dtype] = off + x.numel()
        parts.setdefault(x.dtype, []).append(x.reshape(-1))
    return {dt: torch.cat(xs) for dt, xs in parts.items()}, layout


def _views(bufs, layout) -> List[torch.Tensor]:
    return [bufs[dt][off:off + _numel(shape)].view(shape)
            for dt, off, shape in layout]


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= d
    return n


class EagerStep:
    """A step called as it is (the CPU)."""

    captured = False
    # Its scans mark themselves where they run.
    scan_calls: Tuple = ()

    def __init__(self, fn: Callable, device):
        self.fn = fn
        self.device = torch.device(device)

    def __call__(self, params, states, scalars: Tuple[int, ...]):
        sc = torch.tensor(scalars, dtype=torch.int64, device=self.device)
        return self.fn(params, states, sc)

    def idle(self) -> bool:
        return True

    def wait(self) -> None:
        pass

    def close(self) -> None:
        pass


class GraphStep:
    """A step captured into a CUDA graph (see the module docstring).
    Built on the thread that serves blocks; `capture()` may run on
    another thread, and the step is callable once it returns."""

    captured = True

    def __init__(self, fn: Callable, params: Tuple, states: Tuple,
                 scalars: Tuple[int, ...], carry: bool):
        self.fn = fn
        self.carry = carry
        # Each member's static leaves, and the trees made of them.
        self._p_static, self._s_static = [], []
        params_st, states_st = [], []
        for P, st in zip(params, states):
            for tree, leaves_out, trees in ((P, self._p_static, params_st),
                                            (st, self._s_static, states_st)):
                spec, leaves = flatten(tree)
                static = [x.clone() for x in leaves]
                leaves_out.append(static)
                trees.append(unflatten(spec, static))
        self.static_params = tuple(params_st)
        self.static_states = tuple(states_st)
        # The objects whose params were copied in last.
        self._src_params = list(params)
        self.device = params[0].device
        self.scalars = torch.tensor(scalars, dtype=torch.int64,
                                    device=self.device)
        self._scalars_host = tuple(scalars)
        self._built = self._event()
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._packed: Dict[torch.dtype, torch.Tensor] = {}
        self._layout: List = []
        self._out_spec = None
        self.launches: Dict[str, int] = {}
        self.scan_calls: Tuple[scan_ops.Call, ...] = ()
        self._lock = threading.Lock()
        self._done = None  # an event after the last call's work
        self.capture_seconds: Optional[float] = None
        # The scans' scratch of this step is keyed by a token of its own,
        # freed when the step is closed or collected.
        self._scratch_owner = object()
        self._release = weakref.finalize(self, scan_ops.release_scratch,
                                         self._scratch_owner)

    def _event(self):
        """An event recorded now on the current stream (None off CUDA)."""
        if self.device.type != "cuda":
            return None
        event = torch.cuda.Event()
        event.record()
        return event

    def _body(self):
        """The captured work: the step on the static inputs, the new
        states written back (carry) or kept, every output packed.
        Returns (output spec, packed buffers, layout)."""
        new_states, outs = self.fn(self.static_params, self.static_states,
                                   self.scalars)
        if self.carry:
            self._write_back(new_states)
            tree = outs
        else:
            tree = (new_states, outs)
        spec, leaves = flatten(tree)
        packed, layout = _pack(leaves)
        return spec, packed, layout

    def capture(self) -> None:
        """Warm-up and capture on a stream of this step's own; sets
        `capture_seconds`, the wall time of both (waiting for another
        capture to end not counted)."""
        with _capture_lock:
            t0 = time.perf_counter()
            stream = torch.cuda.Stream(self.device)
            stream.wait_event(self._built)
            with torch.cuda.stream(stream):
                with scan_ops.graph_scope(self._scratch_owner):
                    self.fn(self.static_params, self.static_states,
                            self.scalars)
                graph = torch.cuda.CUDAGraph()
                with scan_ops.graph_scope(self._scratch_owner,
                                          record=True) as recorded:
                    graph.capture_begin(capture_error_mode="thread_local")
                    try:
                        body = self._body()
                    except Exception:
                        try:  # end the broken capture; its error is moot
                            graph.capture_end()
                        except RuntimeError:
                            pass
                        raise
                    graph.capture_end()
            stream.synchronize()
            self.capture_seconds = time.perf_counter() - t0
        self._out_spec, self._packed, self._layout = body
        self.scan_calls = tuple(recorded)
        self.launches = dict(collections.Counter(
            entry for entry, *_ in recorded))
        self._graph = graph

    def _replay(self) -> None:
        self._graph.replay()

    def _write_back(self, new_states) -> None:
        dst, src = [], []
        for static, st in zip(self._s_static, new_states):
            _, leaves = flatten(st)
            for d, s in zip(static, leaves):
                if s is not d:
                    dst.append(d)
                    src.append(s)
        if dst:
            torch._foreach_copy_(dst, src)

    def __call__(self, params, states, scalars: Tuple[int, ...]):
        with spans.span("engine.replay"), self._lock:
            if self._graph is None:
                raise RuntimeError("the session step is not captured, or "
                                   "was closed")
            dst, src = [], []
            for k, P in enumerate(params):
                if P is not self._src_params[k]:
                    dst += self._p_static[k]
                    src += flatten(P)[1]
                    self._src_params[k] = P
            for k, st in enumerate(states):
                if not (self.carry and st is self.static_states[k]):
                    dst += self._s_static[k]
                    src += flatten(st)[1]
            if dst:
                torch._foreach_copy_(dst, src)
            scalars = tuple(scalars)
            if scalars != self._scalars_host:
                host = torch.tensor(scalars, dtype=torch.int64)
                if self.device.type == "cuda":
                    host = host.pin_memory()
                self.scalars.copy_(host, non_blocking=True)
                self._scalars_host = scalars
            self._replay()
            scan_ops.count_launches(self.launches)
            scan_ops.mark_calls(self.scan_calls)
            out = unflatten(self._out_spec, _views(
                {dt: b.clone() for dt, b in self._packed.items()},
                self._layout))
            self._done = self._event()
        if self.carry:
            return self.static_states, out
        return out

    def idle(self) -> bool:
        """Whether the card has finished every replay issued so far."""
        return self._done is None or self._done.query()

    def wait(self) -> None:
        """Blocks until the card has finished every replay issued so far."""
        if self._done is not None:
            self._done.synchronize()

    def close(self) -> None:
        """Drops the graph (its private memory pool) and its scratch.
        Call only once the step is idle and no thread will call it."""
        with self._lock:
            self._graph = None
            self._packed = {}
            self._release()


def make_step(fn: Callable, params: Tuple, states: Tuple,
              scalars: Tuple[int, ...], carry: bool):
    """An EagerStep on the CPU, a GraphStep (still to be captured) on
    CUDA."""
    device = params[0].device
    if device.type == "cuda":
        return GraphStep(fn, params, states, scalars, carry)
    return EagerStep(fn, device)

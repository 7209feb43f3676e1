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
    fills every lazy cache of the render: timeline layouts, the kernel
    libraries, the scans' scratch) and the capture run on a stream of their
    own, inside kernels.graph_scope: the scans use scratch of this step's
    own, which no other call, warm-up or replay shares, freed when the step
    is closed or collected.  One capture runs at a time in the process,
    with capture_error_mode="thread_local", so that another thread may serve
    blocks on the card meanwhile.  A kernel launch recorded by the capture
    (a scan's or an interval gate's) is counted at every replay
    (kernels.count_launches), and the shapes of
    the scan calls it recorded (`scan_calls`) are marked on the profiler's
    clock at every replay under a session (kernels.mark_calls).  The
    capture also counts the device operations it adds to the graph by the
    engine node class whose render enqueued them (`node_ops`, NodeOps),
    marked at every replay under a session as
    `tuun.engine.ops.<Class>:<n>` (`GraphStep.mark`), the node renders
    that shared subtrees saved (`shared_renders`, graph.CShared), marked
    as `tuun.engine.shared:<n>`, and those that settled subtrees saved
    (`folded_renders`, graph.CFold), marked as `tuun.engine.folded:<n>`;
    a node class whose every node sits in a settled subtree keeps an
    entry of 0 in `node_ops`.  Apart from the classes, it counts the
    operations enqueued inside the double-single helpers (`df32_ops`:
    df32.py's public functions, each outermost call's growth), which
    still count under the node that called them, marked as
    `tuun.engine.df32:<n>`, 0 in a step with none.  The counts run only
    inside a capture.
  * A call replays on the caller's current stream, under the step's own
    lock (a window's prefetch worker and the serve thread both call it),
    inside the span `tuun.engine.replay` (spans.py).
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import sys
import threading
import time
import weakref
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch

from .. import spans
from . import df32, kernels, scan_ops
from .graph import Node, Params, counting_folded, counting_shared

_capture_lock = threading.Lock()

# The node class of operations enqueued outside every engine node's
# render (the step's mix, the states written back, the outputs packed).
OTHER = "other"
# CUstreamCaptureStatus: the stream is capturing.
_CAPTURE_ACTIVE = 1
_libcuda = None


def captured_nodes(stream: int) -> Optional[int]:
    """The device operations (graph nodes: kernels, copies, sets) that the
    capture on the CUDA stream `stream` (a raw handle) holds so far, read
    through libcuda; None where it cannot be read.  The two libcuda calls
    return at once and keep the interpreter lock (PyDLL), so the capture
    never waits for it behind the thread that serves blocks meanwhile."""
    global _libcuda
    if _libcuda is None:
        try:
            lib = ctypes.PyDLL("libcuda.so.1")
            lib.cuStreamGetCaptureInfo_v2.argtypes = [ctypes.c_void_p] + \
                [ctypes.c_void_p] * 5
            lib.cuGraphGetNodes.argtypes = [ctypes.c_void_p] * 3
            lib.cuStreamGetCaptureInfo_v2.restype = ctypes.c_int
            lib.cuGraphGetNodes.restype = ctypes.c_int
            _libcuda = lib
        except (OSError, AttributeError):
            _libcuda = False
    if not _libcuda:
        return None
    status, cid = ctypes.c_int(), ctypes.c_uint64()
    graph, deps, ndeps = ctypes.c_void_p(), ctypes.c_void_p(), \
        ctypes.c_size_t()
    if _libcuda.cuStreamGetCaptureInfo_v2(
            ctypes.c_void_p(stream), ctypes.byref(status),
            ctypes.byref(cid), ctypes.byref(graph), ctypes.byref(deps),
            ctypes.byref(ndeps)) != 0 or status.value != _CAPTURE_ACTIVE:
        return None
    n = ctypes.c_size_t()
    if _libcuda.cuGraphGetNodes(graph, None, ctypes.byref(n)) != 0:
        return None
    return n.value


def _df32_codes() -> set:
    """The code objects of df32.py's public functions."""
    return {fn.__code__ for name, fn in vars(df32).items()
            if not name.startswith("_") and callable(fn)
            and getattr(fn, "__module__", None) == df32.__name__}


def _render_classes() -> Dict[Any, str]:
    """Each engine node class's `render` code object, and the class's
    name."""
    codes, todo = {}, [Node]
    while todo:
        cls = todo.pop()
        todo += cls.__subclasses__()
        fn = cls.__dict__.get("render")
        if fn is not None:
            codes[fn.__code__] = cls.__name__
    return codes


class NodeOps:
    """Counts, while active on a thread, the device operations enqueued
    there by the engine node class whose render enqueued them: a node's
    count is what `nodes()` (the operations enqueued so far) grew by
    while its render ran, less its children's renders; what grew outside
    every render is OTHER's.  `df32` counts apart what grew inside the
    outermost calls of df32.py's public functions (the double-single
    arithmetic), which count under their node as well.  The renders' and
    the helpers' starts and returns come from sys.monitoring events set
    on those code objects alone, so no other call pays for them and no
    call makes this thread wait for the interpreter lock; calls on other
    threads are passed over.  Nothing is counted where `nodes()` reads
    None or no monitoring tool id is free."""

    def __init__(self, nodes: Callable[[], Optional[int]]):
        self.nodes = nodes
        self.counts: collections.Counter = collections.Counter()
        self.df32 = 0
        self._stack: List[list] = []
        self._df_depth = 0
        self._df_start = 0
        self._tool: Optional[int] = None
        self._lost = False  # a reading of None after the start

    def _now(self) -> int:
        n = self.nodes()
        if n is None:
            self._lost = True
            return 0
        return n

    def _on_start(self, code, offset) -> None:
        if threading.get_ident() != self._thread:
            return
        if code in self._df_codes:
            if not self._df_depth:
                self._df_start = self._now()
            self._df_depth += 1
        else:
            self._stack.append([self._codes[code], self._now(), 0])

    def _on_return(self, code, offset, value) -> None:
        if threading.get_ident() != self._thread:
            return
        if code in self._df_codes:
            self._df_depth -= 1
            if not self._df_depth:
                self.df32 += self._now() - self._df_start
        elif self._stack:
            cls, start, inner = self._stack.pop()
            grown = self._now() - start
            if grown != inner:  # a render that only returned a stored
                self.counts[cls] += grown - inner  # result adds nothing
            if self._stack:
                self._stack[-1][2] += grown

    def __enter__(self) -> "NodeOps":
        self._start = self.nodes()
        mon = sys.monitoring
        free = [i for i in (3, 4) if mon.get_tool(i) is None]
        if self._start is None or not free:
            return self
        try:
            mon.use_tool_id(free[0], "tuun.node_ops")
        except ValueError:  # taken meanwhile
            return self
        self._tool, self._thread = free[0], threading.get_ident()
        self._codes = _render_classes()
        self._df_codes = _df32_codes()
        mon.register_callback(self._tool, mon.events.PY_START,
                              self._on_start)
        mon.register_callback(self._tool, mon.events.PY_RETURN,
                              self._on_return)
        for code in (*self._codes, *self._df_codes):
            mon.set_local_events(self._tool, code, mon.events.PY_START
                                 | mon.events.PY_RETURN)
        return self

    def __exit__(self, *exc) -> bool:
        if self._tool is None:
            return False
        mon = sys.monitoring
        for code in (*self._codes, *self._df_codes):
            mon.set_local_events(self._tool, code, 0)
        mon.register_callback(self._tool, mon.events.PY_START, None)
        mon.register_callback(self._tool, mon.events.PY_RETURN, None)
        mon.free_tool_id(self._tool)
        end = self._now()
        inside = sum(self.counts.values())
        if self._lost:
            self.counts.clear()
            self.df32 = 0
        elif end - self._start > inside:
            self.counts[OTHER] += end - self._start - inside
        return False


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

    def mark(self) -> None:
        """Nothing: its scans mark themselves where they run, and no
        capture counted its node operations."""

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
        self.scan_calls: Tuple[kernels.Call, ...] = ()
        # Device operations of one replay by engine node class (NodeOps),
        # and the node renders that shared and settled subtrees saved in
        # it.
        self.node_ops: Dict[str, int] = {}
        # Those of them enqueued inside the double-single helpers.
        self.df32_ops = 0
        self.shared_renders = 0
        self.folded_renders = 0
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
                with kernels.graph_scope(self._scratch_owner):
                    self.fn(self.static_params, self.static_states,
                            self.scalars)
                graph = torch.cuda.CUDAGraph()
                raw = stream.cuda_stream
                with self._recording(lambda: captured_nodes(raw)) as count:
                    graph.capture_begin(capture_error_mode="thread_local")
                    try:
                        with count:
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
        self._graph = graph

    @contextlib.contextmanager
    def _recording(self, nodes: Callable[[], Optional[int]]
                   ) -> Iterator[NodeOps]:
        """Records what the capture inside it enqueues, for the replays:
        the scans' calls and the hand-written kernels' launches
        (kernels.graph_scope: `scan_calls`, `launches`) and, inside the
        NodeOps it yields (over `nodes`, the operations captured so far),
        the device operations by engine node class (`node_ops`, with 0
        for a class that only settled subtrees hold) and those inside
        the double-single helpers (`df32_ops`), and the node renders that
        shared and settled subtrees saved (`shared_renders`,
        `folded_renders`)."""
        counter = NodeOps(nodes)
        with kernels.graph_scope(self._scratch_owner,
                                  record=True) as recorded, \
                counting_shared() as saved, counting_folded() as folded:
            yield counter
        self.scan_calls = tuple(recorded)
        self.launches = dict(recorded.launches)
        self.node_ops = dict(counter.counts)
        self.df32_ops = counter.df32
        if self.node_ops:
            for cls in folded[1]:
                self.node_ops.setdefault(cls, 0)
        self.shared_renders = saved[0]
        self.folded_renders = folded[0]

    def mark(self) -> None:
        """Under a profiler session, marks what one replay enqueues on
        the profiler's clock: each scan call's shape
        (kernels.mark_calls), each engine node class's operations,
        `tuun.engine.ops.<Class>:<n>`, and beside them those inside the
        double-single helpers, `tuun.engine.df32:<n>`, and the node
        renders shared and settled subtrees saved,
        `tuun.engine.shared:<n>` and `tuun.engine.folded:<n>`."""
        if spans.traced():
            kernels.mark_calls(self.scan_calls)
            for cls, n in sorted(self.node_ops.items()):
                spans.mark(f"engine.ops.{cls}:{n}")
            if self.node_ops:
                spans.mark(f"engine.df32:{self.df32_ops}")
            spans.mark(f"engine.shared:{self.shared_renders}")
            spans.mark(f"engine.folded:{self.folded_renders}")

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
            kernels.count_launches(self.launches)
            self.mark()
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

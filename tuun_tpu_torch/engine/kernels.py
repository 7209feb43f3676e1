"""The seam between the engine and its hand-written CUDA kernels, which
scan_ops.py (csrc/scan.cu, csrc/exact.cu) and lane_ops.py (csrc/lanes.cu)
wrap: how a library is built and loaded, how a launch is counted and
recorded, and how a kernel's rows form runs under torch.func.vmap.

Build.  `library(source, bind)` compiles a source with nvcc into
`_build/` at its first use (keyed by a hash of the source and flags),
loads it through ctypes and runs the wrapper's `bind` (argtypes, checks
against its constants), once, whichever threads get there first.  Every
fast render on the card needs csrc/scan.cu and csrc/lanes.cu, so the
first use of either builds both at once.

Launches.  Every launch counts in `launches` by its entry point, so a
run can show which kernels its path reached; a scan also records its
call's shape (entry, rows, lanes, J or None): a capture keeps the calls
it recorded (`graph_scope`), and an eager call under a profiler session
marks itself `tuun.scan.<entry>:<rows>x<lanes>[:J<J>]` (spans.py).  A
launch that a CUDA graph captures inside `graph_scope` is the scope's,
counted at each of the graph's replays (`count_launches`).

Batching.  A library exports only rows forms: a kernel runs [B, ...]
rows in one launch, and a single-voice entry point launches it on one
row.  Under torch.func.vmap (the tracker's group render) the entry point
hands the whole batch to its rows form in one call (`vmapped`), as
jax.vmap of a pallas_call adds a grid axis, so a group never falls back
to a loop over voices.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import (Any, Callable, Dict, Iterator, List, Optional, Sequence,
                    Tuple)

import torch
from torch._C import _functorch

from .. import spans

PKG_DIR = Path(__file__).resolve().parent.parent
SOURCE = PKG_DIR / "csrc" / "scan.cu"
EXACT_SOURCE = PKG_DIR / "csrc" / "exact.cu"
# The interval gates (lane_ops.py): every render on the card runs them.
LANES_SOURCE = PKG_DIR / "csrc" / "lanes.cu"
BUILD_DIR = PKG_DIR / "_build"
# No --use_fast_math: it would swap in approximate division and
# transcendentals (see the FMA and sinf notes in ROADMAP.md queue 3).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
# Sources built as parts at once, then linked, where the source names the
# macro: (macro, its values).  csrc/exact.cu's chain-form instances take
# most of its build.
SOURCE_PARTS = {"exact.cu": ("TUUN_EXACT_PART", (1, 2, 3))}
# Every fast render on the card needs both: the first use of either
# builds them at once.
FAST_SOURCES = (SOURCE, LANES_SOURCE)

# Each wrapper's count key and the device kernel it launches (the
# __global__ function of its source, as a profiler names it).
KERNEL_SYMBOLS: Dict[str, str] = {
    "prefix_sum_f32": "scan_single_pass",
    "prefix_max_f32": "scan_single_pass",
    "affine_scan_f32": "affine_scan_pass",
    "prefix_sum_rows_f32": "scan_single_pass",
    "prefix_max_rows_f32": "scan_single_pass",
    "affine_scan_rows_f32": "affine_scan_pass",
    "affine_scan_deep_f32": "affine_deep_pass",
    "affine_scan_deep_rows_f32": "affine_deep_pass",
    "linear_recurrence_f32": "linear_recurrence",
    "linear_recurrence_f64": "linear_recurrence",
    "linear_recurrence_rows_f32": "linear_recurrence",
    "linear_recurrence_rows_f64": "linear_recurrence",
    "df_prefix_sum_f32": "df_prefix_sum",
    "df_prefix_sum_rows_f32": "df_prefix_sum",
    # csrc/lanes.cu's (lane_ops.py): no scan, so no tuun.scan.* marker.
    "interval_gate": "interval_gate_kernel",
    "interval_mask": "interval_mask_kernel"}
launches: Dict[str, int] = {k: 0 for k in KERNEL_SYMBOLS}

# Loaded libraries by source.
_libs: Dict[Path, ctypes.CDLL] = {}
# Per thread: the graph_scope's owner and, while a graph captures, the
# calls its scans recorded.
_tls = threading.local()
# Held for the first load of each library and for each scratch creation
# (scan_ops.py; never by a launch that finds its buffer): threads at first
# use (the audio thread, the prewarm, the bake and capture workers) would
# each build or allocate, and a launch could take the pointer of a buffer
# that the table then drops.
first_use = threading.RLock()


# ---------------------------------------------------------------------------
# Build and load
# ---------------------------------------------------------------------------


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME): the "
                           "kernels build with nvcc")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def build_library(source: Path = SOURCE) -> Path:
    """Compiles `source` (csrc/scan.cu by default) unless a build of this
    exact source exists; a source of SOURCE_PARTS as its parts at once,
    each an object, then links them."""
    src = source.read_bytes()
    parts = SOURCE_PARTS.get(source.name)
    if parts is not None and parts[0].encode() not in src:
        parts = None
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()
                            + repr(parts).encode()).hexdigest()
    lib = BUILD_DIR / f"libtuun_{source.stem}_{digest[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.{threading.get_ident()}"
                        f".tmp")

    def nvcc(argv):
        proc = subprocess.run([_nvcc(), *argv], capture_output=True,
                              text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr}")
    if parts is None:
        nvcc([*NVCC_FLAGS, "-o", str(tmp), str(source)])
    else:
        from concurrent.futures import ThreadPoolExecutor
        macro, values = parts
        compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
        objs = [tmp.with_name(f"{tmp.name}.{v}.o") for v in values]
        with ThreadPoolExecutor(len(values)) as pool:
            list(pool.map(lambda v, o: nvcc(
                [*compile_flags, f"-D{macro}={v}", "-c", "-o", str(o),
                 str(source)]), values, objs))
        nvcc([*NVCC_FLAGS, "-o", str(tmp), *map(str, objs)])
        for o in objs:
            o.unlink()
    os.replace(tmp, lib)  # atomic: concurrent builders converge
    return lib


def build_libraries(sources: Sequence[Path] = (SOURCE, EXACT_SOURCE,
                                                LANES_SOURCE)
                    ) -> List[Path]:
    """Builds the kernel sources at once, one nvcc each (every one by
    default)."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(len(sources)) as pool:
        return list(pool.map(build_library, sources))


def library(source: Path, bind: Callable[[ctypes.CDLL], None]
            ) -> ctypes.CDLL:
    """`source`'s library, built (with its FAST_SOURCES partner), loaded
    and bound by `bind` on first use: once, whichever threads get here
    first.  A `bind` that raises leaves it unloaded."""
    lib = _libs.get(source)
    if lib is not None:
        return lib
    with first_use:
        lib = _libs.get(source)
        if lib is None:
            sources = FAST_SOURCES if source in FAST_SOURCES else (source,)
            lib = ctypes.CDLL(str(
                build_libraries(sources)[sources.index(source)]))
            bind(lib)
            _libs[source] = lib
    return lib


# ---------------------------------------------------------------------------
# Launches and calls
# ---------------------------------------------------------------------------


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def launched(entry: str, status: int) -> None:
    """Counts one launch under `entry` (a capture's in its recording,
    graph_scope), or raises on its nonzero CUDA status."""
    if status != 0:
        raise RuntimeError(f"{entry}: CUDA error {status} at launch")
    rec = getattr(_tls, "recording", None)
    if rec is None:
        launches[entry] += 1
    else:
        rec.launches[entry] += 1


def count_launches(recorded: Dict[str, int]) -> None:
    """Counts the launches that a replay of a captured graph makes."""
    for k, c in recorded.items():
        launches[k] += c


# A scan call's shape: (entry, rows, lanes, J or None).
Call = Tuple[str, int, int, Optional[int]]


class Recording(List[Call]):
    """What a capture recorded: its scan calls, in order, and the
    launches of every kernel of `launches`' table by entry."""

    def __init__(self):
        super().__init__()
        self.launches: collections.Counter = collections.Counter()


def call_marker(call: Call) -> str:
    """The marker's name of a scan call, after "tuun."."""
    entry, rows, lanes, J = call
    return f"scan.{entry}:{rows}x{lanes}" + ("" if J is None else f":J{J}")


def mark_calls(calls: Sequence[Call]) -> None:
    """One marker per call while a profiler session runs (a captured
    step's calls, at its dispatch)."""
    if calls and spans.traced():
        for call in calls:
            spans.mark(call_marker(call))


def called(entry: str, rows: int, lanes: int,
           J: Optional[int] = None) -> None:
    """Records a call: in the capture's recording while a graph captures,
    else as a marker under a session."""
    rec = getattr(_tls, "recording", None)
    if rec is not None:
        rec.append((entry, rows, lanes, J))
    elif spans.traced():
        spans.mark(call_marker((entry, rows, lanes, J)))


@contextlib.contextmanager
def graph_scope(owner, record: bool = False) -> Iterator[Recording]:
    """While active on this thread, the scans use scratch of `owner`'s
    own; with record=True (a capture) the scans append their calls to the
    yielded Recording instead of marking them, and every counted kernel
    adds its launches to the Recording's instead of to `launches`: each
    launch a captured graph holds is one at every replay."""
    if getattr(_tls, "owner", None) is not None:
        raise RuntimeError("graph_scope does not nest")
    recorded = Recording()
    _tls.owner = owner
    _tls.recording = recorded if record else None
    try:
        yield recorded
    finally:
        _tls.owner = None
        _tls.recording = None


def scope_owner() -> Any:
    """This thread's graph_scope owner, or None outside one."""
    return getattr(_tls, "owner", None)


# ---------------------------------------------------------------------------
# Rows forms under torch.func.vmap
# ---------------------------------------------------------------------------


def _voices_first(x, bdim: Optional[int], voices: int, contiguous: bool):
    """An operand as a rows form reads it: the voice axis first, an
    operand vmap does not batch (bdim None) the same for every voice, by
    a stride-0 expand; copied to contiguous rows unless `contiguous` is
    False (a kernel that reads row strides).  A non-tensor passes."""
    if not isinstance(x, torch.Tensor):
        return x
    x = x.expand(voices, *x.shape) if bdim is None else x.movedim(bdim, 0)
    return x.contiguous() if contiguous else x


def vmapped(rows: Callable, xs: Sequence, contiguous: bool = True):
    """`rows(*operands)` once, for a call whose operands `xs` vmap
    batches: each operand unwrapped at the current vmap level and laid
    out by _voices_first, every output wrapped back at dim 0 (a tuple for
    a tuple).  None where vmap batches none of `xs`."""
    for x in xs:
        if isinstance(x, torch.Tensor) and _functorch.is_batchedtensor(x):
            break
    else:
        return None
    level = _functorch.maybe_current_level()
    args = [_functorch._unwrap_batched(x, level)
            if isinstance(x, torch.Tensor) else (x, None) for x in xs]
    voices = next((x.shape[d] for x, d in args if d is not None), None)
    if voices is None or any(isinstance(x, torch.Tensor)
                             and _functorch.is_batchedtensor(x)
                             for x, _ in args):
        raise ValueError(f"{getattr(rows, '__name__', rows)}: an operand "
                         f"is batched by an outer vmap (nested vmap is not "
                         f"supported)")
    out = rows(*(_voices_first(x, d, voices, contiguous) for x, d in args))
    if isinstance(out, tuple):
        return tuple(_functorch._add_batch_dim(o, 0, level) for o in out)
    return _functorch._add_batch_dim(out, 0, level)

"""The engine's cross-lane scans: inclusive prefix sum, running max, and
the affine scan that runs IIR filter feedback, with its deep form for
feedback deeper than MAX_J; and the exact precisions' two: the sequential
linear recurrence (exact-mode IIR feedback) and the compensated
(double-single) prefix sum of exact_df's phase.

Counterpart of tuun_tpu/engine/pallas_ops.py.  Each public entry point
dispatches on the device of its input:

  * a CPU tensor takes the plain PyTorch version beside it (`*_ref`);
  * a CUDA tensor launches the hand-written kernel in csrc/scan.cu (the
    scans) or csrc/exact.cu (the recurrence and the df prefix sum), or
    raises.  Nothing falls back to the plain version.

kernels.py builds and loads the libraries, counts each launch in its
`launches` table under the entry point's name and records each call's
shape (entry, rows, lanes, J) for the `tuun.scan.*` markers.

Each kernel is one launch per call: a single-pass scan with decoupled
look-back, in a fixed grouping, so a call gives the same bits every
time (the linear recurrence instead runs each row's chain in sequence,
one block a row, and needs no scratch).  Each scan keeps a persistent
scratch per (device, stream), zeroed once when it is allocated and left
clean by every call, so calls and replays of a captured CUDA graph need
no set-up:

  * the prefix scans' (two counters and one status word per 4096-lane
    tile) is sized once for the longest scan (4 MiB) and never grows;
  * the affine scan's (a counter, then per look-back record 72 64-bit
    words, each a value with the stamp of the call that wrote it; ~1.03
    records a 1024-lane tile) would be ~1.3 GB for the longest scan, so it
    starts at the records of 2^20 lanes (0.61 MB) and grows by a new
    buffer when a longer scan comes; an outgrown buffer is kept, never
    freed, because a captured graph may hold its pointer.  The records a
    length takes never fall as the length grows, so a warm-up at the
    longest length covers every shorter one.  The kernel leaves it ready
    for the next call: no record needs clearing, since a stale stamp
    never matches;
  * the deep affine scan's (two counters, a flag and a record of up to
    340 floats per 1024-lane tile) follows the same rule, from 2^20 lanes
    (1.4 MB);
  * the df prefix sum's (two counters, a flag and a (hi, lo) record per
    2048-lane tile) follows the affine scan's rule, from 2^22 lanes.

Call a scan once on a stream, at the longest length it will capture,
before capturing it there, so that its scratch exists outside the
capture: a call that would allocate scratch while the stream captures
raises.  A graph keeps the scratch of the stream it was captured on, so
replays of graphs captured on one stream must not overlap one another
or calls on that stream.  Inside `kernels.graph_scope(owner)` a thread's
scans take scratch of their own, keyed by the owner too
(engine/capture.py gives each captured graph its own, so that no
warm-up, call or replay elsewhere shares it; `release_scratch(owner)`
frees it with the graph).

Unlike the TPU kernels, these take any length from 1 to 2^31 - 1 (no
multiple-of-128 or 2^21 limit), the affine scan any J from 1 to MAX_J = 8
and its deep form (affine_scan_deep_f32) any J from 9 to MAX_DEEP_J = 16;
a deeper fast-mode filter runs the linear recurrence.  Both affine forms
return y and the final history (not the Pallas kernel's J planes of h:
the engine reads only y) and hold their maps in shared memory.  So the
engine never needs a plain path on the card.

Each scan also has a voices x lanes form (`*_rows_f32`) for a voice
group: [B, N] rows (the affine scan: a [B, N, J], ff and live [B, N], h0
[B, J]) scanned in one launch, tiles never crossing a row, row r with the
bits of a single call on it.  The library exports only the rows form:
a single-voice entry point launches it on one row, and under
torch.func.vmap (the tracker's group render) hands the whole [B, ...]
batch to it (kernels.vmapped), its operands as contiguous rows.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Any, Dict, List, Tuple

import torch

from . import kernels
# The launch table, read here by the benchmark harness: the same dict as
# kernels.launches.
from .kernels import launches  # noqa: F401

MAX_J = 8
# The deep affine scan takes MAX_J < J <= MAX_DEEP_J.
MAX_DEEP_J = 16
MAX_N = 2 ** 31 - 1
# The linear recurrence takes any feedback depth up to this.
MAX_RECURRENCE_J = 4096

# The df prefix sum's first scratch covers this many lanes; a longer scan
# grows it, as the affine scan's does.
DF_SCRATCH_MIN_LANES = 1 << 22

# The affine scan's first scratch covers this many lanes (0.61 MB); a
# longer scan grows it.
AFFINE_SCRATCH_MIN_LANES = 1 << 20
# Its kernel's tile (csrc/scan.cu) and the look-back fans it takes.
AFFINE_TILE = 1024
AFFINE_FANS = (16, 32, 64)
# The deep affine scan's, likewise (1.4 MB at 1024-lane tiles).
DEEP_SCRATCH_MIN_LANES = 1 << 20

# Lanes a df prefix-sum tile at DF_SCRATCH_MIN_LANES, read from the library
# once: it sizes the first scratch.
_df_tile = 0
# Read from the library once: lanes per prefix-scan tile, the 64-bit
# words of a stream's prefix-scan scratch, and lanes per deep affine tile.
_scan_tile = 0
_scratch_words = 0
_deep_tile = 0
# Persistent prefix-scan scratch, keyed by (device index, raw stream), and
# inside a graph_scope by (device index, raw stream, owner).
_scratch: Dict[Tuple, torch.Tensor] = {}
# Persistent affine-scan scratch, keyed likewise: (buffer, tiles it holds).
_affine_scratch: Dict[Tuple, Tuple[torch.Tensor, int]] = {}
# The deep affine scan's and the df prefix sum's, likewise.
_deep_scratch: Dict[Tuple, Tuple[torch.Tensor, int]] = {}
_df_scratch: Dict[Tuple, Tuple[torch.Tensor, int]] = {}
# Outgrown affine, deep and df scratch: never freed (a captured graph may
# use it), and an owner's until the owner releases it.
_affine_retired: List[torch.Tensor] = []
_owner_retired: Dict[Any, List[torch.Tensor]] = {}


def _scratch_key(device: int, stream: int) -> Tuple:
    owner = kernels.scope_owner()
    return (device, stream) if owner is None else (device, stream, owner)


def release_scratch(owner) -> None:
    """Frees every scratch buffer of `owner` (its graph is gone).  The
    tables hold `owner` in their keys until then: an owner that may be
    dropped passes a token of its own and releases with a finalizer."""
    with kernels.first_use:
        for table in (_scratch, _affine_scratch, _deep_scratch,
                      _df_scratch):
            for key in [k for k in table if len(k) == 3 and k[2] is owner]:
                del table[key]
        _owner_retired.pop(owner, None)


def _bind(lib: ctypes.CDLL) -> None:
    """csrc/scan.cu's argtypes, its constants checked against this
    module's and its tiles read."""
    p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    for name in ("tuun_scan_tile", "tuun_affine_tile", "tuun_affine_max_j",
                 "tuun_affine_deep_tile", "tuun_affine_deep_max_j"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = i32
    lib.tuun_scan_scratch_words.argtypes = []
    lib.tuun_scan_scratch_words.restype = i64
    for name in ("tuun_affine_scratch_words",
                 "tuun_affine_deep_scratch_words"):
        getattr(lib, name).argtypes = [i64]
        getattr(lib, name).restype = i64
    for name in ("tuun_prefix_sum_rows_f32", "tuun_prefix_max_rows_f32"):
        getattr(lib, name).argtypes = [p, p, p, i64, i64, p]
        getattr(lib, name).restype = i32
    lib.tuun_affine_slots.argtypes = [i64, i32]
    lib.tuun_affine_slots.restype = i64
    lib.tuun_affine_scan_rows_f32.argtypes = [p] * 7 + [
        i64, i64, i64, i32, i32, p]
    lib.tuun_affine_scan_rows_f32.restype = i32
    lib.tuun_affine_scan_deep_rows_f32.argtypes = [p] * 7 + [
        i64, i64, i64, i32, p]
    lib.tuun_affine_scan_deep_rows_f32.restype = i32
    if lib.tuun_affine_max_j() != MAX_J:
        raise RuntimeError("scan.cu and scan_ops.MAX_J disagree")
    if lib.tuun_affine_deep_max_j() != MAX_DEEP_J:
        raise RuntimeError("scan.cu and scan_ops.MAX_DEEP_J disagree")
    if lib.tuun_affine_tile() != AFFINE_TILE or any(
            lib.tuun_affine_slots(n, fan) != affine_slots(n, fan)
            for n in (1, 4097, 1 << 21) for fan in AFFINE_FANS):
        raise RuntimeError("scan.cu and scan_ops.affine_slots disagree")
    global _scan_tile, _scratch_words, _deep_tile
    _scan_tile = lib.tuun_scan_tile()
    _scratch_words = lib.tuun_scan_scratch_words()
    _deep_tile = lib.tuun_affine_deep_tile()


def load_library() -> ctypes.CDLL:
    """The scan library (csrc/scan.cu), built and loaded on first use."""
    return kernels.library(kernels.SOURCE, _bind)


def _bind_exact(lib: ctypes.CDLL) -> None:
    """csrc/exact.cu's argtypes, its depth checked and its df tile
    read."""
    global _df_tile
    p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.tuun_recurrence_max_j.argtypes = []
    lib.tuun_recurrence_max_j.restype = i32
    lib.tuun_df_tile.argtypes = [i64]
    lib.tuun_df_tile.restype = i32
    lib.tuun_df_scratch_words.argtypes = [i64]
    lib.tuun_df_scratch_words.restype = i64
    for name in ("tuun_linear_recurrence_rows_f32",
                 "tuun_linear_recurrence_rows_f64"):
        getattr(lib, name).argtypes = [p] * 6 + [i64, i64, i32, p]
        getattr(lib, name).restype = i32
    lib.tuun_df_prefix_sum_rows_f32.argtypes = [p] * 5 + [i64, i64, i64, p]
    lib.tuun_df_prefix_sum_rows_f32.restype = i32
    if lib.tuun_recurrence_max_j() != MAX_RECURRENCE_J:
        raise RuntimeError("exact.cu and scan_ops.MAX_RECURRENCE_J "
                           "disagree")
    _df_tile = lib.tuun_df_tile(DF_SCRATCH_MIN_LANES)


def load_exact_library() -> ctypes.CDLL:
    """The exact precisions' library (csrc/exact.cu), built and loaded on
    first use."""
    return kernels.library(kernels.EXACT_SOURCE, _bind_exact)


def _check_vector(x: torch.Tensor, name: str, dims: int = 1) -> None:
    # Runs on every call, so each message is formatted only when its
    # check fails.  dims = 2: [B, N] rows.
    if x.dtype != torch.float32:
        raise ValueError(f"{name}: expected float32, got {x.dtype}")
    if x.dim() != dims:
        raise ValueError(f"{name}: expected a {dims}-D tensor, got "
                         f"{tuple(x.shape)}")
    if not 1 <= x.shape[-1] <= MAX_N:
        raise ValueError(f"{name}: length {x.shape[-1]} outside [1, {MAX_N}]")
    if x.shape[0] < 1:
        raise ValueError(f"{name}: no rows")
    if not x.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if not (x.is_cuda or x.is_cpu):
        raise ValueError(f"{name}: unsupported device {x.device}")


# ---------------------------------------------------------------------------
# Prefix sum / running max
# ---------------------------------------------------------------------------


def prefix_sum_ref(x: torch.Tensor) -> torch.Tensor:
    """The plain version of both sum forms: along the last axis."""
    return torch.cumsum(x, -1, dtype=torch.float32)


def prefix_max_ref(x: torch.Tensor) -> torch.Tensor:
    """The plain version of both max forms: along the last axis."""
    return torch.cummax(x, -1).values


def _zeroed(words: int, dtype, device: int, what: str) -> torch.Tensor:
    # torch.zeros runs on the current stream, the one the buffer is keyed
    # by, so it is ordered before the kernel that first uses it.
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            f"{what}: this stream has no scratch for this length yet; call "
            f"the scan once on it, at the longest length, before capturing")
    return torch.zeros(words, dtype=dtype, device=device)


def _zeroed_scratch(device: int) -> torch.Tensor:
    return _zeroed(_scratch_words, torch.int64, device, "prefix scan")


def prefix_scratch(device: int, stream: int,
                   alloc=_zeroed_scratch) -> torch.Tensor:
    """The persistent scratch of (device, stream), made on first use.

    Each (device, stream) has its own buffer, so scans on different
    streams may run at the same time.  It comes zeroed from
    `alloc(device)`, at the size of the longest scan, and is kept for the
    life of the process: a captured graph holds its raw pointer, so it
    must never be freed.  The kernel leaves it zeroed after each call.
    Inside a graph_scope the buffer is the scope owner's own."""
    key = _scratch_key(device, stream)
    buf = _scratch.get(key)
    if buf is None:
        with kernels.first_use:
            buf = _scratch.get(key)
            if buf is None:
                buf = _scratch[key] = alloc(device)
    return buf


def _prefix_launch(fn, entry: str, x: torch.Tensor) -> torch.Tensor:
    """Launches `fn`, a rows entry point, on x as rows (a 1-D x is one
    row) and counts the launch under `entry`."""
    n = x.shape[-1]
    rows = x.shape[0] if x.dim() == 2 else 1
    dev = x.get_device()
    # torch.cuda.current_stream(dev).cuda_stream without building a Stream
    # object, which cost ~2 us of host time per call.
    stream = torch._C._cuda_getCurrentRawStream(dev)
    scratch = prefix_scratch(dev, stream).data_ptr() if n > _scan_tile else 0
    if scratch and rows * -(-n // _scan_tile) > _scratch_words - 2:
        raise ValueError(f"{entry}: {rows} rows of {n} lanes exceed the "
                         f"prefix scratch's tiles")
    out = torch.empty_like(x)
    status = fn(x.data_ptr(), out.data_ptr(), scratch, rows, n, stream)
    kernels.launched(entry, status)
    return out


def prefix_sum_f32(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum of a 1-D float32 tensor.

    The CUDA kernel scans each 4096-lane tile (16 lanes in sequence per
    thread, then a shuffle scan across the block) and adds the sum of all
    earlier tiles: the inclusive prefix of the nearest earlier anchor
    tile (every 256th) plus the aggregates of the tiles between, summed by
    a fixed shuffle tree.  That order differs from torch.cumsum's: results
    agree within a bound that grows with the running magnitude (the
    tile's own roundings, the carry's tree, and one rounding per anchor
    passed).  The grouping does not depend on timing, so every call
    gives the same bits."""
    out = kernels.vmapped(prefix_sum_rows_f32, (x,))
    if out is not None:
        return out
    _check_vector(x, "prefix_sum_f32")
    kernels.called("prefix_sum_f32", 1, x.shape[0])
    if x.is_cpu:
        return prefix_sum_ref(x)
    return _prefix_launch(load_library().tuun_prefix_sum_rows_f32,
                          "prefix_sum_f32", x)


def prefix_max_f32(x: torch.Tensor) -> torch.Tensor:
    """Inclusive running max of a 1-D float32 tensor, bit-identical to
    torch.cummax(x, 0).values (NaN propagates; ties take the later lane)."""
    out = kernels.vmapped(prefix_max_rows_f32, (x,))
    if out is not None:
        return out
    _check_vector(x, "prefix_max_f32")
    kernels.called("prefix_max_f32", 1, x.shape[0])
    if x.is_cpu:
        return prefix_max_ref(x)
    return _prefix_launch(load_library().tuun_prefix_max_rows_f32,
                          "prefix_max_f32", x)


def prefix_sum_rows_f32(x: torch.Tensor) -> torch.Tensor:
    """prefix_sum_f32 of each row of a float32 [B, N] tensor, in one
    launch; row r has the bits of prefix_sum_f32(x[r])."""
    _check_vector(x, "prefix_sum_rows_f32", dims=2)
    kernels.called("prefix_sum_rows_f32", *x.shape)
    if x.is_cpu:
        return prefix_sum_ref(x)
    return _prefix_launch(load_library().tuun_prefix_sum_rows_f32,
                          "prefix_sum_rows_f32", x)


def prefix_max_rows_f32(x: torch.Tensor) -> torch.Tensor:
    """prefix_max_f32 of each row of a float32 [B, N] tensor, in one
    launch: bit-identical to torch.cummax(x, -1).values."""
    _check_vector(x, "prefix_max_rows_f32", dims=2)
    kernels.called("prefix_max_rows_f32", *x.shape)
    if x.is_cpu:
        return prefix_max_ref(x)
    return _prefix_launch(load_library().tuun_prefix_max_rows_f32,
                          "prefix_max_rows_f32", x)


# ---------------------------------------------------------------------------
# Affine scan (IIR feedback)
# ---------------------------------------------------------------------------


def affine_scan_ref(a_rows: torch.Tensor, ff: torch.Tensor,
                    live: torch.Tensor, h0: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Companion-matrix composition (tuun_tpu/engine/graph.py:876-897),
    scanned by doubling: after the step of width k, lane i holds the
    composed map of lanes (i-2k, i].  Runs in the inputs' dtype, so
    float64 inputs give the reference the kernel is checked against.
    The plain version of both forms: leading axes (a [..., N, J], ff and
    live [..., N], h0 [..., J]) are rows scanned on their own."""
    n, J = a_rows.shape[-2:]
    lead = a_rows.shape[:-2]
    eye = torch.eye(J, dtype=a_rows.dtype, device=a_rows.device)
    top = -a_rows[..., None, :]
    if J > 1:
        A = torch.cat([top, eye[:-1].expand(*lead, n, J - 1, J)], dim=-2)
    else:
        A = top
    b = torch.cat([ff[..., None], ff.new_zeros((*lead, n, J - 1))], dim=-1)
    A = torch.where(live[..., None, None], A, eye)
    b = torch.where(live[..., None], b, 0.0)
    k = 1
    while k < n:
        Ac, bc = A[..., k:, :, :], b[..., k:, :]
        nA = Ac @ A[..., :-k, :, :]
        nb = (Ac @ b[..., :-k, :, None])[..., 0] + bc
        A = torch.cat([A[..., :k, :, :], nA], dim=-3)
        b = torch.cat([b[..., :k, :], nb], dim=-2)
        k *= 2
    hs = (A @ h0[..., None, :, None])[..., 0] + b
    return hs, hs[..., -1, :].clone()


def affine_y_ref(a_rows: torch.Tensor, ff: torch.Tensor, live: torch.Tensor,
                 h0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of both affine scans' contract, at any J:
    affine_scan_ref's composed companion maps scanned by doubling (the
    math of tuun_tpu's fast mode), then y = h[..., 0] on live lanes and 0
    on dead ones, and the history after the last lane.  In the inputs'
    dtype: float64 inputs give the reference the kernels are checked
    against."""
    hs, hist = affine_scan_ref(a_rows, ff, live, h0)
    return torch.where(live, hs[..., 0], 0.0), hist


def affine_fan(n: int) -> int:
    """The affine scan's look-back fan for rows of n lanes: records fold
    in groups of fan.  64 keeps up to 64 tiles (65536 lanes, the CLI's
    block: 64 blocks) to one look-back hop; past that 32 was the fastest
    fan or within 6% of it at every shape timed on an H100
    (affine_probe.py sweep).  Chosen from n alone, so a row has the bits
    of a single call on it."""
    return 64 if n <= 1 << 16 else 32


@functools.lru_cache(maxsize=None)
def affine_slots(n: int, fan: int) -> int:
    """Look-back records a row of n lanes takes (csrc/scan.cu's
    aff_slots): tiles / fan^l at each level l of the record tree."""
    count = -(-n // AFFINE_TILE)
    total = 0
    while count:
        total += count
        count //= fan
    return total


def affine_capacity(rows: int, n: int) -> int:
    """The records the affine scratch holds for `rows` rows of n lanes:
    never fewer at a longer n (the tile is fixed and a smaller fan only
    adds records), so a warm-up at the longest length serves every
    shorter one."""
    return rows * affine_slots(n, affine_fan(n))


# The feedback depths each affine form takes.
_AFFINE_DEPTHS = (1, MAX_J)
_DEEP_DEPTHS = (MAX_J + 1, MAX_DEEP_J)


def _check_depth(J: int, name: str, depths: Tuple[int, int]) -> None:
    lo, hi = depths
    if not lo <= J <= hi:
        other = "affine_scan_f32" if J <= MAX_J else \
            "affine_scan_deep_f32" if J <= MAX_DEEP_J else "linear_recurrence"
        raise NotImplementedError(
            f"{name}: feedback depth J={J} outside {lo}..{hi} (depth {J} "
            f"runs on {other})")


def _check_affine(a_rows, ff, live, h0, name: str = "affine_scan_f32",
                  depths: Tuple[int, int] = _AFFINE_DEPTHS) -> None:
    # Runs on every call, so each message is formatted only when its
    # check fails.
    if a_rows.dtype != torch.float32 or a_rows.dim() != 2:
        raise ValueError(f"{name}: a_rows must be float32 [N, J], "
                         f"got {a_rows.dtype} {tuple(a_rows.shape)}")
    n, J = a_rows.shape
    _check_depth(J, name, depths)
    _check_vector(ff, f"{name} ff")
    if ff.shape[0] != n:
        raise ValueError(f"{name}: ff length != N")
    if live.dtype != torch.bool or live.shape != (n,):
        raise ValueError(f"{name}: live must be bool [N]")
    if h0.dtype != torch.float32 or h0.shape != (J,):
        raise ValueError(f"{name}: h0 must be float32 [J]")
    _check_layout(a_rows, ff, live, h0, name)


def _check_affine_rows(a_rows, ff, live, h0,
                       name: str = "affine_scan_rows_f32",
                       depths: Tuple[int, int] = _AFFINE_DEPTHS) -> None:
    if a_rows.dtype != torch.float32 or a_rows.dim() != 3:
        raise ValueError(f"{name}: a_rows must be float32 [B, N, J], got "
                         f"{a_rows.dtype} {tuple(a_rows.shape)}")
    B, n, J = a_rows.shape
    _check_depth(J, name, depths)
    _check_vector(ff, f"{name} ff", dims=2)
    if ff.shape != (B, n):
        raise ValueError(f"{name}: ff must be [B, N]")
    if live.dtype != torch.bool or live.shape != (B, n):
        raise ValueError(f"{name}: live must be bool [B, N]")
    if h0.dtype != torch.float32 or h0.shape != (B, J):
        raise ValueError(f"{name}: h0 must be float32 [B, J]")
    _check_layout(a_rows, ff, live, h0, name)


def _check_layout(a_rows, ff, live, h0, name) -> None:
    dev = ff.device
    for x in (a_rows, live, h0):
        if not x.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
        if x.device != dev:
            raise ValueError(f"{name}: inputs on different devices")


def _zeroed_affine_scratch(device: int, records: int) -> torch.Tensor:
    words = load_library().tuun_affine_scratch_words(records)
    return _zeroed(words, torch.int32, device, "affine scan")


def affine_scratch(device: int, stream: int, records: int,
                   alloc=_zeroed_affine_scratch) -> Tuple[torch.Tensor, int]:
    """(buffer, capacity in records) of (device, stream), holding at
    least `records` look-back records (affine_capacity).

    Made on first use, zeroed by `alloc(device, capacity)`, for at least
    the records of AFFINE_SCRATCH_MIN_LANES lanes.  A longer scan gets a
    new buffer of at least twice the capacity; the old one is kept in
    _affine_retired for the life of the process, since a captured graph
    may hold its raw pointer.  The kernel leaves the counters and flags
    zero after each call.  Inside a graph_scope the buffers are the scope
    owner's own."""
    return _grown_scratch(_affine_scratch, device, stream, records,
                          affine_capacity(1, AFFINE_SCRATCH_MIN_LANES), alloc)


def _grown_scratch(table, device: int, stream: int, tiles: int,
                   min_tiles: int, alloc) -> Tuple[torch.Tensor, int]:
    """affine_scratch's rule on `table`: (buffer, capacity) of at least
    max(tiles, min_tiles) tiles, grown by a new buffer of at least twice
    the capacity, an outgrown one kept."""
    key = _scratch_key(device, stream)
    entry = table.get(key)
    if entry is not None and entry[1] >= tiles:
        return entry
    with kernels.first_use:
        entry = table.get(key)
        if entry is not None and entry[1] >= tiles:
            return entry
        cap = max(tiles, min_tiles)
        if entry is not None:
            cap = max(cap, 2 * entry[1])
        buf = alloc(device, cap)
        if entry is not None:
            retired = _affine_retired if len(key) == 2 else \
                _owner_retired.setdefault(key[2], [])
            retired.append(entry[0])
        entry = table[key] = (buf, cap)
        return entry


def affine_scan_f32(a_rows: torch.Tensor, ff: torch.Tensor,
                    live: torch.Tensor, h0: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scans y[i] = ff[i] - sum_j a_rows[i, j] * y[i-1-j] for 1 <= J <=
    MAX_J.

    a_rows f32[N, J]; ff f32[N]; live bool[N] (a dead lane yields 0 and
    passes the history through unchanged); h0 f32[J] = [y[-1] ... y[-J]].
    Returns (y f32[N], hist f32[J], the history after lane N - 1): the
    engine's use of the Pallas kernel's (h, hist), h[:, 0] on live lanes.
    On the CPU, affine_y_ref in float32.

    The CUDA kernel (tuun_affine_scan_rows_f32) builds each segment's map
    column by column, carries the history across segments and tiles by
    composed maps in a fixed grouping (a tree of look-back records), and
    runs the recurrence itself over each quarter segment: every call
    gives the same bits."""
    out = kernels.vmapped(affine_scan_rows_f32, (a_rows, ff, live, h0))
    if out is not None:
        return out
    _check_affine(a_rows, ff, live, h0)
    kernels.called("affine_scan_f32", 1, *a_rows.shape)
    if ff.is_cpu:
        return affine_y_ref(a_rows, ff, live, h0)
    return _affine_launch(a_rows, ff, live, h0, 1, "affine_scan_f32")


def affine_scan_rows_f32(a_rows: torch.Tensor, ff: torch.Tensor,
                         live: torch.Tensor, h0: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """affine_scan_f32 of each of B rows in one launch: a_rows f32[B, N,
    J], ff f32[B, N], live bool[B, N], h0 f32[B, J] -> (y f32[B, N],
    hist f32[B, J]); row r has the bits of a single call on row r."""
    _check_affine_rows(a_rows, ff, live, h0)
    kernels.called("affine_scan_rows_f32", *a_rows.shape)
    if ff.is_cpu:
        return affine_y_ref(a_rows, ff, live, h0)
    return _affine_launch(a_rows, ff, live, h0, ff.shape[0],
                          "affine_scan_rows_f32")


def _zeroed_deep_scratch(device: int, tiles: int) -> torch.Tensor:
    words = load_library().tuun_affine_deep_scratch_words(tiles)
    return _zeroed(words, torch.int32, device, "deep affine scan")


def deep_scratch(device: int, stream: int, tiles: int,
                 alloc=_zeroed_deep_scratch) -> Tuple[torch.Tensor, int]:
    """The deep affine scan's persistent scratch of (device, stream), as
    affine_scratch's: (buffer, capacity in tiles), at least the tiles of
    DEEP_SCRATCH_MIN_LANES lanes, grown by a new buffer for a longer scan,
    an outgrown one kept."""
    return _grown_scratch(_deep_scratch, device, stream, tiles,
                          -(-DEEP_SCRATCH_MIN_LANES // _deep_tile), alloc)


def _deep_cpu(a_rows, ff, live, h0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both deep forms on the CPU: the plain version in float64, rounded
    to float32.  A float32 doubling scan rounds by how a render groups
    its lanes, so a tracker window of several blocks would differ from
    the same blocks rendered one by one by more than summation order
    (phase 8's bound); in float64 the CPU stays as close to the
    recurrence's result as the linear recurrence it replaces."""
    y, hist = affine_y_ref(a_rows.double(), ff.double(), live, h0.double())
    return y.float(), hist.float()


def affine_scan_deep_f32(a_rows: torch.Tensor, ff: torch.Tensor,
                         live: torch.Tensor, h0: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """y[i] = ff[i] - sum_j a_rows[i, j] * y[i-1-j] for MAX_J < J <=
    MAX_DEEP_J, with affine_scan_f32's contract: (y f32[N], 0 on dead
    lanes; hist f32[J], the history after lane N - 1).  On the CPU, the
    plain version in float64 (_deep_cpu).

    The CUDA kernel (tuun_affine_scan_deep_rows_f32) builds each
    32-lane segment's map column by column, composes them in shared
    memory, carries the history across tiles by a look-back in a fixed
    grouping, and runs the recurrence itself over each segment: every
    call gives the same bits."""
    out = kernels.vmapped(affine_scan_deep_rows_f32,
                          (a_rows, ff, live, h0))
    if out is not None:
        return out
    _check_affine(a_rows, ff, live, h0, "affine_scan_deep_f32", _DEEP_DEPTHS)
    kernels.called("affine_scan_deep_f32", 1, *a_rows.shape)
    if ff.is_cpu:
        return _deep_cpu(a_rows, ff, live, h0)
    return _deep_launch(a_rows, ff, live, h0, 1, "affine_scan_deep_f32")


def affine_scan_deep_rows_f32(a_rows: torch.Tensor, ff: torch.Tensor,
                              live: torch.Tensor, h0: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """affine_scan_deep_f32 of each of B rows in one launch: a_rows
    f32[B, N, J], ff f32[B, N], live bool[B, N], h0 f32[B, J] -> (y
    f32[B, N], hist f32[B, J]); row r has the bits of a single call on
    row r."""
    _check_affine_rows(a_rows, ff, live, h0, "affine_scan_deep_rows_f32",
                       _DEEP_DEPTHS)
    kernels.called("affine_scan_deep_rows_f32", *a_rows.shape)
    if ff.is_cpu:
        return _deep_cpu(a_rows, ff, live, h0)
    return _deep_launch(a_rows, ff, live, h0, ff.shape[0],
                        "affine_scan_deep_rows_f32")


def _affine_launch(a_rows, ff, live, h0, rows: int, entry: str):
    """Launches the affine scan's rows kernel on `rows` rows (1: a single
    voice's unbatched operands) at affine_fan(n), counted under `entry`:
    (y, hist)."""
    lib = load_library()
    n = ff.shape[-1]
    dev = ff.get_device()
    stream = torch._C._cuda_getCurrentRawStream(dev)
    scratch, cap = affine_scratch(dev, stream, affine_capacity(rows, n)) \
        if n > AFFINE_TILE else (None, 0)
    return _launch_affine(lib.tuun_affine_scan_rows_f32, stream, scratch, cap,
                          a_rows, ff, live, h0, rows, entry, affine_fan(n))


def _deep_launch(a_rows, ff, live, h0, rows: int, entry: str):
    """As _affine_launch, for the deep form's kernel: (y, hist)."""
    lib = load_library()
    dev = ff.get_device()
    stream = torch._C._cuda_getCurrentRawStream(dev)
    per_row = -(-ff.shape[-1] // _deep_tile)
    scratch, cap = deep_scratch(dev, stream, rows * per_row) \
        if per_row > 1 else (None, 0)
    return _launch_affine(lib.tuun_affine_scan_deep_rows_f32, stream,
                          scratch, cap, a_rows, ff, live, h0, rows, entry)


def _launch_affine(kernel, stream: int, scratch, cap: int, a_rows, ff,
                   live, h0, rows: int, entry: str, *geometry: int):
    """Launches `kernel`, a rows entry of the library, on `stream`,
    writing y and the final history, with `scratch` (None when a row is
    one tile) of `cap` records or tiles and the kernel's `geometry`
    arguments; counts the launch under `entry`.  Returns (y, hist)."""
    n, J = a_rows.shape[-2:]
    y = torch.empty_like(ff)
    hist = torch.empty(h0.shape, dtype=torch.float32, device=ff.device)
    sp = scratch.data_ptr() if scratch is not None else 0
    status = kernel(a_rows.data_ptr(), ff.data_ptr(), live.data_ptr(),
                    h0.data_ptr(), y.data_ptr(), hist.data_ptr(), sp, cap,
                    rows, n, J, *geometry, stream)
    kernels.launched(entry, status)
    return y, hist


# ---------------------------------------------------------------------------
# Linear recurrence (exact-mode IIR feedback)
# ---------------------------------------------------------------------------


def linear_recurrence_ref(a_rows: torch.Tensor, ff: torch.Tensor,
                          live: torch.Tensor, h0: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The recurrence lane by lane in the reference's op order
    (tuun_tpu/engine/graph.py:852-864): acc = ff[i], then acc = acc -
    a[i, j] * h[j] for j = 0..J-1, each op rounded on its own; a dead lane
    yields 0 and passes the history through.  The plain version of both
    forms, in the inputs' dtype: leading axes (a [..., N, J], ff and live
    [..., N], h0 [..., J]) are rows run side by side."""
    n = ff.shape[-1]
    ffl = ff.unbind(-1)
    lvl = live.unbind(-1)
    lanes = a_rows.unbind(-2)
    h = h0.clone(memory_format=torch.contiguous_format)
    # Lanes live (or dead) in every row skip the selects, which would
    # leave every value as it is: the same bits in fewer ops.
    flat = live.reshape(-1, n)
    all_live = flat.all(0).tolist()
    any_live = flat.any(0).tolist()
    ys = []
    for i in range(n):
        acc = ffl[i]
        # A lane's J products in one op, each rounded on its own; then
        # the differences in order.
        for prod in (lanes[i] * h).unbind(-1):
            acc = acc - prod
        if all_live[i]:
            h = torch.cat([acc.unsqueeze(-1), h[..., :-1]], -1)
        elif not any_live[i]:
            acc = torch.zeros_like(acc)
        else:
            lv = lvl[i]
            acc = torch.where(lv, acc, 0.0)
            h = torch.where(lv.unsqueeze(-1), torch.cat(
                [acc.unsqueeze(-1), h[..., :-1]], -1), h)
        ys.append(acc)
    return torch.stack(ys, -1), h


def _check_recurrence(a_rows, ff, live, h0, rows: bool) -> None:
    # Runs on every call, so each message is formatted only when its
    # check fails.
    name = "linear_recurrence_rows" if rows else "linear_recurrence"
    lead = 1 if rows else 0
    if a_rows.dtype not in (torch.float32, torch.float64) \
            or a_rows.dim() != 2 + lead:
        raise ValueError(f"{name}: a_rows must be float32 or float64 "
                         f"{'[B, N, J]' if rows else '[N, J]'}, got "
                         f"{a_rows.dtype} {tuple(a_rows.shape)}")
    n, J = a_rows.shape[-2:]
    if not 1 <= J <= MAX_RECURRENCE_J:
        raise ValueError(f"{name}: feedback depth J={J} outside 1.."
                         f"{MAX_RECURRENCE_J}")
    if not 1 <= n <= MAX_N or (rows and a_rows.shape[0] < 1):
        raise ValueError(f"{name}: shape {tuple(a_rows.shape)} outside the "
                         f"kernel's range")
    lead_shape = tuple(a_rows.shape[:lead])
    if ff.dtype != a_rows.dtype or ff.shape != (*lead_shape, n):
        raise ValueError(f"{name}: ff must be {a_rows.dtype} "
                         f"{(*lead_shape, n)}")
    if live.dtype != torch.bool or live.shape != (*lead_shape, n):
        raise ValueError(f"{name}: live must be bool {(*lead_shape, n)}")
    if h0.dtype != a_rows.dtype or h0.shape != (*lead_shape, J):
        raise ValueError(f"{name}: h0 must be {a_rows.dtype} "
                         f"{(*lead_shape, J)}")
    if not ff.is_contiguous():
        raise ValueError(f"{name}: inputs must be contiguous")
    _check_layout(a_rows, ff, live, h0, name)


def _suffix(dtype) -> str:
    return "f32" if dtype == torch.float32 else "f64"


def linear_recurrence(a_rows: torch.Tensor, ff: torch.Tensor,
                      live: torch.Tensor, h0: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Runs y[i] = ff[i] - sum_j a_rows[i, j] * y[i-1-j] in sequence.

    a_rows [N, J], ff [N], h0 [J] = [y[-1] ... y[-J]], all float32 or all
    float64; live bool[N] (a dead lane yields 0 and passes the history
    through).  Returns (y [N], hist [J], the history after lane N - 1).
    Any J up to MAX_RECURRENCE_J.

    The CUDA kernel (tuun_linear_recurrence_rows_{f32,f64}) runs the
    chain in the plain version's op order, every product and difference
    rounded on its own: the same bits as linear_recurrence_ref."""
    out = kernels.vmapped(linear_recurrence_rows, (a_rows, ff, live, h0))
    if out is not None:
        return out
    _check_recurrence(a_rows, ff, live, h0, rows=False)
    kernels.called(f"linear_recurrence_{_suffix(ff.dtype)}", 1, *a_rows.shape)
    if ff.is_cpu:
        return linear_recurrence_ref(a_rows, ff, live, h0)
    return _recurrence_launch(a_rows, ff, live, h0, 1,
                              f"linear_recurrence_{_suffix(ff.dtype)}")


def linear_recurrence_rows(a_rows: torch.Tensor, ff: torch.Tensor,
                           live: torch.Tensor, h0: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """linear_recurrence of each of B rows in one launch: a [B, N, J], ff
    and live [B, N], h0 [B, J] -> (y [B, N], hist [B, J]); row r has the
    bits of a single call on row r."""
    _check_recurrence(a_rows, ff, live, h0, rows=True)
    kernels.called(f"linear_recurrence_rows_{_suffix(ff.dtype)}",
                   *a_rows.shape)
    if ff.is_cpu:
        return linear_recurrence_ref(a_rows, ff, live, h0)
    return _recurrence_launch(a_rows, ff, live, h0, ff.shape[0],
                              f"linear_recurrence_rows_{_suffix(ff.dtype)}")


def _recurrence_launch(a_rows, ff, live, h0, rows: int, entry: str):
    lib = load_exact_library()
    n, J = a_rows.shape[-2:]
    dev = ff.get_device()
    stream = torch._C._cuda_getCurrentRawStream(dev)
    y = torch.empty_like(ff)
    hist = torch.empty_like(h0)
    fn = lib.tuun_linear_recurrence_rows_f32 if ff.dtype == torch.float32 \
        else lib.tuun_linear_recurrence_rows_f64
    status = fn(a_rows.data_ptr(), ff.data_ptr(), live.data_ptr(),
                h0.data_ptr(), y.data_ptr(), hist.data_ptr(), rows, n, J,
                stream)
    kernels.launched(entry, status)
    return y, hist


# ---------------------------------------------------------------------------
# Compensated (double-single) prefix sum
# ---------------------------------------------------------------------------


def df_prefix_sum_ref(xh: torch.Tensor, xl: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive prefix of df32.df_add over (hi, lo) pairs along the last
    axis, by doubling (Hillis-Steele): after the step of width k, lane i
    holds the sum of lanes (i - 2k, i], the earlier operand first.  The
    plain version of both forms."""
    from .df32 import df_add
    n = xh.shape[-1]
    xh, xl = xh.clone(), xl.clone()
    k = 1
    while k < n:
        sh, sl = df_add(xh[..., :-k], xl[..., :-k], xh[..., k:], xl[..., k:])
        xh = torch.cat([xh[..., :k], sh], dim=-1)
        xl = torch.cat([xl[..., :k], sl], dim=-1)
        k *= 2
    return xh, xl


def _check_df(xh, xl, dims: int, name: str) -> None:
    _check_vector(xh, f"{name} hi", dims)
    _check_vector(xl, f"{name} lo", dims)
    if xl.shape != xh.shape or xl.device != xh.device:
        raise ValueError(f"{name}: hi and lo differ in shape or device")


def df_prefix_sum_f32(xh: torch.Tensor, xl: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compensated inclusive prefix sum of a 1-D float32 (hi, lo) pair:
    df32.df_cumsum's scan (tuun_tpu/engine/df32.py:118-130).

    The CUDA kernel (tuun_df_prefix_sum_rows_f32) is a single-pass scan
    with decoupled look-back over pairs in a fixed grouping: every call
    gives the same bits.  df_add is not associative, so those bits differ
    from the plain doubling scan's (and XLA's) in the last compensated
    bits; each holds f64-class accuracy against the float64 cumsum."""
    out = kernels.vmapped(df_prefix_sum_rows_f32, (xh, xl))
    if out is not None:
        return out
    _check_df(xh, xl, 1, "df_prefix_sum_f32")
    kernels.called("df_prefix_sum_f32", 1, xh.shape[0])
    if xh.is_cpu:
        return df_prefix_sum_ref(xh, xl)
    return _df_launch(xh, xl, 1, "df_prefix_sum_f32")


def df_prefix_sum_rows_f32(xh: torch.Tensor, xl: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """df_prefix_sum_f32 of each row of [B, N] float32 pairs in one
    launch; row r has the bits of a single call on row r."""
    _check_df(xh, xl, 2, "df_prefix_sum_rows_f32")
    kernels.called("df_prefix_sum_rows_f32", *xh.shape)
    if xh.is_cpu:
        return df_prefix_sum_ref(xh, xl)
    return _df_launch(xh, xl, xh.shape[0], "df_prefix_sum_rows_f32")


def _zeroed_df_scratch(device: int, tiles: int) -> torch.Tensor:
    words = load_exact_library().tuun_df_scratch_words(tiles)
    return _zeroed(words, torch.int32, device, "df prefix sum")


def df_scratch(device: int, stream: int, tiles: int,
               alloc=_zeroed_df_scratch) -> Tuple[torch.Tensor, int]:
    """The df prefix sum's persistent scratch of (device, stream), as
    affine_scratch's: (buffer, capacity in tiles), grown by a new buffer
    for a longer scan, an outgrown one kept."""
    return _grown_scratch(_df_scratch, device, stream, tiles,
                          -(-DF_SCRATCH_MIN_LANES // _df_tile), alloc)


def _df_launch(xh, xl, rows: int, entry: str):
    lib = load_exact_library()
    n = xh.shape[-1]
    dev = xh.get_device()
    stream = torch._C._cuda_getCurrentRawStream(dev)
    per_row = -(-n // lib.tuun_df_tile(n))
    scratch, cap = df_scratch(dev, stream, rows * per_row) \
        if per_row > 1 else (None, 0)
    oh = torch.empty_like(xh)
    ol = torch.empty_like(xl)
    sp = scratch.data_ptr() if scratch is not None else 0
    status = lib.tuun_df_prefix_sum_rows_f32(
        xh.data_ptr(), xl.data_ptr(), oh.data_ptr(), ol.data_ptr(), sp, cap,
        rows, n, stream)
    kernels.launched(entry, status)
    return oh, ol

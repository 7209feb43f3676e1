"""The engine's interval gates: a block's lanes selected by the active
interval [s, e) in one kernel.

    interval_gate(idx, s, e, a, b) == where((idx >= s) & (idx < e), a, b)
    interval_mask(idx, s, e) == (idx >= s) & (idx < e)

where idx is a block's lane index, torch.arange(n).  No TPU kernel is
ported: the JAX engine leaves the gate to XLA's fusion.  In eager
PyTorch the expression is four full-width kernels (two broadcast int64
compares, the `&`, the `where`); on a CUDA tensor this module launches
csrc/lanes.cu's one kernel instead, which tests the interval in the
thread and selects in the same pass (the mask form writes the bool
mask).  A CPU tensor takes the plain version beside it, over the same
operand layouts the kernel reads.  Nothing falls back to the plain
version on the card.

Operands: s and e are ints or int64 0-dim tensors; a and b are floats
or float32 tensors of shape () or [n] (the output is float32 [n]).
Under torch.func.vmap (a voice group's render) each entry point hands
the batch to its rows form (`interval_gate_rows`, `interval_mask_rows`)
through kernels.vmapped, which leaves each operand in place with the
voice axis first: the kernel reads each operand's row stride, so the
output is [voices, n] in one launch, and an operand vmap does not batch
is read by every row (row stride 0), never copied.
Launches are counted in kernels.launches under `interval_gate` and
`interval_mask` (a captured graph's at every replay); neither records a
scan marker.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple, Union

import torch

from . import kernels

GATE = "interval_gate"
MASK = "interval_mask"

# An operand's lane mode, as csrc/lanes.cu reads it.
ROW = 0        # one value a row (lane stride 0)
LANES = 1      # lane stride 1
LANES_VEC = 2  # lane stride 1, every row 16-byte aligned

Scalar = Union[int, float, torch.Tensor]
# (values or None for the immediate, row stride, immediate)
Bound = Tuple[Optional[torch.Tensor], int, int]
# (values or None for the immediate, row stride, lane mode, immediate)
Operand = Tuple[Optional[torch.Tensor], int, int, float]


def _bind(lib: ctypes.CDLL) -> None:
    p, i64, i32, f = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                      ctypes.c_float)
    lib.tuun_interval_gate_rows_f32.argtypes = [
        p, i64, i64, p, i64, i64, p, i64, i64,
        p, i64, i32, f, p, i64, i32, f, p]
    lib.tuun_interval_gate_rows_f32.restype = i32
    lib.tuun_interval_mask_rows.argtypes = [
        p, i64, i64, p, i64, i64, p, i64, i64, p]
    lib.tuun_interval_mask_rows.restype = i32


def load_library() -> ctypes.CDLL:
    """csrc/lanes.cu's library, built (beside the scans', at once) and
    loaded on first use."""
    return kernels.library(kernels.LANES_SOURCE, _bind)


# ---------------------------------------------------------------------------
# Operands as the kernel reads them
# ---------------------------------------------------------------------------


def _check(x: torch.Tensor, dtype, device: torch.device, what: str) -> None:
    if x.dtype != dtype:
        raise ValueError(f"{what}: expected {dtype}, got {x.dtype}")
    if x.device != device:
        raise ValueError(f"{what}: expected a tensor on {device}, got "
                         f"{x.device}")


def _bound(x: Scalar, rows: bool, device: torch.device,
           what: str) -> Bound:
    """An interval end as the kernel reads it: one int64 a row.  With
    rows, x holds one a voice at its row stride; else every row shares
    it."""
    if not isinstance(x, torch.Tensor):
        return None, 0, int(x)
    _check(x, torch.int64, device, what)
    if x.dim() != int(rows):
        raise ValueError(f"{what}: expected one end a voice, got shape "
                         f"{tuple(x.shape)}")
    return x, x.stride(0) if rows else 0, 0


def _operand(x: Scalar, rows: bool, n: int, device: torch.device,
             what: str) -> Operand:
    """A select operand as the kernel reads it: an immediate, one value a
    row, or n lanes a row, with its row stride.  With rows, x has the
    voice axis first (row stride 0 where every row shares it); else every
    row shares x."""
    if not isinstance(x, torch.Tensor):
        return None, 0, ROW, float(x)
    _check(x, torch.float32, device, what)
    lanes = x.shape[1:] if rows else x.shape
    rs = x.stride(0) if rows else 0
    if lanes == ():
        return x, rs, ROW, 0.0
    if lanes != (n,):
        raise ValueError(f"{what}: expected shape () or ({n},) a voice, "
                         f"got {tuple(lanes)}")
    if n > 1 and x.stride(-1) == 0:  # an expanded value: one a row
        return x, rs, ROW, 0.0
    if n > 1 and x.stride(-1) != 1:
        if rs == 0:  # one row that every row reads: copied once
            x = (x[0] if rows else x).contiguous()
        else:
            x, rs = x.contiguous(), n
    vec = x.data_ptr() % 16 == 0 and rs % 4 == 0
    return x, rs, LANES_VEC if vec else LANES, 0.0


# ---------------------------------------------------------------------------
# Plain versions, over the operands as the kernel reads them
# ---------------------------------------------------------------------------


def _bound_rows(b: Bound, rows: int) -> torch.Tensor:
    x, rs, imm = b
    if x is None:
        return torch.full((rows, 1), imm, dtype=torch.int64)
    return torch.as_strided(x, (rows, 1), (rs, 0), x.storage_offset())


def _operand_rows(o: Operand, rows: int, n: int) -> torch.Tensor:
    x, rs, mode, imm = o
    if x is None:
        return torch.full((rows, n), imm, dtype=torch.float32)
    return torch.as_strided(x, (rows, n), (rs, 0 if mode == ROW else 1),
                            x.storage_offset())


def mask_rows_ref(rows: int, n: int, s: Bound, e: Bound) -> torch.Tensor:
    """The mask kernel's plain version: bool [rows, n]."""
    i = torch.arange(n)
    return (i >= _bound_rows(s, rows)) & (i < _bound_rows(e, rows))


def gate_rows_ref(rows: int, n: int, s: Bound, e: Bound, a: Operand,
                  b: Operand) -> torch.Tensor:
    """The gate kernel's plain version: float32 [rows, n]."""
    return torch.where(mask_rows_ref(rows, n, s, e),
                       _operand_rows(a, rows, n), _operand_rows(b, rows, n))


# ---------------------------------------------------------------------------
# Launches
# ---------------------------------------------------------------------------


def _gate_rows(rows: int, n: int, s: Bound, e: Bound, a: Operand,
               b: Operand, device: torch.device, shape) -> torch.Tensor:
    if device.type == "cpu":
        return gate_rows_ref(rows, n, s, e, a, b).reshape(shape)
    out = torch.empty(shape, dtype=torch.float32, device=device)
    dev = out.get_device()
    status = load_library().tuun_interval_gate_rows_f32(
        out.data_ptr(), rows, n, *_bound_args(s), *_bound_args(e),
        *_operand_args(a), *_operand_args(b),
        torch._C._cuda_getCurrentRawStream(dev))
    kernels.launched(GATE, status)
    return out


def _mask_rows(rows: int, n: int, s: Bound, e: Bound, device: torch.device,
               shape) -> torch.Tensor:
    if device.type == "cpu":
        return mask_rows_ref(rows, n, s, e).reshape(shape)
    out = torch.empty(shape, dtype=torch.bool, device=device)
    dev = out.get_device()
    status = load_library().tuun_interval_mask_rows(
        out.data_ptr(), rows, n, *_bound_args(s), *_bound_args(e),
        torch._C._cuda_getCurrentRawStream(dev))
    kernels.launched(MASK, status)
    return out


def _bound_args(b: Bound) -> Tuple:
    x, rs, imm = b
    return (None if x is None else x.data_ptr()), rs, imm


def _operand_args(o: Operand) -> Tuple:
    x, rs, mode, imm = o
    return (None if x is None else x.data_ptr()), rs, mode, imm


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def interval_gate_rows(idx: torch.Tensor, s: Scalar, e: Scalar, a: Scalar,
                       b: Scalar) -> torch.Tensor:
    """interval_gate of [rows, n] lanes in one launch: idx [rows, n] (its
    shape and device are read), s and e ints or int64 [rows], a and b
    floats or float32 [rows] or [rows, n]; each tensor with the voice
    axis first, at any row stride (0: one value every row reads).
    float32 [rows, n]."""
    rows, n = idx.shape
    dev = idx.device
    return _gate_rows(rows, n, _bound(s, True, dev, "s"),
                      _bound(e, True, dev, "e"),
                      _operand(a, True, n, dev, "a"),
                      _operand(b, True, n, dev, "b"), dev, (rows, n))


def interval_gate(idx: torch.Tensor, s: Scalar, e: Scalar, a: Scalar,
                  b: Scalar) -> torch.Tensor:
    """torch.where((idx >= s) & (idx < e), a, b) for a block's lane index
    idx = torch.arange(n): float32 [n], or [voices, n] under vmap
    (interval_gate_rows, one launch)."""
    out = kernels.vmapped(interval_gate_rows, (idx, s, e, a, b),
                          contiguous=False)
    if out is not None:
        return out
    n, dev = idx.shape[-1], idx.device
    return _gate_rows(1, n, _bound(s, False, dev, "s"),
                      _bound(e, False, dev, "e"),
                      _operand(a, False, n, dev, "a"),
                      _operand(b, False, n, dev, "b"), dev, (n,))


def interval_mask_rows(idx: torch.Tensor, s: Scalar, e: Scalar
                       ) -> torch.Tensor:
    """interval_mask of [rows, n] lanes in one launch, its operands as
    interval_gate_rows': bool [rows, n]."""
    rows, n = idx.shape
    dev = idx.device
    return _mask_rows(rows, n, _bound(s, True, dev, "s"),
                      _bound(e, True, dev, "e"), dev, (rows, n))


def interval_mask(idx: torch.Tensor, s: Scalar, e: Scalar) -> torch.Tensor:
    """(idx >= s) & (idx < e) for a block's lane index idx =
    torch.arange(n): bool [n], or [voices, n] under vmap
    (interval_mask_rows, one launch)."""
    out = kernels.vmapped(interval_mask_rows, (idx, s, e), contiguous=False)
    if out is not None:
        return out
    n, dev = idx.shape[-1], idx.device
    return _mask_rows(1, n, _bound(s, False, dev, "s"),
                      _bound(e, False, dev, "e"), dev, (n,))

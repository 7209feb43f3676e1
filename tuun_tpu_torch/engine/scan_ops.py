"""The engine's cross-lane scans: inclusive prefix sum, running max, and
the affine scan that runs IIR filter feedback.

Counterpart of tuun_tpu/engine/pallas_ops.py.  Each public entry point
dispatches on the device of its input:

  * a CPU tensor takes the plain PyTorch version beside it (`*_ref`);
  * a CUDA tensor launches the hand-written kernel in csrc/scan.cu, or
    raises.  Nothing falls back to the plain version.

The kernels build with nvcc into `_build/` at the first CUDA call, keyed
by a hash of the source and flags, and bind through ctypes.  Each entry
point counts its kernel launches in `launches` (reset with
`reset_launches`), so a run can show which kernels its path reached.

Unlike the TPU kernels, these take any length from 1 to 2^31 - 1 (no
multiple-of-128 or 2^21 limit) and the affine scan any J from 1 to
MAX_J = 8, so the engine never needs a plain path on the card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Dict, Tuple

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
SOURCE = PKG_DIR / "csrc" / "scan.cu"
BUILD_DIR = PKG_DIR / "_build"
# No --use_fast_math: it would swap in approximate division and
# transcendentals (see the FMA and sinf notes in ROADMAP.md queue 3).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
MAX_J = 8
MAX_N = 2 ** 31 - 1

launches: Dict[str, int] = {"prefix_sum_f32": 0, "prefix_max_f32": 0,
                            "affine_scan_f32": 0}

_lib = None


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME): the scan "
                           "kernels build with nvcc")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def build_library() -> Path:
    """Compiles csrc/scan.cu unless a build of this exact source exists."""
    src = SOURCE.read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    lib = BUILD_DIR / f"libtuun_scan_{digest[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {SOURCE}:\n{proc.stderr}")
    os.replace(tmp, lib)  # atomic: concurrent builders converge
    return lib


def load_library() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build_library()))
    p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    for name in ("tuun_scan_tile", "tuun_affine_tile", "tuun_affine_max_j"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = i32
    for name in ("tuun_prefix_sum_f32", "tuun_prefix_max_f32"):
        getattr(lib, name).argtypes = [p, p, p, i64, p]
        getattr(lib, name).restype = i32
    lib.tuun_affine_scan_f32.argtypes = [p, p, p, p, p, p, p, p, i64, i32, p]
    lib.tuun_affine_scan_f32.restype = i32
    if lib.tuun_affine_max_j() != MAX_J:
        raise RuntimeError("scan.cu and scan_ops.MAX_J disagree")
    _lib = lib
    return lib


def _check(status: int, name: str) -> None:
    if status != 0:
        raise RuntimeError(f"{name}: CUDA error {status} at launch")


def _stream(device: torch.device):
    return torch.cuda.current_stream(device).cuda_stream


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check_vector(x: torch.Tensor, name: str) -> None:
    _require(x.dtype == torch.float32, f"{name}: expected float32, got {x.dtype}")
    _require(x.dim() == 1, f"{name}: expected a 1-D tensor, got {tuple(x.shape)}")
    _require(1 <= x.shape[0] <= MAX_N, f"{name}: length {x.shape[0]} "
             f"outside [1, {MAX_N}]")
    _require(x.is_contiguous(), f"{name}: expected a contiguous tensor")
    _require(x.device.type in ("cpu", "cuda"),
             f"{name}: unsupported device {x.device}")


# ---------------------------------------------------------------------------
# Prefix sum / running max
# ---------------------------------------------------------------------------


def prefix_sum_ref(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(x, 0, dtype=torch.float32)


def prefix_max_ref(x: torch.Tensor) -> torch.Tensor:
    return torch.cummax(x, 0).values


def _prefix_launch(entry: str, x: torch.Tensor) -> torch.Tensor:
    lib = load_library()
    n = x.shape[0]
    tile = lib.tuun_scan_tile()
    out = torch.empty_like(x)
    agg = torch.empty((n + tile - 1) // tile, dtype=torch.float32,
                      device=x.device)
    _check(getattr(lib, f"tuun_{entry}")(
        x.data_ptr(), out.data_ptr(), agg.data_ptr(), n,
        _stream(x.device)), entry)
    launches[entry] += 1
    return out


def prefix_sum_f32(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum of a 1-D float32 tensor.

    The CUDA kernel sums each 2048-lane tile and then adds the tile's
    prefix, an order that differs from torch.cumsum's: results agree
    within a bound that grows with the running magnitude (one rounding of
    the carry per lane on top of the tile's own)."""
    _check_vector(x, "prefix_sum_f32")
    if x.device.type == "cpu":
        return prefix_sum_ref(x)
    return _prefix_launch("prefix_sum_f32", x)


def prefix_max_f32(x: torch.Tensor) -> torch.Tensor:
    """Inclusive running max of a 1-D float32 tensor, bit-identical to
    torch.cummax(x, 0).values (NaN propagates; ties take the later lane)."""
    _check_vector(x, "prefix_max_f32")
    if x.device.type == "cpu":
        return prefix_max_ref(x)
    return _prefix_launch("prefix_max_f32", x)


# ---------------------------------------------------------------------------
# Affine scan (IIR feedback)
# ---------------------------------------------------------------------------


def affine_scan_ref(a_rows: torch.Tensor, ff: torch.Tensor,
                    live: torch.Tensor, h0: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Companion-matrix composition (tuun_tpu/engine/graph.py:876-897),
    scanned by doubling: after the step of width k, lane i holds the
    composed map of lanes (i-2k, i].  Runs in the inputs' dtype, so
    float64 inputs give the reference the kernel is checked against."""
    n, J = a_rows.shape
    eye = torch.eye(J, dtype=a_rows.dtype, device=a_rows.device)
    top = -a_rows[:, None, :]
    if J > 1:
        A = torch.cat([top, eye[:-1].expand(n, J - 1, J)], dim=1)
    else:
        A = top
    b = torch.cat([ff[:, None], ff.new_zeros((n, J - 1))], dim=1)
    A = torch.where(live[:, None, None], A, eye)
    b = torch.where(live[:, None], b, 0.0)
    k = 1
    while k < n:
        Ac, bc = A[k:], b[k:]
        nA = Ac @ A[:-k]
        nb = (Ac @ b[:-k, :, None])[..., 0] + bc
        A = torch.cat([A[:k], nA])
        b = torch.cat([b[:k], nb])
        k *= 2
    hs = (A @ h0) + b
    return hs, hs[-1].clone()


def _check_affine(a_rows, ff, live, h0) -> None:
    _require(a_rows.dtype == torch.float32 and a_rows.dim() == 2,
             f"affine_scan_f32: a_rows must be float32 [N, J], got "
             f"{a_rows.dtype} {tuple(a_rows.shape)}")
    n, J = a_rows.shape
    if not 1 <= J <= MAX_J:
        raise NotImplementedError(
            f"affine_scan_f32: feedback depth J={J} outside 1..{MAX_J} "
            f"(deeper filters: ROADMAP.md queue 2)")
    _check_vector(ff, "affine_scan_f32 ff")
    _require(ff.shape[0] == n, "affine_scan_f32: ff length != N")
    _require(live.dtype == torch.bool and live.shape == (n,),
             "affine_scan_f32: live must be bool [N]")
    _require(h0.dtype == torch.float32 and h0.shape == (J,),
             "affine_scan_f32: h0 must be float32 [J]")
    for t in (a_rows, live, h0):
        _require(t.is_contiguous(), "affine_scan_f32: inputs must be "
                 "contiguous")
        _require(t.device == ff.device, "affine_scan_f32: inputs on "
                 "different devices")


def affine_scan_f32(a_rows: torch.Tensor, ff: torch.Tensor,
                    live: torch.Tensor, h0: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scans y[i] = ff[i] - sum_j a_rows[i, j] * y[i-1-j].

    a_rows f32[N, J]; ff f32[N]; live bool[N] (dead lanes pass the history
    through unchanged); h0 f32[J] = [y[-1] ... y[-J]].  Returns
    (h f32[N, J] with h[i, j] = y[i-j], hist f32[J] = h[N-1])."""
    _check_affine(a_rows, ff, live, h0)
    if ff.device.type == "cpu":
        return affine_scan_ref(a_rows, ff, live, h0)
    lib = load_library()
    n, J = a_rows.shape
    tile = lib.tuun_affine_tile()
    nb = (n + tile - 1) // tile
    dev = ff.device
    h = torch.empty((n, J), dtype=torch.float32, device=dev)
    hist = torch.empty(J, dtype=torch.float32, device=dev)
    agg = torch.empty(nb * (J * J + J), dtype=torch.float32, device=dev)
    hin = torch.empty((nb + 1) * J, dtype=torch.float32, device=dev)
    _check(lib.tuun_affine_scan_f32(
        a_rows.data_ptr(), ff.data_ptr(), live.data_ptr(), h0.data_ptr(),
        h.data_ptr(), hist.data_ptr(), agg.data_ptr(), hin.data_ptr(), n, J,
        _stream(dev)), "affine_scan_f32")
    launches["affine_scan_f32"] += 1
    return h, hist

"""ctypes bridge to the native (C++) oracle engine.

Encodes a Waveform IR as a flat pre-order program and drives
native/tuun_native.cpp — a sample-exact C++ port of the reference
generator's per-sample semantics.  Used for fast long-window golden
generation in differential tests and host-side length computation; the
shared library builds on demand with g++ (cached next to the source).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path
from typing import List, Tuple

import numpy as np

from . import ir

NATIVE_DIR = Path(__file__).resolve().parent.parent / "native"
SOURCE = NATIVE_DIR / "tuun_native.cpp"
LIB = NATIVE_DIR / "libtuun_native.so"

OP_CONST, OP_TIME, OP_NOISE, OP_FIXED, OP_FIN, OP_APPEND, OP_SINE, \
    OP_FILTER, OP_BINOP, OP_RESET, OP_ALT, OP_MARKED, OP_CAPTURED = range(13)

_OPERATOR_IDS = {
    ir.Operator.ADD: 0, ir.Operator.SUBTRACT: 1, ir.Operator.MULTIPLY: 2,
    ir.Operator.DIVIDE: 3, ir.Operator.MERGE: 4, ir.Operator.POWER: 5,
}

_lib = None


def build_library(force: bool = False) -> Path:
    """Compiles the shared library if missing or stale.

    Staleness is decided by a content hash of the source recorded at build
    time, not mtime: a stale (or tampered) binary next to a newer-looking
    source would otherwise load silently. The binary itself is never
    committed — it rebuilds from tuun_native.cpp in ~2 s on first use."""
    import hashlib

    stamp = NATIVE_DIR / "libtuun_native.sha256"
    want = hashlib.sha256(SOURCE.read_bytes()).hexdigest()
    if (LIB.exists() and not force and stamp.exists()
            and stamp.read_text().strip() == want):
        return LIB
    # Built beside the library and moved into place whole (os.replace),
    # stamp last: a process that loads the library meanwhile (a test
    # worker, tuun_tpu's copy of this loader) never sees a partial file.
    tmp = LIB.with_name(f"{LIB.name}.{os.getpid()}.tmp")
    cmd = ["g++", "-O2", "-std=c++17", "-shared", "-fPIC",
           str(SOURCE), "-o", str(tmp)]
    subprocess.run(cmd, check=True, capture_output=True)
    os.replace(tmp, LIB)
    stamp_tmp = stamp.with_name(f"{stamp.name}.{os.getpid()}.tmp")
    stamp_tmp.write_text(want)
    os.replace(stamp_tmp, stamp)
    return LIB


def _load():
    global _lib
    if _lib is not None:
        return _lib
    build_library()
    lib = ctypes.CDLL(str(LIB))
    lib.tn_create.restype = ctypes.c_void_p
    lib.tn_create.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.c_int32, ctypes.c_uint32]
    lib.tn_generate.restype = ctypes.c_int64
    lib.tn_generate.argtypes = [ctypes.c_void_p,
                                ctypes.POINTER(ctypes.c_float),
                                ctypes.c_int64]
    lib.tn_length.restype = ctypes.c_int64
    lib.tn_length.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.tn_reset.argtypes = [ctypes.c_void_p]
    lib.tn_destroy.argtypes = [ctypes.c_void_p]
    lib.tnt_create.restype = ctypes.c_void_p
    lib.tnt_create.argtypes = [ctypes.c_int32]
    lib.tnt_play.restype = ctypes.c_int64
    lib.tnt_play.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.c_int64, ctypes.c_uint32, ctypes.c_int64]
    lib.tnt_render.restype = ctypes.c_int64
    lib.tnt_render.argtypes = [ctypes.c_void_p,
                               ctypes.POINTER(ctypes.c_float),
                               ctypes.c_int64]
    lib.tnt_stop.restype = ctypes.c_int32
    lib.tnt_stop.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.tnt_now.restype = ctypes.c_int64
    lib.tnt_now.argtypes = [ctypes.c_void_p]
    lib.tnt_destroy.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def native_available() -> bool:
    try:
        _load()
        return True
    except Exception:
        return False


def encode(w: ir.Waveform) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pre-order flat encoding: (nodes i32[n,4], consts f32[], data f32[]).
    Node uids (noise stream ids) are assigned in pre-order, matching
    oracle.initialize."""
    nodes: List[Tuple[int, int, int, int]] = []
    consts: List[float] = []
    data: List[np.ndarray] = []
    data_len = 0
    uid_counter = [0]

    def walk(node: ir.Waveform) -> None:
        nonlocal data_len
        uid = uid_counter[0]
        uid_counter[0] += 1
        if isinstance(node, ir.Const):
            consts.append(np.float32(node.value))
            nodes.append((OP_CONST, len(consts) - 1, 0, 0))
        elif isinstance(node, ir.Time):
            nodes.append((OP_TIME, 0, 0, 0))
        elif isinstance(node, ir.Noise):
            nodes.append((OP_NOISE, uid, 0, 0))
        elif isinstance(node, ir.Fixed):
            data.append(np.asarray(node.samples, np.float32))
            nodes.append((OP_FIXED, data_len, len(node.samples), 0))
            data_len += len(node.samples)
        elif isinstance(node, ir.Fin):
            nodes.append((OP_FIN, 0, 0, 0))
        elif isinstance(node, ir.Append):
            nodes.append((OP_APPEND, 0, 0, 0))
        elif isinstance(node, ir.Sine):
            nodes.append((OP_SINE, 0, 0, 0))
        elif isinstance(node, ir.Filter):
            nodes.append((OP_FILTER, len(node.feed_forward),
                          len(node.feedback), 0))
        elif isinstance(node, ir.BinaryPointOp):
            nodes.append((OP_BINOP, _OPERATOR_IDS[node.op], 0, 0))
        elif isinstance(node, ir.Reset):
            nodes.append((OP_RESET, 0, 0, 0))
        elif isinstance(node, ir.Alt):
            nodes.append((OP_ALT, 0, 0, 0))
        elif isinstance(node, ir.Marked):
            nodes.append((OP_MARKED, 0, 0, 0))
        elif isinstance(node, ir.Captured):
            nodes.append((OP_CAPTURED, 0, 0, 0))
        else:
            raise TypeError(type(node))
        for child in node.children():
            walk(child)

    walk(w)
    nodes_arr = np.asarray(nodes, np.int32).reshape(-1, 4)
    consts_arr = np.asarray(consts, np.float32)
    data_arr = (np.concatenate(data) if data else
                np.zeros(0, np.float32)).astype(np.float32)
    return nodes_arr, consts_arr, data_arr


class NativeOracle:
    """A stateful native generator for one waveform (resumable blocks)."""

    def __init__(self, w: ir.Waveform, sample_rate: int, seed: int = 0):
        lib = _load()
        nodes, consts, data = encode(w)
        self._lib = lib
        nodes = np.ascontiguousarray(nodes)
        consts = np.ascontiguousarray(consts)
        data = np.ascontiguousarray(data)
        self._handle = lib.tn_create(
            nodes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(nodes),
            consts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            len(consts),
            data.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            len(data), sample_rate, seed)
        if not self._handle:
            raise RuntimeError("failed to build native waveform program")

    def generate(self, out: np.ndarray) -> int:
        assert out.dtype == np.float32 and out.flags.c_contiguous
        return self._lib.tn_generate(
            self._handle, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            len(out))

    def length(self, maxn: int) -> int:
        return self._lib.tn_length(self._handle, maxn)

    def reset(self) -> None:
        self._lib.tn_reset(self._handle)

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.tn_destroy(self._handle)
            self._handle = None


def render(w: ir.Waveform, n: int, sample_rate: int, seed: int = 0,
           block: int = 0) -> np.ndarray:
    """Drop-in for oracle.render backed by the native engine."""
    o = NativeOracle(w, sample_rate, seed)
    out = np.zeros(n, dtype=np.float32)
    if block <= 0:
        ln = o.generate(out)
        return out[:ln]
    total = 0
    while total < n:
        m = min(block, n - total)
        ln = o.generate(out[total:total + m])
        total += ln
        if ln < m:
            break
    return out[:total]


class NativeTracker:
    """Native (C++) multi-voice mixer/scheduler: the host-side runtime
    analogue of tracker.rs's audio callback — pending voices promote at
    their start sample (mid-block starts are in-block offsets), late
    starts catch up by generating-and-discarding, active voices mix
    additively, finished voices retire. The TPU tracker
    (tuun_tpu.tracker) is the production path; this is the fast native
    CPU fallback (native/tuun_native.cpp Tracker)."""

    def __init__(self, sample_rate: int):
        self._lib = _load()
        self._handle = self._lib.tnt_create(sample_rate)
        self.sample_rate = sample_rate

    def play(self, w: ir.Waveform, start: int = -1, seed: int = 0,
             repeat_every: int = 0) -> int:
        nodes, consts, data = encode(w)
        nodes = np.ascontiguousarray(nodes)
        consts = np.ascontiguousarray(consts)
        data = np.ascontiguousarray(data)
        vid = self._lib.tnt_play(
            self._handle,
            nodes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(nodes),
            consts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            len(consts),
            data.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            len(data), start, seed, repeat_every)
        if vid < 0:
            raise RuntimeError("failed to build native voice program")
        return int(vid)

    def render(self, count: int) -> Tuple[np.ndarray, int]:
        """Mixes the next `count` samples; returns (mix, active_voices)."""
        out = np.zeros(count, dtype=np.float32)
        active = self._lib.tnt_render(
            self._handle,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), count)
        return out, int(active)

    def stop(self, voice_id: int) -> bool:
        return bool(self._lib.tnt_stop(self._handle, voice_id))

    @property
    def now(self) -> int:
        return int(self._lib.tnt_now(self._handle))

    def run_to_completion(self, block: int = 1024,
                          max_seconds: float = 120.0) -> np.ndarray:
        chunks = []
        budget = int(max_seconds * self.sample_rate)
        while budget > 0:
            out, active = self.render(min(block, budget))
            chunks.append(out)
            budget -= len(out)
            if active == 0:
                break
        return np.concatenate(chunks) if chunks else \
            np.zeros(0, np.float32)

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.tnt_destroy(self._handle)
            self._handle = None

#!/usr/bin/env python3
"""Probes the affine scan's kernels (tuun_tpu_torch/csrc/scan.cu) and the
linear recurrence (csrc/exact.cu) on one CUDA card: where a call's time
goes, what ptxas makes of each instance, and how the geometry moves the
time.  Run from the root of a checkout, on a machine with a card and
nvcc:

    python3 affine_probe.py split [--tree DIR]
    python3 affine_probe.py sweep [--tree DIR]
    python3 affine_probe.py recurrence [--tree DIR] [--parent DIR]

`split` is for a tree whose J <= 8 affine scan is the per-thread
register-map kernel (affine_single_pass, h f32[N, J] out; every commit
before that kernel's redesign).  It compiles two copies of that tree's
csrc/scan.cu into chip_work/affine_probe/ (gitignored):

  * one with clock64() stamps that thread 0 of each block takes at the
    kernel's phase boundaries (entry, loads done, maps pushed, block map
    scan done, look-back done, recurrence done, store done), read back
    from a device array after the call: each phase's mean and largest
    cycles a block, over the blocks of a call, at the main path's shapes
    (J = 2 at 65536 lanes, J = 3 at 2^20, rows (8, 1024, 2) and (64,
    1024, 3));
  * one whose deep entry also takes J = 5-8 (affine_deep_pass
    instantiated below its range), built with -Xptxas -v: registers and
    spills of both kernels, and the device time of the two kernels at J
    = 5-8 on 65536 and 2^17 lanes (one CUDA graph of 50 calls, replayed).

`sweep` is for a tree with the redesigned kernel (tuun_affine_scan_rows_f32
taking the look-back fan; the warps a block, kAffWarps, built in turn at 2,
4 and 8): ptxas's registers and spills for it; the device time of each
main-path shape at every warps and fan, held to the float64 plain
version and to its own bits,
beside the geometry scan_ops chooses; there, the same kernel loading by
bulk asynchronous copies (TMA) instead of 16-byte loads; and the phase
split of its blocks by clock64() stamps.

`recurrence` builds copies of the tree's csrc/exact.cu into
chip_work/affine_probe/, each with a watchdog (a stage wait traps after
~2^26 tries instead of hanging; rec_watchdog_source): as the engine has
it, with -Xptxas -v (registers and spills of every linear_recurrence<T,
J>); with clock64 and global-timer stamps (rec_probe_source) that split
each row's call into the chain's wait for stages, its lanes, the
producer's y stores and fills, and the first stage's arrival after the
block starts; and as REC_VARIANTS (other group widths and lookaheads,
the producer's loads instead of bulk copies), each made by replacing
text in the copy, as `sweep` does for scan.cu.  With --parent DIR, that
checkout's exact.cu too, as it is.  At each of REC_SHAPES, on
all-live lanes and on chip_smoke.py's mixed input, every build is first
held to the engine build's bits (and to the one-step check and its own
bits on a second call; exit 1 on any miss), then timed: the parent and
the engine build in turns, each variant in turns with the engine build,
and the split (the chain form's, J <= 16; past it, the wide form, which
no variant changes, is timed beside the parent alone).

Prints one JSON object a measurement (and appends it to --out FILE) and
the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from chip_smoke import graph_ms, stable_feedback

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "chip_work" / "affine_probe"
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC"]
STAMPS = 7
MAX_STAMPED_TILES = 1 << 16
PHASES = ("load", "map build", "block map scan", "look-back", "recurrence",
          "store")
# The redesigned kernel's phases: the boundaries its stamps mark.
NEW_PHASES = ("load", "column build", "map scan", "look-back",
              "entering histories", "recurrence", "store")
# (rows or None for a single call, n, J)
SPLIT_SHAPES = ((None, 1 << 16, 2), (None, 1 << 20, 3), (8, 1024, 2),
                (64, 1024, 3))
DEEP_VS_SINGLE = tuple((J, n) for n in (1 << 16, 1 << 17)
                       for J in (5, 6, 7, 8))


# --out FILE: each JSON line is appended there too.
OUT = None


def emit(**row) -> None:
    """Prints row as one JSON line and appends it to OUT, when given."""
    line = json.dumps(row)
    print(line, flush=True)
    if OUT is not None:
        OUT.parent.mkdir(parents=True, exist_ok=True)
        with OUT.open("a") as f:
            f.write(line + "\n")


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def sm_clock_mhz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True, check=True).stdout
    return float(out.split()[0])


def nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def patch(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise SystemExit(f"the source does not hold exactly one {old!r}")
    return src.replace(old, new)


def stamped_source(src: str) -> str:
    """The tree's scan.cu with thread 0's clock64() stamps at the phase
    boundaries of affine_single_pass, kept in g_aff_stamps[tile]."""
    def stamp(k):
        return f"  if (threadIdx.x == 0) st_[{k}] = clock64();\n"
    src = patch(src, "template <int J, bool kRows>\n__global__ void "
                "__launch_bounds__(kAffThreads)",
                f"__device__ unsigned long long g_aff_stamps"
                f"[{MAX_STAMPED_TILES} * {STAMPS}];\n\n"
                "template <int J, bool kRows>\n__global__ void "
                "__launch_bounds__(kAffThreads)")
    first = "  const int64_t nbr = (n + kAffTile - 1) / kAffTile;  // tiles per row\n"
    src = patch(src, first, f"  unsigned long long st_[{STAMPS}];\n"
                + stamp(0) + first)
    loaded = ("      live_s[e] = e < avail ? live[base + e] : 0;\n    }\n  }\n"
              "  __syncthreads();\n")
    src = patch(src, loaded, loaded + stamp(1))
    scan = ("  Map<J> total;\n  const Map<J> excl = "
            "block_exclusive_scan_maps<J>(P, warp_maps, &total);\n")
    src = patch(src, scan, stamp(2) + scan + stamp(3))
    rec = "  // The recurrence over the thread's lanes from its entering history, in\n"
    src = patch(src, rec, stamp(4) + rec)
    store = "  // Store: coalesced, from the padded rows.\n"
    src = patch(src, store, stamp(5) + store)
    clean = ("  // The last block to finish its look-back leaves the scratch "
             "clean.\n  if (nbr > 1 && last_block) {\n    unsigned* all = "
             "scratch + kAffHead;\n    for (int64_t i = threadIdx.x; i < nb; "
             "i += kAffThreads)")
    src = patch(src, clean, stamp(6) + (
        f"  if (threadIdx.x == 0 && gt < {MAX_STAMPED_TILES}) {{\n"
        f"    for (int k = 0; k < {STAMPS}; ++k) "
        f"g_aff_stamps[gt * {STAMPS} + k] = st_[k];\n  }}\n") + clean)
    return src + (
        "\nextern \"C\" int tuun_probe_stamps(unsigned long long* dst, "
        "long long count) {\n  return (int)cudaMemcpyFromSymbol(dst, "
        "g_aff_stamps, count * sizeof(unsigned long long));\n}\n")


def stamped_new_source(src: str) -> str:
    """The tree's scan.cu with thread 0's clock64() stamps at the phase
    boundaries of the redesigned affine_scan_pass (NEW_PHASES)."""
    def stamp(k):
        return f"  if (threadIdx.x == 0) st_[{k}] = clock64();\n"
    n = len(NEW_PHASES) + 1
    src = patch(src, "template <int J, bool kRows>\n__global__ void "
                "__launch_bounds__(kAffThreads)",
                f"__device__ unsigned long long g_aff_stamps"
                f"[{MAX_STAMPED_TILES} * {n}];\n"
                f"__device__ unsigned long long g_aff_times"
                f"[{MAX_STAMPED_TILES} * 3];\n"
                "__device__ __forceinline__ unsigned long long gtimer() {\n"
                "  unsigned long long t;\n"
                "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
                "  return t;\n}\n\n"
                "template <int J, bool kRows>\n__global__ void "
                "__launch_bounds__(kAffThreads)")
    first = "  const int64_t nbr = (n + tile - 1) / tile;  // tiles per row\n"
    src = patch(src, first, f"  unsigned long long st_[{n}];\n" + stamp(0)
                + first)
    built = "  // Segment s's map, column by column"
    src = patch(src, built, stamp(1) + built)
    pub = "\n        }\n      }\n      float* X = xl + l * kMap;\n"
    src = patch(src, pub, "\n          g_aff_times[gt * 3 + 1] = gtimer();" + pub)
    ent = "  const int64_t base = t * tile;\n"
    src = patch(src, ent, ent + "  if (threadIdx.x == 0 && gt < "
                + str(MAX_STAMPED_TILES) + ") g_aff_times[gt * 3] = gtimer();\n")
    lbend = "  // The recurrence over each quarter segment"
    src = patch(src, lbend, "  if (threadIdx.x == 0 && gt < " + str(MAX_STAMPED_TILES)
                + ") g_aff_times[gt * 3 + 2] = gtimer();\n" + lbend)
    for k, mark in ((2, "  // Each warp scans its eight segment maps"),
                    (3, "  // The history entering the tile.  Fixed grouping"),
                    (4, "  // The recurrence over each quarter segment"),
                    (5, "    const int i0 = q * kAffQuarter;\n")):
        src = patch(src, mark, stamp(k) + mark)
    store = "  // Store from the padded segment rows: segment s by its quad.\n"
    src = patch(src, store, stamp(6) + store)
    clean = "      y[e] = f_s[e / kAffSeg * L::kSegF + e % kAffSeg];\n    }\n  }\n"
    src = patch(src, clean, clean + stamp(7) + (
        f"  if (threadIdx.x == 0 && gt < {MAX_STAMPED_TILES}) {{\n"
        f"    for (int k = 0; k < {n}; ++k) "
        f"g_aff_stamps[gt * {n} + k] = st_[k];\n  }}\n"))
    return src + (
        "\nextern \"C\" int tuun_probe_stamps(unsigned long long* dst, "
        "long long count) {\n  return (int)cudaMemcpyFromSymbol(dst, "
        "g_aff_stamps, count * sizeof(unsigned long long));\n}\n"
        "\nextern \"C\" int tuun_probe_times(unsigned long long* dst, "
        "long long count) {\n  return (int)cudaMemcpyFromSymbol(dst, "
        "g_aff_times, count * sizeof(unsigned long long));\n}\n")


def read_times(torch, lib, call, nb):
    """Per tile, in ns from the call's first block start (the card's global
    timer): when its tile index came, when it published its record, when
    its look-back ended; one call after a warm one."""
    call()
    call()
    torch.cuda.synchronize()
    buf = torch.zeros(nb * 3, dtype=torch.int64)
    status = lib.tuun_probe_times(buf.data_ptr(), nb * 3)
    if status != 0:
        raise SystemExit(f"times: CUDA error {status}")
    t = buf.view(nb, 3).numpy().astype(np.int64)
    t0 = t[:, 0].min()
    return dict(start_ns=(t[:, 0] - t0).tolist(),
                publish_ns=[int(x - t0) if x else None for x in t[:, 1]],
                lookback_end_ns=(t[:, 2] - t0).tolist())


def read_split(torch, lib, call, nb, phases):
    """Each phase's mean and largest cycles a block over 10 calls (after
    10 warm ones), from the stamps of `nb` blocks."""
    stamps = len(phases) + 1
    out = []
    for _ in range(20):
        call()
        torch.cuda.synchronize()
        buf = torch.zeros(nb * stamps, dtype=torch.int64)
        status = lib.tuun_probe_stamps(buf.data_ptr(), nb * stamps)
        if status != 0:
            raise SystemExit(f"stamps: CUDA error {status}")
        out.append(np.diff(buf.view(nb, stamps).numpy().astype(np.int64),
                           axis=1))
    d = np.concatenate(out[10:])
    clock = sm_clock_mhz()
    return dict(sm_clock_mhz=clock,
                mean_cycles={p: float(d[:, i].mean())
                             for i, p in enumerate(phases)},
                max_cycles={p: int(d[:, i].max())
                            for i, p in enumerate(phases)},
                mean_block_us=float(d.sum(1).mean()) / clock)


BULK_HELPERS = r"""
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, "
        "[%1], %2;\nselp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

"""

BULK_LOADS = r"""  __shared__ __align__(8) unsigned long long load_bar;
  const bool aligned =
      (((uintptr_t)a | (uintptr_t)ff | (uintptr_t)live) & 15) == 0;
  if (whole && aligned) {
    const unsigned bar = smem_addr(&load_bar);
    if (threadIdx.x == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(bar)
                   : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                   :: "r"(bar), "r"((unsigned)(tile * (4 * J + 5)))
                   : "memory");
    }
    __syncthreads();
    if (warp == 0) {
      for (int k = lane; k < kAffSegs; k += 32) {
        bulk_load(a_s + k * L::kSegA, a + k * kAffSeg * J, 4 * kAffSeg * J,
                  bar);
        bulk_load(f_s + k * L::kSegF, ff + k * kAffSeg, 4 * kAffSeg, bar);
      }
      if (lane == 0) bulk_load(live_s, live, tile, bar);
    }
    mbar_wait(bar, 0);
  } else if (whole && aligned) {
"""


def bulk_source(src: str) -> str:
    """The tree's scan.cu whose affine scan loads an aligned whole tile by
    bulk asynchronous copies (TMA, 1D) on one mbarrier: warp 0's lane k
    copies segment k's a and ff, lane 0 the live bytes."""
    src = patch(src, "template <int J, bool kRows>\n__global__ void "
                "__launch_bounds__(kAffThreads)", BULK_HELPERS +
                "template <int J, bool kRows>\n__global__ void "
                "__launch_bounds__(kAffThreads)")
    return patch(src, "  if (whole && (((uintptr_t)a | (uintptr_t)ff | "
                 "(uintptr_t)live) & 15) == 0) {\n    const float4* a4",
                 BULK_LOADS + "    const float4* a4")


def deep_below_source(src: str) -> str:
    """The tree's scan.cu whose deep entry also takes J = 5..8."""
    case9 = "    case 9: return run_affine_deep<9>("
    extra = "".join(f"    case {J}: return run_affine_deep<{J}>(a, ff, live, "
                    f"h0, y, hist, scratch, cap, rows, n, s);\n"
                    for J in (5, 6, 7, 8))
    return patch(src, case9, extra + case9)


def build(name: str, src: str, verbose: bool) -> tuple:
    WORK.mkdir(parents=True, exist_ok=True)
    cu, so = WORK / f"{name}.cu", WORK / f"lib{name}.so"
    cu.write_text(src)
    flags = FLAGS + (["-Xptxas", "-v"] if verbose else [])
    proc = subprocess.run([nvcc(), *flags, "-o", str(so), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed on {cu}:\n{proc.stderr}")
    return so, proc.stderr


def ptxas_rows(log: str, kernels: tuple) -> list:
    """(kernel, J, rows form, registers, spill stores, spill loads) of each
    instance ptxas reports for `kernels` (mangled names)."""
    out, cur, spill = [], None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            cur = next((k for k in kernels if k in name), None)
            args = re.search(r"ILi(\d+)E(?:Lb(\d)E)?", name)
            if cur and args:
                cur = (cur, int(args.group(1)), args.group(2) == "1")
            else:
                cur = None
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            out.append(dict(kernel=cur[0], J=cur[1], rows_form=cur[2],
                            registers=int(m.group(1)),
                            spill_stores=spill[0], spill_loads=spill[1]))
            cur = None
    return out


def inputs(torch, rng, rows, n, J):
    lead = (rows,) if rows else ()
    a = np.broadcast_to(stable_feedback(J).astype(np.float32),
                        (*lead, n, J)).copy()
    ff = rng.standard_normal((*lead, n)).astype(np.float32)
    live = rng.random((*lead, n)) > 0.1
    h0 = rng.standard_normal((*lead, J)).astype(np.float32)
    return tuple(torch.from_numpy(x).cuda() for x in (a, ff, live, h0))


def old_call(torch, lib, args, tile, deep=False):
    """A closure launching the old entry (or the deep one) on args."""
    a, ff, live, h0 = args
    n, J = a.shape[-2:]
    rows = ff.shape[0] if ff.dim() == 2 else 1
    tiles = rows * -(-n // tile)
    words = (lib.tuun_affine_deep_scratch_words if deep
             else lib.tuun_affine_scratch_words)(tiles)
    scratch = torch.zeros(words, dtype=torch.int32, device="cuda")
    out = torch.empty_like(ff) if deep else torch.empty_like(a)
    hist = torch.empty_like(h0)
    fn = (lib.tuun_affine_scan_deep_rows_f32 if deep
          else lib.tuun_affine_scan_rows_f32)

    def call():
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(a.data_ptr(), ff.data_ptr(), live.data_ptr(),
                    h0.data_ptr(), out.data_ptr(), hist.data_ptr(),
                    scratch.data_ptr(), tiles, rows, n, J, stream)
        if status != 0:
            raise SystemExit(f"launch failed: CUDA error {status}")
    return call, out, hist


def bind_old(lib) -> None:
    p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    for name in ("tuun_affine_scan_rows_f32", "tuun_affine_scan_deep_rows_f32"):
        getattr(lib, name).argtypes = [p] * 7 + [i64, i64, i64, i32, p]
        getattr(lib, name).restype = i32
    for name in ("tuun_affine_scratch_words", "tuun_affine_deep_scratch_words"):
        getattr(lib, name).argtypes = [i64]
        getattr(lib, name).restype = i64
    for name in ("tuun_affine_tile", "tuun_affine_deep_tile"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = i32


def split(tree: Path) -> None:
    import torch
    src = (tree / "tuun_tpu_torch" / "csrc" / "scan.cu").read_text()
    with ThreadPoolExecutor(2) as pool:
        stamped = pool.submit(build, "stamped", stamped_source(src), False)
        below = pool.submit(build, "deep_below", deep_below_source(src), True)
        (stamped_so, _), (below_so, ptxas) = stamped.result(), below.result()
    for row in ptxas_rows(ptxas, ("affine_single_pass", "affine_deep_pass")):
        emit(what="ptxas", **row)
    lib = ctypes.CDLL(str(stamped_so))
    bind_old(lib)
    lib.tuun_probe_stamps.argtypes = [ctypes.c_void_p, ctypes.c_longlong]
    lib.tuun_probe_stamps.restype = ctypes.c_int
    tile = lib.tuun_affine_tile()
    rng = np.random.default_rng(0)
    for rows, n, J in SPLIT_SHAPES:
        args = inputs(torch, rng, rows, n, J)
        call, _, _ = old_call(torch, lib, args, tile)
        nb = (rows or 1) * -(-n // tile)
        emit(what="old kernel phase split", rows=rows, n=n, J=J, tiles=nb,
             **read_split(torch, lib, call, nb, PHASES),
             device_us_stamped=graph_ms(torch, call) * 1e3)
    lib = ctypes.CDLL(str(below_so))
    bind_old(lib)
    deep_tile = lib.tuun_affine_deep_tile()
    for J, n in DEEP_VS_SINGLE:
        args = inputs(torch, rng, None, n, J)
        single, h, _ = old_call(torch, lib, args, tile)
        deep, y, _ = old_call(torch, lib, args, deep_tile, deep=True)
        single()
        deep()
        torch.cuda.synchronize()
        live = args[2]
        agree = float((torch.where(live, h[:, 0], 0.0) - y).abs().max())
        times = {}
        for label, fn in (("single", single), ("deep", deep),
                          ("deep ", deep), ("single ", single)):
            times.setdefault(label.strip(), []).append(
                graph_ms(torch, fn) * 1e3)
        emit(what="deep vs single", J=J, n=n,
             single_device_us=times["single"], deep_device_us=times["deep"],
             max_abs_diff_y=agree)


# The linear recurrence (csrc/exact.cu).  (rows or None, n, J, dtype) of
# `recurrence`: the main path's shapes (2^17-lane blocks of the long
# render and the shape gate, the CLI's 65536, the live block and a live
# group of 8) at lpf's J = 2 and filter_4_3's J = 3 in both types, the
# deep filters' J = 9, 12, 16 at 2^17, and the wide form's J = 17, 24, 32
# and 64 at the same four shapes in f32, J = 17 and 32 at 2^17 in f64.
REC_MAIN = ((None, 1 << 17), (None, 1 << 16), (None, 1024), (8, 1024))
REC_SHAPES = tuple((rows, n, J, dt) for dt in ("f32", "f64") for J in (2, 3)
                   for rows, n in REC_MAIN) + tuple(
    (None, 1 << 17, J, "f32") for J in (9, 12, 16)) + tuple(
    (rows, n, J, "f32") for J in (17, 24, 32, 64) for rows, n in REC_MAIN) \
    + tuple((None, 1 << 17, J, "f64") for J in (17, 32))
# The deepest J whose history the chain form keeps in registers: deeper
# rows take the wide form, which the variants and the clock64 split (all
# of the chain form) leave as it is.
REC_REG_J = 16
# Copies of exact.cu timed beside the engine's: (name, {text: replacement}).
REC_GROUP = "  return J <= 4 ? 64 : 32;"
REC_AHEAD = "  return J <= 8 ? 4 : 2;"
REC_BULK = "  const bool bulk =\n"
REC_VARIANTS = (("groups of 32", {REC_GROUP: "  return 32;"}),
                ("groups of 64", {REC_GROUP: "  return 64;"}),
                ("ahead 2", {REC_AHEAD: "  return 2;"}),
                ("ahead 8", {REC_AHEAD: "  return 8;"}),
                ("no bulk copies", {REC_BULK: "  const bool bulk = false &&\n"}))
# --quick: the shapes of REC_SHAPES that PERF.md's headline rows take.
REC_QUICK = ((None, 1 << 17, 2, "f32"), (None, 1024, 2, "f32"),
             (None, 1 << 17, 2, "f64"), (None, 1 << 17, 3, "f32"),
             (None, 1 << 17, 9, "f32"), (None, 1 << 17, 16, "f32"),
             (None, 1 << 17, 17, "f32"), (None, 1 << 17, 32, "f32"),
             (None, 1024, 17, "f32"))
# Instances whose SASS `recurrence --sass DIR` keeps (mangled name parts).
REC_SASS = ("linear_recurrenceIfLi2EE", "linear_recurrenceIdLi2EE",
            "linear_recurrenceIfLi16EE")
REC_WORDS = ("wait_cycles", "chain_cycles", "first_stage_ns", "store_cycles",
             "fill_cycles", "stages", "chain_end_ns", "bulk")
# Live patterns of the inputs: chip_smoke.recurrence_input's default (5%
# dead lanes and a run of 64: ~19% of 32-lane groups all live) and every
# lane live (the path's: lanes die only past a voice's fin).
REC_LIVE = ("mixed", "live")


def rec_watchdog_source(src: str) -> str:
    """exact.cu whose mbarrier wait traps after ~2^26 tries instead of
    waiting for ever on a stage that never comes."""
    src = patch(src, "  unsigned done;\n  do {\n",
                "  unsigned done, tries = 0;\n  do {\n")
    return patch(src, '"memory");\n  } while (!done);',
                 '"memory");\n    if (++tries == (1u << 26)) __trap();\n'
                 "  } while (!done);")


def rec_probe_source(src: str) -> str:
    """exact.cu with the split's stamps in rec_chain_row, per row (the
    first kRecProbeRows) in g_rec_probe, read by tuun_rec_probe_read:
    REC_WORDS in order, cycles by clock64() and ns by %globaltimer."""
    defs = """// The probe's split, per row: REC_WORDS of affine_probe.py.
constexpr int kRecProbeRows = 64;
constexpr int kRecProbeWords = 8;
__device__ unsigned long long g_rec_probe[kRecProbeRows * kRecProbeWords];
__device__ __forceinline__ unsigned long long rec_gtimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

"""
    c0 = "const unsigned long long c0 = clock64();\n"
    for old, new in (
            ("// A 16-byte shared-memory load of V", defs + "// A 16-byte "
             "shared-memory load of V"),
            ("  const int lane = threadIdx.x & 31;\n  if (threadIdx.x == 0) "
             "{\n    for (int s = 0; s < kRecStages; ++s) {",
             "  const int lane = threadIdx.x & 31;\n  const unsigned long "
             "long t_start = rec_gtimer();\n  if (threadIdx.x == 0) {\n    "
             "for (int s = 0; s < kRecStages; ++s) {"),
            ("  if (warp == 1) {\n",
             "  if (warp == 1) {\n    unsigned long long c_store = 0, c_fill "
             "= 0;\n"),
            ("      mbar_wait(&empty[s], (unsigned)(d / kRecStages) & 1u);\n",
             "      mbar_wait(&empty[s], (unsigned)(d / kRecStages) & 1u);\n"
             "      " + c0),
            ("y[drain.st + e] = ys[e];\n",
             "y[drain.st + e] = ys[e];\n      c_store += clock64() - c0;\n"),
            ("      if (k >= kRecStages) store();\n",
             "      if (k >= kRecStages) store();\n      " + c0),
            ("      mbar_arrive(&full[s]);\n    }\n    while (drain.st < n) "
             "store();\n",
             "      mbar_arrive(&full[s]);\n      c_fill += clock64() - c0;\n"
             "    }\n    while (drain.st < n) store();\n"
             "    if (lane == 0 && blockIdx.x < kRecProbeRows) {\n"
             "      g_rec_probe[blockIdx.x * kRecProbeWords + 3] = c_store;\n"
             "      g_rec_probe[blockIdx.x * kRecProbeWords + 4] = c_fill;\n"
             "      g_rec_probe[blockIdx.x * kRecProbeWords + 7] = bulk;\n"
             "    }\n"),
            ("    T h[J];\n#pragma unroll\n    for (int j = 0; j < J; ++j) "
             "h[j] = h0[j];\n    RecStage st(n, head);\n",
             "    unsigned long long c_wait = 0, c_chain = 0, t_first = 0;\n"
             "    T h[J];\n#pragma unroll\n    for (int j = 0; j < J; ++j) "
             "h[j] = h0[j];\n    RecStage st(n, head);\n"),
            ("      mbar_wait(&full[s], (unsigned)(st.k / kRecStages) & 1u);\n",
             "      " + c0 +
             "      mbar_wait(&full[s], (unsigned)(st.k / kRecStages) & 1u);\n"
             "      const unsigned long long c1 = clock64();\n"
             "      c_wait += c1 - c0;\n"
             "      if (st.k == 0) t_first = rec_gtimer();\n"),
            ("(int)st.len, h, lane);\n      mbar_arrive(&empty[s]);\n",
             "(int)st.len, h, lane);\n      c_chain += clock64() - c1;\n"
             "      mbar_arrive(&empty[s]);\n"),
            ("      for (int j = 0; j < J; ++j) hist[j] = h[j];\n    }\n  }\n}\n",
             "      for (int j = 0; j < J; ++j) hist[j] = h[j];\n    }\n"
             "    if (lane == 0 && blockIdx.x < kRecProbeRows) {\n"
             "      unsigned long long* p = g_rec_probe + blockIdx.x * "
             "kRecProbeWords;\n"
             "      p[0] = c_wait;\n      p[1] = c_chain;\n"
             "      p[2] = t_first - t_start;\n      p[5] = st.k;\n"
             "      p[6] = rec_gtimer() - t_start;\n    }\n  }\n}\n")):
        src = patch(src, old, new)
    return src + """
// The split words of the first `rows` rows of the last call.
extern "C" int tuun_rec_probe_read(unsigned long long* dst, long long rows) {
  return (int)cudaMemcpyFromSymbol(
      dst, g_rec_probe, (size_t)rows * kRecProbeWords * sizeof(unsigned long long));
}
"""


def rec_build(name: str, src: str, verbose=False) -> tuple:
    """Builds the source text `src` (build()); returns the library, bound
    (the probe's read too, where `src` has it), and nvcc's stderr."""
    t0 = time.perf_counter()
    so, log = build(name, src, verbose)
    emit(what="build", name=name, seconds=time.perf_counter() - t0)
    lib = ctypes.CDLL(str(so))
    p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    for entry in ("tuun_linear_recurrence_rows_f32",
                  "tuun_linear_recurrence_rows_f64"):
        getattr(lib, entry).argtypes = [p] * 6 + [i64, i64, i32, p]
        getattr(lib, entry).restype = i32
    if "tuun_rec_probe_read" in src:
        lib.tuun_rec_probe_read.argtypes = [p, i64]
        lib.tuun_rec_probe_read.restype = i32
    return lib, log


def rec_ptxas(log: str) -> list:
    """(type, J, registers, spill stores, spill loads) of each instance of
    linear_recurrence<T, J> that ptxas reports (J = 0: the wide and
    streamed forms)."""
    out, cur, spill = [], None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"linear_recurrenceI([fd])Li(\d+)EE", m.group(1))
            cur = ("f32" if k.group(1) == "f" else "f64", int(k.group(2))) \
                if k else None
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            out.append(dict(dtype=cur[0], J=cur[1], registers=int(m.group(1)),
                            spill_stores=spill[0], spill_loads=spill[1]))
            cur = None
    return out


def rec_call(torch, lib, args):
    """A closure launching lib's recurrence on args, and its outputs."""
    a, ff, live, h0 = args
    rows = ff.shape[0] if ff.dim() == 2 else 1
    n, J = a.shape[-2:]
    y, hist = torch.empty_like(ff), torch.empty_like(h0)
    fn = lib.tuun_linear_recurrence_rows_f32 if ff.dtype == torch.float32 \
        else lib.tuun_linear_recurrence_rows_f64

    def call():
        status = fn(a.data_ptr(), ff.data_ptr(), live.data_ptr(),
                    h0.data_ptr(), y.data_ptr(), hist.data_ptr(), rows, n, J,
                    torch.cuda.current_stream().cuda_stream)
        if status != 0:
            raise SystemExit(f"recurrence launch failed: CUDA error {status}")
    return call, y, hist




def rec_split(torch, lib, call, rows, n) -> dict:
    """The probe build's words (REC_WORDS) of the second of two calls, as
    means over its rows (at most 64), cycles also per lane."""
    call()
    call()
    torch.cuda.synchronize()
    k = min(rows, 64)
    buf = torch.zeros(k * len(REC_WORDS), dtype=torch.int64)
    status = lib.tuun_rec_probe_read(buf.data_ptr(), k)
    if status != 0:
        raise SystemExit(f"probe read: CUDA error {status}")
    w = buf.view(k, len(REC_WORDS)).double().mean(0).tolist()
    row = dict(zip(REC_WORDS, w))
    row.update(chain_cycles_per_lane=row["chain_cycles"] / n,
               wait_cycles_per_lane=row["wait_cycles"] / n,
               sm_clock_mhz=sm_clock_mhz())
    return row


# The card's own chain: one thread runs the recurrence's dependent chain
# (all lanes live, the history and coefficients in registers, no loads or
# stores) for LATENCY_LANES lanes; clock64 around it gives the cycles a
# lane that no kernel of the recurrence can beat on this card.
LATENCY_SRC = r"""
#include <stdint.h>
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }

template <typename T, int J>
__global__ void chain(const T* a, const T* f, T* h_io, long long* cyc,
                      int n) {
  T av[J], h[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    av[j] = a[j];
    h[j] = h_io[j];
  }
  const T ff = f[0];
  const long long t0 = clock64();
#pragma unroll 4
  for (int i = 0; i < n; ++i) {
    T acc = ff;
#pragma unroll
    for (int j = 0; j < J; ++j) acc = sub_rn(acc, mul_rn(av[j], h[j]));
#pragma unroll
    for (int j = J - 1; j >= 1; --j) h[j] = h[j - 1];
    h[0] = acc;
  }
  const long long t1 = clock64();
#pragma unroll
  for (int j = 0; j < J; ++j) h_io[j] = h[j];
  cyc[0] = t1 - t0;
}

#define ENTRY(T, S, J) \
  extern "C" int chain_##S##_##J(const T* a, const T* f, T* h, \
                                 long long* c, int n) { \
    chain<T, J><<<1, 1>>>(a, f, h, c, n); \
    return (int)cudaDeviceSynchronize(); \
  }
ENTRY(float, f32, 1) ENTRY(float, f32, 2) ENTRY(float, f32, 3)
ENTRY(float, f32, 9) ENTRY(float, f32, 12) ENTRY(float, f32, 16)
ENTRY(float, f32, 17) ENTRY(float, f32, 32)
ENTRY(double, f64, 2) ENTRY(double, f64, 3) ENTRY(double, f64, 16)
"""
# The same chain fed from shared memory in 16-byte chunks (one warp, the
# wide form's way), over NQ chunks a lane: by a loop whose count is known
# only at run time, and unrolled.  Why the wide form unrolls a lane's
# products up to kRecWideUnrolledJ.
LOOP_SRC = r"""
#include <stdint.h>
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

template <int NQ>
__global__ void chunks(float* out, long long* cyc, int lanes, int nq) {
  __shared__ __align__(16) float P[4 * 256];
  for (int i = threadIdx.x; i < 4 * 256; i += 32) P[i] = 1e-7f * (i % 7);
  __syncwarp();
  const float4* P4 = reinterpret_cast<const float4*>(P);
  float acc = 1.0f;
  const long long t0 = clock64();
  for (int x = 0; x < lanes; ++x) {
    const float4* q = P4 + (x & 3) * 32;
    if (NQ == 0) {
      for (int c = 0; c < nq; ++c) {
        const float4 v = q[c];
        acc = sub(acc, v.x); acc = sub(acc, v.y);
        acc = sub(acc, v.z); acc = sub(acc, v.w);
      }
    } else {
#pragma unroll
      for (int c = 0; c < NQ; ++c) {
        const float4 v = q[c];
        acc = sub(acc, v.x); acc = sub(acc, v.y);
        acc = sub(acc, v.z); acc = sub(acc, v.w);
      }
    }
    acc = sub(acc, -1e-7f);
  }
  const long long t1 = clock64();
  if (threadIdx.x == 0) { out[0] = acc; cyc[0] = t1 - t0; }
}

#define ENTRY(NAME, NQ) extern "C" int NAME(float* o, long long* c, \
                                            int lanes, int nq) { \
  chunks<NQ><<<1, 32>>>(o, c, lanes, nq); \
  return (int)cudaDeviceSynchronize(); }
ENTRY(loop, 0) ENTRY(unrolled_4, 4) ENTRY(unrolled_16, 16)
"""
LOOP_CASES = (("loop", 4), ("unrolled_4", 4), ("loop", 16),
              ("unrolled_16", 16))
LOOP_LANES = 4096
LATENCY_CASES = (("f32", 1), ("f32", 2), ("f32", 3), ("f32", 9),
                 ("f32", 12), ("f32", 16), ("f32", 17), ("f32", 32),
                 ("f64", 2), ("f64", 3), ("f64", 16))
LATENCY_LANES = 1 << 16


def rec_latency(torch) -> None:
    """The chain's cycles a lane on this card (LATENCY_SRC), beside the
    model's (J + 1) ops at 4 (f32) or 8 (f64) cycles; then the chain fed
    from shared memory by a runtime loop and unrolled (LOOP_SRC)."""
    WORK.mkdir(parents=True, exist_ok=True)
    cu, so = WORK / "latency.cu", WORK / "liblatency.so"
    cu.write_text(LATENCY_SRC)
    proc = subprocess.run([nvcc(), *FLAGS, "-o", str(so), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed on {cu}:\n{proc.stderr}")
    lib = ctypes.CDLL(str(so))
    from chip_smoke import stable_feedback
    for dt, J in LATENCY_CASES:
        dtype = torch.float32 if dt == "f32" else torch.float64
        a = torch.tensor(stable_feedback(J), dtype=dtype, device="cuda")
        f = torch.ones(1, dtype=dtype, device="cuda")
        h = torch.full((J,), 0.5, dtype=dtype, device="cuda")
        cyc = torch.zeros(1, dtype=torch.int64, device="cuda")
        fn = getattr(lib, f"chain_{dt}_{J}")
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int]
        fn.restype = ctypes.c_int
        best = None
        for _ in range(3):
            status = fn(a.data_ptr(), f.data_ptr(), h.data_ptr(),
                        cyc.data_ptr(), LATENCY_LANES)
            if status != 0:
                raise SystemExit(f"latency chain: CUDA error {status}")
            c = int(cyc.item()) / LATENCY_LANES
            best = c if best is None else min(best, c)
        emit(what="chain latency", dtype=dt, J=J, cycles_per_lane=best,
             cycles_per_op=best / (J + 1),
             model_cycles_per_lane=(J + 1) * (4 if dt == "f32" else 8),
             finite=bool(torch.isfinite(h).all()))
    cu, so = WORK / "loop.cu", WORK / "libloop.so"
    cu.write_text(LOOP_SRC)
    proc = subprocess.run([nvcc(), *FLAGS, "-o", str(so), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed on {cu}:\n{proc.stderr}")
    lib = ctypes.CDLL(str(so))
    out = torch.zeros(1, device="cuda")
    cyc = torch.zeros(1, dtype=torch.int64, device="cuda")
    for name, nq in LOOP_CASES:
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
        fn.restype = ctypes.c_int
        best = None
        for _ in range(3):
            if fn(out.data_ptr(), cyc.data_ptr(), LOOP_LANES, nq) != 0:
                raise SystemExit("chunk chain: CUDA error")
            c = int(cyc.item()) / LOOP_LANES
            best = c if best is None else min(best, c)
        emit(what="chunk chain", form=name, chunks=nq, cycles_per_lane=best,
             cycles_per_op=best / (4 * nq + 1))


def rec_sass(so: Path, out: Path) -> None:
    """The SASS of REC_SASS's instances in `so`, one file each in `out`."""
    from torch.utils.cpp_extension import CUDA_HOME
    proc = subprocess.run([str(Path(CUDA_HOME) / "bin" / "cuobjdump"),
                           "-sass", str(so)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"cuobjdump failed:\n{proc.stderr}")
    out.mkdir(parents=True, exist_ok=True)
    for part in proc.stdout.split("Function : ")[1:]:
        name = next((k for k in REC_SASS if k in part.split("\n", 1)[0]),
                    None)
        if name:
            (out / f"{name}.sass").write_text(part)


def recurrence(tree: Path, parent: Path = None, quick: bool = False,
               sass: Path = None) -> None:
    """The linear recurrence's probe: ptxas's registers and spills of every
    instance; at each of REC_SHAPES and live pattern, the engine's build
    held to its own bits on a second call, to the one-step check, to the
    parent's bits (when given) and every variant to the engine's bits
    (exits 1 if one is not); then device times (CUDA graphs of calls) of
    the parent and the engine's build in turns (parent, build, build,
    parent), of each variant in turns with the build, and the clock64
    split of the probe build."""
    import torch
    from chip_smoke import recurrence_input, recurrence_one_step_rows
    src = rec_watchdog_source(
        (tree / "tuun_tpu_torch" / "csrc" / "exact.cu").read_text())
    builds = [("engine", src, True), ("probe", rec_probe_source(src), False)]
    builds += [(f"variant{i}", variant_source(src, subs), False)
               for i, (_, subs) in enumerate(REC_VARIANTS)]
    if parent is not None:
        builds.append(("parent", (parent / "tuun_tpu_torch" / "csrc" /
                                  "exact.cu").read_text(), False))
    with ThreadPoolExecutor(len(builds)) as pool:
        jobs = {name: pool.submit(rec_build, name, s, v)
                for name, s, v in builds}
        libs = {name: j.result()[0] for name, j in jobs.items()}
        ptxas = jobs["engine"].result()[1]
    for row in rec_ptxas(ptxas):
        emit(what="ptxas", **row)
    rec_latency(torch)
    if sass is not None:
        rec_sass(WORK / "libengine.so", sass)
    others = ["probe"] + [f"variant{i}" for i in range(len(REC_VARIANTS))]
    rng = np.random.default_rng(0)
    cases, bad = [], 0
    for rows, n, J, dt in REC_QUICK if quick else REC_SHAPES:
        dtype = torch.float32 if dt == "f32" else torch.float64
        for live in REC_LIVE:
            args = recurrence_input(torch, np, rng, J, n, dtype, rows,
                                    dead=live)
            new, y, hist = rec_call(torch, libs["engine"], args)
            new()
            torch.cuda.synchronize()
            first = (y.clone(), hist.clone())
            new()
            torch.cuda.synchronize()
            row = dict(rows=rows, n=n, J=J, dtype=dt, live=live,
                       same_bits=bool(torch.equal(first[0], y)
                                      and torch.equal(first[1], hist)),
                       one_step=recurrence_one_step_rows(torch, args, y,
                                                         hist))
            for name in others + (["parent"] if parent else []):
                call, oy, oh = rec_call(torch, libs[name], args)
                call()
                torch.cuda.synchronize()
                row[f"{name}_bits"] = bool(torch.equal(oy, y)
                                           and torch.equal(oh, hist))
            ok = all(v for k, v in row.items() if k == "same_bits"
                     or k == "one_step" or k.endswith("_bits"))
            bad += not ok
            emit(what="recurrence check", ok=ok, **row)
            cases.append((rows, n, J, dt, live, args, new))
    if bad:
        raise SystemExit(f"recurrence: {bad} cases wrong")
    for rows, n, J, dt, live, args, new in cases:
        big = n > 4096
        calls, replays = (5, 2) if big else (50, 5)
        times = {}
        if parent is not None:
            old, _, _ = rec_call(torch, libs["parent"], args)
            for label, fn in (("parent", old), ("engine", new),
                              ("engine", new), ("parent", old)):
                times.setdefault(label, []).append(
                    graph_ms(torch, fn, calls, replays) * 1e3)
        else:
            times["engine"] = [graph_ms(torch, new, calls, replays) * 1e3]
        chain_us = n * (J + 1) * (4 if dt == "f32" else 8) / 1.98e3
        emit(what="recurrence", rows=rows, n=n, J=J, dtype=dt, live=live,
             device_us=times, chain_bound_us=chain_us)
        for i, (name, _) in enumerate(REC_VARIANTS):
            if J > REC_REG_J:
                continue
            var, _, _ = rec_call(torch, libs[f"variant{i}"], args)
            t = [graph_ms(torch, f, calls, replays) * 1e3
                 for f in (new, var, var, new)]
            emit(what="recurrence variant", variant=name, rows=rows, n=n,
                 J=J, dtype=dt, live=live, engine_device_us=t[::3],
                 variant_device_us=t[1:3])
        if J > REC_REG_J:
            continue
        call, _, _ = rec_call(torch, libs["probe"], args)
        emit(what="recurrence split", rows=rows, n=n, J=J, dtype=dt,
             live=live, **rec_split(torch, libs["probe"], call, rows or 1, n),
             device_us_probe=graph_ms(torch, call, calls, replays) * 1e3)


def main(argv) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("mode", choices=("split", "sweep", "recurrence"))
    p.add_argument("--tree", type=Path, default=ROOT)
    p.add_argument("--out", type=Path, default=None,
                   help="also append each JSON line to this file")
    p.add_argument("--quick", action="store_true",
                   help="recurrence: only the shapes of REC_QUICK")
    p.add_argument("--sass", type=Path, default=None,
                   help="recurrence: write the SASS of REC_SASS's instances "
                   "into this directory")
    p.add_argument("--parent", type=Path, default=None,
                   help="sweep: also time this checkout's J <= 8 affine "
                   "scan (the per-thread register-map kernel) in turns; "
                   "recurrence: its linear recurrence")
    args = p.parse_args(argv)
    global OUT
    OUT = args.out
    import torch
    if not torch.cuda.is_available():
        print("affine_probe: no CUDA card", file=sys.stderr)
        return 1
    print(card(), flush=True)
    if args.mode == "split":
        split(args.tree.resolve())
    elif args.mode == "recurrence":
        recurrence(args.tree.resolve(),
                   args.parent.resolve() if args.parent else None,
                   args.quick, args.sass)
    else:
        sweep(args.tree.resolve(),
              args.parent.resolve() if args.parent else None)
    return 0


# (rows or None, n, J) of the sweep: the main path's shapes and PERF.md's.
SWEEP_SHAPES = ((None, 1 << 16, 2), (None, 1 << 20, 3), (8, 1024, 2),
                (64, 1024, 3), (32, 1 << 16, 2), (None, 1 << 17, 8),
                (None, 1 << 17, 5), (None, 1 << 16, 1), (None, 1 << 20, 2),
                (None, 1024, 2), (4, 1 << 16, 2))
# Warps a block (csrc/scan.cu's kAffWarps, 4), each built on its own.
SWEEP_WARPS = (2, 4, 8)
WARPS = "constexpr int kAffWarps = 4;"
SWEEP_FANS = (16, 32, 64)


def bind_new(lib) -> None:
    p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.tuun_affine_scan_rows_f32.argtypes = [p] * 7 + [
        i64, i64, i64, i32, i32, p]
    lib.tuun_affine_scan_rows_f32.restype = i32
    lib.tuun_affine_slots.argtypes = [i64, i32]
    lib.tuun_affine_slots.restype = i64
    lib.tuun_affine_tile.argtypes = []
    lib.tuun_affine_tile.restype = i32
    lib.tuun_affine_scratch_words.argtypes = [i64]
    lib.tuun_affine_scratch_words.restype = i64


def new_call(torch, lib, args, fan):
    """A closure launching the redesigned entry at look-back fan `fan`."""
    a, ff, live, h0 = args
    n, J = a.shape[-2:]
    rows = ff.shape[0] if ff.dim() == 2 else 1
    slots = rows * lib.tuun_affine_slots(n, fan)
    scratch = torch.zeros(lib.tuun_affine_scratch_words(slots),
                          dtype=torch.int32, device="cuda")
    y, hist = torch.empty_like(ff), torch.empty_like(h0)

    def call():
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.tuun_affine_scan_rows_f32(
            a.data_ptr(), ff.data_ptr(), live.data_ptr(), h0.data_ptr(),
            y.data_ptr(), hist.data_ptr(), scratch.data_ptr(), slots, rows,
            n, J, fan, stream)
        if status != 0:
            raise SystemExit(f"launch failed: CUDA error {status}")
    return call, y, hist


# Variants of the redesigned kernel timed beside it at scan_ops' geometry:
# (name, {text in scan.cu: replacement}).
SPIN = "          } while (__any_sync(kFull, !ok));"
VARIANTS = (
    ("poll backoff", {SPIN: "            if (!ok) __nanosleep(100);\n" + SPIN}),
    ("no prefetch", {"        prefetch_l2(a_all + b0 * J + 32 * v);": "",
                     "        prefetch_l2(ff_all + b0 + 32 * v);": ""}),
    ("plain loads", {"reinterpret_cast<float4*>(as)[v] = __ldcs(a4 + v);":
                     "reinterpret_cast<float4*>(as)[v] = a4[v];",
                     "reinterpret_cast<float4*>(fs)[v] = __ldcs(f4 + v);":
                     "reinterpret_cast<float4*>(fs)[v] = f4[v];"}),
    ("read-only loads", {
        "reinterpret_cast<float4*>(as)[v] = __ldcs(a4 + v);":
        "reinterpret_cast<float4*>(as)[v] = __ldg(a4 + v);",
        "reinterpret_cast<float4*>(fs)[v] = __ldcs(f4 + v);":
        "reinterpret_cast<float4*>(fs)[v] = __ldg(f4 + v);"}),
    # Unsafe beyond one wave (a block may wait on a tile not yet started):
    # timed only to price the counter.
    ("tile = blockIdx.x (unsafe)", {
        "    gt = (int64_t)tile_index;\n  }\n  // A 32-bit division (nb < 2^31),"
        " cheaper than a 64-bit one.\n  const int64_t r = kRows ? (int64_t)"
        "((unsigned)gt / (unsigned)nbr) : 0;\n  const int64_t t = gt - r * nbr;"
        "\n  const int64_t base = t * tile;":
        "  }\n  const int64_t r = kRows ? (int64_t)((unsigned)gt / "
        "(unsigned)nbr) : 0;\n  const int64_t t = gt - r * nbr;\n"
        "  const int64_t base = t * tile;"}),
)


def variant_source(src: str, subs: dict) -> str:
    for old, new in subs.items():
        src = patch(src, old, new)
    return src


def sweep(tree: Path, parent: Path = None) -> None:
    """Every (warps, fan) at SWEEP_SHAPES, each output held to the float64
    plain version within chip_smoke's per-J bound and to its own bits on
    a second call, then its device time; at scan_ops' geometry (4 warps,
    affine_fan(n)) the bulk-copy loads and VARIANTS beside it, the phase
    split, and the parent's kernel in turns."""
    import torch
    from chip_smoke import affine_tol, tree_scan_ops
    src = (tree / "tuun_tpu_torch" / "csrc" / "scan.cu").read_text()
    with ThreadPoolExecutor(6 + len(VARIANTS)) as pool:
        warp_jobs = {w: pool.submit(build, f"warps{w}", patch(
            src, WARPS, f"constexpr int kAffWarps = {w};"), False)
            for w in SWEEP_WARPS if w != 4}
        jobs = [pool.submit(build, "quad", src, True),
                pool.submit(build, "bulk", bulk_source(src), False),
                pool.submit(build, "stamped_new", stamped_new_source(src),
                            False)]
        var_jobs = [pool.submit(build, f"variant{i}",
                                variant_source(src, subs), False)
                    for i, (_, subs) in enumerate(VARIANTS)]
        old_job = pool.submit(build, "parent", (
            parent / "tuun_tpu_torch" / "csrc" / "scan.cu").read_text(),
            False) if parent else None
        (quad_so, ptxas), (bulk_so, _), (stamped_so, _) = (
            j.result() for j in jobs)
        variant_libs = {name: ctypes.CDLL(str(j.result()[0]))
                        for (name, _), j in zip(VARIANTS, var_jobs)}
        old_lib = ctypes.CDLL(str(old_job.result()[0])) if parent else None
    for lib in variant_libs.values():
        bind_new(lib)
    if old_lib is not None:
        bind_old(old_lib)
    for row in ptxas_rows(ptxas, ("affine_scan_pass",)):
        emit(what="ptxas", **row)
        warp_libs = {w: ctypes.CDLL(str(j.result()[0]))
                     for w, j in warp_jobs.items()}
    libs = {"quad": ctypes.CDLL(str(quad_so)),
            "bulk": ctypes.CDLL(str(bulk_so)),
            "stamped": ctypes.CDLL(str(stamped_so))}
    warp_libs[4] = libs["quad"]
    for lib in warp_libs.values():
        bind_new(lib)
    for lib in libs.values():
        bind_new(lib)
    for name in ("tuun_probe_stamps", "tuun_probe_times"):
        getattr(libs["stamped"], name).argtypes = [ctypes.c_void_p,
                                                   ctypes.c_longlong]
        getattr(libs["stamped"], name).restype = ctypes.c_int
    ops = tree_scan_ops(tree)
    rng = np.random.default_rng(0)
    for rows, n, J in SWEEP_SHAPES:
        args = inputs(torch, rng, rows, n, J)
        a, ff, live, h0 = args
        hs, ref_hist = ops.affine_scan_ref(a.double(), ff.double(), live,
                                           h0.double())
        ref = torch.where(live, hs[..., 0], 0.0)
        scale = max(1.0, float(ref.abs().max()))
        chosen = (4, ops.affine_fan(n))
        for warps in SWEEP_WARPS:
            for fan in SWEEP_FANS:
                call, y, hist = new_call(torch, warp_libs[warps], args, fan)
                call()
                torch.cuda.synchronize()
                first = torch.cat([y.reshape(-1), hist.reshape(-1)]).clone()
                err = max(float((y.double() - ref).abs().max()),
                          float((hist.double() - ref_hist).abs().max()))
                call()
                torch.cuda.synchronize()
                same = torch.equal(first, torch.cat([y.reshape(-1),
                                                     hist.reshape(-1)]))
                emit(what="sweep", rows=rows, n=n, J=J, warps=warps, fan=fan,
                     chosen=(warps, fan) == tuple(chosen),
                     device_us=graph_ms(torch, call) * 1e3,
                     err_of_scale=err / scale,
                     within_tol=err <= affine_tol(J) * scale,
                     same_bits=same)
        loads = {}
        for label in ("quad", "bulk", "bulk ", "quad "):
            call, _, _ = new_call(torch, libs[label.strip()], args,
                                  chosen[1])
            loads.setdefault(label.strip(), []).append(
                graph_ms(torch, call) * 1e3)
        emit(what="loads", rows=rows, n=n, J=J, warps=chosen[0],
             fan=chosen[1], quad_ldcs_device_us=loads["quad"],
             bulk_device_us=loads["bulk"])
        new, _, _ = new_call(torch, libs["quad"], args, chosen[1])
        for name, lib in variant_libs.items():
            var, _, _ = new_call(torch, lib, args, chosen[1])
            times = [graph_ms(torch, f) * 1e3 for f in (new, var, var, new)]
            emit(what="variant", variant=name, rows=rows, n=n, J=J,
                 kernel_device_us=times[::3], variant_device_us=times[1:3])
        if old_lib is not None:
            old, _, _ = old_call(torch, old_lib, args,
                                 old_lib.tuun_affine_tile())
            times = [graph_ms(torch, f) * 1e3 for f in (old, new, new, old)]
            emit(what="parent", rows=rows, n=n, J=J,
                 parent_device_us=times[::3], kernel_device_us=times[1:3])
        call, _, _ = new_call(torch, libs["stamped"], args, chosen[1])
        nb = (rows or 1) * -(-n // ops.AFFINE_TILE)
        emit(what="new kernel phase split", rows=rows, n=n, J=J,
             warps=chosen[0], fan=chosen[1], tiles=nb,
             **read_split(torch, libs["stamped"], call, nb, NEW_PHASES),
             device_us_stamped=graph_ms(torch, call) * 1e3)
        if nb > 1 and rows is None and n <= 1 << 17:
            emit(what="new kernel tile times", n=n, J=J, warps=chosen[0],
                 fan=chosen[1], **read_times(torch, libs["stamped"], call, nb))



if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

#!/usr/bin/env python3
"""Probes the affine scan's kernels (tuun_tpu_torch/csrc/scan.cu) on one
CUDA card: where a call's time goes, what ptxas makes of each instance,
and how the tile geometry moves the time.  Run from the root of a
checkout, on a machine with a card and nvcc:

    python3 affine_probe.py split [--tree DIR]
    python3 affine_probe.py sweep [--tree DIR]

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


def main(argv) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("mode", choices=("split", "sweep"))
    p.add_argument("--tree", type=Path, default=ROOT)
    p.add_argument("--out", type=Path, default=None,
                   help="also append each JSON line to this file")
    p.add_argument("--parent", type=Path, default=None,
                   help="sweep: also time this checkout's J <= 8 affine "
                   "scan (the per-thread register-map kernel) in turns")
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

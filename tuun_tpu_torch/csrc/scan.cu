// Cross-lane scans of the render engine, written by hand for Hopper (sm_90a).
//
// Four entry points, each one kernel launch per call, the first three the
// counterparts of one Pallas TPU kernel in tuun_tpu/engine/pallas_ops.py:
//
//   tuun_prefix_sum_rows_f32        <- prefix_sum_f32 / _prefix_sum_kernel
//   tuun_prefix_max_rows_f32        <- prefix_max_f32 / _prefix_max_kernel
//   tuun_affine_scan_rows_f32       <- affine_scan_f32 / _affine_scan_kernel
//   tuun_affine_scan_deep_rows_f32  <- the same IIR deeper than the Pallas
//       kernel takes: fast mode's jax.lax.associative_scan of companion
//       maps (tuun_tpu/engine/graph.py:876-897), here for 8 < J <= 16
//
// The TPU kernels walk a sequential grid and carry the running total (or
// the running affine map) from one grid step to the next in SMEM scratch.
// Blocks on this card run in parallel and in no order.
//
// Each scans B rows of n lanes (voices x lanes), one per voice of a tracker
// group, in one launch; a single voice is the one-row call.  It replaces
// the same Pallas kernels, and them under the group's jax.vmap, which adds
// a grid axis over the voices (tuun_tpu/tracker.py:409-410).  The grid is every
// row's tiles: global tile gt is tile gt % nbr of row gt / nbr (nbr tiles
// a row), a tile never crosses a row, and its look-back reads only its own
// row's status in the grouping a one-row call has, so row r gives the bits
// of a single call on row r.  One scratch serves all rows (one status
// slot per global tile); the done counter counts every row's tiles.  With
// one tile a row (the live block of 1024 lanes) no tile looks back and no
// scratch is touched.  A one-row call runs a kernel compiled without the
// row arithmetic (kRows = false): at a given B, the
// batched call moves the bytes of B single calls but launches once, so it
// saves B - 1 launches and their host work.
//
// Prefix sum and max: one launch per call, a single-pass scan with
// decoupled look-back (Merrill & Garland, "Single-pass Parallel Prefix
// Scan with Decoupled Look-back", NVIDIA 2016).  What bounds them on this
// card: at the main path's 65536 lanes, launch latency and the host's
// dispatch (the data is 0.5 MB, ~0.2 us of HBM time); at large N, HBM
// bytes, 8 per lane (read once, written once).  The design answers both:
//   * one kernel, no set-up launch or memset, so a call is one launch;
//   * each block takes its tile index from an atomic counter, scans its
//     4096 lanes (float4 loads, coalesced and transposed through padded
//     shared memory, 16 lanes per thread in registers, then a
//     warp-shuffle block scan) and publishes a 64-bit status word {flag,
//     value}.  Flag and value are one word, written and read whole, so no
//     fence orders them.  Every lane is read once and written once; no
//     pass re-reads the output;
//   * the grouping is fixed, so a result is the same bits on every call:
//     every kScanThreads-th tile (256) is an anchor.  Tile t's carry is
//     the inclusive prefix of the anchor a at or before t - 1, combined
//     with the aggregates of tiles a + 1 .. t - 1: thread k reads tile
//     a + k's word, all at once, each warp folds its words by a shuffle
//     tree, and thread 0 combines the warp totals in order.  Up to 32
//     words (the main path's 16 tiles) warp 0 alone reads and folds them,
//     with no extra barrier.  Only anchors publish an inclusive prefix,
//     only other tiles an aggregate.  The anchors form a chain, one link
//     per 256 tiles (8 MB of traffic); up to 2^20 lanes every tile reads
//     tile 0 and nothing waits on a chain;
//   * the tile index comes from the counter, not blockIdx, so a block
//     waits only on tiles that have already started: forward progress
//     holds however many waves the grid takes;
//   * the scratch (tile counter, done counter, status words) is the
//     caller's persistent buffer for its (device, stream), of
//     tuun_scan_scratch_words() words (enough for kMaxN), zeroed once when
//     allocated.  After its look-back each block adds one to the done
//     counter, with release and acquire semantics in place of a full
//     __threadfence(); the block that sees nb - 1 clears what the call
//     used, so the next call, or the next replay of a captured CUDA graph,
//     finds it clean.  No epoch comes from the host: graph capture would
//     freeze it;
//   * N <= one tile skips the counter and the look-back.
// Measured on an H100 (PERF.md): the tile, 256 threads x 16 lanes, was
// chosen for the main path's 65536 lanes, where no tile measured was
// faster (256x8, 128x16 and 512x8 tied it; 128x32, 256x32 and 512x16
// were 3-10% slower).  Against the look-back it replaced, which folded
// back to the first inclusive prefix it found and so grouped tiles by
// timing, this fixed grouping was level at 65536 lanes and 4-10% faster
// at 2^20 and 2^26.  Two other fixed groupings lost 0.4-0.6 us a call at
// 65536 lanes: all threads folding through the block scan, and warp 0
// polling 8 words per lane (also 35% slower at 2^20).  A pointer that is
// not 16-byte aligned, and the ragged last tile, take coalesced scalar
// loads.
//
// Affine scan (IIR feedback, h_i = A_i h_{i-1} + b_i over the J-deep
// history, companion form): one launch per call, the same single-pass
// scheme with a look-back over maps (Maleki, Yang & Burtscher,
// "Higher-Order and Tuple-Based Massively-Parallel Prefix Sums", PLDI
// 2016, on top of Merrill & Garland).  Replaces affine_scan_f32 /
// _affine_scan_kernel (tuun_tpu/engine/pallas_ops.py:301).  What bounds
// it on this card: HBM bytes, 8J + 5 per lane (a 4J and ff 4 and live 1
// read once, h 4J written once; 1.4 MB at J = 2 and 65536 lanes, 0.41 us
// at 3.35 TB/s), and below ~2^20 lanes launch latency and the chain of
// dependent memory trips in a block.  Arithmetic (O(J^2) a lane) does
// not bound it.  The design:
//   * one kernel, no set-up launch or memset;
//   * a block takes its tile index from an atomic counter, loads the
//     tile's a, ff and live coalesced (float4 / 16-byte loads; scalar for
//     a misaligned pointer or the ragged tail) into shared rows padded so
//     that each thread reads its own lanes as float4s without bank
//     conflicts;
//   * each thread composes its lanes' companion maps (push_lane, O(J^2) a
//     lane), and a warp-shuffle scan gives each thread its exclusive map
//     within the tile and the tile's map;
//   * status: one flag word per tile and one record of J^2 + J floats.
//     Unlike the prefix scan's 64-bit {flag, value} word, the record does
//     not fit in one word, so a tile writes its record first and then the
//     flag with st.release; a reader loads the flag with ld.acquire and
//     only then the record, from L2 (ld.cg).  Every kAffThreads-th tile
//     (one per thread of a block) is an anchor and publishes its exit
//     history (J floats) once it knows its entering one; every other
//     tile publishes its map at once, before its own look-back;
//   * fixed grouping, so a call gives the same bits every time: tile t's
//     entering history is anchor a's exit history (a = the last multiple
//     of kAffThreads below t) with the maps of tiles a + 1 .. t - 1 applied
//     in sequence order, folded by a fixed shuffle tree (the anchor's
//     history enters it as a constant map);
//   * accuracy as in the three-launch kernel this replaced: composed maps
//     only carry the history across tiles and threads; each thread then
//     runs the recurrence itself over its lanes from its entering
//     history, in the reference's op order (y = ff - sum_j a_j y_{-1-j}),
//     and h goes back out through the same shared rows, coalesced;
//   * the scratch is the caller's persistent buffer for its (device,
//     stream), tuun_affine_scratch_words(cap) words for up to cap tiles,
//     zeroed once; the last block to count itself done (acquire-release)
//     clears the flags and counters, so the next call or graph replay
//     finds it clean.  The records need no clearing;
//   * N <= one tile skips the counter and the look-back; the block that
//     holds lane N - 1 writes hist.
// Tile: 128 threads x 16 lanes, one look-back record per thread, so an
// anchor every 128 tiles.  It was chosen on an H100 for the main path's
// 65536 lanes (32 tiles), where no tile tried was faster.  At 2^20 lanes
// smaller tiles (128 x 4, 64 x 8, 32 x 16) lost to the longer chain of
// anchors.  Reading 2-4 records per thread (no anchor chain up to 2^20
// lanes) was slower at 65536 lanes and mixed at 2^20 (PERF.md).
//
// Deep affine scan (the same IIR at 8 < J <= kDeepMaxJ = 16), fast mode's
// feedback past the affine scan's kMaxJ.  It returns y and the final
// history, not the J planes of h: the engine reads only y and hist.  What
// bounds it on this card: HBM bytes, 4J + 9 a lane (a 4J, ff 4, live 1
// read once, y 4 written once; 2.86 us at J = 16 and 2^17 lanes), then the
// chains of dependent operations in a tile.  What held the affine scan to
// J <= 8: each thread keeps its J x J map and its shuffle partner's in
// registers, 2 (J^2 + J) floats, which spill from J = 7.  Here no thread
// holds a map:
//   * a block's tile (kDeepTile lanes) is kDeepSegs segments of kDeepSeg
//     lanes, kDeepSegsPerWarp a warp.  Each warp stages its segments' a,
//     ff and live into shared memory with cp.async, one commit group a
//     segment, so the load of the next segment overlaps the work on the
//     current one;
//   * a segment's map (A J x J, b J) is built column by column: lane c < J
//     pushes the basis history e_c through the segment's lanes with ff =
//     0 and lane J pushes ff from a zero history, each lane holding one
//     J-float history in registers and reading a[i][.] from shared memory
//     as a broadcast.  Column c of A is lane c's history after the
//     segment, b lane J's.  Maps live in shared memory, column by column,
//     each column padded to a multiple of 4 floats (Jp);
//   * the tile's maps are scanned in place by a Blelloch up-sweep: at
//     each level a thread composes one output column (J^2 FMAs, the
//     columns of the right map's A read as float4s), and the root holds
//     the tile's map;
//   * look-back as in the affine scan, in a fixed grouping: every
//     kDeepAnchor-th tile is an anchor and publishes its exit history,
//     every other tile its map (J^2 + J floats of a kDeepRecord record) at
//     once.  Tile t's warp 0 waits for the maps of tiles a + 1 .. t - 1
//     (a the anchor at or before t - 1; acquire) and copies them from L2
//     into shared memory while anchor a's exit history may still be on
//     its way, then applies them in turn to that history (lane i row i);
//   * a tile's exit history is its map applied to its entering history,
//     the same product an anchor publishes and a look-back applies, and
//     the last tile's is the row's hist.  So rendering whole tiles in
//     several calls (a tracker's blocks) gives the bits of one call over
//     them (its lookahead window): phase 8's bound holds a deep group's
//     windowed mix to its blocks rendered one by one.  Folding the maps
//     between anchors into one, which took 2-6 us off at 2^17 lanes on
//     an H100, rounds otherwise and broke that by 1e-5;
//   * a down-sweep of vectors gives each segment its entering history:
//     the right child enters with the left child's map applied to the
//     parent's history (J^2 FMAs a node, one thread a row);
//   * accuracy as in the affine scan: composed maps only carry the
//     history across segments and tiles; each segment then runs the
//     recurrence itself from its entering history, in the reference's op
//     order (y = ff - sum_j a_j y_{-1-j}), one thread a segment, writing
//     y over ff in shared memory; y goes out coalesced;
//   * the scratch is the caller's persistent buffer for its (device,
//     stream), tuun_affine_deep_scratch_words(cap) words for up to cap
//     tiles, its records sized for kDeepMaxJ, zeroed once; the last block
//     to count itself done clears the flags and counters;
//   * N <= one tile skips the counter and the look-back.
// Tensor cores do not serve: TF32 products would lose the digits the
// engine's bounds hold, so the compositions are FP32 FMAs.
// Tile: 8 warps x 4 segments of 32 lanes (1024 lanes), an anchor every 32
// tiles.  Chosen on an H100 at 2^17 lanes (T1's and fast mode's offline
// block), where no shape tried was faster by more than 1% (2 segments a
// warp in 16 warps, 16- and 64-lane segments, anchors every 16 tiles);
// 512-lane tiles were 12-16% faster at 1024 lanes and 33-43% slower at
// 2^17 (PERF.md).  Measured there: 27.7-41.5 us at 2^17 lanes for J = 9
// to 16, against 7.4-12.7 ms for the linear recurrence that fast mode ran
// before.

// C interface, bound with ctypes (tuun_tpu_torch/engine/scan_ops.py).
// Every entry launches one grid on the given stream, allocates nothing
// (the caller passes outputs and scratch) and returns
// cudaGetLastError().  Lengths are 64-bit: any N from 1 to 2^31 - 1 is
// covered, the ragged last tile masked.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

// ---------------------------------------------------------------------------
// Prefix sum / prefix max: one template over the combine op.
// ---------------------------------------------------------------------------

constexpr int kScanThreads = 256;
constexpr int kScanItems = 16;                        // lanes per thread
constexpr int kScanTile = kScanThreads * kScanItems;  // 4096 lanes per block
constexpr int kScanVecs = kScanItems / 4;             // float4 per thread

// Status word of a tile: flag in the high half, the value's bits in the
// low half, written and read as one 64-bit word.
constexpr unsigned long long kNotReady = 0;
constexpr unsigned long long kAggregate = 1;
constexpr unsigned long long kPrefix = 2;

// Scratch words: [0] tile counter, [1] done counter, [2 + t] tile t's
// status.  Sized once for the longest scan, so a buffer never grows.
constexpr int64_t kMaxN = 2147483647;  // 2^31 - 1
constexpr int kScratchHead = 2;
constexpr int64_t kScratchWords = kScratchHead + (kMaxN + kScanTile - 1) / kScanTile;

// Shared-memory index of lane j of the tile: 4 pad words after every 32.
// Coalesced stores (scalar or float4) and each thread's float4 reads of
// its own 16 lanes are then free of bank conflicts, and every float4
// stays 16-byte aligned.
__device__ __forceinline__ int pad(int j) { return j + ((j >> 5) << 2); }

struct SumOp {
  __device__ static float identity() { return 0.0f; }
  // `a` precedes `b` in the sequence.
  __device__ static float combine(float a, float b) { return a + b; }
};

struct MaxOp {
  __device__ static float identity() { return -__int_as_float(0x7f800000); }
  // torch.cummax's rule, so that the result is bit-identical to it: the
  // later element wins when it is NaN, or when it is >= a non-NaN running
  // max (ties go to the later element, which decides the sign of a zero).
  __device__ static float combine(float a, float b) {
    return (isnan(b) || (!isnan(a) && b >= a)) ? b : a;
  }
};

// Exclusive scan of one value per thread across the block (blockDim.x a
// multiple of 32, at most 1024): a shuffle Kogge-Stone in each warp, then
// warp 0 scans the warp totals.  Returns the thread's exclusive prefix
// (the identity for thread 0) and the block total in *total.
template <class Op>
__device__ float block_exclusive_scan(float v, float* warp_tot, float* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  float incl = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float o = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl = Op::combine(o, incl);
  }
  float excl = __shfl_up_sync(kFull, incl, 1);
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    float t = lane < nwarps ? warp_tot[lane] : Op::identity();
    for (int d = 1; d < nwarps; d <<= 1) {
      const float o = __shfl_up_sync(kFull, t, d);
      if (lane >= d) t = Op::combine(o, t);
    }
    warp_tot[lane] = t;
  }
  __syncthreads();
  if (warp > 0) {
    const float before = warp_tot[warp - 1];
    excl = lane == 0 ? before : Op::combine(before, excl);
  } else if (lane == 0) {
    excl = Op::identity();
  }
  *total = warp_tot[nwarps - 1];
  __syncthreads();
  return excl;
}

__device__ __forceinline__ unsigned long long pack_status(unsigned long long flag,
                                                          float v) {
  return (flag << 32) | (unsigned long long)__float_as_uint(v);
}

__device__ __forceinline__ unsigned long long status_flag(unsigned long long s) {
  return s >> 32;
}

// One add on a scratch counter, ordered after this thread's earlier
// accesses and before its later ones (release and acquire at GPU scope),
// without a full fence.
__device__ __forceinline__ unsigned long long count_acq_rel(
    unsigned long long* p) {
  unsigned long long old;
  asm volatile("atom.add.acq_rel.gpu.u64 %0, [%1], 1;"
               : "=l"(old) : "l"(p) : "memory");
  return old;
}

// Run by the whole block of tile t > 0; the result is thread 0's.  The
// combine of every earlier tile, in sequence order and a fixed grouping:
// the inclusive prefix of anchor a = the last multiple of kScanThreads
// below t, then the aggregates of tiles a + 1 .. t - 1.  Thread k waits
// for tile a + k's word; each warp's shuffle tree folds lane l + d into
// lane l, and thread 0 combines the warp totals in order.  With at most
// 32 words, only warp 0 takes part and no barrier is needed.
template <class Op>
__device__ float look_back(volatile unsigned long long* status, int64_t t,
                           float* warp_tot) {
  const int64_t a = (t - 1) / kScanThreads * kScanThreads;
  const int words = (int)(t - a);
  const int lane = threadIdx.x & 31;
  if (words <= 32 && threadIdx.x >= 32) return Op::identity();
  // The warp spins as one: a divergent spin per lane cost 0.35 us a call
  // at 65536 lanes on an H100.
  const bool mine = (int)threadIdx.x < words;
  unsigned long long s =
      mine ? status[a + threadIdx.x] : pack_status(kAggregate, Op::identity());
  while (__any_sync(kFull, status_flag(s) == kNotReady)) {
    if (status_flag(s) == kNotReady) s = status[a + threadIdx.x];
  }
  float v = __uint_as_float((unsigned)s);
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float o = __shfl_down_sync(kFull, v, d);
    if (lane + d < 32) v = Op::combine(v, o);
  }
  if (words <= 32) return v;
  if (lane == 0) warp_tot[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < (words + 31) / 32; ++w) v = Op::combine(v, warp_tot[w]);
  }
  return v;
}

// Single-pass inclusive scan of each of `rows` rows of n lanes (row r at
// x + r * n).  Lanes past n read as the identity.  A tile never crosses a
// row: global tile gt is tile t = gt % nbr of row r = gt / nbr, and its
// look-back reads only its own row's status words, in the grouping a
// single row has, so row r gives the bits of a one-row call on it.
// kRows = false is the one-row form, compiled without the row arithmetic.
template <class Op, bool kRows>
__global__ void __launch_bounds__(kScanThreads)
scan_single_pass(const float* __restrict__ x_all, float* __restrict__ out_all,
                 unsigned long long* scratch, int64_t rows, int64_t n) {
  __shared__ __align__(16) float tile[kScanTile + kScanTile / 8];
  __shared__ float warp_tot[32];
  __shared__ unsigned long long tile_index;
  __shared__ float tile_prefix;
  __shared__ bool last_block;
  const int64_t nbr = (n + kScanTile - 1) / kScanTile;  // tiles per row
  const int64_t nb = kRows ? rows * nbr : nbr;
  int64_t gt = blockIdx.x;
  if (nbr > 1) {
    if (threadIdx.x == 0) tile_index = atomicAdd(&scratch[0], 1ull);
    __syncthreads();
    gt = (int64_t)tile_index;
  }
  // A 32-bit division (nb < 2^31), cheaper than a 64-bit one.
  const int64_t r = kRows ? (int64_t)((unsigned)gt / (unsigned)nbr) : 0;
  const int64_t t = gt - r * nbr;
  const float* __restrict__ x = x_all + r * n;
  float* __restrict__ out = out_all + r * n;
  volatile unsigned long long* status = scratch + kScratchHead + r * nbr;
  const int64_t base = t * kScanTile;
  const bool vec = base + kScanTile <= n &&
      (((uintptr_t)x | (uintptr_t)out) & 15) == 0;

  // Load: coalesced, into the padded tile.
  if (vec) {
    const float4* src = reinterpret_cast<const float4*>(x + base);
#pragma unroll
    for (int k = 0; k < kScanVecs; ++k) {
      const int v = k * kScanThreads + threadIdx.x;
      *reinterpret_cast<float4*>(&tile[pad(4 * v)]) = src[v];
    }
  } else {
#pragma unroll
    for (int k = 0; k < kScanItems; ++k) {
      const int j = k * kScanThreads + threadIdx.x;
      const int64_t g = base + j;
      tile[pad(j)] = g < n ? x[g] : Op::identity();
    }
  }
  __syncthreads();

  // Each thread scans its own 16 lanes in registers.
  float items[kScanItems];
  const int first = threadIdx.x * kScanItems;
#pragma unroll
  for (int q = 0; q < kScanVecs; ++q) {
    const float4 f = *reinterpret_cast<const float4*>(&tile[pad(first + 4 * q)]);
    items[4 * q] = f.x;
    items[4 * q + 1] = f.y;
    items[4 * q + 2] = f.z;
    items[4 * q + 3] = f.w;
  }
#pragma unroll
  for (int k = 1; k < kScanItems; ++k) {
    items[k] = Op::combine(items[k - 1], items[k]);
  }
  float total;
  const float excl =
      block_exclusive_scan<Op>(items[kScanItems - 1], warp_tot, &total);

  if (nbr > 1) {
    float prefix = Op::identity();
    const bool anchor = t % kScanThreads == 0;
    if (t == 0) {
      if (threadIdx.x == 0) status[0] = pack_status(kPrefix, total);
    } else {
      if (threadIdx.x == 0 && !anchor) status[t] = pack_status(kAggregate, total);
      prefix = look_back<Op>(status, t, warp_tot);
      if (threadIdx.x == 0 && anchor) {
        status[t] = pack_status(kPrefix, Op::combine(prefix, total));
      }
    }
    if (threadIdx.x == 0) {
      tile_prefix = prefix;
      // The look-back's shuffles or barrier have ordered every read of
      // the status words before this count, and this block's word is
      // final.
      last_block = count_acq_rel(&scratch[1]) == (unsigned long long)(nb - 1);
    }
    __syncthreads();
  }

  // Fold in the thread's prefix within the tile, then the tile's prefix.
  bool fold = threadIdx.x > 0;
  float carry = excl;
  if (t > 0) {
    carry = fold ? Op::combine(tile_prefix, excl) : tile_prefix;
    fold = true;
  }
  if (fold) {
#pragma unroll
    for (int k = 0; k < kScanItems; ++k) items[k] = Op::combine(carry, items[k]);
  }
#pragma unroll
  for (int q = 0; q < kScanVecs; ++q) {
    *reinterpret_cast<float4*>(&tile[pad(first + 4 * q)]) =
        make_float4(items[4 * q], items[4 * q + 1], items[4 * q + 2],
                    items[4 * q + 3]);
  }
  __syncthreads();

  // Store: coalesced, from the padded tile.
  if (vec) {
    float4* dst = reinterpret_cast<float4*>(out + base);
#pragma unroll
    for (int k = 0; k < kScanVecs; ++k) {
      const int v = k * kScanThreads + threadIdx.x;
      dst[v] = *reinterpret_cast<const float4*>(&tile[pad(4 * v)]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < kScanItems; ++k) {
      const int j = k * kScanThreads + threadIdx.x;
      const int64_t g = base + j;
      if (g < n) out[g] = tile[pad(j)];
    }
  }

  // The last block to finish its look-back leaves the scratch clean.
  if (nbr > 1 && last_block) {
    volatile unsigned long long* all = scratch + kScratchHead;
    for (int64_t i = threadIdx.x; i < nb; i += kScanThreads) all[i] = 0;
    if (threadIdx.x == 0) {
      scratch[0] = 0;
      scratch[1] = 0;
    }
  }
}

template <class Op>
int run_prefix(const float* x, float* out, unsigned long long* scratch,
               int64_t rows, int64_t n, cudaStream_t stream) {
  if (n <= 0 || n > kMaxN || rows <= 0) return (int)cudaErrorInvalidValue;
  const int64_t nbr = (n + kScanTile - 1) / kScanTile;
  const int64_t nb = rows * nbr;
  if (nb > kMaxN) return (int)cudaErrorInvalidValue;
  if (nbr > 1 && (scratch == nullptr || nb > kScratchWords - kScratchHead)) {
    return (int)cudaErrorInvalidValue;
  }
  if (rows == 1) {
    scan_single_pass<Op, false><<<(unsigned)nb, kScanThreads, 0, stream>>>(
        x, out, scratch, rows, n);
  } else {
    scan_single_pass<Op, true><<<(unsigned)nb, kScanThreads, 0, stream>>>(
        x, out, scratch, rows, n);
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Affine scan: h_i = A_i h_{i-1} + b_i over the J-deep filter history.
// ---------------------------------------------------------------------------
//
// Lane i is the companion-form map of y[i] = ff[i] - sum_j a[i,j] y[i-1-j]
// (row 0 = -a[i,:], rows 1.. shift the history down; b = (ff[i], 0, ...)),
// or the identity on a dead lane.  h[i, :] = (y[i], y[i-1], ..., y[i-J+1]).

// Tile: kAffThreads threads x kAffItems lanes.  Every kAffThreads-th tile
// is an anchor, so a look-back reads at most one status record per thread.
constexpr int kAffThreads = 128;
constexpr int kAffItems = 16;
constexpr int kAffTile = kAffThreads * kAffItems;  // 2048 lanes per block
constexpr int kMaxJ = 8;

// Scratch, in 32-bit words, for a capacity of `cap` tiles: [0] tile
// counter, [1] done counter, [2, 2 + cap) one flag per tile, then from
// aff_payload_offset(cap) one record of kAffRecord floats per tile.  Only
// the counters and flags must be zero when a call starts.
constexpr int kAffHead = 2;
constexpr int kAffRecord = kMaxJ * kMaxJ + kMaxJ;
constexpr unsigned kAffNotReady = 0;
constexpr unsigned kAffAggregate = 1;  // the record holds the tile's map
constexpr unsigned kAffHistory = 2;    // the record holds its exit history

__host__ __device__ constexpr int64_t aff_payload_offset(int64_t cap) {
  return (kAffHead + cap + 3) / 4 * 4;
}

// Shared-memory row of a thread's lanes, in floats: padded so that the
// row stride is an odd number of float4s.  A warp's float4 reads of one
// offset in each thread's row are then free of bank conflicts, and every
// row stays 16-byte aligned.
__host__ __device__ constexpr int aff_row(int floats) {
  return (floats / 4) % 2 ? floats : floats + 4;
}

template <int J>
__host__ __device__ constexpr size_t aff_smem_bytes() {
  return (size_t)kAffThreads *
         (aff_row(kAffItems * J) + aff_row(kAffItems)) * sizeof(float) +
         kAffTile;
}

template <int J>
struct Map {
  float A[J][J];
  float b[J];
};

template <int J>
__device__ __forceinline__ void set_identity(Map<J>& m) {
#pragma unroll
  for (int i = 0; i < J; ++i) {
#pragma unroll
    for (int k = 0; k < J; ++k) m.A[i][k] = i == k ? 1.0f : 0.0f;
    m.b[i] = 0.0f;
  }
}

// cur after prev: (cur.A prev.A, cur.A prev.b + cur.b).
template <int J>
__device__ __forceinline__ Map<J> compose(const Map<J>& cur,
                                          const Map<J>& prev) {
  Map<J> r;
#pragma unroll
  for (int i = 0; i < J; ++i) {
    float bb = cur.b[i];
#pragma unroll
    for (int m = 0; m < J; ++m) bb += cur.A[i][m] * prev.b[m];
    r.b[i] = bb;
#pragma unroll
    for (int k = 0; k < J; ++k) {
      float acc = 0.0f;
#pragma unroll
      for (int m = 0; m < J; ++m) acc += cur.A[i][m] * prev.A[m][k];
      r.A[i][k] = acc;
    }
  }
  return r;
}

template <int J>
__device__ __forceinline__ Map<J> shfl_up_map(const Map<J>& m, int d) {
  Map<J> r;
#pragma unroll
  for (int i = 0; i < J; ++i) {
#pragma unroll
    for (int k = 0; k < J; ++k) r.A[i][k] = __shfl_up_sync(kFull, m.A[i][k], d);
    r.b[i] = __shfl_up_sync(kFull, m.b[i], d);
  }
  return r;
}

template <int J>
__device__ __forceinline__ Map<J> shfl_down_map(const Map<J>& m, int d) {
  Map<J> r;
#pragma unroll
  for (int i = 0; i < J; ++i) {
#pragma unroll
    for (int k = 0; k < J; ++k) {
      r.A[i][k] = __shfl_down_sync(kFull, m.A[i][k], d);
    }
    r.b[i] = __shfl_down_sync(kFull, m.b[i], d);
  }
  return r;
}

// out = m(h) = m.A h + m.b
template <int J>
__device__ __forceinline__ void apply_map(const Map<J>& m, const float* h,
                                          float* out) {
#pragma unroll
  for (int i = 0; i < J; ++i) {
    float acc = m.b[i];
#pragma unroll
    for (int k = 0; k < J; ++k) acc += m.A[i][k] * h[k];
    out[i] = acc;
  }
}

// P <- (companion map of lane a, f) after P.
template <int J>
__device__ __forceinline__ void push_lane(Map<J>& P, const float* a, float f) {
  float row[J];
  float b0 = f;
#pragma unroll
  for (int k = 0; k < J; ++k) row[k] = 0.0f;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const float aj = a[j];
#pragma unroll
    for (int k = 0; k < J; ++k) row[k] -= aj * P.A[j][k];
    b0 -= aj * P.b[j];
  }
#pragma unroll
  for (int i = J - 1; i >= 1; --i) {
#pragma unroll
    for (int k = 0; k < J; ++k) P.A[i][k] = P.A[i - 1][k];
    P.b[i] = P.b[i - 1];
  }
#pragma unroll
  for (int k = 0; k < J; ++k) P.A[0][k] = row[k];
  P.b[0] = b0;
}

// Exclusive scan of one map per thread across the block; same shape as
// block_exclusive_scan.  *total receives the block's map.
template <int J>
__device__ Map<J> block_exclusive_scan_maps(const Map<J>& v, Map<J>* warp_maps,
                                            Map<J>* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  Map<J> incl = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Map<J> o = shfl_up_map<J>(incl, d);
    if (lane >= d) incl = compose<J>(incl, o);
  }
  Map<J> excl = shfl_up_map<J>(incl, 1);
  if (lane == 31) warp_maps[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    Map<J> t;
    if (lane < nwarps) {
      t = warp_maps[lane];
    } else {
      set_identity<J>(t);
    }
    for (int d = 1; d < nwarps; d <<= 1) {
      const Map<J> o = shfl_up_map<J>(t, d);
      if (lane >= d) t = compose<J>(t, o);
    }
    if (lane < nwarps) warp_maps[lane] = t;
  }
  __syncthreads();
  if (warp > 0) {
    const Map<J> before = warp_maps[warp - 1];
    if (lane == 0) {
      excl = before;
    } else {
      excl = compose<J>(excl, before);
    }
  } else if (lane == 0) {
    set_identity<J>(excl);
  }
  *total = warp_maps[nwarps - 1];
  __syncthreads();
  return excl;
}

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned count_acq_rel(unsigned* p) {
  unsigned old;
  asm volatile("atom.add.acq_rel.gpu.global.u32 %0, [%1], 1;"
               : "=r"(old) : "l"(p) : "memory");
  return old;
}

// A status record as a map: an anchor's exit history is the constant map
// (A = 0, b = history).
template <int J>
__device__ __forceinline__ Map<J> load_record(const float* rec, bool history) {
  Map<J> m;
#pragma unroll
  for (int i = 0; i < J; ++i) {
#pragma unroll
    for (int k = 0; k < J; ++k) {
      m.A[i][k] = history ? 0.0f : __ldcg(rec + i * J + k);
    }
    m.b[i] = __ldcg(rec + (history ? i : J * J + i));
  }
  return m;
}

// Run by the whole block of tile t > 0; thread 0 writes the history
// entering the tile to h_in.  Fixed grouping: the exit history of anchor
// a = the last multiple of kAffThreads below t, as a constant map, then
// the maps of tiles a + 1 .. t - 1, composed in sequence order.  Thread k
// waits for tile a + k's flag (acquire) and reads its record from L2;
// each warp's shuffle tree then folds lane l + d into lane l (the later
// map after the earlier), and thread 0 folds the warp totals in order.
// The fold's b is the entering history.  With at most 32 records, only
// warp 0 takes part and no barrier is needed.
template <int J>
__device__ void affine_look_back(const unsigned* flags, const float* records,
                                 int64_t t, Map<J>* warp_maps, float* h_in) {
  const int64_t a = (t - 1) / kAffThreads * kAffThreads;
  const int words = (int)(t - a);
  const int lane = threadIdx.x & 31;
  if (words <= 32 && threadIdx.x >= 32) return;
  const bool mine = (int)threadIdx.x < words;
  bool ready = !mine;
  // The warp spins as one, as the prefix scan's look-back does.
  while (__any_sync(kFull, !ready)) {
    if (!ready) ready = load_acquire(&flags[a + threadIdx.x]) != kAffNotReady;
  }
  Map<J> v;
  if (mine) {
    v = load_record<J>(records + (a + threadIdx.x) * kAffRecord,
                       threadIdx.x == 0);
  } else {
    set_identity<J>(v);
  }
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Map<J> o = shfl_down_map<J>(v, d);
    if (lane + d < 32) v = compose<J>(o, v);
  }
  if (words > 32) {
    if (lane == 0) warp_maps[threadIdx.x >> 5] = v;
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int w = 1; w < (words + 31) / 32; ++w) {
        v = compose<J>(warp_maps[w], v);
      }
    }
  }
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < J; ++i) h_in[i] = v.b[i];
  }
}

// Copies `count` floats of a tile from global memory into the padded
// shared rows (lane group e / per_row of row_floats per thread).  float4
// when the source is 16-byte aligned and whole, else masked scalars.
template <int kPerRow>
__device__ __forceinline__ void load_rows(const float* __restrict__ src,
                                          int64_t avail, bool vec,
                                          float* dst) {
  constexpr int kRow = aff_row(kPerRow);
  constexpr int kCount = kAffThreads * kPerRow;
  if (vec) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
#pragma unroll
    for (int k = 0; k < kCount / 4 / kAffThreads; ++k) {
      const int e = 4 * (k * kAffThreads + threadIdx.x);
      *reinterpret_cast<float4*>(&dst[e / kPerRow * kRow + e % kPerRow]) =
          __ldcs(&s4[k * kAffThreads + threadIdx.x]);
    }
  } else {
    for (int e = threadIdx.x; e < kCount; e += kAffThreads) {
      dst[e / kPerRow * kRow + e % kPerRow] = e < avail ? src[e] : 0.0f;
    }
  }
}

// One launch: for each of `rows` rows, h f32[n, J] and hist f32[J] from
// a f32[n, J], ff f32[n], live u8[n] and h0 f32[J] (row r of each at r
// times its row's size).  As in the prefix scan, a tile never crosses a
// row and its look-back reads only its own row's flags and records, in a
// single row's grouping, so row r gives the bits of a one-row call on it.
// kRows = false is the one-row form, compiled without the row arithmetic.
template <int J, bool kRows>
__global__ void __launch_bounds__(kAffThreads)
affine_single_pass(const float* __restrict__ a_all,
                   const float* __restrict__ ff_all,
                   const uint8_t* __restrict__ live_all,
                   const float* __restrict__ h0_all, float* __restrict__ h_all,
                   float* __restrict__ hist_all, unsigned* scratch, int64_t cap,
                   int64_t rows, int64_t n) {
  constexpr int kRowA = aff_row(kAffItems * J);
  constexpr int kRowF = aff_row(kAffItems);
  extern __shared__ __align__(16) unsigned char aff_smem[];
  float* a_s = reinterpret_cast<float*>(aff_smem);  // then h, in place
  float* ff_s = a_s + kAffThreads * kRowA;
  uint8_t* live_s = reinterpret_cast<uint8_t*>(ff_s + kAffThreads * kRowF);
  __shared__ Map<J> warp_maps[kAffThreads / 32];
  __shared__ float h_tile[J];
  __shared__ unsigned tile_index;
  __shared__ bool last_block;

  const int64_t nbr = (n + kAffTile - 1) / kAffTile;  // tiles per row
  const int64_t nb = kRows ? rows * nbr : nbr;
  int64_t gt = blockIdx.x;
  if (nbr > 1) {
    if (threadIdx.x == 0) tile_index = atomicAdd(&scratch[0], 1u);
    __syncthreads();
    gt = (int64_t)tile_index;
  }
  // A 32-bit division (nb < 2^31), cheaper than a 64-bit one.
  const int64_t r = kRows ? (int64_t)((unsigned)gt / (unsigned)nbr) : 0;
  const int64_t t = gt - r * nbr;
  const float* __restrict__ a = a_all + r * n * J;
  const float* __restrict__ ff = ff_all + r * n;
  const uint8_t* __restrict__ live = live_all + r * n;
  const float* __restrict__ h0 = h0_all + r * J;
  float* __restrict__ h = h_all + r * n * J;
  float* __restrict__ hist = hist_all + r * J;
  unsigned* flags = scratch + kAffHead + r * nbr;
  float* records = reinterpret_cast<float*>(scratch + aff_payload_offset(cap)) +
                   r * nbr * kAffRecord;
  const int64_t base = t * kAffTile;
  const bool whole = base + kAffTile <= n;
  const int64_t avail = whole ? kAffTile : n - base;

  // Load: coalesced, into the padded rows.
  load_rows<kAffItems * J>(a + base * J, avail * J,
                           whole && ((uintptr_t)a & 15) == 0, a_s);
  load_rows<kAffItems>(ff + base, avail, whole && ((uintptr_t)ff & 15) == 0,
                       ff_s);
  if (whole && ((uintptr_t)live & 15) == 0) {
    const uint4* s4 = reinterpret_cast<const uint4*>(live + base);
    for (int v = threadIdx.x; v < kAffTile / 16; v += kAffThreads) {
      reinterpret_cast<uint4*>(live_s)[v] = __ldcs(&s4[v]);
    }
  } else {
    for (int e = threadIdx.x; e < kAffTile; e += kAffThreads) {
      live_s[e] = e < avail ? live[base + e] : 0;
    }
  }
  __syncthreads();

  // Each thread composes its lanes' maps, O(J^2) a lane.
  const float* row_a = a_s + threadIdx.x * kRowA;
  const float* row_f = ff_s + threadIdx.x * kRowF;
  const uint8_t* row_l = live_s + threadIdx.x * kAffItems;
  Map<J> P;
  set_identity<J>(P);
#pragma unroll
  for (int g = 0; g < kAffItems / 4; ++g) {
    float av[4 * J];
#pragma unroll
    for (int c = 0; c < J; ++c) {
      const float4 q = reinterpret_cast<const float4*>(row_a + 4 * J * g)[c];
      av[4 * c] = q.x, av[4 * c + 1] = q.y, av[4 * c + 2] = q.z,
      av[4 * c + 3] = q.w;
    }
    const float4 fq = reinterpret_cast<const float4*>(row_f)[g];
    const float fv[4] = {fq.x, fq.y, fq.z, fq.w};
    const unsigned lw = reinterpret_cast<const unsigned*>(row_l)[g];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if ((lw >> (8 * q)) & 0xff) push_lane<J>(P, av + q * J, fv[q]);
    }
  }
  Map<J> total;
  const Map<J> excl = block_exclusive_scan_maps<J>(P, warp_maps, &total);

  // The history entering the tile.
  if (nbr > 1) {
    const bool anchor = t % kAffThreads == 0;
    float* rec = records + t * kAffRecord;
    if (threadIdx.x == 0 && !anchor) {
#pragma unroll
      for (int i = 0; i < J; ++i) {
#pragma unroll
        for (int k = 0; k < J; ++k) rec[i * J + k] = total.A[i][k];
        rec[J * J + i] = total.b[i];
      }
      store_release(&flags[t], kAffAggregate);
    }
    if (t == 0) {
      if (threadIdx.x < J) h_tile[threadIdx.x] = h0[threadIdx.x];
      __syncthreads();
    } else {
      affine_look_back<J>(flags, records, t, warp_maps, h_tile);
    }
    if (threadIdx.x == 0) {
      if (anchor) {
        apply_map<J>(total, h_tile, rec);
        store_release(&flags[t], kAffHistory);
      }
      // Every read of a flag or record by this block is done, and this
      // tile's flag is final.
      last_block = count_acq_rel(&scratch[1]) == (unsigned)(nb - 1);
    }
  } else if (threadIdx.x < J) {
    h_tile[threadIdx.x] = h0[threadIdx.x];
  }
  __syncthreads();

  // The recurrence over the thread's lanes from its entering history, in
  // the reference's op order; h overwrites a in the thread's row.
  float hv[J];
  {
    float hb[J];
#pragma unroll
    for (int i = 0; i < J; ++i) hb[i] = h_tile[i];
    apply_map<J>(excl, hb, hv);
  }
  const int64_t first = base + (int64_t)threadIdx.x * kAffItems;
#pragma unroll
  for (int g = 0; g < kAffItems / 4; ++g) {
    float4* row4 =
        reinterpret_cast<float4*>(a_s + threadIdx.x * kRowA + 4 * J * g);
    float av[4 * J];
#pragma unroll
    for (int c = 0; c < J; ++c) {
      const float4 q = row4[c];
      av[4 * c] = q.x, av[4 * c + 1] = q.y, av[4 * c + 2] = q.z,
      av[4 * c + 3] = q.w;
    }
    const float4 fq = reinterpret_cast<const float4*>(row_f)[g];
    const float fv[4] = {fq.x, fq.y, fq.z, fq.w};
    const unsigned lw = reinterpret_cast<const unsigned*>(row_l)[g];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if ((lw >> (8 * q)) & 0xff) {
        float y = fv[q];
#pragma unroll
        for (int j = 0; j < J; ++j) y -= av[q * J + j] * hv[j];
#pragma unroll
        for (int j = J - 1; j >= 1; --j) hv[j] = hv[j - 1];
        hv[0] = y;
      }
#pragma unroll
      for (int j = 0; j < J; ++j) av[q * J + j] = hv[j];
      if (first + 4 * g + q == n - 1) {
#pragma unroll
        for (int j = 0; j < J; ++j) hist[j] = hv[j];
      }
    }
#pragma unroll
    for (int c = 0; c < J; ++c) {
      row4[c] = make_float4(av[4 * c], av[4 * c + 1], av[4 * c + 2],
                            av[4 * c + 3]);
    }
  }
  __syncthreads();

  // Store: coalesced, from the padded rows.
  {
    constexpr int kPerRow = kAffItems * J;
    float* dst = h + base * J;
    if (whole && ((uintptr_t)h & 15) == 0) {
      float4* d4 = reinterpret_cast<float4*>(dst);
#pragma unroll
      for (int k = 0; k < kPerRow / 4; ++k) {
        const int v = k * kAffThreads + threadIdx.x;
        const int e = 4 * v;
        d4[v] = *reinterpret_cast<const float4*>(
            &a_s[e / kPerRow * kRowA + e % kPerRow]);
      }
    } else {
      for (int e = threadIdx.x; e < kAffThreads * kPerRow; e += kAffThreads) {
        if (e < avail * J) dst[e] = a_s[e / kPerRow * kRowA + e % kPerRow];
      }
    }
  }

  // The last block to finish its look-back leaves the scratch clean.
  if (nbr > 1 && last_block) {
    unsigned* all = scratch + kAffHead;
    for (int64_t i = threadIdx.x; i < nb; i += kAffThreads) all[i] = 0;
    if (threadIdx.x == 0) {
      scratch[0] = 0;
      scratch[1] = 0;
    }
  }
}

template <int J>
int run_affine(const float* a, const float* ff, const uint8_t* live,
               const float* h0, float* h, float* hist, unsigned* scratch,
               int64_t cap, int64_t rows, int64_t n, cudaStream_t stream) {
  const int64_t nbr = (n + kAffTile - 1) / kAffTile;
  const int64_t nb = rows * nbr;
  if (nb > kMaxN || (nbr > 1 && (scratch == nullptr || nb > cap))) {
    return (int)cudaErrorInvalidValue;
  }
  constexpr size_t smem = aff_smem_bytes<J>();
  auto kernel = rows == 1 ? affine_single_pass<J, false>
                          : affine_single_pass<J, true>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<(unsigned)nb, kAffThreads, smem, stream>>>(
      a, ff, live, h0, h, hist, scratch, cap, rows, n);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Deep affine scan: the same IIR for kMaxJ < J <= kDeepMaxJ, maps in shared
// memory.
// ---------------------------------------------------------------------------

constexpr int kDeepMaxJ = 16;
constexpr int kDeepSeg = 32;  // lanes a segment
constexpr int kDeepSegsPerWarp = 4;
constexpr int kDeepWarps = 8;
constexpr int kDeepThreads = 32 * kDeepWarps;
constexpr int kDeepSegs = kDeepWarps * kDeepSegsPerWarp;  // 32
constexpr int kDeepTile = kDeepSegs * kDeepSeg;           // 1024 lanes
// Every kDeepAnchor-th tile is an anchor: a look-back reads at most that
// many records, one flag a lane of warp 0.
constexpr int kDeepAnchor = 32;
static_assert((kDeepSegs & (kDeepSegs - 1)) == 0, "the sweeps pair segments");
static_assert(kDeepSeg % 4 == 0, "segments start on 16-byte boundaries");
static_assert(kDeepSegsPerWarp <= 4, "cp_async_wait covers 3 pending groups");
static_assert(kDeepAnchor <= 32, "warp 0 waits for the look-back's flags");

// Floats of one map column in shared memory and in a record: J rounded up
// to a float4, and to an odd number of float4s (as aff_row), so that a
// warp's float4 reads of consecutive columns are free of bank conflicts.
__host__ __device__ constexpr int deep_col(int J) { return aff_row((J + 3) / 4 * 4); }
// A record: a map of kDeepMaxJ + 1 such columns, or an anchor's history in
// its first J floats.  The scratch is laid out as the affine scan's
// (aff_payload_offset), with records of this size.
constexpr int kDeepRecord = (kDeepMaxJ + 1) * deep_col(kDeepMaxJ);

template <int J>
struct Deep {
  static constexpr int kJp = deep_col(J);
  static constexpr int kMap = (J + 1) * kJp;  // columns 0..J-1: A; J: b
  static constexpr int kSegA = kDeepSeg * J + 4;  // a segment's a, padded
  static constexpr int kSegF = kDeepSeg + 4;      // a segment's ff, then y
  // Shared-memory offsets, in floats; every region 16-byte aligned.
  static constexpr int kA = 0;
  static constexpr int kF = kA + kDeepSegs * kSegA;
  static constexpr int kMaps = kF + kDeepSegs * kSegF;
  static constexpr int kHv = kMaps + kDeepSegs * kMap;  // entering histories
  static constexpr int kLb = kHv + kDeepSegs * kJp;     // look-back records
  static constexpr int kLive = kLb + kDeepAnchor * kMap;
  static constexpr size_t kSmemBytes = sizeof(float) * (size_t)kLive + kDeepTile;
  static_assert(kMap <= kDeepRecord, "a record holds the tile's map");
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               :: "r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
               :: "r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Waits until at most `pending` (0..3) of this thread's groups are in flight.
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;" ::: "memory"); break;
  }
}

// The calling warp copies one segment's a, ff and live (lanes seg0 ..
// seg0 + kDeepSeg - 1 of the row; zero past n, so those lanes are dead)
// into shared memory, as one commit group: 16-byte copies where the row's
// pointer is 16-byte aligned and the segment whole, else 4-byte ones.
template <int J>
__device__ __forceinline__ void deep_stage(float* a_s, float* f_s, uint8_t* l_s,
                                           const float* __restrict__ a,
                                           const float* __restrict__ ff,
                                           const uint8_t* __restrict__ live,
                                           int64_t seg0, int64_t n, bool a16,
                                           bool f16, int lane) {
  const int64_t left = n - seg0;
  const int m = left >= kDeepSeg ? kDeepSeg : left > 0 ? (int)left : 0;
  const float* src = a + seg0 * J;
  if (m == kDeepSeg && a16) {
    for (int v = lane; v < kDeepSeg * J / 4; v += 32) {
      cp_async16(a_s + 4 * v, src + 4 * v);
    }
  } else {
    for (int e = lane; e < kDeepSeg * J; e += 32) {
      if (e < m * J) {
        cp_async4(a_s + e, src + e);
      } else {
        a_s[e] = 0.0f;
      }
    }
  }
  if (m == kDeepSeg && f16) {
    if (lane < kDeepSeg / 4) cp_async16(f_s + 4 * lane, ff + seg0 + 4 * lane);
  } else {
    for (int e = lane; e < kDeepSeg; e += 32) {
      if (e < m) {
        cp_async4(f_s + e, ff + seg0 + e);
      } else {
        f_s[e] = 0.0f;
      }
    }
  }
  for (int e = lane; e < kDeepSeg; e += 32) l_s[e] = e < m ? live[seg0 + e] : 0;
  cp_async_commit();
}

// A segment's map, column by column, by the calling warp: lane c < J
// pushes the basis history e_c through the segment with ff = 0, lane J
// pushes ff from a zero history (lanes past J push zeros and write
// nothing).  Lane c's history after the segment is column c of the map.
// Four partial sums shorten each lane's chain: a map only carries the
// history, so its order of rounding is free (and fixed: the same bits
// every call).  A dead lane is the identity, the same for the whole warp.
template <int J>
__device__ __forceinline__ void deep_build_map(const float* a_s,
                                               const float* f_s,
                                               const uint8_t* l_s, float* map,
                                               int lane) {
  float h[J];
#pragma unroll
  for (int j = 0; j < J; ++j) h[j] = j == lane ? 1.0f : 0.0f;
  const bool bcol = lane == J;
#pragma unroll 2
  for (int i = 0; i < kDeepSeg; ++i) {
    const float* ar = a_s + i * J;
    float p[4] = {bcol ? f_s[i] : 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < J; ++j) p[j & 3] -= ar[j] * h[j];
    const float y = (p[0] + p[1]) + (p[2] + p[3]);
    if (l_s[i]) {
#pragma unroll
      for (int j = J - 1; j >= 1; --j) h[j] = h[j - 1];
      h[0] = y;
    }
  }
  if (lane <= J) {
    float* col = map + lane * Deep<J>::kJp;
#pragma unroll
    for (int j = 0; j < J; ++j) col[j] = h[j];
  }
}

// Column c of the map "mr after ml" into out: A_r times column c of A_l
// (c < J), or A_r b_l + b_r (c == J).  The left column is read as
// float4s (consecutive columns, so a warp's reads fall in distinct
// banks), the right map's columns as float4s that a product's threads
// share.
template <int J>
__device__ __forceinline__ void deep_compose_column(const float* mr,
                                                    const float* ml, int c,
                                                    float* out) {
  constexpr int Jp = Deep<J>::kJp;
  constexpr int kV = (J + 3) / 4;
  float lc[4 * kV];
#pragma unroll
  for (int q = 0; q < kV; ++q) {
    const float4 v = reinterpret_cast<const float4*>(ml + c * Jp)[q];
    lc[4 * q] = v.x, lc[4 * q + 1] = v.y, lc[4 * q + 2] = v.z,
    lc[4 * q + 3] = v.w;
  }
#pragma unroll
  for (int i = 0; i < J; ++i) out[i] = c == J ? mr[J * Jp + i] : 0.0f;
#pragma unroll
  for (int x = 0; x < J; ++x) {
    const float s = lc[x];
    const float4* rc = reinterpret_cast<const float4*>(mr + x * Jp);
#pragma unroll
    for (int q = 0; q < kV; ++q) {
      const float4 v = rc[q];
      const float w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (4 * q + k < J) out[4 * q + k] += w[k] * s;
      }
    }
  }
}

// Blelloch up-sweep of the tile's segment maps, in place: at the level of
// width d, map R = (2p + 2) d - 1 becomes "R after R - d"; the root then
// holds the tile's map.  One thread an output column; every column is
// read before any is written.
template <int J>
__device__ void deep_up_sweep(float* maps) {
  constexpr int kMap = Deep<J>::kMap;
  constexpr int kRounds =
      (kDeepSegs / 2 * (J + 1) + kDeepThreads - 1) / kDeepThreads;
  for (int d = 1; d < kDeepSegs; d <<= 1) {
    const int tasks = kDeepSegs / (2 * d) * (J + 1);
    float out[kRounds][J];
#pragma unroll
    for (int u = 0; u < kRounds; ++u) {
      const int e = threadIdx.x + u * kDeepThreads;
      if (e < tasks) {
        const int p = e / (J + 1), c = e - p * (J + 1);
        const int R = (2 * p + 2) * d - 1;
        deep_compose_column<J>(maps + R * kMap, maps + (R - d) * kMap, c,
                               out[u]);
      }
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kRounds; ++u) {
      const int e = threadIdx.x + u * kDeepThreads;
      if (e < tasks) {
        const int p = e / (J + 1), c = e - p * (J + 1);
        const int R = (2 * p + 2) * d - 1;
        float* col = maps + R * kMap + c * Deep<J>::kJp;
#pragma unroll
        for (int i = 0; i < J; ++i) col[i] = out[u][i];
      }
    }
    __syncthreads();
  }
}

// The down-sweep of entering histories (hv, kJp floats a segment, the
// root's slot holding the tile's): from the widest level down, the left
// child takes the parent's history and the right child the left child's
// map applied to it.  One thread a row of one product.
template <int J>
__device__ void deep_down_sweep(const float* maps, float* hv) {
  constexpr int Jp = Deep<J>::kJp, kMap = Deep<J>::kMap;
  constexpr int kRounds = (kDeepSegs / 2 * J + kDeepThreads - 1) / kDeepThreads;
  for (int d = kDeepSegs / 2; d >= 1; d >>= 1) {
    const int tasks = kDeepSegs / (2 * d) * J;
    float vr[kRounds], vl[kRounds];
#pragma unroll
    for (int u = 0; u < kRounds; ++u) {
      const int e = threadIdx.x + u * kDeepThreads;
      if (e < tasks) {
        const int p = e / J, i = e - p * J;
        const int R = (2 * p + 2) * d - 1;
        const float* ml = maps + (R - d) * kMap;
        const float* hr = hv + R * Jp;
        float acc = ml[J * Jp + i];
#pragma unroll
        for (int x = 0; x < J; ++x) acc += ml[x * Jp + i] * hr[x];
        vr[u] = acc;
        vl[u] = hr[i];
      }
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kRounds; ++u) {
      const int e = threadIdx.x + u * kDeepThreads;
      if (e < tasks) {
        const int p = e / J, i = e - p * J;
        const int R = (2 * p + 2) * d - 1;
        hv[R * Jp + i] = vr[u];
        hv[(R - d) * Jp + i] = vl[u];
      }
    }
    __syncthreads();
  }
}

// Row i of m(h), by a whole warp: h_c is held by lane c.  Every tile's
// exit history (an anchor's record, a row's hist) and every step of a
// look-back is this product, each op written out (__fmaf_rn, __fadd_rn),
// so that the same map and history give the same bits at every call
// site.
template <int J>
__device__ __forceinline__ float deep_apply_lane(const float* m, float h,
                                                 int i) {
  constexpr int Jp = Deep<J>::kJp;
  float p[4] = {m[J * Jp + i], 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int c = 0; c < J; ++c) {
    p[c & 3] = __fmaf_rn(m[c * Jp + i], __shfl_sync(kFull, h, c), p[c & 3]);
  }
  return __fadd_rn(__fadd_rn(p[0], p[1]), __fadd_rn(p[2], p[3]));
}

// Run by warp 0 of tile t > 0: lane k waits for the flag of tile a + 1 +
// k (acquire) for k < m, m = t - 1 - a the non-anchor tiles between the
// anchor a (the last multiple of kDeepAnchor below t) and t; then the warp
// copies their maps from L2 into lb, map k at lb + k * kMap.
template <int J>
__device__ void deep_wait_maps(const unsigned* flags, const float* records,
                               int64_t a, int m, float* lb, int lane) {
  constexpr int kMap = Deep<J>::kMap, kMap4 = kMap / 4;
  bool ready = lane >= m;
  // The warp spins as one, as the affine scan's look-back does.
  while (__any_sync(kFull, !ready)) {
    if (!ready) ready = load_acquire(&flags[a + 1 + lane]) != kAffNotReady;
  }
  __syncwarp();
  for (int v = lane; v < m * kMap4; v += 32) {
    const int k = v / kMap4, off = 4 * (v - k * kMap4);
    cp_async16(lb + k * kMap + off, records + (a + 1 + k) * kDeepRecord + off);
  }
  cp_async_commit();
  cp_async_wait(0);
  __syncwarp();
}

// Run by warp 0: row i of anchor a's exit history, each lane waiting for
// the anchor's flag (acquire) before it reads the record from L2.
template <int J>
__device__ __forceinline__ float deep_wait_history(const unsigned* flags,
                                                   const float* records,
                                                   int64_t a, int i) {
  while (!__all_sync(kFull, load_acquire(&flags[a]) == kAffHistory)) {
  }
  return __ldcg(records + a * kDeepRecord + i);
}

// One launch: for each of `rows` rows, y f32[n] and hist f32[J] from a
// f32[n, J], ff f32[n], live u8[n] and h0 f32[J] (row r of each at r times
// its row's size).  As in the affine scan, a tile never crosses a row and
// its look-back reads only its own row's flags and records, in a single
// row's grouping, so row r gives the bits of a one-row call on it.  One
// form serves both: the row arithmetic is one 32-bit division a block.
template <int J>
__global__ void __launch_bounds__(kDeepThreads)
affine_deep_pass(const float* __restrict__ a_all,
                 const float* __restrict__ ff_all,
                 const uint8_t* __restrict__ live_all,
                 const float* __restrict__ h0_all, float* __restrict__ y_all,
                 float* __restrict__ hist_all, unsigned* scratch, int64_t cap,
                 int64_t rows, int64_t n) {
  using D = Deep<J>;
  constexpr int Jp = D::kJp, kMap = D::kMap;
  extern __shared__ __align__(16) float deep_smem[];
  float* a_s = deep_smem + D::kA;
  float* f_s = deep_smem + D::kF;
  float* maps = deep_smem + D::kMaps;
  float* hv = deep_smem + D::kHv;
  float* lb = deep_smem + D::kLb;
  uint8_t* live_s = reinterpret_cast<uint8_t*>(deep_smem + D::kLive);
  __shared__ unsigned tile_index;
  __shared__ bool last_block;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t nbr = (n + kDeepTile - 1) / kDeepTile;  // tiles per row
  const int64_t nb = rows * nbr;
  int64_t gt = blockIdx.x;
  if (nbr > 1) {
    if (threadIdx.x == 0) tile_index = atomicAdd(&scratch[0], 1u);
    __syncthreads();
    gt = (int64_t)tile_index;
  }
  // A 32-bit division (nb < 2^31), cheaper than a 64-bit one.
  const int64_t r = (int64_t)((unsigned)gt / (unsigned)nbr);
  const int64_t t = gt - r * nbr;
  const float* __restrict__ a = a_all + r * n * J;
  const float* __restrict__ ff = ff_all + r * n;
  const uint8_t* __restrict__ live = live_all + r * n;
  const float* __restrict__ h0 = h0_all + r * J;
  float* __restrict__ y = y_all + r * n;
  float* __restrict__ hist = hist_all + r * J;
  unsigned* flags = scratch + kAffHead + r * nbr;
  float* records = reinterpret_cast<float*>(scratch + aff_payload_offset(cap)) +
                   r * nbr * kDeepRecord;
  const int64_t base = t * kDeepTile;
  const bool a16 = ((uintptr_t)a & 15) == 0;
  const bool f16 = ((uintptr_t)ff & 15) == 0;

  // Each warp stages its own segments, then builds each one's map as its
  // copy lands.
#pragma unroll
  for (int q = 0; q < kDeepSegsPerWarp; ++q) {
    const int k = warp * kDeepSegsPerWarp + q;
    deep_stage<J>(a_s + k * D::kSegA, f_s + k * D::kSegF,
                  live_s + k * kDeepSeg, a, ff, live, base + k * kDeepSeg, n,
                  a16, f16, lane);
  }
#pragma unroll
  for (int q = 0; q < kDeepSegsPerWarp; ++q) {
    cp_async_wait(kDeepSegsPerWarp - 1 - q);
    __syncwarp();
    const int k = warp * kDeepSegsPerWarp + q;
    deep_build_map<J>(a_s + k * D::kSegA, f_s + k * D::kSegF,
                      live_s + k * kDeepSeg, maps + k * kMap, lane);
  }
  __syncthreads();
  deep_up_sweep<J>(maps);
  const float* total = maps + (kDeepSegs - 1) * kMap;

  // The history entering the tile, into the root's slot of hv, and the
  // one leaving it: the tile's map applied to it.  The last tile's is the
  // row's hist, so a render in blocks of whole tiles carries the same
  // history from block to block as one call over those blocks carries
  // from tile to tile: the same bits either way.
  const bool anchor = t % kDeepAnchor == 0;
  float* rec = records + t * kDeepRecord;
  if (nbr > 1 && !anchor) {
    for (int v = threadIdx.x; v < kMap / 4; v += kDeepThreads) {
      reinterpret_cast<float4*>(rec)[v] =
          reinterpret_cast<const float4*>(total)[v];
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      __threadfence();
      store_release(&flags[t], kAffAggregate);
    }
  }
  if (warp == 0) {
    const int i = lane < J ? lane : 0;
    float h = h0[i];
    if (t > 0) {
      // Look-back, in a fixed grouping: the maps of the tiles between
      // anchor a and t, which publish at once, are copied in while anchor
      // a's exit history may still be on its way; then each map in turn.
      const int64_t a = (t - 1) / kDeepAnchor * kDeepAnchor;
      const int m = (int)(t - 1 - a);
      if (m > 0) deep_wait_maps<J>(flags, records, a, m, lb, lane);
      h = deep_wait_history<J>(flags, records, a, i);
      for (int w = 0; w < m; ++w) h = deep_apply_lane<J>(lb + w * kMap, h, i);
    }
    if (lane < J) hv[(kDeepSegs - 1) * Jp + lane] = h;
    const bool last = t == nbr - 1;
    if ((nbr > 1 && anchor) || last) {
      const float h_exit = deep_apply_lane<J>(total, h, i);
      if (last && lane < J) hist[lane] = h_exit;
      if (nbr > 1 && anchor) {
        if (lane < J) rec[lane] = h_exit;
        __syncwarp();
        if (lane == 0) {
          __threadfence();
          store_release(&flags[t], kAffHistory);
        }
      }
    }
    // Every read of a flag or record by this block is done, and this
    // tile's flag is final.
    if (nbr > 1 && lane == 0) {
      last_block = count_acq_rel(&scratch[1]) == (unsigned)(nb - 1);
    }
  }
  __syncthreads();
  deep_down_sweep<J>(maps, hv);

  // The recurrence over each segment from its entering history, in the
  // reference's op order, one thread a segment (segment k of the warp's
  // in lane k: their rows of a lie 4 banks apart); y overwrites ff.
  if (lane < kDeepSegsPerWarp) {
    const int k = warp * kDeepSegsPerWarp + lane;
    const float* as = a_s + k * D::kSegA;
    float* fs = f_s + k * D::kSegF;
    const uint8_t* ls = live_s + k * kDeepSeg;
    float hr[J];
#pragma unroll
    for (int j = 0; j < J; ++j) hr[j] = hv[k * Jp + j];
#pragma unroll 2
    for (int i = 0; i < kDeepSeg; ++i) {
      const bool lv = ls[i] != 0;
      float yv = fs[i];
#pragma unroll
      for (int j = 0; j < J; ++j) yv -= as[i * J + j] * hr[j];
#pragma unroll
      for (int j = J - 1; j >= 1; --j) hr[j] = lv ? hr[j - 1] : hr[j];
      hr[0] = lv ? yv : hr[0];
      fs[i] = lv ? yv : 0.0f;
    }
  }
  __syncthreads();

  // Store: coalesced, from the padded segments.
  if (base + kDeepTile <= n && ((uintptr_t)y & 15) == 0) {
    for (int v = threadIdx.x; v < kDeepTile / 4; v += kDeepThreads) {
      const int e = 4 * v;
      reinterpret_cast<float4*>(y + base)[v] = *reinterpret_cast<const float4*>(
          &f_s[e / kDeepSeg * D::kSegF + e % kDeepSeg]);
    }
  } else {
    for (int e = threadIdx.x; e < kDeepTile; e += kDeepThreads) {
      if (base + e < n) y[base + e] = f_s[e / kDeepSeg * D::kSegF + e % kDeepSeg];
    }
  }

  // The last block to finish its look-back leaves the scratch clean.
  if (nbr > 1 && last_block) {
    unsigned* all = scratch + kAffHead;
    for (int64_t i = threadIdx.x; i < nb; i += kDeepThreads) all[i] = 0;
    if (threadIdx.x == 0) {
      scratch[0] = 0;
      scratch[1] = 0;
    }
  }
}

template <int J>
int run_affine_deep(const float* a, const float* ff, const uint8_t* live,
                    const float* h0, float* y, float* hist, unsigned* scratch,
                    int64_t cap, int64_t rows, int64_t n,
                    cudaStream_t stream) {
  const int64_t nbr = (n + kDeepTile - 1) / kDeepTile;
  const int64_t nb = rows * nbr;
  if (nb > kMaxN || (nbr > 1 && (scratch == nullptr || nb > cap))) {
    return (int)cudaErrorInvalidValue;
  }
  constexpr size_t smem = Deep<J>::kSmemBytes;
  const cudaError_t e = cudaFuncSetAttribute(
      affine_deep_pass<J>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  affine_deep_pass<J><<<(unsigned)nb, kDeepThreads, smem, stream>>>(
      a, ff, live, h0, y, hist, scratch, cap, rows, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int tuun_scan_tile() { return kScanTile; }
long long tuun_scan_scratch_words() { return kScratchWords; }
int tuun_affine_tile() { return kAffTile; }
int tuun_affine_max_j() { return kMaxJ; }

// x and out f32[rows, n] row-major, each row scanned on its own, in one
// launch, with the bits a one-row call gives: out[r, i] = x[r, 0] + ... +
// x[r, i], the same bits on every call.  scratch: the caller's persistent,
// zeroed buffer of tuun_scan_scratch_words() 64-bit words for this stream
// (null when n <= one tile), which rows * ceil(n / tile) tiles must fit;
// the kernel leaves it zeroed.  Calls that share a scratch buffer must not
// overlap.
int tuun_prefix_sum_rows_f32(const float* x, float* out,
                             unsigned long long* scratch, long long rows,
                             long long n, void* stream) {
  return run_prefix<SumOp>(x, out, scratch, rows, n, (cudaStream_t)stream);
}

// out[r, i] = max(x[r, 0..i]) with torch.cummax's NaN and tie rules; the
// rest as for tuun_prefix_sum_rows_f32.
int tuun_prefix_max_rows_f32(const float* x, float* out,
                             unsigned long long* scratch, long long rows,
                             long long n, void* stream) {
  return run_prefix<MaxOp>(x, out, scratch, rows, n, (cudaStream_t)stream);
}

// Words (32-bit) of an affine-scan scratch buffer for up to `tiles` tiles.
long long tuun_affine_scratch_words(long long tiles) {
  return aff_payload_offset(tiles) + tiles * kAffRecord;
}

// a f32[rows, n, J], ff f32[rows, n], live u8[rows, n], h0 f32[rows, J]
// (each row-major) -> h f32[rows, n, J] (h[r, i, j] = y_r[i - j]), hist
// f32[rows, J] (= h[r, n-1, :]), each row scanned on its own, in one
// launch, with the bits a one-row call gives.  scratch: the caller's
// persistent buffer of tuun_affine_scratch_words(cap) words for this
// stream, with counters and flags zero, cap >= rows * ceil(n /
// tuun_affine_tile()) (null when n <= one tile); the kernel leaves it so.
// Calls that share a scratch buffer must not overlap.
int tuun_affine_scan_rows_f32(const float* a, const float* ff,
                              const uint8_t* live, const float* h0, float* h,
                              float* hist, unsigned* scratch, long long cap,
                              long long rows, long long n, int J,
                              void* stream) {
  if (n <= 0 || n > kMaxN || rows <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (J) {
    case 1: return run_affine<1>(a, ff, live, h0, h, hist, scratch, cap,
                                 rows, n, s);
    case 2: return run_affine<2>(a, ff, live, h0, h, hist, scratch, cap,
                                 rows, n, s);
    case 3: return run_affine<3>(a, ff, live, h0, h, hist, scratch, cap,
                                 rows, n, s);
    case 4: return run_affine<4>(a, ff, live, h0, h, hist, scratch, cap,
                                 rows, n, s);
    case 5: return run_affine<5>(a, ff, live, h0, h, hist, scratch, cap,
                                 rows, n, s);
    case 6: return run_affine<6>(a, ff, live, h0, h, hist, scratch, cap,
                                 rows, n, s);
    case 7: return run_affine<7>(a, ff, live, h0, h, hist, scratch, cap,
                                 rows, n, s);
    case 8: return run_affine<8>(a, ff, live, h0, h, hist, scratch, cap,
                                 rows, n, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

int tuun_affine_deep_tile() { return kDeepTile; }
int tuun_affine_deep_max_j() { return kDeepMaxJ; }

// Words (32-bit) of a deep affine-scan scratch buffer for up to `tiles`
// tiles.
long long tuun_affine_deep_scratch_words(long long tiles) {
  return aff_payload_offset(tiles) + tiles * kDeepRecord;
}

// a f32[rows, n, J], ff f32[rows, n], live u8[rows, n], h0 f32[rows, J]
// (each row-major), kMaxJ < J <= kDeepMaxJ -> y f32[rows, n] (y[r, i] = 0
// on a dead lane), hist f32[rows, J] (the history after lane n - 1), each
// row scanned on its own, in one launch, with the bits a one-row call
// gives.  scratch: the caller's persistent buffer of
// tuun_affine_deep_scratch_words(cap) words for this stream, with counters
// and flags zero, cap >= rows * ceil(n / tuun_affine_deep_tile()) (null
// when n <= one tile); the kernel leaves it so.  Calls that share a
// scratch buffer must not overlap.
int tuun_affine_scan_deep_rows_f32(const float* a, const float* ff,
                                   const uint8_t* live, const float* h0,
                                   float* y, float* hist, unsigned* scratch,
                                   long long cap, long long rows, long long n,
                                   int J, void* stream) {
  if (n <= 0 || n > kMaxN || rows <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (J) {
    case 9: return run_affine_deep<9>(a, ff, live, h0, y, hist, scratch, cap,
                                      rows, n, s);
    case 10: return run_affine_deep<10>(a, ff, live, h0, y, hist, scratch,
                                        cap, rows, n, s);
    case 11: return run_affine_deep<11>(a, ff, live, h0, y, hist, scratch,
                                        cap, rows, n, s);
    case 12: return run_affine_deep<12>(a, ff, live, h0, y, hist, scratch,
                                        cap, rows, n, s);
    case 13: return run_affine_deep<13>(a, ff, live, h0, y, hist, scratch,
                                        cap, rows, n, s);
    case 14: return run_affine_deep<14>(a, ff, live, h0, y, hist, scratch,
                                        cap, rows, n, s);
    case 15: return run_affine_deep<15>(a, ff, live, h0, y, hist, scratch,
                                        cap, rows, n, s);
    case 16: return run_affine_deep<16>(a, ff, live, h0, y, hist, scratch,
                                        cap, rows, n, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"

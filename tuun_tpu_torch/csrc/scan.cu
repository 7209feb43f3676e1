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
// of a single call on row r.  One scratch serves all rows (its status
// slots per row side by side); the tile counter counts every row's tiles.  With
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
// Affine scan (IIR feedback, y_i = ff_i - sum_j a_ij y_{i-1-j} over the
// J-deep history, 1 <= J <= kMaxJ = 8, as composed companion maps): one
// launch per call.  Replaces affine_scan_f32 / _affine_scan_kernel
// (tuun_tpu/engine/pallas_ops.py:301), whose contract returns the J
// planes of h f32[N, J]; the engine reads only h[:, 0] on live lanes and
// the final history, so this kernel returns y f32[N] (0 on a dead lane)
// and hist f32[J], the deep form's contract.  What bounds it on this
// card: HBM bytes, 4J + 9 a lane (a 4J, ff 4 and live 1 read once, y 4
// written once; 1.11 MB at J = 2 and 65536 lanes, 0.333 us at 3.35
// TB/s), and below ~2^20 lanes the latency of the chain in a block: the
// loads, the map arithmetic, one look-back, the store.  The per-thread
// register-map kernel it replaced spent 29% of a 65536-lane block in its
// loads and 45% in its look-back (affine_probe.py split), held J^2 + J
// floats a thread (spilling at J = 8) and left 100 of 132 SMs idle at the
// CLI's block.  The design:
//   * a block of 4 warps scans a tile of 8 segments of kAffSeg = 32 lanes
//     a warp, 1024 lanes: 64 blocks at the CLI's 65536-lane block, and a
//     live 1024-lane row fills one.  8 warps were 1-10% faster at 2^20
//     lanes and at 4 rows of 65536, slower elsewhere, 2 warps slower at
//     every shape (affine_probe.py sweep); a fixed tile keeps the tile
//     count monotone in n;
//   * each segment's quad of threads loads its a and ff (16-byte loads,
//     evict-first) into padded rows; a ragged or misaligned tile takes
//     scalar loads.  Bulk asynchronous copies (TMA) were 0.5-4.3 us slower
//     at every shape measured (affine_probe.py sweep);
//   * no thread holds a map.  A segment's map (A J x J, b J) is built
//     column by column by its quad: column c < J pushes the basis history
//     e_c through the segment with ff = 0, column J pushes ff from a zero
//     history, each thread holding at most three J-float histories, a
//     quarter's inputs read into registers first.  Maps live in shared
//     memory, column by column (deep_col), and the columns after each
//     quarter of the segment are kept as the quarters' maps;
//   * each warp scans its eight segment maps (Kogge-Stone, inclusive),
//     warp 0 scans the warp totals; the last is the tile's map;
//   * look-back over a tree of records, with no chain of anchors: record
//     (l, k) is the map of tiles [k fan^l, (k + 1) fan^l), published once
//     by the tile (k + 1) fan^l - 1, which composes its own map with the
//     folds of the levels below.  Tile t reads level l's records t_l - d_l
//     .. t_l - 1 (t_l = t / fan^l, d_l its base-fan digit), at most fan -
//     1 a level over ~log_fan(tiles) levels, folds them by an up-sweep
//     (16 maps a warp, then warp 0) and applies the folds to h0, the
//     earliest first.  A record's words carry the stamp of the call that
//     wrote them beside each value, so a reader polls the words themselves:
//     no flag, no fence, one trip to L2.  The grouping is fixed, so a call
//     gives the same bits every time, and no tile waits on more than
//     levels hops;
//   * each thread's quarter segment enters with the tile's history with
//     the scanned maps of the warps before, of the warp's segments before
//     and of the segment's quarters before applied in turn; it runs the
//     recurrence itself over its 8 lanes in the reference's op order and
//     writes y over ff in shared memory; y goes out coalesced.  Composed
//     maps only carry the history across quarters, segments and tiles.
//     The thread whose quarter holds lane n - 1 writes hist;
//   * the scratch is the caller's persistent buffer for its (device,
//     stream), tuun_affine_scratch_words(cap) words for up to cap records
//     (tuun_affine_slots a row), each sized for kMaxJ, zeroed once.  The
//     block that draws the last tile from the counter resets it and
//     advances the epoch that stamps the next call's records: no memset,
//     and stale records never match;
//   * N <= one tile skips the counter and the look-back.
// Tensor cores do not serve: the maps are composed in float32, and TF32
// products would lose the digits AFFINE_TOL holds.
//
// Deep affine scan (the same IIR at 8 < J <= kDeepMaxJ = 16), fast mode's
// feedback past the affine scan's kMaxJ, with its contract (y and the
// final history).  What bounds it on this card: HBM bytes, 4J + 9 a lane (a 4J, ff 4, live 1
// read once, y 4 written once; 2.86 us at J = 16 and 2^17 lanes), then the
// chains of dependent operations in a tile.  No thread holds a map (the
// first J <= 8 kernel kept 2 (J^2 + J) floats a thread in registers, which
// spilled from J = 7):
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
//   * look-back in a fixed grouping: every
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
// Shared by the affine scans: the scratch's head and flags, padded rows, and
// the acquire / release operations of their look-backs.
// ---------------------------------------------------------------------------
//
// Lane i is the companion-form map of y[i] = ff[i] - sum_j a[i,j] y[i-1-j]
// (row 0 = -a[i,:], rows 1.. shift the history down; b = (ff[i], 0, ...)),
// or the identity on a dead lane; the history after lane i is (y[i],
// y[i-1], ..., y[i-J+1]).

constexpr int kMaxJ = 8;

// Scratch, in 32-bit words, for a capacity of `cap` records: [0] tile
// counter, [1] done counter, [2, 2 + cap) one flag per record, then from
// aff_payload_offset(cap) the records.  Only the counters and flags must
// be zero when a call starts.
constexpr int kAffHead = 2;
constexpr unsigned kAffNotReady = 0;
constexpr unsigned kAffAggregate = 1;  // the record holds a map
constexpr unsigned kAffHistory = 2;    // the record holds an exit history

__host__ __device__ constexpr int64_t aff_payload_offset(int64_t cap) {
  return (kAffHead + cap + 3) / 4 * 4;
}

// Shared-memory row of `floats` floats, padded so that the row stride is
// an odd number of float4s: a warp's float4 reads of one offset in
// consecutive rows are then free of bank conflicts, and every row stays
// 16-byte aligned.
__host__ __device__ constexpr int aff_row(int floats) {
  return (floats / 4) % 2 ? floats : floats + 4;
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


// ---------------------------------------------------------------------------
// Affine scan: the IIR at J <= kMaxJ, segment maps built column by column.
// ---------------------------------------------------------------------------

constexpr int kAffSeg = 32;                    // lanes a segment
constexpr int kAffQuad = 4;                    // threads a segment
constexpr int kAffQuarter = kAffSeg / kAffQuad;  // lanes a thread's recurrence
constexpr int kAffSegsPerWarp = 32 / kAffQuad;   // 8
constexpr int kAffWarps = 4;
constexpr int kAffThreads = 32 * kAffWarps;
constexpr int kAffSegs = kAffSegsPerWarp * kAffWarps;  // 32
constexpr int kAffTile = kAffSeg * kAffSegs;           // 1024 lanes
// The look-back's fan: a power of two in this range (a level folds at most
// fan - 1 records, one flag a thread).
constexpr int kAffMinFan = 16;
constexpr int kAffMaxFan = 64;
// Levels of the record tree: base-16 digits of a tile index (< 2^31).
constexpr int kAffMaxLevels = 8;
// Scratch, in 32-bit words: [0, 2) the tile counter (low half) and the
// call's epoch (high half) as one 64-bit word, then from word kAffHeadWords
// one record a slot of kAffRecord 64-bit words.  A record word is a map's
// value (low half) with the stamp of the call that wrote it (high half),
// so a reader that sees the stamp of its own call sees the value: no flag,
// no fence, one trip to L2 a word.
constexpr int kAffHeadWords = 4;
constexpr int kAffRecord = kMaxJ * (kMaxJ + 1);  // A and b at kMaxJ
// 64-bit words a thread polls at once in a look-back.
constexpr int kAffPollBatch = 8;
// Maps a warp folds on its own in a look-back.
constexpr int kAffFoldGroup = 16;
// Grids past this many tiles prefetch a block's likely tile into L2 while
// its tile counter answers: 0.7-1.2 us saved at 1024 tiles and more, 0.1-
// 0.4 us lost at 64-256 (affine_probe.py sweep).
constexpr int64_t kAffPrefetchTiles = 256;
static_assert(kAffSeg % (4 * kAffQuad) == 0, "quarters of whole float4s");
static_assert(kAffMaxFan <= kAffThreads, "a thread a look-back's record");

// Records of one row at `tiles` tiles: level l holds tiles / fan^l (fan =
// 2^fan_bits).
__host__ __device__ inline int64_t aff_slots(int64_t tiles, int fan_bits) {
  int64_t total = 0;
  for (int64_t c = tiles; c > 0; c >>= fan_bits) total += c;
  return total;
}

__host__ __device__ inline int aff_log2(int fan) {
  int bits = 0;
  while ((1 << bits) < fan) ++bits;
  return bits;
}

// Shared-memory layout of a block at J and fan, in floats; every region
// starts on a 16-byte boundary.
template <int J>
struct AffLayout {
  static constexpr int kJp = deep_col(J);
  static constexpr int kMap = (J + 1) * kJp;  // columns 0..J-1: A; J: b
  static constexpr int kSegA = aff_row(kAffSeg * J);  // a segment's a
  static constexpr int kSegF = aff_row(kAffSeg);      // its ff, then y
  static constexpr int kA = 0;
  static constexpr int kF = kA + kAffSegs * kSegA;
  static constexpr int kMaps = kF + kAffSegs * kSegF;    // segment maps
  static constexpr int kCk = kMaps + kAffSegs * kMap;    // quarter maps
  static constexpr int kWt = kCk + kAffSegs * (kAffQuad - 1) * kMap;
  static constexpr int kLb = kWt + kAffWarps * kMap;     // a look-back level
  // Then fan maps of lb, the level folds and R, R' (xl), the live bytes.
  __host__ __device__ static int xl(int fan) { return kLb + fan * kMap; }
  __host__ __device__ static int live(int fan) {
    return xl(fan) + (kAffMaxLevels + 2) * kMap;
  }
  __host__ __device__ static size_t bytes(int fan) {
    return sizeof(float) * (size_t)live(fan) + kAffTile;
  }
};

// Kogge-Stone inclusive scan of maps[0 .. count) in place by the calling
// warp: at width d, map s >= d becomes "s after s - d"; map s then holds
// the fold of maps 0..s, the first applied first.  One lane an output
// column; every column is read before any is written.
template <int J, int kMaxCount>
__device__ void aff_scan(float* maps, int count, int lane) {
  constexpr int kMap = AffLayout<J>::kMap;
  constexpr int kRounds = ((kMaxCount - 1) * (J + 1) + 31) / 32;
  for (int d = 1; d < count; d <<= 1) {
    const int tasks = (count - d) * (J + 1);
    float out[kRounds][J];
#pragma unroll
    for (int u = 0; u < kRounds; ++u) {
      const int e = lane + 32 * u;
      if (e < tasks) {
        const int m = d + e / (J + 1), c = e % (J + 1);
        deep_compose_column<J>(maps + m * kMap, maps + (m - d) * kMap, c,
                               out[u]);
      }
    }
    __syncwarp();
#pragma unroll
    for (int u = 0; u < kRounds; ++u) {
      const int e = lane + 32 * u;
      if (e < tasks) {
        const int m = d + e / (J + 1), c = e % (J + 1);
        float* col = maps + m * kMap + c * AffLayout<J>::kJp;
#pragma unroll
        for (int i = 0; i < J; ++i) col[i] = out[u][i];
      }
    }
    __syncwarp();
  }
}

// Levels d in [d0, d1) of a Blelloch up-sweep of maps[0 .. count) (count a
// power of two) in place by the calling warp: map R = (2p + 2) d - 1
// becomes "R after R - d"; after every level below count, map count - 1
// holds the fold of all, the first applied first.  One lane an output
// column, at most kMaxTasks columns a level; every column is read before
// any is written.
template <int J, int kMaxTasks>
__device__ void aff_up_sweep(float* maps, int count, int d0, int d1,
                             int lane) {
  constexpr int kMap = AffLayout<J>::kMap;
  constexpr int kRounds = (kMaxTasks + 31) / 32;
  for (int d = d0; d < d1; d <<= 1) {
    const int tasks = count / (2 * d) * (J + 1);
    float out[kRounds][J];
#pragma unroll
    for (int u = 0; u < kRounds; ++u) {
      const int e = lane + 32 * u;
      if (e < tasks) {
        const int p = e / (J + 1), c = e - p * (J + 1);
        const int R = (2 * p + 2) * d - 1;
        deep_compose_column<J>(maps + R * kMap, maps + (R - d) * kMap, c,
                               out[u]);
      }
    }
    __syncwarp();
#pragma unroll
    for (int u = 0; u < kRounds; ++u) {
      const int e = lane + 32 * u;
      if (e < tasks) {
        const int p = e / (J + 1), c = e - p * (J + 1);
        const int R = (2 * p + 2) * d - 1;
        float* col = maps + R * kMap + c * AffLayout<J>::kJp;
#pragma unroll
        for (int i = 0; i < J; ++i) col[i] = out[u][i];
      }
    }
    __syncwarp();
  }
}

// The fold of `count` maps (a power of two <= kAffMaxFan) by the block: its
// levels below kAffFoldGroup in groups of that many maps, a warp a group,
// then the rest by warp 0; map count - 1 holds the fold, the first map
// applied first (the up-sweep's grouping).
template <int J>
__device__ void aff_fold(float* maps, int count) {
  constexpr int kMap = AffLayout<J>::kMap;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int group = count < kAffFoldGroup ? count : kAffFoldGroup;
  for (int g = warp; g < count / group; g += kAffWarps) {
    aff_up_sweep<J, kAffFoldGroup / 2 * (J + 1)>(maps + g * group * kMap,
                                                 group, 1, group, lane);
  }
  __syncthreads();
  if (warp == 0) {
    aff_up_sweep<J, kAffMaxFan / (2 * kAffFoldGroup) * (J + 1)>(
        maps, count, group, count, lane);
  }
  __syncthreads();
}

// h <- m(h) in place, every row in this thread, each row's products in
// order (the same bits wherever a map meets a history).
template <int J>
__device__ __forceinline__ void aff_apply(const float* m, float* h) {
  constexpr int Jp = AffLayout<J>::kJp;
  float out[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    float acc = m[J * Jp + j];
#pragma unroll
    for (int c = 0; c < J; ++c) acc = __fmaf_rn(m[c * Jp + j], h[c], acc);
    out[j] = acc;
  }
#pragma unroll
  for (int j = 0; j < J; ++j) h[j] = out[j];
}

__device__ __forceinline__ unsigned long long load_word(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_word(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" :: "l"(p));
}

// One launch: for each of `rows` rows, y f32[n] (0 on a dead lane) and hist
// f32[J] (the history after lane n - 1) from a f32[n, J], ff f32[n], live
// u8[n] and h0 f32[J] (row r of each at r times its row's size).  A block
// scans a tile of kAffSegs segments of kAffSeg lanes.
// Tiles never cross a row; the look-back reads only its own row's records,
// in a single row's grouping, so row r gives the bits of a one-row call on
// it.  kRows = false is the one-row form, compiled without the row
// arithmetic.
template <int J, bool kRows>
__global__ void __launch_bounds__(kAffThreads)
affine_scan_pass(const float* __restrict__ a_all,
                 const float* __restrict__ ff_all,
                 const uint8_t* __restrict__ live_all,
                 const float* __restrict__ h0_all, float* __restrict__ y_all,
                 float* __restrict__ hist_all, unsigned* scratch, int64_t cap,
                 int64_t rows, int64_t n, int fan) {
  using L = AffLayout<J>;
  constexpr int Jp = L::kJp, kMap = L::kMap;
  extern __shared__ __align__(16) float aff_smem[];
  __shared__ unsigned tile_index, call_stamp;
  __shared__ float h_tile[J];
  float* a_s = aff_smem + L::kA;
  float* f_s = aff_smem + L::kF;
  float* maps = aff_smem + L::kMaps;
  float* ck = aff_smem + L::kCk;
  float* wt = aff_smem + L::kWt;
  float* lb = aff_smem + L::kLb;
  float* xl = aff_smem + L::xl(fan);
  uint8_t* live_s = reinterpret_cast<uint8_t*>(aff_smem + L::live(fan));

  constexpr int tile = kAffTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t nbr = (n + tile - 1) / tile;  // tiles per row
  const int64_t nb = kRows ? rows * nbr : nbr;
  int64_t gt = blockIdx.x;
  if (nbr > 1) {
    // The tile comes from the counter; the block that draws the last one
    // knows every block has drawn, and readies the scratch for the next
    // call: the counter back to zero, the epoch advanced.
    unsigned long long* head = reinterpret_cast<unsigned long long*>(scratch);
    if (threadIdx.x == 0) {
      const unsigned long long old = atomicAdd(head, 1ull);
      tile_index = (unsigned)old;
      call_stamp = 2u * (unsigned)(old >> 32) + 1u;  // never 0
      if ((unsigned)old == (unsigned)(nb - 1)) {
        *head = ((old >> 32) + 1ull) << 32;
      }
    }
    // While the counter answers, bring tile blockIdx.x (the tile a block
    // most often draws) towards L2, when the grid is more than
    // kAffPrefetchTiles tiles.
    if (nb > kAffPrefetchTiles) {
      const int64_t r0 = kRows ? (int64_t)((unsigned)gt / (unsigned)nbr) : 0;
      const int64_t b0 = r0 * n + (gt - r0 * nbr) * tile;
      const int64_t left = n * (r0 + 1) - b0;
      const int lanes = left < tile ? (int)left : tile;
      for (int v = threadIdx.x; v < lanes * J / 32; v += kAffThreads) {
        prefetch_l2(a_all + b0 * J + 32 * v);
      }
      for (int v = threadIdx.x; v < lanes / 32; v += kAffThreads) {
        prefetch_l2(ff_all + b0 + 32 * v);
      }
    }
    __syncthreads();
    gt = (int64_t)tile_index;
  }
  // A 32-bit division (nb < 2^31), cheaper than a 64-bit one.
  const int64_t r = kRows ? (int64_t)((unsigned)gt / (unsigned)nbr) : 0;
  const int64_t t = gt - r * nbr;
  const int64_t base = t * tile;
  const float* __restrict__ a = a_all + (r * n + base) * J;
  const float* __restrict__ ff = ff_all + r * n + base;
  const uint8_t* __restrict__ live = live_all + r * n + base;
  const float* __restrict__ h0 = h0_all + r * J;
  float* __restrict__ y = y_all + r * n + base;
  float* __restrict__ hist = hist_all + r * J;
  const int fan_bits = aff_log2(fan);
  const int64_t per_row = aff_slots(nbr, fan_bits);
  unsigned long long* records =
      reinterpret_cast<unsigned long long*>(scratch + kAffHeadWords) +
      r * per_row * kAffRecord;
  const int64_t avail = n - base < tile ? n - base : tile;
  const bool whole = avail == tile;

  // Load the tile into padded segment rows: segment s by its quad's four
  // threads (16-byte loads, evict-first), the live bytes by the block;
  // scalars past n or off a 16-byte boundary.
  const int s = threadIdx.x / kAffQuad, q = threadIdx.x % kAffQuad;
  float* __restrict__ as = a_s + s * L::kSegA;
  float* __restrict__ fs = f_s + s * L::kSegF;
  const uint8_t* __restrict__ ls = live_s + s * kAffSeg;
  if (whole && (((uintptr_t)a | (uintptr_t)ff | (uintptr_t)live) & 15) == 0) {
    const float4* a4 = reinterpret_cast<const float4*>(a + s * kAffSeg * J);
#pragma unroll
    for (int v = q; v < kAffSeg * J / 4; v += kAffQuad) {
      reinterpret_cast<float4*>(as)[v] = __ldcs(a4 + v);
    }
    const float4* f4 = reinterpret_cast<const float4*>(ff + s * kAffSeg);
#pragma unroll
    for (int v = q; v < kAffSeg / 4; v += kAffQuad) {
      reinterpret_cast<float4*>(fs)[v] = __ldcs(f4 + v);
    }
    const uint4* l4 = reinterpret_cast<const uint4*>(live);
    for (int v = threadIdx.x; v < tile / 16; v += kAffThreads) {
      reinterpret_cast<uint4*>(live_s)[v] = __ldcs(l4 + v);
    }
  } else {
    for (int e = threadIdx.x; e < tile * J; e += kAffThreads) {
      a_s[e / (kAffSeg * J) * L::kSegA + e % (kAffSeg * J)] =
          e < avail * J ? a[e] : 0.0f;
    }
    for (int e = threadIdx.x; e < tile; e += kAffThreads) {
      f_s[e / kAffSeg * L::kSegF + e % kAffSeg] = e < avail ? ff[e] : 0.0f;
      live_s[e] = e < avail ? live[e] : 0;
    }
  }
  __syncthreads();

  // Segment s's map, column by column: quad thread q pushes columns q, q +
  // 4 and q + 8 (those <= J) through the segment's lanes.  Column c < J
  // starts from the basis history e_c with ff = 0, column J from a zero
  // history with ff; a column's history after the segment is that column
  // of the map.  After each quarter the columns are kept too: the maps
  // that carry a quarter's entering history.  Four partial sums shorten
  // each chain: a map only carries the history, so its order of rounding
  // is free (and fixed: the same bits every call).  A quarter's inputs are
  // read into registers first.
  {
    constexpr int kCols = (J + kAffQuad) / kAffQuad;
    float hc[kCols][J];
#pragma unroll
    for (int u = 0; u < kCols; ++u) {
#pragma unroll
      for (int j = 0; j < J; ++j) hc[u][j] = q + kAffQuad * u == j ? 1.0f : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < kAffQuad; ++k) {
      float av[kAffQuarter][J], fv[kAffQuarter];
      bool lv[kAffQuarter];
#pragma unroll
      for (int x = 0; x < kAffQuarter; ++x) {
        const int i = k * kAffQuarter + x;
#pragma unroll
        for (int j = 0; j < J; ++j) av[x][j] = as[i * J + j];
        fv[x] = fs[i];
        lv[x] = ls[i] != 0;
      }
#pragma unroll
      for (int x = 0; x < kAffQuarter; ++x) {
#pragma unroll
        for (int u = 0; u < kCols; ++u) {
          float p[4] = {q + kAffQuad * u == J ? fv[x] : 0.0f, 0.0f, 0.0f,
                        0.0f};
#pragma unroll
          for (int j = 0; j < J; ++j) p[j & 3] -= av[x][j] * hc[u][j];
          const float yv = (p[0] + p[1]) + (p[2] + p[3]);
#pragma unroll
          for (int j = J - 1; j >= 1; --j) hc[u][j] = lv[x] ? hc[u][j - 1] : hc[u][j];
          hc[u][0] = lv[x] ? yv : hc[u][0];
        }
      }
      float* m = k + 1 < kAffQuad ? ck + (s * (kAffQuad - 1) + k) * kMap
                                  : maps + s * kMap;
#pragma unroll
      for (int u = 0; u < kCols; ++u) {
        const int c = q + kAffQuad * u;
        if (c <= J) {
#pragma unroll
          for (int j = 0; j < J; ++j) m[c * Jp + j] = hc[u][j];
        }
      }
    }
  }
  // Each warp scans its eight segment maps (inclusive, from the warp's
  // first), then warp 0 scans the warp totals: the last is the tile's map.
  // Segment s's entering history is then its warp's entering one with the
  // prefix of the warp's segments before s applied.
  __syncwarp();
  aff_scan<J, kAffSegsPerWarp>(maps + warp * kAffSegsPerWarp * kMap,
                               kAffSegsPerWarp, lane);
  for (int v = lane; v < kMap; v += 32) {
    wt[warp * kMap + v] = maps[(warp * kAffSegsPerWarp + 7) * kMap + v];
  }
  __syncthreads();
  if (warp == 0) aff_scan<J, kAffWarps>(wt, kAffWarps, lane);
  const float* total = wt + (kAffWarps - 1) * kMap;

  // The history entering the tile.  Fixed grouping over a tree of records
  // with `fan` children: record (l, k) is the map of tiles [k fan^l, (k +
  // 1) fan^l), at slot off_l + k of the row (off_0 = 0, off_{l+1} = off_l
  // + nbr / fan^l).  With t's base-fan digits d_l, the tiles before t are
  // level l's records t_l - d_l .. t_l - 1 (t_l = t / fan^l) over every
  // level, so a look-back folds at most fan - 1 records a level and waits
  // on no chain: a record (l, k) is published by tile (k + 1) fan^l - 1,
  // which composes its own map with the folds of the levels below.  A
  // level's records are copied in from L2 by the threads that waited for
  // them and folded by an up-sweep; the folds are then applied to h0, the
  // highest level first.
  if (nbr > 1) {
    // R: the map the tile publishes, composed in turn into xl's last two
    // slots.
    const float* R = total;
    float* next = xl + kAffMaxLevels * kMap;
    bool chain = true;  // R is the map of the tiles of record (l, t_l)
    int64_t tl = t, off = 0, count = nbr;
    int levels = 0;
    for (int l = 0; tl > 0 || chain; ++l) {
      const int d = (int)(tl & (fan - 1));
      if (chain && d != fan - 1) {
        // R is record (l, t_l): published at once (the level's fold is not
        // part of it) unless no tile reads it: every later tile does.  The
        // release orders the thread's own writes of the record.
        chain = false;
        if (t + 1 < nbr && warp == 0) {
          unsigned long long* rec = records + (off + tl) * kAffRecord;
          const unsigned long long stamp = (unsigned long long)call_stamp << 32;
          for (int e = lane; e < J * (J + 1); e += 32) {
            store_word(rec + e, stamp | __float_as_uint(R[e / J * Jp + e % J]));
          }
        }
      }
      float* X = xl + l * kMap;
      if (d > 0) {
        int P = 1;
        while (P < d) P <<= 1;
        // The level's d records, word by word: each thread polls its
        // share, kAffPollBatch words at a time, until every word carries
        // this call's stamp (each warp spinning as one), and writes the
        // values into slots P - d .. P - 1; identity maps fill the slots
        // before.
        constexpr int W = J * (J + 1);
        const unsigned long long* src = records + (off + tl - d) * kAffRecord;
        for (int first = 0; first < d * W;
             first += kAffThreads * kAffPollBatch) {
          unsigned long long w[kAffPollBatch];
          bool ok = true;
#pragma unroll
          for (int b = 0; b < kAffPollBatch; ++b) {
            const int x = first + b * kAffThreads + threadIdx.x;
            w[b] = x < d * W ? load_word(src + x / W * kAffRecord + x % W)
                             : 0ull;
          }
          do {
            ok = true;
#pragma unroll
            for (int b = 0; b < kAffPollBatch; ++b) {
              const int x = first + b * kAffThreads + threadIdx.x;
              if (x < d * W && (unsigned)(w[b] >> 32) != call_stamp) {
                w[b] = load_word(src + x / W * kAffRecord + x % W);
                ok = false;
              }
            }
          } while (__any_sync(kFull, !ok));
#pragma unroll
          for (int b = 0; b < kAffPollBatch; ++b) {
            const int x = first + b * kAffThreads + threadIdx.x;
            if (x < d * W) {
              const int k = x / W, e = x % W;
              lb[(P - d + k) * kMap + e / J * Jp + e % J] =
                  __uint_as_float((unsigned)w[b]);
            }
          }
        }
        for (int e = threadIdx.x; e < P - d; e += kAffThreads) {
          float* dst = lb + e * kMap;
#pragma unroll
          for (int c = 0; c <= J; ++c) {
#pragma unroll
            for (int i = 0; i < Jp; ++i) {
              dst[c * Jp + i] = c < J && c == i ? 1.0f : 0.0f;
            }
          }
        }
        __syncthreads();
        aff_fold<J>(lb, P);
        for (int v = threadIdx.x; v < kMap; v += kAffThreads) {
          X[v] = lb[(P - 1) * kMap + v];
        }
        __syncthreads();
      }
      if (chain) {  // d == fan - 1: R after the level's fold
        if (threadIdx.x <= J) {
          float col[J];
          deep_compose_column<J>(R, X, threadIdx.x, col);
#pragma unroll
          for (int i = 0; i < J; ++i) next[threadIdx.x * Jp + i] = col[i];
        }
        __syncthreads();
        R = next;
        next = next == xl + kAffMaxLevels * kMap ? next + kMap : next - kMap;
      }
      off += count;
      count >>= fan_bits;
      tl >>= fan_bits;
      levels = l + 1;
    }
    if (warp == 0) {
      // The folds applied to h0, the earliest tiles' first: row i of the
      // history in lane i.
      const int i = lane < J ? lane : 0;
      float h = h0[i];
      for (int l = levels - 1; l >= 0; --l) {
        if ((t >> (l * fan_bits)) & (fan - 1)) {
          h = deep_apply_lane<J>(xl + l * kMap, h, i);
        }
      }
      if (lane < J) h_tile[lane] = h;
    }
  } else if (threadIdx.x < J) {
    h_tile[threadIdx.x] = h0[threadIdx.x];
  }
  __syncthreads();
  // The recurrence over each quarter segment from its entering history:
  // the tile's, then the warps before (their scanned total), the warp's
  // segments before s (their scanned map) and the quarters before q in
  // the segment (its quarter map) applied in turn.  It runs in the
  // reference's op order (y = ff - sum_j a_j y_{-1-j}); y overwrites ff.
  // The thread whose quarter holds lane n - 1 writes hist: past it, lanes
  // are dead.
  {
    float h[J];
#pragma unroll
    for (int j = 0; j < J; ++j) h[j] = h_tile[j];
    if (warp > 0) aff_apply<J>(wt + (warp - 1) * kMap, h);
    if (s % kAffSegsPerWarp > 0) aff_apply<J>(maps + (s - 1) * kMap, h);
    if (q > 0) aff_apply<J>(ck + (s * (kAffQuad - 1) + q - 1) * kMap, h);
    const int i0 = q * kAffQuarter;
    float yq[kAffQuarter];
#pragma unroll
    for (int x = 0; x < kAffQuarter; ++x) {
      const int i = i0 + x;
      const bool lv = ls[i] != 0;
      float yv = fs[i];
#pragma unroll
      for (int j = 0; j < J; ++j) yv -= as[i * J + j] * h[j];
#pragma unroll
      for (int j = J - 1; j >= 1; --j) h[j] = lv ? h[j - 1] : h[j];
      h[0] = lv ? yv : h[0];
      yq[x] = lv ? yv : 0.0f;
    }
#pragma unroll
    for (int x = 0; x < kAffQuarter; x += 4) {
      reinterpret_cast<float4*>(fs + i0)[x / 4] =
          make_float4(yq[x], yq[x + 1], yq[x + 2], yq[x + 3]);
    }
    const int64_t first = (int64_t)s * kAffSeg + i0;
    if (first < avail && avail <= first + kAffQuarter && base + avail == n) {
#pragma unroll
      for (int j = 0; j < J; ++j) hist[j] = h[j];
    }
  }
  __syncthreads();

  // Store from the padded segment rows: segment s by its quad.
  if (whole && ((uintptr_t)y & 15) == 0) {
    float4* y4 = reinterpret_cast<float4*>(y + s * kAffSeg);
#pragma unroll
    for (int v = q; v < kAffSeg / 4; v += kAffQuad) {
      y4[v] = reinterpret_cast<const float4*>(fs)[v];
    }
  } else {
    for (int e = threadIdx.x; e < avail; e += kAffThreads) {
      y[e] = f_s[e / kAffSeg * L::kSegF + e % kAffSeg];
    }
  }
}

template <int J>
int run_affine(const float* a, const float* ff, const uint8_t* live,
               const float* h0, float* y, float* hist, unsigned* scratch,
               int64_t cap, int64_t rows, int64_t n, int fan,
               cudaStream_t stream) {
  if (fan < kAffMinFan || fan > kAffMaxFan || (fan & (fan - 1))) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t nbr = (n + kAffTile - 1) / kAffTile;
  const int64_t nb = rows * nbr;
  if (nb > kMaxN || (nbr > 1 && (scratch == nullptr ||
                                 rows * aff_slots(nbr, aff_log2(fan)) >
                                     cap))) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = AffLayout<J>::bytes(fan);
  auto kernel = rows == 1 ? affine_scan_pass<J, false>
                          : affine_scan_pass<J, true>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<(unsigned)nb, kAffThreads, smem, stream>>>(
      a, ff, live, h0, y, hist, scratch, cap, rows, n, fan);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int tuun_scan_tile() { return kScanTile; }
long long tuun_scan_scratch_words() { return kScratchWords; }
int tuun_affine_max_j() { return kMaxJ; }
int tuun_affine_tile() { return kAffTile; }

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

// Records a row of n lanes takes at look-back fan `fan` (the kernel's
// aff_slots; scan_ops mirrors it).
long long tuun_affine_slots(long long n, int fan) {
  return aff_slots((n + kAffTile - 1) / kAffTile, aff_log2(fan));
}

// Words (32-bit) of an affine-scan scratch buffer for up to `slots`
// records.
long long tuun_affine_scratch_words(long long slots) {
  return kAffHeadWords + 2 * kAffRecord * slots;
}

// a f32[rows, n, J], ff f32[rows, n], live u8[rows, n], h0 f32[rows, J]
// (each row-major), 1 <= J <= kMaxJ -> y f32[rows, n] (y[r, i] = 0 on a
// dead lane), hist f32[rows, J] (the history after lane n - 1), each row
// scanned on its own, in one launch, with the bits a one-row call gives.
// A block scans a tile of tuun_affine_tile() lanes; the look-back folds
// records in groups of `fan` (16, 32 or 64).  scratch: the caller's
// persistent buffer of tuun_affine_scratch_words(cap) words for this
// stream, zeroed when made, cap >= rows * tuun_affine_slots(n, fan) (null
// when n <= one tile); the kernel leaves it ready for the next call.  Calls that share a scratch
// buffer must not overlap.
int tuun_affine_scan_rows_f32(const float* a, const float* ff,
                              const uint8_t* live, const float* h0, float* y,
                              float* hist, unsigned* scratch, long long cap,
                              long long rows, long long n, int J, int fan,
                              void* stream) {
  if (n <= 0 || n > kMaxN || rows <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (J) {
#define TUUN_AFFINE_CASE(j)                                                 \
    case j: return run_affine<j>(a, ff, live, h0, y, hist, scratch, cap,   \
                                 rows, n, fan, s);
    TUUN_AFFINE_CASE(1) TUUN_AFFINE_CASE(2) TUUN_AFFINE_CASE(3)
    TUUN_AFFINE_CASE(4) TUUN_AFFINE_CASE(5) TUUN_AFFINE_CASE(6)
    TUUN_AFFINE_CASE(7) TUUN_AFFINE_CASE(8)
#undef TUUN_AFFINE_CASE
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

// Cross-lane scans of the render engine, written by hand for Hopper (sm_90a).
//
// Three entry points, each the counterpart of one Pallas TPU kernel in
// tuun_tpu/engine/pallas_ops.py and each one kernel launch per call:
//
//   tuun_prefix_sum_rows_f32   <- prefix_sum_f32 / _prefix_sum_kernel
//   tuun_prefix_max_rows_f32   <- prefix_max_f32 / _prefix_max_kernel
//   tuun_affine_scan_rows_f32  <- affine_scan_f32 / _affine_scan_kernel
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

}  // extern "C"

// The exact precisions' two kernels, written by hand for Hopper (sm_90a).
//
//   tuun_linear_recurrence_rows_{f32,f64}  <- the exact-mode IIR, a
//       jax.lax.scan in tuun_tpu/engine/graph.py:852-864 (CFilter._feedback
//       with sequential_iir: precision "exact" and "exact_df")
//   tuun_df_prefix_sum_rows_f32            <- df32.df_cumsum, a
//       jax.lax.associative_scan of df_add over (hi, lo) pairs in
//       tuun_tpu/engine/df32.py:118-130 (CSine's phase in "exact_df")
//
// Neither replaces a Pallas kernel: on the TPU both ran as XLA scans.
// Each is one launch per call, on B rows of n lanes (voices x lanes, one
// row per voice of a tracker group; a single voice is the one-row call),
// and allocates nothing: the caller passes outputs and scratch.
//
// Linear recurrence.  Each row runs
//     acc = ff[i];  acc = acc - a[i, j] * h[j]  for j = 0 .. J-1;
//     y[i] = live[i] ? acc : 0;  h <- live[i] ? (acc, h[0 .. J-2]) : h
// lane after lane, with h[j] = y[i-1-j] and h = h0 on entry: the
// reference's op order (oracle.py:330-337, generator.rs's filter loop),
// which the reference defines only sequentially.  No reassociation is
// allowed, so a row is one dependent chain of J + 1 roundings a lane
// (the product with h[0] = y[i-1], then J differences).  What bounds it
// on this card: that chain's latency, n (J + 1) dependent operations a
// row, far above the bytes (4J + 9 a lane in f32, read once and written
// once; 8J + 17 in f64) at the main path's shapes.  The design:
//   * one block a row; thread 0 runs the row's chain alone, from shared
//     memory, with the history in registers (J <= 16, a template per J:
//     fast mode's filters deeper than the affine scan's 8 run here too) or
//     in a ring in shared memory (any larger J); with the history in
//     registers, it reads a group of lanes' inputs into registers before
//     the group's chain, so no shared-memory load sits on the chain;
//   * the other warps stage the next tile of a, ff and live into shared
//     memory (cp.async, all copies in flight at once) and write the last
//     tile's y back, coalesced, while thread 0 works on the current one
//     (double buffering), so the chain never waits on device memory;
//   * every product and difference is an intrinsic that rounds on its own
//     (__fmul_rn / __fsub_rn, __dmul_rn / __dsub_rn): nvcc contracts
//     a*b + c into a fused multiply-add by default, which would round once
//     where the reference rounds twice.  So y has the bits of the plain
//     version (scan_ops.linear_recurrence_ref) in both types;
//   * no scratch: rows share nothing, so a captured CUDA graph needs no
//     set-up either.
// Measured on an H100 (700 W, PERF.md): 2.76 ms at 2^17 lanes, J = 2, in
// f32 (3.52 ms in f64), 3.5x (2.2x) a model of the chain at 4 (8) cycles
// an operation; reading each group's inputs into registers first took
// 1.5x off.
//
// df prefix sum.  Inclusive prefix of df_add over (hi, lo) pairs along
// each row: the same single-pass scan with decoupled look-back as
// scan.cu's prefix sum (scan_single_pass), over pairs.  What bounds it:
// bytes, 16 a lane (two floats read, two written; 1 MB at 65536 lanes,
// 0.31 us at 3.35 TB/s), and below ~2^20 lanes launch latency and the
// chain of memory trips of the look-back.  The design follows scan.cu's:
//   * one kernel, tile index from an atomic counter, 256 threads x 8
//     lanes a tile, each thread folds its lanes in sequence, a shuffle
//     scan across the block (hi and lo shuffled as a pair);
//   * status: a pair and a flag do not fit in one 64-bit word, so each
//     tile has a flag word and a record of two floats; a tile writes its
//     record, then the flag with st.release; a reader loads the flag with
//     ld.acquire and only then the record, from L2 (ld.cg), as scan.cu's
//     affine scan does;
//   * fixed grouping, so a call gives the same bits every time: every
//     256th tile is an anchor and publishes its inclusive prefix, every
//     other tile its aggregate at once; tile t folds anchor a's prefix
//     and the aggregates of a + 1 .. t - 1 by a fixed shuffle tree.
//     df_add is not associative, so these bits differ from XLA's
//     associative_scan and from the plain doubling scan in the last
//     compensated bits; each is held to the float64 cumsum;
//   * df_add's additions are __fadd_rn / __fsub_rn: TwoSum's error term
//     is exact only if each rounds on its own;
//   * the scratch (counters, flags, records) is the caller's persistent
//     buffer for its (device, stream), zeroed once; the last block to
//     count itself done clears the counters and flags, so the next call
//     or graph replay finds it clean.  N <= one tile touches no scratch.
// Measured on an H100 (700 W, PERF.md): 5.7-5.9 us at 2^17 lanes against
// the 0.63 us bytes bound.
//
// C interface, bound with ctypes (tuun_tpu_torch/engine/scan_ops.py).
// Every entry returns cudaGetLastError() after its launch.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int64_t kMaxN = 2147483647;  // 2^31 - 1

// ---------------------------------------------------------------------------
// Linear recurrence
// ---------------------------------------------------------------------------

constexpr int kRecThreads = 128;  // warp 0: the chain; warps 1-3: staging
constexpr int kRecStagers = kRecThreads - 32;
constexpr int kRecTile = 512;     // lanes a staged tile (J <= 16)
// Shared memory a block may take: the generic (J > 16) form sizes its
// tiles to this.
constexpr int kRecSmemBudget = 200 * 1024;
constexpr int kRecMaxJ = 4096;

__host__ __device__ __forceinline__ int64_t lmin(int64_t a, int64_t b) {
  return a < b ? a : b;
}

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }

// Shared-memory layout of one block: two buffers each of a [tile * J],
// ff [tile] and y [tile], then (generic form) the history ring [J], then
// two live buffers [tile] of bytes.
template <typename T>
struct RecSmem {
  T* a[2];
  T* ff[2];
  T* y[2];
  T* ring;
  uint8_t* live[2];
};

template <typename T>
__host__ __device__ constexpr size_t rec_smem_bytes(int tile, int J, bool ring) {
  return sizeof(T) * (size_t)(2 * tile * J + 4 * tile + (ring ? J : 0)) +
         2 * (size_t)tile;
}

template <typename T>
__device__ RecSmem<T> rec_smem(unsigned char* base, int tile, int J, bool ring) {
  RecSmem<T> s;
  T* p = reinterpret_cast<T*>(base);
  s.a[0] = p;
  s.a[1] = p + tile * J;
  p += 2 * tile * J;
  s.ff[0] = p;
  s.ff[1] = p + tile;
  p += 2 * tile;
  s.y[0] = p;
  s.y[1] = p + tile;
  p += 2 * tile;
  s.ring = p;
  p += ring ? J : 0;
  uint8_t* q = reinterpret_cast<uint8_t*>(p);
  s.live[0] = q;
  s.live[1] = q + tile;
  return s;
}

// Copies tile `t` of the row's a, ff and live into buffer `b`, with the
// threads [first, first + count) of the block: a and ff by cp.async
// (every copy in flight at once; the caller waits), live by plain loads.
template <typename T>
__device__ __forceinline__ void rec_stage(const RecSmem<T>& s, int b,
                                          const T* __restrict__ a,
                                          const T* __restrict__ ff,
                                          const uint8_t* __restrict__ live,
                                          int64_t n, int J, int tile, int64_t t,
                                          int me, int count) {
  const int64_t base = t * tile;
  const int m = (int)lmin(tile, n - base);
  const T* src_a = a + base * J;
  for (int e = me; e < m * J; e += count) {
    __pipeline_memcpy_async(&s.a[b][e], &src_a[e], sizeof(T));
  }
  for (int e = me; e < m; e += count) {
    __pipeline_memcpy_async(&s.ff[b][e], &ff[base + e], sizeof(T));
    s.live[b][e] = live[base + e];
  }
  __pipeline_commit();
}

// Writes the y of tile `t` from buffer `b`, coalesced.
template <typename T>
__device__ __forceinline__ void rec_store(const RecSmem<T>& s, int b,
                                          T* __restrict__ y, int64_t n,
                                          int tile, int64_t t, int me,
                                          int count) {
  const int64_t base = t * tile;
  const int m = (int)lmin(tile, n - base);
  for (int e = me; e < m; e += count) y[base + e] = s.y[b][e];
}

// One lane of the chain, history in registers.
template <typename T, int J>
__device__ __forceinline__ T rec_lane(const T* av, T f, bool lv, T* h) {
  T acc = f;
#pragma unroll
  for (int j = 0; j < J; ++j) acc = sub_rn(acc, mul_rn(av[j], h[j]));
#pragma unroll
  for (int j = J - 1; j >= 1; --j) h[j] = lv ? h[j - 1] : h[j];
  h[0] = lv ? acc : h[0];
  return lv ? acc : T(0);
}

// The chain over one staged tile of m lanes, history in registers.  The
// lanes go in groups of G: a group's a, ff and live are read from shared
// memory into registers before its chain starts, so the chain never
// waits on a shared-memory load.
template <typename T, int J>
__device__ __forceinline__ void rec_tile_regs(const RecSmem<T>& s, int b, int m,
                                              T* h) {
  constexpr int G = J <= 2 ? 16 : (J <= 4 ? 8 : 4);
  const T* __restrict__ a = s.a[b];
  const T* __restrict__ ff = s.ff[b];
  const uint8_t* __restrict__ live = s.live[b];
  T* __restrict__ y = s.y[b];
  int i = 0;
  for (; i + G <= m; i += G) {
    T av[G * J], fv[G], yv[G];
    bool lv[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      fv[g] = ff[i + g];
      lv[g] = live[i + g] != 0;
#pragma unroll
      for (int j = 0; j < J; ++j) av[g * J + j] = a[(i + g) * J + j];
    }
#pragma unroll
    for (int g = 0; g < G; ++g) yv[g] = rec_lane<T, J>(av + g * J, fv[g], lv[g], h);
#pragma unroll
    for (int g = 0; g < G; ++g) y[i + g] = yv[g];
  }
  for (; i < m; ++i) {
    T av[J];
#pragma unroll
    for (int j = 0; j < J; ++j) av[j] = a[i * J + j];
    y[i] = rec_lane<T, J>(av, ff[i], live[i] != 0, h);
  }
}

// The chain over one staged tile, history in a ring in shared memory:
// ring[p] is the newest value y[i-1], ring[(p - j) mod J] is y[i-1-j].
template <typename T>
__device__ __forceinline__ void rec_tile_ring(const RecSmem<T>& s, int b, int m,
                                              int J, int& p) {
  const T* __restrict__ a = s.a[b];
  const T* __restrict__ ff = s.ff[b];
  const uint8_t* __restrict__ live = s.live[b];
  T* __restrict__ y = s.y[b];
  T* ring = s.ring;
  for (int i = 0; i < m; ++i) {
    T acc = ff[i];
    int k = p;
    for (int j = 0; j < J; ++j) {
      acc = sub_rn(acc, mul_rn(a[i * J + j], ring[k]));
      k = k == 0 ? J - 1 : k - 1;
    }
    if (live[i]) {
      p = p == J - 1 ? 0 : p + 1;
      ring[p] = acc;
      y[i] = acc;
    } else {
      y[i] = T(0);
    }
  }
}

// One block a row.  kJ > 0: the history in registers, kJ = 0: J (any) in
// the ring.  Thread 0 runs the chain over tile t while warps 1-3 stage
// tile t + 1 and store tile t - 1's y.
template <typename T, int kJ>
__global__ void __launch_bounds__(kRecThreads)
linear_recurrence(const T* __restrict__ a_all, const T* __restrict__ ff_all,
                  const uint8_t* __restrict__ live_all,
                  const T* __restrict__ h0_all, T* __restrict__ y_all,
                  T* __restrict__ hist_all, int64_t n, int J, int tile) {
  extern __shared__ __align__(16) unsigned char rec_raw[];
  const RecSmem<T> s = rec_smem<T>(rec_raw, tile, J, kJ == 0);
  const int64_t r = blockIdx.x;
  const T* __restrict__ a = a_all + r * n * J;
  const T* __restrict__ ff = ff_all + r * n;
  const uint8_t* __restrict__ live = live_all + r * n;
  const T* __restrict__ h0 = h0_all + r * J;
  T* __restrict__ y = y_all + r * n;
  T* __restrict__ hist = hist_all + r * J;
  const int64_t tiles = (n + tile - 1) / tile;
  const bool stager = threadIdx.x >= 32;
  const int me = threadIdx.x - 32;

  rec_stage<T>(s, 0, a, ff, live, n, J, tile, 0, threadIdx.x, kRecThreads);
  __pipeline_wait_prior(0);
  __syncthreads();

  constexpr int kRegs = kJ > 0 ? kJ : 1;
  T h[kRegs];
  int p = 0;
  if (threadIdx.x == 0) {
    if constexpr (kJ > 0) {
#pragma unroll
      for (int j = 0; j < kJ; ++j) h[j] = h0[j];
    } else {
      for (int j = 0; j < J; ++j) s.ring[(J - j) % J] = h0[j];
    }
  }
  for (int64_t t = 0; t < tiles; ++t) {
    const int cur = (int)(t & 1);
    if (stager) {
      if (t + 1 < tiles) {
        rec_stage<T>(s, cur ^ 1, a, ff, live, n, J, tile, t + 1, me,
                     kRecStagers);
      }
      if (t > 0) rec_store<T>(s, cur ^ 1, y, n, tile, t - 1, me, kRecStagers);
      __pipeline_wait_prior(0);
    } else if (threadIdx.x == 0) {
      const int m = (int)lmin(tile, n - t * tile);
      if constexpr (kJ > 0) {
        rec_tile_regs<T, kJ>(s, cur, m, h);
      } else {
        rec_tile_ring<T>(s, cur, m, J, p);
      }
    }
    __syncthreads();
  }
  rec_store<T>(s, (int)((tiles - 1) & 1), y, n, tile, tiles - 1, threadIdx.x,
               kRecThreads);
  if (threadIdx.x == 0) {
    if constexpr (kJ > 0) {
#pragma unroll
      for (int j = 0; j < kJ; ++j) hist[j] = h[j];
    } else {
      for (int j = 0; j < J; ++j) hist[j] = s.ring[(p - j + J) % J];
    }
  }
}

template <typename T, int kJ>
int launch_recurrence(const T* a, const T* ff, const uint8_t* live,
                      const T* h0, T* y, T* hist, int64_t rows, int64_t n,
                      int J, cudaStream_t stream) {
  int tile = kRecTile;
  if (kJ == 0) {
    // Tiles that fit the budget, at most kRecTile lanes.
    const size_t per_lane = rec_smem_bytes<T>(1, J, false);
    const size_t room = kRecSmemBudget - sizeof(T) * (size_t)J;
    tile = (int)lmin(kRecTile, (int64_t)(room / per_lane));
    if (tile < 1) return (int)cudaErrorInvalidValue;
  }
  const size_t smem = rec_smem_bytes<T>(tile, J, kJ == 0);
  auto kernel = linear_recurrence<T, kJ>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<(unsigned)rows, kRecThreads, smem, stream>>>(a, ff, live, h0, y,
                                                         hist, n, J, tile);
  return (int)cudaGetLastError();
}

template <typename T>
int run_recurrence(const T* a, const T* ff, const uint8_t* live, const T* h0,
                   T* y, T* hist, int64_t rows, int64_t n, int J,
                   cudaStream_t stream) {
  if (n <= 0 || n > kMaxN || rows <= 0 || rows > kMaxN || J < 1 ||
      J > kRecMaxJ) {
    return (int)cudaErrorInvalidValue;
  }
  switch (J) {
#define TUUN_REC_CASE(k) \
    case k: return launch_recurrence<T, k>(a, ff, live, h0, y, hist, rows, \
                                           n, J, stream);
    TUUN_REC_CASE(1) TUUN_REC_CASE(2) TUUN_REC_CASE(3) TUUN_REC_CASE(4)
    TUUN_REC_CASE(5) TUUN_REC_CASE(6) TUUN_REC_CASE(7) TUUN_REC_CASE(8)
    TUUN_REC_CASE(9) TUUN_REC_CASE(10) TUUN_REC_CASE(11) TUUN_REC_CASE(12)
    TUUN_REC_CASE(13) TUUN_REC_CASE(14) TUUN_REC_CASE(15) TUUN_REC_CASE(16)
#undef TUUN_REC_CASE
    default:
      return launch_recurrence<T, 0>(a, ff, live, h0, y, hist, rows, n, J,
                                     stream);
  }
}

// ---------------------------------------------------------------------------
// df prefix sum
// ---------------------------------------------------------------------------

constexpr int kDfThreads = 256;
constexpr int kDfItems = 8;                       // lanes per thread
constexpr int kDfTile = kDfThreads * kDfItems;    // 2048 lanes per block
constexpr int kDfVecs = kDfItems / 4;             // float4 per thread per word
// Scratch, in 32-bit words, for `cap` tiles: [0] tile counter, [1] done
// counter, [2, 2 + cap) a flag per tile, then from df_record_offset(cap)
// two floats (hi, lo) per tile.  Only counters and flags must be zero when
// a call starts.
constexpr int kDfHead = 2;

__host__ __device__ constexpr int64_t df_record_offset(int64_t cap) {
  return (kDfHead + cap + 1) / 2 * 2;
}

struct Df {
  float h, l;
};

// df32.df_add: TwoSum of the high words, the low words added into its
// error, then Fast2Sum.  `x` precedes `y` in the sequence.
__device__ __forceinline__ Df df_add(Df x, Df y) {
  const float s = __fadd_rn(x.h, y.h);
  const float bb = __fsub_rn(s, x.h);
  const float err = __fadd_rn(__fsub_rn(x.h, __fsub_rn(s, bb)),
                              __fsub_rn(y.h, bb));
  const float te = __fadd_rn(err, __fadd_rn(x.l, y.l));
  const float s2 = __fadd_rn(s, te);
  return Df{s2, __fsub_rn(te, __fsub_rn(s2, s))};
}

__device__ __forceinline__ Df shfl_up_df(Df v, int d) {
  return Df{__shfl_up_sync(kFull, v.h, d), __shfl_up_sync(kFull, v.l, d)};
}

__device__ __forceinline__ Df shfl_down_df(Df v, int d) {
  return Df{__shfl_down_sync(kFull, v.h, d), __shfl_down_sync(kFull, v.l, d)};
}

// Shared-memory index of lane j of the tile: 4 pad words after every 32
// (scan.cu's pad), so coalesced stores and each thread's float4 reads of
// its own lanes are free of bank conflicts.
__device__ __forceinline__ int df_pad(int j) { return j + ((j >> 5) << 2); }

__device__ __forceinline__ unsigned df_load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void df_store_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned df_count_acq_rel(unsigned* p) {
  unsigned old;
  asm volatile("atom.add.acq_rel.gpu.global.u32 %0, [%1], 1;"
               : "=r"(old) : "l"(p) : "memory");
  return old;
}

// Exclusive scan of one pair per thread across the block; thread 0's
// result is unused (it has no predecessor).  *total: the block's total.
__device__ Df df_block_exclusive(Df v, Df* warp_tot, Df* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  constexpr int kWarps = kDfThreads / 32;
  Df incl = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Df o = shfl_up_df(incl, d);
    if (lane >= d) incl = df_add(o, incl);
  }
  Df excl = shfl_up_df(incl, 1);
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    Df t = lane < kWarps ? warp_tot[lane] : Df{0.0f, 0.0f};
#pragma unroll
    for (int d = 1; d < kWarps; d <<= 1) {
      const Df o = shfl_up_df(t, d);
      if (lane >= d) t = df_add(o, t);
    }
    if (lane < kWarps) warp_tot[lane] = t;
  }
  __syncthreads();
  if (warp > 0) {
    const Df before = warp_tot[warp - 1];
    excl = lane == 0 ? before : df_add(before, excl);
  }
  *total = warp_tot[kWarps - 1];
  __syncthreads();
  return excl;
}

// Run by the whole block of tile t > 0; the result is thread 0's.  Anchor
// a's inclusive prefix (a = the last multiple of kDfThreads below t), then
// the aggregates of tiles a + 1 .. t - 1, folded in sequence order by a
// fixed shuffle tree: thread k waits for tile a + k's flag (acquire) and
// reads its record from L2.  With at most 32 records only warp 0 takes
// part and no barrier is needed.
__device__ Df df_look_back(const unsigned* flags, const float* records,
                           int64_t t, Df* warp_tot) {
  const int64_t a = (t - 1) / kDfThreads * kDfThreads;
  const int words = (int)(t - a);
  const int lane = threadIdx.x & 31;
  Df v{0.0f, 0.0f};
  if (words <= 32 && threadIdx.x >= 32) return v;
  const bool mine = (int)threadIdx.x < words;
  bool ready = !mine;
  // The warp spins as one, as scan.cu's look-backs do.
  while (__any_sync(kFull, !ready)) {
    if (!ready) ready = df_load_acquire(&flags[a + threadIdx.x]) != 0;
  }
  if (mine) {
    const float* rec = records + 2 * (a + threadIdx.x);
    v = Df{__ldcg(rec), __ldcg(rec + 1)};
  }
  // Lanes past the words hold (0, 0), which df_add passes through.
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Df o = shfl_down_df(v, d);
    if (lane + d < 32) v = df_add(v, o);
  }
  if (words <= 32) return v;
  if (lane == 0) warp_tot[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < (words + 31) / 32; ++w) v = df_add(v, warp_tot[w]);
  }
  return v;
}

// Loads `count`-lane tile words into the padded shared tile: float4 when
// whole and 16-byte aligned, else masked scalars (lanes past n are 0).
__device__ __forceinline__ void df_load(const float* __restrict__ src,
                                        int64_t base, int64_t n, bool vec,
                                        float* tile) {
  if (vec) {
    const float4* s4 = reinterpret_cast<const float4*>(src + base);
#pragma unroll
    for (int k = 0; k < kDfVecs; ++k) {
      const int v = k * kDfThreads + threadIdx.x;
      *reinterpret_cast<float4*>(&tile[df_pad(4 * v)]) = s4[v];
    }
  } else {
#pragma unroll
    for (int k = 0; k < kDfItems; ++k) {
      const int j = k * kDfThreads + threadIdx.x;
      tile[df_pad(j)] = base + j < n ? src[base + j] : 0.0f;
    }
  }
}

__device__ __forceinline__ void df_store(float* __restrict__ dst, int64_t base,
                                         int64_t n, bool vec,
                                         const float* tile) {
  if (vec) {
    float4* d4 = reinterpret_cast<float4*>(dst + base);
#pragma unroll
    for (int k = 0; k < kDfVecs; ++k) {
      const int v = k * kDfThreads + threadIdx.x;
      d4[v] = *reinterpret_cast<const float4*>(&tile[df_pad(4 * v)]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < kDfItems; ++k) {
      const int j = k * kDfThreads + threadIdx.x;
      if (base + j < n) dst[base + j] = tile[df_pad(j)];
    }
  }
}

// Single-pass inclusive df scan of each of `rows` rows of n lanes (row r
// at r * n in each of xh, xl, oh, ol).  As in scan.cu, a tile never
// crosses a row and its look-back reads only its own row's status in a
// single row's grouping, so row r gives the bits of a one-row call on it.
__global__ void __launch_bounds__(kDfThreads)
df_prefix_sum(const float* __restrict__ xh_all, const float* __restrict__ xl_all,
              float* __restrict__ oh_all, float* __restrict__ ol_all,
              unsigned* scratch, int64_t cap, int64_t rows, int64_t n) {
  constexpr int kPadded = kDfTile + kDfTile / 8;
  __shared__ __align__(16) float tile_h[kPadded];
  __shared__ __align__(16) float tile_l[kPadded];
  __shared__ Df warp_tot[32];
  __shared__ unsigned tile_index;
  __shared__ Df tile_prefix;
  __shared__ bool last_block;
  const int64_t nbr = (n + kDfTile - 1) / kDfTile;  // tiles per row
  const int64_t nb = rows * nbr;
  int64_t gt = blockIdx.x;
  if (nbr > 1) {
    if (threadIdx.x == 0) tile_index = atomicAdd(&scratch[0], 1u);
    __syncthreads();
    gt = (int64_t)tile_index;
  }
  const int64_t r = (int64_t)((unsigned)gt / (unsigned)nbr);
  const int64_t t = gt - r * nbr;
  const float* __restrict__ xh = xh_all + r * n;
  const float* __restrict__ xl = xl_all + r * n;
  float* __restrict__ oh = oh_all + r * n;
  float* __restrict__ ol = ol_all + r * n;
  unsigned* flags = scratch + kDfHead + r * nbr;
  float* records = reinterpret_cast<float*>(scratch + df_record_offset(cap)) +
                   2 * r * nbr;
  const int64_t base = t * kDfTile;
  const bool whole = base + kDfTile <= n;
  const bool vec_in = whole && (((uintptr_t)xh | (uintptr_t)xl) & 15) == 0;
  const bool vec_out = whole && (((uintptr_t)oh | (uintptr_t)ol) & 15) == 0;

  df_load(xh, base, n, vec_in, tile_h);
  df_load(xl, base, n, vec_in, tile_l);
  __syncthreads();

  // Each thread folds its own lanes in sequence.
  Df items[kDfItems];
  const int first = threadIdx.x * kDfItems;
#pragma unroll
  for (int q = 0; q < kDfVecs; ++q) {
    const float4 fh = *reinterpret_cast<const float4*>(&tile_h[df_pad(first + 4 * q)]);
    const float4 fl = *reinterpret_cast<const float4*>(&tile_l[df_pad(first + 4 * q)]);
    items[4 * q] = Df{fh.x, fl.x};
    items[4 * q + 1] = Df{fh.y, fl.y};
    items[4 * q + 2] = Df{fh.z, fl.z};
    items[4 * q + 3] = Df{fh.w, fl.w};
  }
#pragma unroll
  for (int k = 1; k < kDfItems; ++k) items[k] = df_add(items[k - 1], items[k]);
  Df total;
  const Df excl = df_block_exclusive(items[kDfItems - 1], warp_tot, &total);

  if (nbr > 1) {
    const bool anchor = t % kDfThreads == 0;
    if (threadIdx.x == 0 && !anchor) {
      records[2 * t] = total.h;
      records[2 * t + 1] = total.l;
      df_store_release(&flags[t], 1u);
    }
    Df before{0.0f, 0.0f};
    if (t > 0) before = df_look_back(flags, records, t, warp_tot);
    if (threadIdx.x == 0) {
      if (anchor) {
        const Df incl = t > 0 ? df_add(before, total) : total;
        records[2 * t] = incl.h;
        records[2 * t + 1] = incl.l;
        df_store_release(&flags[t], 1u);
      }
      tile_prefix = before;
      // Every read of a flag or record by this block is done, and this
      // tile's flag is final.
      last_block = df_count_acq_rel(&scratch[1]) == (unsigned)(nb - 1);
    }
    __syncthreads();
  }

  // Fold in the tile's carry, then the thread's exclusive prefix within
  // the tile (thread 0 has none).
  const bool has_tile = nbr > 1 && t > 0;
  if (has_tile || threadIdx.x > 0) {
    Df carry = excl;
    if (has_tile) carry = threadIdx.x > 0 ? df_add(tile_prefix, excl) : tile_prefix;
#pragma unroll
    for (int k = 0; k < kDfItems; ++k) items[k] = df_add(carry, items[k]);
  }
#pragma unroll
  for (int q = 0; q < kDfVecs; ++q) {
    *reinterpret_cast<float4*>(&tile_h[df_pad(first + 4 * q)]) = make_float4(
        items[4 * q].h, items[4 * q + 1].h, items[4 * q + 2].h, items[4 * q + 3].h);
    *reinterpret_cast<float4*>(&tile_l[df_pad(first + 4 * q)]) = make_float4(
        items[4 * q].l, items[4 * q + 1].l, items[4 * q + 2].l, items[4 * q + 3].l);
  }
  __syncthreads();
  df_store(oh, base, n, vec_out, tile_h);
  df_store(ol, base, n, vec_out, tile_l);

  // The last block to finish its look-back leaves the scratch clean.
  if (nbr > 1 && last_block) {
    unsigned* all = scratch + kDfHead;
    for (int64_t i = threadIdx.x; i < nb; i += kDfThreads) all[i] = 0;
    if (threadIdx.x == 0) {
      scratch[0] = 0;
      scratch[1] = 0;
    }
  }
}

}  // namespace

extern "C" {

int tuun_df_tile() { return kDfTile; }
int tuun_recurrence_max_j() { return kRecMaxJ; }

// Words (32-bit) of a df prefix-sum scratch buffer for up to `tiles` tiles.
long long tuun_df_scratch_words(long long tiles) {
  return df_record_offset(tiles) + 2 * tiles;
}

// a T[rows, n, J], ff T[rows, n], live u8[rows, n], h0 T[rows, J] (each
// row-major) -> y T[rows, n], hist T[rows, J]: each row's recurrence (see
// the top of this file), one block a row, in one launch.  Bit-identical
// to scan_ops.linear_recurrence_ref.
int tuun_linear_recurrence_rows_f32(const float* a, const float* ff,
                                    const uint8_t* live, const float* h0,
                                    float* y, float* hist, long long rows,
                                    long long n, int J, void* stream) {
  return run_recurrence<float>(a, ff, live, h0, y, hist, rows, n, J,
                               (cudaStream_t)stream);
}

int tuun_linear_recurrence_rows_f64(const double* a, const double* ff,
                                    const uint8_t* live, const double* h0,
                                    double* y, double* hist, long long rows,
                                    long long n, int J, void* stream) {
  return run_recurrence<double>(a, ff, live, h0, y, hist, rows, n, J,
                                (cudaStream_t)stream);
}

// xh, xl f32[rows, n] -> oh, ol f32[rows, n]: the inclusive df_add prefix
// of each row, in one launch, the same bits on every call and for a row
// as for a one-row call on it.  scratch: the caller's persistent buffer of
// tuun_df_scratch_words(cap) words for this stream, counters and flags
// zero, cap >= rows * ceil(n / tuun_df_tile()) (null when n <= one tile);
// the kernel leaves it so.  Calls that share a scratch must not overlap.
int tuun_df_prefix_sum_rows_f32(const float* xh, const float* xl, float* oh,
                                float* ol, unsigned* scratch, long long cap,
                                long long rows, long long n, void* stream) {
  if (n <= 0 || n > kMaxN || rows <= 0) return (int)cudaErrorInvalidValue;
  const int64_t nbr = (n + kDfTile - 1) / kDfTile;
  const int64_t nb = rows * nbr;
  if (nb > kMaxN || (nbr > 1 && (scratch == nullptr || nb > cap))) {
    return (int)cudaErrorInvalidValue;
  }
  df_prefix_sum<<<(unsigned)nb, kDfThreads, 0, (cudaStream_t)stream>>>(
      xh, xl, oh, ol, scratch, cap, rows, n);
  return (int)cudaGetLastError();
}

}  // extern "C"

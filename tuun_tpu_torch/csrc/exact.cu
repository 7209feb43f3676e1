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
// once; 8J + 17 in f64) at the main path's shapes.  One thread running
// the chain alone from registers takes 13.8 cycles a lane at J = 2 in f32
// (24.8 in f64; 51.0 at J = 9, 84.5 at J = 16: affine_probe.py's chain
// latency on an H100), so the design keeps everything else off the chain.
// The chain form (J <= 16, a template per J: fast mode's filters deeper
// than the affine scan's 8 run here too):
//   * one block a row, two warps; no block barrier after set-up.  Warp 1,
//     the producer, stages a, ff and live through a ring of kRecStages
//     shared-memory stage buffers: three 1-D bulk copies (TMA) a stage,
//     counted on the stage's `full` mbarrier, for the stage's whole
//     16-lane grains; its own coalesced loads for the head (the lanes
//     before the first whose live byte starts a grain: a [1:] view's 15)
//     and a ragged tail, or for every lane where a, ff and live are not
//     aligned alike.  The first stage is the head, then 64 lanes, so the
//     chain starts ~0.5 us after launch; stages then double up to S;
//   * warp 0 runs the chain, all 32 lanes at once on the same lanes (SIMT
//     makes the copies free): a group's inputs come by broadcast 16-byte
//     shared loads issued a few lanes ahead of the chain, so no load and
//     no select sits on it; every V lanes' y go back by one 16-byte store
//     to the stage buffer, and the producer stores the stage's y,
//     coalesced, once the chain releases it (`empty`), then refills it;
//   * one ballot of the live bytes per 32 lanes picks a group's body (64
//     lanes up to J = 4, else 32): all live, with no select on the chain;
//     all dead, zeros; mixed, the reference's selects lane by lane;
//   * every product and difference is an intrinsic that rounds on its own
//     (__fmul_rn / __fsub_rn, __dmul_rn / __dsub_rn): nvcc contracts
//     a*b + c into a fused multiply-add by default, which would round once
//     where the reference rounds twice.  So y has the bits of the plain
//     version (scan_ops.linear_recurrence_ref) in both types;
//   * no scratch: rows share nothing, so a captured CUDA graph needs no
//     set-up either.
// The wide form (J = 17 .. kRecWideMaxJ = 95, J at run time: one kernel
// for every such J, unrolled windows up to J = 34): the chain form's ring
// of stages, producer warp and chain warp, but the history a linear
// buffer in shared memory and each lane's products formed ahead of it by
// the warp's 32 threads together, so only the first product and the J
// differences sit on the chain (rec_wide_row, below).  Measured (PERF.md
// section 6, `--phase times --tree` in turns, all lanes live): J = 17 /
// 24 / 32 / 64 at 2^17 lanes 8.83-8.89 / 10.99-11.07 / 13.29-13.39 /
// 41.3-41.6 ms against 69.4-69.9 / 92.0-92.6 / 118.4-119.4 / 224.1-225.8
// for the ring form before it (1.85-1.87 / 1.66-1.67 / 1.52-1.53 /
// 2.40-2.42x the chain model; ~1.4x and ~1.15x the card's own chain at J
// = 17 and 32), 1024 lanes at J = 17 71.6-72.2 us against 546-550.
// The streamed form (J = 96 .. kRecMaxJ = 4096, J at run time): the wide
// form's stages, history and products formed ahead by the chain warp's
// threads, but a lane's a row, too large for a ring of stages, streams in
// by bulk copies of its own into a small ring of buffers, and a lane's
// products are formed while the lane before it runs its chain, so that
// the chain reads them by broadcast 16-byte loads (rec_stream_row,
// below; its times beside the ring form it replaced: PERF.md section 6).
// Measured on an H100 80GB HBM3 at 700 W (PERF.md section 6: device time
// of captured calls by `chip_smoke.py --phase times --tree`, in turns with
// the earlier one-thread kernel; all lanes live): J = 2 in f32 at 2^17
// lanes 1013-1021 us (15.3-15.4 cycles a lane at 1.98 GHz; the earlier
// kernel 2762-2763 us), 9.90-10.01 us at 1024 lanes (23.38-23.60), f64
// 1874-1889 us (3517-3520), J = 9 / 12 / 16 3167-3190 / 4131-4162 /
// 5353-5396 us (7476-7477 / 8995 / 12676-12678): within 1.12x of one
// thread running the chain from registers, or under it.  Shuffling a
// group's inputs from lane to lane instead was 1.3-4x slower
// (`affine_probe.py recurrence`): a warp's shared-memory and shuffle
// instructions issue at ~1 per 5 cycles, so the 16-byte loads, which need
// fewest, win.
//
// df prefix sum.  Inclusive prefix of df_add over (hi, lo) pairs along
// each row.  What bounds it: bytes, 16 a lane (two floats read, two
// written; 2 MB at 2^17 lanes, 0.63 us at 3.35 TB/s), and below ~2^20
// lanes the latency of launch, of a tile's dependent adds and of the
// memory trips of a look-back.  So the design keeps all three short:
//   * tiles sized by the call (df_tile): a row of up to 1024 lanes (the
//     live block, a group's rows) is one block of 256 threads x 4 lanes,
//     loaded straight into registers by float4, a shuffle scan a warp and
//     one exchange of warp totals through shared memory; a row of up to
//     4096 lanes one block of 512 x 8; both touch no scratch.  Longer rows
//     take 2048-lane tiles up to 2^18 lanes and 4096-lane ones past it
//     (the fewest look-back records that still fill the card), staged
//     through shared memory so that loads and stores stay coalesced;
//   * a longer row's tiles are a single-pass scan with decoupled
//     look-back; a tile waits only on tiles of lower index.  Every grid
//     whose rows have more than one tile takes its tiles from an atomic
//     counter (df_counted), so every tile below a running one has been
//     taken by a block that is running or done, and a running block waits
//     only on those: the scan makes progress whatever else the card runs
//     (two calls overlapping from two streams, a graph's warm-up beside a
//     render) and whatever order CUDA dispatches blocks in, which it does
//     not promise.  While the counter answers, a block sends tile
//     blockIdx.x towards L2, so that whichever block draws a tile finds
//     it there or on its way (blocks that start together draw in no fixed
//     order).  A block runs one tile, and the tile, not the block, fixes
//     the bits.  A pair and a
//     flag do not fit in one 64-bit word, so each tile has a flag word and
//     a record of two floats; a tile writes its record, then the flag with
//     st.release; a reader loads the flag with ld.acquire and only then
//     the record, from L2 (ld.cg), as scan.cu's affine scan does;
//   * fixed grouping, so a call gives the same bits every time: every
//     tile whose index is a multiple of its thread count (256 or 512) is
//     an anchor and publishes its inclusive prefix, every other tile its
//     aggregate at once; tile t folds anchor a's prefix and the aggregates
//     of a + 1 .. t - 1, a record a thread, by a fixed tree.  df_add is
//     not associative, so these bits differ from XLA's associative_scan
//     and from the plain doubling scan in the last compensated bits; each
//     is held to the float64 cumsum (chip_smoke.df_model gives the
//     kernel's own bits);
//   * df_add's additions are __fadd_rn / __fsub_rn: TwoSum's error term
//     is exact only if each rounds on its own;
//   * the scratch (a done counter, a tile counter, flags, records) is the
//     caller's persistent buffer for its (device, stream), zeroed once;
//     the last block to count itself done clears the counters and flags,
//     so the next call or graph replay finds it clean.  A one-tile row
//     touches no scratch.
// Measured (PERF.md section 6, in turns with the kernel before it): 1024
// lanes 2.14-2.29 us against 2.72-2.74, rows (8, 1024) 2.24-2.39 against
// 2.76, 2^17 5.48-5.49 against 5.92-5.98 (bytes bound 0.63), 2^20
// 10.36-10.42 against 13.02-13.04.
//
// C interface, bound with ctypes (tuun_tpu_torch/engine/scan_ops.py).
// Every entry returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

// Build parts.  The engine compiles this file three times at once and
// links the objects (engine/scan_ops.py): TUUN_EXACT_PART 1 and 2 hold
// the chain form's instances for J = 1-8 and 9-16 (most of the build's
// time), 3 the rest and the C interface.  Without the macro one object
// holds all.
#ifndef TUUN_EXACT_PART
#define TUUN_EXACT_PART 0
#endif

namespace tuun_exact {
// The chain form's launch for J = 1-8 (part 1) and 9-16 (part 2).
template <typename T>
int launch_chain_lo(const T* a, const T* ff, const uint8_t* live,
                    const T* h0, T* y, T* hist, int64_t rows, int64_t n,
                    int J, cudaStream_t stream);
template <typename T>
int launch_chain_hi(const T* a, const T* ff, const uint8_t* live,
                    const T* h0, T* y, T* hist, int64_t rows, int64_t n,
                    int J, cudaStream_t stream);
}  // namespace tuun_exact

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int64_t kMaxN = 2147483647;  // 2^31 - 1

// ---------------------------------------------------------------------------
// Linear recurrence
// ---------------------------------------------------------------------------

constexpr int kRecMaxJ = 4096;
constexpr int kRecRegJ = 16;  // deepest history held in registers
// The chain form: warp 0 runs the chain, warp 1 stages its inputs.
constexpr int kRecChainThreads = 64;
constexpr int kRecStages = 4;     // stage buffers in the ring
constexpr int kRecFirst = 64;     // first stage's lanes past the head
constexpr int kRecMaxStage = 1024;
constexpr int kRecBudget = 48 * 1024;  // shared memory of the ring
// A bulk copy moves whole 16-byte grains: 16 lanes of live bytes.
constexpr int kRecGrain = 16;
// Group width, lookahead and bulk copies were chosen by measurement
// (PERF.md; `affine_probe.py recurrence` times the alternatives).
// Lanes a group: one ballot per 32 decides a group's body, and the body's
// loop is unrolled over the group.
__host__ __device__ constexpr int rec_group_lanes(int J) {
  return J <= 4 ? 64 : 32;
}
// Lanes whose inputs are loaded ahead of the chain.
__host__ __device__ constexpr int rec_ahead_lanes(int J) {
  return J <= 8 ? 4 : 2;
}

__host__ __device__ __forceinline__ int64_t lmin(int64_t a, int64_t b) {
  return a < b ? a : b;
}

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }

// Bytes a lane takes in a stage buffer: a (J), ff, y, live.
__host__ __device__ constexpr int rec_lane_bytes(int J, int item) {
  return (J + 2) * item + 1;
}

// Lanes of a full stage: the largest power of two from kRecFirst up to
// kRecMaxStage whose ring of kRecStages buffers fits kRecBudget.
__host__ __device__ constexpr int rec_stage_lanes(int J, int item) {
  int s = kRecMaxStage;
  while (s > kRecFirst &&
         (int64_t)kRecStages * s * rec_lane_bytes(J, item) > kRecBudget) {
    s >>= 1;
  }
  return s;
}

// One row's stages, in the order the producer fills them and the chain
// runs them: the head (the lanes before the first whose live byte starts
// a 16-byte grain) where there is one, then kRecFirst lanes, then twice
// as many each time up to S, the last what is left.  Every stage past the
// head starts on a grain, so a stage's buffer holds lane st + i at index
// i and its 16-byte loads are aligned.
struct RecStage {
  int64_t st;   // first lane
  int64_t len;  // lanes
  int k;        // stages before it
  int g;        // doublings: the stage after the head has 0
  __device__ __forceinline__ RecStage(int64_t n, int head)
      : st(0), len(lmin(n, head > 0 ? head : kRecFirst)), k(0),
        g(head > 0 ? -1 : 0) {}
  __device__ __forceinline__ void next(int64_t n, int S) {
    st += len;
    ++k;
    ++g;
    len = lmin(n - st, g < 16 ? lmin(S, (int64_t)kRecFirst << g) : S);
  }
};

// mbarriers and bulk copies (PTX, sm_90).
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// Release: this thread's earlier accesses happen before the phase ends.
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Acquire: waits for the phase of `parity` to complete.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, "
        "[%1], %2;\nselp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  } while (!done);
}

// A 1-D bulk copy (TMA) of `bytes` (a multiple of 16, both ends 16-byte
// aligned) from device memory into shared memory, counted on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Orders this thread's earlier generic accesses to shared memory before
// later bulk copies into it.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// A 16-byte shared-memory load of V = 16 / sizeof(T) items into out, and
// a 16-byte store of V items from in.
template <typename T>
__device__ __forceinline__ void lds16(const T* p, T* out) {
  if constexpr (sizeof(T) == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  } else {
    const double2 v = *reinterpret_cast<const double2*>(p);
    out[0] = v.x;
    out[1] = v.y;
  }
}

template <typename T>
__device__ __forceinline__ void sts16(T* p, const T* in) {
  if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
  } else {
    *reinterpret_cast<double2*>(p) = make_double2(in[0], in[1]);
  }
}

// Issues the 16-byte loads that start in lane q's inputs: its a row (the
// chunks that begin there; one that spills into lane q + 1 comes whole)
// and, every V lanes, V lanes' ff.  All indices are constants once the
// caller's loop unrolls, so av and fv live in registers.
template <typename T, int J>
__device__ __forceinline__ void rec_fetch(const T* as, const T* fs, int q,
                                          T* av, T* fv) {
  constexpr int V = 16 / sizeof(T);
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int e = q * J + j;
    if (e % V == 0) lds16(as + e, av + e);
  }
  if (q % V == 0) lds16(fs + q, fv + q);
}

// The chain over one group of kRecGroup lanes (as, fs, ys: its first
// lane, 16-byte aligned).  Every lane of the warp runs it: lane q's
// inputs come by broadcast 16-byte loads (every lane one address) issued
// kAhead lanes ahead of its chain, which never waits on them, and every
// V lanes' y go out by one broadcast 16-byte store.  kAll: every lane
// live, no select on the chain; else `mask` has bit q set for a live lane
// q, which selects as the reference does.
template <typename T, int J, bool kAll>
__device__ __forceinline__ void rec_group(const T* __restrict__ as,
                                          const T* __restrict__ fs,
                                          uint64_t mask, T (&h)[J],
                                          T* __restrict__ ys) {
  constexpr int G = rec_group_lanes(J);
  constexpr int V = 16 / sizeof(T);
  constexpr int D = rec_ahead_lanes(J);
  T av[G * J];
  T fv[G];
  T yv[G];
#pragma unroll
  for (int q = 0; q < D; ++q) rec_fetch<T, J>(as, fs, q, av, fv);
#pragma unroll
  for (int q = 0; q < G; ++q) {
    if (q + D < G) rec_fetch<T, J>(as, fs, q + D, av, fv);
    T acc = fv[q];
#pragma unroll
    for (int j = 0; j < J; ++j) acc = sub_rn(acc, mul_rn(av[q * J + j], h[j]));
    yv[q] = acc;
    if constexpr (kAll) {
#pragma unroll
      for (int j = J - 1; j >= 1; --j) h[j] = h[j - 1];
      h[0] = acc;
    } else {
      const bool lv = (mask >> q) & 1u;
#pragma unroll
      for (int j = J - 1; j >= 1; --j) h[j] = lv ? h[j - 1] : h[j];
      h[0] = lv ? acc : h[0];
      yv[q] = lv ? acc : T(0);
    }
    if (q % V == V - 1) sts16(ys + q - (V - 1), yv + q - (V - 1));
  }
}

// The chain over one stage of m lanes (as, fs, ls, ys: its first lane in
// the stage buffer), run by the whole chain warp.  Each group's live
// bytes, read a group ahead, decide by a ballot a warp's width which body
// it takes (all live, all dead, mixed).  Lanes past the last whole group
// go one at a time, by scalar broadcast loads.
template <typename T, int J>
__device__ __forceinline__ void rec_chain_stage(const T* as, const T* fs,
                                                const uint8_t* ls, T* ys,
                                                int m, T (&h)[J], int lane) {
  constexpr int G = rec_group_lanes(J);
  constexpr int W = G / 32;
  constexpr uint64_t kAllLive = G == 64 ? ~0ull : 0xffffffffull;
  int i = 0;
  bool live[W];
#pragma unroll
  for (int w = 0; w < W; ++w) {
    live[w] = m >= G && ls[32 * w + lane] != 0;
  }
  for (; i + G <= m; i += G) {
    uint64_t mask = 0;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      mask |= (uint64_t)__ballot_sync(kFull, live[w]) << (32 * w);
      const int ahead = i + G + 32 * w + lane;
      live[w] = ls[ahead < m ? ahead : m - 1] != 0;
    }
    if (mask == kAllLive) {
      rec_group<T, J, true>(as + i * J, fs + i, mask, h, ys + i);
    } else if (mask == 0) {
#pragma unroll
      for (int w = 0; w < W; ++w) ys[i + 32 * w + lane] = T(0);
    } else {
      rec_group<T, J, false>(as + i * J, fs + i, mask, h, ys + i);
    }
  }
  for (; i < m; ++i) {
    T acc = fs[i];
#pragma unroll
    for (int j = 0; j < J; ++j) acc = sub_rn(acc, mul_rn(as[i * J + j], h[j]));
    const bool lv = ls[i] != 0;
#pragma unroll
    for (int j = J - 1; j >= 1; --j) h[j] = lv ? h[j - 1] : h[j];
    h[0] = lv ? acc : h[0];
    ys[i] = lv ? acc : T(0);
  }
}

// The head of a row: the lanes before the first whose live byte starts a
// 16-byte grain.
__device__ __forceinline__ int rec_head(const uint8_t* live) {
  return (int)((16 - ((uintptr_t)live & 15)) & 15);
}

// Past the head, a and ff take bulk copies where their lanes align there
// too (any contiguous row, and its [1:] views, do).
template <typename T>
__device__ __forceinline__ bool rec_bulk(const T* a, const T* ff, int head,
                                         int J) {
  return (((uintptr_t)(ff + head) | (uintptr_t)(a + (int64_t)head * J)) &
          15) == 0;
}

// The ring's mbarriers, then a block barrier: `full` completes when the
// producer warp has arrived and its bulk copies have landed, `empty` when
// the chain warp has arrived.
__device__ __forceinline__ void rec_ring_init(uint64_t* full, uint64_t* empty) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < kRecStages; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
}

// The producer warp of one row of the wide form (the chain form's, inline
// in rec_chain_row, does the same): fills
// the ring of kRecStages stage buffers of S lanes (A: a, F: ff, L: live),
// the 16-byte-aligned middle of a stage by three bulk copies (a, ff, live)
// counted on the stage's `full` mbarrier, the lanes outside it (the head,
// a ragged tail, or every lane where the three arrays' lanes are not
// aligned alike) by its 32 threads' loads; it stores each finished
// stage's y (Y), coalesced, once the chain has released the stage
// (`empty`), then refills it.  Without kA (the streamed form, J = 0) it
// stages ff and live only.
template <typename T, bool kA = true>
__device__ __forceinline__ void rec_produce(
    const T* __restrict__ a, const T* __restrict__ ff,
    const uint8_t* __restrict__ live, T* __restrict__ y, int64_t n, int J,
    int S, int head, bool bulk, T* A, T* F, const T* Y, uint8_t* L,
    uint64_t* full, uint64_t* empty, int lane) {
  RecStage fill(n, head), drain(n, head);
  int d = 0;  // stages stored
  auto store = [&]() {
    const int s = d % kRecStages;
    mbar_wait(&empty[s], (unsigned)(d / kRecStages) & 1u);
    T* dst = y + drain.st;
    for (int64_t e = lane; e < drain.len; e += 32) dst[e] = Y[s * S + e];
    drain.next(n, S);
    ++d;
  };
  for (int k = 0; fill.st < n; ++k, fill.next(n, S)) {
    const int s = k % kRecStages;
    if (k >= kRecStages) store();
    const int64_t st = fill.st;
    const int64_t en = st + fill.len;
    // The bulk span [st, b1): the stage's whole grains, where it starts
    // on one (every stage but the head) and the row takes bulk copies.
    const int64_t b1 = bulk && st >= head
        ? st + (fill.len & ~(int64_t)(kRecGrain - 1)) : st;
    T* as = A + s * S * J;
    T* fs = F + s * S;
    uint8_t* ls = L + s * S;
    fence_proxy_async();
    if (lane == 0 && b1 > st) {
      const unsigned m = (unsigned)(b1 - st);
      mbar_expect_tx(&full[s], m * (unsigned)((J + 1) * sizeof(T) + 1));
      if constexpr (kA) bulk_load(as, a + st * J, m * J * sizeof(T), &full[s]);
      bulk_load(fs, ff + st, m * sizeof(T), &full[s]);
      bulk_load(ls, live + st, m, &full[s]);
    }
    // The lanes past the span, flat and coalesced.
    {
      const int64_t lo = b1;
      const int64_t hi = en;
      const int64_t o = lo - st;
      for (int64_t e = lane; e < (hi - lo) * J; e += 32) {
        as[o * J + e] = a[lo * J + e];
      }
      for (int64_t e = lane; e < hi - lo; e += 32) {
        fs[o + e] = ff[lo + e];
        ls[o + e] = live[lo + e];
      }
    }
    mbar_arrive(&full[s]);
  }
  while (drain.st < n) store();
}

// One row, history in registers (J <= 16).  Warp 1, the producer, fills a
// ring of kRecStages stage buffers: the 16-byte-aligned middle of a stage
// by three bulk copies (a, ff, live) counted on the stage's `full`
// mbarrier, the lanes outside it (the head, a ragged tail, or every lane
// where the three arrays' lanes are not aligned alike) by its 32 threads'
// loads; it stores each finished stage's y, coalesced, once the chain has
// released the stage (`empty`), then refills it.  Warp 0 runs the chain.
// No block barrier after set-up.
template <typename T, int J>
__device__ __forceinline__ void rec_chain_row(
    const T* __restrict__ a, const T* __restrict__ ff,
    const uint8_t* __restrict__ live, const T* __restrict__ h0,
    T* __restrict__ y, T* __restrict__ hist, int64_t n, unsigned char* raw,
    uint64_t* full, uint64_t* empty) {
  constexpr int S = rec_stage_lanes(J, sizeof(T));
  T* A = reinterpret_cast<T*>(raw);
  T* F = A + kRecStages * S * J;
  T* Y = F + kRecStages * S;
  uint8_t* L = reinterpret_cast<uint8_t*>(Y + kRecStages * S);
  // The head: the lanes before the first whose live byte starts a 16-byte
  // grain.  Past it, a and ff take bulk copies where their lanes align
  // there too (any contiguous row, and its [1:] views, do).
  const int head = (int)((16 - ((uintptr_t)live & 15)) & 15);
  const bool bulk =
      (((uintptr_t)(ff + head) | (uintptr_t)(a + (int64_t)head * J)) & 15) == 0;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kRecStages; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == 1) {
    RecStage fill(n, head), drain(n, head);
    int d = 0;  // stages stored
    auto store = [&]() {
      const int s = d % kRecStages;
      mbar_wait(&empty[s], (unsigned)(d / kRecStages) & 1u);
      const T* ys = Y + s * S;
      for (int64_t e = lane; e < drain.len; e += 32) y[drain.st + e] = ys[e];
      drain.next(n, S);
      ++d;
    };
    for (int k = 0; fill.st < n; ++k, fill.next(n, S)) {
      const int s = k % kRecStages;
      if (k >= kRecStages) store();
      const int64_t st = fill.st;
      const int64_t en = st + fill.len;
      // The bulk span [st, b1): the stage's whole grains, where it starts
      // on one (every stage but the head) and the row takes bulk copies.
      const int64_t b1 = bulk && st >= head
          ? st + (fill.len & ~(int64_t)(kRecGrain - 1)) : st;
      T* as = A + s * S * J;
      T* fs = F + s * S;
      uint8_t* ls = L + s * S;
      fence_proxy_async();
      if (lane == 0 && b1 > st) {
        const unsigned m = (unsigned)(b1 - st);
        mbar_expect_tx(&full[s], m * (unsigned)((J + 1) * sizeof(T) + 1));
        bulk_load(as, a + st * J, m * J * sizeof(T), &full[s]);
        bulk_load(fs, ff + st, m * sizeof(T), &full[s]);
        bulk_load(ls, live + st, m, &full[s]);
      }
      // The lanes past the span, flat and coalesced.
      {
        const int64_t lo = b1;
        const int64_t hi = en;
        const int64_t o = lo - st;
        for (int64_t e = lane; e < (hi - lo) * J; e += 32) {
          as[o * J + e] = a[lo * J + e];
        }
        for (int64_t e = lane; e < hi - lo; e += 32) {
          fs[o + e] = ff[lo + e];
          ls[o + e] = live[lo + e];
        }
      }
      mbar_arrive(&full[s]);
    }
    while (drain.st < n) store();
  } else {
    T h[J];
#pragma unroll
    for (int j = 0; j < J; ++j) h[j] = h0[j];
    RecStage st(n, head);
    for (; st.st < n; st.next(n, S)) {
      const int s = st.k % kRecStages;
      mbar_wait(&full[s], (unsigned)(st.k / kRecStages) & 1u);
      rec_chain_stage<T, J>(A + s * S * J, F + s * S, L + s * S, Y + s * S,
                            (int)st.len, h, lane);
      mbar_arrive(&empty[s]);
    }
    if (lane == 0) {
#pragma unroll
      for (int j = 0; j < J; ++j) hist[j] = h[j];
    }
  }
}

// The wide form (kRecRegJ < J <= kRecWideMaxJ, one kernel for every such
// J).  The chain form's ring of stages, producer warp and chain warp,
// whose 32 threads all run the chain; but the history is a buffer in
// shared memory and most of a lane's inputs are made ahead of it:
//   * the history buffer Hb holds the outputs of live lanes, oldest first
//     (h0 reversed, then each live lane's y; a dead lane appends nothing),
//     moved to its front when a stage would run past it; its two newest
//     values also sit in registers, h0r and h1r;
//   * lane x's chain: acc = ff - a[0] * h[0] (h0r), then - a[1] * h[1],
//     then the products a[j] * h[j] for j = 2 .. J - 1 in order: J + 1
//     roundings, the chain model.  Only the first product waits on lane x
//     - 1's output.  ff, a[0] and a[1] * h[1] are formed by every thread a
//     lane ahead; the later products two lanes ahead by the warp's
//     threads together (thread t the products t, t + 32, t + 64: its loads
//     of a and Hb at the start of lane x - 2, coalesced; its product and
//     store at that lane's end, then one __syncwarp), each rounded on its
//     own as the reference rounds it, into one of four buffers in turn;
//   * the chain reads the products by broadcast 16-byte loads.  A runtime
//     loop over them runs ~7 cycles an f32 op on this card where
//     straight-line code runs ~4.1, so up to kRecWideUnrolledJ (J - 2 <=
//     32) a lane's products run unrolled from four register sets, each
//     reloaded four chunks ahead, the last four with the next lane's first
//     four: a window of 16, 24 or 32 items that ends with the products,
//     led by zeros (acc - (+0) is acc, bit for bit).  Deeper rows loop;
//   * a ballot of 32 live bytes a group: an all-live group runs with no
//     branch a lane, an all-dead one writes zeros, a mixed one runs a live
//     lane's chain and skips a dead one's (y = 0, the history as it was);
//     no select on the chain.
constexpr int kRecWideMaxJ = 95;
// Up to this depth a lane's products (at most 32: one a thread) run
// unrolled from registers; deeper, by a loop over the window's chunks.
constexpr int kRecWideUnrolledJ = 34;
// Shared memory the wide form takes at most: it sizes its stages to this.
constexpr int kRecWideBudget = 200 * 1024;
constexpr int kRecWideBufs = 4;   // product buffers
constexpr int kRecWidePs = 100;   // items a buffer: its window, then the
                                  // item dropped products are stored to

// 16-byte chunks of the looped form's window: room for kRecWideMaxJ - 2
// products.
__host__ __device__ constexpr int rec_wide_chunks(int item) {
  return (kRecWideMaxJ - 2 + 16 / item - 1) / (16 / item);
}

static_assert(rec_wide_chunks(4) * 4 < kRecWidePs &&
                  rec_wide_chunks(8) * 2 < kRecWidePs && kRecWidePs % 4 == 0,
              "a product buffer holds its window and the dropped item");

// Bytes of the wide form's shared memory at depth J with stages of S
// lanes: the ring of stages (a, ff, y, live), the product buffers, the
// history (2J + S values: a stage appends at most S to the newest J).
__host__ __device__ constexpr int64_t rec_wide_bytes(int J, int S, int item) {
  return (int64_t)kRecStages * S * rec_lane_bytes(J, item) +
         (int64_t)item * (kRecWideBufs * kRecWidePs + 2 * J + S);
}

// Lanes of a full stage of the wide form: the largest power of two from
// kRecFirst up to kRecMaxStage whose shared memory fits kRecWideBudget.
__host__ __device__ constexpr int rec_wide_stage_lanes(int J, int item) {
  int s = kRecMaxStage;
  while (s > kRecFirst && rec_wide_bytes(J, s, item) > kRecWideBudget) {
    s >>= 1;
  }
  return s;
}

static_assert(rec_wide_bytes(kRecWideMaxJ, kRecFirst, 8) <= kRecWideBudget,
              "the wide form's deepest f64 row fits the budget");

// Lane x's products, formed by thread `lane` of the chain warp: entry k =
// 32 s + lane (s < kSlots) is a[x, k + 2] times h[k + 2] = ht[-3 - k] (ht:
// one past the newest history entry lane x sees).  kk[s]: the thread's k,
// cut at J - 3 (a thread past the products loads entry J - 3's factors).
// Product k goes to item W - (J - 2) + k of the buffer (W: the window's
// items), so the last ends the window; every thread stores, a dropped
// product to item kRecWidePs - 1.
template <typename T, int kSlots>
struct RecWideIn {
  T v[kSlots];
  T h[kSlots];
};

template <typename T, int kSlots>
__device__ __forceinline__ RecWideIn<T, kSlots> rec_wide_get(
    const T* ax, const T* ht, const int (&kk)[kSlots]) {
  RecWideIn<T, kSlots> in;
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    in.v[s] = ax[kk[s] + 2];
    in.h[s] = ht[-3 - kk[s]];
  }
  return in;
}

template <typename T, int kSlots>
__device__ __forceinline__ void rec_wide_put(const RecWideIn<T, kSlots>& in,
                                             T* P, bool keep, int W, int J,
                                             int lane) {
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int k = 32 * s + lane;
    P[keep && k < J - 2 ? W - (J - 2) + k : kRecWidePs - 1] =
        mul_rn(in.v[s], in.h[s]);
  }
}

// The chain's register sets: chunk c of a window sits in q[c % 4].
template <typename T>
using RecWideQ = T[4][16 / sizeof(T)];

// Loads the first four chunks of the window P (from chunk 0) into their
// register sets.
template <typename T>
__device__ __forceinline__ void rec_wide_first(const T* P, RecWideQ<T>& q) {
#pragma unroll
  for (int s = 0; s < 4; ++s) lds16(P + s * (16 / sizeof(T)), q[s]);
}

// acc minus a lane's products.  kNQ > 0: the window is kNQ chunks, in
// registers four chunks ahead, unrolled: each set reloaded with chunk c +
// 4 as chunk c is done, the last four with the next lane's first four
// (Pn).  kNQ = 0: the window's chunks from `first` to `last` by a loop.
template <typename T, int kNQ>
__device__ __forceinline__ T rec_wide_run(T acc, RecWideQ<T>& q,
                                          const T* Px, const T* Pn,
                                          int first, int last) {
  constexpr int V = 16 / sizeof(T);
  if constexpr (kNQ > 0) {
#pragma unroll
    for (int c = 0; c < kNQ; ++c) {
#pragma unroll
      for (int k = 0; k < V; ++k) acc = sub_rn(acc, q[c % 4][k]);
      lds16(c + 4 < kNQ ? Px + (c + 4) * V : Pn + (c % 4) * V, q[c % 4]);
    }
  } else {
    for (int c = first; c < last; ++c) {
      T z[V];
      lds16(Px + c * V, z);
#pragma unroll
      for (int k = 0; k < V; ++k) acc = sub_rn(acc, z[k]);
    }
  }
  return acc;
}

// A lane's inputs held in registers ahead of its chain: ff, a[0], a[1] *
// h[1]; with kNQ > 0, its products' first four chunks sit in the register
// sets.
template <typename T>
struct RecWideRegs {
  T ff, a0, p1;
};

// Lane x of a stage in the wide form, run by the whole chain warp.  On
// entry r (and q) hold lane x's registers, buffer Px its products; Pn
// holds lane x + 1's (formed a lane ago); a1, f1: lane x + 1's a row and
// ff, a2 lane x + 2's a row; ht one past the newest history entry.  It
// loads lane x + 1's registers, forms lane x + 2's products into Pf
// (keep2: the stage has that lane; live1: lane x + 1 is live) and, if
// live, runs lane x's chain (else y = 0 and the history stays).  kAll:
// lane x is live, with no branch, so that its loads and products
// interleave with the chain.
template <typename T, int kSlots, int kNQ, bool kAll>
__device__ __forceinline__ void rec_wide_lane(
    bool live, const T* a1, const T* f1, const T* a2, T* yx, T*& ht, T& h0r,
    T& h1r, RecWideRegs<T>& r, RecWideQ<T>& q, const T* Px, const T* Pn,
    T* Pf, bool keep2, int live1, int W, int first, int J,
    const int (&kk)[kSlots], int lane) {
  const T ff1 = *f1;
  const T a01 = a1[0];
  const T a11 = a1[1];
  const RecWideIn<T, kSlots> in =
      rec_wide_get<T, kSlots>(a2, ht + (live ? 1 : 0) + live1, kk);
  if (kAll || live) {
    T acc = sub_rn(r.ff, mul_rn(r.a0, h0r));
    acc = sub_rn(acc, r.p1);
    acc = rec_wide_run<T, kNQ>(acc, q, Px, Pn, first,
                               W / (16 / (int)sizeof(T)));
    *yx = acc;
    *ht++ = acc;
    r.p1 = mul_rn(a11, h0r);  // lane x + 1's h[1] is lane x's h[0]
    h1r = h0r;
    h0r = acc;
  } else {
    if constexpr (kNQ > 0) rec_wide_first<T>(Pn, q);
    *yx = T(0);
    r.p1 = mul_rn(a11, h1r);
  }
  rec_wide_put<T, kSlots>(in, Pf, keep2, W, J, lane);
  __syncwarp();
  r.ff = ff1;
  r.a0 = a01;
}

// The chain over one stage of m lanes in the wide form (as, fs, ls, ys:
// its first lane in the stage buffer), 32-lane groups at a time.  b: the
// product buffer of the next lane, advanced a lane at a time; ht: one past
// the newest history entry; W items a window, its products' chunks from
// `first`.  Reads past the stage's lanes (of the lanes after its last two)
// stay in shared memory and reach no output.
template <typename T, int kSlots, int kNQ>
__device__ __forceinline__ void rec_wide_stage(const T* as, const T* fs,
                                               const uint8_t* ls, T* ys,
                                               int m, int J, int W, int first,
                                               T*& ht, T& h0r, T& h1r, T* P,
                                               int& b, int lane) {
  int kk[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) kk[s] = min(32 * s + lane, J - 3);
  RecWideRegs<T> r;
  RecWideQ<T> q;
  auto buf = [&](int i) { return P + (i % kRecWideBufs) * kRecWidePs; };
  // Lanes x's and x + 1's products into buffers b and b + 1, lane x's
  // registers, from the history as it stands (live0: lane x is live).
  auto prime = [&](int x, int live0) {
    T* Pb = buf(b);
    __syncwarp();
    rec_wide_put<T, kSlots>(rec_wide_get<T, kSlots>(as + x * J, ht, kk), Pb,
                            true, W, J, lane);
    rec_wide_put<T, kSlots>(
        rec_wide_get<T, kSlots>(as + (x + 1) * J, ht + live0, kk),
        buf(b + 1), x + 1 < m, W, J, lane);
    r.ff = fs[x];
    r.a0 = as[x * J];
    r.p1 = mul_rn(as[x * J + 1], h1r);
    __syncwarp();
    if constexpr (kNQ > 0) rec_wide_first<T>(Pb, q);
  };
  unsigned mask = __ballot_sync(kFull, lane < m && ls[lane] != 0);
  prime(0, mask & 1u);
  for (int g = 0; g < m; g += 32) {
    const int len = min(32, m - g);
    const int g2 = g + 32;
    const unsigned next =
        __ballot_sync(kFull, g2 + lane < m && ls[g2 + lane] != 0);
    if (mask == 0) {
      if (lane < len) ys[g + lane] = T(0);
      if (g2 < m) prime(g2, next & 1u);
      mask = next;
      continue;
    }
    const uint64_t M = mask | (uint64_t)next << 32;
    const T* Px = buf(b);
    const T* Pn = buf(b + 1);
    T* Pf = buf(b + 2);
    const T* a1 = as + (g + 1) * J;
    auto step = [&]() {
      a1 += J;
      Px = Pn;
      Pn = Pf;
      Pf = buf(++b + 2);
    };
    if (mask == (len == 32 ? kFull : (1u << len) - 1u)) {
      for (int q0 = 0; q0 < len; ++q0) {
        const int x = g + q0;
        rec_wide_lane<T, kSlots, kNQ, true>(
            true, a1, fs + x + 1, a1 + J, ys + x, ht, h0r, h1r, r, q, Px, Pn,
            Pf, x + 2 < m, (int)((M >> (q0 + 1)) & 1u), W, first, J, kk,
            lane);
        step();
      }
    } else {
      for (int q0 = 0; q0 < len; ++q0) {
        const int x = g + q0;
        rec_wide_lane<T, kSlots, kNQ, false>(
            (M >> q0) & 1u, a1, fs + x + 1, a1 + J, ys + x, ht, h0r, h1r, r,
            q, Px, Pn, Pf, x + 2 < m, (int)((M >> (q0 + 1)) & 1u), W, first,
            J, kk, lane);
        step();
      }
    }
    mask = next;
  }
}

// One row of the wide form: warp 1 the producer (rec_produce, stages of
// rec_wide_stage_lanes), warp 0 the chain.  Shared memory: the ring (a,
// ff, y, live), then the product buffers, then the history.  kNQ > 0: a
// window of kNQ chunks (the products of J <= kRecWideNQ's rows), else
// rec_wide_chunks.
template <typename T, int kSlots, int kNQ>
__device__ __forceinline__ void rec_wide_row(
    const T* __restrict__ a, const T* __restrict__ ff,
    const uint8_t* __restrict__ live, const T* __restrict__ h0,
    T* __restrict__ y, T* __restrict__ hist, int64_t n, int J,
    unsigned char* raw, uint64_t* full, uint64_t* empty) {
  constexpr int V = 16 / sizeof(T);
  rec_ring_init(full, empty);
  const int S = rec_wide_stage_lanes(J, sizeof(T));
  T* A = reinterpret_cast<T*>(raw);
  T* F = A + kRecStages * S * J;
  T* Y = F + kRecStages * S;
  uint8_t* L = reinterpret_cast<uint8_t*>(Y + kRecStages * S);
  T* P = reinterpret_cast<T*>(L + kRecStages * S);
  T* Hb = P + kRecWideBufs * kRecWidePs;
  const int head = rec_head(live);
  const int lane = threadIdx.x & 31;
  if (threadIdx.x >= 32) {
    rec_produce<T>(a, ff, live, y, n, J, S, head, rec_bulk(a, ff, head, J),
                   A, F, Y, L, full, empty, lane);
    return;
  }
  const int W = (kNQ > 0 ? kNQ : rec_wide_chunks(sizeof(T))) * V;
  const int first = W / V - (J - 2 + V - 1) / V;
  for (int e = lane; e < J; e += 32) Hb[e] = h0[J - 1 - e];
  // The windows' leading items stay 0: only products are stored later.
  for (int e = lane; e < kRecWideBufs * kRecWidePs; e += 32) P[e] = T(0);
  T h0r = h0[0];
  T h1r = h0[1];
  T* ht = Hb + J;  // one past the newest history entry
  int b = 0;
  for (RecStage sg(n, head); sg.st < n; sg.next(n, S)) {
    const int s = sg.k % kRecStages;
    mbar_wait(&full[s], (unsigned)(sg.k / kRecStages) & 1u);
    const int m = (int)sg.len;
    if (ht + m > Hb + 2 * J + S) {
      // The newest J entries to the front (more than 2J: no overlap).
      __syncwarp();
      for (int e = lane; e < J; e += 32) Hb[e] = ht[e - J];
      ht = Hb + J;
    }
    rec_wide_stage<T, kSlots, kNQ>(A + s * S * J, F + s * S, L + s * S,
                                   Y + s * S, m, J, W, first, ht, h0r, h1r,
                                   P, b, lane);
    mbar_arrive(&empty[s]);
  }
  __syncwarp();
  for (int j = lane; j < J; j += 32) hist[j] = ht[-1 - j];
}

// The streamed form (kRecWideMaxJ < J <= kRecMaxJ, one kernel for every
// such J).  The wide form's shape, but a lane's a row (J values, 384
// bytes or more) no longer fits a ring of stages, so a is not staged with
// the stages:
//   * warp 1 stages ff and live through the ring of stages and stores y
//     (rec_produce without a); warp 2 streams a, block after block of the
//     rows of rec_stream_block_lanes lanes (the 16-byte grains that cover
//     them, by one 1-D bulk copy), into a ring of rec_stream_bufs buffers,
//     each on its own `full` and `empty` mbarrier;
//   * the chain warp runs lane x's chain, acc = ff - a[0] h[0] - a[1] h[1]
//     (a lane ahead, in registers), then the products a[j] h[j] for j = 2
//     .. J - 1 in order by broadcast 16-byte loads four chunks ahead, in a
//     loop unrolled over 32 products: J + 1 roundings, the chain model;
//   * meanwhile its 32 threads form lane x + 1's products (thread t the
//     products t + 2, t + 34, ...: coalesced shared loads of that lane's a
//     row and of the history, one product a thread per 32 products of the
//     chain), each rounded on its own as the reference rounds it, into the
//     other of two product buffers; a product of lane x + 1 needs only
//     outputs before lane x;
//   * the history is the wide form's buffer of live lanes' outputs; a dead
//     lane skips its chain and appends nothing, and a lane's products are
//     formed only if it is live.
// Shared memory a block of the streamed form takes at most: it sizes its
// a buffers and stages to this.
constexpr int kRecStreamBudget = 200 * 1024;
constexpr int kRecStreamThreads = 96;   // chain, stage producer, a streamer
constexpr int kRecStreamBufs = 4;       // a buffers, at most
constexpr int kRecStreamMinBufs = 2;    // and at least
constexpr int kRecStreamRowBytes = 4096;  // a block of a rows: at least
                                          // this many bytes, or one lane
constexpr int kRecStreamBars = 128;     // bytes of the a buffers' mbarriers

// Lanes of a block of a rows.
__host__ __device__ constexpr int rec_stream_block_lanes(int J, int item) {
  return kRecStreamRowBytes / (J * item) > 1 ? kRecStreamRowBytes / (J * item)
                                             : 1;
}

// Bytes of an a buffer: a block's rows, rounded out to 16-byte grains.
__host__ __device__ constexpr int64_t rec_stream_block_bytes(int J, int item) {
  return ((int64_t)rec_stream_block_lanes(J, item) * J * item + 15) / 16 * 16 +
         32;
}

// Items of a product buffer: a lane's J - 2 products, 32 a slot, and
// zeros past them (acc - (+0) is acc, bit for bit).
__host__ __device__ constexpr int rec_stream_window(int J) {
  return (J - 2 + 31) / 32 * 32;
}

// Bytes of the streamed form's shared memory at depth J with stages of S
// lanes and NA a buffers: the mbarriers, two product buffers, the a
// buffers, the ring of stages (ff, y, live) and the history (2J + S
// values, as the wide form's).
__host__ __device__ constexpr int64_t rec_stream_bytes(int J, int S, int NA,
                                                       int item) {
  return kRecStreamBars + 2LL * rec_stream_window(J) * item +
         NA * rec_stream_block_bytes(J, item) +
         (int64_t)kRecStages * S * (2 * item + 1) + (int64_t)(2 * J + S) * item;
}

// a buffers at depth J: kRecStreamBufs, halved down to kRecStreamMinBufs
// while the smallest stages do not fit kRecStreamBudget.
__host__ __device__ constexpr int rec_stream_bufs(int J, int item) {
  int na = kRecStreamBufs;
  while (na > kRecStreamMinBufs &&
         rec_stream_bytes(J, kRecFirst, na, item) > kRecStreamBudget) {
    na >>= 1;
  }
  return na;
}

// Lanes of a full stage of the streamed form: the largest power of two
// from kRecFirst up to kRecMaxStage that fits kRecStreamBudget.
__host__ __device__ constexpr int rec_stream_stage_lanes(int J, int item) {
  int s = kRecMaxStage;
  while (s > kRecFirst &&
         rec_stream_bytes(J, s, rec_stream_bufs(J, item), item) >
             kRecStreamBudget) {
    s >>= 1;
  }
  return s;
}

static_assert(rec_stream_bytes(kRecMaxJ, kRecFirst, kRecStreamMinBufs, 8) <=
                  kRecStreamBudget,
              "the streamed form's deepest f64 row fits the budget");
static_assert(2 * kRecStreamBufs * 8 <= kRecStreamBars,
              "the a buffers' mbarriers fit their bytes");

// The a streamer (one thread of warp 2): block q's rows, lanes [q La, (q
// + 1) La), into buffer q % NA once the chain has released its last block
// (`empty`), by one bulk copy of the grains that cover them, counted on
// the buffer's `full` mbarrier.
template <typename T>
__device__ __forceinline__ void rec_stream_a(const T* __restrict__ a, int64_t n,
                                             int J, int La, int NA,
                                             int64_t RB, unsigned char* A,
                                             uint64_t* full, uint64_t* empty) {
  int s = 0;          // the buffer of block x0 / La
  unsigned ph = 0;    // the phase of its `empty` to wait for
  bool again = false;  // every buffer filled once
  for (int64_t x0 = 0; x0 < n; x0 += La) {
    if (again) mbar_wait(&empty[s], ph);
    const uintptr_t src = (uintptr_t)(a + x0 * J);
    const uintptr_t lo = src & ~(uintptr_t)15;
    const uintptr_t hi =
        (src + (uintptr_t)(lmin(La, n - x0) * J * sizeof(T)) + 15) &
        ~(uintptr_t)15;
    fence_proxy_async();
    mbar_expect_tx(&full[s], (unsigned)(hi - lo));
    bulk_load(A + s * RB, reinterpret_cast<const void*>(lo),
              (unsigned)(hi - lo), &full[s]);
    mbar_arrive(&full[s]);
    if (++s == NA) {
      s = 0;
      ph ^= again ? 1u : 0u;
      again = true;
    }
  }
}

// The chain warp's view of the a stream: each lane's row in turn, waiting
// for its block's copy at the block's first lane and releasing the block
// after its last.
template <typename T>
struct RecStreamRows {
  const T* a;
  const unsigned char* A;
  uint64_t* full;
  uint64_t* empty;
  int64_t n, RB;
  int J, La, NA;
  int64_t x0 = 0;    // the first lane of the next lane's block
  int i = 0;         // the next lane's place in it
  int s = 0;         // the block's buffer
  unsigned ph = 0;   // and the phase of its `full`
  int64_t seen = 0;  // lanes given
  const T* base = nullptr;

  // The next lane's a row.
  __device__ __forceinline__ const T* next() {
    if (i == 0) {
      mbar_wait(&full[s], ph);
      base = reinterpret_cast<const T*>(A + s * RB) +
             ((uintptr_t)(a + x0 * J) & 15) / sizeof(T);
    }
    ++seen;
    return base + (int64_t)i * J;
  }

  // Done with the row next() gave last.
  __device__ __forceinline__ void done() {
    if (++i == La || seen == n) {
      mbar_arrive(&empty[s]);
      i = 0;
      x0 += La;
      if (++s == NA) {
        s = 0;
        ph ^= 1u;
      }
    }
  }
};

// acc minus chunks [c0, c0 + 32 / V) of a lane's products Px (kLast: only
// those below nc), each from its register set in q, which is reloaded
// with the chunk four on as its own is done.
template <typename T, bool kLast>
__device__ __forceinline__ T rec_stream_chunks(T acc, RecWideQ<T>& q,
                                               const T* Px, int c0, int nc) {
  constexpr int V = 16 / sizeof(T);
#pragma unroll
  for (int c = 0; c < 32 / V; ++c) {
    if (!kLast || c0 + c < nc) {
#pragma unroll
      for (int k = 0; k < V; ++k) acc = sub_rn(acc, q[c % 4][k]);
    }
    lds16(Px + (c0 + c + 4) * V, q[c % 4]);
  }
  return acc;
}

// Slot s of lane x's chain and of lane x + 1's products (rec_stream_run):
// a thread's product j = 2 + 32 s + lane, loaded before the slot's 32
// products of the chain, formed and stored after them.
template <typename T, bool kChain, bool kForm, bool kLast>
__device__ __forceinline__ T rec_stream_slot(T acc, RecWideQ<T>& q,
                                             const T* Px, T* Pn, const T* a1,
                                             const T* hb, int J, int s,
                                             int nc, int lane) {
  constexpr int V = 16 / sizeof(T);
  const int j = 2 + 32 * s + lane;
  const int jj = min(j, J - 1);
  T av = T(0), hv = T(0);
  if constexpr (kForm) {
    av = a1[jj];
    hv = hb[-jj];
  }
  if constexpr (kChain) {
    acc = rec_stream_chunks<T, kLast>(acc, q, Px, s * (32 / V), nc);
  }
  if constexpr (kForm) {
    if (j < J) Pn[j - 2] = mul_rn(av, hv);
  }
  return acc;
}

// kChain: acc minus lane x's products Px in order (its first four chunks
// already in q); kForm: lane x + 1's products into Pn, product j from its
// a row a1 and hb[-j] (its h[j]).  The last slot, whose chunks may end
// early, runs outside the loop: inside it, a branch a slot that picked
// the slot's body slowed every slot.
template <typename T, bool kChain, bool kForm>
__device__ __forceinline__ T rec_stream_run(T acc, RecWideQ<T>& q,
                                            const T* Px, T* Pn, const T* a1,
                                            const T* hb, int J, int lane) {
  constexpr int V = 16 / sizeof(T);
  const int slots = (J - 2 + 31) / 32;
  const int nc = (J - 2 + V - 1) / V;
  int s = 0;
  for (; s + 1 < slots; ++s) {
    acc = rec_stream_slot<T, kChain, kForm, false>(acc, q, Px, Pn, a1, hb, J,
                                                   s, nc, lane);
  }
  return rec_stream_slot<T, kChain, kForm, true>(acc, q, Px, Pn, a1, hb, J, s,
                                                 nc, lane);
}

// One lane x of a stage in the streamed form, run by the whole chain
// warp.  On entry r holds its ff, a[0] and a[1] h[1], Px its products (q
// their first four chunks); a1 is lane x + 1's a row (any shared address
// past the stage), ff1 its ff, live1 whether it is live; ht one past the
// newest history entry.  Runs lane x's chain if it is live (else y = 0
// and the history stays), forms lane x + 1's products into Pn and its
// registers if it is live.
template <typename T>
__device__ __forceinline__ void rec_stream_lane(
    bool live, bool live1, const T* a1, T ff1, T* yx, T*& ht, T& h0r, T& h1r,
    RecWideRegs<T>& r, RecWideQ<T>& q, const T* Px, T* Pn, int J,
    int lane) {
  const T a01 = a1[0];
  const T a11 = a1[1];
  if (live) {
    T acc = sub_rn(r.ff, mul_rn(r.a0, h0r));
    acc = sub_rn(acc, r.p1);
    // Lane x + 1's h[j] is lane x's h[j - 1], ht[-j].
    acc = live1
        ? rec_stream_run<T, true, true>(acc, q, Px, Pn, a1, ht, J, lane)
        : rec_stream_run<T, true, false>(acc, q, Px, Pn, a1, ht, J, lane);
    *yx = acc;
    *ht++ = acc;
    r.p1 = mul_rn(a11, h0r);  // lane x + 1's h[1] is lane x's h[0]
    h1r = h0r;
    h0r = acc;
  } else {
    *yx = T(0);
    // Lane x + 1's history is lane x's: h[j] = ht[-1 - j].
    if (live1) {
      rec_stream_run<T, false, true>(T(0), q, Px, Pn, a1, ht - 1, J, lane);
    }
    r.p1 = mul_rn(a11, h1r);
  }
  r.ff = ff1;
  r.a0 = a01;
}

// One row of the streamed form: warp 1 the stage producer (rec_produce
// without a, stages of rec_stream_stage_lanes), warp 2 the a streamer,
// warp 0 the chain.  Shared memory: the a buffers' mbarriers, the two
// product buffers, the a buffers, the ring (ff, y, live), the history.
template <typename T>
__device__ __forceinline__ void rec_stream_row(
    const T* __restrict__ a, const T* __restrict__ ff,
    const uint8_t* __restrict__ live, const T* __restrict__ h0,
    T* __restrict__ y, T* __restrict__ hist, int64_t n, int J,
    unsigned char* raw, uint64_t* full, uint64_t* empty) {
  constexpr int item = sizeof(T);
  const int NA = rec_stream_bufs(J, item);
  const int S = rec_stream_stage_lanes(J, item);
  const int La = rec_stream_block_lanes(J, item);
  const int64_t RB = rec_stream_block_bytes(J, item);
  const int W = rec_stream_window(J);
  uint64_t* afull = reinterpret_cast<uint64_t*>(raw);
  uint64_t* aempty = afull + kRecStreamBufs;
  T* P = reinterpret_cast<T*>(raw + kRecStreamBars);
  unsigned char* A = reinterpret_cast<unsigned char*>(P + 2 * W);
  T* F = reinterpret_cast<T*>(A + NA * RB);
  T* Y = F + kRecStages * S;
  uint8_t* L = reinterpret_cast<uint8_t*>(Y + kRecStages * S);
  T* Hb = reinterpret_cast<T*>(L + kRecStages * S);
  const int head = rec_head(live);
  const int role = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < NA; ++s) {
      mbar_init(&afull[s], 1);
      mbar_init(&aempty[s], 32);
    }
  }
  rec_ring_init(full, empty);
  if (role == 1) {
    rec_produce<T, false>(a, ff, live, y, n, 0, S, head,
                          ((uintptr_t)(ff + head) & 15) == 0, nullptr, F, Y,
                          L, full, empty, lane);
    return;
  }
  if (role == 2) {
    if (lane == 0) rec_stream_a<T>(a, n, J, La, NA, RB, A, afull, aempty);
    return;
  }
  for (int e = lane; e < J; e += 32) Hb[e] = h0[J - 1 - e];
  // Past a lane's products the windows stay 0: only products are stored.
  for (int e = lane; e < 2 * W; e += 32) P[e] = T(0);
  T h0r = h0[0];
  T h1r = h0[1];
  T* ht = Hb + J;  // one past the newest history entry
  int b = 0;       // the product buffer of the next lane
  RecStreamRows<T> rows{a, A, afull, aempty, n, RB, J, La, NA};
  RecWideRegs<T> r{T(0), T(0), T(0)};
  RecWideQ<T> q;
  for (RecStage sg(n, head); sg.st < n; sg.next(n, S)) {
    const int s = sg.k % kRecStages;
    mbar_wait(&full[s], (unsigned)(sg.k / kRecStages) & 1u);
    const int m = (int)sg.len;
    const T* fs = F + s * S;
    const uint8_t* ls = L + s * S;
    T* ys = Y + s * S;
    __syncwarp();
    if (ht + m > Hb + 2 * J + S) {
      // The newest J entries to the front (more than 2J: no overlap).
      for (int e = lane; e < J; e += 32) Hb[e] = ht[e - J];
      ht = Hb + J;
      __syncwarp();
    }
    // The live bytes of 32 lanes a ballot, a group ahead.
    unsigned mask = __ballot_sync(kFull, lane < m && ls[lane] != 0);
    // The stage's first lane: its registers and products from the
    // history as it stands.
    {
      const T* a0 = rows.next();
      if (mask & 1u) {
        r.ff = fs[0];
        r.a0 = a0[0];
        r.p1 = mul_rn(a0[1], h1r);
        rec_stream_run<T, false, true>(T(0), q, nullptr, P + (b & 1) * W,
                                       a0, ht - 1, J, lane);
      }
      rows.done();
      __syncwarp();
      rec_wide_first<T>(P + (b & 1) * W, q);
    }
    for (int g = 0; g < m; g += 32) {
      const int g2 = g + 32;
      const unsigned next =
          __ballot_sync(kFull, g2 + lane < m && ls[g2 + lane] != 0);
      const uint64_t M = mask | (uint64_t)next << 32;
      const int len = min(32, m - g);
      for (int k = 0; k < len; ++k, ++b) {
        const int x = g + k;
        const bool more = x + 1 < m;
        T* Pn = P + ((b + 1) & 1) * W;
        // Past the stage a1 and ff1 are read but not used.
        rec_stream_lane<T>((M >> k) & 1u, (M >> (k + 1)) & 1u,
                           more ? rows.next() : P, fs[x + 1], ys + x, ht,
                           h0r, h1r, r, q, P + (b & 1) * W, Pn, J, lane);
        if (more) rows.done();
        __syncwarp();
        // The next lane's first four chunks, in flight while the next
        // lane's registers and a row are found.
        rec_wide_first<T>(Pn, q);
      }
      mask = next;
    }
    mbar_arrive(&empty[s]);
  }
  __syncwarp();
  for (int j = lane; j < J; j += 32) hist[j] = ht[-1 - j];
}

// One block a row.  kJ > 0: the chain form, history in registers; kJ = 0:
// any deeper J, the wide form up to kRecWideMaxJ, the streamed form past
// it.
template <typename T, int kJ>
__global__ void __launch_bounds__(kRecStreamThreads)
linear_recurrence(const T* __restrict__ a_all, const T* __restrict__ ff_all,
                  const uint8_t* __restrict__ live_all,
                  const T* __restrict__ h0_all, T* __restrict__ y_all,
                  T* __restrict__ hist_all, int64_t n, int J) {
  extern __shared__ __align__(128) unsigned char rec_raw[];
  __shared__ uint64_t rec_full[kRecStages];
  __shared__ uint64_t rec_empty[kRecStages];
  const int64_t r = blockIdx.x;
  if constexpr (kJ > 0) {
    rec_chain_row<T, kJ>(a_all + r * n * kJ, ff_all + r * n, live_all + r * n,
                         h0_all + r * kJ, y_all + r * n, hist_all + r * kJ, n,
                         rec_raw, rec_full, rec_empty);
  } else {
    const T* a = a_all + r * n * J;
    const T* ff = ff_all + r * n;
    const uint8_t* live = live_all + r * n;
    const T* h0 = h0_all + r * J;
    T* y = y_all + r * n;
    T* hist = hist_all + r * J;
    if (J > kRecWideMaxJ) {
      rec_stream_row<T>(a, ff, live, h0, y, hist, n, J, rec_raw, rec_full,
                        rec_empty);
      return;
    }
    // The window: 16, 24 or 32 products (a multiple of 8: at most 7 zeros
    // before them; one a thread), unrolled, up to kRecWideUnrolledJ, else
    // rec_wide_chunks by a loop, a thread forming up to three products.
    constexpr int V = 16 / sizeof(T);
#define TUUN_WIDE_ROW(slots, nq)                                          \
    rec_wide_row<T, slots, nq>(a, ff, live, h0, y, hist, n, J, rec_raw, \
                               rec_full, rec_empty)
    switch (J > kRecWideUnrolledJ ? 0 : (J - 2 + 7) / 8) {
      case 2: TUUN_WIDE_ROW(1, 16 / V); break;
      case 3: TUUN_WIDE_ROW(1, 24 / V); break;
      case 4: TUUN_WIDE_ROW(1, 32 / V); break;
      default: TUUN_WIDE_ROW(3, 0);
    }
#undef TUUN_WIDE_ROW
  }
}

template <typename T, int kJ>
int launch_recurrence(const T* a, const T* ff, const uint8_t* live,
                      const T* h0, T* y, T* hist, int64_t rows, int64_t n,
                      int J, cudaStream_t stream) {
  int threads = kRecChainThreads;
  size_t smem;
  if constexpr (kJ > 0) {
    smem = (size_t)kRecStages * rec_stage_lanes(kJ, sizeof(T)) *
           rec_lane_bytes(kJ, sizeof(T));
  } else if (J <= kRecWideMaxJ) {
    smem = (size_t)rec_wide_bytes(J, rec_wide_stage_lanes(J, sizeof(T)),
                                  sizeof(T));
  } else {
    // The streamed form: a buffers and stages sized to its budget.
    threads = kRecStreamThreads;
    smem = (size_t)rec_stream_bytes(J, rec_stream_stage_lanes(J, sizeof(T)),
                                    rec_stream_bufs(J, sizeof(T)),
                                    sizeof(T));
  }
  auto kernel = linear_recurrence<T, kJ>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<(unsigned)rows, threads, smem, stream>>>(a, ff, live, h0, y, hist,
                                                    n, J);
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
  if (J <= kRecRegJ / 2) {
    return tuun_exact::launch_chain_lo<T>(a, ff, live, h0, y, hist, rows, n,
                                          J, stream);
  }
  if (J <= kRecRegJ) {
    return tuun_exact::launch_chain_hi<T>(a, ff, live, h0, y, hist, rows, n,
                                          J, stream);
  }
  return launch_recurrence<T, 0>(a, ff, live, h0, y, hist, rows, n, J,
                                 stream);
}

// ---------------------------------------------------------------------------
// df prefix sum
// ---------------------------------------------------------------------------

// Tiles by the call's row length n (df_tile): a row of at most kDfOneTile
// lanes is one tile (256 threads x 4 lanes, straight from registers), of
// at most kDfWideTile one wide tile (512 x 8); both touch no scratch.  A
// longer row takes tiles of kDfTile (256 x 8) up to kDfTileMax lanes, wide
// tiles past it (chosen on the card among 512- to 4096-lane tiles).
// Multi-lane tiles are staged through shared memory, so that loads and
// stores stay coalesced.
constexpr int kDfOneTile = 1024;
constexpr int kDfTile = 2048;
constexpr int kDfWideTile = 4096;
constexpr int64_t kDfTileMax = 1 << 18;
// Scratch, in 32-bit words, for `cap` tiles: [0] done counter,
// [kDfTicket] tile counter (every grid of rows longer than one tile),
// [kDfHead, kDfHead + cap) a flag per tile, then from df_record_offset(cap)
// two floats (hi, lo) per tile.  Only the counters and flags must be zero
// when a call starts.  The tile counter has a 128-byte line of its own:
// all of a grid's blocks draw from it at once, and on the line of the
// done counter and the flags that the look-back polls, the draws of a
// 2^20-lane row's 256 blocks queued long enough to show in its time.
constexpr int kDfTicket = 32;
constexpr int kDfHead = 64;

__host__ __device__ constexpr int df_tile(int64_t n) {
  return n <= kDfOneTile ? kDfOneTile
         : n <= kDfWideTile || n > kDfTileMax ? kDfWideTile : kDfTile;
}

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

__device__ __forceinline__ Df shfl_df(Df v, int src) {
  return Df{__shfl_sync(kFull, v.h, src), __shfl_sync(kFull, v.l, src)};
}

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

// Run by the whole block of tile t > 0; the result is thread 0's.  Anchor
// a's inclusive prefix (a = the last multiple of kThreads below t), then
// the aggregates of tiles a + 1 .. t - 1, folded in sequence order by a
// fixed grouping: thread k waits for the flag of record a + k (acquire)
// and reads the record from L2, a shuffle tree folds each warp's, and
// thread 0 the warps' partials in turn.  With at most 32 records only
// warp 0 takes part and no barrier is needed.
template <int kThreads>
__device__ Df df_look_back(const unsigned* flags, const float* records,
                           int64_t t, Df* part) {
  const int64_t a = (t - 1) / kThreads * kThreads;
  const int words = (int)(t - a);
  const int lane = threadIdx.x & 31;
  Df v{0.0f, 0.0f};
  if (words <= 32 && threadIdx.x >= 32) return v;
  const int k = threadIdx.x;
  bool wait = k < words;
  // The warp spins as one, as scan.cu's look-backs do.
  while (__any_sync(kFull, wait)) {
    if (wait && df_load_acquire(&flags[a + k]) != 0) wait = false;
  }
  if (k < words) {
    const float* rec = records + 2 * (a + k);
    v = Df{__ldcg(rec), __ldcg(rec + 1)};
  }
  // Lanes past the words hold (0, 0), which df_add passes through.
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Df o = shfl_down_df(v, d);
    if (lane + d < 32) v = df_add(v, o);
  }
  if (words <= 32) return v;
  if (lane == 0) part[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < (words + 31) / 32; ++w) v = df_add(v, part[w]);
  }
  return v;
}

// Shared-memory index of lane j of a staged tile: 4 pad words after every
// 32 (scan.cu's pad), so coalesced stores and each thread's float4 reads
// of its own lanes are free of bank conflicts.
__device__ __forceinline__ int df_pad(int j) { return j + ((j >> 5) << 2); }

// A tile's lanes [base, base + kTile) of src into the padded stage: float4
// when whole and 16-byte aligned, else masked scalars (lanes past n are
// 0); and back out to dst.
template <int kThreads, int kTile>
__device__ __forceinline__ void df_stage_in(const float* __restrict__ src,
                                            int64_t base, int64_t n,
                                            bool vec, float* stage) {
  if (vec) {
    const float4* s4 = reinterpret_cast<const float4*>(src + base);
#pragma unroll
    for (int k = 0; k < kTile / 4 / kThreads; ++k) {
      const int v = k * kThreads + threadIdx.x;
      *reinterpret_cast<float4*>(&stage[df_pad(4 * v)]) = s4[v];
    }
  } else {
#pragma unroll
    for (int k = 0; k < kTile / kThreads; ++k) {
      const int j = k * kThreads + threadIdx.x;
      stage[df_pad(j)] = base + j < n ? src[base + j] : 0.0f;
    }
  }
}

template <int kThreads, int kTile>
__device__ __forceinline__ void df_stage_out(float* __restrict__ dst,
                                             int64_t base, int64_t n,
                                             bool vec, const float* stage) {
  if (vec) {
    float4* d4 = reinterpret_cast<float4*>(dst + base);
#pragma unroll
    for (int k = 0; k < kTile / 4 / kThreads; ++k) {
      const int v = k * kThreads + threadIdx.x;
      d4[v] = *reinterpret_cast<const float4*>(&stage[df_pad(4 * v)]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < kTile / kThreads; ++k) {
      const int j = k * kThreads + threadIdx.x;
      if (base + j < n) dst[base + j] = stage[df_pad(j)];
    }
  }
}

// Whether a grid's blocks take their tiles from the tile counter: every
// grid whose rows have more than one tile, so that every tile below a
// running one has been taken by a block that is running or done, whatever
// else runs on the card.
__host__ __device__ constexpr bool df_counted(int64_t tiles_a_row) {
  return tiles_a_row > 1;
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" :: "l"(p));
}

// Global tile gt (of rows of nbr tiles of kTile lanes) towards L2: a
// prefetch a 128-byte line of xh and of xl.
template <int kThreads, int kTile>
__device__ __forceinline__ void df_prefetch_tile(const float* xh_all,
                                                 const float* xl_all,
                                                 int64_t n, int64_t nbr,
                                                 int64_t gt) {
  const int64_t r = (int64_t)((unsigned)gt / (unsigned)nbr);
  const int64_t base = (gt - r * nbr) * kTile;
  const int lines = (int)((lmin(kTile, n - base) + 31) / 32);
  for (int v = threadIdx.x; v < 2 * lines; v += kThreads) {
    prefetch_l2((v < lines ? xh_all : xl_all) + r * n + base +
                32 * (v < lines ? v : v - lines));
  }
}

// Global tile gt (of rows of nbr tiles of kTile lanes) into the padded
// stages, float4 where the tile is whole and 16-byte aligned.
template <int kThreads, int kTile>
__device__ __forceinline__ void df_stage_tile(const float* __restrict__ xh_all,
                                              const float* __restrict__ xl_all,
                                              int64_t n, int64_t nbr,
                                              int64_t gt, float* stage_h,
                                              float* stage_l) {
  const int64_t r = (int64_t)((unsigned)gt / (unsigned)nbr);
  const int64_t base = (gt - r * nbr) * kTile;
  const float* xh = xh_all + r * n;
  const float* xl = xl_all + r * n;
  const bool vec =
      base + kTile <= n && (((uintptr_t)xh | (uintptr_t)xl) & 15) == 0;
  df_stage_in<kThreads, kTile>(xh, base, n, vec, stage_h);
  df_stage_in<kThreads, kTile>(xl, base, n, vec, stage_l);
}

// Single-pass inclusive df scan of each of `rows` rows of n lanes (row r
// at r * n in each of xh, xl, oh, ol), tiles of kThreads x kItems lanes,
// a block a tile, the tiles of the rows in order.  Thread k of a tile takes its
// kItems lanes into registers (kStaged: through the padded stage, with
// coalesced float4 loads of the tile; else straight from device memory,
// float4 where whole and 16-byte aligned, masked scalars otherwise; lanes
// past n are 0) and folds them in turn; a shuffle scan across its warp;
// one exchange of warp totals through shared memory, which every warp
// scans the same way; a tile of a longer row then publishes its aggregate
// (or its inclusive prefix, an anchor), looks back, and folds the prefix
// before it into its lanes.  A tile waits only on tiles of lower index.
// A one-tile row's block b is tile b; a longer row's block takes the next
// tile from the scratch's tile counter (df_counted), and while the counter
// answers it sends tile b towards L2, so that whichever block draws a tile
// finds it there or on its way.  A block runs one tile, and the tile, not
// the block, fixes the bits.  A tile never crosses a row and its look-back
// reads only its own row's status in a single row's grouping, so row r
// gives the bits of a one-row call on it.
template <int kThreads, int kItems, bool kStaged>
__global__ void __launch_bounds__(kThreads)
df_prefix_sum(const float* __restrict__ xh_all, const float* __restrict__ xl_all,
              float* __restrict__ oh_all, float* __restrict__ ol_all,
              unsigned* scratch, int64_t cap, int64_t rows, int64_t n) {
  constexpr int kTile = kThreads * kItems;
  constexpr int kWarps = kThreads / 32;
  constexpr int kVecs = kItems / 4;
  constexpr int kPadded = kStaged ? kTile + kTile / 8 : 4;
  __shared__ __align__(16) float stage_h[kPadded];
  __shared__ __align__(16) float stage_l[kPadded];
  __shared__ Df warp_tot[kWarps];
  __shared__ Df part[kWarps];
  __shared__ Df tile_prefix;
  __shared__ bool last_block;
  __shared__ unsigned taken;
  const int64_t nbr = (n + kTile - 1) / kTile;  // tiles per row
  const int64_t nb = rows * nbr;
  const bool counted = df_counted(nbr);
  int64_t gt = blockIdx.x;
  if (counted) {
    // The drawn tile stays in a register while the prefetches go out.
    unsigned drawn = 0;
    if (threadIdx.x == 0) drawn = atomicAdd(&scratch[kDfTicket], 1u);
    df_prefetch_tile<kThreads, kTile>(xh_all, xl_all, n, nbr, gt);
    if (threadIdx.x == 0) taken = drawn;
    __syncthreads();
    gt = taken;
  }
  if constexpr (kStaged) {
    df_stage_tile<kThreads, kTile>(xh_all, xl_all, n, nbr, gt, stage_h,
                                   stage_l);
    __syncthreads();
  }
  const int64_t r = (int64_t)((unsigned)gt / (unsigned)nbr);
  const int64_t t = gt - r * nbr;
  const float* __restrict__ xh = xh_all + r * n;
  const float* __restrict__ xl = xl_all + r * n;
  float* __restrict__ oh = oh_all + r * n;
  float* __restrict__ ol = ol_all + r * n;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t base = t * kTile;
  const int own = (int)threadIdx.x * kItems;  // the thread's first lane
  const int64_t first = base + own;
  const bool whole = kStaged ? base + kTile <= n : first + kItems <= n;

  Df items[kItems];
  if constexpr (kStaged) {
#pragma unroll
    for (int q = 0; q < kVecs; ++q) {
      const float4 fh =
          *reinterpret_cast<const float4*>(&stage_h[df_pad(own + 4 * q)]);
      const float4 fl =
          *reinterpret_cast<const float4*>(&stage_l[df_pad(own + 4 * q)]);
      items[4 * q] = Df{fh.x, fl.x};
      items[4 * q + 1] = Df{fh.y, fl.y};
      items[4 * q + 2] = Df{fh.z, fl.z};
      items[4 * q + 3] = Df{fh.w, fl.w};
    }
  } else if (whole && (((uintptr_t)xh | (uintptr_t)xl) & 15) == 0) {
#pragma unroll
    for (int q = 0; q < kVecs; ++q) {
      const float4 fh = reinterpret_cast<const float4*>(xh + first)[q];
      const float4 fl = reinterpret_cast<const float4*>(xl + first)[q];
      items[4 * q] = Df{fh.x, fl.x};
      items[4 * q + 1] = Df{fh.y, fl.y};
      items[4 * q + 2] = Df{fh.z, fl.z};
      items[4 * q + 3] = Df{fh.w, fl.w};
    }
  } else {
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const bool in = first + k < n;
      items[k] = Df{in ? xh[first + k] : 0.0f, in ? xl[first + k] : 0.0f};
    }
  }
#pragma unroll
  for (int k = 1; k < kItems; ++k) items[k] = df_add(items[k - 1], items[k]);

  // The thread totals' inclusive scan across the warp, then the warp
  // totals', done alike by every warp from one exchange.
  Df incl = items[kItems - 1];
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Df o = shfl_up_df(incl, d);
    if (lane >= d) incl = df_add(o, incl);
  }
  const Df excl = shfl_up_df(incl, 1);
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  Df wt = lane < kWarps ? warp_tot[lane] : Df{0.0f, 0.0f};
#pragma unroll
  for (int d = 1; d < kWarps; d <<= 1) {
    const Df o = shfl_up_df(wt, d);
    if (lane >= d) wt = df_add(o, wt);
  }
  const Df before_warp = shfl_df(wt, warp > 0 ? warp - 1 : 0);
  const Df total = shfl_df(wt, kWarps - 1);

  if (nbr > 1) {
    unsigned* flags = scratch + kDfHead + r * nbr;
    float* records = reinterpret_cast<float*>(scratch + df_record_offset(cap)) +
                     2 * r * nbr;
    const bool anchor = t % kThreads == 0;
    if (threadIdx.x == 0 && !anchor) {
      records[2 * t] = total.h;
      records[2 * t + 1] = total.l;
      df_store_release(&flags[t], 1u);
    }
    Df before{0.0f, 0.0f};
    if (t > 0) before = df_look_back<kThreads>(flags, records, t, part);
    if (threadIdx.x == 0) {
      if (anchor) {
        const Df whole_incl = t > 0 ? df_add(before, total) : total;
        records[2 * t] = whole_incl.h;
        records[2 * t + 1] = whole_incl.l;
        df_store_release(&flags[t], 1u);
      }
      tile_prefix = before;
      // Every read of a flag or record by this block is done, and this
      // tile's flag is final.
      last_block = df_count_acq_rel(&scratch[0]) == (unsigned)(nb - 1);
    }
    __syncthreads();
  }

  // What precedes the thread's lanes: the tile's prefix (a later tile of
  // a longer row), its warp's, its own within the warp, in that order.
  const bool has_tile = nbr > 1 && t > 0;
  bool has = lane > 0;
  Df carry = excl;
  if (warp > 0) {
    carry = has ? df_add(before_warp, carry) : before_warp;
    has = true;
  }
  if (has_tile) {
    carry = has ? df_add(tile_prefix, carry) : tile_prefix;
    has = true;
  }
  if (has) {
#pragma unroll
    for (int k = 0; k < kItems; ++k) items[k] = df_add(carry, items[k]);
  }
  if constexpr (kStaged) {
#pragma unroll
    for (int q = 0; q < kVecs; ++q) {
      *reinterpret_cast<float4*>(&stage_h[df_pad(own + 4 * q)]) = make_float4(
          items[4 * q].h, items[4 * q + 1].h, items[4 * q + 2].h,
          items[4 * q + 3].h);
      *reinterpret_cast<float4*>(&stage_l[df_pad(own + 4 * q)]) = make_float4(
          items[4 * q].l, items[4 * q + 1].l, items[4 * q + 2].l,
          items[4 * q + 3].l);
    }
    __syncthreads();
    const bool vec = whole && (((uintptr_t)oh | (uintptr_t)ol) & 15) == 0;
    df_stage_out<kThreads, kTile>(oh, base, n, vec, stage_h);
    df_stage_out<kThreads, kTile>(ol, base, n, vec, stage_l);
  } else if (whole && (((uintptr_t)oh | (uintptr_t)ol) & 15) == 0) {
#pragma unroll
    for (int q = 0; q < kVecs; ++q) {
      reinterpret_cast<float4*>(oh + first)[q] =
          make_float4(items[4 * q].h, items[4 * q + 1].h, items[4 * q + 2].h,
                      items[4 * q + 3].h);
      reinterpret_cast<float4*>(ol + first)[q] =
          make_float4(items[4 * q].l, items[4 * q + 1].l, items[4 * q + 2].l,
                      items[4 * q + 3].l);
    }
  } else {
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if (first + k < n) {
        oh[first + k] = items[k].h;
        ol[first + k] = items[k].l;
      }
    }
  }

  // The last block to finish its look-back leaves the scratch clean.
  if (nbr > 1 && last_block) {
    unsigned* all = scratch + kDfHead;
    for (int64_t i = threadIdx.x; i < nb; i += kThreads) all[i] = 0;
    if (threadIdx.x == 0) scratch[0] = scratch[kDfTicket] = 0;
  }
}

static_assert(256 * 4 == kDfOneTile && 256 * 8 == kDfTile &&
                  512 * 8 == kDfWideTile,
              "the launches' geometry is df_tile's");

// Blocks of df_prefix_sum<kThreads, kItems, kStaged> that the current
// device holds at once (0 if the runtime cannot say).  No launch reads
// it; tuun_df_resident reports it.
template <int kThreads, int kItems, bool kStaged>
int64_t df_resident() {
  int per_sm = 0, dev = 0, sms = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, df_prefix_sum<kThreads, kItems, kStaged>, kThreads, 0) !=
          cudaSuccess ||
      cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return (int64_t)per_sm * sms;
}

template <int kThreads, int kItems, bool kStaged>
int launch_df(const float* xh, const float* xl, float* oh, float* ol,
              unsigned* scratch, int64_t cap, int64_t rows, int64_t n,
              int64_t blocks, cudaStream_t stream) {
  df_prefix_sum<kThreads, kItems, kStaged>
      <<<(unsigned)blocks, kThreads, 0, stream>>>(xh, xl, oh, ol, scratch,
                                                   cap, rows, n);
  return (int)cudaGetLastError();
}

}  // namespace

#define TUUN_REC_CASE(k) \
    case k: return launch_recurrence<T, k>(a, ff, live, h0, y, hist, rows, \
                                           n, J, stream);
#define TUUN_REC_PART(name)                                                  \
  template int name<float>(const float*, const float*, const uint8_t*,       \
                           const float*, float*, float*, int64_t, int64_t,   \
                           int, cudaStream_t);                               \
  template int name<double>(const double*, const double*, const uint8_t*,    \
                            const double*, double*, double*, int64_t,        \
                            int64_t, int, cudaStream_t);

namespace tuun_exact {
#if TUUN_EXACT_PART == 0 || TUUN_EXACT_PART == 1
template <typename T>
int launch_chain_lo(const T* a, const T* ff, const uint8_t* live,
                    const T* h0, T* y, T* hist, int64_t rows, int64_t n,
                    int J, cudaStream_t stream) {
  switch (J) {
    TUUN_REC_CASE(1) TUUN_REC_CASE(2) TUUN_REC_CASE(3) TUUN_REC_CASE(4)
    TUUN_REC_CASE(5) TUUN_REC_CASE(6) TUUN_REC_CASE(7) TUUN_REC_CASE(8)
    default: return (int)cudaErrorInvalidValue;
  }
}
TUUN_REC_PART(launch_chain_lo)
#endif
#if TUUN_EXACT_PART == 0 || TUUN_EXACT_PART == 2
template <typename T>
int launch_chain_hi(const T* a, const T* ff, const uint8_t* live,
                    const T* h0, T* y, T* hist, int64_t rows, int64_t n,
                    int J, cudaStream_t stream) {
  switch (J) {
    TUUN_REC_CASE(9) TUUN_REC_CASE(10) TUUN_REC_CASE(11) TUUN_REC_CASE(12)
    TUUN_REC_CASE(13) TUUN_REC_CASE(14) TUUN_REC_CASE(15) TUUN_REC_CASE(16)
    default: return (int)cudaErrorInvalidValue;
  }
}
TUUN_REC_PART(launch_chain_hi)
#endif
}  // namespace tuun_exact
#undef TUUN_REC_PART
#undef TUUN_REC_CASE

#if TUUN_EXACT_PART == 0 || TUUN_EXACT_PART == 3
extern "C" {

// Lanes of a df prefix-sum tile for rows of n lanes (a row of at most one
// tile takes no scratch).
int tuun_df_tile(long long n) { return df_tile(n); }
int tuun_recurrence_max_j() { return kRecMaxJ; }

// Blocks of the df prefix sum's kernel for rows of n lanes that the
// current card holds at once (0 if the runtime cannot say).  The kernel
// does not depend on it: chip_smoke.py sizes its two-stream check by it.
long long tuun_df_resident(long long n) {
  const int tile = df_tile(n);
  return tile == kDfOneTile ? df_resident<256, 4, false>()
         : tile == kDfTile  ? df_resident<256, 8, true>()
                            : df_resident<512, 8, true>();
}

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
// zero, cap >= rows * ceil(n / tuun_df_tile(n)) (null when n <= one tile);
// the kernel leaves it so.  Calls that share a scratch must not overlap.
int tuun_df_prefix_sum_rows_f32(const float* xh, const float* xl, float* oh,
                                float* ol, unsigned* scratch, long long cap,
                                long long rows, long long n, void* stream) {
  if (n <= 0 || n > kMaxN || rows <= 0) return (int)cudaErrorInvalidValue;
  const int tile = df_tile(n);
  const int64_t nbr = (n + tile - 1) / tile;
  const int64_t nb = rows * nbr;
  if (nb > kMaxN || (nbr > 1 && (scratch == nullptr || nb > cap))) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  if (tile == kDfOneTile) {
    return launch_df<256, 4, false>(xh, xl, oh, ol, scratch, cap, rows, n, nb,
                                    s);
  }
  if (tile == kDfTile) {
    return launch_df<256, 8, true>(xh, xl, oh, ol, scratch, cap, rows, n, nb,
                                   s);
  }
  return launch_df<512, 8, true>(xh, xl, oh, ol, scratch, cap, rows, n, nb,
                                 s);
}

}  // extern "C"
#endif

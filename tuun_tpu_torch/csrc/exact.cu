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
// The ring form (J > 16) keeps the earlier design: thread 0 runs the chain
// with the history in a ring in shared memory while warps 1-3 stage tiles by
// cp.async, a block barrier a tile.
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
// The ring form (J > 16): warp 0 runs the chain, warps 1-3 stage tiles.
constexpr int kRecThreads = 128;
constexpr int kRecStagers = kRecThreads - 32;
constexpr int kRecTile = 512;
// Shared memory a block of the ring form may take: it sizes its tiles to
// this.
constexpr int kRecSmemBudget = 200 * 1024;

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

// The ring form (J > 16).  Shared-memory layout of one block: two buffers
// each of a [tile * J], ff [tile] and y [tile], then the history ring [J],
// then two live buffers [tile] of bytes.
template <typename T>
struct RecSmem {
  T* a[2];
  T* ff[2];
  T* y[2];
  T* ring;
  uint8_t* live[2];
};

template <typename T>
__host__ __device__ constexpr size_t rec_smem_bytes(int tile, int J) {
  return sizeof(T) * (size_t)(2 * tile * J + 4 * tile + J) + 2 * (size_t)tile;
}

template <typename T>
__device__ RecSmem<T> rec_smem(unsigned char* base, int tile, int J) {
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
  p += J;
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

// One row, any J, the history in a ring: thread 0 runs the chain over tile
// t while warps 1-3 stage tile t + 1 and store tile t - 1's y.
template <typename T>
__device__ __forceinline__ void rec_ring_row(
    const T* __restrict__ a, const T* __restrict__ ff,
    const uint8_t* __restrict__ live, const T* __restrict__ h0,
    T* __restrict__ y, T* __restrict__ hist, int64_t n, int J, int tile,
    unsigned char* raw) {
  const RecSmem<T> s = rec_smem<T>(raw, tile, J);
  const int64_t tiles = (n + tile - 1) / tile;
  const bool stager = threadIdx.x >= 32;
  const int me = threadIdx.x - 32;

  rec_stage<T>(s, 0, a, ff, live, n, J, tile, 0, threadIdx.x, kRecThreads);
  __pipeline_wait_prior(0);
  __syncthreads();

  int p = 0;
  if (threadIdx.x == 0) {
    for (int j = 0; j < J; ++j) s.ring[(J - j) % J] = h0[j];
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
      rec_tile_ring<T>(s, cur, (int)lmin(tile, n - t * tile), J, p);
    }
    __syncthreads();
  }
  rec_store<T>(s, (int)((tiles - 1) & 1), y, n, tile, tiles - 1, threadIdx.x,
               kRecThreads);
  if (threadIdx.x == 0) {
    for (int j = 0; j < J; ++j) hist[j] = s.ring[(p - j + J) % J];
  }
}

// One block a row.  kJ > 0: the chain form, history in registers; kJ = 0:
// the ring form, any J.
template <typename T, int kJ>
__global__ void __launch_bounds__(kRecThreads)
linear_recurrence(const T* __restrict__ a_all, const T* __restrict__ ff_all,
                  const uint8_t* __restrict__ live_all,
                  const T* __restrict__ h0_all, T* __restrict__ y_all,
                  T* __restrict__ hist_all, int64_t n, int J, int tile) {
  extern __shared__ __align__(128) unsigned char rec_raw[];
  __shared__ uint64_t rec_full[kRecStages];
  __shared__ uint64_t rec_empty[kRecStages];
  const int64_t r = blockIdx.x;
  if constexpr (kJ > 0) {
    rec_chain_row<T, kJ>(a_all + r * n * kJ, ff_all + r * n, live_all + r * n,
                         h0_all + r * kJ, y_all + r * n, hist_all + r * kJ, n,
                         rec_raw, rec_full, rec_empty);
  } else {
    rec_ring_row<T>(a_all + r * n * J, ff_all + r * n, live_all + r * n,
                    h0_all + r * J, y_all + r * n, hist_all + r * J, n, J,
                    tile, rec_raw);
  }
}

template <typename T, int kJ>
int launch_recurrence(const T* a, const T* ff, const uint8_t* live,
                      const T* h0, T* y, T* hist, int64_t rows, int64_t n,
                      int J, cudaStream_t stream) {
  int tile = 0;
  int threads = kRecChainThreads;
  size_t smem;
  if constexpr (kJ > 0) {
    smem = (size_t)kRecStages * rec_stage_lanes(kJ, sizeof(T)) *
           rec_lane_bytes(kJ, sizeof(T));
  } else {
    // Tiles that fit the budget, at most kRecTile lanes.
    const size_t per_lane = sizeof(T) * (size_t)(2 * J + 4) + 2;
    const size_t room = kRecSmemBudget - sizeof(T) * (size_t)J;
    tile = (int)lmin(kRecTile, (int64_t)(room / per_lane));
    if (tile < 1) return (int)cudaErrorInvalidValue;
    threads = kRecThreads;
    smem = rec_smem_bytes<T>(tile, J);
  }
  auto kernel = linear_recurrence<T, kJ>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<(unsigned)rows, threads, smem, stream>>>(a, ff, live, h0, y, hist,
                                                    n, J, tile);
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

// Cross-lane scans of the render engine, written by hand for Hopper (sm_90a).
//
// Three kernels, each the counterpart of one Pallas TPU kernel in
// tuun_tpu/engine/pallas_ops.py:
//
//   tuun_prefix_sum_f32   <- prefix_sum_f32 / _prefix_sum_kernel
//   tuun_prefix_max_f32   <- prefix_max_f32 / _prefix_max_kernel
//   tuun_affine_scan_f32  <- affine_scan_f32 / _affine_scan_kernel
//
// The TPU kernels walk a sequential grid and carry the running total (or
// the running affine map) from one grid step to the next in SMEM scratch.
// Blocks on this card run in parallel and in no order, so nothing can be
// carried between them: every scan here is three launches instead --
// (1) each block scans or reduces its own tile and writes the tile's
// aggregate, (2) one block scans the aggregates, (3) each block folds its
// tile's exclusive prefix in.
//
// What bounds them: all three move a few bytes per lane and do little
// arithmetic (the affine scan O(J^2) per lane sequentially plus O(J^3) per
// thread in the block scan), so they are bound by device-memory traffic
// and by launch latency at small N.  The design answers with coalesced
// tile loads through shared memory (prefix kernels), each thread owning a
// contiguous run of lanes (sequential work in registers, one value or one
// J x J map per thread entering the warp-shuffle scan), and a single small
// aggregate pass whose traffic is 1/2048 of the data.  A single-pass
// decoupled look-back would save the re-read of pass (3); that is later
// work.
//
// C interface, bound with ctypes (tuun_tpu_torch/engine/scan_ops.py).
// Every entry launches on the given stream, allocates nothing (the caller
// passes outputs and scratch) and returns cudaGetLastError().  Lengths are
// 64-bit: any N from 1 to 2^31 - 1 is covered, the ragged last tile masked.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

// ---------------------------------------------------------------------------
// Prefix sum / prefix max: one template over the combine op.
// ---------------------------------------------------------------------------

constexpr int kScanThreads = 256;
constexpr int kScanItems = 8;
constexpr int kScanTile = kScanThreads * kScanItems;  // 2048 lanes per block

// Shared-memory index with one pad word per 32: both the coalesced
// (stride-1) and the per-thread (stride-kScanItems) accesses are then free
// of bank conflicts.
__device__ __forceinline__ int pad(int j) { return j + (j >> 5); }

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

// Pass 1: inclusive scan of each 2048-lane tile; the tile's aggregate goes
// to agg[blockIdx.x].  Lanes past n read as the identity.
template <class Op>
__global__ void __launch_bounds__(kScanThreads)
scan_tiles(const float* __restrict__ x, float* __restrict__ out,
           float* __restrict__ agg, int64_t n) {
  __shared__ float tile[kScanTile + kScanTile / 32];
  __shared__ float warp_tot[32];
  const int64_t base = (int64_t)blockIdx.x * kScanTile;
#pragma unroll
  for (int k = 0; k < kScanItems; ++k) {
    const int j = k * kScanThreads + threadIdx.x;
    const int64_t g = base + j;
    tile[pad(j)] = g < n ? x[g] : Op::identity();
  }
  __syncthreads();
  float items[kScanItems];
  const int first = threadIdx.x * kScanItems;
#pragma unroll
  for (int k = 0; k < kScanItems; ++k) items[k] = tile[pad(first + k)];
#pragma unroll
  for (int k = 1; k < kScanItems; ++k) {
    items[k] = Op::combine(items[k - 1], items[k]);
  }
  float total;
  const float excl =
      block_exclusive_scan<Op>(items[kScanItems - 1], warp_tot, &total);
  if (threadIdx.x > 0) {
#pragma unroll
    for (int k = 0; k < kScanItems; ++k) items[k] = Op::combine(excl, items[k]);
  }
#pragma unroll
  for (int k = 0; k < kScanItems; ++k) tile[pad(first + k)] = items[k];
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kScanItems; ++k) {
    const int j = k * kScanThreads + threadIdx.x;
    const int64_t g = base + j;
    if (g < n) out[g] = tile[pad(j)];
  }
  if (threadIdx.x == 0) agg[blockIdx.x] = total;
}

// Pass 2 (one block): agg[t] <- exclusive prefix of the tile aggregates,
// walked in chunks of kScanThreads with a running carry.
template <class Op>
__global__ void __launch_bounds__(kScanThreads)
scan_aggregates(float* __restrict__ agg, int64_t nb) {
  __shared__ float warp_tot[32];
  float carry = Op::identity();
  for (int64_t base = 0; base < nb; base += kScanThreads) {
    const int64_t g = base + threadIdx.x;
    const float v = g < nb ? agg[g] : Op::identity();
    float total;
    const float excl = block_exclusive_scan<Op>(v, warp_tot, &total);
    if (g < nb) agg[g] = threadIdx.x == 0 ? carry : Op::combine(carry, excl);
    carry = Op::combine(carry, total);
  }
}

// Pass 3: tile t >= 1 folds in its exclusive prefix agg[t].
template <class Op>
__global__ void __launch_bounds__(kScanThreads)
add_prefix(float* __restrict__ out, const float* __restrict__ agg, int64_t n) {
  const int64_t t = (int64_t)blockIdx.x + 1;
  const float p = agg[t];
  const int64_t base = t * kScanTile;
#pragma unroll
  for (int k = 0; k < kScanItems; ++k) {
    const int64_t g = base + k * kScanThreads + threadIdx.x;
    if (g < n) out[g] = Op::combine(p, out[g]);
  }
}

template <class Op>
int run_prefix(const float* x, float* out, float* agg, int64_t n,
               cudaStream_t stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const int64_t nb = (n + kScanTile - 1) / kScanTile;
  scan_tiles<Op><<<(unsigned)nb, kScanThreads, 0, stream>>>(x, out, agg, n);
  if (nb > 1) {
    scan_aggregates<Op><<<1, kScanThreads, 0, stream>>>(agg, nb);
    add_prefix<Op><<<(unsigned)(nb - 1), kScanThreads, 0, stream>>>(out, agg, n);
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Affine scan: h_i = A_i h_{i-1} + b_i over the J-deep filter history.
// ---------------------------------------------------------------------------
//
// Lane i is the companion-form map of y[i] = ff[i] - sum_j a[i,j] y[i-1-j]
// (row 0 = -a[i,:], rows 1.. shift the history down; b = (ff[i], 0, ...)),
// or the identity on a dead lane.  Each thread owns kAffItems contiguous
// lanes and composes their maps in registers; pushing one companion map
// onto a running map costs O(J^2) because only row 0 is new.  Thread maps
// then enter a block scan with full J x J composition.  The last pass does
// not apply the composed maps lane by lane: it applies the thread's
// exclusive prefix map to the history entering its block once, then runs
// the recurrence itself over its lanes (O(J) per lane, in the reference op
// order), writing h[i, :] = (y[i], y[i-1], ..., y[i-J+1]).

constexpr int kAffThreads = 128;
constexpr int kAffItems = 16;
constexpr int kAffTile = kAffThreads * kAffItems;  // 2048 lanes per block
constexpr int kMaxJ = 8;

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
__device__ __forceinline__ void push_lane(Map<J>& P, const float* __restrict__ a,
                                          float f) {
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

// The composed map of the thread's kAffItems lanes starting at `start`.
template <int J>
__device__ __forceinline__ Map<J> thread_map(const float* __restrict__ a,
                                             const float* __restrict__ ff,
                                             const uint8_t* __restrict__ live,
                                             int64_t start, int64_t n) {
  Map<J> P;
  set_identity<J>(P);
  for (int k = 0; k < kAffItems; ++k) {
    const int64_t i = start + k;
    if (i < n && live[i]) push_lane<J>(P, a + i * J, ff[i]);
  }
  return P;
}

// Exclusive scan of one map per thread across the block; same shape as
// block_exclusive_scan.  *total (when not null) receives the block's map.
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
  if (total != nullptr) *total = warp_maps[nwarps - 1];
  __syncthreads();
  return excl;
}

template <int J>
__device__ __forceinline__ void store_map(const Map<J>& m, float* dst) {
#pragma unroll
  for (int i = 0; i < J; ++i) {
#pragma unroll
    for (int k = 0; k < J; ++k) dst[i * J + k] = m.A[i][k];
    dst[J * J + i] = m.b[i];
  }
}

template <int J>
__device__ __forceinline__ void load_map(Map<J>& m, const float* src) {
#pragma unroll
  for (int i = 0; i < J; ++i) {
#pragma unroll
    for (int k = 0; k < J; ++k) m.A[i][k] = src[i * J + k];
    m.b[i] = src[J * J + i];
  }
}

// Pass 1: each block's composed map over its tile -> agg[blockIdx.x].
template <int J>
__global__ void __launch_bounds__(kAffThreads)
affine_tile_maps(const float* __restrict__ a, const float* __restrict__ ff,
                 const uint8_t* __restrict__ live, int64_t n,
                 float* __restrict__ agg) {
  __shared__ Map<J> warp_maps[32];
  const int64_t start =
      (int64_t)blockIdx.x * kAffTile + (int64_t)threadIdx.x * kAffItems;
  const Map<J> P = thread_map<J>(a, ff, live, start, n);
  Map<J> total;
  block_exclusive_scan_maps<J>(P, warp_maps, &total);
  if (threadIdx.x == 0) store_map<J>(total, agg + (int64_t)blockIdx.x * (J * J + J));
}

// Pass 2 (one block): hin[t] = history entering tile t, hin[0] = h0.
template <int J>
__global__ void __launch_bounds__(kAffThreads)
affine_scan_aggregates(const float* __restrict__ agg,
                       const float* __restrict__ h0, float* __restrict__ hin,
                       int64_t nb) {
  __shared__ Map<J> warp_maps[32];
  float hv[J];
#pragma unroll
  for (int i = 0; i < J; ++i) hv[i] = h0[i];
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < J; ++i) hin[i] = hv[i];
  }
  for (int64_t base = 0; base < nb; base += kAffThreads) {
    const int64_t g = base + threadIdx.x;
    Map<J> m;
    if (g < nb) {
      load_map<J>(m, agg + g * (J * J + J));
    } else {
      set_identity<J>(m);
    }
    Map<J> total;
    const Map<J> excl = block_exclusive_scan_maps<J>(m, warp_maps, &total);
    float t[J], o[J];
    apply_map<J>(excl, hv, t);
    apply_map<J>(m, t, o);
    if (g < nb) {
#pragma unroll
      for (int i = 0; i < J; ++i) hin[(g + 1) * J + i] = o[i];
    }
    apply_map<J>(total, hv, t);
#pragma unroll
    for (int i = 0; i < J; ++i) hv[i] = t[i];
  }
}

// Pass 3: the recurrence over each thread's lanes from its entering history.
template <int J>
__global__ void __launch_bounds__(kAffThreads)
affine_apply(const float* __restrict__ a, const float* __restrict__ ff,
             const uint8_t* __restrict__ live, const float* __restrict__ hin,
             int64_t n, float* __restrict__ h, float* __restrict__ hist) {
  __shared__ Map<J> warp_maps[32];
  const int64_t start =
      (int64_t)blockIdx.x * kAffTile + (int64_t)threadIdx.x * kAffItems;
  const Map<J> P = thread_map<J>(a, ff, live, start, n);
  const Map<J> excl = block_exclusive_scan_maps<J>(P, warp_maps, nullptr);
  float hb[J], hv[J];
#pragma unroll
  for (int i = 0; i < J; ++i) hb[i] = hin[(int64_t)blockIdx.x * J + i];
  apply_map<J>(excl, hb, hv);
  for (int k = 0; k < kAffItems; ++k) {
    const int64_t i = start + k;
    if (i >= n) break;
    if (live[i]) {
      float y = ff[i];
#pragma unroll
      for (int j = 0; j < J; ++j) y -= a[i * J + j] * hv[j];
#pragma unroll
      for (int j = J - 1; j >= 1; --j) hv[j] = hv[j - 1];
      hv[0] = y;
    }
#pragma unroll
    for (int j = 0; j < J; ++j) h[i * J + j] = hv[j];
    if (i == n - 1) {
#pragma unroll
      for (int j = 0; j < J; ++j) hist[j] = hv[j];
    }
  }
}

template <int J>
int run_affine(const float* a, const float* ff, const uint8_t* live,
               const float* h0, float* h, float* hist, float* agg, float* hin,
               int64_t n, cudaStream_t stream) {
  const int64_t nb = (n + kAffTile - 1) / kAffTile;
  affine_tile_maps<J><<<(unsigned)nb, kAffThreads, 0, stream>>>(a, ff, live, n, agg);
  affine_scan_aggregates<J><<<1, kAffThreads, 0, stream>>>(agg, h0, hin, nb);
  affine_apply<J><<<(unsigned)nb, kAffThreads, 0, stream>>>(a, ff, live, hin, n, h, hist);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int tuun_scan_tile() { return kScanTile; }
int tuun_affine_tile() { return kAffTile; }
int tuun_affine_max_j() { return kMaxJ; }

// out[i] = x[0] + ... + x[i].  agg: ceil(n / tuun_scan_tile()) floats.
int tuun_prefix_sum_f32(const float* x, float* out, float* agg, long long n,
                        void* stream) {
  return run_prefix<SumOp>(x, out, agg, n, (cudaStream_t)stream);
}

// out[i] = max(x[0..i]) with torch.cummax's NaN and tie rules.
int tuun_prefix_max_f32(const float* x, float* out, float* agg, long long n,
                        void* stream) {
  return run_prefix<MaxOp>(x, out, agg, n, (cudaStream_t)stream);
}

// a f32[n, J] row-major, ff f32[n], live u8[n], h0 f32[J].
// Writes h f32[n, J] (h[i, j] = y[i - j]) and hist f32[J] (= h[n-1, :]).
// agg: nb * (J*J + J) floats, hin: (nb + 1) * J floats,
// nb = ceil(n / tuun_affine_tile()).
int tuun_affine_scan_f32(const float* a, const float* ff, const uint8_t* live,
                         const float* h0, float* h, float* hist, float* agg,
                         float* hin, long long n, int J, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (J) {
    case 1: return run_affine<1>(a, ff, live, h0, h, hist, agg, hin, n, s);
    case 2: return run_affine<2>(a, ff, live, h0, h, hist, agg, hin, n, s);
    case 3: return run_affine<3>(a, ff, live, h0, h, hist, agg, hin, n, s);
    case 4: return run_affine<4>(a, ff, live, h0, h, hist, agg, hin, n, s);
    case 5: return run_affine<5>(a, ff, live, h0, h, hist, agg, hin, n, s);
    case 6: return run_affine<6>(a, ff, live, h0, h, hist, agg, hin, n, s);
    case 7: return run_affine<7>(a, ff, live, h0, h, hist, agg, hin, n, s);
    case 8: return run_affine<8>(a, ff, live, h0, h, hist, agg, hin, n, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"

// The whole bisection k-selection in one launch: one thread block cluster
// reads x once and runs every bisection round on chip.
//
// Replaces src/repro/kernels/topk_threshold.py::topk_threshold
// (iters rounds of the Pallas kernel `_stats_kernel` through
// `threshold_stats`, then one more stats pass at the final bracket).  For a
// flat x of n fp32 values and a target count k:
//
//     a_max = max |x|
//     hi    = fp32(fp32(a_max * c1) + c2)     c1 = fp32(1 + 1e-6), c2 = 1e-30
//     lo    = 0
//     iters times:
//         mid    = fp32(0.5 * fp32(lo + hi))
//         c      = #{|x| >= mid and |x| > 0}
//         lo, hi = c >= k ? (mid, hi) : (lo, mid)
//     cnt   = #{|x| >= lo and |x| > 0}            (int32, exact)
//     sum   = sum of |x| over those, fp64, rounded to fp32 once
//
// Every fp32 result and input is flushed as the reference computes it
// (flush-to-zero: a subnormal is the zero of its sign), with __fmul_rn and
// __fadd_rn so that no multiply and add fuse into an fma: lo is the plain
// version's, bit for bit.  Exact zeros are never counted (Algorithm 1;
// ROADMAP Queue 3, R1).
//
// Bound: memory, one read of x: at n = 307,434 that is 1.2 MB, 0.37 us at
// 3.35 TB/s.  What bounds it in practice is latency: iters steps, each
// depending on the count of the one before, and a final count.  The TPU
// kernel streamed x from HBM once a step, and topk_threshold launched it
// once a step.
//
// Design: one cluster of C = 16 CTAs (the non-portable cluster size) of
// 512 threads.  CTA r takes the slice [r * per, (r + 1) * per) of x, per =
// ceil(n / C), and keeps up to 28 rows of 2048 elements of it (224 KB) in
// shared memory as magnitude keys: |x| as a uint32 pattern, 0 for a zero, a
// subnormal or a NaN.  Non-negative floats order as their patterns, so a
// count is one integer compare an element against the least pattern that
// counts.  What does not fit (n above 16 x 57,344 = 917,504 at C = 16) is
// read again from global memory (L2) in every round, inside the same
// launch: there is no capacity limit and no fallback.  A card that cannot
// place a 16-CTA cluster refuses the launch, and the wrapper raises.
//
// Each round settles two bisection steps.  From (lo, hi) it computes the
// step's mid and both mids the next step can take, (lo, mid) and (mid,
// hi), with the same fp32 arithmetic, counts at all three in one sweep of
// the keys and then walks the two decisions: the same mids as one step at
// a time, so the same lo bit for bit, with half the rounds (17 for 32
// steps).  Rounds, not compares, are what cost here: a compare is a cycle,
// a round waits on a cluster-wide exchange.
//
// The exchange: each warp reduces its three counts and adds them into its
// CTA's shared total; after a CTA barrier, warp 0 pushes the CTA's totals
// into a slot of its own in every CTA's inbox (distributed shared memory
// stores, lane r to CTA r); one cluster barrier publishes every inbox, and
// each warp sums the C slots of its own inbox, so every thread of the
// cluster takes the same decisions on the same lo and hi.  Totals and
// inboxes alternate between two buffers by the round's parity: a buffer is
// written again two rounds later, after every reader has passed the
// cluster barrier in between.  a_max is exchanged the same way, with a max.
//
// The final sum is taken in an order fixed by position alone: each thread
// adds its elements in index order, lanes in a fixed shuffle tree, warps in
// order, then CTA 0 adds the CTAs' partials in rank order, so two calls
// give identical bits.  A last cluster barrier keeps every CTA (and its
// shared memory) alive until CTA 0 has read them.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int ROW = 4 * THREADS;   // elements in a row of uint4 keys
constexpr int MAX_ROWS = 28;       // 28 x 8 KB of shared memory a CTA
constexpr int CLUSTER = 16;       // CTAs in the one cluster
constexpr int MIDS = 3;            // a round's mids: the step's and two next
constexpr unsigned FULL = 0xffffffffu;

// |v| as a uint32 pattern; 0 for a zero, a subnormal or a NaN
__device__ __forceinline__ unsigned magnitude_key(float v) {
  const unsigned b = __float_as_uint(v) & 0x7fffffffu;
  return b < 0x00800000u || b > 0x7f800000u ? 0u : b;
}

// v with a subnormal value as the zero of its sign, by its bits
__device__ __forceinline__ float ftz(float v) {
  const unsigned b = __float_as_uint(v);
  return (b & 0x7f800000u) == 0u ? __uint_as_float(b & 0x80000000u) : v;
}

// fp32(0.5 * fp32(lo + hi)), each result flushed, no fma
__device__ __forceinline__ float midpoint(float lo, float hi) {
  return ftz(__fmul_rn(0.5f, ftz(__fadd_rn(lo, hi))));
}

// The least magnitude_key that counts at a threshold t >= 0 (flushed):
// |x| >= t and |x| > 0
__device__ __forceinline__ unsigned threshold_key(float t) {
  const unsigned b = __float_as_uint(t);
  return b == 0u ? 1u : b;
}

struct Exchange {           // a CTA's side of the cluster-wide reduction
  unsigned total[2][MIDS];                // this CTA's totals, by parity
  unsigned inbox[2][CLUSTER][MIDS];       // every CTA's totals, by parity
};

// The cluster-wide sums (or maxima) of each thread's v[0..m), in every
// thread, through buffer p of `ex` (see the design note).
template <bool MAX, int M>
__device__ __forceinline__ void exchange(const cg::cluster_group& cl,
                                         Exchange& ex, int p,
                                         unsigned (&v)[M]) {
  const unsigned lane = threadIdx.x & 31u;
  const unsigned rank = cl.block_rank();
#pragma unroll
  for (int i = 0; i < M; ++i) {
    const unsigned w = MAX ? __reduce_max_sync(FULL, v[i])
                           : __reduce_add_sync(FULL, v[i]);
    if (lane == 0u) {
      if (MAX) {
        atomicMax(&ex.total[p][i], w);
      } else {
        atomicAdd(&ex.total[p][i], w);
      }
    }
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    const unsigned mine = lane < M ? ex.total[p][lane] : 0u;
    if (lane < M) ex.total[p][lane] = 0u;   // for its use two rounds on
    unsigned* dst = cl.map_shared_rank(&ex.inbox[p][rank][0],
                                       lane < CLUSTER ? lane : 0u);
#pragma unroll
    for (int i = 0; i < M; ++i) {
      const unsigned t = __shfl_sync(FULL, mine, i);
      if (lane < CLUSTER) dst[i] = t;
    }
  }
  cl.sync();
#pragma unroll
  for (int i = 0; i < M; ++i) {
    const unsigned r = lane < CLUSTER ? ex.inbox[p][lane][i] : 0u;
    v[i] = MAX ? __reduce_max_sync(FULL, r) : __reduce_add_sync(FULL, r);
  }
}

__global__ void __launch_bounds__(THREADS, 1)
    bisect_select_kernel(const float* __restrict__ x,
                         float* __restrict__ lo_out,
                         int* __restrict__ cnt_out,
                         float* __restrict__ sum_out, int64_t n,
                         long long k, int iters, float c1, float c2,
                         int64_t per, int rows) {
  extern __shared__ uint4 keys[];        // rows * THREADS uint4
  __shared__ Exchange ex;
  __shared__ int warp_cnt[WARPS];
  __shared__ double warp_sum[WARPS];
  __shared__ int cta_cnt;
  __shared__ double cta_sum;
  const cg::cluster_group cl = cg::this_cluster();
  const unsigned rank = cl.block_rank();
  const int tid = threadIdx.x;
  if (tid < 2 * MIDS) ex.total[tid / MIDS][tid % MIDS] = 0u;

  // this CTA's slice: [begin, begin + len), the first `held` in shared
  const int64_t begin = static_cast<int64_t>(rank) * per;
  const int64_t len = begin < n ? (n - begin < per ? n - begin : per) : 0;
  const int64_t cap = static_cast<int64_t>(rows) * ROW;
  const int64_t held = len < cap ? len : cap;
  const float* xs = x + begin;
  unsigned* flat = reinterpret_cast<unsigned*>(keys);
  unsigned mx[1] = {0u};
#pragma unroll 4
  for (int64_t i = tid; i < cap; i += THREADS) {
    const unsigned key = i < held ? magnitude_key(__ldg(xs + i)) : 0u;
    flat[i] = key;
    mx[0] = key > mx[0] ? key : mx[0];
  }
  for (int64_t i = held + tid; i < len; i += THREADS) {
    const unsigned key = magnitude_key(__ldg(xs + i));
    mx[0] = key > mx[0] ? key : mx[0];
  }
  // the keys and the zeroed totals before any use, and every CTA of the
  // cluster running before the first store into another's shared memory
  cl.sync();

  exchange<true>(cl, ex, 1, mx);
  const float a_max = __uint_as_float(mx[0]);
  float hi = ftz(__fadd_rn(ftz(__fmul_rn(a_max, c1)), c2));
  float lo = 0.f;
  for (int done = 0, round = 0; done < iters; done += 2, ++round) {
    // the step's mid, and the next step's after a count below k (lo, mid)
    // or at least k (mid, hi)
    const float mid = midpoint(lo, hi);
    const float below = midpoint(lo, mid);
    const float above = midpoint(mid, hi);
    const unsigned t0 = threshold_key(mid);
    const unsigned t1 = threshold_key(below);
    const unsigned t2 = threshold_key(above);
    unsigned c[MIDS] = {0u, 0u, 0u};
    for (int j = 0; j < rows; ++j) {
      const uint4 q = keys[j * THREADS + tid];
      c[0] += (q.x >= t0) + (q.y >= t0) + (q.z >= t0) + (q.w >= t0);
      c[1] += (q.x >= t1) + (q.y >= t1) + (q.z >= t1) + (q.w >= t1);
      c[2] += (q.x >= t2) + (q.y >= t2) + (q.z >= t2) + (q.w >= t2);
    }
    for (int64_t i = held + tid; i < len; i += THREADS) {
      const unsigned key = magnitude_key(__ldcg(xs + i));
      c[0] += key >= t0;
      c[1] += key >= t1;
      c[2] += key >= t2;
    }
    exchange<false>(cl, ex, round & 1, c);
    const bool up = static_cast<long long>(c[0]) >= k;
    if (up) {
      lo = mid;
    } else {
      hi = mid;
    }
    if (done + 1 < iters) {
      const float next = up ? above : below;
      if (static_cast<long long>(up ? c[2] : c[1]) >= k) {
        lo = next;
      } else {
        hi = next;
      }
    }
  }

  // the stats at lo: count and fp64 sum in an order fixed by position
  const unsigned thr = threshold_key(lo);
  int c = 0;
  double s = 0.0;
  for (int j = 0; j < rows; ++j) {
    const uint4 q = keys[j * THREADS + tid];
    const unsigned e[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (e[u] >= thr) {
        c += 1;
        s += static_cast<double>(__uint_as_float(e[u]));
      }
    }
  }
  for (int64_t i = held + tid; i < len; i += THREADS) {
    const unsigned key = magnitude_key(__ldcg(xs + i));
    if (key >= thr) {
      c += 1;
      s += static_cast<double>(__uint_as_float(key));
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    c += __shfl_xor_sync(FULL, c, off);
    s += __shfl_xor_sync(FULL, s, off);
  }
  if ((tid & 31) == 0) {
    warp_cnt[tid / 32] = c;
    warp_sum[tid / 32] = s;
  }
  __syncthreads();
  if (tid == 0) {
    c = 0;
    s = 0.0;
    for (int w = 0; w < WARPS; ++w) {
      c += warp_cnt[w];
      s += warp_sum[w];
    }
    cta_cnt = c;
    cta_sum = s;
  }
  cl.sync();
  if (rank == 0 && tid == 0) {
    c = 0;
    s = 0.0;
    for (unsigned r = 0; r < CLUSTER; ++r) {
      c += *cl.map_shared_rank(&cta_cnt, r);
      s += *cl.map_shared_rank(&cta_sum, r);
    }
    *lo_out = lo;
    *cnt_out = c;
    *sum_out = __double2float_rn(s);
  }
  cl.sync();  // no CTA leaves while CTA 0 reads its shared memory
}

}  // namespace

// x (n,) f32 on the card; k in [1, n]; iters >= 0; c1 and c2 the bracket's
// constants (fp32(1 + 1e-6), fp32(1e-30)).  Writes lo (f32), cnt (int32)
// and sum (f32).  One launch on `stream`; returns its error (a cluster that
// cannot be placed is refused here).
extern "C" int bisect_select_f32(const void* x, void* lo, void* cnt,
                                 void* sum, long long n, long long k,
                                 int iters, float c1, float c2,
                                 void* stream) {
  if (n <= 0 || k < 1 || k > n || iters < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static bool configured[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!configured[dev]) {
    err = cudaFuncSetAttribute(bisect_select_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               MAX_ROWS * ROW * 4);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(
          bisect_select_kernel,
          cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    configured[dev] = true;
  }
  const int64_t per = (n + CLUSTER - 1) / CLUSTER;
  const int64_t need = (per + ROW - 1) / ROW;
  const int rows = static_cast<int>(need < MAX_ROWS ? need : MAX_ROWS);

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CLUSTER, 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = static_cast<size_t>(rows) * ROW * 4;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, bisect_select_kernel,
                           static_cast<const float*>(x),
                           static_cast<float*>(lo), static_cast<int*>(cnt),
                           static_cast<float*>(sum), static_cast<int64_t>(n),
                           k, iters, c1, c2, per, rows);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

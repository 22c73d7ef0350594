// Threshold statistics for k-selection by bisection: the count and the
// magnitude mass of the elements at or above a threshold.
//
// Replaces the Pallas kernel `_stats_kernel` of
// src/repro/kernels/topk_threshold.py (entry `threshold_stats`):
//
//     m   = |x| >= t  and  |x| > 0
//     cnt = #m                     (int32, exact)
//     sum = sum of |x| over m      (fp64, rounded to fp32 once)
//
// Exact zeros are never counted, as in Algorithm 1 and the stc_apply kernel
// (the reference's Pallas kernel counts them at t = 0; ROADMAP Queue 3, R1).
// For every t > 0 the two definitions agree.  Subnormal values of x and t
// count as zeros, as the reference computes them (flush-to-zero).  The
// comparison is taken on bit patterns: a non-negative fp32 value orders as
// its uint32 pattern, so each element is one integer compare against the
// least pattern that counts (NaN never counts, as in the fp32 compare).
//
// `t` is read from device memory, so a caller can keep it on the card.  One
// launch writes both outputs: no fills, no casts around it.
//
// Bound: memory.  One 4-byte read per element; at n = 307,434 that is
// 1.2 MB, 0.37 us at 3.35 TB/s, so a launch is close to launch-bound.
// Design: each thread strides over the vector and sums its own elements in
// index order in fp64; lanes reduce in a fixed shuffle tree and warps in
// order; thread 0 writes the CTA's partial and takes a ticket after a
// release fence (as in histogram.cu).  The last CTA reduces the partials in
// a fixed order (each thread its CTAs in order, the same tree, warps in
// order), writes the int32 count and the fp32 sum, and resets the ticket.
// The sum's order is fixed by the elements' positions and the grid, so two
// calls on the same input give identical bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

// |v| as a uint32 pattern; 0 for a zero, a subnormal or a NaN
__device__ __forceinline__ unsigned magnitude_key(float v) {
  const unsigned b = __float_as_uint(v) & 0x7fffffffu;
  return b < 0x00800000u || b > 0x7f800000u ? 0u : b;
}

// The least magnitude_key that counts at threshold t: |x| >= t and |x| > 0
__device__ __forceinline__ unsigned threshold_key(float t) {
  const unsigned b = __float_as_uint(t);
  if ((b & 0x7fffffffu) > 0x7f800000u) return FULL;    // NaN: nothing
  if ((b >> 31) != 0u || b < 0x00800000u) return 1u;   // t <= 0, subnormal
  return b;
}

// Each warp's (count, sum) reduced in a fixed tree, then the warps in
// order; the result is valid in thread 0.
__device__ __forceinline__ void block_reduce(int& c, double& s) {
  __shared__ int wc[WARPS];
  __shared__ double ws[WARPS];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    c += __shfl_xor_sync(FULL, c, off);
    s += __shfl_xor_sync(FULL, s, off);
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x / 32;
  if (lane == 0) {
    wc[warp] = c;
    ws[warp] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    c = 0;
    s = 0.0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      c += wc[w];
      s += ws[w];
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS)
    threshold_stats_kernel(const float* __restrict__ x,
                           const float* __restrict__ thresh,
                           int* __restrict__ cnt_out,
                           float* __restrict__ sum_out,
                           int* __restrict__ part_cnt,
                           double* __restrict__ part_sum,
                           unsigned* __restrict__ ticket, int64_t n) {
  __shared__ bool last;
  const unsigned thr = threshold_key(*thresh);
  int c = 0;
  double s = 0.0;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * THREADS;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
       i < n; i += stride) {
    const unsigned key = magnitude_key(__ldg(x + i));
    if (key >= thr) {
      c += 1;
      s += static_cast<double>(__uint_as_float(key));
    }
  }
  block_reduce(c, s);
  if (threadIdx.x == 0) {
    part_cnt[blockIdx.x] = c;
    part_sum[blockIdx.x] = s;
    asm volatile("fence.acq_rel.gpu;" ::: "memory");
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
    if (last) asm volatile("fence.acq_rel.gpu;" ::: "memory");
  }
  __syncthreads();
  if (!last) return;
  c = 0;
  s = 0.0;
  for (unsigned b = threadIdx.x; b < gridDim.x; b += THREADS) {
    c += __ldcg(part_cnt + b);
    s += __ldcg(part_sum + b);
  }
  block_reduce(c, s);
  if (threadIdx.x == 0) {
    *cnt_out = c;
    *sum_out = __double2float_rn(s);
    *ticket = 0u;  // ready for the next launch
  }
}

}  // namespace

// x (n,) f32; thresh a one-element f32 on the card.  Writes cnt (int32) and
// sum (f32).  Scratch: part_cnt (int32) and part_sum (f64) of `blocks`
// entries, and one zeroed ticket word, which the kernel leaves at 0.
extern "C" int threshold_stats_f32(const void* x, const void* thresh,
                                   void* cnt, void* sum, void* part_cnt,
                                   void* part_sum, void* ticket, long long n,
                                   int blocks, void* stream) {
  if (n <= 0) return 0;
  threshold_stats_kernel<<<static_cast<unsigned>(blocks), THREADS, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(thresh),
      static_cast<int*>(cnt), static_cast<float*>(sum),
      static_cast<int*>(part_cnt), static_cast<double*>(part_sum),
      static_cast<unsigned*>(ticket), static_cast<int64_t>(n));
  return static_cast<int>(cudaGetLastError());
}

// Threshold statistics for k-selection by bisection: the count and the
// magnitude mass of the elements at or above a threshold.
//
// Replaces the Pallas kernel `_stats_kernel` of
// src/repro/kernels/topk_threshold.py (entry `threshold_stats`):
//
//     m   = |x| >= t  and  |x| > 0
//     cnt = #m                     (int32, exact)
//     sum = sum of |x| over m      (accumulated in fp64)
//
// Exact zeros are never counted, as in Algorithm 1 and the stc_apply kernel
// (the reference's Pallas kernel counts them at t = 0; ROADMAP Queue 3, R1).
// For every t > 0 the two definitions agree.
//
// `t` is read from device memory, so the bisection driver keeps its bracket
// on the card and queues all of its iters + 1 launches without a host sync.
// The caller zeroes `cnt` and `sum` first.
//
// Bound: memory.  One 4-byte read per element; at n = 307,434 that is
// 1.2 MB, 0.37 us at 3.35 TB/s, so a launch is close to launch-bound.
// Design: the TPU kernel carried its partials across a sequential grid;
// here each thread strides over the vector, the block reduces its threads'
// partials with warp shuffles and shared memory, and one thread per block
// adds them to the output with one int32 and one fp64 global atomic.  Sums
// are fp64 so that the result does not depend, beyond the wrapper's final
// rounding to fp32, on the order the atomics land in.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

__global__ void threshold_stats_kernel(const float* __restrict__ x,
                                       const float* __restrict__ thresh,
                                       int* __restrict__ cnt_out,
                                       double* __restrict__ sum_out,
                                       int64_t n) {
  __shared__ int cnt_w[WARPS];
  __shared__ double sum_w[WARPS];
  const float t = *thresh;
  int c = 0;
  double s = 0.0;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * THREADS;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
       i < n; i += stride) {
    const float a = fabsf(x[i]);
    if (a >= t && a > 0.0f) {
      c += 1;
      s += static_cast<double>(a);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    c += __shfl_down_sync(0xffffffffu, c, off);
    s += __shfl_down_sync(0xffffffffu, s, off);
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x / 32;
  if (lane == 0) {
    cnt_w[warp] = c;
    sum_w[warp] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int bc = 0;
    double bs = 0.0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      bc += cnt_w[w];
      bs += sum_w[w];
    }
    if (bc != 0) {
      atomicAdd(cnt_out, bc);
      atomicAdd(sum_out, bs);
    }
  }
}

}  // namespace

extern "C" int threshold_stats_f32(const void* x, const void* thresh,
                                   void* cnt, void* sum, long long n,
                                   int blocks, void* stream) {
  if (n <= 0) return 0;
  threshold_stats_kernel<<<static_cast<unsigned>(blocks), THREADS, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(thresh),
      static_cast<int*>(cnt), static_cast<double*>(sum),
      static_cast<int64_t>(n));
  return static_cast<int>(cudaGetLastError());
}

// Per-row 256-bin magnitude histogram: counts and sums of |x|.
//
// Replaces the Pallas kernel `_hist_kernel_batched` (with `_block_hist`) of
// src/repro/kernels/hist_select.py (entry `magnitude_histogram_batched`).
// For every row b of x, with scale_b = 256 / max|x_b| (0 for an all-zero
// row):
//
//     bin      = clip(int(|x| * scale_b), 0, 255)   (truncation toward zero)
//     cnt[b]   = #elements per bin                   (int32, exact)
//     sums[b]  = sum of |x| per bin                  (accumulated in fp64)
//
// The bin is __float2int_rz(__fmul_rn(a, scale)): one fp32 multiply with no
// fused add, truncated toward zero, then clipped -- the same expression as
// core/selection.py::bin_index, bit for bit.
//
// Bound: memory.  One read of x (4 bytes per element) plus a (B, 256)
// output; at (10, 307434) that is 12.3 MB, about 3.7 us at 3.35 TB/s.  What
// stands in the way is atomic contention: gradient-like data piles most
// elements into a few low bins.  Design: the TPU kernel accumulated across
// its sequential grid; here the blocks of a row spread over many CTAs that
// run in no order.  Each warp owns a private sub-histogram in shared memory
// (8 warps x 256 bins x (4 + 8) bytes = 24 KB), so a shared atomic collides
// only within one warp; at the end the block reduces its warps' bins and
// flushes them to the (B, 256) global output with one global atomic per
// bin.  The caller zeroes that output first.  Sums are accumulated in fp64
// so that the result does not depend, beyond the final fp32 rounding, on the
// order the atomics land in; the wrapper rounds them to fp32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NBINS = 256;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

__global__ void magnitude_histogram_kernel(const float* __restrict__ x,
                                           const float* __restrict__ scale,
                                           int* __restrict__ cnt_out,
                                           double* __restrict__ sum_out,
                                           int64_t n) {
  __shared__ int cnt[WARPS][NBINS];
  __shared__ double sums[WARPS][NBINS];
  const int warp = threadIdx.x / 32;
  for (int i = threadIdx.x; i < WARPS * NBINS; i += THREADS) {
    cnt[i / NBINS][i % NBINS] = 0;
    sums[i / NBINS][i % NBINS] = 0.0;
  }
  __syncthreads();

  const int64_t row = blockIdx.y;
  const float s = scale[row];
  const float* x_row = x + row * n;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * THREADS;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
       i < n; i += stride) {
    const float a = fabsf(x_row[i]);
    int bin = __float2int_rz(__fmul_rn(a, s));
    bin = min(max(bin, 0), NBINS - 1);
    atomicAdd(&cnt[warp][bin], 1);
    atomicAdd(&sums[warp][bin], static_cast<double>(a));
  }
  __syncthreads();

  for (int bin = threadIdx.x; bin < NBINS; bin += THREADS) {
    int c = 0;
    double t = 0.0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      c += cnt[w][bin];
      t += sums[w][bin];
    }
    if (c != 0) {
      atomicAdd(&cnt_out[row * NBINS + bin], c);
      atomicAdd(&sum_out[row * NBINS + bin], t);
    }
  }
}

}  // namespace

extern "C" int magnitude_histogram_f32(const void* x, const void* scale,
                                       void* cnt, void* sums, int rows,
                                       long long n, int blocks_per_row,
                                       void* stream) {
  if (rows <= 0 || n <= 0) return 0;
  dim3 grid(static_cast<unsigned>(blocks_per_row),
            static_cast<unsigned>(rows));
  magnitude_histogram_kernel<<<grid, THREADS, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(scale),
      static_cast<int*>(cnt), static_cast<double*>(sums),
      static_cast<int64_t>(n));
  return static_cast<int>(cudaGetLastError());
}

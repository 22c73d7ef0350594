// Fused STC apply: mask -> ternarize -> error feedback, one pass.
//
// Replaces the Pallas kernel `_fused_kernel` of
// src/repro/kernels/stc_compress.py (entry `stc_apply_batched`).  For every
// row b of the carried matrix c = delta + residual, with the row's threshold
// t_b and ternary magnitude mu_b:
//
//     m    = |c| >= t_b  &&  |c| > 0      (Algorithm 1; exact zeros are never
//                                          selected, the port's rule R1)
//     tern = m ? mu_b * sign(c) : 0
//     res  = c - tern
//
// Bound: memory.  Each element reads 4 bytes and writes 8, so 12 bytes per
// element; at (10, 307434) fp32 that is 36.9 MB, about 11 us at 3.35 TB/s.
// Design: a 2-D grid (column blocks, rows); each block reads its row's
// (t, mu) once and each thread handles ELEMS elements strided by the block
// width, so every load and store of a warp is one contiguous 128-byte line.
// Rows of odd length (n = 307434 is not a multiple of 4) rule out aligned
// float4 access per row, so the loads stay scalar and coalesced.  The
// arithmetic is the plain version's, operation for operation: given the same
// (t, mu) the outputs are bitwise equal.  Subnormal values count as zeros,
// as the reference computes them (flush-to-zero): t, mu and the residual as
// the zero of their sign, and c as +0, the reference's flushed carried sum
// of a subnormal delta and a +0 residual (the port's carried sum is not
// flushed; ROADMAP Queue 3, R5).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int ELEMS = 4;

// v with a subnormal value as the zero of its sign, by its bits
__device__ __forceinline__ float ftz(float v) {
  const unsigned b = __float_as_uint(v);
  return (b & 0x7f800000u) == 0u ? __uint_as_float(b & 0x80000000u) : v;
}

// a carried value with a subnormal as +0 (exact zeros kept), by its bits
__device__ __forceinline__ float carried_read(float v) {
  const unsigned b = __float_as_uint(v) & 0x7fffffffu;
  return b != 0u && b < 0x00800000u ? 0.0f : v;
}

__global__ void stc_apply_kernel(const float* __restrict__ carried,
                                 const float* __restrict__ thresh,
                                 const float* __restrict__ mu,
                                 float* __restrict__ tern,
                                 float* __restrict__ res,
                                 int64_t n) {
  const int64_t row = blockIdx.y;
  const float t = ftz(thresh[row]);
  const float m = ftz(mu[row]);
  const float* c_row = carried + row * n;
  float* tern_row = tern + row * n;
  float* res_row = res + row * n;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * THREADS * ELEMS;
#pragma unroll
  for (int j = 0; j < ELEMS; ++j) {
    const int64_t i = base + j * THREADS + threadIdx.x;
    if (i < n) {
      const float c = carried_read(c_row[i]);
      const float a = fabsf(c);
      const bool keep = (a >= t) && (a > 0.0f);
      const float q = keep ? (c > 0.0f ? m : -m) : 0.0f;
      tern_row[i] = q;
      res_row[i] = ftz(__fsub_rn(c, q));
    }
  }
}

}  // namespace

extern "C" int stc_apply_f32(const void* carried, const void* thresh,
                             const void* mu, void* tern, void* res,
                             int rows, long long n, void* stream) {
  if (rows <= 0 || n <= 0) return 0;
  const int64_t per_block = static_cast<int64_t>(THREADS) * ELEMS;
  dim3 grid(static_cast<unsigned>((n + per_block - 1) / per_block),
            static_cast<unsigned>(rows));
  stc_apply_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(carried), static_cast<const float*>(thresh),
      static_cast<const float*>(mu), static_cast<float*>(tern),
      static_cast<float*>(res), static_cast<int64_t>(n));
  return static_cast<int>(cudaGetLastError());
}

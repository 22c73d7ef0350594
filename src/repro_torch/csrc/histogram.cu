// Per-row 256-bin magnitude histogram: counts and sums of |x|.
//
// Replaces the Pallas kernel `_hist_kernel_batched` (with `_block_hist`) of
// src/repro/kernels/hist_select.py (entry `magnitude_histogram_batched`).
// For every row b of x, with scale_b = 256 / max|x_b| (0 for an all-zero
// row):
//
//     bin      = clip(int(|x| * scale_b), 0, 255)   (truncation toward zero)
//     cnt[b]   = #elements per bin                   (int32, exact)
//     sums[b]  = sum of |x| per bin                  (fp64, rounded to fp32 once)
//
// The bin is __float2int_rz(__fmul_rn(a, scale)): one fp32 multiply with no
// fused add, truncated toward zero, then clipped -- the same expression as
// core/selection.py::bin_index, bit for bit.  A subnormal |x| counts as 0
// (bin 0, adding nothing), as the plain version's flush_subnormal makes it.
//
// Bound: memory.  One read of x (4 bytes an element) plus the (B, 256)
// output (8 bytes a bin); at (10, 307434) that is 12.3 MB, 3.7 us at
// 3.35 TB/s.  The first version of this kernel took 25.5 us there on an
// H100 80GB HBM3 at 700 W: one shared atomicAdd on an int and one on a
// double per element, and an fp64 atomicAdd to shared memory compiles to a
// compare-and-swap loop (ATOMS.CAST.SPIN.64 in its SASS, as chip_smoke.py
// prints it), which serialises on the few hot bins that hold most of a
// carried row (chip_smoke.py prints the bin shares); every CTA zeroed
// 24 KB and flushed 512 global atomics onto the same B x 256 addresses;
// loads were scalar; and two zero fills and an fp64->fp32 cast ran around
// the launch.  Warp aggregation (__match_any_sync groups whose leader
// gathers the group's values in lane order) costs more in the match and the
// gather than the collisions it avoids.  This version:
//
// * counts and sums bins 0 and 1 (the hot bins of heavy-tailed data) in
//   each thread's registers, without a branch, in fp64;
// * sums bins 2..255 as exact integers: the row's scale bounds those
//   magnitudes to [2^e0, 2^(e0+8)), where every fp32 value is an integer
//   multiple of 2^(e0-23) below 2^31 (RowUnit below), so the CTA's shared
//   histogram takes three fire-and-forget 32-bit atomics an element (count,
//   low 16 bits, the rest) whose order cannot change the sum; the warp
//   skips them when none of its lanes has such a bin, and the rare larger
//   values of the clipped bin 255 go to registers in fp64;
// * reads the 16-byte-aligned body of each row with float4 loads, four in
//   flight a thread, and the unaligned head and tail (at most 3 elements
//   each) with scalar loads;
// * runs one launch with no fills or casts: a grid of one 512-thread CTA an
//   SM (chip_smoke.py times 1, 2 and 4), each CTA writes its partial (256
//   counts, 256 fp64 sums) to a scratch buffer, and the last CTA of its row
//   (a per-row ticket, taken after a release fence and reset to 0 by that
//   CTA) reduces the row's partials in CTA order and writes int32 counts
//   and __double2float_rn sums.
//
// Every fp64 sum is taken in an order fixed by the data's position alone
// (a thread's own elements in order, lanes in a fixed tree, warps in order,
// CTAs in order) or is a sum of exact integers, so two calls on the same
// input give identical bits.  The time is still about 2.5x the byte bound
// at (10, 307434) and far above it for one row; the fence, the ticket and
// the last CTA's reduce run after the loop on the launch's critical path,
// and how the rest splits between the loop and them is not yet measured.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NBINS = 256;
constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int SPLIT = THREADS / NBINS;  // threads a bin in the merge
constexpr int UNROLL = 4;               // float4 loads in flight a thread
constexpr int REDUCE_BATCH = 16;
constexpr int MAX_CTA_ELEMS = 65535;    // keeps the split sums below 2^32
constexpr unsigned FULL = 0xffffffffu;

static_assert(THREADS % NBINS == 0, "the merge gives each bin SPLIT threads");

// What a row's scale says about the magnitudes of bins 2..255.  With
// s = m * 2^es (1 <= m < 2), fl(a * s) >= 2 forces a >= 2^e0 (e0 = -es),
// and a < 2^(e0 + 8) keeps fl(a * s) below 256; every larger a lands in the
// clipped bin 255.  An fp32 a >= 2^e0 is a multiple of 2^ue (ue = e0 - 23,
// or -149 below the normal range), and below 2^(e0 + 8) it is that unit
// times an integer under 2^31: bins 2..255 sum exact integers, whose sum
// does not depend on the order of the adds.
struct RowUnit {
  float big;  // 2^(e0 + 8); 0 when no bin >= 2 can take the integer path
  int ue;
};

__device__ __forceinline__ RowUnit row_unit(float s) {
  if (!(s > 0.f) || isinf(s)) return RowUnit{0.f, 0};
  const int e0 = -ilogbf(s);
  return RowUnit{e0 + 8 >= 128 ? __int_as_float(0x7f800000)
                               : ldexpf(1.f, e0 + 8),
                 max(e0 - 23, -149)};
}

// a (>= 2^e0, < 2^(e0 + 8)) in units of 2^ue, exactly
__device__ __forceinline__ unsigned fixed_point(float a, int ue) {
  const unsigned bits = __float_as_uint(a);
  const int e = static_cast<int>(bits >> 23);
  const unsigned m = (bits & 0x7fffffu) | (e ? 0x800000u : 0u);
  return m << ((e ? e : 1) - 150 - ue);
}

// |v| with a subnormal value as +0 (the reference's flush-to-zero), by its
// bits: neither fabsf nor the conversion to fp64 is flushed by -ftz=true
__device__ __forceinline__ float flushed_abs(float v) {
  const unsigned b = __float_as_uint(v) & 0x7fffffffu;
  return __uint_as_float(b < 0x00800000u ? 0u : b);
}

struct RegBins {  // a thread's bins 0 and 1, and its bin-255 values >= big
  int c0, c1, cx;
  double s0, s1, sx;
};

// One element a lane; the whole warp calls it.  Bins 0 and 1 are counted
// and summed in the lane's registers without a branch; bins 2..255 go to
// the CTA's shared histogram as exact integers (the count, the low 16 bits
// and the rest of the fixed-point value, three fire-and-forget atomics),
// skipped by the whole warp when no lane has one.
__device__ __forceinline__ void bin_step(float v, bool valid, float s,
                                         RowUnit u, int* __restrict__ cnt,
                                         unsigned* __restrict__ lohi,
                                         RegBins& r) {
  const float a = flushed_abs(v);
  int bin = __float2int_rz(__fmul_rn(a, s));
  bin = min(max(bin, 0), NBINS - 1);
  const double ad = static_cast<double>(a);
  const bool b0 = valid && bin == 0, b1 = valid && bin == 1;
  r.c0 += b0;
  r.c1 += b1;
  r.s0 += b0 ? ad : 0.0;
  r.s1 += b1 ? ad : 0.0;
  const bool high = valid && bin >= 2;
  if (!__any_sync(FULL, high)) return;
  if (high && a < u.big) {
    const unsigned q = fixed_point(a, u.ue);
    atomicAdd(cnt + bin, 1);
    atomicAdd(lohi + 2 * bin, q & 0xffffu);
    atomicAdd(lohi + 2 * bin + 1, q >> 16);
  } else if (high) {
    r.cx += 1;
    r.sx += ad;
  }
}

__global__ void __launch_bounds__(THREADS)
    magnitude_histogram_kernel(const float* __restrict__ x,
                               const float* __restrict__ scale,
                               int* __restrict__ cnt_out,
                               float* __restrict__ sum_out,
                               int* __restrict__ part_cnt,
                               double* __restrict__ part_sum,
                               unsigned* __restrict__ tickets, int64_t n) {
  __shared__ int hcnt[NBINS];
  __shared__ unsigned hlohi[2 * NBINS];
  __shared__ int rc[3][WARPS];
  __shared__ double rs[3][WARPS];
  __shared__ int tc[SPLIT][NBINS];
  __shared__ double ts[SPLIT][NBINS];
  __shared__ bool last_cta;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < NBINS; i += THREADS) hcnt[i] = 0;
  for (int i = threadIdx.x; i < 2 * NBINS; i += THREADS) hlohi[i] = 0u;
  __syncthreads();

  const int64_t row = blockIdx.y;
  const float s = scale[row];
  const RowUnit u = row_unit(s);
  const float* xr = x + row * n;
  // the row's 16-byte-aligned body of float4s, with a head and a tail of
  // at most 3 scalars each
  const int64_t skew = static_cast<int64_t>(
      ((16u - (reinterpret_cast<uintptr_t>(xr) & 15u)) & 15u) / 4u);
  const int64_t head = skew < n ? skew : n;
  const int64_t nv = (n - head) / 4;
  const float4* body = reinterpret_cast<const float4*>(xr + head);
  const int64_t per_cta = (nv + gridDim.x - 1) / gridDim.x;
  const int64_t v0 = static_cast<int64_t>(blockIdx.x) * per_cta;
  const int64_t v1 = v0 + per_cta < nv ? v0 + per_cta : nv;

  RegBins r{0, 0, 0, 0.0, 0.0, 0.0};
  for (int64_t base = v0; base < v1; base += THREADS * UNROLL) {
    float4 q[UNROLL];
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      const int64_t i = base + k * THREADS + threadIdx.x;
      q[k] = i < v1 ? __ldg(body + i) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      const bool ok = base + k * THREADS + threadIdx.x < v1;
      bin_step(q[k].x, ok, s, u, hcnt, hlohi, r);
      bin_step(q[k].y, ok, s, u, hcnt, hlohi, r);
      bin_step(q[k].z, ok, s, u, hcnt, hlohi, r);
      bin_step(q[k].w, ok, s, u, hcnt, hlohi, r);
    }
  }
  if (blockIdx.x == 0 && warp == 0) {  // head on lanes 0-2, tail on 3-5
    const int64_t i = lane < 3 ? lane : head + 4 * nv + (lane - 3);
    const bool ok = lane < 3 ? lane < head : (lane < 6 && i < n);
    bin_step(ok ? xr[i] : 0.f, ok, s, u, hcnt, hlohi, r);
  }

  // register bins: a fixed shuffle tree per warp, then warps in order
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    r.c0 += __shfl_xor_sync(FULL, r.c0, o);
    r.c1 += __shfl_xor_sync(FULL, r.c1, o);
    r.cx += __shfl_xor_sync(FULL, r.cx, o);
    r.s0 += __shfl_xor_sync(FULL, r.s0, o);
    r.s1 += __shfl_xor_sync(FULL, r.s1, o);
    r.sx += __shfl_xor_sync(FULL, r.sx, o);
  }
  if (lane == 0) {
    rc[0][warp] = r.c0;
    rc[1][warp] = r.c1;
    rc[2][warp] = r.cx;
    rs[0][warp] = r.s0;
    rs[1][warp] = r.s1;
    rs[2][warp] = r.sx;
  }
  __syncthreads();

  const int bin = threadIdx.x % NBINS;
  const int part = threadIdx.x / NBINS;
  int c = 0;
  double t = 0.0;
  if (part == 0) {
    c = hcnt[bin];
    const unsigned long long q =
        hlohi[2 * bin] + (static_cast<unsigned long long>(hlohi[2 * bin + 1])
                          << 16);
    t = ldexp(static_cast<double>(q), u.ue);  // exact below 2^53
    const int reg = bin == 0 ? 0 : bin == 1 ? 1 : bin == NBINS - 1 ? 2 : -1;
    if (reg >= 0) {
      for (int w = 0; w < WARPS; ++w) {
        c += rc[reg][w];
        t += rs[reg][w];
      }
    }
  }
  const int64_t out = row * NBINS + bin;
  if (gridDim.x == 1) {
    if (part == 0) {
      cnt_out[out] = c;
      sum_out[out] = __double2float_rn(t);
    }
    return;
  }

  const int64_t first = row * gridDim.x * NBINS + bin;  // CTA 0's slot
  if (part == 0) {
    part_cnt[first + static_cast<int64_t>(blockIdx.x) * NBINS] = c;
    part_sum[first + static_cast<int64_t>(blockIdx.x) * NBINS] = t;
  }
  // thread 0 publishes the CTA's partial: the barrier orders the CTA's
  // stores before its release fence, and the last CTA's acquire fence
  // orders its loads after every ticket
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("fence.acq_rel.gpu;" ::: "memory");
    last_cta = atomicAdd(&tickets[row], 1u) == gridDim.x - 1;
    if (last_cta) asm volatile("fence.acq_rel.gpu;" ::: "memory");
  }
  __syncthreads();
  if (!last_cta) return;

  // the row's last CTA: SPLIT threads a bin each sum a contiguous run of
  // the partials in CTA order, read from L2, and thread 0 of the bin adds
  // the runs in order
  const unsigned run = (gridDim.x + SPLIT - 1) / SPLIT;
  const unsigned lo = part * run;
  const unsigned hi = lo + run < gridDim.x ? lo + run : gridDim.x;
  c = 0;
  t = 0.0;
  for (unsigned b0 = lo; b0 < hi; b0 += REDUCE_BATCH) {
    int cb[REDUCE_BATCH];
    double tb[REDUCE_BATCH];
#pragma unroll
    for (int j = 0; j < REDUCE_BATCH; ++j) {
      const bool ok = b0 + j < hi;
      const int64_t at = first + static_cast<int64_t>(b0 + j) * NBINS;
      cb[j] = ok ? __ldcg(part_cnt + at) : 0;
      tb[j] = ok ? __ldcg(part_sum + at) : 0.0;
    }
#pragma unroll
    for (int j = 0; j < REDUCE_BATCH; ++j) {
      c += cb[j];
      t += tb[j];
    }
  }
  tc[part][bin] = c;
  ts[part][bin] = t;
  __syncthreads();
  if (part == 0) {
    for (int p = 1; p < SPLIT; ++p) {
      c += tc[p][bin];
      t += ts[p][bin];
    }
    cnt_out[out] = c;
    sum_out[out] = __double2float_rn(t);
  }
  if (threadIdx.x == 0) tickets[row] = 0u;  // ready for the next launch
}

}  // namespace

// ``part_cnt`` / ``part_sum`` hold rows * blocks_per_row * 256 entries and
// ``tickets`` one zeroed word a row; both are unused when blocks_per_row is
// 1.  Launches on ``stream``; returns cudaGetLastError().
extern "C" int magnitude_histogram_f32(const void* x, const void* scale,
                                       void* cnt, void* sums, void* part_cnt,
                                       void* part_sum, void* tickets,
                                       int rows, long long n,
                                       int blocks_per_row, void* stream) {
  if (rows <= 0 || n <= 0 || blocks_per_row <= 0) return 0;
  // every CTA's share (plus the head and tail) must stay in MAX_CTA_ELEMS
  if (4 * ((n / 4 + blocks_per_row - 1) / blocks_per_row) + 6 >
      MAX_CTA_ELEMS) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  dim3 grid(static_cast<unsigned>(blocks_per_row),
            static_cast<unsigned>(rows));
  magnitude_histogram_kernel<<<grid, THREADS, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(scale),
      static_cast<int*>(cnt), static_cast<float*>(sums),
      static_cast<int*>(part_cnt), static_cast<double*>(part_sum),
      static_cast<unsigned*>(tickets), static_cast<int64_t>(n));
  return static_cast<int>(cudaGetLastError());
}

// Exact candidate-bin select: per row, the r-th largest |x| among the
// elements of one histogram bin, with the count and the magnitude mass of
// the bin's elements at or above it.
//
// Replaces the refinement of the Pallas k-selection
// src/repro/kernels/hist_select.py::hist_topk_threshold_batched (pass 3,
// the masked `lax.top_k` with `cap` and the `_mixed` full-row sort when
// the candidate bin holds more than `cap` elements), which runs around the
// Pallas histogram `_hist_kernel_batched`.  For every row with scale s,
// candidate bin b and rank r (from core/selection.py::locate_bin):
//
//     candidates = { |x| : clip(int(|x| * s), 0, 255) == b }
//     v          = the r-th largest candidate                    (exact)
//     cnt_in     = #{candidates >= v and > 0}                    (int32)
//     sum_in     = sum of those candidates, fp64, rounded to fp32 once
//
// The bin is __float2int_rz(__fmul_rn(a, s)), clipped: the expression of
// histogram.cu and core/selection.py::bin_index, bit for bit.  A subnormal
// |x| counts as 0 (its bits too), as the plain version's flush makes it.
// Exact zeros are never counted (Algorithm 1: a row with fewer non-zeros
// than k gets v = 0 and counts its non-zeros only).
//
// There is no capacity limit: a candidate bin may hold the whole row, as
// bin 0 of a carried residual row does (98.7 % of a round-40 cnn row).
//
// Design: a radix select on the fp32 bit pattern (non-negative floats order
// as their uint32 patterns), most significant digit first, in three digit
// passes over bits [30, 20], [19, 10] and [9, 0] (bit 31 of |x| is 0).
// Every pass reads the row (the first from device memory, the others from
// the 50 MB L2 at the main path's 12.3 MB), keeps the bin's elements whose
// higher bits match the digits chosen so far, and counts their digit in a
// shared-memory histogram; each CTA merges its counts into the row's
// global histogram with integer atomics, whose order cannot change a count.
// The row's last CTA (a per-row ticket taken after a release fence, as in
// histogram.cu) scans the merged counts from the top digit down, picks the
// digit that holds the rank, writes the row's prefix and remaining rank for
// the next pass and zeroes the global histogram and the ticket for the next
// launch.  After the third pass the prefix is v's bit pattern.  A fourth
// pass counts and sums the bin's elements >= v: each thread adds its own
// elements in order, lanes in a fixed shuffle tree, warps in order, and the
// row's last CTA adds the CTAs' partials in CTA order, so the sum's order
// is fixed by the elements' positions and two calls give identical bits.
//
// Bound: memory.  One read of x (4 bytes an element) plus the per-row
// inputs and outputs: 12.3 MB at (10, 307434), 3.7 us at 3.35 TB/s.  The
// four passes read x four times (three from L2) and each ends with a
// ticket and one CTA's scan on the launch's critical path.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NBINS = 256;
constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 4;                 // float4 loads in flight a thread
constexpr int MAX_DIGITS = 2048;          // the widest digit: 11 bits
constexpr int REDUCE_BATCH = 16;
constexpr unsigned FULL = 0xffffffffu;

__host__ __device__ constexpr int digit_shift(int pass) {
  return pass == 0 ? 20 : pass == 1 ? 10 : 0;
}
__host__ __device__ constexpr int digit_bits(int pass) {
  return pass == 0 ? 11 : 10;
}

struct RowState {
  unsigned prefix;  // the bits of v chosen so far
  unsigned rank;    // v's rank among the candidates that match them
};

// A row's 16-byte-aligned body of float4s, with a head and a tail of at
// most 3 scalars each.
struct RowSpan {
  const float* xr;
  int64_t head;
  int64_t nv;
  const float4* body;
};

__device__ __forceinline__ RowSpan row_span(const float* x, int64_t row,
                                            int64_t n) {
  const float* xr = x + row * n;
  const int64_t skew = static_cast<int64_t>(
      ((16u - (reinterpret_cast<uintptr_t>(xr) & 15u)) & 15u) / 4u);
  const int64_t head = skew < n ? skew : n;
  const int64_t nv = (n - head) / 4;
  return RowSpan{xr, head, nv,
                 reinterpret_cast<const float4*>(xr + head)};
}

// Calls f(value) on every element of this CTA's share of the row: the
// CTA's contiguous run of the body, each thread its strided float4s in
// order, then (CTA 0, threads 0-5) the head and the tail.
template <class F>
__device__ __forceinline__ void for_each_element(const RowSpan& sp,
                                                 int64_t n, F&& f) {
  const int64_t per_cta = (sp.nv + gridDim.x - 1) / gridDim.x;
  const int64_t v0 = static_cast<int64_t>(blockIdx.x) * per_cta;
  const int64_t v1 = v0 + per_cta < sp.nv ? v0 + per_cta : sp.nv;
  for (int64_t base = v0; base < v1; base += THREADS * UNROLL) {
    float4 q[UNROLL];
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      const int64_t i = base + k * THREADS + threadIdx.x;
      q[k] = i < v1 ? __ldg(sp.body + i) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      if (base + k * THREADS + threadIdx.x < v1) {
        f(q[k].x);
        f(q[k].y);
        f(q[k].z);
        f(q[k].w);
      }
    }
  }
  if (blockIdx.x == 0 && threadIdx.x < 6) {
    const int t = threadIdx.x;
    const int64_t i = t < 3 ? t : sp.head + 4 * sp.nv + (t - 3);
    if (t < 3 ? i < sp.head : i < n) f(sp.xr[i]);
  }
}

// |v| with a subnormal value as +0 (the reference's flush-to-zero), by its
// bits: neither fabsf nor the conversion to fp64 is flushed by -ftz=true
__device__ __forceinline__ float flushed_abs(float v) {
  const unsigned b = __float_as_uint(v) & 0x7fffffffu;
  return __uint_as_float(b < 0x00800000u ? 0u : b);
}

__device__ __forceinline__ int bin_of(float a, float s) {
  const int bin = __float2int_rz(__fmul_rn(a, s));
  return min(max(bin, 0), NBINS - 1);
}

// Thread 0 publishes the CTA's global writes and takes the row's ticket;
// true in every thread of the row's last CTA, whose later loads then see
// every other CTA's writes.
__device__ __forceinline__ bool last_cta_of_row(unsigned* tickets,
                                                int64_t row) {
  __shared__ bool last;
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("fence.acq_rel.gpu;" ::: "memory");
    last = atomicAdd(&tickets[row], 1u) == gridDim.x - 1;
    if (last) asm volatile("fence.acq_rel.gpu;" ::: "memory");
  }
  __syncthreads();
  return last;
}

template <int PASS>
__global__ void __launch_bounds__(THREADS)
    digit_pass_kernel(const float* __restrict__ x,
                      const float* __restrict__ scale,
                      const long long* __restrict__ bin_in,
                      const long long* __restrict__ rank_in,
                      RowState* __restrict__ state,
                      unsigned* __restrict__ ghist,
                      unsigned* __restrict__ tickets, int64_t n) {
  constexpr int SHIFT = digit_shift(PASS);
  constexpr int ND = 1 << digit_bits(PASS);
  constexpr int HIGH = SHIFT + digit_bits(PASS);  // bits above the digit
  constexpr int PER = ND / THREADS;               // digits a thread scans
  static_assert(ND % THREADS == 0 && ND <= MAX_DIGITS, "digit layout");
  __shared__ unsigned h[ND];
  __shared__ unsigned wsum[WARPS];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < ND; i += THREADS) h[i] = 0u;
  __syncthreads();

  const int64_t row = blockIdx.y;
  const float s = scale[row];
  const int bsel = static_cast<int>(bin_in[row]);
  unsigned prefix = 0u, rank;
  if (PASS == 0) {
    const long long r = rank_in[row];
    rank = r < 1 ? 1u : static_cast<unsigned>(r);
  } else {
    prefix = state[row].prefix;
    rank = state[row].rank;
  }
  const unsigned high = prefix >> HIGH;  // HIGH <= 31
  for_each_element(row_span(x, row, n), n, [&](float v) {
    const float a = flushed_abs(v);
    const unsigned bits = __float_as_uint(a);
    if (bin_of(a, s) == bsel && (bits >> HIGH) == high) {
      atomicAdd(&h[(bits >> SHIFT) & (ND - 1)], 1u);
    }
  });
  __syncthreads();
  unsigned* gh = ghist + row * MAX_DIGITS;
  for (int i = threadIdx.x; i < ND; i += THREADS) {
    if (h[i] != 0u) atomicAdd(gh + i, h[i]);
  }
  if (!last_cta_of_row(tickets, row)) return;

  // The row's last CTA.  Thread t holds digits ND-1-(t*PER+q), q < PER
  // (descending); an exclusive scan over the threads gives each one the
  // number of candidates above its digits, and the thread whose digit
  // holds the rank-th largest writes the row's state.
  unsigned c[PER];
  unsigned mine = 0u;
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const int d = ND - 1 - (threadIdx.x * PER + q);
    c[q] = __ldcg(gh + d);
    gh[d] = 0u;  // zero for the next launch
    mine += c[q];
  }
  unsigned incl = mine;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) wsum[warp] = incl;
  if (threadIdx.x == 0) {
    state[row] = RowState{prefix, rank};  // kept if no digit holds it
    tickets[row] = 0u;                    // ready for the next pass
  }
  __syncthreads();
  unsigned run = incl - mine;
  for (int w = 0; w < warp; ++w) run += wsum[w];
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    if (run < rank && rank <= run + c[q]) {
      const unsigned d =
          static_cast<unsigned>(ND - 1 - (threadIdx.x * PER + q));
      state[row] = RowState{prefix | (d << SHIFT), rank - run};
    }
    run += c[q];
  }
}

__global__ void __launch_bounds__(THREADS)
    final_pass_kernel(const float* __restrict__ x,
                      const float* __restrict__ scale,
                      const long long* __restrict__ bin_in,
                      const RowState* __restrict__ state,
                      int* __restrict__ part_cnt,
                      double* __restrict__ part_sum,
                      unsigned* __restrict__ tickets,
                      float* __restrict__ v_out, int* __restrict__ cnt_out,
                      float* __restrict__ sum_out, int64_t n) {
  __shared__ int wc[WARPS];
  __shared__ double ws[WARPS];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t row = blockIdx.y;
  const float s = scale[row];
  const int bsel = static_cast<int>(bin_in[row]);
  const float v = __uint_as_float(state[row].prefix);
  int c = 0;
  double t = 0.0;
  for_each_element(row_span(x, row, n), n, [&](float e) {
    const float a = flushed_abs(e);
    if (bin_of(a, s) == bsel && a >= v && a > 0.f) {
      c += 1;
      t += static_cast<double>(a);
    }
  });
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    c += __shfl_xor_sync(FULL, c, o);
    t += __shfl_xor_sync(FULL, t, o);
  }
  if (lane == 0) {
    wc[warp] = c;
    ws[warp] = t;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    c = 0;
    t = 0.0;
    for (int w = 0; w < WARPS; ++w) {
      c += wc[w];
      t += ws[w];
    }
  }
  if (gridDim.x > 1) {
    const int64_t first = row * gridDim.x;  // the row's CTA 0 slot
    if (threadIdx.x == 0) {
      part_cnt[first + blockIdx.x] = c;
      part_sum[first + blockIdx.x] = t;
    }
    if (!last_cta_of_row(tickets, row)) return;
    if (threadIdx.x != 0) return;
    c = 0;
    t = 0.0;
    for (unsigned b0 = 0; b0 < gridDim.x; b0 += REDUCE_BATCH) {
      int cb[REDUCE_BATCH];
      double tb[REDUCE_BATCH];
#pragma unroll
      for (int j = 0; j < REDUCE_BATCH; ++j) {
        const bool ok = b0 + j < gridDim.x;
        cb[j] = ok ? __ldcg(part_cnt + first + b0 + j) : 0;
        tb[j] = ok ? __ldcg(part_sum + first + b0 + j) : 0.0;
      }
#pragma unroll
      for (int j = 0; j < REDUCE_BATCH; ++j) {
        c += cb[j];
        t += tb[j];
      }
    }
    tickets[row] = 0u;
  }
  if (threadIdx.x == 0) {
    v_out[row] = v;
    cnt_out[row] = c;
    sum_out[row] = __double2float_rn(t);
  }
}

}  // namespace

// x (rows, n) f32; scale (rows,) f32; bin and rank (rows,) int64 (from
// locate_bin: the candidate bin and the rank inside it, 1-based).  Writes
// v (rows,) f32, cnt (rows,) int32 and sum (rows,) f32.  Scratch: ``state``
// two words a row, ``ghist`` rows * 2048 zeroed words, ``part_cnt`` and
// ``part_sum`` rows * blocks_per_row entries, ``tickets`` one zeroed word a
// row; the kernels leave ``ghist`` and ``tickets`` zeroed again.  Launches
// the four passes on ``stream``; returns the first launch error.
extern "C" int candidate_select_f32(const void* x, const void* scale,
                                    const void* bin, const void* rank,
                                    void* v, void* cnt, void* sum,
                                    void* state, void* ghist, void* part_cnt,
                                    void* part_sum, void* tickets, int rows,
                                    long long n, int blocks_per_row,
                                    void* stream) {
  if (rows <= 0 || n <= 0 || blocks_per_row <= 0) return 0;
  const dim3 grid(static_cast<unsigned>(blocks_per_row),
                  static_cast<unsigned>(rows));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* sf = static_cast<const float*>(scale);
  const long long* bf = static_cast<const long long*>(bin);
  const long long* rf = static_cast<const long long*>(rank);
  RowState* rs = static_cast<RowState*>(state);
  unsigned* gh = static_cast<unsigned*>(ghist);
  unsigned* tk = static_cast<unsigned*>(tickets);
  cudaError_t err;
  digit_pass_kernel<0><<<grid, THREADS, 0, st>>>(xf, sf, bf, rf, rs, gh, tk,
                                                  n);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  digit_pass_kernel<1><<<grid, THREADS, 0, st>>>(xf, sf, bf, rf, rs, gh, tk,
                                                  n);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  digit_pass_kernel<2><<<grid, THREADS, 0, st>>>(xf, sf, bf, rf, rs, gh, tk,
                                                  n);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  final_pass_kernel<<<grid, THREADS, 0, st>>>(
      xf, sf, bf, rs, static_cast<int*>(part_cnt),
      static_cast<double*>(part_sum), tk, static_cast<float*>(v),
      static_cast<int*>(cnt), static_cast<float*>(sum), n);
  return static_cast<int>(cudaGetLastError());
}

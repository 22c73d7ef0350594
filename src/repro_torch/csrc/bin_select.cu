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
//     sum_in     = sum of those candidates, rounded to fp32 once
//
// The bin is __float2int_rz(__fmul_rn(a, s)), clipped: the expression of
// histogram.cu and core/selection.py::bin_index, bit for bit.  A subnormal
// |x| counts as 0 (its bits too), as the plain version's flush makes it.
// Exact zeros are never counted (Algorithm 1: a row with fewer non-zeros
// than k gets v = 0 and counts its non-zeros only).  There is no capacity
// limit: a candidate bin may hold the whole row, as bin 0 of a carried
// residual row does (98.7 % of a round-40 cnn row).
//
// A radix select on the fp32 bit pattern (non-negative floats order as
// their uint32 patterns), most significant digit first: level 0 takes bits
// [30, 20] (2048 digits: the exponent and 3 mantissa bits), level 1 bits
// [19, 10] and level 2 bits [9, 0] (1024 digits each).  Each level counts
// the candidates that match the digits chosen so far, scans the counts
// from the top digit down and picks the digit that holds the rank.  After
// level 2 the chosen digits are v's bit pattern.
//
// Exact sums, in no counting pass.  A level-0 digit fixes the exponent E,
// so every element it holds is (2^23 + M) * 2^(E - 150): a mass of integer
// mantissas, exact in 64 bits and the same in any order of the adds.  The
// elements counted in v's favour are those of the level-0 digits above d0
// (about r of the row, read by level 1), those of d0 whose level-1 digit
// lies above d1 (read by level 2), those of d0 and d1 whose level-2 digit
// lies above d2, and the ties at v; the elements of one level-2 digit are
// equal, so the last two are counts times a mantissa.  All of them but
// the rare ones more than NEAR binades above d0 add, shifted to the unit
// 2^(eb - 150) (eb = max(E0, 1)), to one integer in each thread's registers
// (the near sum); those rare ones add by exponent in shared memory.  Each
// integer is turned into fp64 once, the 255 terms are added in a fixed
// order and the total is rounded to fp32 once: no position-ordered pass,
// no worse than an fp64 sum, and two calls give identical bits.  The
// counts follow from the digit counts: the digits above the chosen one at
// each level, plus the ties when v > 0.
//
// The candidate bin is a key interval: bin_of is non-decreasing in the key,
// so [first_key(s, b), first_key(s, b + 1)) (two 31-step searches a CTA)
// replaces the multiply and conversion of every element by one compare.
// The input is finite (the magnitudes of a gradient or residual row).
//
// Two routes, chosen by the host from (rows, n) alone
// (kernels/hist_select.py::select_plan):
//
// * cluster (n <= 16 * CLUSTER_KEYS): one launch; a row is held in the
//   shared memory of a thread block cluster of C CTAs (the smallest power
//   of two that holds it; 16 is the non-portable size).  Each warp brings
//   its slots of the CTA's slice with one bulk copy (cp.async.bulk on its
//   own mbarrier; the unaligned head and tail by scalar loads) and turns
//   them into keys in place, a non-candidate into 0, counting level-0
//   digits.  Level 1 keeps each thread's keys at or above d0's least key,
//   compacted in place without a branch, then sums those above d0 and
//   counts d0's; level 2 reads d0's.  At each level the CTAs other than 0
//   add their counts into CTA 0's over distributed shared memory
//   (cluster.map_shared_rank, fire-and-forget atomics); after a cluster
//   barrier CTA 0 picks the digit and stores its choice into every CTA,
//   which a second barrier publishes.  No global histogram, ticket or
//   partial exists.
// * two_read (longer rows): three launches over a grid of CTAs a row, each
//   ending on a per-row ticket (taken after a release fence) whose last CTA
//   scans the row's global digit counts, picks the digit and zeroes them.
//   Pass A reads x and counts level-0 digits.  Pass B reads x again: the
//   candidates above d0 add to the near sum, and d0's count their level-1
//   digit and are compacted, through a staging area a warp, into a per-row
//   candidate buffer of `cap` elements.  Pass C runs level 2 over the
//   buffer; a row whose d0 held more than `cap` elements (a constant row,
//   heavy ties) reads x a third time, filtered by d0, in the same launch: a
//   path of the kernel, exact like the other.
//
// Reads: each call writes, per row, the elements of x it loaded (`reads`,
// counted where the loads are issued): n on the cluster route, 2n on the
// two_read route and 3n when d0 overflowed the buffer.
//
// Counting: every count is an increment of a shared counter, which the
// compiler issues as ATOMS.POPC.INC: the lanes of a warp that hit one
// counter (a constant row's one digit, a near-Gaussian bin's hot digits)
// add as one.  Level 0 of the cluster route predicates it (red.shared.add
// under a predicate), so a warp whose lanes mostly count runs no divergent
// branch.  Explicit warp votes (__match_any_sync, or a ballot and shuffle
// an element) cost more than they saved: on the card they made pass A
// slower than this plain increment at the mesh row.
//
// Bound: memory.  One read of x (4 bytes an element) plus the per-row
// inputs and outputs: 12.3 MB at (10, 307434), 3.7 us at 3.35 TB/s.  The
// cluster route reads x once from device memory (or L2); the two_read
// route twice (plus the buffer), so its floor is twice the bound.  What
// bounds the cluster route at the cnn row is latency: the bulk copy, three
// levels of counting, and six cluster barriers around three 2048- or
// 1024-digit scans, one after another (chip_smoke.py --select-study times
// each step from a build with -DBIN_SELECT_STAMPS).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int NBINS = 256;
constexpr int THREADS = 512;           // two_read CTAs
constexpr int CT = 512;                // cluster CTAs
constexpr int UNROLL = 4;              // float4 loads in flight a thread
constexpr int D0 = 2048;               // level-0 digits: bits [30, 20]
constexpr int D12 = 1024;              // level-1 and level-2 digits
constexpr int NEXP = 256;
constexpr unsigned NEAR = 9;           // binades the near sum spans
constexpr int STAGE = 1024;            // a warp's staging area (two_read)
constexpr int STAGE_ROOM = STAGE - 16 * 32 - 8;  // flush above it
constexpr int CLUSTER_KEYS = 53248;    // a CTA's slice of the row (cluster)
constexpr int MAX_CLUSTER = 16;
constexpr int MAX_BULK = 32768;        // bytes of one bulk copy
constexpr unsigned NOT_KEY = 0xffffffffu;  // no candidate's key (a NaN's)
constexpr unsigned FULL = 0xffffffffu;

// the two_read route's per-row scratch: zero between launches (each pass's
// last CTA zeroes what it read), but `seen`, the candidate count of d0 in
// the last call (read by chip_smoke.py: above `cap` the third read ran)
struct RowScratch {
  unsigned seen;
  unsigned cursor;                     // d0's candidates appended so far
  unsigned ticket;
  unsigned d0, d1, rank, above;        // the levels' choices so far
  unsigned pad;
  unsigned long long near;             // see near_base below
  unsigned long long xread;            // elements of x the passes loaded
  unsigned long long es[NEXP];         // far mantissas above d0, by exponent
  unsigned g0[D0];
  unsigned g1[D12];
  unsigned g2[D12];
};
static_assert(sizeof(RowScratch) == 18480, "hist_select._ROW_SCRATCH_BYTES");

struct Sel {
  unsigned digit;   // the chosen digit
  unsigned rank;    // the rank inside it
  unsigned above;   // candidates in the digits above it
  unsigned count;   // candidates in it
};

// With -DBIN_SELECT_STAMPS (chip_smoke.py --select-study builds a copy so),
// thread 0 of the cluster route's CTA (0, 0) records the global timer at
// each step of its last launch: STAMP(k) writes stamp k.
#ifdef BIN_SELECT_STAMPS
__device__ unsigned long long g_stamps[16];
#define STAMP(k)                                                       \
  do {                                                                 \
    if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0) {      \
      unsigned long long t_;                                           \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));           \
      g_stamps[k] = t_;                                                \
    }                                                                  \
  } while (0)
#else
#define STAMP(k) \
  do {           \
  } while (0)
#endif

__device__ __forceinline__ int64_t lmin(int64_t a, int64_t b) {
  return a < b ? a : b;
}

// |v|'s bits with a subnormal value as +0 (the reference's flush-to-zero):
// neither fabsf nor the conversion to fp64 is flushed by -ftz=true
__device__ __forceinline__ unsigned flushed_key(unsigned bits) {
  const unsigned b = bits & 0x7fffffffu;
  return b < 0x00800000u ? 0u : b;
}

__device__ __forceinline__ int bin_of(unsigned key, float s) {
  const int bin = __float2int_rz(__fmul_rn(__uint_as_float(key), s));
  return min(max(bin, 0), NBINS - 1);
}

// The least key whose bin is at least b (0x7f800001 when none).  bin_of is
// non-decreasing in the key over [0, 0x7f800000] (a correctly rounded
// product, a truncation and a clip), so candidate bin b is the key interval
// [first_key(s, b), first_key(s, b + 1)): one unsigned compare an element.
__device__ __forceinline__ unsigned first_key(float s, int b) {
  if (b <= 0) return 0u;
  unsigned lo = 0u, hi = 0x7f800001u;
  if (b >= NBINS) return hi;
  while (lo < hi) {
    const unsigned mid = lo + ((hi - lo) >> 1);
    if (bin_of(mid, s) >= b) {
      hi = mid;
    } else {
      lo = mid + 1u;
    }
  }
  return lo;
}

// A row's candidate keys: key - lo < width
struct Bin {
  unsigned lo, width;
  __device__ __forceinline__ bool holds(unsigned key) const {
    return key - lo < width;
  }
};

// Threads 0 and 1 of the calling warp find the bin's two bounds; the
// caller's next barrier publishes them.
__device__ __forceinline__ void find_bin(float s, int b, unsigned* bounds) {
  const int lane = threadIdx.x & 31;
  if (lane < 2) bounds[lane] = first_key(s, b + lane);
}

// the element's value in units of 2^(E - 150): 2^23 + M (0 has E = 0,
// whose terms are never added)
__device__ __forceinline__ unsigned long long mant(unsigned key) {
  return (key & 0x7fffffu) | 0x800000u;
}

// The near sum's unit: 2^(eb - 150), eb = max(E0, 1) for the exponent E0
// of d0.  A candidate above d0 lies at E >= E0; within NEAR binades of eb
// it adds mant << (E - eb) (below 2^32) to its thread's register, the
// rarer larger ones add mant to es[E] in shared memory.  Under 2^31 terms
// of 2^32 keep the near sum, with d0's own mantissas, below 2^64.
__device__ __forceinline__ unsigned near_base(unsigned d0) {
  return max(d0 >> 3, 1u);
}

__device__ __forceinline__ void add_above(unsigned key, unsigned eb,
                                          unsigned long long& near,
                                          unsigned long long* es) {
  const unsigned e = key >> 23;
  if (e - eb < NEAR) {
    near += mant(key) << (e - eb);
  } else {
    atomicAdd(es + e, mant(key));
  }
}

// The CTA of NT threads picks the digit of rank `rank` (1-based, counted
// from the top) from counts c[q] of digits ND-1-(t*PER+q) held by thread t
// (descending, PER = ND / NT).  With `clamp` the rank is first clamped to
// [1, total].  A rank outside [1, total] picks digit 0 with nothing above
// it.  Writes *out; every thread of the CTA calls it.
template <int ND, int NT>
__device__ __forceinline__ void pick_digit(const unsigned (&c)[ND / NT],
                                           unsigned rank, bool clamp,
                                           Sel* out, unsigned* wsum) {
  constexpr int PER = ND / NT;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned mine = 0u;
#pragma unroll
  for (int q = 0; q < PER; ++q) mine += c[q];
  unsigned incl = mine;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  unsigned before = 0u, total = 0u;
#pragma unroll
  for (int w = 0; w < NT / 32; ++w) {
    const unsigned t = wsum[w];
    total += t;
    before += w < warp ? t : 0u;
  }
  if (clamp) rank = min(max(rank, 1u), total);
  const bool found = rank >= 1u && rank <= total;
  if (!found && threadIdx.x == 0) *out = Sel{0u, 0u, 0u, 0u};
  unsigned run = before + incl - mine;
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    if (found && run < rank && rank <= run + c[q]) {
      const unsigned d =
          static_cast<unsigned>(ND - 1 - (threadIdx.x * PER + q));
      *out = Sel{d, rank - run, run, c[q]};
    }
    run += c[q];
  }
  __syncthreads();
}

// The sum over a CTA of NT threads of one integer a thread (exact, in any
// order); the total in thread 0.
template <int NT>
__device__ __forceinline__ unsigned long long cta_sum_u64(
    unsigned long long v, unsigned long long* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  unsigned long long t = 0ull;
  if (threadIdx.x == 0) {
    for (int w = 0; w < NT / 32; ++w) t += red[w];
  }
  __syncthreads();
  return t;
}

struct Finish {              // shared memory of the row's last step
  unsigned long long red[32];
  unsigned long long extra;
};

// The row's outputs from its choices, by a CTA of NT threads.  `prefix`
// holds d0 and d1 (bits [30, 10]); s2 is level 2's choice and c[q] its
// counts (thread t holds digits 1023-(t*PER+q)); `above` counts the
// candidates above d0 and, inside d0, above d1; `near` is the near sum of
// the candidates above d0 and d0's candidates above d1 (thread 0's is
// read); es_at(E) gives the far mantissas of exponent E.  The 255 terms are added
// in a fixed order: warp 0's lane l takes exponents 255-8l .. 248-8l in
// turn, then a fixed shuffle tree.  Every thread calls it.
template <int NT, class EsAt>
__device__ __forceinline__ void finish_row(unsigned prefix, const Sel& s2,
                                           const unsigned (&c)[D12 / NT],
                                           unsigned above,
                                           unsigned long long near,
                                           EsAt&& es_at, Finish& f,
                                           float* v_out, int* cnt_out,
                                           float* sum_out, int64_t row) {
  constexpr int PER = D12 / NT;
  const unsigned vb = prefix | s2.digit;
  unsigned long long part = 0ull;
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const unsigned d =
        static_cast<unsigned>(D12 - 1 - (threadIdx.x * PER + q));
    if (d > s2.digit) part += c[q] * mant(prefix | d);
  }
  part = cta_sum_u64<NT>(part, f.red);
  if (threadIdx.x == 0) {
    f.extra = part + near + (vb != 0u ? s2.count * mant(vb) : 0ull);
  }
  __syncthreads();
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  const int eb = static_cast<int>(near_base(prefix >> 20));
  double t = 0.0;
#pragma unroll
  for (int j = 0; j < NEXP / 32; ++j) {
    const int e = NEXP - 1 - lane * 8 - j;
    const unsigned long long u = es_at(e) + (e == eb ? f.extra : 0ull);
    if (e > 0 && u != 0ull) t += ldexp(__ull2double_rn(u), e - 150);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(FULL, t, o);
  if (lane == 0) {
    v_out[row] = __uint_as_float(vb);
    cnt_out[row] =
        static_cast<int>(above + s2.above + (vb != 0u ? s2.count : 0u));
    sum_out[row] = __double2float_rn(t);
  }
}

__device__ __forceinline__ unsigned first_rank(const long long* rank_in,
                                               int64_t row) {
  const long long r = rank_in[row];
  return r < 1 ? 1u : r > 0x7fffffffll ? 0x7fffffffu
                                        : static_cast<unsigned>(r);
}

// ------------------------------------------------------------- cluster

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// One more in *c when `on`, as a predicated shared reduction: no branch,
// so a warp whose lanes mostly count runs no divergent path.
__device__ __forceinline__ void count_if(unsigned* c, bool on) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.u32 p, %1, 0;\n"
      "@p red.shared.add.u32 [%0], 1;\n}" ::"r"(smem_u32(c)),
      "r"(static_cast<unsigned>(on))
      : "memory");
}

struct ClusterShared {
  unsigned h[D0];                   // digit counts; CTA 0: the cluster's
  unsigned long long es[NEXP];      // far mantissas above d0; CTA 0: all
  unsigned long long near;          // CTA 0: the cluster's near sum
  unsigned xread;                   // elements of x loaded; CTA 0: all
  unsigned wsum[CT / 32];
  Sel sel;                          // this level's choice, from CTA 0
  unsigned long long bars[CT / 32];  // each warp's bulk copy's mbarrier
  Finish fin;
};

// A barrier of the whole cluster (of the CTA alone when the cluster is
// one CTA), ordering shared and distributed shared memory.
__device__ __forceinline__ void cluster_barrier(const cg::cluster_group& cl,
                                                unsigned csize) {
  if (csize > 1) {
    cl.sync();
  } else {
    __syncthreads();
  }
}

// A CTA other than 0 adds its counts of digits [0, nd) into CTA 0's and
// zeroes its own, for the next level.
__device__ __forceinline__ void push_counts(const cg::cluster_group& cl,
                                            unsigned* h, int nd) {
  unsigned* dst = cl.map_shared_rank(h, 0);
  for (int i = threadIdx.x; i < nd; i += CT) {
    const unsigned c = h[i];
    if (c != 0u) {
      atomicAdd(dst + i, c);
      h[i] = 0u;
    }
  }
}

// CTA 0 reads the cluster's counts of thread t's digits ND-1-(t*PER+q)
// (descending) and zeroes them, for the next level.
template <int ND>
__device__ __forceinline__ void take_counts(unsigned* h,
                                            unsigned (&c)[ND / CT]) {
#pragma unroll
  for (int q = 0; q < ND / CT; ++q) {
    const int d = ND - 1 - (threadIdx.x * (ND / CT) + q);
    c[q] = h[d];
    h[d] = 0u;
  }
}

// CTA 0 hands its choice to every CTA of the cluster (after pick_digit's
// barrier); the next cluster barrier publishes it.
__device__ __forceinline__ void share_choice(const cg::cluster_group& cl,
                                             unsigned csize, Sel* sel) {
  if (threadIdx.x > 0 && threadIdx.x < csize) {
    *cl.map_shared_rank(sel, threadIdx.x) = *sel;
  }
}

__global__ void __launch_bounds__(CT, 2)
    cluster_select_kernel(const float* __restrict__ x,
                          const float* __restrict__ scale,
                          const long long* __restrict__ bin_in,
                          const long long* __restrict__ rank_in,
                          float* __restrict__ v_out, int* __restrict__ cnt_out,
                          float* __restrict__ sum_out,
                          long long* __restrict__ read_out, int64_t n,
                          int64_t per) {
  extern __shared__ __align__(16) unsigned keys[];
  __shared__ ClusterShared sh;
  const cg::cluster_group cl = cg::this_cluster();
  const unsigned crank = cl.block_rank();
  const unsigned csize = cl.num_blocks();
  const bool lead = crank == 0;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t row = blockIdx.y;
  for (int i = tid; i < D0; i += CT) sh.h[i] = 0u;
  for (int i = tid; i < NEXP; i += CT) sh.es[i] = 0ull;
  if (tid == 0) {
    sh.near = 0ull;
    sh.xread = 0u;
  }
  STAMP(0);

  // this CTA's slice [e0, e1) of the row; element e sits at slot e - base,
  // base chosen so that the 16-byte-aligned body [a0, a1) lands 16-byte
  // aligned; the slots before lo and from hi to span hold NOT_KEY.  Warp w
  // owns slots [ws, we): it copies its part of the body with one bulk copy
  // on its own mbarrier, loads or pads its other slots, finds the bin's
  // bounds while the copy runs, and starts level 0 when its slots are in.
  const float* xr = x + row * n;
  const int64_t e0 = lmin(static_cast<int64_t>(crank) * per, n);
  const int64_t e1 = lmin(e0 + per, n);
  const int64_t skew = static_cast<int64_t>(
      ((16u - (reinterpret_cast<uintptr_t>(xr + e0) & 15u)) & 15u) / 4u);
  const int64_t a0 = lmin(e0 + skew, e1);
  const int64_t a1 = a0 + ((e1 - a0) & ~int64_t{3});
  const int64_t base = a0 - ((a0 - e0 + 3) & ~int64_t{3});
  const int lo = static_cast<int>(e0 - base);
  const int hi = static_cast<int>(e1 - base);
  const int span = (hi + 3) & ~3;
  const int bs = static_cast<int>(a0 - base);  // the body's slots
  const int be = static_cast<int>(a1 - base);
  const int seg = ((span + CT / 32 - 1) / (CT / 32) + 3) & ~3;
  const int ws = min(warp * seg, span);
  const int we = min(ws + seg, span);
  const unsigned bar = smem_u32(&sh.bars[warp]);
  if (lane == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  // every CTA's zeroed counts before any CTA adds to CTA 0's: the cluster
  // barrier's arrival now, its wait after the first level's count
  if (csize > 1) asm volatile("barrier.cluster.arrive.aligned;" ::: "memory");
  const int p0 = max(ws, bs), p1 = min(we, be);
  const unsigned bytes = p1 > p0 ? static_cast<unsigned>(p1 - p0) * 4u : 0u;
  if (lane == 0) {
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
        "r"(bytes)
        : "memory");
    if (bytes != 0u) {
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], %2, [%3];" ::"r"(smem_u32(keys + p0)),
          "l"(reinterpret_cast<uint64_t>(xr + base + p0)), "r"(bytes),
          "r"(bar)
          : "memory");
      atomicAdd(&sh.xread, bytes / 4u);
    }
  } else if (lane <= 8) {  // slots [0, bs) on lanes 1-4, [be, span) on 5-8
    const int i = lane <= 4 ? lane - 1 : be + (lane - 5);
    if ((lane <= 4 ? i < bs : i < span) && i >= ws && i < we) {
      const bool in = i >= lo && i < hi;
      keys[i] = in ? __float_as_uint(__ldg(xr + base + i)) : NOT_KEY;
      if (in) atomicAdd(&sh.xread, 1u);
    }
  }
  unsigned bound = 0u;
  if (lane >= 30) {
    bound = first_key(scale[row], static_cast<int>(bin_in[row]) + lane - 30);
  }
  const Bin bin{__shfl_sync(FULL, bound, 30),
                __shfl_sync(FULL, bound, 31) - __shfl_sync(FULL, bound, 30)};
  {
    unsigned done = 0u;
    while (!done) {
      asm volatile(
          "{\n.reg .pred p;\n"
          "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
          "selp.u32 %0, 1, 0, p;\n}"
          : "=r"(done)
          : "r"(bar)
          : "memory");
    }
  }
  __syncwarp();
  if (warp == 0) STAMP(1);

  // level 0: each thread turns its elements into keys in place, 4 slots
  // at a time (ws + 128 m + 4 lane, m = 0, 1, ...), a non-candidate into 0,
  // and counts the candidates' level-0 digits.  A 0 never counts again: the
  // levels below read keys at or above d0's least key only, and a zero
  // candidate matters only as v = 0, which level 0 already decides.
  for (int i = ws + 4 * lane; i < we; i += 128) {
    uint4 q = *reinterpret_cast<const uint4*>(keys + i);
    unsigned* k4[4] = {&q.x, &q.y, &q.z, &q.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const unsigned key = flushed_key(*k4[j]);
      const bool on = bin.holds(key);
      count_if(sh.h + (key >> 20), on);
      *k4[j] = on ? key : 0u;
    }
    *reinterpret_cast<uint4*>(keys + i) = q;
  }
  __syncthreads();
  STAMP(2);
  if (csize > 1) {
    asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
    if (!lead) push_counts(cl, sh.h, D0);
  }
  cluster_barrier(cl, csize);
  if (lead) {
    unsigned c[D0 / CT];
    take_counts<D0>(sh.h, c);
    pick_digit<D0, CT>(c, first_rank(rank_in, row), true, &sh.sel, sh.wsum);
    share_choice(cl, csize, &sh.sel);
  }
  cluster_barrier(cl, csize);
  const Sel sel0 = sh.sel;
  const unsigned d0 = sel0.digit;
  const unsigned eb = near_base(d0);
  const bool deep = d0 >= 8u;  // below 8, d0 holds zeros alone: v = 0
  STAMP(3);

  // level 1: each thread first keeps its keys at or above d0's least key
  // (about r of the row, plus d0's), compacted in place at slot(0 .. m): the
  // k-th kept key of a thread goes to the k-th slot it has read, at or
  // before the one it reads, without a branch, so that a warp runs no
  // divergent path for the few.  Then those above d0 add to the near sum
  // (or by exponent), and d0's count their level-1 digit and stay, at
  // slot(0 .. kept).
  auto slot = [&](int k) { return ws + 128 * (k >> 2) + 4 * lane + (k & 3); };
  const unsigned d0_key = d0 << 20;  // the least key of d0
  int m = 0;
  for (int i = ws + 4 * lane; i < we; i += 128) {
    const uint4 q = *reinterpret_cast<const uint4*>(keys + i);
    if (max(max(q.x, q.y), max(q.z, q.w)) < d0_key) continue;
    const unsigned k4[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool ge = k4[j] >= d0_key;
      if (ge) keys[slot(m)] = k4[j];
      m += ge;
    }
  }
  unsigned long long near = 0ull;
  int kept = 0;
  for (int k = 0; k < m; ++k) {
    const unsigned key = keys[slot(k)];
    if (key >> 20 > d0) {
      add_above(key, eb, near, sh.es);
    } else if (deep) {
      atomicAdd(sh.h + ((key >> 10) & 1023u), 1u);
      keys[slot(kept++)] = key;
    }
  }
  __syncthreads();
  STAMP(4);
  if (!lead) push_counts(cl, sh.h, D12);
  cluster_barrier(cl, csize);
  if (lead) {
    unsigned c[D12 / CT];
    take_counts<D12>(sh.h, c);
    pick_digit<D12, CT>(c, sel0.rank, false, &sh.sel, sh.wsum);
    share_choice(cl, csize, &sh.sel);
  }
  cluster_barrier(cl, csize);
  const Sel sel1 = sh.sel;
  const unsigned d1 = sel1.digit;
  STAMP(5);

  // level 2: d0's candidates above d1 add to the near sum; those of d1
  // count their level-2 digit
  for (int k = 0; k < kept; k += 4) {
    const uint4 q = *reinterpret_cast<const uint4*>(keys + slot(k));
    const unsigned k4[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const unsigned key = k4[j];
      const unsigned dg = (key >> 10) & 1023u;
      if (k + j < kept && dg > d1) near += mant(key);
      if (k + j < kept && dg == d1) atomicAdd(sh.h + (key & 1023u), 1u);
    }
  }
  STAMP(6);
  near = cta_sum_u64<CT>(near, sh.fin.red);
  if (tid == 0 && near != 0ull) {
    atomicAdd(cl.map_shared_rank(&sh.near, 0), near);
  }
  if (!lead) {
    if (tid == 0) atomicAdd(cl.map_shared_rank(&sh.xread, 0), sh.xread);
    push_counts(cl, sh.h, D12);
    unsigned long long* es0 = cl.map_shared_rank(sh.es, 0);
    for (int e = tid; e < NEXP; e += CT) {
      if (sh.es[e] != 0ull) atomicAdd(es0 + e, sh.es[e]);
    }
  }
  cluster_barrier(cl, csize);  // CTA 0 reads nothing of the others after it
  if (!lead) return;
  STAMP(7);
  if (tid == 0) read_out[row] = sh.xread;
  unsigned c[D12 / CT];
  take_counts<D12>(sh.h, c);
  pick_digit<D12, CT>(c, sel1.rank, false, &sh.sel, sh.wsum);
  const Sel sel2 = sh.sel;
  finish_row<CT>((d0 << 20) | (d1 << 10), sel2, c, sel0.above + sel1.above,
                 sh.near, [&](int e) { return sh.es[e]; }, sh.fin, v_out,
                 cnt_out, sum_out, row);
  STAMP(8);
}

// ------------------------------------------------------------ two_read

// Calls f(bits, valid) for this CTA's share of the row: batches of
// THREADS * UNROLL float4s of the 16-byte-aligned body dealt to the CTAs in
// turn (a row's rare elements cluster by layer, and a CTA's contiguous run
// would leave one CTA with most of them), each thread its strided float4s,
// 16 elements a thread a batch with after_batch() after each (the whole
// CTA together), then (CTA 0, warp 0) the head and the tail of at most 3
// scalars each.  Returns how many elements of x the thread loaded.
template <class F, class G>
__device__ __forceinline__ unsigned long long stream_row(const float* xr,
                                                         int64_t n, F&& f,
                                                         G&& after_batch) {
  constexpr int64_t BATCH = THREADS * UNROLL;
  const int64_t skew = static_cast<int64_t>(
      ((16u - (reinterpret_cast<uintptr_t>(xr) & 15u)) & 15u) / 4u);
  const int64_t head = skew < n ? skew : n;
  const int64_t nv = (n - head) / 4;
  const uint4* body = reinterpret_cast<const uint4*>(xr + head);
  unsigned long long loaded = 0ull;
  for (int64_t b0 = static_cast<int64_t>(blockIdx.x) * BATCH; b0 < nv;
       b0 += static_cast<int64_t>(gridDim.x) * BATCH) {
    uint4 q[UNROLL];
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      const int64_t i = b0 + k * THREADS + threadIdx.x;
      q[k] = i < nv ? __ldg(body + i) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      const bool ok = b0 + k * THREADS + threadIdx.x < nv;
      loaded += ok ? 4u : 0u;
      f(q[k].x, ok);
      f(q[k].y, ok);
      f(q[k].z, ok);
      f(q[k].w, ok);
    }
    after_batch();
  }
  if (blockIdx.x == 0 && threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const int64_t i = lane < 3 ? lane : head + 4 * nv + (lane - 3);
    const bool ok = lane < 3 ? lane < head : (lane < 6 && i < n);
    f(ok ? __float_as_uint(xr[i]) : 0u, ok);
    loaded += ok ? 1u : 0u;
  }
  return loaded;
}

// Thread 0 publishes the CTA's global writes and takes the row's ticket;
// true in every thread of the row's last CTA, whose later loads then see
// every other CTA's writes.
__device__ __forceinline__ bool last_cta_of_row(unsigned* ticket) {
  __shared__ bool last;
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("fence.acq_rel.gpu;" ::: "memory");
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
    if (last) asm volatile("fence.acq_rel.gpu;" ::: "memory");
  }
  __syncthreads();
  return last;
}

// The CTA's nonzero counts of digits [0, nd) added to the row's.
__device__ __forceinline__ void flush_counts(const unsigned* h, int nd,
                                             unsigned* g) {
  for (int i = threadIdx.x; i < nd; i += THREADS) {
    if (h[i] != 0u) atomicAdd(g + i, h[i]);
  }
}

// The row's counts of thread t's digits ND-1-(t*PER+q), read from L2 and
// zeroed for the next call.
template <int ND>
__device__ __forceinline__ void take_row_counts(
    unsigned* g, unsigned (&c)[ND / THREADS]) {
#pragma unroll
  for (int q = 0; q < ND / THREADS; ++q) {
    const int d = ND - 1 - (threadIdx.x * (ND / THREADS) + q);
    c[q] = __ldcg(g + d);
    g[d] = 0u;
  }
}

// Pass A: the level-0 digit counts of the row's candidates, and d0.
__global__ void __launch_bounds__(THREADS)
    level0_pass_kernel(const float* __restrict__ x,
                       const float* __restrict__ scale,
                       const long long* __restrict__ bin_in,
                       const long long* __restrict__ rank_in,
                       RowScratch* __restrict__ scratch, int64_t n) {
  __shared__ unsigned h[D0];
  __shared__ unsigned wsum[THREADS / 32];
  __shared__ unsigned long long red[THREADS / 32];
  __shared__ unsigned bounds[2];
  __shared__ Sel sel;
  const int64_t row = blockIdx.y;
  RowScratch* rs = scratch + row;
  for (int i = threadIdx.x; i < D0; i += THREADS) h[i] = 0u;
  if (threadIdx.x < 32) {
    find_bin(scale[row], static_cast<int>(bin_in[row]), bounds);
  }
  __syncthreads();
  const Bin bin{bounds[0], bounds[1] - bounds[0]};
  const unsigned long long loaded = cta_sum_u64<THREADS>(
      stream_row(
          x + row * n, n,
          [&](unsigned bits, bool ok) {
            const unsigned key = flushed_key(bits);
            count_if(h + (key >> 20), ok && bin.holds(key));
          },
          [] {}),
      red);
  if (threadIdx.x == 0) atomicAdd(&rs->xread, loaded);
  flush_counts(h, D0, rs->g0);
  if (!last_cta_of_row(&rs->ticket)) return;
  unsigned c[D0 / THREADS];
  take_row_counts<D0>(rs->g0, c);
  pick_digit<D0, THREADS>(c, first_rank(rank_in, row), true, &sel, wsum);
  if (threadIdx.x == 0) {
    rs->d0 = sel.digit;
    rs->rank = sel.rank;
    rs->above = sel.above;
    rs->ticket = 0u;
  }
}

// Pass B: the candidates above d0 into the near sum (or by exponent), d0's
// level-1 digit counts, d0's candidates into the buffer, and d1.
__global__ void __launch_bounds__(THREADS)
    level1_pass_kernel(const float* __restrict__ x,
                       const float* __restrict__ scale,
                       const long long* __restrict__ bin_in,
                       RowScratch* __restrict__ scratch,
                       unsigned* __restrict__ buf, int64_t cap, int64_t n) {
  extern __shared__ unsigned stage[];     // THREADS / 32 x STAGE keys
  __shared__ unsigned h[D12];
  __shared__ unsigned long long es[NEXP];
  __shared__ unsigned long long red[THREADS / 32];
  __shared__ unsigned staged[THREADS / 32];
  __shared__ unsigned wsum[THREADS / 32];
  __shared__ unsigned bounds[2];
  __shared__ Sel sel;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t row = blockIdx.y;
  RowScratch* rs = scratch + row;
  for (int i = threadIdx.x; i < D12; i += THREADS) h[i] = 0u;
  for (int i = threadIdx.x; i < NEXP; i += THREADS) es[i] = 0ull;
  if (lane == 0) staged[warp] = 0u;
  if (threadIdx.x < 32) {
    find_bin(scale[row], static_cast<int>(bin_in[row]), bounds);
  }
  __syncthreads();
  const Bin bin{bounds[0], bounds[1] - bounds[0]};
  const unsigned d0 = rs->d0;
  const unsigned eb = near_base(d0);
  const bool deep = d0 >= 8u;
  unsigned* st = stage + warp * STAGE;
  unsigned* dst = buf + row * cap;
  // the warp's staged keys to the buffer, when more than `room` of them
  auto flush = [&](unsigned room) {
    __syncwarp();
    const unsigned c = staged[warp];
    if (c <= room) return;
    unsigned at = 0u;
    if (lane == 0) at = atomicAdd(&rs->cursor, c);
    at = __shfl_sync(FULL, at, 0);
    for (unsigned j = lane; j < c; j += 32) {
      if (at + j < cap) dst[at + j] = st[j];
    }
    __syncwarp();
    if (lane == 0) staged[warp] = 0u;
    __syncwarp();
  };
  unsigned long long near = 0ull;
  const unsigned long long loaded = stream_row(
      x + row * n, n,
      [&](unsigned bits, bool ok) {
        const unsigned key = flushed_key(bits);
        if (ok && bin.holds(key) && key >> 20 >= d0) {
          if (key >> 20 > d0) {
            add_above(key, eb, near, es);
          } else if (deep) {
            atomicAdd(h + ((key >> 10) & 1023u), 1u);
            st[atomicAdd(staged + warp, 1u)] = key;
          }
        }
      },
      [&] { flush(STAGE_ROOM); });
  flush(0u);
  near = cta_sum_u64<THREADS>(near, red);
  if (threadIdx.x == 0 && near != 0ull) atomicAdd(&rs->near, near);
  const unsigned long long got = cta_sum_u64<THREADS>(loaded, red);
  if (threadIdx.x == 0) atomicAdd(&rs->xread, got);
  flush_counts(h, D12, rs->g1);
  for (int i = threadIdx.x; i < NEXP; i += THREADS) {
    if (es[i] != 0ull) atomicAdd(rs->es + i, es[i]);
  }
  if (!last_cta_of_row(&rs->ticket)) return;
  unsigned c[D12 / THREADS];
  take_row_counts<D12>(rs->g1, c);
  pick_digit<D12, THREADS>(c, rs->rank, false, &sel, wsum);
  if (threadIdx.x == 0) {
    rs->d1 = sel.digit;
    rs->rank = sel.rank;
    rs->above += sel.above;
    rs->ticket = 0u;
  }
}

// Pass C: level 2 over the buffer (over x, filtered by d0, when d0 held
// more than `cap`), d2 and the row's outputs.
__global__ void __launch_bounds__(THREADS)
    level2_pass_kernel(const float* __restrict__ x,
                       const float* __restrict__ scale,
                       const long long* __restrict__ bin_in,
                       RowScratch* __restrict__ scratch,
                       const unsigned* __restrict__ buf, int64_t cap,
                       int64_t n, float* __restrict__ v_out,
                       int* __restrict__ cnt_out, float* __restrict__ sum_out,
                       long long* __restrict__ read_out) {
  __shared__ unsigned h[D12];
  __shared__ unsigned wsum[THREADS / 32];
  __shared__ unsigned bounds[2];
  __shared__ Sel sel;
  __shared__ Finish fin;
  const int64_t row = blockIdx.y;
  RowScratch* rs = scratch + row;
  const unsigned d0 = rs->d0, d1 = rs->d1;
  const int64_t held = rs->cursor;
  for (int i = threadIdx.x; i < D12; i += THREADS) h[i] = 0u;
  if (d0 >= 8u && held > cap && threadIdx.x < 32) {
    find_bin(scale[row], static_cast<int>(bin_in[row]), bounds);
  }
  __syncthreads();
  unsigned long long near = 0ull, loaded = 0ull;
  auto level2 = [&](unsigned key, bool on) {
    const unsigned dg = (key >> 10) & 1023u;
    if (on && dg > d1) near += mant(key);
    if (on && dg == d1) atomicAdd(h + (key & 1023u), 1u);
  };
  if (d0 >= 8u && held <= cap) {
    // d0's candidates from the buffer: this CTA's run of 4-aligned groups
    const unsigned* src = buf + row * cap;
    const int64_t per_cta =
        ((held + gridDim.x - 1) / gridDim.x + 3) & ~int64_t{3};
    const int64_t c0 = lmin(static_cast<int64_t>(blockIdx.x) * per_cta, held);
    const int64_t c1 = lmin(c0 + per_cta, held);
    for (int64_t b0 = c0; b0 < c1; b0 += 4 * THREADS) {
      const int64_t i = b0 + 4 * threadIdx.x;
      uint4 q = make_uint4(0u, 0u, 0u, 0u);
      if (i < c1) q = __ldg(reinterpret_cast<const uint4*>(src + i));
      level2(q.x, i < c1);
      level2(q.y, i + 1 < c1);
      level2(q.z, i + 2 < c1);
      level2(q.w, i + 3 < c1);
    }
  } else if (d0 >= 8u) {
    // more than `cap`: d0's candidates from x again
    const Bin bin{bounds[0], bounds[1] - bounds[0]};
    loaded = stream_row(
        x + row * n, n,
        [&](unsigned bits, bool ok) {
          const unsigned key = flushed_key(bits);
          level2(key, ok && key >> 20 == d0 && bin.holds(key));
        },
        [] {});
  }
  near = cta_sum_u64<THREADS>(near, fin.red);
  if (threadIdx.x == 0 && near != 0ull) atomicAdd(&rs->near, near);
  loaded = cta_sum_u64<THREADS>(loaded, fin.red);
  if (threadIdx.x == 0 && loaded != 0ull) atomicAdd(&rs->xread, loaded);
  flush_counts(h, D12, rs->g2);
  if (!last_cta_of_row(&rs->ticket)) return;
  unsigned c[D12 / THREADS];
  take_row_counts<D12>(rs->g2, c);
  pick_digit<D12, THREADS>(c, rs->rank, false, &sel, wsum);
  const Sel sel2 = sel;
  if (threadIdx.x == 0) {
    rs->seen = static_cast<unsigned>(held);
    read_out[row] = static_cast<long long>(__ldcg(&rs->xread));
    rs->xread = 0ull;
  }
  finish_row<THREADS>((d0 << 20) | (d1 << 10), sel2, c, rs->above,
                      __ldcg(&rs->near),
                      [&](int e) {
                        const unsigned long long t = __ldcg(rs->es + e);
                        rs->es[e] = 0ull;
                        return t;
                      },
                      fin, v_out, cnt_out, sum_out, row);
  if (threadIdx.x == 0) {
    rs->near = 0ull;
    rs->cursor = 0u;
    rs->ticket = 0u;
  }
}

constexpr int STAGE_BYTES = THREADS / 32 * STAGE * 4;  // pass B's dynamic

// The kernels' shared-memory and cluster-size limits, once per device.
cudaError_t configure_kernels() {
  static bool configured[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (configured[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(cluster_select_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (CLUSTER_KEYS + 4) * 4);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(
        cluster_select_kernel,
        cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(level1_pass_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               STAGE_BYTES);
  }
  if (err == cudaSuccess) configured[dev] = true;
  return err;
}

// The cluster route's launch configuration for rows of n elements in
// clusters of `cluster` CTAs (attr holds its cluster dimension).
cudaLaunchConfig_t cluster_config(int rows, long long n, int cluster,
                                  cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  const int64_t per = (n + cluster - 1) / cluster;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(cluster),
                     static_cast<unsigned>(rows), 1);
  cfg.blockDim = dim3(CT, 1, 1);
  cfg.dynamicSmemBytes = static_cast<size_t>((per + 4 + 3) & ~int64_t{3}) * 4;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = static_cast<unsigned>(cluster);
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

bool cluster_fits(long long n, int cluster) {
  return cluster >= 1 && cluster <= MAX_CLUSTER &&
         !(cluster & (cluster - 1)) &&
         (n + cluster - 1) / cluster <= CLUSTER_KEYS;
}

}  // namespace

// Bytes of the two_read route's scratch a row (zeroed once by the caller;
// the kernels leave it zeroed again, but for `seen`).
extern "C" long long candidate_select_scratch_bytes() {
  return static_cast<long long>(sizeof(RowScratch));
}

// How many clusters of `cluster` CTAs, each holding its share of an
// n-element row, the card can run at once (cudaOccupancyMaxActiveClusters);
// a negative cudaError_t when the query fails.
extern "C" int candidate_select_max_clusters(long long n, int cluster) {
  if (n <= 0 || !cluster_fits(n, cluster)) {
    return -static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = configure_kernels();
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(1, n, cluster, nullptr, &attr);
  int count = 0;
  err = cudaOccupancyMaxActiveClusters(&count, cluster_select_kernel, &cfg);
  return err == cudaSuccess ? count : -static_cast<int>(err);
}

#ifdef BIN_SELECT_STAMPS
// The 16 stamps of the last stamped launch (globaltimer, ns).
extern "C" int candidate_select_stamps(unsigned long long* out) {
  return static_cast<int>(
      cudaMemcpyFromSymbol(out, g_stamps, sizeof(g_stamps)));
}
#endif

// The cluster route.  x (rows, n) f32; scale (rows,) f32; bin and rank
// (rows,) int64 (from locate_bin: the candidate bin and the rank inside it,
// 1-based).  Writes v (rows,) f32, cnt (rows,) int32, sum (rows,) f32 and
// reads (rows,) int64, the elements of x the launch loaded for each row.
// One launch of rows clusters of `cluster` CTAs (a power of two up to 16
// that holds the row, CLUSTER_KEYS elements a CTA) on `stream`; returns its
// error (a cluster that cannot be placed is refused here).
extern "C" int candidate_select_cluster_f32(const void* x, const void* scale,
                                            const void* bin, const void* rank,
                                            void* v, void* cnt, void* sum,
                                            void* reads, int rows,
                                            long long n, int cluster,
                                            void* stream) {
  if (rows <= 0 || n <= 0) return 0;
  if (!cluster_fits(n, cluster)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = configure_kernels();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(
      rows, n, cluster, static_cast<cudaStream_t>(stream), &attr);
  err = cudaLaunchKernelEx(
      &cfg, cluster_select_kernel, static_cast<const float*>(x),
      static_cast<const float*>(scale), static_cast<const long long*>(bin),
      static_cast<const long long*>(rank), static_cast<float*>(v),
      static_cast<int*>(cnt), static_cast<float*>(sum),
      static_cast<long long*>(reads), static_cast<int64_t>(n),
      static_cast<int64_t>((n + cluster - 1) / cluster));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The two_read route, same inputs and outputs.  ``scratch`` holds rows
// RowScratch entries (zeroed), ``buf`` rows * cap words (cap a multiple of
// 4).  Launches the three passes over grids of blocks_per_row CTAs a row on
// ``stream``; returns the first launch error.
extern "C" int candidate_select_two_read_f32(
    const void* x, const void* scale, const void* bin, const void* rank,
    void* v, void* cnt, void* sum, void* reads, void* scratch, void* buf,
    int rows,
    long long n, int blocks_per_row, long long cap, void* stream) {
  if (rows <= 0 || n <= 0) return 0;
  if (blocks_per_row <= 0 || cap <= 0 || (cap & 3) || n >= (1ll << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>(blocks_per_row),
                  static_cast<unsigned>(rows));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* sf = static_cast<const float*>(scale);
  const long long* bf = static_cast<const long long*>(bin);
  RowScratch* rs = static_cast<RowScratch*>(scratch);
  unsigned* bu = static_cast<unsigned*>(buf);
  cudaError_t err = configure_kernels();
  if (err != cudaSuccess) return static_cast<int>(err);
  level0_pass_kernel<<<grid, THREADS, 0, st>>>(
      xf, sf, bf, static_cast<const long long*>(rank), rs, n);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  level1_pass_kernel<<<grid, THREADS, STAGE_BYTES, st>>>(xf, sf, bf, rs, bu,
                                                         cap, n);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  level2_pass_kernel<<<grid, THREADS, 0, st>>>(
      xf, sf, bf, rs, bu, cap, n, static_cast<float*>(v),
      static_cast<int*>(cnt), static_cast<float*>(sum),
      static_cast<long long*>(reads));
  return static_cast<int>(cudaGetLastError());
}

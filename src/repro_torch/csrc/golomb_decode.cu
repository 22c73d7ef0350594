// Golomb field decode of the ternary wire stream, on the card.
//
// Replaces, on the ternary decode path, the Pallas kernel `_unpack_kernel`
// of src/repro/kernels/wiredecode.py (entry `unpack_bits_words`) together
// with the host field scan that consumed its bits
// (src/repro/core/wire.py::_decode_stream_fields).  The TPU kernel expanded
// every stream bit to a byte because a TPU has no cheap bit scan; here one
// thread finds the next unary terminator in a register with __clz and the
// fields never leave the card as bits.
//
// What it computes, for segments i of a word-aligned batch (segment i owns
// stream bits [bit_start_i, bit_start_i + bit_len_i)): each segment is a
// chain of Golomb codewords -- q ones, a 0 terminator, b remainder bits (MSB
// first), one sign bit -- starting at the segment's first bit, every next
// codeword starting b + 2 bits past the previous terminator.  Codeword k of
// segment i lands at output out_base_i + k with
//
//     position = sum_{k' <= k} (q 2^b + r + 1) - 1,  sign = +-1.0
//
// and a per-segment status (codewords decoded; the last state, whose FINAL
// bit says the chain ended exactly on the segment end and whose OVERRUN bit
// says a codeword ran past it; the last position), from which the wrapper
// raises on truncated codewords, dangling unary runs, a count other than the
// advertised nnz, and a position past numel.
//
// (The owning segment of each codeword is the advertised counts spelled out,
// which the status confirms, so the wrapper writes it on the host.)
//
// Bound: memory.  4 bytes read a word, 12 written a codeword (position 8,
// sign 4); a cnn round (W = 15,564, 61,480 codewords) is 0.80 MB, 0.24 us at
// 3.35 TB/s.  The decode is a chain of dependent steps, so what
// limits it is latency.  The design is a speculative chunk decode in ONE
// launch: each segment is owned by one thread block cluster of C CTAs
// (kernels/wiredecode.py::decode_plan picks C from the batch's shape), and
// nothing but the fields and the status goes to device memory.
//
// A segment is cut into word-aligned chunks of 128 bits; a chunk owns the
// codewords whose terminator lies in it.  The state entering a chunk is the
// offset e in [0, b+1] at which its first codeword starts, or "inside an
// open unary run" (which decodes like e = 0 with the run's ones added to the
// first quotient).  A decode from one state to the chunk end is a record
// (exit state, codewords, gap sum), and the records of consecutive chunks
// compose associatively, as maps from entry state to exit state.
//
// The cluster walks its segment in tiles of C x `per` chunks (`per` at most
// the plan's tile, at most TILE; one tile for every segment on the paths),
// CTA j taking chunks [j per, (j+1) per) of the tile.  Each CTA, in shared
// memory:
//
// 1. stages its chunks' words (and the two after) with coalesced loads;
// 2. decodes every (chunk, entry state) pair -- one thread a pair, a 64-bit
//    window of three shared words a codeword -- to its record, keeping each
//    owned codeword's gap sum so far and its sign (the speculative decode:
//    one of a chunk's S decodes is the true one);
// 3. composes the maps of each group of GROUP chunks from every state (a
//    thread a (group, state), keeping the prefix before each chunk of the
//    group);
// 4. composes the group maps with one warp whose lane e holds the map's
//    record from state e: the next group's records come in one load a lane
//    and the lookup of each lane's exit state is a __shfl_sync, so no
//    barrier separates the steps; the warp keeps the prefix map before each
//    group and ends with the CTA's map, which it stores into the shared
//    memory of every CTA of the cluster (distributed shared memory; the
//    first time only once a cluster barrier, whose arrival each CTA made at
//    its start, says that every CTA of the cluster runs);
// 5. after one cluster barrier, thread 0 carries the segment's cursor
//    (state 0 at the tile's first bit, or the last tile's exit) through
//    the CTA maps before it (at most C - 1 lookups), which gives the CTA's
//    true entry, and on through the rest, which gives the tile's exit; a
//    thread a chunk then carries the CTA's entry through the prefix before
//    its group and the one before it inside the group (two lookups), which
//    picks the true one of the chunk's decodes;
// 6. one warp a chunk writes the codewords of that decode, a lane a
//    codeword: no second decode.
//
// The composition is a chain of dependent lookups (~0.1 us each on an
// H100).  Scans of the whole CTA (Hillis-Steele over the chunk maps, the
// group maps or the CTA maps, a barrier a step) cost ~0.35 us a step there
// and took longer at the paths' shapes, as did 64-bit chunks (a shorter
// decode, but twice the chunks to compose), warp walks in place of step 3's
// and step 5's lookups, and a decode from a 64-bit register window
// (PERF.md section 6).
//
// CTA 0's thread 0 writes the status from the last tile's exit; an empty
// segment (no chunks) gets the status of an empty chain.  Outputs are sized
// by the advertised nnz, so a segment that decodes more codewords than it
// advertised writes no more than its share (the wrapper then raises on its
// count).  A chunk's chain from its true entry is the chain the serial
// decoder follows, so the fields are bitwise the host scan's on every valid
// batch.
//
// Sizes: 128-bit chunks (~15 codewords at p = 1/50), groups of 8, at most
// 64 chunks a CTA (a cnn message of ~390 chunks in one tile of a cluster of
// 8); a CTA's shared memory grows with its chunks and b: 71 KB for 49
// chunks at b = 5, 179 KB at most (64 chunks, b = 29).

#include <climits>
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int CHUNK_BITS = 128;               // 4 words a chunk
constexpr int CHUNK_WORDS = CHUNK_BITS / 32;
constexpr int TILE = 64;                      // chunks a CTA holds at most
constexpr int GROUP = 8;                      // chunks a thread composes
constexpr int MAX_CLUSTER = 16;
constexpr int MAX_STATES = 32;                // b + 2 at b = 30
constexpr int MAX_THREADS = 512;
constexpr int EXIT_U = 63;         // exit state: inside an open unary run
constexpr int FINAL = 64;          // the chain met its segment's final codeword
constexpr int OVERRUN = 128;       // a codeword ran past its segment's end
constexpr unsigned FULL = 0xFFFFFFFFu;

// The segment table, int64 rows of META_COLS: first bit, bit length, first
// output; row n_segments holds the output total in its last column.
constexpr int META_COLS = 3;

// A chunk, or a span of chunks inside one tile, entered from one state.
// `code` is the exit state (an offset into the next chunk, or EXIT_U) |
// FINAL | OVERRUN, and for EXIT_U the open run's ones << 8.
struct Rec {
  long long gaps;  // gap sum of the owned codewords (first quotient local)
  int n;           // owned codewords
  int code;
};
// an open run inside a CTA's span fits the 23 bits `code` keeps for it
static_assert(TILE * CHUNK_BITS < (1 << 23), "tile too long");

// A segment's cursor: its state, the ones of its open run, and the
// codewords and gap sum so far.
struct Acc {
  long long gaps;
  long long run;
  long long n;
  long long code;  // exit state | FINAL | OVERRUN
};

// With -DGOLOMB_DECODE_STAMPS (chip_smoke.py --wire-study builds a copy
// so), thread 0 of CTA 0 records the global timer at each step of its first
// tile of its last launch: STAMP(k) writes stamp k, and a barrier after the
// writes lets stamp 8 see every chunk written.
#ifdef GOLOMB_DECODE_STAMPS
__device__ unsigned long long g_stamps[12];  // 10 steps, 2 SM clocks
#define STAMP(k)                                                       \
  do {                                                                 \
    if (blockIdx.x == 0 && threadIdx.x == 0) {                         \
      unsigned long long t_;                                           \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));           \
      g_stamps[k] = t_;                                                \
      if ((k) == 0 || (k) == 9) g_stamps[10 + (k) / 9] = clock64();    \
    }                                                                  \
  } while (0)
#define STAMP_TILE(k) \
  do {                \
    if (tile == 0) STAMP(k); \
  } while (0)
#define STAMP_WRITTEN() \
  do {                  \
    __syncthreads();    \
    STAMP_TILE(8);      \
  } while (0)
#else
#define STAMP(k) \
  do {           \
  } while (0)
#define STAMP_TILE(k) STAMP(k)
#define STAMP_WRITTEN() STAMP(0)
#endif

// The most codewords a chunk owns from one entry state: its terminators
// lie in its CHUNK_BITS bits, b + 2 bits apart at least.
__host__ __device__ constexpr int max_owned(int b) {
  return (CHUNK_BITS + b + 1) / (b + 2);
}
static_assert(max_owned(0) <= 64, "a chunk's signs fill 64 bits");

// A CTA's shared memory for `tile` chunks at parameter b, in the order of
// the offsets below: the chunk maps and the prefix maps inside each group,
// the group maps (their prefixes once the warp has passed), two buffers of
// the cluster's CTA maps (16 B a state each); each chunk's true entry
// (32 B); each (chunk, state) decode's codewords -- the gap sums so far
// (8 B) and the signs (a bit each, 8 B a pair) -- and the staged words.
__host__ __device__ constexpr long long smem_bytes(int tile, int b) {
  return static_cast<long long>(b + 2) *
             ((2 * tile + (tile + GROUP - 1) / GROUP + 2 * MAX_CLUSTER) * 16 +
              tile * (8 * max_owned(b) + 8)) +
         32 * tile + 4 * (CHUNK_WORDS * tile + 4);
}

// 64 stream bits from chunk bit r (r <= CHUNK_BITS), MSB first, as two
// words: the chunk's words are w[0 ..], and w holds two words past it.
__device__ __forceinline__ void window(const uint32_t* w, int r, uint32_t* hi,
                                       uint32_t* lo) {
  const int i = r >> 5, sh = r & 31;
  const uint32_t w0 = w[i], w1 = w[i + 1], w2 = w[i + 2];
  *hi = __funnelshift_l(w1, w0, sh);
  *lo = __funnelshift_l(w2, w1, sh);
}

// The first 0 bit at a chunk bit in [r, lim), or lim: a run of ones longer
// than a window.
__device__ __noinline__ int first_zero(const uint32_t* w, int r, int lim) {
  while (r < lim) {
    uint32_t hi, lo;
    window(w, r, &hi, &lo);
    if (~hi) {
      const int t = r + __clz(~hi);
      return t < lim ? t : lim;
    }
    r += 32;
  }
  return lim;
}

// Decode a chunk of `len` bits (the segment ends `lim` bits past its first
// bit, clamped to 2 x CHUNK_BITS) from offset e: its record, and each owned
// codeword's gap sum so far (cum[j]) and sign (bit j of *signs).  One
// window of 64 bits serves a codeword whose unary run is shorter than 32.
__device__ __forceinline__ Rec transition(const uint32_t* w, int len, int lim,
                                          int e, int b, long long* cum,
                                          unsigned long long* signs) {
  long long gaps = 0;
  unsigned long long sg = 0;
  int r = e, n = 0, code;
  for (;;) {
    if (r >= len) {                        // next codeword starts past len
      code = r - len;
      break;
    }
    uint32_t hi, lo, f;
    window(w, r, &hi, &lo);
    const int z = __clz(~hi);              // 32 when hi is all ones
    int t;
    if (z < 32) {                          // the tail: window bits z+1 ..
      t = r + z;
      f = __funnelshift_lc(lo, hi, z + 1) >> (31 - b);
    } else {
      t = first_zero(w, r + 32, len);
      uint32_t thi, tlo;
      window(w, t + 1, &thi, &tlo);
      f = thi >> (31 - b);
    }
    if (t >= len) {                        // open run to the chunk end
      code = EXIT_U | (len - r) << 8;
      break;
    }
    const int next = t + b + 2;
    if (next > lim) {
      code = OVERRUN;
      break;
    }
    gaps += (static_cast<long long>(t - r) << b) + (f >> 1) + 1;
    cum[n] = gaps;
    sg |= static_cast<unsigned long long>(f & 1u) << n;
    ++n;
    if (next == lim) {
      code = FINAL;
      break;
    }
    r = next;
  }
  *signs = sg;
  return Rec{gaps, n, code};
}

__device__ __forceinline__ int open_run(int code) {
  return (code & EXIT_U) == EXIT_U ? code >> 8 : 0;
}

// The state of `next` (a map, one record a state) that `code` enters.
__device__ __forceinline__ int entered(int code) {
  const int exit = code & EXIT_U;
  return (code & (FINAL | OVERRUN)) || exit == EXIT_U ? 0 : exit;
}

// Span `a`, then the span whose record from a's exit is z (from state 0
// when a ends inside an open unary run, which then grows z's first
// quotient); selects, no branches.
__device__ __forceinline__ Rec join(const Rec& a, const Rec& z, int b) {
  const bool done = a.code & (FINAL | OVERRUN);
  const bool u = (a.code & EXIT_U) == EXIT_U;
  const int run = u ? a.code >> 8 : 0;
  const bool grow = u && z.n == 0 && (z.code & EXIT_U) == EXIT_U;
  const Rec j{a.gaps + z.gaps + (z.n > 0 ? static_cast<long long>(run) << b
                                         : 0),
              a.n + z.n, grow ? z.code + (run << 8) : z.code};
  return done ? a : j;
}

__device__ __forceinline__ Rec then(const Rec& a, const Rec* next, int b) {
  return join(a, next[entered(a.code)], b);
}

// The same for a segment's cursor.
__device__ __forceinline__ Acc then(const Acc& a, const Rec* next, int b) {
  const bool done = a.code & (FINAL | OVERRUN);
  const bool u = (a.code & EXIT_U) == EXIT_U;
  const Rec z = next[done || u ? 0 : static_cast<int>(a.code & EXIT_U)];
  const long long zrun = open_run(z.code);
  const Acc j{a.gaps + z.gaps + (u && z.n > 0 ? a.run << b : 0),
              zrun + (u && z.n == 0 ? a.run : 0), a.n + z.n, z.code & 0xFF};
  return done ? a : j;
}

// A barrier of the whole cluster (of the CTA alone when the cluster is one
// CTA), ordering shared and distributed shared memory.
__device__ __forceinline__ void cluster_barrier(const cg::cluster_group& cl,
                                                int csize) {
  if (csize > 1) {
    cl.sync();
  } else {
    __syncthreads();
  }
}

__global__ void __launch_bounds__(MAX_THREADS, 2)
    decode_kernel(const uint32_t* __restrict__ w,
                  const long long* __restrict__ meta, int b, int csize,
                  int cap, long long* __restrict__ out_pos,
                  float* __restrict__ out_sign,
                  long long* __restrict__ status) {
  STAMP(0);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ Acc cursor;                 // the segment's, thread 0's
  __shared__ Acc entry;                  // this CTA's true entry
  const int S = b + 2, K = max_owned(b), tid = threadIdx.x, T = blockDim.x;
  const int groups = (cap + GROUP - 1) / GROUP;
  Rec* m = reinterpret_cast<Rec*>(smem_raw);  // the maps, by offset:
  const int chunk_maps = 0;                   // [cap][S]
  const int chunk_pre = cap * S;              // [cap][S]
  const int group_maps = 2 * cap * S;         // [groups][S]
  const int cta_maps = group_maps + groups * S;  // 2 x [MAX_CLUSTER][S]
  Acc* ents = reinterpret_cast<Acc*>(m + cta_maps + 2 * MAX_CLUSTER * S);
  long long* cums = reinterpret_cast<long long*>(ents + cap);
  unsigned long long* signs =                         // [cap][S]
      reinterpret_cast<unsigned long long*>(cums + cap * S * K);
  uint32_t* words = reinterpret_cast<uint32_t*>(signs + cap * S);
  const cg::cluster_group cl = cg::this_cluster();
  const int rank = static_cast<int>(blockIdx.x % csize);
  const long long seg = blockIdx.x / csize;
  const long long* row = meta + META_COLS * seg;
  const long long start = row[0], end = start + row[1];
  const long long out0 = row[2], nnz = row[META_COLS + 2] - out0;
  const long long nc = (row[1] + CHUNK_BITS - 1) / CHUNK_BITS;
  const long long per =
      nc < static_cast<long long>(cap) * csize ? (nc + csize - 1) / csize
                                               : cap;
  const long long span = per * csize;
  const long long tiles = nc > 0 ? (nc + span - 1) / span : 0;
  const long long wend = (end + 31) >> 5;  // words holding segment bits
  if (tid == 0) cursor = Acc{0, 0, 0, 0};  // offset 0, nothing yet
  // a CTA writes into the others' shared memory only once all of them run:
  // the cluster barrier's arrival now, its wait before the first write
  const bool clustered = csize > 1 && tiles > 0;
  if (clustered)
    asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  STAMP(1);
  for (long long tile = 0; tile < tiles; ++tile) {
    const long long t0 = tile * span, c0 = t0 + rank * per;
    const int L = static_cast<int>(
        c0 < nc ? (nc - c0 < per ? nc - c0 : per) : 0);
    const int NG = (L + GROUP - 1) / GROUP;
    const int my_maps = cta_maps + (tile & 1) * MAX_CLUSTER * S;
    __syncthreads();              // the last tile's words and entries are read
    // 1. this CTA's chunks' words and the two after
    const long long wbase = (start >> 5) + CHUNK_WORDS * c0;
    for (int i = tid; i < (L > 0 ? CHUNK_WORDS * L + 2 : 0); i += T) {
      const long long wi = wbase + i;
      words[i] = wi < wend ? __ldg(w + wi) : 0u;
    }
    __syncthreads();
    STAMP_TILE(2);
    // 2. every (chunk, entry state) decoded to its map record and its
    //    codewords
    for (int i = tid; i < L * S; i += T) {
      const int c = i / S, e = i - c * S;
      const long long left = end - (start + (c0 + c) * CHUNK_BITS);
      m[chunk_maps + i] = transition(
          words + CHUNK_WORDS * c,
          static_cast<int>(left < CHUNK_BITS ? left : CHUNK_BITS),
          static_cast<int>(left < 2 * CHUNK_BITS ? left : 2 * CHUNK_BITS), e,
          b, cums + static_cast<long long>(i) * K, signs + i);
    }
    __syncthreads();
    STAMP_TILE(3);
    // 3. each group's map from every state, and the prefix before each of
    //    its chunks
    for (int i = tid; i < NG * S; i += T) {
      const int g = i / S, e = i - g * S;
      const int first = g * GROUP, last = min(first + GROUP, L);
      Rec a = m[chunk_maps + first * S + e];
      for (int k = first + 1; k < last; ++k) {
        m[chunk_pre + k * S + e] = a;
        a = then(a, m + chunk_maps + k * S, b);
      }
      m[group_maps + i] = a;
    }
    __syncthreads();
    // 4. one warp, lane e the record from state e: the group maps composed
    //    by shuffles, each group's prefix kept in place of its map, the
    //    CTA's map handed to every CTA of the cluster (by a CTA with chunks:
    //    step 5 passes over the others)
    if (tid < 32) {
      const bool on = tid < S && L > 0;
      Rec acc = on ? m[group_maps + tid] : Rec{0, 0, 0};
      for (int g = 1; g < NG; ++g) {
        const Rec nx = on ? m[group_maps + g * S + tid] : Rec{0, 0, 0};
        if (on) m[group_maps + g * S + tid] = acc;
        const int src = entered(acc.code);
        const Rec z{__shfl_sync(FULL, nx.gaps, src),
                    __shfl_sync(FULL, nx.n, src),
                    __shfl_sync(FULL, nx.code, src)};
        acc = join(acc, z, b);
      }
      STAMP_TILE(4);
      if (clustered && tile == 0)
        asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
      if (on) {
        for (int k = 0; k < csize; ++k) {
          Rec* dst = m + my_maps + rank * S + tid;
          *(csize > 1 ? cl.map_shared_rank(dst, k) : dst) = acc;
        }
      }
    } else if (clustered && tile == 0) {
      asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
    }
    STAMP_TILE(5);
    cluster_barrier(cl, csize);
    STAMP_TILE(6);
    // 5. the cursor through the CTA maps: this CTA's entry, the tile's exit;
    //    then each chunk's true entry, the CTA's through the prefix before
    //    its group and the prefix before it inside the group
    if (tid == 0) {
      Acc cur = cursor;
      for (int k = 0; k < csize; ++k) {
        if (k == rank) entry = cur;
        if (t0 + k * per < nc) cur = then(cur, m + my_maps + k * S, b);
      }
      cursor = cur;
    }
    __syncthreads();
    for (int c = tid; c < L; c += T) {
      const int g = c / GROUP;
      Acc en = g > 0 ? then(entry, m + group_maps + g * S, b) : entry;
      if (c > g * GROUP) en = then(en, m + chunk_pre + c * S, b);
      ents[c] = en;
    }
    __syncthreads();
    STAMP_TILE(7);
    // 6. one warp a chunk: the codewords of its true entry's decode, a lane
    //    a codeword
    for (int c = tid >> 5; c < L; c += T >> 5) {
      const Acc en = ents[c];
      if (en.code & (FINAL | OVERRUN)) continue;  // the chain ended before
      const int exit = static_cast<int>(en.code & EXIT_U);
      const int i = c * S + (exit == EXIT_U ? 0 : exit);
      const long long base =
          en.gaps + (exit == EXIT_U ? en.run << b : 0) - 1;
      const long long* cum = cums + static_cast<long long>(i) * K;
      const unsigned long long sg = signs[i];
      for (int j = tid & 31; j < m[chunk_maps + i].n; j += 32) {
        const long long k = en.n + j;
        if (k < nnz) {
          out_pos[out0 + k] = base + cum[j];
          out_sign[out0 + k] = (sg >> j) & 1u ? 1.0f : -1.0f;
        }
      }
    }
    STAMP_WRITTEN();
  }
  if (rank == 0 && tid == 0) {
    status[3 * seg] = cursor.n;
    status[3 * seg + 1] = cursor.code;
    status[3 * seg + 2] = cursor.gaps - 1;          // the last position
  }
  STAMP(9);
}

// The kernel's shared-memory and cluster-size limits, once per device.
cudaError_t configure_kernel() {
  static bool configured[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (configured[dev]) return cudaSuccess;
  long long most = 0;
  for (int b = 0; b <= MAX_STATES - 2; ++b)
    most = smem_bytes(TILE, b) > most ? smem_bytes(TILE, b) : most;
  err = cudaFuncSetAttribute(decode_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(most));
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(
        decode_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  if (err == cudaSuccess) configured[dev] = true;
  return err;
}

}  // namespace

#ifdef GOLOMB_DECODE_STAMPS
// The 10 stamps of the last stamped launch (globaltimer, ns), then the SM
// clock (cycles) at the first and the last.
extern "C" int golomb_decode_stamps(unsigned long long* out) {
  return static_cast<int>(
      cudaMemcpyFromSymbol(out, g_stamps, sizeof(g_stamps)));
}
#endif

// One launch on `stream`: a cluster of `cluster` CTAs (a power of two up to
// 16) of `threads` threads (a multiple of 32 up to 512) a segment, also for
// empty ones, so every status is written, each CTA holding at most `tile`
// chunks (up to TILE) at once.  `meta` is the segment table (see
// META_COLS), `status` 3 int64 a segment; the outputs hold the advertised
// nnz total.
extern "C" int golomb_decode(const void* words, const void* meta,
                             int n_segments, int b, int cluster, int threads,
                             int tile, void* out_pos, void* out_sign,
                             void* status, void* stream) {
  if (n_segments <= 0) return 0;
  if (b < 0 || b > MAX_STATES - 2 || cluster < 1 || cluster > MAX_CLUSTER ||
      (cluster & (cluster - 1)) || threads < 32 || threads > MAX_THREADS ||
      threads % 32 || tile < 1 || tile > TILE ||
      static_cast<long long>(n_segments) * cluster > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = configure_kernel();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(n_segments * cluster), 1, 1);
  cfg.blockDim = dim3(static_cast<unsigned>(threads), 1, 1);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem_bytes(tile, b));
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = static_cast<unsigned>(cluster);
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, decode_kernel, static_cast<const uint32_t*>(words),
      static_cast<const long long*>(meta), b, cluster, tile,
      static_cast<long long*>(out_pos), static_cast<float*>(out_sign),
      static_cast<long long*>(status));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

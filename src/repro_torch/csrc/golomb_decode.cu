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
//     seg = i,  position = sum_{k' <= k} (q 2^b + r + 1) - 1,  sign = +-1.0
//
// and a per-segment status (codewords decoded; the last state, whose FINAL
// bit says the chain ended exactly on the segment end and whose OVERRUN bit
// says a codeword ran past it; the last position), from which the wrapper
// raises on truncated codewords, dangling unary runs, a count other than the
// advertised nnz, and a position past numel.
//
// Bound: memory.  4 bytes read a word, 20 written a codeword (seg 8,
// position 8, sign 4); a cnn round (W = 15,564, 61,480 codewords) is 1.29 MB,
// 0.39 us at 3.35 TB/s.  The decode is a chain of dependent steps, so what
// limits it is latency, and the design is a speculative chunk decode:
//
// 1. transitions: every segment is cut into word-aligned chunks of 128 bits;
//    a chunk owns the codewords whose terminator lies in it.  The state
//    entering a chunk is the offset e in [0, b+1] at which its first
//    codeword starts, or "inside an open unary run" (which decodes like e = 0
//    with the run's ones added to the first quotient).  One thread per
//    (chunk, e) decodes to the chunk end and records its exit state, the
//    count and gap sum of the codewords it owns, the ones of an open run at
//    the end, and whether it met the segment's final terminator or overran.
//    The chunk's words and the next two sit in registers (a forward-only
//    queue), and one 64-bit window usually holds a whole codeword, so a
//    codeword costs a few ALU steps and no memory load.
// 2. compose: the records are maps from entry state to exit state with sums,
//    and maps compose associatively.  One CTA per segment takes them in
//    tiles held in shared memory (96 KB: a cnn round's segment of ~390
//    chunks in one tile): each (group of 8 chunks, state) thread composes
//    its group's map, the group maps are scanned (Hillis-Steele), which
//    gives each group its true entry from the segment's cursor (state 0 at
//    its first bit), and each group's thread walks its chunks from there,
//    writing every chunk's entry (state, carried run, codewords and gap sum
//    before it); the last cursor is the segment's status.
// 3. write: one thread per chunk decodes again from its true entry and
//    writes its codewords.  Outputs are sized by the advertised nnz, so no
//    host round trip sits between the passes; a segment that decodes more
//    codewords than it advertised writes no more than its share (the wrapper
//    then raises on its count).
//
// A chunk's chain from its true entry is the chain the serial decoder
// follows, so the fields are bitwise the host scan's on every valid batch.
//
// Sizes: 128-bit chunks, 8-chunk groups and 64-thread write CTAs were the
// fastest of the settings tried on an H100 (passes 1 and 3 shorten with the
// chunk, compose lengthens with the chunk count).  What is left is latency:
// ~16 dependent codeword steps a thread in passes 1 and 3, ~25 dependent
// steps in one CTA a segment in pass 2.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CHUNK_BITS = 128;    // 4 words a chunk
constexpr int QWORDS = CHUNK_BITS / 32 + 2;  // + the word after, + slack
constexpr int THREADS = 128;       // transitions pass
constexpr int WRITE_THREADS = 64;  // write pass: spread over more SMs
constexpr int COMPOSE_THREADS = 512;
constexpr int GROUP = 8;           // compose: chunks a thread walks
constexpr int COMPOSE_SMEM = 96 * 1024;  // opted into at each launch
constexpr int EXIT_U = 63;         // exit state: inside an open unary run
constexpr int FINAL = 64;          // the chain met its segment's final codeword
constexpr int OVERRUN = 128;       // a codeword ran past its segment's end

// The segment table, int64 rows of META_COLS: first bit, bit length, first
// chunk, first output; row n_segments holds the totals in its last two.
// Passes 1 and 3 stage it in shared memory up to SMEM_SEGMENTS segments.
constexpr int META_COLS = 4;
constexpr int SMEM_SEGMENTS = 255;

// A chunk, or a span of chunks inside one compose tile, entered from one
// state.  `code` is the exit state (an offset into the next chunk, or
// EXIT_U) | FINAL | OVERRUN, and for EXIT_U the open run's ones << 8.
struct Rec {
  long long gaps;  // gap sum of the owned codewords (first quotient local)
  int n;           // owned codewords
  int code;
};

// A segment's cursor: its state, the ones of its open run, and the
// codewords and gap sum so far.
struct Acc {
  long long gaps;
  long long run;
  long long n;
  long long code;  // exit state | FINAL | OVERRUN
};

__device__ __forceinline__ long long lmin(long long a, long long b) {
  return a < b ? a : b;
}

// The segment that owns chunk c: the last row whose first chunk is <= c
// (empty segments share their first chunk with the next one).
__device__ __forceinline__ int find_segment(const long long* meta,
                                            int n_segments, long long c) {
  int lo = 0, hi = n_segments - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (meta[META_COLS * mid + 2] <= c) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// A chunk's stream bits in registers: the chunk's words and the next one
// (a codeword's remainder and sign may run past the chunk end) as a queue
// that only moves forward, so every index is a constant and nothing
// spills.  Stream bit t is bit 31 - (t & 31) of word t >> 5; chunk bit r is
// stream bit chunk_start + r.  Words past the segment's data read as 0
// (their bits are never parsed).
struct Reader {
  uint32_t q[QWORDS];
  int base;        // chunk word held in q[0]

  __device__ __forceinline__ void load(const uint32_t* w, long long cs,
                                       long long end) {
#pragma unroll
    for (int k = 0; k < QWORDS; ++k) {
      const long long wi = (cs >> 5) + k;
      q[k] = 32 * wi < end ? __ldg(w + wi) : 0u;
    }
    base = 0;
  }

  // 64 bits from chunk bit r (r never moves back), MSB first; at least
  // 33 of them are stream bits.
  __device__ __forceinline__ uint64_t window(int r) {
    while (base < (r >> 5)) {
#pragma unroll
      for (int k = 0; k + 1 < QWORDS; ++k) q[k] = q[k + 1];
      q[QWORDS - 1] = 0u;
      ++base;
    }
    return ((static_cast<uint64_t>(q[0]) << 32) | q[1]) << (r & 31);
  }

  // First 0 bit at a chunk bit in [r, lim), or lim.
  __device__ __forceinline__ int first_zero(int r, int lim) {
    while (r < lim) {
      const uint32_t x = ~static_cast<uint32_t>(window(r) >> 32);
      if (x) {
        const int t = r + __clz(x);
        return t < lim ? t : lim;
      }
      r += 32;
    }
    return lim;
  }

  // Chunk bits t+1 .. t+b+1 (the remainder MSB first, then the sign) as
  // the low b + 1 bits.
  __device__ __forceinline__ uint32_t tail_bits(int t, int b) {
    return static_cast<uint32_t>(window(t + 1) >> (63 - b)) &
           ((2u << b) - 1u);
  }

  // The codeword starting at chunk bit r: its terminator t (lim if none
  // before lim) and its tail bits (valid when t < lim).  One window serves
  // a codeword whose terminator and tail lie in its first 33 bits.
  __device__ __forceinline__ int codeword(int r, int lim, int b,
                                          uint32_t* tail) {
    const uint64_t win = window(r);
    const uint32_t x = ~static_cast<uint32_t>(win >> 32);
    const int z = __clz(x);                     // 32 when x == 0
    if (z + b + 2 <= 33) {
      *tail = static_cast<uint32_t>((win << (z + 1)) >> (63 - b)) &
              ((2u << b) - 1u);
      return r + z < lim ? r + z : lim;
    }
    const int t = first_zero(r, lim);
    if (t < lim) *tail = tail_bits(t, b);
    return t;
  }
};

// Chunk c of segment s: its first stream bit, its length in bits, and the
// segment end relative to its first bit (clamped: only "equal" and "past"
// matter, and no codeword of the chunk ends beyond CHUNK_BITS + 33).
__device__ __forceinline__ void chunk_bounds(const long long* meta, int s,
                                             long long c, long long* cs,
                                             int* len, int* end_rel) {
  const long long* row = meta + META_COLS * s;
  const long long end = row[0] + row[1];
  *cs = row[0] + (c - row[2]) * CHUNK_BITS;
  *len = static_cast<int>(lmin(CHUNK_BITS, end - *cs));
  *end_rel = static_cast<int>(lmin(2 * CHUNK_BITS, end - *cs));
}

// The segment table in shared memory when it is small (every thread of the
// CTA must call this), else in device memory.
__device__ __forceinline__ const long long* stage_meta(
    const long long* meta, int n_segments, long long* smem) {
  if (n_segments > SMEM_SEGMENTS) return meta;
  for (int i = threadIdx.x; i < (n_segments + 1) * META_COLS; i += blockDim.x)
    smem[i] = meta[i];
  __syncthreads();
  return smem;
}

__global__ void transitions_kernel(const uint32_t* __restrict__ w,
                                   const long long* __restrict__ meta_g,
                                   int n_segments, int b, int n_threads,
                                   Rec* __restrict__ rec) {
  __shared__ long long meta_s[(SMEM_SEGMENTS + 1) * META_COLS];
  const long long* meta = stage_meta(meta_g, n_segments, meta_s);
  const int g = blockIdx.x * THREADS + threadIdx.x;
  if (g >= n_threads) return;
  const int c = g / (b + 2), e = g - c * (b + 2);
  const int s = find_segment(meta, n_segments, c);
  long long cs;
  int len, end;
  chunk_bounds(meta, s, c, &cs, &len, &end);
  Reader rd;
  rd.load(w, cs, cs + end);
  long long gaps = 0;
  int r = e, n = 0, code;
  for (;;) {
    if (r >= len) {                        // next codeword starts past len
      code = r - len;
      break;
    }
    uint32_t f = 0;
    const int t = rd.codeword(r, len, b, &f);
    if (t == len) {                        // open run to the chunk end
      code = EXIT_U | (len - r) << 8;
      break;
    }
    const int next = t + b + 2;
    if (next > end) {
      code = OVERRUN;
      break;
    }
    gaps += (static_cast<long long>(t - r) << b) + (f >> 1) + 1;
    ++n;
    if (next == end) {
      code = FINAL;
      break;
    }
    r = next;
  }
  rec[g] = Rec{gaps, n, code};
}

__device__ __forceinline__ int open_run(int code) {
  return (code & EXIT_U) == EXIT_U ? code >> 8 : 0;
}

// Span `a`, then the chunk or span whose records (one per entry state) are
// next[0 .. b+1].  Inside an open run the next one decodes as from offset
// 0, its first quotient grown by the run's ones.
__device__ __forceinline__ Rec then(const Rec& a, const Rec* next, int b) {
  if (a.code & (FINAL | OVERRUN)) return a;
  const int exit = a.code & EXIT_U;
  if (exit != EXIT_U) {
    const Rec z = next[exit];
    return Rec{a.gaps + z.gaps, a.n + z.n, z.code};
  }
  const Rec z = next[0];
  const int run = a.code >> 8;
  return Rec{a.gaps + z.gaps + (z.n > 0 ? static_cast<long long>(run) << b : 0),
             a.n + z.n,
             z.n > 0 || (z.code & EXIT_U) != EXIT_U ? z.code
                                                    : z.code + (run << 8)};
}

// The same for a segment's cursor.
__device__ __forceinline__ Acc then(const Acc& a, const Rec* next, int b) {
  if (a.code & (FINAL | OVERRUN)) return a;
  const int exit = static_cast<int>(a.code & EXIT_U);
  const Rec z = next[exit != EXIT_U ? exit : 0];
  if (exit != EXIT_U)
    return Acc{a.gaps + z.gaps, open_run(z.code), a.n + z.n, z.code & 0xFF};
  return Acc{a.gaps + z.gaps + (z.n > 0 ? a.run << b : 0),
             open_run(z.code) + (z.n > 0 ? 0 : a.run), a.n + z.n,
             z.code & 0xFF};
}

// Chunks a compose tile holds: its records and the group maps twice (a
// scan reads one copy and writes the other), 16 B a state each, and the
// group entries (32 B), in COMPOSE_SMEM, a whole number of groups.
__host__ __device__ constexpr int tile_chunks(int states) {
  return (COMPOSE_SMEM / (GROUP * 16 * states + 32 * states + 32)) * GROUP;
}
// an open run inside a tile fits the 23 bits `code` keeps for it
static_assert(tile_chunks(2) * CHUNK_BITS < (1 << 23), "tile too long");

// One CTA a segment, tile by tile: (1) each (group, state) thread composes
// the group's GROUP chunk records from that state; (2) the group maps are
// scanned (Hillis-Steele, one thread a (group, state)), which gives every
// group its true entry from the segment's cursor; (3) each group's thread
// walks its chunks from that entry, writing every chunk's entry.
__global__ void compose_kernel(const long long* __restrict__ meta, int b,
                               const Rec* __restrict__ rec,
                               Acc* __restrict__ entry,
                               long long* __restrict__ status) {
  extern __shared__ unsigned char smem_raw[];
  const int states = b + 2, tile = tile_chunks(states);
  const int max_maps = (tile / GROUP) * states;
  Rec* recs = reinterpret_cast<Rec*>(smem_raw);               // [tile][states]
  Rec* maps = recs + tile * states;                           // 2 x [groups][states]
  Acc* gentry = reinterpret_cast<Acc*>(maps + 2 * max_maps);  // [groups]
  __shared__ Acc cursor;
  const int seg = blockIdx.x, tid = threadIdx.x;
  const long long c0 = meta[META_COLS * seg + 2];
  const long long n_chunks = meta[META_COLS * (seg + 1) + 2] - c0;
  if (tid == 0) cursor = Acc{0, 0, 0, 0};         // offset 0, nothing yet
  for (long long base = 0; base < n_chunks; base += tile) {
    const int len = static_cast<int>(lmin(tile, n_chunks - base));
    const int groups = (len + GROUP - 1) / GROUP, n_maps = groups * states;
    const Rec* src = rec + (c0 + base) * states;
    for (int i = tid; i < len * states; i += COMPOSE_THREADS) recs[i] = src[i];
    __syncthreads();
    Rec* cur = maps;
    for (int i = tid; i < n_maps; i += COMPOSE_THREADS) {
      const int g = i / states, first = g * GROUP;
      const int last = min(first + GROUP, len);
      Rec a = recs[first * states + i - g * states];
      for (int k = first + 1; k < last; ++k) a = then(a, recs + k * states, b);
      cur[i] = a;
    }
    __syncthreads();
    // inclusive scan: cur[g] becomes groups 0 .. g composed
    for (int d = 1; d < groups; d <<= 1) {
      Rec* nxt = cur == maps ? maps + max_maps : maps;
      for (int i = tid; i < n_maps; i += COMPOSE_THREADS) {
        const int g = i / states;
        nxt[i] = g >= d ? then(cur[i - d * states], cur + g * states, b)
                        : cur[i];
      }
      __syncthreads();
      cur = nxt;
    }
    for (int g = tid; g < groups; g += COMPOSE_THREADS)
      gentry[g] = g == 0 ? cursor : then(cursor, cur + (g - 1) * states, b);
    __syncthreads();
    if (tid == 0) cursor = then(cursor, cur + (groups - 1) * states, b);
    for (int g = tid; g < groups; g += COMPOSE_THREADS) {
      Acc a = gentry[g];
      const int last = min((g + 1) * GROUP, len);
      for (int k = g * GROUP; k < last; ++k) {
        entry[c0 + base + k] = a;
        a = then(a, recs + k * states, b);
      }
    }
    __syncthreads();
  }
  if (tid == 0) {
    status[3 * seg] = cursor.n;
    status[3 * seg + 1] = cursor.code;
    status[3 * seg + 2] = cursor.gaps - 1;          // the last position
  }
}

__global__ void write_kernel(const uint32_t* __restrict__ w,
                             const long long* __restrict__ meta_g,
                             int n_segments, int b, int n_chunks,
                             const Acc* __restrict__ entry,
                             long long* __restrict__ out_seg,
                             long long* __restrict__ out_pos,
                             float* __restrict__ out_sign) {
  __shared__ long long meta_s[(SMEM_SEGMENTS + 1) * META_COLS];
  const long long* meta = stage_meta(meta_g, n_segments, meta_s);
  const int c = blockIdx.x * WRITE_THREADS + threadIdx.x;
  if (c >= n_chunks) return;
  const Acc en = entry[c];
  if (en.code & (FINAL | OVERRUN)) return;        // the chain ended before
  const int s = find_segment(meta, n_segments, c);
  long long cs;
  int len, end;
  chunk_bounds(meta, s, c, &cs, &len, &end);
  const long long out0 = meta[META_COLS * s + 3];
  const long long nnz = meta[META_COLS * (s + 1) + 3] - out0;
  Reader rd;
  rd.load(w, cs, cs + end);
  const int exit = static_cast<int>(en.code & EXIT_U);
  int r = exit == EXIT_U ? 0 : exit;
  long long carry = exit == EXIT_U ? en.run : 0;
  long long k = en.n, acc = en.gaps;
  while (r < len) {
    uint32_t f = 0;
    const int t = rd.codeword(r, len, b, &f);
    if (t == len) break;
    const int next = t + b + 2;
    if (next > end) break;
    acc += ((t - r + carry) << b) + (f >> 1) + 1;
    carry = 0;
    if (k < nnz) {
      out_seg[out0 + k] = s;
      out_pos[out0 + k] = acc - 1;
      out_sign[out0 + k] = (f & 1u) ? 1.0f : -1.0f;
    }
    ++k;
    if (next == end) break;
    r = next;
  }
}

}  // namespace

// The chunk length the segment table's chunk column is counted in.
extern "C" int golomb_decode_chunk_bits() { return CHUNK_BITS; }

// Scratch bytes for n_chunks chunks at parameter b: the chunk records, then
// the chunk entries.
extern "C" long long golomb_decode_scratch_bytes(long long n_chunks, int b) {
  return n_chunks * ((b + 2) * sizeof(Rec) + sizeof(Acc));
}

// Three launches on `stream`: transitions, compose (one CTA a segment, also
// for empty ones, so every status is written), write.  `scratch` holds
// golomb_decode_scratch_bytes(n_chunks, b) bytes, `status` 3 int64 a
// segment; the outputs hold the advertised nnz total.
extern "C" int golomb_decode(const void* words, const void* meta,
                             int n_segments, int b, long long n_chunks,
                             void* scratch, void* out_seg, void* out_pos,
                             void* out_sign, void* status, void* stream) {
  if (n_segments <= 0) return 0;
  if (b < 0 || b > 30 || n_chunks * (b + 2) > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int states = b + 2;
  const uint32_t* w = static_cast<const uint32_t*>(words);
  const long long* m = static_cast<const long long*>(meta);
  Rec* rec = static_cast<Rec*>(scratch);
  Acc* entry = reinterpret_cast<Acc*>(rec + n_chunks * states);
  if (n_chunks > 0) {
    const int n1 = static_cast<int>(n_chunks * states);
    transitions_kernel<<<(n1 + THREADS - 1) / THREADS, THREADS, 0, st>>>(
        w, m, n_segments, b, n1, rec);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const cudaError_t attr = cudaFuncSetAttribute(
      compose_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      COMPOSE_SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  compose_kernel<<<n_segments, COMPOSE_THREADS, COMPOSE_SMEM, st>>>(
      m, b, rec, entry, static_cast<long long*>(status));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_chunks == 0) return static_cast<int>(err);
  write_kernel<<<static_cast<unsigned>((n_chunks + WRITE_THREADS - 1) /
                                       WRITE_THREADS),
                 WRITE_THREADS, 0, st>>>(
      w, m, n_segments, b, static_cast<int>(n_chunks), entry,
      static_cast<long long*>(out_seg), static_cast<long long*>(out_pos),
      static_cast<float*>(out_sign));
  return static_cast<int>(cudaGetLastError());
}

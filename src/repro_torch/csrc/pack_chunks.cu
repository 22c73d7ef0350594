// Golomb chunk packing for the ternary wire format: (value, length) chunks
// at given bit offsets -> the canonical MSB-first uint32 word stream.
//
// Replaces, on the ternary wire path, the Pallas kernel `_pack_kernel` of
// src/repro/kernels/bitpack.py (entry `pack_bits_words`) together with the
// host chunk -> bit expansion in front of it: the reference's "kernel" wire
// backend computes
//
//     pack_bits_words(_chunks_to_bits(vals, lens, offs, total_bits))
//
// (src/repro/core/wire.py, `_make_kernel_backend`), i.e. chunk i's `lens[i]`
// low bits of `vals[i]`, most significant first, at stream bits
// [offs[i], offs[i] + lens[i]), everything else 0, and stream bit t in word
// t >> 5 at bit 31 - (t & 31).  The result is byte-identical to
// core/wire.py::_scatter_chunks_numpy.
//
// Bound: memory.  20 bytes read a chunk (int64 value, int32 length, int64
// offset) and 4 bytes written a word; a round's upstream batch of ~61,500
// chunks is ~1.3 MB, under half a microsecond of traffic, so the launch and
// its latency are the cost.  The TPU kernel took a dense bit plane (one
// byte a stream bit, built on the host and copied up) because a
// shift-and-sum over it suits the vector unit.  Here, in one launch, with no
// memset and no global atomic, every output word is written once by the
// CTA that owns it, and a CTA issues all its loads at once (one round trip):
//
// * CTA j takes chunks [j CHUNKS, (j+1) CHUNKS) and owns the words from the
//   one holding its first chunk's first bit to the one holding the next
//   CTA's (CTA 0 from word 0, the last CTA to the end), so the CTAs' words
//   partition the output, gaps and tail included;
// * the bits of its owned words come from its own chunks and from the
//   chunks before them that reach into its first word: with lengths of at
//   least one bit, at most 31 of them (BEFORE are loaded);
// * each thread loads one chunk into registers, ORs its pieces that fall in
//   the owned words into shared-memory words (zeroed first; shared
//   atomics, which commute), and the CTA writes its words with 16-byte
//   stores (scalar ones at ragged ends), TILE_WORDS words a pass (one pass
//   unless a gap makes the owned run longer).
//
// A chunk that straddles two CTAs' words is ORed by both, each taking the
// pieces in its own words.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;       // a chunk each
constexpr int BEFORE = 32;         // chunks before its own that reach its
                                   // first word (at most 31 bits of it)
constexpr int CHUNKS = THREADS - BEFORE;   // a CTA's own chunks
constexpr int TILE_WORDS = 1024;   // owned words a pass

// ORs the pieces of one chunk that lie in words [w0, w1) into the tile
// (tile[0] is word w0).
__device__ __forceinline__ void or_chunk(unsigned* tile, int64_t w0,
                                         int64_t w1, uint64_t v, int len,
                                         int64_t off) {
  if (len <= 0 || len > 64) return;
  if (len < 64) v &= (1ull << len) - 1ull;
  if (v == 0) return;
  const int64_t end = off + len;  // one past the chunk's last bit
  const int64_t first = off >> 5, last = (end - 1) >> 5;
  for (int64_t w = first; w <= last; ++w) {  // at most 3
    if (w < w0 || w >= w1) continue;
    // where v's least significant bit sits, counted up from word w's LSB
    const int64_t sh = 32 * (w + 1) - end;
    const unsigned piece = sh >= 0 ? static_cast<unsigned>(v << sh)
                                   : static_cast<unsigned>(v >> (-sh));
    if (piece != 0u) atomicOr(tile + (w - w0), piece);
  }
}

__global__ void __launch_bounds__(THREADS)
    pack_chunks_kernel(const uint64_t* __restrict__ vals,
                       const int* __restrict__ lens,
                       const int64_t* __restrict__ offs,
                       unsigned* __restrict__ words, int64_t n_chunks,
                       int64_t n_words) {
  __shared__ __align__(16) unsigned tile[TILE_WORDS];
  const int64_t i0 = static_cast<int64_t>(blockIdx.x) * CHUNKS;
  const int64_t i1 = i0 + CHUNKS < n_chunks ? i0 + CHUNKS : n_chunks;
  // the owned words [lo, hi), and this thread's chunk, loaded at once
  int64_t lo = blockIdx.x == 0 ? 0 : offs[i0] >> 5;
  int64_t hi = blockIdx.x + 1 == gridDim.x ? n_words : offs[i1] >> 5;
  const int64_t i = i0 - BEFORE + threadIdx.x;
  const bool in = i >= 0 && i < i1;
  const uint64_t v = in ? vals[i] : 0ull;
  const int len = in ? lens[i] : 0;
  const int64_t off = in ? offs[i] : 0;
  lo = lo < n_words ? lo : n_words;
  hi = hi < n_words ? hi : n_words;
  const bool aligned = (reinterpret_cast<uintptr_t>(words) & 15u) == 0;
  for (int64_t base = lo; base < hi; base += TILE_WORDS) {
    const int64_t top = base + TILE_WORDS < hi ? base + TILE_WORDS : hi;
    if (base > lo) __syncthreads();            // the last pass is written
    for (int i = threadIdx.x; i < TILE_WORDS; i += THREADS) tile[i] = 0u;
    __syncthreads();
    or_chunk(tile, base, top, v, len, off);
    __syncthreads();
    // [base, a0) and [a1, top) one word a thread, [a0, a1) 16 B a thread
    const int64_t a0 = aligned ? ((base + 3) & ~int64_t{3}) : top;
    const int64_t a0c = a0 < top ? a0 : top;
    const int64_t a1 = aligned && (top & ~int64_t{3}) > a0c
                           ? (top & ~int64_t{3}) : a0c;
    for (int64_t w = base + threadIdx.x; w < a0c; w += THREADS)
      words[w] = tile[w - base];
    for (int64_t q = a0c + 4 * threadIdx.x; q < a1; q += 4 * THREADS)
      *reinterpret_cast<uint4*>(words + q) =
          uint4{tile[q - base], tile[q - base + 1], tile[q - base + 2],
                tile[q - base + 3]};
    for (int64_t w = a1 + threadIdx.x; w < top; w += THREADS)
      words[w] = tile[w - base];
  }
}

}  // namespace

// Writes ``n_words`` words from ``n_chunks`` chunks (``offs``
// non-decreasing, lengths 1-64) in one launch on ``stream``; returns the
// first CUDA error.
extern "C" int pack_chunks_u64(const void* vals, const void* lens,
                               const void* offs, void* words,
                               long long n_chunks, long long n_words,
                               void* stream) {
  if (n_words <= 0) return 0;
  const long long blocks =
      n_chunks > 0 ? (n_chunks + CHUNKS - 1) / CHUNKS : 1;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  pack_chunks_kernel<<<static_cast<unsigned>(blocks), THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(vals), static_cast<const int*>(lens),
      static_cast<const int64_t*>(offs), static_cast<unsigned*>(words),
      static_cast<int64_t>(n_chunks), static_cast<int64_t>(n_words));
  return static_cast<int>(cudaGetLastError());
}

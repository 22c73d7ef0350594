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
// chunks is ~1.3 MB, under half a microsecond of traffic, so the launch is
// the cost.  The TPU kernel took a dense bit plane (one byte a stream bit,
// built on the host and copied up) because a shift-and-sum over it suits
// the vector unit.  Here one thread takes one chunk: a chunk of at most 64
// bits at any offset touches at most 3 words, and the thread atomicOr's its
// non-zero pieces into them.  OR commutes, so the words do not depend on
// the order of the atomics.  The C entry clears the words with
// cudaMemsetAsync on the same stream just before the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__global__ void pack_chunks_kernel(const uint64_t* __restrict__ vals,
                                   const int* __restrict__ lens,
                                   const int64_t* __restrict__ offs,
                                   unsigned* __restrict__ words,
                                   int64_t n_chunks, int64_t n_words) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (i >= n_chunks) return;
  const int len = lens[i];
  if (len <= 0 || len > 64) return;
  uint64_t v = vals[i];
  if (len < 64) v &= (1ull << len) - 1ull;
  if (v == 0) return;
  const int64_t off = offs[i];
  const int64_t end = off + len;  // one past the chunk's last bit
  for (int64_t w = off >> 5; w <= (end - 1) >> 5; ++w) {  // at most 3
    // where v's least significant bit sits, counted up from word w's LSB
    const int64_t sh = 32 * (w + 1) - end;
    const unsigned piece = sh >= 0 ? static_cast<unsigned>(v << sh)
                                   : static_cast<unsigned>(v >> (-sh));
    if (piece != 0u && w >= 0 && w < n_words) atomicOr(words + w, piece);
  }
}

}  // namespace

// Clears ``n_words`` words and ORs ``n_chunks`` chunks into them, on
// ``stream``; returns the first CUDA error.
extern "C" int pack_chunks_u64(const void* vals, const void* lens,
                               const void* offs, void* words,
                               long long n_chunks, long long n_words,
                               void* stream) {
  if (n_words <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(words, 0, static_cast<size_t>(n_words) * 4,
                                    st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = n_chunks > 0 ? (n_chunks + THREADS - 1) / THREADS
                                        : 1;
  pack_chunks_kernel<<<static_cast<unsigned>(blocks), THREADS, 0, st>>>(
      static_cast<const uint64_t*>(vals), static_cast<const int*>(lens),
      static_cast<const int64_t*>(offs), static_cast<unsigned*>(words),
      static_cast<int64_t>(n_chunks), static_cast<int64_t>(n_words));
  return static_cast<int>(cudaGetLastError());
}

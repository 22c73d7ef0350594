// MSB-first word unpacking of a wire stream, with per-word zero counts.
//
// Replaces the Pallas kernel `_unpack_kernel` of
// src/repro/kernels/wiredecode.py (entries `unpack_words_with_counts` and
// `unpack_bits_words`):
//
//     bit[32 w + j] = (word[w] >> (31 - j)) & 1      (uint8 0/1)
//     zeros[w]      = 32 - popc(word[w])             (int32)
//
// the exact inverse of pack_bits.cu, byte-identical to
// core/wire.py::_unpack_bits_numpy (np.unpackbits of the big-endian words).
// The words arrive as the int32 tensor that holds their uint32 pattern and
// are reinterpreted as unsigned before any shift.
//
// Bound: memory.  Four bytes read and 36 written per word (32 bit bytes plus
// the count); at a round's W ~ 15,600 words that is 0.6 MB, about 0.2 us at
// 3.35 TB/s, so at the decode path's sizes the launch itself is the cost.
// Design: one thread per word.  The thread builds its 32 output bytes in
// eight 32-bit registers (byte j of the word's slice is bit 31 - j) and
// writes them as two 16-byte vector stores; a warp's stores cover one
// contiguous 1 KB span.  The wrapper allocates the output, so it is aligned.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__global__ void unpack_bits_kernel(const uint32_t* __restrict__ words,
                                   uint8_t* __restrict__ bits,
                                   int* __restrict__ zeros, int64_t n_words) {
  const int64_t w = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (w >= n_words) return;
  const uint32_t u = words[w];
  uint32_t out[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    // stream bits 4q .. 4q+3 of this word, MSB first, one per byte
    const uint32_t nib = (u >> (28 - 4 * q)) & 0xFu;
    out[q] = ((nib >> 3) & 1u) | (((nib >> 2) & 1u) << 8) |
             (((nib >> 1) & 1u) << 16) | ((nib & 1u) << 24);
  }
  uint4* dst = reinterpret_cast<uint4*>(bits + 32 * w);
  dst[0] = make_uint4(out[0], out[1], out[2], out[3]);
  dst[1] = make_uint4(out[4], out[5], out[6], out[7]);
  zeros[w] = 32 - __popc(u);
}

}  // namespace

extern "C" int unpack_bits_u32(const void* words, void* bits, void* zeros,
                               long long n_words, void* stream) {
  if (n_words <= 0) return 0;
  const unsigned blocks =
      static_cast<unsigned>((n_words + THREADS - 1) / THREADS);
  unpack_bits_kernel<<<blocks, THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<uint8_t*>(bits),
      static_cast<int*>(zeros), static_cast<int64_t>(n_words));
  return static_cast<int>(cudaGetLastError());
}

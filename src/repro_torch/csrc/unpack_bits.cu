// MSB-first word unpacking of wire streams, with per-word zero counts, and
// the sign-plane tally that the signSGD ingest fuses with the unpack.
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
// `unpack_bits_u32` takes a (B, W) batch as its B * W words: row i's bits
// are the flat output's [32 W i, 32 W (i + 1)).  Bound: memory, 4 bytes
// read and 36 written a word (0.11 us at W = 9,608 and 3.35 TB/s).
// Design: one thread per half word, which writes its 16 bit bytes as one
// 16-byte store (a warp's stores cover one contiguous 512-byte span); 128
// threads a CTA, so one plane of 9,608 words is 151 CTAs over the 132 SMs.
//
// `sign_plane_tally_f64` is what the signSGD ingest does with the bits
// (core/ingest.py::IngestAccumulator.add_sign_plane, message by message):
// for every coordinate j < n and i = 0 .. B - 1 in order,
//
//     sum[j] = sum[j] + f64(bit(i, j) ? f32(step) : -f32(step)) * w[i]
//
// a fp64 product rounded, then a fp64 add rounded (__dmul_rn, __dadd_rn:
// nvcc would otherwise contract the two into one fma, rounded once), so the
// sum is bitwise the host loop's.  The wrapper passes f64(f32(step)).
// Bound: memory, the words read once and the fp64 sum read and written once
// (1.58 us at (10, 9,608), n = 307,434).  Design: one thread per
// coordinate; a warp's 32 coordinates share one word a row, a broadcast
// load, and its sum loads and stores are coalesced 256-byte spans.  The
// bit planes never exist in memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int UNPACK_THREADS = 128;
constexpr int TALLY_THREADS = 256;

// Four stream bits, MSB first, one per byte (byte 0 = the first bit).
__device__ __forceinline__ uint32_t nibble_bytes(uint32_t nib) {
  return ((nib >> 3) & 1u) | (((nib >> 2) & 1u) << 8) |
         (((nib >> 1) & 1u) << 16) | ((nib & 1u) << 24);
}

__global__ void unpack_bits_kernel(const uint32_t* __restrict__ words,
                                   uint8_t* __restrict__ bits,
                                   int* __restrict__ zeros, int64_t n_words) {
  const int64_t h =
      static_cast<int64_t>(blockIdx.x) * UNPACK_THREADS + threadIdx.x;
  if (h >= 2 * n_words) return;
  const int64_t w = h >> 1;
  const uint32_t u = __ldg(words + w);
  const uint32_t half = (h & 1) ? (u & 0xFFFFu) : (u >> 16);
  reinterpret_cast<uint4*>(bits)[h] = make_uint4(
      nibble_bytes(half >> 12), nibble_bytes((half >> 8) & 0xFu),
      nibble_bytes((half >> 4) & 0xFu), nibble_bytes(half & 0xFu));
  if (!(h & 1)) zeros[w] = 32 - __popc(u);
}

__global__ void sign_plane_tally_kernel(const uint32_t* __restrict__ words,
                                        const double* __restrict__ weights,
                                        double* __restrict__ sum, int rows,
                                        int64_t n_words, int64_t n,
                                        double step) {
  const int64_t j =
      static_cast<int64_t>(blockIdx.x) * TALLY_THREADS + threadIdx.x;
  if (j >= n) return;
  const uint32_t* col = words + (j >> 5);
  const int shift = 31 - static_cast<int>(j & 31);
  double s = sum[j];
  for (int i = 0; i < rows; ++i) {
    const double v = ((__ldg(col + i * n_words) >> shift) & 1u) ? step
                                                                 : -step;
    s = __dadd_rn(s, __dmul_rn(v, __ldg(weights + i)));
  }
  sum[j] = s;
}

}  // namespace

extern "C" int unpack_bits_u32(const void* words, void* bits, void* zeros,
                               long long n_words, void* stream) {
  if (n_words <= 0) return 0;
  const unsigned blocks = static_cast<unsigned>(
      (2 * n_words + UNPACK_THREADS - 1) / UNPACK_THREADS);
  unpack_bits_kernel<<<blocks, UNPACK_THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<uint8_t*>(bits),
      static_cast<int*>(zeros), static_cast<int64_t>(n_words));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sign_plane_tally_f64(const void* words, const void* weights,
                                    void* sum, long long rows,
                                    long long n_words, long long n,
                                    double step, void* stream) {
  if (rows <= 0 || n <= 0) return 0;
  const unsigned blocks =
      static_cast<unsigned>((n + TALLY_THREADS - 1) / TALLY_THREADS);
  sign_plane_tally_kernel<<<blocks, TALLY_THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words),
      static_cast<const double*>(weights), static_cast<double*>(sum),
      static_cast<int>(rows), static_cast<int64_t>(n_words),
      static_cast<int64_t>(n), step);
  return static_cast<int>(cudaGetLastError());
}

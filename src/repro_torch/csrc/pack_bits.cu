// MSB-first word packing of a batch of bit planes, one launch a batch.
//
// Replaces the Pallas kernel `_pack_kernel` of src/repro/kernels/bitpack.py
// (entries `pack_bits_words` and `pack_bits_words_batched`).  Over a
// (B, m) batch whose rows are padded to whole words, row i's word w is
//
//     word[i, w] = sum_j bit(i, 32 w + j) << (31 - j)      (bits past m are 0)
//
// byte-identical to core/wire.py::_pack_bits_numpy of each row (np.packbits
// read back as big-endian uint32 words), ragged last word included, so the
// flattened (B, W) output is the concatenation of the per-row packs.
//
// Two input forms, one kernel each:
//
// * uint8 0/1 bits (`pack_bits_u8`): bit = b != 0.  A CTA owns 64
//   consecutive words of one row.  Its threads read the bytes those words
//   cover as aligned 16-byte vectors (a row of m bytes starts anywhere, so
//   the span is widened to 16-byte boundaries; an aligned vector holding one
//   byte of the span never crosses a page), turn each vector into a 16-bit
//   MSB-first mask in shared memory, and each thread then cuts its word out
//   of three masks with one 64-bit shift.  The bytes outside the row are
//   read but never land in a word: the row's last word is masked to its m
//   bits.
// * fp32 values (`pack_sign_f32`): bit = x > 0, decided exactly as numpy's
//   `x > 0` in core/wire.py::pack_sign_words.  The build flushes subnormals
//   in comparisons (-ftz=true), so the bit is read from the pattern:
//   u = bits of x, bit = (u - 1) < 0x7f800000 (positive, non-zero, not NaN:
//   a positive subnormal and +inf give 1; -0.0, NaN and negatives 0).  A
//   warp owns 32 consecutive words of one row: for word i it reads the
//   word's 32 floats (one a lane, a coalesced 128-byte load), __ballot_sync
//   puts lane j's bit at bit j and __brev makes it MSB-first; the 32 loads
//   are issued before the ballots, so 32 words are in flight a warp.  Lane
//   i keeps word i and the warp writes its 32 words in one 128-byte store.
//
// Bound: memory.  fp32 at signSGD's (10, 307,434): 12,297,360 bytes read
// and 384,320 written, 3.79 us at 3.35 TB/s.  Both grids are sized by the
// batch's words (64 threads a CTA), so a batch of ten planes is ~1,500 CTAs
// over the 132 SMs and one plane still ~150.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int U8_WORDS = 64;            // words (= threads) a CTA, uint8 form
constexpr int F32_THREADS = 64;         // fp32 form: two warps a CTA
constexpr int F32_WARPS = F32_THREADS / 32;

// Byte k of c (little-endian: byte 0 is the lowest address) nonzero -> bit
// 3 - k of the result (MSB-first over the four bytes).
__device__ __forceinline__ uint32_t nonzero_nibble(uint32_t c) {
  uint32_t t = c | (c >> 4);
  t |= t >> 2;
  t |= t >> 1;
  t &= 0x01010101u;                     // bit 0 of each byte: byte != 0
  return (t * 0x08040201u) >> 24;       // gather: byte k -> bit 3 - k
}

__global__ void pack_bits_u8_kernel(const uint8_t* __restrict__ bits,
                                    uint32_t* __restrict__ words, int64_t m,
                                    int64_t n_words, int64_t tiles_per_row) {
  // 16-bit masks of the aligned vectors covering the tile's bytes: at most
  // 32 * U8_WORDS / 16 + 1 of them, plus one read past the last by a shift
  __shared__ uint32_t mask[2 * U8_WORDS + 2];
  const int64_t row = blockIdx.x / tiles_per_row;
  const int64_t w0 = (blockIdx.x - row * tiles_per_row) * U8_WORDS;
  const uint8_t* row_bits = bits + row * m;
  const int64_t end = (w0 + U8_WORDS) * 32 < m ? (w0 + U8_WORDS) * 32 : m;
  const uintptr_t a0 = reinterpret_cast<uintptr_t>(row_bits + w0 * 32) &
                       ~static_cast<uintptr_t>(15);
  const uintptr_t a1 =
      (reinterpret_cast<uintptr_t>(row_bits + end) + 15) &
      ~static_cast<uintptr_t>(15);
  const int n_vec = static_cast<int>((a1 - a0) >> 4);
  for (int k = threadIdx.x; k < 2 * U8_WORDS + 2; k += U8_WORDS) {
    uint32_t mk = 0;
    if (k < n_vec) {
      const uint4 q = *reinterpret_cast<const uint4*>(a0 + 16 * k);
      mk = (nonzero_nibble(q.x) << 12) | (nonzero_nibble(q.y) << 8) |
           (nonzero_nibble(q.z) << 4) | nonzero_nibble(q.w);
    }
    mask[k] = mk;
  }
  __syncthreads();
  const int64_t w = w0 + threadIdx.x;
  if (w >= n_words) return;
  const uintptr_t s = reinterpret_cast<uintptr_t>(row_bits + w * 32) - a0;
  const int idx = static_cast<int>(s >> 4);
  const int off = static_cast<int>(s & 15);
  const uint64_t v = (static_cast<uint64_t>(mask[idx]) << 32) |
                     (static_cast<uint64_t>(mask[idx + 1]) << 16) |
                     mask[idx + 2];
  uint32_t word = static_cast<uint32_t>(v >> (16 - off));
  const int64_t valid = m - w * 32;     // >= 1: w < n_words
  if (valid < 32) word &= ~0u << (32 - valid);
  words[row * n_words + w] = word;
}

__global__ void pack_sign_f32_kernel(const uint32_t* __restrict__ x,
                                     uint32_t* __restrict__ words, int64_t n,
                                     int64_t n_words, int64_t groups_per_row,
                                     int64_t groups) {
  const int lane = threadIdx.x & 31;
  const int64_t g =
      static_cast<int64_t>(blockIdx.x) * F32_WARPS + threadIdx.x / 32;
  if (g >= groups) return;              // whole warp leaves together
  const int64_t row = g / groups_per_row;
  const int64_t w0 = (g - row * groups_per_row) * 32;
  const uint32_t* xr = x + row * n;
  uint32_t u[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int64_t t = (w0 + i) * 32 + lane;
    u[i] = t < n ? __ldg(xr + t) : 0u;  // 0 packs as 0
  }
  uint32_t mine = 0;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const uint32_t ballot =
        __ballot_sync(0xffffffffu, (u[i] - 1u) < 0x7f800000u);
    if (lane == i) mine = __brev(ballot);
  }
  if (w0 + lane < n_words) words[row * n_words + w0 + lane] = mine;
}

}  // namespace

extern "C" int pack_bits_u8(const void* bits, void* words, long long rows,
                            long long m, long long n_words, void* stream) {
  if (rows <= 0 || n_words <= 0) return 0;
  const int64_t tiles = (n_words + U8_WORDS - 1) / U8_WORDS;
  pack_bits_u8_kernel<<<static_cast<unsigned>(rows * tiles), U8_WORDS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(bits), static_cast<uint32_t*>(words),
      static_cast<int64_t>(m), static_cast<int64_t>(n_words), tiles);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pack_sign_f32(const void* x, void* words, long long rows,
                             long long n, long long n_words, void* stream) {
  if (rows <= 0 || n_words <= 0) return 0;
  const int64_t per_row = (n_words + 31) / 32;
  const int64_t groups = rows * per_row;
  const unsigned blocks =
      static_cast<unsigned>((groups + F32_WARPS - 1) / F32_WARPS);
  pack_sign_f32_kernel<<<blocks, F32_THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(words),
      static_cast<int64_t>(n), static_cast<int64_t>(n_words), per_row,
      groups);
  return static_cast<int>(cudaGetLastError());
}

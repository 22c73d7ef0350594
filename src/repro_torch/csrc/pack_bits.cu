// MSB-first word packing of a 0/1 bit stream.
//
// Replaces the Pallas kernel `_pack_kernel` of src/repro/kernels/bitpack.py
// (entry `pack_bits_words`):
//
//     word[w] = sum_j bits[32 w + j] << (31 - j)      (bits past m are 0)
//
// which is byte-identical to core/wire.py::_pack_bits_numpy (np.packbits
// read back as big-endian uint32 words), ragged last word included.
//
// Bound: memory.  One byte read per stream bit and four bytes written per
// word, 1.125 bytes per bit; a round's stream of ~10^5..10^6 bits is well
// under a microsecond of traffic, so at these sizes the launch itself is
// the cost.  Design: one warp per 32 consecutive words.  For word i of its
// group the warp reads the word's 32 bytes (lane j reads bits[32 w + j], one
// coalesced 32-byte segment), __ballot_sync puts lane j's bit at bit j, and
// __brev turns that into the MSB-first order.  Lane i keeps word i, so the
// group's 32 words are written by one coalesced 128-byte store.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

__global__ void pack_bits_kernel(const uint8_t* __restrict__ bits,
                                 uint32_t* __restrict__ words, int64_t m,
                                 int64_t n_words) {
  const int lane = threadIdx.x & 31;
  const int64_t group =
      static_cast<int64_t>(blockIdx.x) * WARPS + threadIdx.x / 32;
  const int64_t w0 = group * 32;
  if (w0 >= n_words) return;  // whole warp leaves together
  uint32_t mine = 0;
  for (int i = 0; i < 32; ++i) {
    const int64_t t = (w0 + i) * 32 + lane;
    const bool bit = (t < m) && (bits[t] != 0);
    const uint32_t ballot = __ballot_sync(0xffffffffu, bit);
    if (lane == i) mine = __brev(ballot);
  }
  if (w0 + lane < n_words) words[w0 + lane] = mine;
}

}  // namespace

extern "C" int pack_bits_u8(const void* bits, void* words, long long m,
                            long long n_words, void* stream) {
  if (n_words <= 0) return 0;
  const int64_t groups = (n_words + 31) / 32;
  const unsigned blocks = static_cast<unsigned>((groups + WARPS - 1) / WARPS);
  pack_bits_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(bits), static_cast<uint32_t*>(words),
      static_cast<int64_t>(m), static_cast<int64_t>(n_words));
  return static_cast<int>(cudaGetLastError());
}

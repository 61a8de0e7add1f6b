// Device functions for the minnow bit stream, shared by the kernels.
//
// Element i of a width-`bits` stream occupies bits [i*bits, (i+1)*bits),
// least significant bit first, in little-endian uint32 words
// (minnow_tpu/core/spec.py:87-127; ref go/bit/bit.go).
//
// Both directions are in gather form: a thread computes one whole output
// word (pack) or one whole element (unpack) from what it reads, so no two
// threads write the same word, nothing needs atomics, and the bytes do not
// depend on scheduling.  They replace the TPU's planar tile pack and
// unpack (minnow_tpu/ops/pallas_encode.py:218 _pack_tile_planar,
// minnow_tpu/ops/pallas_codec.py:355 _unpack_group_tiles), which exist to
// fit the (8, 128) vreg tiling.

#pragma once

#include <cstdint>

namespace minnow {

// Mask of the low `bits` bits, for bits in [0, 64].
__device__ __forceinline__ uint64_t low_mask(int bits) {
  return bits >= 64 ? ~0ull : ((1ull << bits) - 1ull);
}

// Word `w` of a stream of `n` elements at width `bits` (1..64).
// `value(i)` returns element i already masked to `bits` bits.  The word
// covers stream bits [32w, 32w + 32); every element that overlaps it adds
// its part, shifted into place.
template <class Value>
__device__ __forceinline__ uint32_t gather_word(long long w, int bits,
                                                long long n, Value value) {
  const long long first_bit = w * 32;
  const long long i0 = first_bit / bits;
  long long i1 = (first_bit + 31) / bits;
  if (i1 > n - 1) i1 = n - 1;
  uint32_t word = 0;
  for (long long i = i0; i <= i1; ++i) {
    const uint64_t v = value(i);
    const long long off = i * bits - first_bit;  // in (-64, 32)
    word |= off >= 0 ? (uint32_t)(v << off) : (uint32_t)(v >> (-off));
  }
  return word;
}

// Element i of the stream in `words`, width `bits` (1..64).  Reads only
// the words the element's bits lie in, so it never reads past the
// stream's last word.
__device__ __forceinline__ uint64_t element(const uint32_t* words,
                                            long long i, int bits) {
  const long long p = i * bits;
  const long long w = p >> 5;
  const int s = (int)(p & 31);
  uint64_t acc = words[w];
  if (s + bits > 32) acc |= (uint64_t)words[w + 1] << 32;
  uint64_t v = acc >> s;
  if (s + bits > 64) v |= (uint64_t)words[w + 2] << (64 - s);
  return v & low_mask(bits);
}

// Threads per CTA of every kernel (ops/_launch.py THREADS).
constexpr int kThreads = 256;

}  // namespace minnow

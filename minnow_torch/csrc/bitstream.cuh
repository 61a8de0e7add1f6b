// Device functions for the minnow bit stream, shared by the kernels.
//
// Element i of a width-`bits` stream occupies bits [i*bits, (i+1)*bits),
// least significant bit first, in little-endian uint32 words
// (minnow_tpu/core/spec.py:87-127; ref go/bit/bit.go).
//
// Both directions are in gather form: a thread computes one whole output
// word (pack) or one whole element (unpack, at any start bit) from what
// it reads, so no two threads write the same word, nothing needs atomics,
// and the bytes do not depend on scheduling.  They replace the TPU's
// planar tile pack and unpack (minnow_tpu/ops/pallas_encode.py:218
// _pack_tile_planar, minnow_tpu/ops/pallas_codec.py:355
// _unpack_group_tiles), which exist to fit the (8, 128) vreg tiling.  gather_word serves the int pack, whose
// widths reach 64; the float packs (encode_float.cu) pack groups of 32
// elements in registers, one thread a group, and only divide by the
// width, with the helpers at the end of this file.

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

// The element of width `bits` (1..64) that starts at bit `bit` of the
// stream in `src`: element i of a stream that starts at bit s0 lies at
// bit s0 + i * bits, wherever s0 falls in a word.  Reads only the words
// the element's bits lie in, so it never reads past the word that holds
// the stream's last bit; bits of a neighbouring stream in those words are
// masked off.
__device__ __forceinline__ uint64_t element_at(const uint32_t* src,
                                               long long bit, int bits) {
  const long long w = bit >> 5;
  const int s = (int)(bit & 31);
  uint64_t acc = src[w];
  if (s + bits > 32) acc |= (uint64_t)src[w + 1] << 32;
  uint64_t v = acc >> s;
  if (s + bits > 64) v |= (uint64_t)src[w + 2] << (64 - s);
  return v & low_mask(bits);
}

// Threads per CTA of the kernels whose grid the wrapper shapes
// (ops/_launch.py THREADS).
constexpr int kThreads = 256;

// Division by a width w in 1..32 without a divide: for 0 <= a < 2^26,
// div_by(a, div_magic(w)) == a / w.  With M = floor(2^31 / w) + 1,
// 2a M / 2^32 = a / w + a (M w - 2^31) / (w 2^31); M w - 2^31 <= w <= 32,
// so the excess is below 1 / w and never reaches the next integer.
__device__ __forceinline__ uint32_t div_magic(int w) {
  return (1u << 31) / (uint32_t)w + 1u;
}
__device__ __forceinline__ int div_by(int a, uint32_t magic) {
  return (int)__umulhi(2u * (uint32_t)a, magic);
}

}  // namespace minnow

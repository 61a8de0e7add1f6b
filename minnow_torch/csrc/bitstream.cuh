// Device functions for the minnow bit stream, shared by the kernels.
//
// Element i of a width-`bits` stream occupies bits [i*bits, (i+1)*bits),
// least significant bit first, in little-endian uint32 words
// (minnow_tpu/core/spec.py:87-127; ref go/bit/bit.go).
//
// The packs (K1 and K5, encode_float.cu, widths 0..32; K3, pack_int.cu,
// widths 0..64) work by aligned tiles in shared memory: one thread packs
// a group of 32 elements in registers at a width that is a template
// constant, into exactly `bits` words, and the CTA writes the tile's
// words out in whole lines, mapping a word to its group with div_by
// below.  The unpacks (K2, K4) are in gather form: a thread extracts one
// whole element at any start bit with element_at, so no two threads
// write the same word, nothing needs atomics, and the bytes do not depend
// on scheduling.  They replace the TPU's planar tile pack and unpack
// (minnow_tpu/ops/pallas_encode.py:218 _pack_tile_planar,
// minnow_tpu/ops/pallas_codec.py:355 _unpack_group_tiles), which exist to
// fit the (8, 128) vreg tiling.

#pragma once

#include <cstdint>

namespace minnow {

// Mask of the low `bits` bits, for bits in [0, 64].
__device__ __forceinline__ uint64_t low_mask(int bits) {
  return bits >= 64 ? ~0ull : ((1ull << bits) - 1ull);
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

// Division by a width w in 1..64 without a divide: for a >= 0 with
// a w < 2^31, div_by(a, div_magic(w)) == a / w.  With M = floor(2^31 / w)
// + 1, 2a M / 2^32 = a / w + a (M w - 2^31) / (w 2^31); M w - 2^31 <= w,
// so the excess is at most a / 2^31, below 1 / w, and a / w, whose
// fraction is at most (w - 1) / w, never reaches the next integer.  The
// packs map a tile's words to their groups with it: K1's tiles have at
// most 32 * 128 words (a < 2^12, w <= 32), K3's at most 64 * 4,096 / 32
// = 8,192 (a < 2^13, w <= 64).
__device__ __forceinline__ uint32_t div_magic(int w) {
  return (1u << 31) / (uint32_t)w + 1u;
}
__device__ __forceinline__ int div_by(int a, uint32_t magic) {
  return (int)__umulhi(2u * (uint32_t)a, magic);
}

}  // namespace minnow

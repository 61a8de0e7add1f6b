// K4: ragged int-block unpack for Hopper (sm_90a), every width 0..64.
//
// Replaces minnow_tpu/ops/pallas_codec.py:592 unpack_pallas_group (kernel
// _unpack_kernel_group :466, _unpack_group_tiles :355) for widths 1..32 and
// :641 unpack_pallas_group64 (kernel _unpack_kernel_group64 :610) for
// widths 33..64, with the caller's add of the block minimum
// (minnow_tpu/ops/codec.py:370-388); with zero minimums it is also the
// per-tile raw unpack unpack_pallas :689 (kernel _unpack_kernel :201).
//
// One launch decodes a table of blocks, each with its own start bit in
// one byte stream, width, length, minimum and place in the output: the
// blocks of a whole column as they lie in the file, back to back at byte
// boundaries.  CTA (b, y) loads block b's row of the table once, leaves
// at once if its first element is at or past the block's length, and
// otherwise walks the block's elements at a stride of gridDim.y * kThreads
// (about UNPACK_PER_THREAD each, ops/decode.py); each element i comes
// whole from the stream:
//
//   out[out_off + i] = (int64)(delta_i + (uint64)min)   (wrapping, 64 bits)
//
// with delta_i the `bits` bits at start_bit + i * bits.  This is
// spec.decode_int_block (minnow_tpu/core/spec.py:296): the uint64 delta
// plus the int64 minimum, modulo 2^64.  The TPU kernels split wide values
// into (lo, hi) uint32 halves only because Mosaic has no 64-bit vectors;
// here minnow::element_at extracts the whole 64-bit delta from the up to
// three words it spans, and the add is one uint64 add.  Width 0 reads no
// words and writes the minimum.
//
// What bounds it on the H100.  At the flagship shape (4096 blocks of 2^17
// at 18 or 54 bits) device memory: per element bits/8 bytes of stream
// (each word read by the up to 32 threads whose elements lie in it,
// served from L1/L2) and 8 bytes of int64 written.  At the main path's
// shapes -- a column of 512 cells of ~3,800 rows, one row-block of
// 853,007, 1,536 blocks of 4,096 -- the bound is microseconds and the
// time was the host's: a launch, a word matrix built on the host and a
// copy each way for every (length, width) bucket of a column.  The table
// removes the buckets: the bytes go to the card as they lie in the file
// (no re-packing into words on the host), and a column is one copy up,
// one launch and one copy down; the table costs 40 bytes a block.
// Unlike the TPU kernels there is no 32*G*8 alignment and no padding (any
// length >= 1), one kernel for all widths, and no transposes, because a
// thread addresses its own bits (gather form, as K2).

#include <cuda_runtime.h>

#include <cstdint>

#include "bitstream.cuh"

namespace {

using minnow::kThreads;

__global__ void __launch_bounds__(kThreads)
unpack_int_kernel(const uint32_t* __restrict__ src,
                  const long long* __restrict__ start_bit,
                  const long long* __restrict__ width,
                  const long long* __restrict__ len,
                  const long long* __restrict__ out_off,
                  const long long* __restrict__ mins,
                  long long* __restrict__ out) {
  const int b = blockIdx.x;
  const long long n = len[b];
  const long long first = (long long)blockIdx.y * blockDim.x;
  if (first >= n) return;
  // the block's first word, and where in it the block starts (as in K2)
  const long long s0 = start_bit[b];
  const uint32_t* sb = src + (s0 >> 5);
  const int s0lo = (int)(s0 & 31);
  const int bits = (int)width[b];
  long long* ob = out + out_off[b];
  const uint64_t mn = (uint64_t)mins[b];

  const long long stride = (long long)gridDim.y * blockDim.x;
  for (long long i = first + threadIdx.x; i < n; i += stride) {
    const uint64_t delta =
        bits ? minnow::element_at(sb, s0lo + i * bits, bits) : 0ull;
    ob[i] = (long long)(delta + mn);
  }
}

}  // namespace

// src: the byte stream as uint32 words, holding every block's bits; the
// table, B rows, each (B,) int64: start_bit, bits (0..64), len, out_off,
// mins; out int64, element out_off[b] + i of block b's element i;
// grid (B, grid_y).
extern "C" int minnow_unpack_int_ragged(const void* src, long long B,
                                        const void* start_bit,
                                        const void* bits, const void* len,
                                        const void* out_off,
                                        const void* mins, void* out,
                                        unsigned int grid_y, void* stream) {
  const dim3 grid((unsigned int)B, grid_y);
  unpack_int_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)src, (const long long*)start_bit,
      (const long long*)bits, (const long long*)len,
      (const long long*)out_off, (const long long*)mins, (long long*)out);
  return (int)cudaGetLastError();
}

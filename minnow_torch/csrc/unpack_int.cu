// K4: int-block unpack for Hopper (sm_90a), every width 0..64.
//
// Replaces minnow_tpu/ops/pallas_codec.py:592 unpack_pallas_group (kernel
// _unpack_kernel_group :466, _unpack_group_tiles :355) for widths 1..32 and
// :641 unpack_pallas_group64 (kernel _unpack_kernel_group64 :610) for
// widths 33..64, with the caller's add of the block minimum
// (minnow_tpu/ops/codec.py:370-388); with zero minimums it is also the
// per-tile raw unpack unpack_pallas :689 (kernel _unpack_kernel :201).
// CTA (b, y) walks block b's elements at a stride of gridDim.y * kThreads
// (about UNPACK_PER_THREAD each, ops/decode.py); each element i comes
// whole from the block's row of packed words:
//
//   out = (int64)(delta_i + (uint64)min)             (wrapping, 64 bits)
//
// This is spec.decode_int_block (minnow_tpu/core/spec.py:296): the uint64
// delta plus the int64 minimum, modulo 2^64.  The TPU kernels split wide
// values into (lo, hi) uint32 halves only because Mosaic has no 64-bit
// vectors; here minnow::element extracts the whole 64-bit delta from the
// up to three words it spans, and the add is one uint64 add.  Width 0
// reads no words and writes the minimum.
//
// What bounds it on the H100: device memory.  Per element it reads bits/8
// bytes of words (each word by the up to 32 threads whose elements lie in
// it, served from L1/L2) and writes 8 bytes of int64.  What differs from
// the TPU kernels: no 32*G*8 alignment and no padding (any n >= 1), one
// kernel for all widths, and no transposes, because a thread addresses
// its own bits (gather form, as K2).

#include <cuda_runtime.h>

#include <cstdint>

#include "bitstream.cuh"

namespace {

using minnow::kThreads;

__global__ void __launch_bounds__(kThreads)
unpack_int_kernel(const uint32_t* __restrict__ words, long long row_words,
                  long long n, int bits,
                  const long long* __restrict__ mins,
                  long long* __restrict__ out) {
  const int b = blockIdx.x;
  const uint32_t* wb = words + (long long)b * row_words;
  long long* ob = out + (long long)b * n;
  const uint64_t mn = (uint64_t)mins[b];

  const long long stride = (long long)gridDim.y * blockDim.x;
  for (long long i = (long long)blockIdx.y * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const uint64_t delta = bits ? minnow::element(wb, i, bits) : 0ull;
    ob[i] = (long long)(delta + mn);
  }
}

}  // namespace

// words (B, row_words) uint32 stream rows at width bits (0..64), each row
// at least ceil(n * bits / 32) words; mins (B,) int64; out (B, n) int64;
// grid (B, grid_y).
extern "C" int minnow_unpack_int(const void* words, long long B,
                                 long long row_words, long long n, int bits,
                                 const void* mins, void* out,
                                 unsigned int grid_y, void* stream) {
  const dim3 grid((unsigned int)B, grid_y);
  unpack_int_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)words, row_words, n, bits, (const long long*)mins,
      (long long*)out);
  return (int)cudaGetLastError();
}

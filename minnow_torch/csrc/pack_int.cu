// K3: int-block delta pack for Hopper (sm_90a).
//
// Replaces minnow_tpu/ops/pallas_encode.py:949 pack_int_pallas_group
// (kernel _pack_int_kernel :910, _pack_tile_planar64 :259), as called by
// delta_pack_int_pallas :1006, and with zero minimums and one width
// minnow_tpu/ops/pallas_pack.py:82 pack_batch_pallas (kernel _kernel :44,
// ops/encode.py pack_batch).  Per block b of a (B, n) int64 batch and
// its first lens[b] elements (spec.encode_int_block,
// minnow_tpu/core/spec.py:278): delta = (uint64)(x - min) with wrapping
// arithmetic, packed at the block's width (1..64).  One thread per output
// word, gather form (bitstream.cuh), native 64-bit arithmetic: the TPU
// kernel's split into u32 limb planes existed because Mosaic has no
// 64-bit vectors.  The per-block min and max delta come from plain
// PyTorch reductions before this launch, as the JAX package took them in
// XLA (codec.int_block_stats).
//
// What bounds it on the H100: device memory.  Per element it reads 8
// bytes of x (each element by the one or two threads whose words it
// touches) and writes bits/8 bytes.

#include <cuda_runtime.h>

#include <cstdint>

#include "bitstream.cuh"

namespace {

using minnow::kThreads;

__global__ void __launch_bounds__(kThreads)
pack_int_kernel(const long long* __restrict__ x, long long n,
                const long long* __restrict__ mins,
                const int* __restrict__ bits,
                const long long* __restrict__ lens,
                const long long* __restrict__ offsets,
                unsigned int* __restrict__ words) {
  const int b = blockIdx.x;
  const int width = bits[b];
  if (width == 0) return;
  const long long* xb = x + (long long)b * n;
  const long long len = lens[b];
  const uint64_t mn = (uint64_t)mins[b];
  const uint64_t mask = minnow::low_mask(width);
  unsigned int* out = words + offsets[b];

  auto value = [&](long long i) -> uint64_t {
    return ((uint64_t)xb[i] - mn) & mask;
  };

  const long long nw = ((long long)width * len + 31) / 32;
  const long long stride = (long long)gridDim.y * blockDim.x;
  for (long long w = (long long)blockIdx.y * blockDim.x + threadIdx.x;
       w < nw; w += stride) {
    out[w] = minnow::gather_word(w, width, len, value);
  }
}

}  // namespace

// x (B, n) int64; mins, lens, offsets (B,) int64; bits (B,) int32 in
// [0, 64] (0: nothing to write); words: the back-to-back block streams;
// grid (B, grid_y).
extern "C" int minnow_pack_int(const void* x, long long B, long long n,
                               const void* mins, const void* bits,
                               const void* lens, const void* offsets,
                               void* words, unsigned int grid_y,
                               void* stream) {
  const dim3 grid((unsigned int)B, grid_y);
  pack_int_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const long long*)x, n, (const long long*)mins, (const int*)bits,
      (const long long*)lens, (const long long*)offsets,
      (unsigned int*)words);
  return (int)cudaGetLastError();
}

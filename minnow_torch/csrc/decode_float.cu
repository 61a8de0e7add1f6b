// K2: fused float-block decode for Hopper (sm_90a).
//
// Replaces minnow_tpu/ops/pallas_codec.py:526 decode_float_pallas_group
// (kernels _decode_kernel_group :398 / _decode_kernel_group_multi :418,
// tail _dequant_tail :140, dither _dither_u_tile :376), and the per-tile
// decode decode_float_pallas :252 (kernel _decode_kernel :174), which
// computes the same for n % 256 == 0 in the none and midpoint modes.  One
// thread per element i of block b, from the block's row of packed words:
//
//   q = delta_i + min                              (wrapping, 64 bits)
//   periodic blocks: one +-pixels step into [0, pixels)      (spec.bound;
//     pixels is a 64-bit count, anything in [1, 2^63))
//   v = f32(f64(q) + f64(u))   u = 0, 0.5, or dither_hash_u(i, k1, k2)
//   out = f32(dx * v) + low                              (spec.dequantize)
//
// This is spec.dequantize (minnow_tpu/core/spec.py:256), the host reader's
// arithmetic, so the kernel equals the host reader in every dither mode;
// for q < 2^24 it also equals the JAX dequantize24.  The products and sums
// are explicitly rounded (__dadd_rn, __double2float_rn, __fmul_rn,
// __fadd_rn) and the build passes -fmad=false: dx*v + low must never
// become an FMA (minnow_tpu/ops/codec.py:142-150).
//
// What bounds it on the H100: device memory.  Per element it reads bits/8
// bytes of words (each word is read by the up to 32 threads whose elements
// lie in it, served from L1/L2) and writes 4 bytes of float32.  The
// counter hash is ~15 integer operations, far below the card's integer
// rate at that byte rate.  What differs from the TPU kernel: no
// 32*G*8 alignment and no padding (any n >= 1), widths 0..64 in one
// kernel, and no transposes, because a thread addresses its own bits.

#include <cuda_runtime.h>

#include <cstdint>

#include "bitstream.cuh"

namespace {

using minnow::kThreads;

// codec.dither_hash_u (minnow_tpu/ops/codec.py:410): lowbias32 of
// (c + k2) ^ k1 with the mantissa fill, a float32 in [0, 1).
__device__ __forceinline__ float dither_hash_u(uint32_t c, uint32_t k1,
                                               uint32_t k2) {
  uint32_t x = (c + k2) ^ k1;
  x ^= x >> 16;
  x *= 0x21F0AAADu;
  x ^= x >> 15;
  x *= 0xD35A2D97u;
  x ^= x >> 15;
  const uint32_t fb = (x >> 9) | 0x3F800000u;
  return __fsub_rn(__uint_as_float(fb), 1.0f);
}

__global__ void __launch_bounds__(kThreads)
decode_kernel(const uint32_t* __restrict__ words, long long row_words,
              long long n, int bits, const long long* __restrict__ mins,
              const float* __restrict__ low, const float* __restrict__ dx,
              const long long* __restrict__ pixels,
              const unsigned char* __restrict__ periodic, int mode,
              const uint32_t* __restrict__ k1,
              const uint32_t* __restrict__ k2, float* __restrict__ out) {
  const int b = blockIdx.x;
  const uint32_t* wb = words + (long long)b * row_words;
  float* ob = out + (long long)b * n;
  const uint64_t mn = (uint64_t)mins[b];
  const float lo = low[b], d = dx[b];
  const long long p = pixels[b];
  const bool per = periodic[b] != 0;
  const uint32_t key1 = mode == 2 ? k1[b] : 0u;
  const uint32_t key2 = mode == 2 ? k2[b] : 0u;

  const long long stride = (long long)gridDim.y * blockDim.x;
  for (long long i = (long long)blockIdx.y * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const uint64_t delta = bits ? minnow::element(wb, i, bits) : 0ull;
    long long q = (long long)(delta + mn);
    if (per) {  // spec.bound(q, 0, pixels)
      if (q < 0) q += p;
      if (q >= p) q -= p;
    }
    double u = 0.0;
    if (mode == 1) u = 0.5;
    if (mode == 2) u = (double)dither_hash_u((uint32_t)i, key1, key2);
    const float v = __double2float_rn(__dadd_rn(__ll2double_rn(q), u));
    ob[i] = __fadd_rn(__fmul_rn(d, v), lo);
  }
}

}  // namespace

// words (B, row_words) uint32 stream rows at width bits (0..64); mins (B,)
// int64; low, dx (B,) float32; pixels (B,) int64; periodic (B,) bool;
// mode 0 none, 1 midpoint, 2 uniform (k1, k2 (B,) uint32 keys; may be
// null otherwise); out (B, n) float32; grid (B, grid_y).
extern "C" int minnow_decode_float(const void* words, long long B,
                                   long long row_words, long long n,
                                   int bits, const void* mins,
                                   const void* low, const void* dx,
                                   const void* pixels, const void* periodic,
                                   int mode, const void* k1, const void* k2,
                                   void* out, unsigned int grid_y,
                                   void* stream) {
  const dim3 grid((unsigned int)B, grid_y);
  decode_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)words, row_words, n, bits, (const long long*)mins,
      (const float*)low, (const float*)dx, (const long long*)pixels,
      (const unsigned char*)periodic, mode, (const uint32_t*)k1,
      (const uint32_t*)k2, (float*)out);
  return (int)cudaGetLastError();
}

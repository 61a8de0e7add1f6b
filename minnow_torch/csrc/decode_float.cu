// K2: ragged float-block decode for Hopper (sm_90a).
//
// Replaces minnow_tpu/ops/pallas_codec.py:526 decode_float_pallas_group
// (kernels _decode_kernel_group :398 / _decode_kernel_group_multi :418,
// tail _dequant_tail :140, dither _dither_u_tile :376), and the per-tile
// decode decode_float_pallas :252 (kernel _decode_kernel :174), which
// computes the same for n % 256 == 0 in the none and midpoint modes.
//
// One launch decodes a table of blocks, each with its own start bit in
// one byte stream, width, length, minimum, place in the output and
// quantisation config: the blocks of a whole column, or of a whole minp
// file, as they lie in the file.  CTA (b, y) loads block b's row of the
// table once and leaves at once if its first element is at or past the
// block's length; otherwise one thread per element i of block b:
//
//   q = delta_i + min                              (wrapping, 64 bits)
//   periodic blocks: one +-pixels step into [0, pixels)      (spec.bound;
//     pixels is a 64-bit count, anything in [1, 2^63))
//   v = f32(f64(q) + f64(u))   u = 0, 0.5, or dither_hash_u(i, k1, k2)
//   out[out_off + i] = f32(dx * v) + low                 (spec.dequantize)
//
// with delta_i the `bits` bits at start_bit + i * bits, and the uniform
// dither keyed on the container block index (k1, k2) with i counted
// within the block, as the host reader keys it (core/reader.py data()).
// This is spec.dequantize (minnow_tpu/core/spec.py:256), the host reader's
// arithmetic, so the kernel equals the host reader in every dither mode;
// for q < 2^24 it also equals the JAX dequantize24.  The products and sums
// are explicitly rounded (__dadd_rn, __double2float_rn, __fmul_rn,
// __fadd_rn) and the build passes -fmad=false: dx*v + low must never
// become an FMA (minnow_tpu/ops/codec.py:142-150).
//
// What bounds it on the H100.  At the flagship shape (4096 blocks of 2^17
// at 18 bits) device memory: per element bits/8 bytes of stream (each
// word read by the up to 32 threads whose elements lie in it, served from
// L1/L2) and 4 bytes of float32 written; the counter hash is ~15 integer
// operations, far below the card's integer rate at that byte rate.  At
// the main path's shapes -- a boundary column of 512 cells of ~3,800 rows
// (4.4 MB in, 7.9 MB out: a bound of ~3.7 us), a minp file of 1,536
// blocks of 4,096 -- the time was the host's: a launch, a host-built word
// matrix and a copy each way for every (length, width) bucket.  The table
// removes the buckets: the bytes reach the card as they lie in the file,
// and a column or a file is one copy up, one launch and one copy down;
// the table costs 57 bytes a block (65 with the uniform keys).  Unlike the
// TPU kernel there is no 32*G*8 alignment and no padding (any length),
// widths 0..64 in one kernel, and no transposes, because a thread
// addresses its own bits.

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

// At most 40 registers a thread (6 CTAs of 256 threads an SM): the
// per-block row of the table lives in vector registers, where the (B, W)
// kernel had its width and length in uniform ones; at the 32 registers
// ptxas chose by itself the loop lost its second element's loads in
// flight (flagship 1.97-1.98 ms against 1.93 at 40 and 2.01 at 46; H100,
// CUDA graph of 10 launches).
__global__ void __launch_bounds__(kThreads, 6)
decode_kernel(const uint32_t* __restrict__ src,
              const long long* __restrict__ start_bit,
              const long long* __restrict__ width,
              const long long* __restrict__ len,
              const long long* __restrict__ out_off,
              const long long* __restrict__ mins,
              const float* __restrict__ low, const float* __restrict__ dx,
              const long long* __restrict__ pixels,
              const unsigned char* __restrict__ periodic, int mode,
              const uint32_t* __restrict__ k1,
              const uint32_t* __restrict__ k2, float* __restrict__ out) {
  const int b = blockIdx.x;
  const long long n = len[b];
  const long long first = (long long)blockIdx.y * blockDim.x;
  if (first >= n) return;
  // the block's first word, and where in it the block starts: the loop
  // keeps a 32-bit offset live, not a 64-bit start bit
  const long long s0 = start_bit[b];
  const uint32_t* sb = src + (s0 >> 5);
  const int s0lo = (int)(s0 & 31);
  const int bits = (int)width[b];
  float* ob = out + out_off[b];
  const uint64_t mn = (uint64_t)mins[b];
  const float lo = low[b], d = dx[b];
  const long long p = pixels[b];
  const bool per = periodic[b] != 0;
  const uint32_t key1 = mode == 2 ? k1[b] : 0u;
  const uint32_t key2 = mode == 2 ? k2[b] : 0u;

  const long long stride = (long long)gridDim.y * blockDim.x;
  for (long long i = first + threadIdx.x; i < n; i += stride) {
    const uint64_t delta =
        bits ? minnow::element_at(sb, s0lo + i * bits, bits) : 0ull;
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

// src: the byte stream as uint32 words, holding every block's bits; the
// table, B rows: start_bit, bits (0..64), len, out_off, mins (B,) int64,
// low, dx (B,) float32, pixels (B,) int64, periodic (B,) bool; mode 0
// none, 1 midpoint, 2 uniform (k1, k2 (B,) uint32 keys; may be null
// otherwise); out float32, element out_off[b] + i of block b's element i;
// grid (B, grid_y).
extern "C" int minnow_decode_float_ragged(
    const void* src, long long B, const void* start_bit, const void* bits,
    const void* len, const void* out_off, const void* mins, const void* low,
    const void* dx, const void* pixels, const void* periodic, int mode,
    const void* k1, const void* k2, void* out, unsigned int grid_y,
    void* stream) {
  const dim3 grid((unsigned int)B, grid_y);
  decode_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)src, (const long long*)start_bit,
      (const long long*)bits, (const long long*)len,
      (const long long*)out_off, (const long long*)mins, (const float*)low,
      (const float*)dx, (const long long*)pixels,
      (const unsigned char*)periodic, mode, (const uint32_t*)k1,
      (const uint32_t*)k2, (float*)out);
  return (int)cudaGetLastError();
}

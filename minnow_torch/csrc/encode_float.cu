// K1: fused float-block encode for Hopper (sm_90a), and K5, the pack from
// a precomputed q.
//
// K1 replaces minnow_tpu/ops/pallas_encode.py:1045 encode_float_pallas_group
// (kernel _encode_kernel_group :493 / _encode_group_block :514), and with
// it the two other TPU float encodes of the reference's write path
// (parallel/pipeline.py:364-379): the big-block pack with a known m and
// minimum, pack_float_pallas_group :714, is this file's pack launch, and
// the per-tile encode encode_float_pallas :388 is both launches.  Those
// TPU variants exist only for B1's tile alignment and block-length cap,
// which these kernels do not have.  What it
// computes, per block b of a (B, n) float32 batch and its first lens[b]
// elements (spec.encode_float_block, minnow_tpu/core/spec.py:303):
//
//   q = floor(f32(f32(x - low) / dx))                      (spec.quantize)
//   periodic blocks: recentre q into [m, m + pixels) by the one-pass
//     window offset m (spec.periodic_min_fast)
//   min-subtract, and pack the deltas at the block's true width.
//
// Two launches.  minnow_encode_float_stats reduces each block to
// (q0, ymin, ymax, qmin, qmax, valid) with warp reductions and one atomic
// per warp into int32 slots the caller initialised.  The host then
// derives the offset m, the block minimum and the width exactly as
// pallas_encode.py:591-617 does, and lays the blocks' streams out back to
// back.  minnow_encode_float_pack runs one thread per output word: it
// re-quantizes the elements overlapping its word, recentres, subtracts
// the minimum and packs (bitstream.cuh, gather form).
//
// K5, minnow_encode_float_pack_q, replaces pallas_encode.py:809
// pack_q_pallas_group (kernel _pack_q_kernel_group :771), the second
// dispatch of encode_float_pallas_bigblock(reuse_q=True) :855.  The stats
// launch, given a q buffer, also stores each element's int32 pixel (the
// TPU's float_block_stats32(return_q=True), ops/codec.py:252); K5 packs
// those pixels with the same recentring, minimum and layout as K1's pack,
// so its words equal K1's, without a second quantize.
//
// What bounds them on the H100: device memory, and in K1's pack the
// division.  Per element K1 reads x twice (8 bytes) and writes bits/8
// bytes; its pack quantizes every element that overlaps a word, about
// 1 + bits/32 IEEE divisions per element.  The reuse_q pair instead reads
// x once, writes and reads q (8 bytes) and divides once.  The TPU kernel
// kept q in VMEM between its passes; keeping it on chip here is later
// work.
//
// What differs from the TPU kernels: any n >= 1 (no 32*G*8 alignment, no
// static width), a true width per block (so no predicted-width re-encode
// loop), and IEEE division (__fdiv_rn) in place of the 16-bit-limb magic
// reciprocal that Mosaic needed.  All float arithmetic is explicitly
// rounded (__fsub_rn, __fdiv_rn) and the build passes -fmad=false.
//
// A block is `valid` unless an element's pixel is not finite or has
// |q| >= 2^31, or a periodic block holds a pixel outside [0, pixels);
// the caller encodes invalid blocks with the normative host encoder.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "bitstream.cuh"

namespace {

using minnow::kThreads;

enum { kQ0, kYMin, kYMax, kQMin, kQMax, kValid, kNStats };

struct Pixel {
  int q;
  bool ok;
};

__device__ __forceinline__ Pixel quantize(float x, float low, float dx) {
  const float qf = floorf(__fdiv_rn(__fsub_rn(x, low), dx));
  Pixel r;
  r.ok = isfinite(qf) && fabsf(qf) < 2147483648.0f;
  r.q = r.ok ? (int)qf : 0;
  return r;
}

// spec.periodic_distance (minnow_tpu/core/spec.py:130), in 64 bits.
__device__ __forceinline__ long long periodic_distance(long long x,
                                                       long long x0,
                                                       long long p) {
  const long long d = x - x0;
  if (d >= 0) {
    if (d > p - d) return d - p;
  } else if (d < -(d + p)) {
    return p + d;
  }
  return d;
}

__global__ void __launch_bounds__(kThreads)
stats_kernel(const float* __restrict__ x, long long n,
             const float* __restrict__ low, const float* __restrict__ dx,
             const int* __restrict__ pixels,
             const unsigned char* __restrict__ periodic,
             const long long* __restrict__ lens, int* __restrict__ stats,
             int* __restrict__ q) {
  const int b = blockIdx.x;
  const float* xb = x + (long long)b * n;
  int* qb = q ? q + (long long)b * n : nullptr;
  const long long len = lens[b];
  const float lo = low[b], d = dx[b];
  const long long p = pixels[b];
  const bool per = periodic[b] != 0;

  Pixel first = {0, false};
  if (len > 0) first = quantize(xb[0], lo, d);
  const bool first_in = first.ok && first.q >= 0 && first.q < p;

  int ymin = INT_MAX, ymax = INT_MIN, qmin = INT_MAX, qmax = INT_MIN;
  unsigned int valid = 1;
  const long long stride = (long long)gridDim.y * blockDim.x;
  for (long long i = (long long)blockIdx.y * blockDim.x + threadIdx.x;
       i < len; i += stride) {
    const Pixel r = quantize(xb[i], lo, d);
    if (qb) qb[i] = r.q;
    if (!r.ok) {
      valid = 0;
      continue;
    }
    qmin = min(qmin, r.q);
    qmax = max(qmax, r.q);
    if (per) {
      if (r.q < 0 || r.q >= p) {
        valid = 0;
      } else if (first_in) {
        const int y = (int)periodic_distance(r.q, first.q, p);
        ymin = min(ymin, y);
        ymax = max(ymax, y);
      }
    }
  }
  const unsigned int all = 0xffffffffu;
  ymin = __reduce_min_sync(all, ymin);
  ymax = __reduce_max_sync(all, ymax);
  qmin = __reduce_min_sync(all, qmin);
  qmax = __reduce_max_sync(all, qmax);
  valid = __reduce_and_sync(all, valid);
  int* s = stats + (long long)b * kNStats;
  if ((threadIdx.x & 31) == 0) {
    atomicMin(s + kYMin, ymin);
    atomicMax(s + kYMax, ymax);
    atomicMin(s + kQMin, qmin);
    atomicMax(s + kQMax, qmax);
    if (!valid) atomicAnd(s + kValid, 0);
  }
  if (blockIdx.y == 0 && threadIdx.x == 0 && first.ok) s[kQ0] = first.q;
}

// The words of block b: the pixel q_of(i) of each element, recentred
// (spec.bound(q, m, pixels) for periodic blocks), minus the block minimum,
// packed at the block's width.  One thread per output word.
template <class Q>
__device__ __forceinline__ void pack_block(
    Q q_of, int b, const int* __restrict__ pixels,
    const unsigned char* __restrict__ periodic,
    const long long* __restrict__ m, const long long* __restrict__ mn,
    int width, const long long* __restrict__ lens,
    const long long* __restrict__ offsets, unsigned int* __restrict__ words) {
  const long long len = lens[b];
  const long long p = pixels[b];
  const bool per = periodic[b] != 0;
  const long long mb = m[b], minb = mn[b];
  const uint64_t mask = minnow::low_mask(width);
  unsigned int* out = words + offsets[b];

  auto value = [&](long long i) -> uint64_t {
    long long q = q_of(i);
    if (per) {
      if (q < mb) q += p;
      if (q >= mb + p) q -= p;
    }
    return (uint64_t)(q - minb) & mask;
  };

  const long long nw = ((long long)width * len + 31) / 32;
  const long long stride = (long long)gridDim.y * blockDim.x;
  for (long long w = (long long)blockIdx.y * blockDim.x + threadIdx.x;
       w < nw; w += stride) {
    out[w] = minnow::gather_word(w, width, len, value);
  }
}

__global__ void __launch_bounds__(kThreads)
pack_kernel(const float* __restrict__ x, long long n,
            const float* __restrict__ low, const float* __restrict__ dx,
            const int* __restrict__ pixels,
            const unsigned char* __restrict__ periodic,
            const long long* __restrict__ m, const long long* __restrict__ mn,
            const int* __restrict__ bits, const long long* __restrict__ lens,
            const long long* __restrict__ offsets,
            unsigned int* __restrict__ words) {
  const int b = blockIdx.x;
  const int width = bits[b];
  if (width == 0) return;
  const float* xb = x + (long long)b * n;
  const float lo = low[b], d = dx[b];
  pack_block([&](long long i) -> long long {
               return quantize(xb[i], lo, d).q;
             },
             b, pixels, periodic, m, mn, width, lens, offsets, words);
}

__global__ void __launch_bounds__(kThreads)
pack_q_kernel(const int* __restrict__ q, long long n,
              const int* __restrict__ pixels,
              const unsigned char* __restrict__ periodic,
              const long long* __restrict__ m,
              const long long* __restrict__ mn, const int* __restrict__ bits,
              const long long* __restrict__ lens,
              const long long* __restrict__ offsets,
              unsigned int* __restrict__ words) {
  const int b = blockIdx.x;
  const int width = bits[b];
  if (width == 0) return;
  const int* qb = q + (long long)b * n;
  pack_block([&](long long i) -> long long { return qb[i]; }, b, pixels,
             periodic, m, mn, width, lens, offsets, words);
}

}  // namespace

// Launch shape of every entry point: grid (B, grid_y) of kThreads
// threads; blockIdx.x is the minnow block, and blockIdx.y with the
// threads strides over that block's elements or words.
//
// x (B, n) float32; low, dx (B,) float32; pixels (B,) int32; periodic (B,)
// bool; lens (B,) int64 <= n; stats (B, 6) int32, initialised by the
// caller to (0, INT_MAX, INT_MIN, INT_MAX, INT_MIN, 1); q (B, n) int32 or
// null: when given, element i < lens[b] of row b gets its pixel (0 where
// it is not certified), and the rest of the row is left as it was.
extern "C" int minnow_encode_float_stats(
    const void* x, long long B, long long n, unsigned int grid_y,
    const void* low, const void* dx, const void* pixels,
    const void* periodic, const void* lens, void* stats, void* q,
    void* stream) {
  const dim3 grid((unsigned int)B, grid_y);
  stats_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, n, (const float*)low, (const float*)dx,
      (const int*)pixels, (const unsigned char*)periodic,
      (const long long*)lens, (int*)stats, (int*)q);
  return (int)cudaGetLastError();
}

// m, mn (B,) int64: recentring offset and block minimum; bits (B,) int32
// in [0, 32] (0: nothing to write); offsets (B,) int64 word offsets of
// each block's stream in `words`.
extern "C" int minnow_encode_float_pack(
    const void* x, long long B, long long n, const void* low,
    const void* dx, const void* pixels, const void* periodic, const void* m,
    const void* mn, const void* bits, const void* lens, const void* offsets,
    void* words, unsigned int grid_y, void* stream) {
  const dim3 grid((unsigned int)B, grid_y);
  pack_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, n, (const float*)low, (const float*)dx,
      (const int*)pixels, (const unsigned char*)periodic,
      (const long long*)m, (const long long*)mn, (const int*)bits,
      (const long long*)lens, (const long long*)offsets,
      (unsigned int*)words);
  return (int)cudaGetLastError();
}

// K5: q (B, n) int32 from the stats launch; the other arguments as for
// minnow_encode_float_pack.
extern "C" int minnow_encode_float_pack_q(
    const void* q, long long B, long long n, const void* pixels,
    const void* periodic, const void* m, const void* mn, const void* bits,
    const void* lens, const void* offsets, void* words, unsigned int grid_y,
    void* stream) {
  const dim3 grid((unsigned int)B, grid_y);
  pack_q_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)q, n, (const int*)pixels, (const unsigned char*)periodic,
      (const long long*)m, (const long long*)mn, (const int*)bits,
      (const long long*)lens, (const long long*)offsets,
      (unsigned int*)words);
  return (int)cudaGetLastError();
}

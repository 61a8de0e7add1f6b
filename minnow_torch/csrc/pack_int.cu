// K3: int-block encode for Hopper (sm_90a): stats, plan and delta pack.
//
// Replaces minnow_tpu/ops/pallas_encode.py:949 pack_int_pallas_group
// (kernel _pack_int_kernel :910, _pack_tile_planar64 :259), as called by
// delta_pack_int_pallas :1006 after the stats the JAX package takes in XLA
// (minnow_tpu/ops/codec.py:212 int_block_stats, parallel/pipeline.py:247-270),
// and with zero minimums and one width minnow_tpu/ops/pallas_pack.py:82
// pack_batch_pallas (kernel _kernel :44, ops/encode.py pack_batch).  Per
// block b of a (B, n) int64 batch and its first lens[b] elements
// (spec.encode_int_block, minnow_tpu/core/spec.py:278): the minimum, the
// width of the wrapped largest delta max - min (0..64), and delta =
// (uint64)(x - min), wrapping, packed at that width.
//
// Three launches in the shape of K1's (encode_float.cu), and nothing for
// the host between them.
//
// minnow_int_stats reduces each block to its int64 minimum and maximum: a
// CTA takes one run of a block's elements, reduces in its warps and in
// shared memory, and adds one atomicMin and one atomicMax on long long to
// the block's two slots, so that a long block spreads over many CTAs.
// Min and max do not depend on the order of the atomics: the result is
// the same every run.
//
// minnow_int_plan (one CTA) turns them into each block's minimum, largest
// delta and width, 64 - clz of the delta in unsigned arithmetic (0 for a
// constant block), and lays the blocks' streams out back to back in the
// device plan K1 writes too (plan.cuh).  The host reads the plan once,
// after the pack is queued.
//
// minnow_pack_int: one thread per output word, gather form
// (bitstream.cuh), native 64-bit arithmetic: the TPU kernel's split into
// u32 limb planes existed because Mosaic has no 64-bit vectors.  Width,
// minimum and word offset come from a device plan, the plan launch's or
// one the caller made on the host; the grid from what the host knows
// before the plan (B, n and the card's SMs), so the launch is queued
// before the plan exists.  A CTA strides over its block's words; a block
// that needs fewer words than the grid has threads leaves them idle.
//
// What bounds them on the H100: device memory.  The stats launch reads x
// once (8 bytes an element); the pack reads it again (each element by the
// one or two threads whose words it touches) and writes bits/8 bytes.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "bitstream.cuh"
#include "plan.cuh"

namespace {

using namespace minnow;  // kThreads; the plan's rows and layout

constexpr int kWarps = kThreads / 32;
// the pack's grid fills this many CTAs an SM (four waves of 8 resident
// CTAs of 256 threads) where a batch has few blocks
constexpr int kPackCtasPerSm = 32;

// Each block's slots to (INT64_MAX, INT64_MIN), for the atomics to take;
// an empty block's to (0, 0), which no CTA touches.
__global__ void int_stats_init_kernel(long long* __restrict__ stats,
                                      const long long* __restrict__ lens,
                                      long long B) {
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const bool live = lens[b] > 0;
  stats[2 * b] = live ? LLONG_MAX : 0;
  stats[2 * b + 1] = live ? LLONG_MIN : 0;
}

// CTA id -> block b = id / runs_per_row and the run id % runs_per_row of
// `run` elements of that block.
__global__ void __launch_bounds__(kThreads)
int_stats_kernel(const long long* __restrict__ x, long long n, int run,
                 unsigned int runs_per_row,
                 const long long* __restrict__ lens,
                 long long* __restrict__ stats) {
  const unsigned int b = blockIdx.x / runs_per_row;
  const unsigned int t = blockIdx.x - b * runs_per_row;
  const long long len = lens[b];
  const long long start = (long long)t * run;
  if (start >= len) return;
  const int cnt = (int)min((long long)run, len - start);
  const long long* xt = x + (long long)b * n + start;

  long long lo = LLONG_MAX, hi = LLONG_MIN;
  // four loads in flight before the first compare
  int i = threadIdx.x;
  for (; i + 3 * kThreads < cnt; i += 4 * kThreads) {
    const long long x0 = xt[i], x1 = xt[i + kThreads];
    const long long x2 = xt[i + 2 * kThreads], x3 = xt[i + 3 * kThreads];
    lo = min(lo, min(min(x0, x1), min(x2, x3)));
    hi = max(hi, max(max(x0, x1), max(x2, x3)));
  }
  for (; i < cnt; i += kThreads) {
    lo = min(lo, xt[i]);
    hi = max(hi, xt[i]);
  }
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }

  __shared__ long long red[kWarps][2];
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    red[warp][0] = lo;
    red[warp][1] = hi;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  for (int w = 1; w < kWarps; ++w) {
    lo = min(lo, red[w][0]);
    hi = max(hi, red[w][1]);
  }
  atomicMin(stats + 2 * b, lo);
  atomicMax(stats + 2 * b + 1, hi);
}

// One CTA of kPlanThreads threads: minimum, largest delta, width, word
// count and word offset of every block.  The difference is taken in
// unsigned arithmetic, so that it wraps where max - min passes 2^63 and
// holds the uint64 bit pattern the width is read from.
__global__ void __launch_bounds__(kPlanThreads)
int_plan_kernel(const long long* __restrict__ stats,
                const long long* __restrict__ lens, long long B,
                long long* __restrict__ plan) {
  lay_out_plan(B, plan, [&](long long b) {
    const long long len = lens[b];
    const bool empty = len == 0;
    const long long mn = empty ? 0 : stats[2 * b];
    const unsigned long long maxd =
        empty ? 0ull
              : (unsigned long long)stats[2 * b + 1] - (unsigned long long)mn;
    const long long bits = 64 - __clzll((long long)maxd);
    plan[kPMins * B + b] = mn;
    plan[kPMaxd * B + b] = (long long)maxd;
    plan[kPBits * B + b] = bits;
    plan[kPValid * B + b] = 1;
    plan[kPM * B + b] = 0;
    return (bits * len + 31) >> 5;
  });
}

// Grid (B, grid_y): CTA (b, y) packs words y * kThreads + threadIdx.x of
// block b's stream, and every grid_y * kThreads-th word after it.  A block
// whose stream would pass the end of `words` is not packed: the caller
// finds the plan's total above the capacity and raises.
__global__ void __launch_bounds__(kThreads)
pack_int_kernel(const long long* __restrict__ x, long long n,
                const long long* __restrict__ plan, long long B,
                const long long* __restrict__ lens,
                unsigned int* __restrict__ words, long long capacity) {
  const unsigned int b = blockIdx.x;
  const int width = (int)plan[kPBits * B + b];
  if (width == 0) return;
  const long long len = lens[b];
  const long long nw = ((long long)width * len + 31) / 32;
  const long long offset = plan[kPOffsets * B + b];
  if (offset + nw > capacity) return;
  const long long* xb = x + (long long)b * n;
  const uint64_t mn = (uint64_t)plan[kPMins * B + b];
  const uint64_t mask = minnow::low_mask(width);
  unsigned int* out = words + offset;

  auto value = [&](long long i) -> uint64_t {
    return ((uint64_t)xb[i] - mn) & mask;
  };

  const long long stride = (long long)gridDim.y * blockDim.x;
  for (long long w = (long long)blockIdx.y * blockDim.x + threadIdx.x;
       w < nw; w += stride) {
    out[w] = minnow::gather_word(w, width, len, value);
  }
}

}  // namespace

// x (B, n) int64; lens (B,) int64 <= n; stats (B, 2) int64: each block's
// minimum and maximum over its first lens[b] elements, (0, 0) for an
// empty block.  Each CTA takes `run` elements of one block.
extern "C" int minnow_int_stats(const void* x, long long B, long long n,
                                int run, const void* lens, void* stats,
                                void* stream) {
  const long long runs_per_row = (n + run - 1) / run;
  if (B <= 0 || run <= 0 || B * runs_per_row > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  int_stats_init_kernel<<<(unsigned int)((B + kThreads - 1) / kThreads),
                          kThreads, 0, (cudaStream_t)stream>>>(
      (long long*)stats, (const long long*)lens, B);
  if (runs_per_row > 0)
    int_stats_kernel<<<(unsigned int)(B * runs_per_row), kThreads, 0,
                       (cudaStream_t)stream>>>(
        (const long long*)x, n, run, (unsigned int)runs_per_row,
        (const long long*)lens, (long long*)stats);
  return (int)cudaGetLastError();
}

// stats (B, 2) int64 from minnow_int_stats; plan: 6 B + 2 int64 as
// plan.cuh lays it out (valid 1 and m 0 for every block).
extern "C" int minnow_int_plan(const void* stats, const void* lens,
                               long long B, void* plan, void* stream) {
  int_plan_kernel<<<1, kPlanThreads, 0, (cudaStream_t)stream>>>(
      (const long long*)stats, (const long long*)lens, B, (long long*)plan);
  return (int)cudaGetLastError();
}

// x (B, n) int64; plan as minnow_int_plan writes it, widths in [0, 64]
// (0: nothing to write); lens (B,) int64; words: room for `capacity`
// uint32.  Each thread takes about `per_thread` words of a block whose
// stream is as long as it can be, 2 n words; a grid of few blocks gets
// more CTAs a block, up to kPackCtasPerSm CTAs an SM in all.
extern "C" int minnow_pack_int(const void* x, long long B, long long n,
                               const void* plan, const void* lens,
                               void* words, long long capacity,
                               int per_thread, void* stream) {
  if (B <= 0 || B > 0x7fffffffLL || n <= 0 || per_thread <= 0)
    return (int)cudaErrorInvalidValue;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return (int)err;
  const long long per_cta = (long long)kThreads * per_thread;
  const long long most = (2 * n + per_cta - 1) / per_cta;
  const long long fill = ((long long)kPackCtasPerSm * sms + B - 1) / B;
  long long grid_y = most < fill ? most : fill;
  if (grid_y < 1) grid_y = 1;
  if (grid_y > 65535) grid_y = 65535;
  const dim3 grid((unsigned int)B, (unsigned int)grid_y);
  pack_int_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const long long*)x, n, (const long long*)plan, B,
      (const long long*)lens, (unsigned int*)words, capacity);
  return (int)cudaGetLastError();
}

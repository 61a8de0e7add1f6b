// K1: fused float-block encode for Hopper (sm_90a), and K5, the pack from
// a precomputed q.
//
// K1 replaces minnow_tpu/ops/pallas_encode.py:1045 encode_float_pallas_group
// (kernel _encode_kernel_group :493 / _encode_group_block :514), and with
// it the two other TPU float encodes of the reference's write path
// (parallel/pipeline.py:364-379): the big-block pack with a known m and
// minimum, pack_float_pallas_group :714, is this file's pack launch, and
// the per-tile encode encode_float_pallas :388 is all three launches.
// Those TPU variants exist only for B1's tile alignment and block-length
// cap, which these kernels do not have.  What it computes, per block b of
// a (B, n) float32 batch and its first lens[b] elements
// (spec.encode_float_block, minnow_tpu/core/spec.py:303):
//
//   q = floor(f32(f32(x - low) / dx))                      (spec.quantize)
//   periodic blocks: recentre q into [m, m + pixels) by the one-pass
//     window offset m (spec.periodic_min_fast)
//   min-subtract, and pack the deltas at the block's true width.
//
// Three launches, and nothing for the host between them.
//
// minnow_encode_float_stats reduces each block to (q0, ymin, ymax, qmin,
// qmax, valid): a CTA takes one run of a block's elements, reduces in its
// warps and in shared memory, and adds one set of atomic min/max to the
// block's int32 slots.
//
// minnow_encode_float_plan (one CTA) turns the stats rows into each
// block's recentring offset m, minimum and width exactly as
// pallas_encode.py:591-617 does (the width is 64 - clz of the largest
// delta), and lays the blocks' streams out back to back with an exclusive
// prefix sum of their word counts.  The plan stays in device memory; the
// host reads it once, after the pack is queued.
//
// minnow_encode_float_pack packs by aligned tiles.  32 elements at width w
// fill exactly w words, so a tile of kTile = 4096 elements that starts at
// a multiple of 32 is 128 w whole words at a word offset that is a
// product.  A persistent CTA walks over tiles: the next tile of x comes
// into shared memory by cp.async (16-byte copies where the rows are
// aligned, 4-byte ones otherwise) while this one is packed.  Each thread
// takes one group of 32 elements: it quantizes, recentres and
// min-subtracts them once, in registers, packs them into the group's w
// words with shifts that are constants (the width selects one of 32
// instantiations), and stores the words over the group's own place in the
// tile.  Then the CTA writes the tile's words out in whole coalesced
// lines.  Indices are 32-bit and the one division by the width is a
// multiply; only the block's base pointers are 64-bit.  A block's last,
// ragged tile takes the same path with its element count as the guard.
//
// K5, minnow_encode_float_pack_q, replaces pallas_encode.py:809
// pack_q_pallas_group (kernel _pack_q_kernel_group :771), the second
// dispatch of encode_float_pallas_bigblock(reuse_q=True) :855.  The stats
// launch, given a q buffer, also stores each element's int32 pixel (the
// TPU's float_block_stats32(return_q=True), ops/codec.py:252); K5 is the
// same tile pack with those pixels loaded in place of x, so its words
// equal K1's, without a second quantize.
//
// What bounds them on the H100: by the bytes they must move (x read once,
// the words written once), device memory; as they run, instruction throughput
// and the latency of the IEEE division as much as memory.  K1 reads x
// twice (8 bytes per element) and writes bits/8 bytes, with one division
// per element in each pass; the reuse_q pair reads x once, writes and
// reads q (8 bytes) and divides once.  On an NVIDIA H100 80GB HBM3 at
// 700 W, at 4096 x 2^17 and 18 bits, the stats launch takes 1.2 ms, the
// pack 1.9 and K5 1.5, where one read of x is 0.64 ms and a pack's bytes
// 1.0 ms (PERF.md).  The TPU kernel kept q in VMEM between its passes; a
// 2^17-element block is 512 KB, more than a CTA's shared memory, so here
// the second pass goes back to device memory.  Running the launches block
// by block over chunks that fit the L2 measured slower, not faster
// (tools/ab_launch.py).
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
// The pixel counts are 64-bit, anything in [1, 2^63): a block is judged
// by the pixels its data holds, never by its count.  The pixels and the
// stats stay ints; only the circle's arithmetic widens, for the blocks
// whose count does not fit an int (periodic_distance), and the plan and
// the recentring in the pack were 64-bit all along.

#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <type_traits>

#include "bitstream.cuh"
#include "plan.cuh"

namespace {

using namespace minnow;  // kThreads; the plan's rows and layout

enum { kQ0, kYMin, kYMax, kQMin, kQMax, kValid, kNStats };

constexpr int kWarps = kThreads / 32;
// the float packs: one thread per group of 32 elements, so a tile of
// kTile elements that starts at a multiple of 32 is whole words at any
// width (32 elements at width w are exactly w words)
constexpr int kPackThreads = 128;
constexpr int kTile = kPackThreads * 32;

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

// spec.periodic_distance (minnow_tpu/core/spec.py:130) for pixels x and x0
// in [0, p) that fit an int.  P is the type the count p is held in: int
// where p < 2^31, and then every intermediate fits an int; long long for
// the counts from 2^31 up to 2^63.  The result fits an int for every p:
// it is d = x - x0, or one step of p from d, and then p < 2^32 and the
// step leaves at most p / 2.  Written with selects so that a thread's
// elements run without branches, and in unsigned arithmetic, so that for
// an x outside [0, p), where the result means nothing, the sums wrap.
template <class P>
__device__ __forceinline__ int periodic_distance(int x, int x0, P p) {
  using U = std::make_unsigned_t<P>;
  const P d = (P)((U)x - (U)x0);
  const P up = d > (P)((U)p - (U)d) ? (P)((U)d - (U)p) : d;
  const P down = d < (P)((U)0 - ((U)d + (U)p)) ? (P)((U)p + (U)d) : d;
  return (int)(d >= 0 ? up : down);
}

// Whether the pixel q lies in [0, p).
__device__ __forceinline__ bool on_circle(int q, int p) {
  return (unsigned int)q < (unsigned int)p;
}
__device__ __forceinline__ bool on_circle(int q, long long p) {
  return q >= 0 && q < p;
}

__global__ void stats_init_kernel(int* __restrict__ stats, long long B) {
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  int* s = stats + b * kNStats;
  s[kQ0] = 0;
  s[kYMin] = INT_MAX;
  s[kYMax] = INT_MIN;
  s[kQMin] = INT_MAX;
  s[kQMax] = INT_MIN;
  s[kValid] = 1;
}

// CTA id -> block b = id / runs_per_row and the run id % runs_per_row of
// `run` elements of that block.
__global__ void __launch_bounds__(kThreads)
stats_kernel(const float* __restrict__ x, long long n, int run,
             unsigned int runs_per_row, const float* __restrict__ low,
             const float* __restrict__ dx,
             const long long* __restrict__ pixels,
             const unsigned char* __restrict__ periodic,
             const long long* __restrict__ lens, int* __restrict__ stats,
             int* __restrict__ q) {
  const unsigned int b = blockIdx.x / runs_per_row;
  const unsigned int t = blockIdx.x - b * runs_per_row;
  const long long len = lens[b];
  const long long start = (long long)t * run;
  if (start >= len) return;
  const int cnt = (int)min((long long)run, len - start);
  const float* xb = x + (long long)b * n;
  const float* xt = xb + start;
  int* qt = q ? q + (long long)b * n + start : nullptr;
  const float lo = low[b], d = dx[b];
  const long long pixels_b = pixels[b];
  const bool per = periodic[b] != 0;

  const Pixel first = quantize(xb[0], lo, d);
  const bool first_in = first.ok && first.q >= 0 && first.q < pixels_b;

  int ymin = INT_MAX, ymax = INT_MIN, qmin = INT_MAX, qmax = INT_MIN;
  unsigned int valid = 1;
  // The run's elements, with the block's count p held as an int where it
  // fits and as a long long where it does not: the choice is made once a
  // CTA, and the blocks below 2^31 pixels pay nothing for the others.
  auto reduce = [&](auto p) {
    // an uncertified pixel clears valid and counts in no minimum or
    // maximum; so does, in a periodic block, a pixel outside [0, p)
    auto take = [&](float xi, int i) {
      const Pixel r = quantize(xi, lo, d);
      if (qt) qt[i] = r.q;
      const bool in = r.ok && (!per || on_circle(r.q, p));
      valid &= in;
      qmin = min(qmin, r.ok ? r.q : INT_MAX);
      qmax = max(qmax, r.ok ? r.q : INT_MIN);
      if (per && first_in) {
        const int y = periodic_distance(r.q, first.q, p);
        ymin = min(ymin, in ? y : INT_MAX);
        ymax = max(ymax, in ? y : INT_MIN);
      }
    };
    // four loads in flight before the first division
    int i = threadIdx.x;
    for (; i + 3 * kThreads < cnt; i += 4 * kThreads) {
      const float x0 = xt[i], x1 = xt[i + kThreads];
      const float x2 = xt[i + 2 * kThreads], x3 = xt[i + 3 * kThreads];
      take(x0, i);
      take(x1, i + kThreads);
      take(x2, i + 2 * kThreads);
      take(x3, i + 3 * kThreads);
    }
    for (; i < cnt; i += kThreads) take(xt[i], i);
  };
  if (pixels_b <= INT_MAX)
    reduce((int)pixels_b);
  else
    reduce(pixels_b);
  const unsigned int all = 0xffffffffu;
  ymin = __reduce_min_sync(all, ymin);
  ymax = __reduce_max_sync(all, ymax);
  qmin = __reduce_min_sync(all, qmin);
  qmax = __reduce_max_sync(all, qmax);
  valid = __reduce_and_sync(all, valid);

  __shared__ int red[kWarps][5];
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    red[warp][0] = ymin;
    red[warp][1] = ymax;
    red[warp][2] = qmin;
    red[warp][3] = qmax;
    red[warp][4] = (int)valid;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  for (int w = 1; w < kWarps; ++w) {
    ymin = min(ymin, red[w][0]);
    ymax = max(ymax, red[w][1]);
    qmin = min(qmin, red[w][2]);
    qmax = max(qmax, red[w][3]);
    valid &= (unsigned int)red[w][4];
  }
  int* s = stats + (long long)b * kNStats;
  if (ymin != INT_MAX) atomicMin(s + kYMin, ymin);
  if (ymax != INT_MIN) atomicMax(s + kYMax, ymax);
  if (qmin != INT_MAX) atomicMin(s + kQMin, qmin);
  if (qmax != INT_MIN) atomicMax(s + kQMax, qmax);
  if (!valid) atomicAnd(s + kValid, 0);
  if (t == 0 && first.ok) s[kQ0] = first.q;
}

// One CTA of kPlanThreads threads: codec.finish_float_stats and the width,
// word count and word offset of every block.  All of it is 64-bit: the
// count alone can pass an int, and so does the sum q0 + ymin + pixels on
// the way to the offset m (itself the pixel the window starts at).
__global__ void __launch_bounds__(kPlanThreads)
plan_kernel(const int* __restrict__ stats,
            const long long* __restrict__ pixels,
            const unsigned char* __restrict__ periodic,
            const long long* __restrict__ lens, long long B,
            long long* __restrict__ plan) {
  lay_out_plan(B, plan, [&](long long b) {
    const int* s = stats + b * kNStats;
    const long long p = pixels[b];
    const bool per = periodic[b] != 0;
    const long long len = lens[b];
    const bool empty = len == 0;
    const long long w = (long long)s[kYMax] - s[kYMin] + 1;
    const bool small = w <= (p >> 1);
    long long m = (long long)s[kQ0] + s[kYMin];
    if (m < 0) m += p;
    if (!small) m = 0;
    const bool shifted = per && small;
    long long mn = shifted ? m : (long long)s[kQMin];
    const long long mx = shifted ? m + w - 1 : (long long)s[kQMax];
    const bool valid = s[kValid] != 0 || empty;
    if (!per || empty) m = 0;
    long long maxd = mx - mn;
    if (empty || !valid) mn = maxd = 0;
    const long long bits = 64 - __clzll(maxd);
    plan[kPMins * B + b] = mn;
    plan[kPMaxd * B + b] = maxd;
    plan[kPBits * B + b] = bits;
    plan[kPValid * B + b] = valid;
    plan[kPM * B + b] = m;
    return (bits * len + 31) >> 5;
  });
}

// The pixel of a raw 32-bit element of the source: K1 quantizes a float
// of x, K5 takes the int32 pixel the stats launch stored.
struct FromX {
  float lo, d;
  __device__ __forceinline__ int operator()(uint32_t raw) const {
    return quantize(__uint_as_float(raw), lo, d).q;
  }
};
struct FromQ {
  __device__ __forceinline__ int operator()(uint32_t raw) const {
    return (int)raw;
  }
};
__device__ __forceinline__ FromX source_of(const float*, float lo, float d) {
  return FromX{lo, d};
}
__device__ __forceinline__ FromQ source_of(const int*, float, float) {
  return FromQ{};
}

// One tile of the pack: block b, elements [start, start + cnt).
struct Tile {
  unsigned int b;
  long long start;
  int cnt;    // 0: nothing to pack (past the block's end, or width 0)
  int width;
};

// Where element k (or, once packed, word k) of group g of 32 lies in a
// tile's shared buffer: the group's eight 16-byte chunks are rotated by
// g, so that the threads of a quarter warp, one group each, reach eight
// different chunk columns with their 16-byte loads and stores.
__device__ __forceinline__ int chunk_at(int g, int j) {
  return (g << 5) + (((j + g) & 7) << 2);
}
__device__ __forceinline__ int slot_at(int g, int k) {
  return chunk_at(g, k >> 2) + (k & 3);
}

// The W words of 32 deltas v at width W, stored over the group's own
// chunks.  W is a template argument so that every index and shift is a
// constant: element i lies at bits [i W, i W + W) of the group's stream.
template <int W>
__device__ __forceinline__ void pack_group(const uint32_t (&v)[32],
                                           uint32_t* __restrict__ buf,
                                           int g) {
  uint32_t w[32] = {};
#pragma unroll
  for (int k = 0; k < W; ++k) {
    uint32_t word = 0;
#pragma unroll
    for (int i = 32 * k / W; i <= (32 * k + 31) / W; ++i) {
      const int off = i * W - 32 * k;  // in (-32, 32)
      word |= off >= 0 ? v[i] << off : v[i] >> -off;
    }
    w[k] = word;
  }
#pragma unroll
  for (int j = 0; j < (W + 3) / 4; ++j)
    *reinterpret_cast<uint4*>(buf + chunk_at(g, j)) =
        make_uint4(w[4 * j], w[4 * j + 1], w[4 * j + 2], w[4 * j + 3]);
}

// The tile pack shared by K1 (T = float: x) and K5 (T = int: the stored
// pixels): recentring (spec.bound(q, m, pixels) for periodic blocks),
// minimum, mask and layout are one body for both.  One thread per group
// of 32 elements.
template <class T>
__global__ void __launch_bounds__(kPackThreads)
pack_tiles_kernel(const T* __restrict__ src, long long n,
                  unsigned int tiles_per_row, unsigned int n_tiles,
                  const float* __restrict__ low, const float* __restrict__ dx,
                  const long long* __restrict__ pixels,
                  const unsigned char* __restrict__ periodic,
                  const long long* __restrict__ plan, long long B,
                  const long long* __restrict__ lens,
                  unsigned int* __restrict__ words, long long capacity) {
  // a stage holds a tile of the source and then, in place, its words
  __shared__ __align__(16) uint32_t tile[2][kTile];

  const long long* bits = plan + kPBits * B;
  const long long* offsets = plan + kPOffsets * B;
  // 16-byte copies need every row of src to start on a 16-byte boundary
  const bool vec = ((uintptr_t)src & 15) == 0 && (n & 3) == 0;

  auto tile_of = [&](unsigned int id) {
    Tile t;
    t.b = id / tiles_per_row;
    t.start = (long long)(id - t.b * tiles_per_row) * kTile;
    t.width = (int)bits[t.b];
    const long long len = lens[t.b];
    t.cnt = t.width == 0 || t.start >= len
                ? 0
                : (int)min((long long)kTile, len - t.start);
    // a block whose stream would pass the end of `words` is not packed:
    // the caller finds the plan's total above the capacity and raises
    if (t.cnt &&
        offsets[t.b] + (((long long)t.width * len + 31) >> 5) > capacity)
      t.cnt = 0;
    return t;
  };

  auto load = [&](const Tile& t, uint32_t* buf) {
    const T* g = src + (long long)t.b * n + t.start;
    if (vec) {
      for (int c = threadIdx.x; 4 * c < t.cnt; c += kPackThreads) {
        const int live = min(4, t.cnt - 4 * c);
        __pipeline_memcpy_async(buf + chunk_at(c >> 3, c & 7), g + 4 * c, 16,
                                16 - 4 * live);
      }
    } else {
      for (int i = threadIdx.x; i < t.cnt; i += kPackThreads)
        __pipeline_memcpy_async(buf + slot_at(i >> 5, i & 31), g + i, 4);
    }
  };

  unsigned int id = blockIdx.x;
  int stage = 0;
  Tile cur = tile_of(id);
  load(cur, tile[stage]);
  __pipeline_commit();
  for (; id < n_tiles; id += gridDim.x, stage ^= 1) {
    // the next tile loads while this one packs
    const unsigned int next_id = id + gridDim.x;
    Tile next = cur;
    if (next_id < n_tiles) {
      next = tile_of(next_id);
      load(next, tile[stage ^ 1]);
    }
    __pipeline_commit();
    __pipeline_wait_prior(1);
    __syncthreads();

    if (cur.cnt) {
      uint32_t* buf = tile[stage];
      const unsigned int b = cur.b;
      const int width = cur.width;
      const int g = threadIdx.x, first = g << 5;
      if (first < cur.cnt) {
        const auto pixel = source_of(src, low[b], dx[b]);
        const long long p = pixels[b];
        const bool per = periodic[b] != 0;
        const long long mb = plan[kPM * B + b], minb = plan[kPMins * B + b];
        // the window's end, mb + p, held at the largest long long where the
        // sum would pass it (no pixel reaches that): once a block, so that
        // an element pays one compare as it does below 2^31 pixels
        const long long top = mb > LLONG_MAX - p ? LLONG_MAX : mb + p;
        const uint32_t mask = width >= 32 ? ~0u : (1u << width) - 1u;
        uint32_t v[32];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const uint4 c = *reinterpret_cast<const uint4*>(buf + chunk_at(g, j));
          v[4 * j] = c.x;
          v[4 * j + 1] = c.y;
          v[4 * j + 2] = c.z;
          v[4 * j + 3] = c.w;
        }
#pragma unroll
        for (int k = 0; k < 32; ++k) {
          long long q = pixel(v[k]);
          if (per) {
            if (q < mb) q += p;
            if (q >= top) q -= p;
          }
          // past the block's end a ragged group packs zeros
          v[k] = first + k < cur.cnt ? (uint32_t)(q - minb) & mask : 0u;
        }
        switch (width) {
#define MINNOW_PACK_CASE(W) \
  case W:                   \
    pack_group<W>(v, buf, g); \
    break;
          MINNOW_PACK_CASE(1) MINNOW_PACK_CASE(2) MINNOW_PACK_CASE(3)
          MINNOW_PACK_CASE(4) MINNOW_PACK_CASE(5) MINNOW_PACK_CASE(6)
          MINNOW_PACK_CASE(7) MINNOW_PACK_CASE(8) MINNOW_PACK_CASE(9)
          MINNOW_PACK_CASE(10) MINNOW_PACK_CASE(11) MINNOW_PACK_CASE(12)
          MINNOW_PACK_CASE(13) MINNOW_PACK_CASE(14) MINNOW_PACK_CASE(15)
          MINNOW_PACK_CASE(16) MINNOW_PACK_CASE(17) MINNOW_PACK_CASE(18)
          MINNOW_PACK_CASE(19) MINNOW_PACK_CASE(20) MINNOW_PACK_CASE(21)
          MINNOW_PACK_CASE(22) MINNOW_PACK_CASE(23) MINNOW_PACK_CASE(24)
          MINNOW_PACK_CASE(25) MINNOW_PACK_CASE(26) MINNOW_PACK_CASE(27)
          MINNOW_PACK_CASE(28) MINNOW_PACK_CASE(29) MINNOW_PACK_CASE(30)
          MINNOW_PACK_CASE(31) MINNOW_PACK_CASE(32)
#undef MINNOW_PACK_CASE
        }
      }
      __syncthreads();

      // the tile's words leave in whole coalesced lines: word o of the
      // tile is word o % width of group o / width
      const uint32_t magic = minnow::div_magic(width);
      const int nw = (width * cur.cnt + 31) >> 5;
      unsigned int* out = words + offsets[b] + (cur.start >> 5) * width;
      for (int o = threadIdx.x; o < nw; o += kPackThreads) {
        const int og = minnow::div_by(o, magic);
        out[o] = buf[slot_at(og, o - og * width)];
      }
    }
    // tile[stage] is free for the tile after the next
    __syncthreads();
    cur = next;
  }
}

// The grid of the persistent pack: as many CTAs as the card holds at once
// (by the kernel's registers and shared memory), or one for each tile
// where there are fewer tiles.
template <class T>
int launch_pack(const void* src, long long B, long long n, const void* low,
                const void* dx, const void* pixels, const void* periodic,
                const void* plan, const void* lens, void* words,
                long long capacity, void* stream) {
  const long long tiles_per_row = (n + kTile - 1) / kTile;
  const long long n_tiles = B * tiles_per_row;
  if (n_tiles <= 0 || n_tiles > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, pack_tiles_kernel<T>, kPackThreads, 0);
  if (err != cudaSuccess) return (int)err;
  const long long ctas = (long long)sms * per_sm;
  if (ctas <= 0) return (int)cudaErrorInvalidValue;
  const unsigned int grid = (unsigned int)(ctas < n_tiles ? ctas : n_tiles);
  pack_tiles_kernel<T><<<grid, kPackThreads, 0, (cudaStream_t)stream>>>(
      (const T*)src, n, (unsigned int)tiles_per_row, (unsigned int)n_tiles,
      (const float*)low, (const float*)dx, (const long long*)pixels,
      (const unsigned char*)periodic, (const long long*)plan, B,
      (const long long*)lens, (unsigned int*)words, capacity);
  return (int)cudaGetLastError();
}

}  // namespace

// x (B, n) float32; low, dx (B,) float32; pixels (B,) int64; periodic (B,)
// bool; lens (B,) int64 <= n; stats (B, 6) int32, set here to (0, INT_MAX,
// INT_MIN, INT_MAX, INT_MIN, 1) before the reduction; q (B, n) int32 or
// null: when given, element i < lens[b] of row b gets its pixel (0 where
// it is not certified), and the rest of the row is left as it was.  Each
// CTA takes `run` elements of one block (a multiple of the CTA's threads).
extern "C" int minnow_encode_float_stats(
    const void* x, long long B, long long n, int run, const void* low,
    const void* dx, const void* pixels, const void* periodic,
    const void* lens, void* stats, void* q, void* stream) {
  const long long runs_per_row = (n + run - 1) / run;
  if (B <= 0 || run <= 0 || B * runs_per_row > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  stats_init_kernel<<<(unsigned int)((B + kThreads - 1) / kThreads), kThreads,
                      0, (cudaStream_t)stream>>>((int*)stats, B);
  if (runs_per_row > 0)
    stats_kernel<<<(unsigned int)(B * runs_per_row), kThreads, 0,
                   (cudaStream_t)stream>>>(
        (const float*)x, n, run, (unsigned int)runs_per_row,
        (const float*)low, (const float*)dx, (const long long*)pixels,
        (const unsigned char*)periodic, (const long long*)lens, (int*)stats,
        (int*)q);
  return (int)cudaGetLastError();
}

// stats (B, 6) int32 from minnow_encode_float_stats; plan: 6 B + 2 int64,
// the rows mins, maxd, bits, valid, m, offsets (each B long), then the
// total number of words and the words of the longest block stream.
extern "C" int minnow_encode_float_plan(const void* stats, const void* pixels,
                                        const void* periodic,
                                        const void* lens, long long B,
                                        void* plan, void* stream) {
  plan_kernel<<<1, kPlanThreads, 0, (cudaStream_t)stream>>>(
      (const int*)stats, (const long long*)pixels,
      (const unsigned char*)periodic,
      (const long long*)lens, B, (long long*)plan);
  return (int)cudaGetLastError();
}

// plan as minnow_encode_float_plan writes it, widths in [0, 32] (0:
// nothing to write); words: room for `capacity` uint32.
extern "C" int minnow_encode_float_pack(
    const void* x, long long B, long long n, const void* low,
    const void* dx, const void* pixels, const void* periodic,
    const void* plan, const void* lens, void* words, long long capacity,
    void* stream) {
  return launch_pack<float>(x, B, n, low, dx, pixels, periodic, plan, lens,
                            words, capacity, stream);
}

// K5: q (B, n) int32 from the stats launch; the other arguments as for
// minnow_encode_float_pack (low and dx have no effect).
extern "C" int minnow_encode_float_pack_q(
    const void* q, long long B, long long n, const void* low,
    const void* dx, const void* pixels, const void* periodic,
    const void* plan, const void* lens, void* words, long long capacity,
    void* stream) {
  return launch_pack<int>(q, B, n, low, dx, pixels, periodic, plan, lens,
                          words, capacity, stream);
}

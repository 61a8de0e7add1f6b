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
// the same every run.  Alone it runs as fast as torch.aminmax over the
// same rows; 16-byte loads, more loads in flight and a persistent grid
// that flushes once a block were measured no faster (PERF.md, Findings).
//
// minnow_int_plan (one CTA) turns them into each block's minimum, largest
// delta and width, 64 - clz of the delta in unsigned arithmetic (0 for a
// constant block), and lays the blocks' streams out back to back in the
// device plan K1 writes too (plan.cuh).  The host reads the plan once,
// after the pack is queued.
//
// minnow_pack_int packs by aligned tiles, as K1's pack does.  32 elements
// at width w fill exactly w words, so a tile of kTile elements (4,096)
// that starts at a multiple of 32 is kTile w / 32 whole words at the word
// offset plan.offsets[b] + (start / 32) w.  The grid is fixed before the
// plan exists: a persistent CTA for each one the card holds walks over
// all B * ceil(n / kTile) tiles and skips those past a block's length or
// at width 0.  The next tile of x comes into shared memory by cp.async
// (16 bytes a copy where the rows are 16-byte aligned, 8 otherwise) while
// this one is packed.  Each thread takes one group of 32 elements: it
// subtracts the block's minimum from them in registers, packs them into
// the group's w words with shifts that are constants (the width selects
// one of 64 instantiations), and stores the words over the group's own 64
// input slots.  Then the CTA writes the tile's words out in whole
// coalesced lines.  No division is left in the loop: the one map from a
// tile's word to its group divides by the width with a multiply
// (bitstream.cuh div_by).  A block's last, ragged tile takes the same path
// with its element count as the guard and packs zeros past it.  Two
// stages of a 4,096-element tile are 64 KB of int64, above the 48 KB a
// CTA gets statically, so the buffer is dynamic: the first launch on a
// device raises the kernel's limit
// (cudaFuncAttributeMaxDynamicSharedMemorySize) and sizes the grid, and
// later ones reuse that grid.
//
// What bounds them on the H100: device memory, by the bytes they must
// move.  The stats launch reads x once (8 bytes an element); the pack
// reads it again and writes bits/8 bytes an element.

#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "bitstream.cuh"
#include "plan.cuh"

namespace {

using namespace minnow;  // kThreads; the plan's rows and layout

constexpr int kWarps = kThreads / 32;
// the pack: tiles of kTile elements, one thread per group of 32, two
// stages of int64 in dynamic shared memory (2,048 elements a tile took
// as long, 8,192 longer: PERF.md, Findings)
constexpr int kTile = 4096;
constexpr int kPackThreads = kTile / 32;
constexpr int kPackSmem = 2 * kTile * (int)sizeof(long long);
// the CTAs an SM holds by shared memory (228 KB an SM on the H100, 1 KB of
// it for each CTA): 3 at kTile 4,096, which leaves a thread up to 168
// registers; launch bounds without it held the pack to 128 and spilled
constexpr int kPackCtasPerSm = 228 * 1024 / (kPackSmem + 1024);

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

// One tile of the pack: block b, elements [start, start + cnt).
struct Tile {
  unsigned int b;
  long long start;
  int cnt;    // 0: nothing to pack (past the block's end, or width 0)
  int width;
};

// Where 16-byte chunk j (0..15) of group g of 32 int64 lies in a tile's
// shared buffer, in uint32 slots: the group's 256 bytes, rotated by g
// chunks, so that the threads of a quarter warp, one group each, reach
// eight different bank quads with their 16-byte loads and stores.  (K1's
// groups are 32 uint32, eight chunks: encode_float.cu keeps its own.)
__device__ __forceinline__ int chunk_at(int g, int j) {
  return (g << 6) + (((j + g) & 15) << 2);
}
// uint32 slot k (0..63) of group g: half k & 1 of element k / 2 before
// the pack, word k after it
__device__ __forceinline__ int slot_at(int g, int k) {
  return chunk_at(g, k >> 2) + (k & 3);
}

// Group g of a tile: its first `live` int64 (up to 32; zeros past them)
// less the minimum mn, wrapping, masked to W bits and packed into W
// words, stored over the group's own slots.  W is a template argument so
// that every index, shift and mask is a constant: element i lies at bits
// [i W, i W + W) of the group's stream.  All 32 values are in registers
// before the first word is stored.
template <int W>
__device__ __forceinline__ void pack_group(uint32_t* __restrict__ buf, int g,
                                           int live, uint64_t mn) {
  constexpr uint64_t mask = W >= 64 ? ~0ull : (1ull << (W & 63)) - 1ull;
  uint64_t v[32];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const ulonglong2 c =
        *reinterpret_cast<const ulonglong2*>(buf + chunk_at(g, j));
    v[2 * j] = c.x;
    v[2 * j + 1] = c.y;
  }
#pragma unroll
  for (int k = 0; k < 32; ++k) v[k] = k < live ? (v[k] - mn) & mask : 0ull;
  uint32_t w[64] = {};
#pragma unroll
  for (int k = 0; k < W; ++k) {  // word k: stream bits [32 k, 32 k + 32)
    uint32_t word = 0;
#pragma unroll
    for (int i = 32 * k / W; i <= (32 * k + 31) / W; ++i) {
      const int off = i * W - 32 * k;  // in (-64, 32)
      word |= off >= 0 ? (uint32_t)(v[i] << off) : (uint32_t)(v[i] >> -off);
    }
    w[k] = word;
  }
#pragma unroll
  for (int j = 0; j < (W + 3) / 4; ++j)
    *reinterpret_cast<uint4*>(buf + chunk_at(g, j)) =
        make_uint4(w[4 * j], w[4 * j + 1], w[4 * j + 2], w[4 * j + 3]);
}

// The tile pack of K3, one thread per group of 32 elements (blockDim.x =
// kPackThreads); `smem` holds two stages of kTile int64, each the tile's
// elements and then, in place, its words.
__global__ void __launch_bounds__(kPackThreads, kPackCtasPerSm)
pack_int_kernel(const long long* __restrict__ x, long long n,
                unsigned int tiles_per_row, unsigned int n_tiles,
                const long long* __restrict__ plan, long long B,
                const long long* __restrict__ lens,
                unsigned int* __restrict__ words, long long capacity) {
  extern __shared__ __align__(16) uint32_t smem[];

  const long long* bits = plan + kPBits * B;
  const long long* offsets = plan + kPOffsets * B;
  // 16-byte copies need every row of x to start on a 16-byte boundary
  const bool vec = ((uintptr_t)x & 15) == 0 && (n & 1) == 0;

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
    const long long* src = x + (long long)t.b * n + t.start;
    if (vec) {
      for (int c = threadIdx.x; 2 * c < t.cnt; c += kPackThreads) {
        const int live = min(2, t.cnt - 2 * c);
        __pipeline_memcpy_async(buf + chunk_at(c >> 4, c & 15), src + 2 * c,
                                16, 16 - 8 * live);
      }
    } else {
      for (int i = threadIdx.x; i < t.cnt; i += kPackThreads)
        __pipeline_memcpy_async(buf + slot_at(i >> 5, 2 * (i & 31)), src + i,
                                8);
    }
  };

  unsigned int id = blockIdx.x;
  int stage = 0;
  Tile cur = tile_of(id);
  load(cur, smem);
  __pipeline_commit();
  for (; id < n_tiles; id += gridDim.x, stage ^= 1) {
    // the next tile loads while this one packs
    const unsigned int next_id = id + gridDim.x;
    Tile next = cur;
    if (next_id < n_tiles) {
      next = tile_of(next_id);
      load(next, smem + (stage ^ 1) * 2 * kTile);
    }
    __pipeline_commit();
    __pipeline_wait_prior(1);
    __syncthreads();

    if (cur.cnt) {
      uint32_t* buf = smem + stage * 2 * kTile;
      const unsigned int b = cur.b;
      const int width = cur.width;
      const int g = threadIdx.x, first = g << 5;
      if (first < cur.cnt) {
        const uint64_t mn = (uint64_t)plan[kPMins * B + b];
        const int live = min(32, cur.cnt - first);
        switch (width) {
#define MINNOW_PACK_CASE(W)               \
  case W:                                 \
    pack_group<W>(buf, g, live, mn);      \
    break;
#define MINNOW_PACK_CASE8(W)                                            \
  MINNOW_PACK_CASE(W) MINNOW_PACK_CASE(W + 1) MINNOW_PACK_CASE(W + 2)   \
  MINNOW_PACK_CASE(W + 3) MINNOW_PACK_CASE(W + 4)                       \
  MINNOW_PACK_CASE(W + 5) MINNOW_PACK_CASE(W + 6) MINNOW_PACK_CASE(W + 7)
          MINNOW_PACK_CASE8(1) MINNOW_PACK_CASE8(9) MINNOW_PACK_CASE8(17)
          MINNOW_PACK_CASE8(25) MINNOW_PACK_CASE8(33) MINNOW_PACK_CASE8(41)
          MINNOW_PACK_CASE8(49) MINNOW_PACK_CASE8(57)
#undef MINNOW_PACK_CASE8
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
    // this stage is free for the tile after the next
    __syncthreads();
    cur = next;
  }
}

// The pack's grid on the current device: as many CTAs as the card holds
// at once, found once a device (the first launch there also raises the
// kernel's dynamic shared memory limit, before any graph capture).
// Threads that race on a first launch store the same number.
constexpr int kMaxDevices = 64;
int pack_ctas[kMaxDevices];

cudaError_t pack_grid(long long* ctas) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  int cached = __atomic_load_n(&pack_ctas[device], __ATOMIC_ACQUIRE);
  if (cached == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(pack_int_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kPackSmem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, pack_int_kernel, kPackThreads, kPackSmem);
    if (err != cudaSuccess) return err;
    cached = sms * per_sm;
    if (cached <= 0) return cudaErrorInvalidValue;
    __atomic_store_n(&pack_ctas[device], cached, __ATOMIC_RELEASE);
  }
  *ctas = cached;
  return cudaSuccess;
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
// uint32.  Tiles of kTile elements, one persistent CTA of kPackThreads
// threads for each the card holds, or one a tile where there are fewer
// tiles.
extern "C" int minnow_pack_int(const void* x, long long B, long long n,
                               const void* plan, const void* lens,
                               void* words, long long capacity,
                               void* stream) {
  if (B <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  const long long tiles_per_row = (n + kTile - 1) / kTile;
  const long long n_tiles = B * tiles_per_row;
  if (n_tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  long long ctas = 0;
  const cudaError_t err = pack_grid(&ctas);
  if (err != cudaSuccess) return (int)err;
  pack_int_kernel<<<(unsigned int)(ctas < n_tiles ? ctas : n_tiles),
                    kPackThreads, kPackSmem, (cudaStream_t)stream>>>(
      (const long long*)x, n, (unsigned int)tiles_per_row,
      (unsigned int)n_tiles, (const long long*)plan, B,
      (const long long*)lens, (unsigned int*)words, capacity);
  return (int)cudaGetLastError();
}

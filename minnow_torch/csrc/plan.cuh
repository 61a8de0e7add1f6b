// The device plan of an encode, shared by the float encode (K1,
// encode_float.cu) and the int encode (K3, pack_int.cu).
//
// Six rows of B int64 -- each block's minimum, largest delta, width,
// validity, recentring offset m and the word offset of its stream -- then
// the total number of words and the words of the longest block stream
// (ops/encode.py PLAN_ROWS, read_plan).  One CTA of kPlanThreads threads
// lays the streams out back to back: the offsets are an exclusive prefix
// sum of the blocks' word counts.

#pragma once

#include <cstdint>

namespace minnow {

enum { kPMins, kPMaxd, kPBits, kPValid, kPM, kPOffsets, kNPlan };

constexpr int kPlanThreads = 1024;

// Inclusive prefix sum of v over the CTA's threads; `total` gets the sum.
// `warp_sums` is 32 values of shared scratch, free again on return.
__device__ __forceinline__ long long cta_inclusive_scan(long long v,
                                                        long long* warp_sums,
                                                        long long* total) {
  const unsigned int all = 0xffffffffu;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 1; o < 32; o <<= 1) {
    const long long up = __shfl_up_sync(all, v, o);
    if (lane >= o) v += up;
  }
  if (lane == 31) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    long long s = warp_sums[lane];
    for (int o = 1; o < 32; o <<= 1) {
      const long long up = __shfl_up_sync(all, s, o);
      if (lane >= o) s += up;
    }
    warp_sums[lane] = s;
  }
  __syncthreads();
  if (warp > 0) v += warp_sums[warp - 1];
  *total = warp_sums[31];
  __syncthreads();
  return v;
}

// The plan of B blocks, by one CTA of kPlanThreads threads: row(b) writes
// every row of block b but its offset and returns its word count; this
// writes the offsets, the total and the longest stream.
template <class Row>
__device__ __forceinline__ void lay_out_plan(long long B,
                                             long long* __restrict__ plan,
                                             Row row) {
  __shared__ long long warp_sums[32];
  long long carry = 0, longest = 0;
  for (long long base = 0; base < B; base += kPlanThreads) {
    const long long b = base + threadIdx.x;
    const long long nw = b < B ? row(b) : 0;
    longest = max(longest, nw);
    long long chunk;
    const long long incl = cta_inclusive_scan(nw, warp_sums, &chunk);
    if (b < B) plan[kPOffsets * B + b] = carry + incl - nw;
    carry += chunk;
  }
  // the longest stream: a max over the CTA through the same scratch
  for (int o = 16; o > 0; o >>= 1)
    longest = max(longest, __shfl_xor_sync(0xffffffffu, longest, o));
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = longest;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kPlanThreads / 32; ++w)
      longest = max(longest, warp_sums[w]);
    plan[kNPlan * B] = carry;
    plan[kNPlan * B + 1] = longest;
  }
}

}  // namespace minnow

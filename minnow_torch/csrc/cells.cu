// The boundary layout's cell table for Hopper (sm_90a): each halo's host
// cell and the ghost cells whose shells hold it, and the rows of every
// cell in the order the file writes them.
//
// Replaces no TPU kernel: the JAX package builds this table on the host
// in numpy (minnow_tpu/formats/boundary.py idx_reg, host_cells_table and
// a stable argsort), and so does the port's host route
// (minnow_torch/formats/boundary.py).  This is the device route of the
// same arithmetic (ref go/minh/boundary.go:111-180), for `minh_to_bnd
// --device`, whose gathers read the table where it lies.
//
// A halo at (x, y, z) has on each axis a = x, y, z
//
//   v = coord / dx (IEEE, __fdiv_rn);  i = trunc(v)
//   if i >= cells: i -= cells, v -= l     (the box length, as the host)
//   region = -1 if v < i + sb, else +1 if v >= (i + 1) - sb, else 0
//
// in float32, each sum rounded once (-fmad=false), and eight slots s (bit
// 0 the x offset, bit 1 y, bit 2 z; the host's _SLOTS order): slot s is
// used when every axis whose bit is set has a region, and its cell is
// the host cell moved by that region along those axes, wrapped into
// [0, cells).  Slot 0 is the host cell (flag 0), the others ghosts (flag
// 1).  The file writes cell by cell, within a cell by point, then slot:
// the host's stable sort of the used slots by cell.  A halo whose
// trunc(v) lies outside [0, 2 cells) on some axis (NaN included) has no
// host cell; it sets the error word and the caller raises.
//
// Three passes, no atomics and no library sort:
//
//   count  a warp takes a contiguous chunk of halos, four a turn (lane
//          8 p + s is slot s of the turn's point p, so lane order is
//          file order), groups the lanes by cell with __match_any_sync
//          and adds each group's size to its cell's bin, the warp's
//          column of a (cells^3, chunks) matrix;
//   scan   an exclusive scan of that matrix in its memory order, cell
//          major, so entry (c, k) becomes where chunk k's first row of
//          cell c goes; cell c's offset is entry (c, 0);
//   place  each warp walks its chunk again in the same turns: a row's
//          place is its bin plus the lanes of its group below it, and the
//          group's last lane moves the bin on.
//
// A warp keeps its bins in its own column of the matrix, which the count
// pass zeroes first; the chunks grow with the cells so that the matrix
// stays under kMatrix entries.  Nothing the caller reads depends on
// scheduling: each bin has one warp, and each place one lane.
//
// What bounds it on the H100: memory.  The table needs each halo's x, y,
// z read once and each row's point index (8 bytes) and flag (1) written
// once; this design reads x, y, z twice (once a pass), and the matrix
// (12 MB at 8^3 cells and 3.0 M halos) stays in the 50 MB L2.  The walk
// reads coordinates a warp's 32 halos at a time, one coalesced load
// each, with the next 32 in flight, and does a halo's division and
// comparisons once, in its own lane; its eight slots are integer work on
// the values shuffled to their lanes.  chip_smoke.py times the chain
// against its plain version at the boundary cell's shape (3.0 M halos,
// 8^3 cells, boundary 5) beside the bound of the table's own bytes.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 4;                 // warps a CTA, count and place
constexpr long long kChunk = 1024;        // halos a warp, at most kMatrix
constexpr long long kMatrix = 1ll << 22;  // matrix entries; then larger
constexpr int kScanThreads = 256;
constexpr int kScanItems = 16;
constexpr long long kScanTile = kScanThreads * kScanItems;
constexpr unsigned kFull = 0xffffffffu;

struct Box {
  float dx;     // l / cells
  float l;      // the box length, subtracted on the wrap
  float sb;     // boundary / dx
  long long cells;
};

// The cell index and region of one axis; false where trunc(v) is outside
// [0, 2 cells) (NaN too).  2 cells is a float exactly: cells^3 cells fit
// in memory only below 2^23 cells a side.
__device__ __forceinline__ bool axis(float coord, const Box& b, int* idx,
                                     int* reg) {
  float v = __fdiv_rn(coord, b.dx);
  const float t = truncf(v);
  if (!(t >= 0.0f) || !(t < (float)(2 * b.cells))) return false;
  int i = (int)t;
  if (i >= b.cells) {
    i -= (int)b.cells;
    v = __fsub_rn(v, b.l);
  }
  const float low = (float)i;
  int r = 0;
  if (v < __fadd_rn(low, b.sb)) {
    r = -1;
  } else if (v >= __fsub_rn(__fadd_rn(low, 1.0f), b.sb)) {
    r = 1;
  }
  *idx = i;
  *reg = r;
  return true;
}

// Axis index i moved by its region where `bit` is set, wrapped.
__device__ __forceinline__ long long moved(int i, int bit, int reg,
                                           long long cells) {
  long long c = i + (bit ? reg : 0);
  if (c < 0) c += cells;
  if (c >= cells) c -= cells;
  return c;
}

// One warp's walk over its chunk [p0, p1), 32 halos a step: lane p finds
// halo p's cell index and region on each axis (one load a coordinate,
// the next step's loads in flight meanwhile), then eight turns of four
// halos: lane 8 q + s takes slot s of the turn's halo q from its lane
// (__shfl_sync), so lane order is file order.  For each used slot,
// `row(cell, rank, group, j, s)` with its cell, its rank among the turn's
// lanes of that cell, the size of that group, its point j and slot s;
// then, after a __syncwarp, `last(cell, group)` on the group's last
// lane, and a __syncwarp again.  Sets *error (where given) for a halo
// with no host cell.
template <class Row, class Last>
__device__ __forceinline__ void walk(const float* __restrict__ x,
                                     const float* __restrict__ y,
                                     const float* __restrict__ z,
                                     long long p0, long long p1,
                                     const Box& b, long long* error, Row row,
                                     Last last) {
  const int lane = threadIdx.x & 31;
  const int s = lane & 7;
  const int bx = s & 1, by = (s >> 1) & 1, bz = (s >> 2) & 1;
  const unsigned below = (1u << lane) - 1u;
  float cx = 0.0f, cy = 0.0f, cz = 0.0f;
  if (p0 + lane < p1) {
    cx = x[p0 + lane];
    cy = y[p0 + lane];
    cz = z[p0 + lane];
  }
  for (long long base = p0; base < p1; base += 32) {
    const long long next = base + 32 + lane;
    float nx = 0.0f, ny = 0.0f, nz = 0.0f;
    if (next < p1) {
      nx = x[next];
      ny = y[next];
      nz = z[next];
    }
    // this lane's halo: its axes' indices and, in `info`, each region + 1
    // (two bits an axis) and bit 6 where it has a host cell
    int ix = 0, iy = 0, iz = 0, rx = 0, ry = 0, rz = 0;
    unsigned info = 0;
    if (base + lane < p1) {
      const bool ok = axis(cx, b, &ix, &rx) & axis(cy, b, &iy, &ry) &
                      axis(cz, b, &iz, &rz);
      if (ok) {
        info = 64u | (unsigned)(rx + 1) | (unsigned)(ry + 1) << 2 |
               (unsigned)(rz + 1) << 4;
      } else if (error != nullptr) {
        *error = 1;
      }
    }
    for (int q = 0; q < 32; q += 4) {
      const int src = q + (lane >> 3);
      const int hx = __shfl_sync(kFull, ix, src);
      const int hy = __shfl_sync(kFull, iy, src);
      const int hz = __shfl_sync(kFull, iz, src);
      const unsigned h = __shfl_sync(kFull, info, src);
      const int gx = (int)(h & 3) - 1, gy = (int)(h >> 2 & 3) - 1,
                gz = (int)(h >> 4 & 3) - 1;
      long long cell = -1;
      if ((h & 64u) && !(bx && !gx) && !(by && !gy) && !(bz && !gz)) {
        cell = moved(hx, bx, gx, b.cells) +
               (moved(hy, by, gy, b.cells) +
                moved(hz, bz, gz, b.cells) * b.cells) * b.cells;
      }
      // unused lanes share one key, above every cell
      const unsigned long long key =
          cell >= 0 ? (unsigned long long)cell : ~0ull;
      const unsigned group = __match_any_sync(kFull, key);
      if (cell >= 0) {
        row(cell, __popc(group & below), __popc(group), base + src, s);
      }
      __syncwarp();
      if (cell >= 0 && lane == 31 - __clz(group)) last(cell, __popc(group));
      __syncwarp();
    }
    cx = nx;
    cy = ny;
    cz = nz;
  }
}

// A warp's bins are its column k of the (cells^3, chunks) matrix.
__global__ void __launch_bounds__(kWarps * 32)
count_kernel(const float* __restrict__ x, const float* __restrict__ y,
             const float* __restrict__ z, long long n, Box b,
             long long chunk, long long chunks, long long* __restrict__ matrix,
             long long* __restrict__ error) {
  const long long k = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (k >= chunks) return;
  long long* bins = matrix + k;
  const long long p0 = k * chunk;
  const long long p1 = p0 + chunk < n ? p0 + chunk : n;
  walk(x, y, z, p0, p1, b, error,
       [](long long, int, int, long long, int) {},
       [&](long long cell, int group) { bins[cell * chunks] += group; });
}

__global__ void __launch_bounds__(kWarps * 32)
place_kernel(const float* __restrict__ x, const float* __restrict__ y,
             const float* __restrict__ z, long long n, Box b,
             long long chunk, long long chunks,
             long long* __restrict__ matrix, long long* __restrict__ perm,
             int8_t* __restrict__ flags) {
  const long long k = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (k >= chunks) return;
  long long* bins = matrix + k;
  const long long p0 = k * chunk;
  const long long p1 = p0 + chunk < n ? p0 + chunk : n;
  walk(x, y, z, p0, p1, b, nullptr,
       [&](long long cell, int rank, int, long long j, int s) {
         const long long at = bins[cell * chunks] + rank;
         perm[at] = j;
         flags[at] = s != 0;
       },
       [&](long long cell, int group) { bins[cell * chunks] += group; });
}

// The exclusive scan of `v` over the CTA (kScanThreads), and the CTA's sum.
__device__ __forceinline__ long long cta_exclusive(long long v,
                                                   long long* total) {
  __shared__ long long warp_sums[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  long long inc = v;
  for (int o = 1; o < 32; o <<= 1) {
    const long long up = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc += up;
  }
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    long long w = lane < warps ? warp_sums[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const long long up = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w += up;
    }
    warp_sums[lane] = w;
  }
  __syncthreads();
  const long long out = inc - v + (warp > 0 ? warp_sums[warp - 1] : 0);
  *total = warp_sums[warps - 1];
  __syncthreads();
  return out;
}

// Tile t's sum of the matrix, kScanTile entries a tile.
__global__ void __launch_bounds__(kScanThreads)
tile_sums_kernel(const long long* __restrict__ matrix, long long len,
                 long long* __restrict__ sums) {
  const long long first = blockIdx.x * kScanTile + threadIdx.x * kScanItems;
  long long mine = 0;
  for (int i = 0; i < kScanItems; ++i) {
    if (first + i < len) mine += matrix[first + i];
  }
  long long total;
  cta_exclusive(mine, &total);
  if (threadIdx.x == 0) sums[blockIdx.x] = total;
}

// The tiles' sums scanned in place, by one CTA; the whole sum is the
// last offset, the rows the table writes.
__global__ void __launch_bounds__(kScanThreads)
scan_sums_kernel(long long* __restrict__ sums, long long tiles,
                 long long* __restrict__ rows) {
  long long carry = 0;
  for (long long at = 0; at < tiles; at += kScanThreads) {
    const long long i = at + threadIdx.x;
    const long long v = i < tiles ? sums[i] : 0;
    long long total;
    const long long out = cta_exclusive(v, &total);
    if (i < tiles) sums[i] = carry + out;
    carry += total;
  }
  if (threadIdx.x == 0) *rows = carry;
}

// The matrix scanned in place from its tiles' offsets; entry (c, 0) is
// cell c's offset.
__global__ void __launch_bounds__(kScanThreads)
scan_tiles_kernel(long long* __restrict__ matrix, long long len,
                  long long chunks, const long long* __restrict__ sums,
                  long long* __restrict__ offsets) {
  const long long first = blockIdx.x * kScanTile + threadIdx.x * kScanItems;
  long long v[kScanItems];
  long long mine = 0;
  for (int i = 0; i < kScanItems; ++i) {
    v[i] = first + i < len ? matrix[first + i] : 0;
    mine += v[i];
  }
  long long total;
  long long at = sums[blockIdx.x] + cta_exclusive(mine, &total);
  for (int i = 0; i < kScanItems; ++i) {
    const long long e = first + i;
    if (e < len) {
      matrix[e] = at;
      if (e % chunks == 0) offsets[e / chunks] = at;
    }
    at += v[i];
  }
}

}  // namespace

// How the table of n halos in cells^3 cells is cut: out[0] the halos a
// warp (a multiple of 32), out[1] the warps (chunks), out[2] the scan's
// tiles.  The caller allocates the (cells^3, chunks) matrix and the tiles'
// sums.  Returns 0.
extern "C" int minnow_cells_layout(long long n, long long cells,
                                   long long* out) {
  const long long ncells = cells * cells * cells;
  long long chunks = (n + kChunk - 1) / kChunk;
  if (chunks < 1) chunks = 1;
  if (chunks * ncells > kMatrix) {
    chunks = kMatrix / ncells;
    if (chunks < 1) chunks = 1;
  }
  long long chunk = (n + chunks - 1) / chunks;
  chunk = ((chunk + 31) / 32) * 32;
  if (chunk < 32) chunk = 32;
  chunks = (n + chunk - 1) / chunk;
  if (chunks < 1) chunks = 1;
  out[0] = chunk;
  out[1] = chunks;
  out[2] = (ncells * chunks + kScanTile - 1) / kScanTile;
  return 0;
}

// The count and scan passes.  x, y, z (n,) float32; matrix (cells^3,
// chunks) int64 and sums (tiles,) int64 as minnow_cells_layout gives
// them; offsets (cells^3 + 1,) int64; error one int64, zero before the
// call, 1 after it where a halo has no host cell.
extern "C" int minnow_cells_count(const void* x, const void* y,
                                  const void* z, long long n, float dx,
                                  float l, float sb, long long cells,
                                  long long chunk, long long chunks,
                                  void* matrix, void* sums, void* offsets,
                                  void* error, void* stream) {
  const Box b{dx, l, sb, cells};
  const long long ncells = cells * cells * cells;
  const long long len = ncells * chunks;
  const long long tiles = (len + kScanTile - 1) / kScanTile;
  cudaStream_t st = (cudaStream_t)stream;
  const unsigned grid = (unsigned)((chunks + kWarps - 1) / kWarps);
  long long* m = (long long*)matrix;
  cudaMemsetAsync(m, 0, len * 8, st);
  count_kernel<<<grid, kWarps * 32, 0, st>>>(
      (const float*)x, (const float*)y, (const float*)z, n, b, chunk, chunks,
      m, (long long*)error);
  long long* s = (long long*)sums;
  long long* off = (long long*)offsets;
  tile_sums_kernel<<<(unsigned)tiles, kScanThreads, 0, st>>>(m, len, s);
  scan_sums_kernel<<<1, kScanThreads, 0, st>>>(s, tiles, off + ncells);
  scan_tiles_kernel<<<(unsigned)tiles, kScanThreads, 0, st>>>(m, len, chunks,
                                                              s, off);
  return (int)cudaGetLastError();
}

// The place pass, after minnow_cells_count on the same matrix: perm
// (rows,) int64 and flags (rows,) int8, rows = offsets[cells^3].
extern "C" int minnow_cells_place(const void* x, const void* y,
                                  const void* z, long long n, float dx,
                                  float l, float sb, long long cells,
                                  long long chunk, long long chunks,
                                  void* matrix, void* perm, void* flags,
                                  void* stream) {
  const Box b{dx, l, sb, cells};
  cudaStream_t st = (cudaStream_t)stream;
  const unsigned grid = (unsigned)((chunks + kWarps - 1) / kWarps);
  place_kernel<<<grid, kWarps * 32, 0, st>>>(
      (const float*)x, (const float*)y, (const float*)z, n, b, chunk, chunks,
      (long long*)matrix, (long long*)perm, (int8_t*)flags);
  return (int)cudaGetLastError();
}

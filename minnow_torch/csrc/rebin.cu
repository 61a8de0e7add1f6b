// The re-binning of a snapshot by particle ID for Hopper (sm_90a): each
// particle's position and velocity go to its Lagrangian place in a grid
// of file cells.
//
// Replaces no TPU kernel: the JAX package re-bins on the host
// (minnow_tpu/ingest/snapshot.py Grid._build, _cell_index), and so does
// the port's host route (minnow_torch/ingest/snapshot.py).  This is the
// device route of the same arithmetic (ops/rebin.py cell_index; ref
// go/minp/snapshot/grid.go:118-137), for `convert_snapshot to_minp
// --device`, whose encoder takes the grid where it lies.
//
// The grid is built a batch of file cells at a time, [c_lo, c_hi), so
// that the card holds a batch and not the snapshot: one launch a source
// file and batch.  Thread j takes particle j (a grid-stride loop): from
// its 1-based ID it computes
//
//   id = ID - 1;  idx = id % N, idy = (id / N) % N, idz = id / N^2
//   c = idx / n + (idy / n) cells + (idz / n) cells^2        (file cell)
//   i = idx % n + (idy % n) n + (idz % n) n^2              (place in it)
//
// with N = n_side and n = N / cells, and when c lies in the batch copies
// the position's and the velocity's three words bit for bit to
// grid_x[c - c_lo][i] and grid_v[c - c_lo][i], and sets the place's bit
// in `marks` (one bit a place of the batch, in 32-bit words).  An ID
// outside [1, N^3] writes nothing and sets error[0], in every batch; a
// place whose bit was already set sets error[1]: two particles have one
// ID.  The caller reads the two words once a batch.  With distinct IDs
// every grid element is written by one thread and the error words are
// plain stores of the same value; the one atomic is the marks' OR, whose
// words do not depend on order, and with a shared ID every writer after
// the first, whichever it is, finds its bit set.  So nothing the
// caller reads depends on scheduling.
//
// What bounds it on the H100: memory, in scattered sectors.  A particle
// reads 32 bytes (its ID and two vectors, in order) and writes 12 bytes
// to each grid at a place that its ID decides and ORs its mark into a
// word there: three 32-byte sectors, as a grid of 201 MB does not stay in
// the 50 MB L2.
// chip_smoke.py times it against its plain version at the snapshot
// cell's shape (2.1 M particles a file, one 256^3 cell) with that bound.

#include <cuda_runtime.h>

#include <cstdint>

#include "bitstream.cuh"

namespace {

using minnow::kThreads;

__global__ void __launch_bounds__(kThreads)
rebin_kernel(const long long* __restrict__ ids,
             const uint32_t* __restrict__ x, const uint32_t* __restrict__ v,
             long long n_particles, long long n_side, long long cells,
             long long c_lo, long long c_hi, uint32_t* __restrict__ grid_x,
             uint32_t* __restrict__ grid_v, unsigned int* __restrict__ marks,
             int* __restrict__ error) {
  const long long n = n_side / cells;
  const long long n3 = n * n * n;
  const long long all = n_side * n_side * n_side;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       j < n_particles; j += stride) {
    // ids are 1-based; the subtraction wraps as numpy's does
    const long long id = (long long)((unsigned long long)ids[j] - 1ull);
    if (id < 0 || id >= all) {
      error[0] = 1;
      continue;
    }
    const long long idx = id % n_side;
    const long long idy = (id / n_side) % n_side;
    const long long idz = id / (n_side * n_side);
    const long long c = idx / n + (idy / n) * cells + (idz / n) * cells * cells;
    if (c < c_lo || c >= c_hi) continue;
    const long long i = idx % n + (idy % n) * n + (idz % n) * n * n;
    const long long place = (c - c_lo) * n3 + i;
    const unsigned int bit = 1u << (place & 31);
    if (atomicOr(marks + (place >> 5), bit) & bit) error[1] = 1;
    uint32_t* ox = grid_x + 3 * place;
    uint32_t* ov = grid_v + 3 * place;
    const uint32_t* ix = x + 3 * j;
    const uint32_t* iv = v + 3 * j;
    ox[0] = ix[0];
    ox[1] = ix[1];
    ox[2] = ix[2];
    ov[0] = iv[0];
    ov[1] = iv[1];
    ov[2] = iv[2];
  }
}

}  // namespace

// ids (n_particles,) int64, 1-based; x, v (n_particles, 3) float32, as
// words; grid_x, grid_v (c_hi - c_lo, (n_side / cells)^3, 3) float32, as
// words; marks ceil((c_hi - c_lo) (n_side / cells)^3 / 32) words; error
// two int32.  n_particles >= 1.
extern "C" int minnow_rebin(const void* ids, const void* x, const void* v,
                            long long n_particles, long long n_side,
                            long long cells, long long c_lo, long long c_hi,
                            void* grid_x, void* grid_v, void* marks,
                            void* error, void* stream) {
  long long blocks = (n_particles + kThreads - 1) / kThreads;
  if (blocks > (1ll << 20)) blocks = 1ll << 20;
  rebin_kernel<<<(unsigned int)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const long long*)ids, (const uint32_t*)x, (const uint32_t*)v,
      n_particles, n_side, cells, c_lo, c_hi, (uint32_t*)grid_x,
      (uint32_t*)grid_v, (unsigned int*)marks, (int*)error);
  return (int)cudaGetLastError();
}

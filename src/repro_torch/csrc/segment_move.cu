// segment_move — incremental superblock migration, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/segment_move.py::segment_move (kernel
// body _make_kernel).  Semantics, per output tile t of BN rows:
//
//   sel[t] == 0:  out[t*BN + i] = src[starts[t] + i]     (reuse a tile of the old superblock)
//   otherwise:    out[t*BN + i] = delta[starts[t] + i]   (a changed tile uploaded by the host)
//
// It is segment_append (csrc/segment_append.cu) without the zero-fill mode.  The wrapper
// (repro_torch/kernels/segment_move.py) checks on the host, before the plan is uploaded,
// that every run lies inside its source; the kernel trusts the plan.
//
// Bound: pure data movement.  The least time is the bytes the migration must move — each
// tile's BN source rows read once, each of the T * BN output rows written once, plus the
// 8 * T bytes of plan — over the H100's 3.35 TB/s (at SCI_1M about 1.9 GB, ~0.6 ms).  This
// first design does nothing about that bound beyond vector width: a grid-stride loop of
// thread blocks over tiles, each block reading its own sel/starts and copying the tile's
// BN contiguous rows with 16-byte loads and stores, neighbouring threads on neighbouring
// addresses.  TMA bulk copies are later work.
//
// The kernel copies bytes, so it takes any dtype whose row is a multiple of 16 bytes; all
// three buffers must be 16-byte aligned.  Plain C entry point (csrc/tile_launch.cuh), loaded
// with ctypes.

#include "tile_launch.cuh"

namespace {

using tile_launch::kThreads;

__global__ void __launch_bounds__(kThreads)
segment_move_kernel(const int4* __restrict__ src, const int4* __restrict__ delta,
                    const int32_t* __restrict__ sel, const int32_t* __restrict__ starts,
                    int4* __restrict__ out, int64_t n_tiles, int block_n, int row_vecs) {
  const int tile_vecs = block_n * row_vecs;
  for (int64_t t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int4* base = (sel[t] == 0 ? src : delta) + static_cast<int64_t>(starts[t]) * row_vecs;
    int4* dst = out + t * tile_vecs;
    for (int k = threadIdx.x; k < tile_vecs; k += kThreads) dst[k] = base[k];
  }
}

}  // namespace

extern "C" int segment_move_launch(const void* src, const void* delta, const void* sel,
                                   const void* starts, void* out, long long n_tiles,
                                   int block_n, long long row_bytes, void* stream) {
  return tile_launch::launch_tiles(segment_move_kernel, src, delta, sel, starts, out,
                                   n_tiles, block_n, row_bytes, stream);
}

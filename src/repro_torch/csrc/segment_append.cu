// segment_append — in-place superblock append for a commit wave, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/segment_append.py::segment_append
// (kernel body _make_kernel).  Semantics, per output tile t of BN rows:
//
//   sel[t] == 0:  out[t*BN + i] = src[starts[t] + i]     (reuse a tile of the old superblock)
//   sel[t] == 1:  out[t*BN + i] = delta[starts[t] + i]   (a new tile uploaded by the host)
//   sel[t] == 2:  out[t*BN + i] = 0                      (alignment slack; reads nothing)
//
// The wrapper (repro_torch/kernels/segment_append.py) checks on the host, before the plan
// is uploaded, that every sel 0/1 run lies inside its source; the kernel trusts the plan.
//
// Bound: pure data movement.  The least time is the bytes the wave must move — each sel 0/1
// tile's BN rows read once, each of the T * BN output rows written once, plus the 8 * T
// bytes of plan — over the H100's 3.35 TB/s.  At SCI_1M a commit wave rewrites the whole
// ~963 MB superblock, about 0.6 ms at the bound.  This first design does nothing about that
// bound beyond vector width: a grid-stride loop of thread blocks over tiles, each block
// reading its own sel/starts and copying the tile's BN contiguous rows with 16-byte loads
// and stores, neighbouring threads on neighbouring addresses.  TMA bulk copies are later
// work.
//
// The kernel copies bytes, so it takes any dtype whose row is a multiple of 16 bytes (the
// superblock pads D to a multiple of 128 elements); all three buffers must be 16-byte
// aligned.  Plain C entry point (csrc/tile_launch.cuh), loaded with ctypes.

#include "tile_launch.cuh"

namespace {

using tile_launch::kThreads;

__global__ void __launch_bounds__(kThreads)
segment_append_kernel(const int4* __restrict__ src, const int4* __restrict__ delta,
                      const int32_t* __restrict__ sel, const int32_t* __restrict__ starts,
                      int4* __restrict__ out, int64_t n_tiles, int block_n, int row_vecs) {
  const int tile_vecs = block_n * row_vecs;
  for (int64_t t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int32_t s = sel[t];
    int4* dst = out + t * tile_vecs;
    if (s == 2) {
      const int4 zero = make_int4(0, 0, 0, 0);
      for (int k = threadIdx.x; k < tile_vecs; k += kThreads) dst[k] = zero;
      continue;
    }
    const int4* base = (s == 0 ? src : delta) + static_cast<int64_t>(starts[t]) * row_vecs;
    for (int k = threadIdx.x; k < tile_vecs; k += kThreads) dst[k] = base[k];
  }
}

}  // namespace

extern "C" int segment_append_launch(const void* src, const void* delta, const void* sel,
                                     const void* starts, void* out, long long n_tiles,
                                     int block_n, long long row_bytes, void* stream) {
  return tile_launch::launch_tiles(segment_append_kernel, src, delta, sel, starts, out,
                                   n_tiles, block_n, row_bytes, stream);
}

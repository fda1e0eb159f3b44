// checkout_wave — the cross-partition fused checkout gather, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/checkout_batched.py::checkout_wave
// (kernel body _make_wave_kernel).  Semantics, per output tile t of BN rows, with
// s0 = starts[t*BN]:
//
//   run tile:  out[t*BN + i] = data[s0 + i]               if mode[t] == 1 and s0 + BN <= hi[t]
//   row tile:  out[t*BN + i] = data[starts[t*BN + i]]     otherwise
//
// The hi check stays on the device, so a stale plan degrades to row gathers instead
// of reading past a partition segment.
//
// Bound: pure data movement.  The least time is the bytes the wave must move — each
// distinct source row read once, each of the T * BN output rows written once, plus the
// plan, 4 * (T*BN + 2*T) bytes — over the H100's 3.35 TB/s; with no repeated source row
// that is 2 * T * BN * row_bytes plus the plan.  This first design does nothing
// about that bound beyond vector width: a grid-stride loop of thread blocks over tiles,
// each block copying its tile's rows with 16-byte loads and stores, neighbouring
// threads on neighbouring addresses; the block reads its own starts/mode/hi.  Run
// tiles as TMA bulk copies are later work.
//
// The kernel copies bytes, so it takes any dtype: row_bytes must be a multiple of 16
// and both tensors 16-byte aligned (the superblock pads D to a multiple of 128
// elements).  Plain C entry point (csrc/tile_launch.cuh), loaded with ctypes.

#include "tile_launch.cuh"

namespace {

using tile_launch::kThreads;

__global__ void __launch_bounds__(kThreads)
checkout_wave_kernel(const int4* __restrict__ data, const int32_t* __restrict__ starts,
                     const int32_t* __restrict__ mode, const int32_t* __restrict__ hi,
                     int4* __restrict__ out, int64_t n_tiles, int block_n, int row_vecs) {
  const int tile_vecs = block_n * row_vecs;
  for (int64_t t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int32_t* tile_starts = starts + t * block_n;
    const int64_t s0 = tile_starts[0];
    const bool run = mode[t] == 1 && s0 + block_n <= static_cast<int64_t>(hi[t]);
    int4* dst = out + t * tile_vecs;
    for (int k = threadIdx.x; k < tile_vecs; k += kThreads) {
      const int i = k / row_vecs;
      const int c = k - i * row_vecs;
      const int64_t src = run ? s0 + i : static_cast<int64_t>(tile_starts[i]);
      dst[k] = data[src * row_vecs + c];
    }
  }
}

}  // namespace

extern "C" int checkout_wave_launch(const void* data, const void* starts, const void* mode,
                                    const void* hi, void* out, long long n_tiles, int block_n,
                                    long long row_bytes, void* stream) {
  return tile_launch::launch_tiles(checkout_wave_kernel, data, starts, mode, hi, out,
                                   n_tiles, block_n, row_bytes, stream);
}

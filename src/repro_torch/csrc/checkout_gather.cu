// checkout_gather — single-version checkout gathers, for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of src/repro/kernels/checkout_gather.py (kernel body
// _copy_kernel, one (1, BD) or (BN, BD) block per grid step):
//
//   gather_rows:       out[i] = data[rids[i]]                          (one row a step)
//   gather_row_tiles:  out[t*BN + i] = data[tile_idx[t]*BN + i]        (one BN-row tile a step)
//
// gather_row_tiles is segment_move's sel-0 case: tile t is one contiguous BN-row run.
// gather_rows groups its rows into BN-row output tiles, as checkout_wave's row tiles do,
// so that a block copies BN rows (4 KB at 512-byte rows) and no thread of a 256-thread
// block idles on a single 512-byte row; the wrapper pads rids to a multiple of BN with a
// valid rid and returns the leading N rows.  The wrappers (repro_torch/kernels/
// checkout_gather.py) check on the host, before the upload, that every rid lies in
// [0, R) and every tile index in [0, R/BN); the kernels trust their indices.
//
// Bound: pure data movement.  The least time is the bytes a checkout must move — each
// gathered source row read once, each output row written once, plus the 4-byte indices —
// over the H100's 3.35 TB/s (a SCI_1M version, ~25 MB, ~7.6 us).  At that size a launch is
// a few microseconds of the card's time, so the design does nothing about the bound beyond
// vector width: a grid-stride loop of thread blocks over output tiles, each block reading
// its own indices and copying 16-byte vectors, neighbouring threads on neighbouring
// addresses.  Both kernels copy bytes, so they take any dtype whose row is a multiple of
// 16 bytes (the wrapper pads D to the lane tile).  Plain C entry points
// (csrc/tile_launch.cuh), loaded with ctypes.

#include "tile_launch.cuh"

namespace {

using tile_launch::kThreads;

__global__ void __launch_bounds__(kThreads)
gather_row_tiles_kernel(const int4* __restrict__ data, const int32_t* __restrict__ tile_idx,
                        const int32_t* __restrict__ /*unused*/,
                        const int32_t* __restrict__ /*unused*/, int4* __restrict__ out,
                        int64_t n_tiles, int block_n, int row_vecs) {
  const int tile_vecs = block_n * row_vecs;
  for (int64_t t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int4* src = data + static_cast<int64_t>(tile_idx[t]) * tile_vecs;
    int4* dst = out + t * tile_vecs;
    for (int k = threadIdx.x; k < tile_vecs; k += kThreads) dst[k] = src[k];
  }
}

__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const int4* __restrict__ data, const int32_t* __restrict__ rids,
                   const int32_t* __restrict__ /*unused*/,
                   const int32_t* __restrict__ /*unused*/, int4* __restrict__ out,
                   int64_t n_tiles, int block_n, int row_vecs) {
  const int tile_vecs = block_n * row_vecs;
  for (int64_t t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int32_t* tile_rids = rids + t * block_n;
    int4* dst = out + t * tile_vecs;
    for (int k = threadIdx.x; k < tile_vecs; k += kThreads) {
      const int i = k / row_vecs;
      const int c = k - i * row_vecs;
      dst[k] = data[static_cast<int64_t>(tile_rids[i]) * row_vecs + c];
    }
  }
}

}  // namespace

extern "C" int gather_row_tiles_launch(const void* data, const void* tile_idx,
                                       const void* unused_c, const void* unused_d, void* out,
                                       long long n_tiles, int block_n, long long row_bytes,
                                       void* stream) {
  return tile_launch::launch_tiles(gather_row_tiles_kernel, data, tile_idx, unused_c,
                                   unused_d, out, n_tiles, block_n, row_bytes, stream);
}

extern "C" int gather_rows_launch(const void* data, const void* rids, const void* unused_c,
                                  const void* unused_d, void* out, long long n_tiles,
                                  int block_n, long long row_bytes, void* stream) {
  return tile_launch::launch_tiles(gather_rows_kernel, data, rids, unused_c, unused_d, out,
                                   n_tiles, block_n, row_bytes, stream);
}

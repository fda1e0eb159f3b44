// tile_launch.cuh — the host side that every tile kernel of the port shares.
//
// A tile kernel copies BN-row output tiles of 16-byte vectors: it takes four input
// pointers (typed as the kernel declares them), the int4 output, the tile count, BN and
// the row width in 16-byte vectors.  launch_tiles checks the row width, sizes a
// grid-stride grid of kBlocksPerSm blocks per SM (capped at one block per tile) and
// launches on the caller's stream.  Each source's extern "C" entry point is this call and
// nothing more; it returns a cudaError_t (0 on success), which the Python wrapper raises.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tile_launch {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

template <typename A, typename B, typename C, typename D>
int launch_tiles(void (*kernel)(const A*, const B*, const C*, const D*, int4*, int64_t, int,
                                int),
                 const void* a, const void* b, const void* c, const void* d, void* out,
                 long long n_tiles, int block_n, long long row_bytes, void* stream) {
  if (n_tiles <= 0) return 0;
  if (row_bytes % 16 != 0 || block_n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  int device = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long cap = static_cast<long long>(sms) * kBlocksPerSm;
  const unsigned grid = static_cast<unsigned>(n_tiles < cap ? n_tiles : cap);
  kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const A*>(a), static_cast<const B*>(b), static_cast<const C*>(c),
      static_cast<const D*>(d), static_cast<int4*>(out), static_cast<int64_t>(n_tiles),
      block_n, static_cast<int>(row_bytes / 16));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tile_launch

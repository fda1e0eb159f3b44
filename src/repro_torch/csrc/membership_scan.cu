// membership_scan — the version-membership scan over bitset vlists, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/vlist_membership.py::membership_scan
// (kernel body _membership_kernel, one BR-row block per grid step).  For version vid, with
// word = vid / 32 and bit = vid % 32, over a bitmap of R rows and W uint32 words a row:
//
//   mask[r] = (bitmap[r, word] >> bit) & 1                       for r < R
//   cnt[b]  = sum of mask over rows [b*BR, (b+1)*BR)            for b < ceil(R / BR)
//
// Rows past R count as zero rows, so the result equals the reference's on a bitmap padded
// with zero rows to a multiple of BR, without copying the bitmap to pad it.  The wrapper
// (repro_torch/kernels/vlist_membership.py) checks 0 <= vid < 32 * W on the host.
//
// Bound: the scan reads one 4-byte word a row at a stride of 4 * W bytes, so at W >= 8
// every row costs one 32-byte DRAM sector: the least time is R * 32 bytes read plus the
// 4 * R bytes of mask and the counts written, over the H100's 3.35 TB/s (SCI_1M: ~34 MB,
// ~10 us).  The design does nothing about the sector waste (a column-major bitmap would
// remove it; that is later work): one block of 256 threads per BR-row block, each thread
// one row at a time, neighbouring threads on neighbouring rows.  The count is exact and
// deterministic: each warp's __ballot_sync + __popc, summed over its rows, then the
// block's 8 warp counts summed by one thread in a fixed order.  Plain C entry point,
// loaded with ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
membership_scan_kernel(const uint32_t* __restrict__ bitmap, int32_t* __restrict__ mask,
                       int32_t* __restrict__ cnt, int64_t n_rows, int n_words, int block_r,
                       int word, int bit) {
  __shared__ int warp_counts[kWarps];
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * block_r;
  int count = 0;
  // every thread runs every iteration, so the ballot sees the whole warp
  for (int base = 0; base < block_r; base += kThreads) {
    const int i = base + static_cast<int>(threadIdx.x);
    const int64_t r = row0 + i;
    int m = 0;
    if (i < block_r && r < n_rows) {
      m = static_cast<int>((bitmap[r * n_words + word] >> bit) & 1u);
      mask[r] = m;
    }
    count += __popc(__ballot_sync(0xffffffffu, m));
  }
  if ((threadIdx.x & 31) == 0) warp_counts[threadIdx.x >> 5] = count;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < kWarps; ++w) total += warp_counts[w];
    cnt[blockIdx.x] = total;
  }
}

}  // namespace

// The bitmap kernels' binding: bitmap, values (unused here), two outputs (mask, counts),
// R, W, BR, vid and the stream; returns a cudaError_t (0 on success).
extern "C" int membership_scan_launch(const void* bitmap, const void* /*values*/, void* mask,
                                      void* cnt, long long n_rows, int n_words, int block_r,
                                      int vid, void* stream) {
  if (n_rows <= 0) return 0;   // a grid of 0 blocks is cudaErrorInvalidConfiguration
  if (n_words <= 0 || block_r <= 0 || vid < 0 ||
      static_cast<long long>(vid) >= 32LL * n_words) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long n_blocks = (n_rows + block_r - 1) / block_r;
  if (n_blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  membership_scan_kernel<<<static_cast<unsigned>(n_blocks), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(bitmap), static_cast<int32_t*>(mask),
      static_cast<int32_t*>(cnt), static_cast<int64_t>(n_rows), n_words, block_r, vid / 32,
      vid % 32);
  return static_cast<int>(cudaGetLastError());
}

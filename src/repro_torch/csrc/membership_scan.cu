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
// with zero rows to a multiple of BR, without copying the bitmap to pad it.  The bitmap is
// read through its strides in elements: element (r, w) lies at bitmap[r * row_stride +
// w * word_stride].  The wrapper (repro_torch/kernels/vlist_membership.py) passes either
// layout it accepts, row-major (word_stride 1) or word-major (row_stride 1, the view that
// word_major() makes), and checks 0 <= vid < 32 * W on the host.
//
// Bound.  Row-major, the scan reads one 4-byte word a row at a stride of 4 * W bytes, so at
// W >= 8 every row costs one 32-byte DRAM sector: R * 32 bytes read plus the 4 * R bytes of
// mask and the counts written (SCI_1M, W = 32: ~34 MB, ~10 us at 3.35 TB/s), and no code
// reaches below that.  Word-major, version vid's word of all R rows is one contiguous run,
// so the least traffic is 4 * R read, 4 * R of mask written and the counts (SCI_1M:
// ~7.6 MB, ~2.3 us).
//
// Design.  One block of 256 threads per BR-row count block (grid = ceil(R / BR)), so no count
// crosses blocks.  Two instances, chosen by the launcher (membership_scan_instance):
//   vec4    the word's run is word-major (row_stride 1) and starts 16-byte aligned, and BR is
//           a multiple of 4: each thread moves 4 consecutive rows (a group) a pass with one
//           16-byte load and one 16-byte mask store, neighbouring threads on neighbouring 16
//           bytes, so a warp moves 512 contiguous bytes each way.  At the default BR of 1024 a
//           block covers its count block in a single pass.  The last group of 4 that R cuts
//           goes row by row.  (A probe on the card found 64-512 threads a block, 1-4 groups
//           of 4 rows a thread and a streaming load hint all within the spread of this one.)
//   strided everything else (row-major, a base off 16 bytes, an odd BR): each thread takes
//           4 rows a pass, kThreads apart (neighbouring threads on neighbouring rows), and
//           issues the 4 loads before it uses any, so 4 loads a thread are in flight.
// The count is exact and deterministic: each thread's bits by popc, the warp's by
// __reduce_add_sync, then the block's 8 warp counts summed by one thread in a fixed order.
// No atomics, no shared memory beyond the 8 warp counts.  Plain C entry points, loaded with
// ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;                   // rows a thread takes a pass
constexpr int kPass = kRows * kThreads;    // rows a block takes a pass

// The block's count: the warp's by a reduction, the warps' in order by thread 0.
__device__ __forceinline__ void write_count(unsigned count, int32_t* __restrict__ cnt) {
  __shared__ unsigned warp_counts[kWarps];
  count = __reduce_add_sync(0xffffffffu, count);
  if ((threadIdx.x & 31) == 0) warp_counts[threadIdx.x >> 5] = count;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned total = 0;
    for (int w = 0; w < kWarps; ++w) total += warp_counts[w];
    cnt[blockIdx.x] = static_cast<int32_t>(total);
  }
}

// `col` is the word's run: row r at col[r].  Needs col and mask 16-byte aligned and
// block_r % 4 == 0, so every group of 4 rows starts 16-byte aligned.
__global__ void __launch_bounds__(kThreads)
membership_scan_vec4_kernel(const uint32_t* __restrict__ col, int32_t* __restrict__ mask,
                            int32_t* __restrict__ cnt, int64_t n_rows, int64_t block_r,
                            int bit) {
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * block_r;
  unsigned count = 0;
  for (int64_t base = 0; base < block_r; base += kPass) {
    // i % 4 == 0 and block_r % 4 == 0, so i < block_r puts all 4 rows in the count block
    const int64_t i = base + kRows * static_cast<int64_t>(threadIdx.x);
    const int64_t r = row0 + i;
    if (i >= block_r || r >= n_rows) continue;   // past the count block or past R
    if (r + kRows <= n_rows) {
      const uint4 w = __ldg(reinterpret_cast<const uint4*>(col + r));
      const int4 m = make_int4((w.x >> bit) & 1u, (w.y >> bit) & 1u, (w.z >> bit) & 1u,
                               (w.w >> bit) & 1u);
      *reinterpret_cast<int4*>(mask + r) = m;
      count += __popc(m.x | (m.y << 1) | (m.z << 2) | (m.w << 3));
    } else {                                     // the group that R cuts, row by row
      for (int64_t k = r; k < n_rows; ++k) {
        const int m = static_cast<int>((__ldg(col + k) >> bit) & 1u);
        mask[k] = m;
        count += m;
      }
    }
  }
  write_count(count, cnt);
}

// Any layout: row r at col[r * row_stride].
__global__ void __launch_bounds__(kThreads)
membership_scan_strided_kernel(const uint32_t* __restrict__ col, int32_t* __restrict__ mask,
                               int32_t* __restrict__ cnt, int64_t n_rows,
                               int64_t row_stride, int64_t block_r, int bit) {
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * block_r;
  unsigned count = 0;
  for (int64_t base = 0; base < block_r; base += kPass) {
    uint32_t w[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k) {            // all loads first: 4 in flight
      const int64_t i = base + k * kThreads + threadIdx.x;
      const int64_t r = row0 + i;
      w[k] = (i < block_r && r < n_rows) ? __ldg(col + r * row_stride) : 0u;
    }
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const int64_t i = base + k * kThreads + threadIdx.x;
      const int64_t r = row0 + i;
      const int m = static_cast<int>((w[k] >> bit) & 1u);
      if (i < block_r && r < n_rows) mask[r] = m;
      count += m;                                // 0 past R and past the block
    }
  }
  write_count(count, cnt);
}

const uint32_t* word_run(const void* bitmap, int vid, long long word_stride) {
  return static_cast<const uint32_t*>(bitmap) + static_cast<long long>(vid / 32) * word_stride;
}

}  // namespace

// The instance a launch with these operands runs: 1 vec4, 0 strided.
extern "C" int membership_scan_instance(const void* bitmap, long long row_stride,
                                        long long word_stride, int block_r, int vid) {
  const uintptr_t run = reinterpret_cast<uintptr_t>(word_run(bitmap, vid, word_stride));
  return row_stride == 1 && run % 16 == 0 && block_r % kRows == 0;
}

// bitmap, the two outputs (mask, counts), R, W, the row and word strides in elements, BR,
// vid and the stream; returns a cudaError_t (0 on success).  The mask must start 16-byte
// aligned (the wrapper's fresh allocation is).
extern "C" int membership_scan_launch(const void* bitmap, void* mask, void* cnt,
                                      long long n_rows, int n_words, long long row_stride,
                                      long long word_stride, int block_r, int vid,
                                      void* stream) {
  if (n_rows <= 0) return 0;   // a grid of 0 blocks is cudaErrorInvalidConfiguration
  if (n_words <= 0 || block_r <= 0 || vid < 0 ||
      static_cast<long long>(vid) >= 32LL * n_words || row_stride < 1 || word_stride < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (reinterpret_cast<uintptr_t>(mask) % 16 != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  const long long n_blocks = (n_rows + block_r - 1) / block_r;
  if (n_blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const uint32_t* col = word_run(bitmap, vid, word_stride);
  int32_t* m = static_cast<int32_t*>(mask);
  int32_t* c = static_cast<int32_t*>(cnt);
  const dim3 grid(static_cast<unsigned>(n_blocks));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (membership_scan_instance(bitmap, row_stride, word_stride, block_r, vid)) {
    membership_scan_vec4_kernel<<<grid, kThreads, 0, s>>>(col, m, c, n_rows, block_r,
                                                          vid % 32);
  } else {
    membership_scan_strided_kernel<<<grid, kThreads, 0, s>>>(col, m, c, n_rows, row_stride,
                                                             block_r, vid % 32);
  }
  return static_cast<int>(cudaGetLastError());
}

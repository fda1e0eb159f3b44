// version_aggregate — per-version sums over bitset vlists, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/version_agg.py::version_aggregate
// (kernel body _agg_kernel).  Over a bitmap of R rows and W uint32 words a row and a
// float32 value per row:
//
//   out[32*w + b] = sum over r < R of ((bitmap[r, w] >> b) & 1) * values[r]
//
// The Pallas kernel walks a (W, R/BR) grid in order and accumulates into an output block
// that the inner record-block axis revisits.  Hopper blocks run in no order, so this is
// two passes, both deterministic (no float atomics; the same inputs give the same bits):
//
//   1. version_partials: a 2-D grid, x over ceil(R/BR) row chunks, y over word tiles of
//      8 words.  A block stages 256 rows of its 8 words and their values in shared memory
//      at a time; thread (w, b) then walks the chunk's rows in order and accumulates
//      version 32*(8*y + w) + b with one fma a row (the reference's bits * values, so a
//      non-finite value propagates as there).  It writes partials[chunk, version].
//   2. version_reduce: one block per word; warp g sums chunks g, g+8, g+16, ... in order,
//      and one thread adds the 8 warp sums in order.
//
// W is the number of 32-version words and grows with the versions (32 at 1,000 versions,
// 313 at 10,000), so nothing assumes 32 * W <= 1024: word tiles are a grid dimension (at
// most 65,535 of them, W <= 524,280 words; the launcher refuses more).
// Rows past R count as zero rows (the reference pads with zero rows to a multiple of BR).
//
// Bound: every bitmap word and value is read once, so the least time is (4 * R * W +
// 4 * R + 128 * W) bytes over the H100's 3.35 TB/s (SCI_1M: ~125 MB, ~37 us); the
// 32 * R * W multiply-adds, 2 operations each over 67 TFLOP/s of float32, take less
// (~29 us at SCI_1M).  The design does nothing more about it than to read the bitmap in
// 32-byte runs; the shared-memory reads are warp broadcasts.  The partials
// (4 * ceil(R/BR) * 32 * W bytes) are written and read once more.  Plain C entry point,
// loaded with ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWordsPerBlock = 8;
constexpr int kThreads = 32 * kWordsPerBlock;   // thread (w, b): word w of the tile, bit b
constexpr int kStageRows = 256;
constexpr int kReduceWarps = 8;

__global__ void __launch_bounds__(kThreads)
version_partials_kernel(const uint32_t* __restrict__ bitmap, const float* __restrict__ values,
                        float* __restrict__ partials, int64_t n_rows, int n_words,
                        int block_r) {
  __shared__ uint32_t words[kStageRows][kWordsPerBlock];
  __shared__ float vals[kStageRows];
  const int w = threadIdx.x >> 5;
  const int b = threadIdx.x & 31;
  const int word0 = blockIdx.y * kWordsPerBlock;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * block_r;
  const int64_t row_end = row0 + block_r < n_rows ? row0 + block_r : n_rows;
  float acc = 0.f;
  for (int64_t s = row0; s < row_end; s += kStageRows) {
    const int rows = static_cast<int>(row_end - s < kStageRows ? row_end - s : kStageRows);
    for (int k = threadIdx.x; k < kStageRows * kWordsPerBlock; k += kThreads) {
      const int i = k / kWordsPerBlock;
      const int j = k - i * kWordsPerBlock;
      uint32_t x = 0u;
      if (i < rows && word0 + j < n_words) x = bitmap[(s + i) * n_words + word0 + j];
      words[i][j] = x;
    }
    for (int i = threadIdx.x; i < kStageRows; i += kThreads) {
      vals[i] = i < rows ? values[s + i] : 0.f;
    }
    __syncthreads();
    for (int i = 0; i < rows; ++i) {
      acc = fmaf(static_cast<float>((words[i][w] >> b) & 1u), vals[i], acc);
    }
    __syncthreads();
  }
  const int word = word0 + w;
  if (word < n_words) {
    partials[static_cast<int64_t>(blockIdx.x) * n_words * 32 + word * 32 + b] = acc;
  }
}

__global__ void __launch_bounds__(32 * kReduceWarps)
version_reduce_kernel(const float* __restrict__ partials, float* __restrict__ out,
                      int n_chunks, int n_versions) {
  __shared__ float sums[kReduceWarps][32];
  const int g = threadIdx.x >> 5;
  const int v = blockIdx.x * 32 + (threadIdx.x & 31);
  float acc = 0.f;
  for (int c = g; c < n_chunks; c += kReduceWarps) {
    acc += partials[static_cast<int64_t>(c) * n_versions + v];
  }
  sums[g][threadIdx.x & 31] = acc;
  __syncthreads();
  if (g == 0) {
    float total = 0.f;
    for (int k = 0; k < kReduceWarps; ++k) total += sums[k][threadIdx.x];
    out[v] = total;
  }
}

}  // namespace

// The bitmap kernels' binding: bitmap, values, two outputs (partials of ceil(R/BR) * 32 * W
// floats, then the 32 * W sums), R, W, BR, vid (unused here) and the stream; returns a
// cudaError_t (0 on success).
extern "C" int version_aggregate_launch(const void* bitmap, const void* values,
                                        void* partials, void* out, long long n_rows,
                                        int n_words, int block_r, int /*vid*/,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_words <= 0 || block_r <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long n_versions = 32LL * n_words;
  if (n_rows <= 0) {   // no rows: every sum is 0, and a grid of 0 blocks would be refused
    return static_cast<int>(cudaMemsetAsync(out, 0, 4 * n_versions, s));
  }
  const long long n_chunks = (n_rows + block_r - 1) / block_r;
  const long long n_tiles = (n_words + kWordsPerBlock - 1) / kWordsPerBlock;
  if (n_chunks > 0x7fffffffLL || n_tiles > 65535 || n_versions > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  version_partials_kernel<<<dim3(static_cast<unsigned>(n_chunks),
                                 static_cast<unsigned>(n_tiles)),
                            kThreads, 0, s>>>(
      static_cast<const uint32_t*>(bitmap), static_cast<const float*>(values),
      static_cast<float*>(partials), static_cast<int64_t>(n_rows), n_words, block_r);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  version_reduce_kernel<<<static_cast<unsigned>(n_words), 32 * kReduceWarps, 0, s>>>(
      static_cast<const float*>(partials), static_cast<float*>(out),
      static_cast<int>(n_chunks), static_cast<int>(n_versions));
  return static_cast<int>(cudaGetLastError());
}

// version_aggregate — per-version sums over bitset vlists on the tensor cores, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/version_agg.py::version_aggregate
// (kernel body _agg_kernel).  Over a bitmap of R rows and W uint32 words a row and a
// float32 value per row:
//
//   out[32*w + b] = sum over r < R of ((bitmap[r, w] >> b) & 1) * values[r]
//
// That is a matrix product, out = Bits^T . values, with 0/1 entries, and this kernel runs it
// on the tensor cores (mma.sync.m16n8k16, bf16 operands, float32 accumulators):
//
//   A (16 x 16) = the bits of 16 versions (half of one word) over 16 record rows, as bf16
//                 1.0 (0x3F80) or 0.  M = versions, K = rows.
//   B (16 x 8)  = the 16 rows' values in three bf16 columns, hi, mid and lo (n = 0, 1, 2; the
//                 other five columns are 0), split by truncation so that no bit is lost:
//                 hi = v & 0xFFFF0000, r = v - hi (exact), mid = r & 0xFFFF0000,
//                 lo = bf16(r - mid) (at most 8 significant bits, so exact).  hi + mid + lo
//                 == v bit for bit for every finite v with |v| >= 2^-102 (below that lo may
//                 fall under float32's normal range and round); a truncated hi never
//                 overflows near FLT_MAX.  A non-finite v splits as (v, 0, 0), a NaN as the
//                 canonical one, so a held inf stays inf.  The products with 0/1 are exact,
//                 so only the float32 accumulation rounds; each version's chunk sum is
//                 (hi_sum + mid_sum) + lo_sum, in that order.
//   C (16 x 8)  = per version, the running hi, mid and lo sums.
//
// A non-finite value keeps the reference's meaning (bits.astype(float32) * vals): the tensor
// cores multiply exactly, so a 0 bit times inf or NaN is NaN, as there; the card suite checks
// the positions of NaN and inf against the plain version.
//
// Two passes, both deterministic (no float atomics; the same inputs give the same bits):
//
//   1. version_partials_kernel: grid x over row chunks of `chunk_rows` rows (the kernel's own
//      chunking, chosen by the wrapper, a multiple of 64), y over groups of 32 words.  A block
//      of 4 warps stages its chunk 64 rows at a time through a 3-slot ring: the group's words
//      of each row by 16-byte cp.async copies (4-byte ones when a row is not 16-byte aligned,
//      W % 4 != 0), so two stages are in flight while one is read; the rows' values by plain
//      loads one stage ahead, split once a row (by threads 0..63, the iteration before the
//      stage is read) into the stage's B fragments.  Each warp owns 8 words (16 M-tiles, 64
//      float32 accumulators a thread) and walks the chunk's rows in order, 16 rows (one
//      K-step) at a time: one 8-byte shared load gives its B fragment, reused by its 16 mma.
//      It writes partials[chunk, version].
//   2. version_reduce_kernel: one block per word; warp g sums chunks g, g+8, g+16, ... in
//      order, and one thread adds the 8 warp sums in order.
//
// Bits to operands.  K order within a tile is free as long as B uses the same row mapping:
// K slots 2t, 2t+1, 2t+8, 2t+9 (the rows of lane l = 4g + t's A and B fragments) are rows
// t, t+4, t+8, t+12 of the K-step.  Then the four lanes of a group read four consecutive rows
// (a 144-byte row stride puts them on distinct banks), and a lane needs bits g, g+8, g+16
// and g+24 of each word: one shift by 7 - g puts them at the top of bytes 0..3, and one
// sign-replicating prmt per register spreads a byte's top bit of two rows over the two bf16
// halves (0xFFFF or 0), which a multiply by -0x3F803F80 (mod 2^32) turns into 1.0 or 0.
// Per word and K-step a lane spends 4 shifts, 8 prmt and 8 multiplies on the 8 A registers
// of its two mma: 10 instructions an mma, 2.5 a register, besides the mma itself and the 2
// 16-byte shared loads a row of 8 words.  The card's integer logic pipe (shifts, prmt, and)
// and the FMA pipe (which also runs integer multiplies) take 2 warp instructions a clock on
// each SM apiece, half the issue rate, and with an and per register the logic pipe was the
// limit; so the mask is a multiply, and two of the four shifts are multiplies by 2^(7 - g):
// 10 of the 20 instructions go to each pipe.  Each word's code runs for every word of the
// warp, also past W (zeros there), with no branch, so that the compiler overlaps words.
//
// Why mma.sync and not wgmma, and this shape: on the H100 an mma.sync m16n8k16 holds an
// SM's issue for a few clocks, and the integer work of its operands does not overlap it, so
// the kernel is bound by issue (the mma plus ~12 instructions), not by bytes.  wgmma
// m64n8k16 with A in registers and B in shared memory (the same expansion, the B operand
// written by the splitting threads behind a proxy fence) was right but slower, also with
// two sets of A registers to overlap the products and with 128-row stages; 4 words a warp
// (80 registers, 6 blocks an SM) and 8 warps a block were slower too.  Those probes timed
// one call at SCI_1M on one card and are not kept in the repository.
//
// W grows with the versions (32 at 1,000 versions, 313 at 10,000), so nothing assumes
// 32 * W <= 1024: word groups are a grid dimension (at most 65,535 of them, W <= 2,097,120
// words; the launcher refuses more).  Rows past R, or past the block's chunk, are zero bits
// with zero values (the reference pads with zero rows to a multiple of BR).
//
// Bound: every bitmap word and value is read once, so the least time is (4 * R * W +
// 4 * R + 128 * W) bytes over the H100's 3.35 TB/s (SCI_1M: ~125 MB, ~37 us).  The design
// adds the partials, 4 * ceil(R / chunk_rows) * 32 * W bytes written and read once more
// (SCI_1M at 1,024 rows a chunk: 3.8 MB each way), and 2 * ceil(R / 16) * W mma of 4,096
// operations (3.78 M mma, 15.5 GFLOP, ~16 us at 989 TFLOP/s), and about 10 issued
// instructions an mma for the bits (~38 M warp instructions, ~40 us at 132 SMs x 4
// schedulers x 1.98 GHz).  chip_smoke.py prints this floor beside the kernel's time.  Plain
// C entry point, loaded with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMinBlocks = 4;                         // blocks an SM holds (128 registers)
constexpr int kWordsPerWarp = 8;
constexpr int kGroupWords = kWarps * kWordsPerWarp;   // 32 words, 1,024 versions a block
constexpr int kStageRows = 64;                        // 4 K-steps of 16 rows
constexpr int kKSteps = kStageRows / 16;
constexpr int kStages = 3;
constexpr int kLd = kGroupWords + 4;                  // row stride in words: 144 bytes
constexpr int kReduceWarps = 8;
// Sign-replicated halves (0xFFFF or 0) times this, mod 2^32, are bf16 1.0 (0x3F80) or 0:
// it is -0x3F803F80, so 0xFFFF * it == 0x3F80 and 0xFFFF0000 * it == 0x3F800000.
constexpr uint32_t kToOnes = 0xC07FC080u;

// A stage: the group's words of 64 rows, and the rows' values as the B fragments of its 4
// K-steps: b[ks][n][t] = {b0, b1} of the lanes 4n + t, column n (hi, mid, lo; 3..7 zero).
struct __align__(16) Stage {
  uint32_t words[kStageRows][kLd];
  uint2 b[kKSteps][8][4];
};

// Global -> shared without a register stop; an invalid source copies 0 bytes and fills
// the destination with zeros.
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
                 "r"(valid ? 16 : 0)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
                 "r"(valid ? 4 : 0)
                 : "memory");
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_one() {   // all but the newest group landed
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Rows [row0, row0 + 64) of the group's words into a stage; rows at or past row_end and
// words past W are zeros.
template <bool kVec>
__device__ __forceinline__ void load_words(Stage& st, const uint32_t* __restrict__ bitmap,
                                           int64_t row0, int64_t row_end, int n_words,
                                           int word0) {
  if constexpr (kVec) {
    constexpr int kPieces = kGroupWords / 4;
    for (int k = threadIdx.x; k < kStageRows * kPieces; k += kThreads) {
      const int i = k / kPieces;
      const int word = word0 + 4 * (k - i * kPieces);
      const bool ok = row0 + i < row_end && word < n_words;
      cp_async<16>(&st.words[i][word - word0],
                   ok ? bitmap + (row0 + i) * n_words + word : bitmap, ok);
    }
  } else {
    for (int k = threadIdx.x; k < kStageRows * kGroupWords; k += kThreads) {
      const int i = k / kGroupWords;
      const int word = word0 + k - i * kGroupWords;
      const bool ok = row0 + i < row_end && word < n_words;
      cp_async<4>(&st.words[i][word - word0],
                  ok ? bitmap + (row0 + i) * n_words + word : bitmap, ok);
    }
  }
}

// The value of row `row` (thread i < 64 of a stage reads row0 + i), 0 past row_end.
__device__ __forceinline__ float load_value(const float* __restrict__ values, int64_t row,
                                            int64_t row_end) {
  return row < row_end ? __ldg(values + row) : 0.f;
}

// Row i of a stage, of value v, into the stage's B fragments: the exact three-way split
// as bf16 bits, hi = v & 0xFFFF0000, mid = (v - hi) & 0xFFFF0000, lo = bf16(v - hi - mid);
// inf or NaN as (v, 0, 0), a NaN as the canonical one (a truncated payload could read inf).
// Row 16 ks + t + 4 q is K slot 2t + (q & 1) + 8 (q >> 1): half q & 1 of b[ks][n][t]'s
// word q >> 1.
__device__ __forceinline__ void store_split(Stage& st, int i, float v) {
  const uint32_t u = __float_as_uint(v);
  const bool finite = (u & 0x7F800000u) != 0x7F800000u;
  const float r = v - __uint_as_float(u & 0xFFFF0000u);
  const uint32_t mid = __float_as_uint(r) & 0xFFFF0000u;
  const uint32_t lo = __bfloat16_as_ushort(__float2bfloat16_rn(r - __uint_as_float(mid)));
  const uint32_t hi = finite || (u & 0x007FFFFFu) == 0u ? u >> 16 : 0x7FC0u;
  const int ks = i >> 4, t = i & 3, q = (i >> 2) & 3;
  uint16_t* b = reinterpret_cast<uint16_t*>(&st.b[ks][0][t]) + q;
  b[0] = static_cast<uint16_t>(hi);
  b[4 * 4] = static_cast<uint16_t>(finite ? mid >> 16 : 0u);        // b[ks][1][t]
  b[2 * 4 * 4] = static_cast<uint16_t>(finite ? lo : 0u);           // b[ks][2][t]
}

// a * b on the FMA pipe: written as PTX, so that the compiler does not turn a multiply by a
// power of two into a shift on the logic pipe.
__device__ __forceinline__ uint32_t mul_lo(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.lo.u32 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// The top bits of byte j of a (low half) and of b (high half), each spread over its 16 bits
// (prmt's sign-replicating mode), as two bf16 1.0 or 0 (a multiply on the FMA pipe, so the
// integer logic pipe issues only the prmt).
template <uint32_t kSel>
__device__ __forceinline__ uint32_t bits_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "n"(kSel));
  return mul_lo(d, kToOnes);
}

// c += a (16x16, row-major bf16) * b (16x8, col-major bf16), float32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One warp's 4 K-steps over a stage: its 8 words, 2 M-tiles a word.
__device__ __forceinline__ void compute_stage(const Stage& st, float (&acc)[kWordsPerWarp][2][4],
                                              int warp, int g, int t) {
  const uint32_t shift = 7u - g;
  const uint32_t scale = 1u << shift;   // the same shift as a multiply, on the FMA pipe
#pragma unroll
  for (int ks = 0; ks < kKSteps; ++ks) {
    const int row = 16 * ks + t;   // K slots 2t, 2t+1, 2t+8, 2t+9: rows +0, +4, +8, +12
    const uint2 b = st.b[ks][g][t];
    uint32_t x[4][kWordsPerWarp];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int h = 0; h < kWordsPerWarp; h += 4) {
        const uint4 w4 =
            *reinterpret_cast<const uint4*>(&st.words[row + 4 * i][kWordsPerWarp * warp + h]);
        x[i][h] = w4.x, x[i][h + 1] = w4.y, x[i][h + 2] = w4.z, x[i][h + 3] = w4.w;
      }
    }
    // Every word of the warp, also those past W: the stage holds zeros there, so their mma
    // add zeros, and their sums are not written.  One straight run of code lets the compiler
    // overlap one word's expansion with the last word's mma.
#pragma unroll
    for (int j = 0; j < kWordsPerWarp; ++j) {
      // bits g, 8 + g, 16 + g, 24 + g to the top of bytes 0..3
      const uint32_t y0 = x[0][j] << shift, y1 = x[1][j] << shift;
      const uint32_t y2 = mul_lo(x[2][j], scale), y3 = mul_lo(x[3][j], scale);
      // M-tile 0, versions g and g + 8 of the word: bytes 0 and 1
      const uint32_t a0[4] = {bits_bf16x2<0xCC88>(y0, y1), bits_bf16x2<0xDD99>(y0, y1),
                              bits_bf16x2<0xCC88>(y2, y3), bits_bf16x2<0xDD99>(y2, y3)};
      mma_bf16(acc[j][0], a0, b.x, b.y);
      // M-tile 1, versions 16 + g and 24 + g: bytes 2 and 3
      const uint32_t a1[4] = {bits_bf16x2<0xEEAA>(y0, y1), bits_bf16x2<0xFFBB>(y0, y1),
                              bits_bf16x2<0xEEAA>(y2, y3), bits_bf16x2<0xFFBB>(y2, y3)};
      mma_bf16(acc[j][1], a1, b.x, b.y);
    }
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
version_partials_kernel(const uint32_t* __restrict__ bitmap, const float* __restrict__ values,
                        float* __restrict__ partials, int64_t n_rows, int n_words,
                        int chunk_rows) {
  __shared__ Stage stages[kStages];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int word0 = blockIdx.y * kGroupWords;
  const int warp_word0 = word0 + kWordsPerWarp * warp;
  const int n_valid = n_words - warp_word0;   // the warp's words below W (<= 0: none)
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * chunk_rows;
  const int64_t row_end = row0 + chunk_rows < n_rows ? row0 + chunk_rows : n_rows;
  const int n_st = static_cast<int>((row_end - row0 + kStageRows - 1) / kStageRows);

  float acc[kWordsPerWarp][2][4];
#pragma unroll
  for (int j = 0; j < kWordsPerWarp; ++j)
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[j][m][k] = 0.f;
  // columns 3..7 of every B fragment stay zero
  for (int k = threadIdx.x; k < kStages * kKSteps * 5 * 4; k += kThreads) {
    const int t4 = k & 3, n = 3 + (k >> 2) % 5, rest = (k >> 2) / 5;
    stages[rest / kKSteps].b[rest % kKSteps][n][t4] = make_uint2(0u, 0u);
  }

  // The values go through registers one stage ahead of their split: thread i < 64 holds
  // row i of the next stage, splits it into that stage's slot one iteration before it is
  // read, and loads the row of the stage after.
  const bool splitter = threadIdx.x < kStageRows;
  load_words<kVec>(stages[0], bitmap, row0, row_end, n_words, word0);
  cp_async_commit();
  if (n_st > 1) load_words<kVec>(stages[1], bitmap, row0 + kStageRows, row_end, n_words, word0);
  cp_async_commit();
  float next = 0.f;
  if (splitter) {
    store_split(stages[0], threadIdx.x, load_value(values, row0 + threadIdx.x, row_end));
    next = load_value(values, row0 + kStageRows + threadIdx.x, row_end);
  }
  for (int s = 0; s < n_st; ++s) {
    cp_async_wait_one();   // stage s has landed (this thread's copies) ...
    __syncthreads();       // ... and everyone's; stage s - 1's slot is free again
    const int64_t ahead = row0 + static_cast<int64_t>(s + 2) * kStageRows;
    if (s + 2 < n_st) {
      load_words<kVec>(stages[(s + 2) % kStages], bitmap, ahead, row_end, n_words, word0);
    }
    cp_async_commit();     // an empty group keeps the count
    if (splitter && s + 1 < n_st) {   // read after the next barrier
      store_split(stages[(s + 1) % kStages], threadIdx.x, next);
      next = load_value(values, ahead + threadIdx.x, row_end);
    }
    if (n_valid > 0) compute_stage(stages[s % kStages], acc, warp, g, t);
  }

  // C fragment: c[0], c[1] = columns 2t, 2t+1 of version g; c[2], c[3] of version g + 8.
  // Lane t = 0 holds hi and mid, lane t = 1 lo.
  float* out = partials + static_cast<int64_t>(blockIdx.x) * 32 * n_words;
#pragma unroll
  for (int j = 0; j < kWordsPerWarp; ++j) {
    if (j >= n_valid) break;   // warp-uniform
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const float* c = acc[j][m];
      const float lo_g = __shfl_down_sync(0xffffffffu, c[0], 1);
      const float lo_g8 = __shfl_down_sync(0xffffffffu, c[2], 1);
      if (t == 0) {
        const int v = 32 * (warp_word0 + j) + 16 * m + g;
        out[v] = (c[0] + c[1]) + lo_g;
        out[v + 8] = (c[2] + c[3]) + lo_g8;
      }
    }
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

// The bitmap kernels' binding: bitmap, values, two outputs (partials of
// ceil(R / chunk_rows) * 32 * W floats, then the 32 * W sums), R, W, then in the BR slot the
// rows of a chunk (a positive multiple of 64, chosen by the wrapper), vid (unused here) and
// the stream; returns a cudaError_t (0 on success).
extern "C" int version_aggregate_launch(const void* bitmap, const void* values,
                                        void* partials, void* out, long long n_rows,
                                        int n_words, int chunk_rows, int /*vid*/,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_words <= 0 || chunk_rows <= 0 || chunk_rows % kStageRows != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long n_versions = 32LL * n_words;
  if (n_rows <= 0) {   // no rows: every sum is 0, and a grid of 0 blocks would be refused
    return static_cast<int>(cudaMemsetAsync(out, 0, 4 * n_versions, s));
  }
  const long long n_chunks = (n_rows + chunk_rows - 1) / chunk_rows;
  const long long n_groups = (n_words + kGroupWords - 1) / kGroupWords;
  if (n_chunks > 0x7fffffffLL || n_groups > 65535 || n_versions > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>(n_chunks), static_cast<unsigned>(n_groups));
  const auto* bits = static_cast<const uint32_t*>(bitmap);
  const auto* vals = static_cast<const float*>(values);
  auto* parts = static_cast<float*>(partials);
  if (n_words % 4 == 0 && reinterpret_cast<uintptr_t>(bitmap) % 16 == 0) {
    version_partials_kernel<true><<<grid, kThreads, 0, s>>>(bits, vals, parts, n_rows,
                                                             n_words, chunk_rows);
  } else {
    version_partials_kernel<false><<<grid, kThreads, 0, s>>>(bits, vals, parts, n_rows,
                                                              n_words, chunk_rows);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  version_reduce_kernel<<<static_cast<unsigned>(n_words), 32 * kReduceWarps, 0, s>>>(
      static_cast<const float*>(partials), static_cast<float*>(out),
      static_cast<int>(n_chunks), static_cast<int>(n_versions));
  return static_cast<int>(cudaGetLastError());
}

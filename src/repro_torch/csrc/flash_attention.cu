// flash_attention — attention forward without the (Sq, Sk) matrix in device memory,
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::flash_attention_fwd
// (kernel body _flash_fwd_kernel).  For q (B, Sq, H, Dh) and k, v (B, Sk, Hkv, Dh), float32 or
// bfloat16, with query head h reading kv head h / (H / Hkv):
//
//   out[b, i, h] = sum_j softmax_j(q[b, i, h] . k[b, j, hk] / sqrt(Dh), causal: j <= i) v[b, j, hk]
//
// in float32 inside, the output in the operands' dtype.
//
// The TPU kernel walks a (B*H, Sq/BQ, Sk/BK) grid whose trailing key axis runs in order, so
// its VMEM scratch (acc, row max m, row sum l) carries from one key tile to the next.  Hopper
// blocks run in no order, so here one block (4 warps) owns one (batch*head, 64-row query tile)
// and loops over the 64-row key tiles itself, the online-softmax state on chip.  With `causal`
// the loop stops at the tile holding the diagonal, and the query tiles are issued
// longest-first, so the short causal rows fill the tail of the grid.  Scores outside the mask
// are -1e30 (NEG_INF) and a zero row sum divides by 1, as in the TPU kernel.  The kernel reads
// q, k and v in their (B, S, H, Dh) layout through row strides: no transposed copy is made.
// Sq and Sk are any positive lengths (the TPU kernel takes multiples of its 128-row tiles):
// rows past Sq or Sk load as zeros, keys past Sk are masked, rows past Sq are not written.
// Dh is a runtime value up to 256, zero-padded to the instance's width.  Two instances by
// dtype:
//   * bfloat16 (the model's path): flash_fwd_mma_kernel, both products on the tensor cores
//     (mma.sync m16n8k16, float32 accumulators), everything per warp in registers.  The TPU
//     kernel multiplies float32 probabilities by V; a bf16 mma takes bf16 operands, so each
//     probability goes in as the pair hi = bf16(p), lo = bf16(p - hi) (two mma for P V, 16
//     significant bits of p, relative error at most 2^-17), not rounded to 8 bits.
//   * float32: flash_fwd_kernel, float32 FMAs on the CUDA cores with the score tile in
//     shared memory and the probabilities kept in float32, so float32 callers keep float32
//     accuracy (the reference's 2e-5).
//
// Bound: the bytes are q, k, v and out read or written once; the operations are
// 4 * B * H * Dh (two products) times the (query, key) pairs the mask keeps (Sq * Sk, or
// S (S + 1) / 2 causal), at the card's rate for the operands' type (bf16: 989 TFLOP/s dense
// on the tensor cores).  At Zamba2-2.7B's attention with B = 4, S = 4096, H = Hkv = 32,
// Dh = 80 in bf16: 336 MB (0.10 ms at 3.35 TB/s) and 344 GFLOP (0.35 ms): bound by
// operations.  The hi + lo split issues P V twice, so the bf16 kernel does 1.5x the
// function's product work, and mma.sync reaches a fraction of that rate (wgmma
// is the instruction that reaches all of it), and this kernel stages each key tile through
// shared memory with plain loads and a barrier, with no copy in flight during the products;
// TMA, wgmma and a pipelined ring of tiles are later work.  Plain C entry point, loaded with
// ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <math.h>

namespace {

constexpr int kBQ = 64;                 // query rows of a block
constexpr int kBK = 64;                 // key rows of a tile
constexpr int kThreads = 128;           // thread (ty, tx): ty = tid / 8 (16), tx = tid % 8
constexpr int kLP = kBK + 1;            // row stride of the score tile
constexpr float kNegInf = -1e30f;

// Rows [row0, row0 + kRows) of one head, `row_stride` elements apart, into a float32 tile of
// row stride `ld`; rows at or past n_rows load as zeros.
template <int kRows>
__device__ __forceinline__ void load_tile(float* tile, int ld, const float* base,
                                          int64_t row_stride, int row0, int n_rows,
                                          int dh) {
  for (int i = threadIdx.x; i < kRows * dh; i += kThreads) {
    const int r = i / dh;
    const int d = i - r * dh;
    float x = 0.f;
    if (row0 + r < n_rows) x = base[static_cast<int64_t>(row0 + r) * row_stride + d];
    tile[r * ld + d] = x;
  }
}

template <int DMAX>
constexpr size_t smem_bytes() {
  return sizeof(float) * (static_cast<size_t>(kBQ + 2 * kBK) * (DMAX + 1) + kBQ * kLP +
                          3 * kBQ);
}

template <int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out, int sq, int sk, int n_heads, int n_kv, int dh,
                 int causal, float scale) {
  constexpr int LD = DMAX + 1;          // odd: the rows of a tile fall in distinct banks
  constexpr int NJ = DMAX / 8;          // output columns a thread owns: tx + 8 j
  extern __shared__ float smem[];
  float* sQ = smem;                     // kBQ x LD
  float* sK = sQ + kBQ * LD;            // kBK x LD
  float* sV = sK + kBK * LD;            // kBK x LD
  float* sP = sV + kBK * LD;            // kBQ x kLP: scores, then probabilities
  float* sCorr = sP + kBQ * kLP;        // kBQ: exp(m_prev - m_new) of this tile
  float* sL = sCorr + kBQ;              // kBQ: running row sums
  float* sM = sL + kBQ;                 // kBQ: running row maxima

  const int n_qt = (sq + kBQ - 1) / kBQ;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x)) * kBQ;   // longest rows first
  const int b = blockIdx.y / n_heads;
  const int h = blockIdx.y - b * n_heads;
  const int hk = h / (n_heads / n_kv);
  const int tid = threadIdx.x;
  const int ty = tid >> 3;
  const int tx = tid & 7;

  const int64_t q_rs = static_cast<int64_t>(n_heads) * dh;
  const int64_t kv_rs = static_cast<int64_t>(n_kv) * dh;
  const float* qb = q + (static_cast<int64_t>(b) * sq * n_heads + h) * dh;
  const float* kb = k + (static_cast<int64_t>(b) * sk * n_kv + hk) * dh;
  const float* vb = v + (static_cast<int64_t>(b) * sk * n_kv + hk) * dh;

  load_tile<kBQ>(sQ, LD, qb, q_rs, q0, sq, dh);
  if (tid < kBQ) {
    sM[tid] = kNegInf;
    sL[tid] = 0.f;
  }

  float acc[4][NJ];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[a][j] = 0.f;

  const int k_end = causal ? min(sk, q0 + kBQ) : sk;
  const int n_kt = (k_end + kBK - 1) / kBK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();                    // the last tile's readers are done
    load_tile<kBK>(sK, LD, kb, kv_rs, k0, sk, dh);
    load_tile<kBK>(sV, LD, vb, kv_rs, k0, sk, dh);
    __syncthreads();

    // S = Q K^T * scale: thread (ty, tx) owns rows ty + 16 a and key columns tx + 8 c
    float s[4][8];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 8; ++c) s[a][c] = 0.f;
    for (int d = 0; d < dh; ++d) {
      float qa[4], kc[8];
#pragma unroll
      for (int a = 0; a < 4; ++a) qa[a] = sQ[(ty + 16 * a) * LD + d];
#pragma unroll
      for (int c = 0; c < 8; ++c) kc[c] = sK[(tx + 8 * c) * LD + d];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 8; ++c) s[a][c] = fmaf(qa[a], kc[c], s[a][c]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int r = ty + 16 * a;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int col = k0 + tx + 8 * c;
        float x = s[a][c] * scale;
        if (col >= sk || (causal && col > q0 + r)) x = kNegInf;
        sP[r * kLP + tx + 8 * c] = x;
      }
    }
    __syncthreads();

    // online softmax: threads 2r and 2r+1 take the two halves of row r
    {
      const int r = tid >> 1;
      float* row = sP + r * kLP + (tid & 1) * (kBK / 2);
      float mx = kNegInf;
      for (int c = 0; c < kBK / 2; ++c) mx = fmaxf(mx, row[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float m_prev = sM[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = 0; c < kBK / 2; ++c) {
        const float p = expf(row[c] - m_new);
        row[c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      if ((tid & 1) == 0) {
        const float corr = expf(m_prev - m_new);
        sCorr[r] = corr;
        sL[r] = corr * sL[r] + sum;
        sM[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + P V: thread (ty, tx) owns rows ty + 16 a and columns tx + 8 j
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float corr = sCorr[ty + 16 * a];
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[a][j] *= corr;
    }
    for (int c = 0; c < kBK; ++c) {
      float pa[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) pa[a] = sP[(ty + 16 * a) * kLP + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        if (tx + 8 * j < dh) {
          const float vv = sV[c * LD + tx + 8 * j];
#pragma unroll
          for (int a = 0; a < 4; ++a) acc[a][j] = fmaf(pa[a], vv, acc[a][j]);
        }
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = ty + 16 * a;
    if (q0 + r >= sq) continue;
    const float l = sL[r];
    const float safe = l == 0.f ? 1.f : l;
    float* orow = out + ((static_cast<int64_t>(b) * sq + q0 + r) * n_heads + h) * dh;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 8 * j;
      if (d < dh) orow[d] = acc[a][j] / safe;
    }
  }
}

// One m16n8k16 tensor-core product: c += a (16x16, row-major bf16) * b (16x8, col-major bf16),
// float32 accumulators (mma.sync; the fragment layouts are the PTX ISA's).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two float32 values as two packed bf16 pairs: hi = bf16(x), lo = bf16(x - hi), so that
// hi + lo carries 16 significant bits of x (relative error at most 2^-17).
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int DP>
constexpr size_t mma_smem_bytes() {
  return sizeof(__nv_bfloat16) *
         (static_cast<size_t>(kBQ + kBK) * (DP + 8) + static_cast<size_t>(DP) * (kBK + 8));
}

// The bfloat16 kernel: the same blocks and loop as flash_fwd_kernel, with both products on the
// tensor cores (mma.sync m16n8k16, float32 accumulators).  Each of the 4 warps owns 16 query
// rows; its scores, probabilities, row max and sum and output stay in registers in the mma
// fragment layout, so no score tile goes through shared memory.  The probabilities enter
// P V as the hi + lo pair of bf16 A operands (split_bf16), the row sums taken in float32.
// Q and K are staged in shared memory as bf16 rows padded to DP
// (a multiple of 16, zeros past Dh) plus 8, V transposed (DP x (64 + 8)); the pads put the 8
// rows a fragment load touches in distinct banks.
template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                     int sq, int sk, int n_heads, int n_kv, int dh, int causal, float scale) {
  constexpr int LQ = DP + 8;            // row stride of the Q and K tiles
  constexpr int LV = kBK + 8;           // row stride of the transposed V tile
  constexpr int NT = DP / 8;            // output column tiles of 8
  constexpr int KS = DP / 16;           // k steps over the head dim
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // kBQ x LQ
  __nv_bfloat16* sK = sQ + kBQ * LQ;                                 // kBK x LQ
  __nv_bfloat16* sVt = sK + kBK * LQ;                                // DP x LV
  const __nv_bfloat16 zero = __float2bfloat16(0.f);

  const int n_qt = (sq + kBQ - 1) / kBQ;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x)) * kBQ;   // longest rows first
  const int b = blockIdx.y / n_heads;
  const int h = blockIdx.y - b * n_heads;
  const int hk = h / (n_heads / n_kv);
  const int tid = threadIdx.x;
  const int wr = (tid >> 5) * 16;       // the warp's first row in the tile
  const int gid = (tid & 31) >> 2;      // fragment row (and row + 8)
  const int tig = tid & 3;              // fragment column pair

  const int64_t q_rs = static_cast<int64_t>(n_heads) * dh;
  const int64_t kv_rs = static_cast<int64_t>(n_kv) * dh;
  const __nv_bfloat16* qb = q + (static_cast<int64_t>(b) * sq * n_heads + h) * dh;
  const __nv_bfloat16* kb = k + (static_cast<int64_t>(b) * sk * n_kv + hk) * dh;
  const __nv_bfloat16* vb = v + (static_cast<int64_t>(b) * sk * n_kv + hk) * dh;

  for (int i = tid; i < kBQ * DP; i += kThreads) {
    const int r = i / DP;
    const int d = i - r * DP;
    sQ[r * LQ + d] = (q0 + r < sq && d < dh) ? qb[(q0 + r) * q_rs + d] : zero;
  }

  float o[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};

  const int k_end = causal ? min(sk, q0 + kBQ) : sk;
  const int n_kt = (k_end + kBK - 1) / kBK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();                    // the last tile's readers are done
    for (int i = tid; i < kBK * DP; i += kThreads) {
      const int r = i / DP;
      const int d = i - r * DP;
      const bool in = k0 + r < sk && d < dh;
      sK[r * LQ + d] = in ? kb[(k0 + r) * kv_rs + d] : zero;
      sVt[d * LV + r] = in ? vb[(k0 + r) * kv_rs + d] : zero;
    }
    __syncthreads();

    // S = Q K^T: 16 rows x 64 keys a warp, 8 column tiles of 8
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const __nv_bfloat16* qa = sQ + (wr + gid) * LQ + kk * 16 + tig * 2;
      const uint32_t a[4] = {ld32(qa), ld32(qa + 8 * LQ), ld32(qa + 8), ld32(qa + 8 * LQ + 8)};
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const __nv_bfloat16* kp = sK + (nt * 8 + gid) * LQ + kk * 16 + tig * 2;
        mma_bf16(s[nt], a, ld32(kp), ld32(kp + 8));
      }
    }

    // scale and mask; element e of column tile nt is row gid (+8 for e >= 2), column
    // nt * 8 + tig * 2 (+1 for odd e)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = q0 + wr + gid + (e >> 1) * 8;
        const int col = k0 + nt * 8 + tig * 2 + (e & 1);
        const float x = s[nt][e] * scale;
        s[nt][e] = (col >= sk || (causal && col > row)) ? kNegInf : x;
      }
    }

    // online softmax; the 4 threads of a fragment row hold its 64 columns
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = kNegInf;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) mx = fmaxf(mx, fmaxf(s[nt][2 * r], s[nt][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      const float corr = expf(m[r] - m_new);
      m[r] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          const float p = expf(s[nt][e] - m_new);
          s[nt][e] = p;
          sum += p;
        }
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[r] = l[r] * corr + sum;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        o[j][2 * r] *= corr;
        o[j][2 * r + 1] *= corr;
      }
    }

    // O += P V: the score fragments of column tiles 2 kk and 2 kk + 1 are the A fragment of
    // key step kk, as the pair hi + lo so that P keeps 16 significant bits
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t hi[4], lo[4];
      split_bf16(s[2 * kk][0], s[2 * kk][1], hi[0], lo[0]);
      split_bf16(s[2 * kk][2], s[2 * kk][3], hi[1], lo[1]);
      split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], hi[2], lo[2]);
      split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], hi[3], lo[3]);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const __nv_bfloat16* vp = sVt + (j * 8 + gid) * LV + kk * 16 + tig * 2;
        const uint32_t b0 = ld32(vp), b1 = ld32(vp + 8);
        mma_bf16(o[j], hi, b0, b1);
        mma_bf16(o[j], lo, b0, b1);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + wr + gid + 8 * r;
    if (row >= sq) continue;
    const float safe = l[r] == 0.f ? 1.f : l[r];
    __nv_bfloat16* orow = out + ((static_cast<int64_t>(b) * sq + row) * n_heads + h) * dh;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int d = j * 8 + tig * 2;
      if (d < dh) orow[d] = __float2bfloat16(o[j][2 * r] / safe);
      if (d + 1 < dh) orow[d + 1] = __float2bfloat16(o[j][2 * r + 1] / safe);
    }
  }
}

template <int DP>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* out, int batch,
                       int sq, int sk, int n_heads, int n_kv, int dh, int causal,
                       cudaStream_t stream) {
  constexpr size_t smem = mma_smem_bytes<DP>();
  auto kernel = flash_fwd_mma_kernel<DP>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(dh)));
  const dim3 grid((sq + kBQ - 1) / kBQ, batch * n_heads);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), sq, sk, n_heads,
      n_kv, dh, causal, scale);
  return cudaGetLastError();
}

cudaError_t dispatch_mma(const void* q, const void* k, const void* v, void* out, int batch,
                         int sq, int sk, int n_heads, int n_kv, int dh, int causal,
                         cudaStream_t s) {
  if (dh <= 16) return launch_mma<16>(q, k, v, out, batch, sq, sk, n_heads, n_kv, dh, causal, s);
  if (dh <= 32) return launch_mma<32>(q, k, v, out, batch, sq, sk, n_heads, n_kv, dh, causal, s);
  if (dh <= 64) return launch_mma<64>(q, k, v, out, batch, sq, sk, n_heads, n_kv, dh, causal, s);
  if (dh <= 80) return launch_mma<80>(q, k, v, out, batch, sq, sk, n_heads, n_kv, dh, causal, s);
  if (dh <= 128) {
    return launch_mma<128>(q, k, v, out, batch, sq, sk, n_heads, n_kv, dh, causal, s);
  }
  return launch_mma<256>(q, k, v, out, batch, sq, sk, n_heads, n_kv, dh, causal, s);
}

template <int DMAX>
cudaError_t launch_fma(const void* q, const void* k, const void* v, void* out, int batch,
                       int sq, int sk, int n_heads, int n_kv, int dh, int causal,
                       cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DMAX>();
  auto kernel = flash_fwd_kernel<DMAX>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(dh)));
  const dim3 grid((sq + kBQ - 1) / kBQ, batch * n_heads);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), sq, sk, n_heads, n_kv, dh, causal, scale);
  return cudaGetLastError();
}

cudaError_t dispatch_fma(const void* q, const void* k, const void* v, void* out, int batch,
                         int sq, int sk, int n_heads, int n_kv, int dh, int causal,
                         cudaStream_t s) {
  if (dh <= 32) return launch_fma<32>(q, k, v, out, batch, sq, sk, n_heads, n_kv, dh, causal, s);
  if (dh <= 64) return launch_fma<64>(q, k, v, out, batch, sq, sk, n_heads, n_kv, dh, causal, s);
  if (dh <= 128) {
    return launch_fma<128>(q, k, v, out, batch, sq, sk, n_heads, n_kv, dh, causal, s);
  }
  return launch_fma<256>(q, k, v, out, batch, sq, sk, n_heads, n_kv, dh, causal, s);
}

}  // namespace

// The flash binding: q, k, v, out, B, Sq, Sk, H, Hkv, Dh, causal, dtype (0 float32,
// 1 bfloat16) and the stream; returns a cudaError_t (0 on success).  Refuses what the
// wrapper refuses (a non-positive dim, H not a multiple of Hkv, Dh > 256) and a grid past
// the card's limits.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      int batch, int sq, int sk, int n_heads, int n_kv,
                                      int dh, int causal, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch <= 0 || sq <= 0 || sk <= 0 || n_heads <= 0 || n_kv <= 0 || dh <= 0 ||
      dh > 256 || n_heads % n_kv != 0 ||
      static_cast<long long>(batch) * n_heads > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 0) {
    return static_cast<int>(
        dispatch_fma(q, k, v, out, batch, sq, sk, n_heads, n_kv, dh, causal, s));
  }
  if (dtype == 1) {
    return static_cast<int>(
        dispatch_mma(q, k, v, out, batch, sq, sk, n_heads, n_kv, dh, causal, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

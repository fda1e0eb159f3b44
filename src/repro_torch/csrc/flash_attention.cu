// flash_attention — attention forward without the (Sq, Sk) matrix in device memory,
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::flash_attention_fwd
// (kernel body _flash_fwd_kernel).  For q (B, Sq, H, Dqk), k (B, Sk, Hkv, Dqk) and
// v (B, Sk, Hkv, Dv), Dv <= Dqk, float32 or bfloat16, with query head h reading kv head
// h / (H / Hkv):
//
//   out[b, i, h] = sum_j softmax_j(q[b, i, h] . k[b, j, hk] / sqrt(Dqk), causal: j <= i) v[b, j, hk]
//
// in float32 inside, the output (B, Sq, H, Dv) in the operands' dtype.  The TPU kernel takes
// one head dim; a v narrower than q is what latent attention computes (DeepSeek-V2: q.k width
// 128 + 64, v width 128), which the TPU kernel gets by zero-padding v.
//
// The TPU kernel walks a (B*H, Sq/BQ, Sk/BK) grid whose trailing key axis runs in order, so
// its VMEM scratch (acc, row max m, row sum l) carries from one key tile to the next.  Hopper
// blocks run in no order, so here one block owns one (batch*head, query tile) and loops over
// the key tiles itself, the online-softmax state on chip.  With `causal` the loop stops at the
// tile holding the diagonal, and the query tiles are issued longest-first, so the short causal
// rows fill the tail of the grid.  Scores outside the mask are -1e30 (NEG_INF) and a zero row
// sum divides by 1, as in the TPU kernel.  The kernels read q, k and v in their (B, S, H, D)
// layout: no transposed copy is made, and the wgmma instance reads v's rows at a pitch past Dv
// (v_ld: the view kv[..., dn:] of latent attention's expanded K/V is read in place; the other
// instances take v contiguous).  Sq and Sk are any
// positive lengths (the TPU kernel takes multiples of its 128-row tiles): rows past Sq or Sk
// load as zeros, keys past Sk are masked, rows past Sq are not written.  Three instances,
// chosen by dtype and the two widths alone (the rule is instance_of, which the wrapper also
// reads; for any other Dv < Dqk the wrapper zero-pads v to Dqk and runs (Dqk, Dqk)):
//   * bfloat16 with (Dqk, Dv) = (Dh, Dh), Dh a multiple of 16 up to 128 (Zamba2 80,
//     InternLM2 128), or (192, 128) (DeepSeek-V2-Lite's latent attention):
//     flash_fwd_wgmma_kernel.  TMA needs q, k and v 16-byte aligned (v's row pitch too); the
//     wrapper copies a view that starts off a 16-byte boundary, and the tensor map refuses
//     one that reaches the entry point (cudaErrorInvalidValue).  A block owns 128 query rows,
//     two consumer warpgroups of 64 and one producer warp that keeps K and V tiles in
//     flight by TMA (cp.async.bulk.tensor, 4-D maps over (D, heads, seq, batch), so rows past
//     the sequence are zeros) in a ring on mbarriers of 128-key tiles: 3 slots for Dqk <= 128;
//     at (192, 128) the Q tile is 48 KB and a slot 48 + 32 KB, so 2 slots (208 KB; 64-key
//     tiles in 3 slots, 168 KB, measured no faster).  S = Q K^T is wgmma m64n128k16 from
//     shared memory; P V is wgmma with P in registers (the S accumulators convert in place to
//     A fragments) and V in its (key, d) layout through the descriptor's transpose.  The
//     softmax runs in the log2 domain (ex2.approx, log2e folded in the scale 1/sqrt(Dqk)) and
//     masks only the tiles that cross the diagonal or Sk.  Rows of 80 or 192 columns are
//     wider than the 128-byte swizzle span.  For Q K^T (K = Dqk) the head dim is cut into
//     pieces a span wide (64 + 16 for 80: a 128B-swizzled box and a 32B-swizzled box, each
//     with its own tensor map and descriptors; 64 + 64 + 64 for 192), not padded (to 128 that
//     would cost 1.6x the Q K^T work at 80; to 256, 1.33x at 192).  For P V (N = Dv) V lands
//     as 64-column atoms, 128B-swizzled, the last one zero-filled by TMA past Dv (columns
//     80-127 at Dv 80: smem, not products), so one wgmma m64n{Dv}k16 covers the head dim (one
//     instruction per piece measured 9% slower).  The O accumulators are Dv wide: at
//     (192, 128) a thread holds the registers of the (128, 128) instance.
//   * bfloat16 otherwise (Dh not a multiple of 16, or Dh past 128, Dv = Dqk):
//     flash_fwd_mma_kernel, 64-row tiles with both products on mma.sync m16n8k16.
//   * float32 (Dv = Dqk): flash_fwd_kernel, float32 FMAs on the CUDA cores with the score tile
//     in shared memory, so float32 callers keep float32 accuracy (the reference's 2e-5).
// The TPU kernel multiplies float32 probabilities by V; a bf16 product takes bf16 operands,
// so both bf16 instances feed each probability as a pair of bf16 terms hi + lo (two
// products for P V, 16 significant bits of p), not rounded to 8 bits: hi = bf16(p) and
// lo = bf16(p - hi) (split_bf16, relative error at most 2^-17) in both.
//
// Bound: the bytes are q, k, v and out read or written once; the operations are
// 2 * B * H * (Dqk + Dv) (two products) times the (query, key) pairs the mask keeps (Sq * Sk,
// or S (S + 1) / 2 causal), at the card's rate for the operands' type (bf16: 989 TFLOP/s
// dense on the tensor cores).  At Zamba2-2.7B's attention with B = 4, S = 4096, H = Hkv = 32,
// Dh = 80 in bf16: 336 MB (0.10 ms at 3.35 TB/s) and 344 GFLOP (0.35 ms): bound by
// operations.  At DeepSeek-V2-Lite's prefill (B = 4, S = 512, H = Hkv = 16, (192, 128)):
// 41.9 MB (0.0125 ms) and 5.38 GFLOP (0.0054 ms): bound by bytes.  The hi + lo split issues
// P V twice (2 * B * H * (Dqk + 2 Dv) * pairs, a floor of 0.52 ms at Zamba2), and whole tiles
// on the diagonal add the masked half of each.  This design keeps the loads off the
// consumers' path (TMA, up to three tiles ahead) but runs each warpgroup's products and its
// softmax one after the other; overlapping them within a warpgroup (two S tiles in flight)
// needs registers past the 168 a thread this block gets, and making the two warpgroups take
// strict turns (FA3's ping-pong, with a producer warpgroup and setmaxnreg) measured only 2%
// faster.  Given a float32 lse buffer, the wgmma instance also writes each row's logsumexp
// from its final row max and sum, the backward's input (csrc/flash_backward.cu); null writes
// nothing, so the serving forward's work is as before.  The Hopper helpers it shares with the
// backward (TMA, mbarriers, descriptors, wgmma) live in csrc/flash_wgmma.cuh.  Plain C entry
// point, loaded with ctypes.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <math.h>

#include "flash_wgmma.cuh"

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

// ---- bfloat16 wgmma + TMA with a pipelined K/V ring: (Dh, Dh) for Dh a multiple of 16 up to
// 128, and (192, 128), latent attention's q.k and v widths ----

namespace wg {

constexpr int kRows = 128;              // query rows of a block
constexpr int kKeys = 128;              // key rows of a K/V tile
constexpr int kConsumers = 256;         // two consumer warpgroups of 64 query rows each
constexpr int kThreads = kConsumers + 32;   // + one producer warp

// The tiles of the (DQK, DV) instance.  Q and K are cut into the pieces of DQK, which lie one
// after another in a tile (a piece of `rows` rows takes rows * 2 * width bytes).  V lands as
// atoms a swizzle span wide (the last one zero-filled past DV), so that one wgmma of width DV
// reads all of them through the descriptor's leading offset; DV also sets the O accumulators
// and the output's columns.
template <int DQK, int DV>
struct Tiles {
  using QK = Pieces<DQK>;
  static constexpr int stages = DQK > 128 ? 2 : 3;   // K/V tiles in flight
  static_assert(DV % 16 == 0 && DV <= 128 && DV <= DQK, "DV a multiple of 16 up to 128");
  static constexpr uint32_t q_bytes = kRows * 2 * DQK;
  static constexpr uint32_t k_bytes = kKeys * 2 * DQK;
  __host__ __device__ static constexpr uint32_t q_offset(int p) {
    return static_cast<uint32_t>(kRows * 2 * QK::col(p));
  }
  __host__ __device__ static constexpr uint32_t k_offset(int p) {
    return static_cast<uint32_t>(kKeys * 2 * QK::col(p));
  }
  static constexpr int v_atom = DV >= 64 ? 64 : (DV >= 32 ? 32 : 16);
  static constexpr int v_atoms = (DV + v_atom - 1) / v_atom;
  static constexpr uint32_t v_atom_bytes = kKeys * 2 * v_atom;
  static constexpr uint32_t v_bytes = v_atom_bytes * v_atoms;
  static constexpr uint32_t slot_bytes = k_bytes + v_bytes;
  // 1024 for aligning the swizzled tiles, Q, the ring, then full[s], empty[s] and Q's barrier
  static constexpr size_t smem = 1024 + q_bytes + static_cast<size_t>(slot_bytes) * stages +
                                 8 * (2 * stages + 1);
  static_assert(smem <= kMaxSmem, "the tiles must fit a block's shared memory");
};

// Tensor maps, 4-D over (Dh, heads, seq, batch), whose box is (width, 1, 128, 1): rows past the
// sequence and columns past Dh come in as zeros.  One map for each head-dim piece of q and k,
// and one for the V atoms (v_atom wide).
struct Maps {
  CUtensorMap q[3];
  CUtensorMap k[3];
  CUtensorMap v;
};

// The bfloat16 wgmma kernel of q.k width DQK and v width DV.  A block owns 128 query rows of one
// (batch, head): warps 0-7 are two consumer warpgroups of 64 rows, warp 8 the producer, whose
// one thread loads Q once and keeps K and V tiles of kKeys rows in flight by TMA in a
// ring of Tiles::stages slots (a full and an empty mbarrier each).  Per K/V tile each consumer
// warpgroup
//   * forms S = Q K^T with wgmma m64n128k16 from shared memory (DQK / 16 k steps over the
//     pieces of DQK),
//   * runs the online softmax in registers in the log2 domain (ex2.approx, log2e folded
//     into the scale), masking only a tile that crosses the diagonal or Sk,
//   * converts the S accumulators in place into A fragments, each probability as the pair
//     hi = bf16(p), lo = bf16(p - hi) (split_bf16), and adds P V with two wgmma of
//     width DV (A from registers) per 16 keys, V read in its natural (key, d) layout through
//     the descriptor's transpose, in swizzle atoms v_atom columns wide that the descriptor's
//     leading offset joins,
//   * and releases the slot.  Rows past Sq are computed on zeros and not written.
// With `lse` non-null it also writes each row's natural-log logsumexp, (m + log2 l) ln 2 from
// the final row max m and sum l, at lse[(b H + h) lse_pitch(Sq) + row], for the backward
// (csrc/flash_backward.cu); null writes nothing.
template <int DQK, int DV>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ Maps maps, __nv_bfloat16* __restrict__ out,
                       float* __restrict__ lse, int sq, int sk, int n_heads, int n_kv,
                       int causal, float scale_log2) {
  using T = Tiles<DQK, DV>;
  using QK = typename T::QK;
  constexpr int kStages = T::stages;
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  const uint32_t raw = smem_u32(wg_smem);
  const uint32_t base = (raw + 1023u) & ~1023u;   // swizzled tiles sit on 1024-byte bounds
  const uint32_t sQ = base;
  const uint32_t bars = base + T::q_bytes + T::slot_bytes * kStages;
  // slot s: K at sQ + q_bytes + s slot_bytes, V right after; full[s], empty[s], then the Q
  // barrier
  auto k_slot = [&](int s) { return sQ + T::q_bytes + s * T::slot_bytes; };
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (kStages + s); };
  const uint32_t qbar = bars + 8u * 2 * kStages;

  const int n_qt = (sq + kRows - 1) / kRows;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x)) * kRows;   // longest rows first
  const int b = blockIdx.y / n_heads;
  const int h = blockIdx.y - b * n_heads;
  const int hk = h / (n_heads / n_kv);
  const int k_end = causal ? min(sk, q0 + kRows) : sk;
  const int n_kt = (k_end + kKeys - 1) / kKeys;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumers);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {              // the producer warp
    if (tid == kConsumers) {
      mbar_expect_tx(qbar, T::q_bytes);
#pragma unroll
      for (int p = 0; p < QK::count; ++p) {
        tma_load(sQ + T::q_offset(p), &maps.q[p], QK::col(p), h, q0, b, qbar);
      }
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % kStages;
        mbar_wait(empty(s), ((kt / kStages) & 1) ^ 1);
        mbar_expect_tx(full(s), T::slot_bytes);
        const uint32_t sk_ = k_slot(s);
#pragma unroll
        for (int p = 0; p < QK::count; ++p) {
          tma_load(sk_ + T::k_offset(p), &maps.k[p], QK::col(p), hk, kt * kKeys, b, full(s));
        }
#pragma unroll
        for (int t = 0; t < T::v_atoms; ++t) {
          tma_load(sk_ + T::k_bytes + t * T::v_atom_bytes, &maps.v, t * T::v_atom, hk,
                   kt * kKeys, b, full(s));
        }
      }
    }
    return;
  }

  const int wgi = tid >> 7;             // consumer warpgroup: query rows 64 wgi ..
  const int lane = tid & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int row0 = q0 + wgi * 64 + ((tid & 127) >> 5) * 16 + gid;   // and row0 + 8
  const int wg_first = q0 + wgi * 64;

  float o[DV / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};

  // The two consumer warpgroups run independently on the same K/V slots; while one does its
  // softmax the other's products can run.  (Making them take strict turns on named barriers,
  // as FA3 does, measured slower here: it needs registers past this block's 168.)
  float sc[kKeys / 2];
  auto qk = [&](int kt) {               // S = Q K_kt^T: 64 rows x kKeys keys a warpgroup
    const int s = kt % kStages;
    mbar_wait(full(s), (kt / kStages) & 1);
#pragma unroll
    for (int i = 0; i < kKeys / 2; ++i) sc[i] = 0.f;
    fence_regs(sc);
    wg_fence();
#pragma unroll
    for (int p = 0; p < QK::count; ++p) {
      const int w = QK::width(p);
      const uint32_t lay = layout_of(w);
      const uint32_t sbo = 16u * w;     // 8 rows of 2 w bytes
#pragma unroll
      for (int ks = 0; ks < w / 16; ++ks) {
        const uint64_t da =
            gmma_desc(sQ + T::q_offset(p) + wgi * 64 * 2 * w + 32 * ks, 16, sbo, lay);
        const uint64_t db = gmma_desc(k_slot(s) + T::k_offset(p) + 32 * ks, 16, sbo, lay);
        wgmma_ss(sc, da, db, (p > 0 || ks > 0) ? 1 : 0);
      }
    }
    wg_commit();
    wg_wait0();
    fence_regs(sc);
  };

  mbar_wait(qbar, 0);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int s = kt % kStages;
    const uint32_t sV = k_slot(s) + T::k_bytes;
    qk(kt);
    // scale into the log2 domain; mask only a tile that crosses the diagonal or Sk.
    // Element 4 j + e is row row0 (+ 8 for e >= 2), key k0 + 8 j + 2 tig (+ 1 for odd e).
    const int k0 = kt * kKeys;
    const bool edge = k0 + kKeys > sk || (causal && k0 + kKeys - 1 > wg_first);
#pragma unroll
    for (int i = 0; i < kKeys / 2; ++i) {
      float x = sc[i] * scale_log2;
      if (edge) {
        const int row = row0 + ((i >> 1) & 1) * 8;
        const int col = k0 + (i >> 2) * 8 + tig * 2 + (i & 1);
        if (col >= sk || (causal && col > row)) x = kNegInf;
      }
      sc[i] = x;
    }

    // online softmax; the 4 threads of a fragment row hold its kKeys keys
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kKeys / 8; ++j) {
        mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * r], sc[4 * j + 2 * r + 1]));
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      const float corr = fast_ex2(m[r] - m_new);
      m[r] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kKeys / 8; ++j) {
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          const float pr = fast_ex2(sc[4 * j + e] - m_new);
          sc[4 * j + e] = pr;
          sum += pr;
        }
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[r] = l[r] * corr + sum;
#pragma unroll
      for (int i = 0; i < DV / 8; ++i) {
        o[4 * i + 2 * r] *= corr;
        o[4 * i + 2 * r + 1] *= corr;
      }
    }

    // P as A fragments: key step kk is S column tiles 2 kk and 2 kk + 1, each probability
    // as hi + lo (split_bf16)
    uint32_t phi[kKeys / 16][4], plo[kKeys / 16][4];
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        split_bf16(sc[8 * kk + 2 * e], sc[8 * kk + 2 * e + 1], phi[kk][e], plo[kk][e]);
      }
    }

    // O += P V in one wgmma of width DV per 16 keys and hi / lo: V (key, d) MN-major in atoms
    // of v_atom columns, key step kk 16 rows down each atom
    fence_regs(phi);
    fence_regs(plo);
    fence_regs(o);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      const uint64_t db = gmma_desc(sV + kk * 16 * 2 * T::v_atom, T::v_atom_bytes,
                                    16u * T::v_atom, layout_of(T::v_atom));
      wgmma_rs(o, phi[kk], db);
      wgmma_rs(o, plo[kk], db);
    }
    wg_commit();
    wg_wait0();
    fence_regs(phi);
    fence_regs(plo);
    fence_regs(o);
    mbar_arrive(empty(s));              // this thread is done with the slot
  }

  // out = O / l; element 4 j + e of o is row row0 (+ 8 for e >= 2), column 8 j + 2 tig
  // (+ 1 for odd e)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= sq) continue;
    const float safe = l[r] == 0.f ? 1.f : l[r];
    const float inv = 1.f / safe;
    __nv_bfloat16* orow = out + ((static_cast<int64_t>(b) * sq + row) * n_heads + h) * DV;
#pragma unroll
    for (int j = 0; j < DV / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * tig) =
          __floats2bfloat162_rn(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
    }
    if (lse != nullptr && tig == 0) {
      lse[(static_cast<int64_t>(b) * n_heads + h) * lse_pitch(sq) + row] =
          (m[r] + log2f(safe)) * kLn2;
    }
  }
}

template <int DQK, int DV>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, void* lse, int batch,
                   int sq, int sk, int n_heads, int n_kv, int v_ld, int causal,
                   cudaStream_t stream) {
  using T = Tiles<DQK, DV>;
  using QK = typename T::QK;
  bind_context();
  const EncodeTiled fn = encode_fn();
  if (fn == nullptr) return cudaErrorNotSupported;
  Maps maps;
  memset(&maps, 0, sizeof(maps));
  for (int p = 0; p < QK::count; ++p) {
    const int w = QK::width(p);
    if (!encode(fn, &maps.q[p], q, batch, sq, n_heads, DQK, DQK, w, kRows) ||
        !encode(fn, &maps.k[p], k, batch, sk, n_kv, DQK, DQK, w, kKeys)) {
      return cudaErrorInvalidValue;
    }
  }
  if (!encode(fn, &maps.v, v, batch, sk, n_kv, DV, v_ld, T::v_atom, kKeys)) {
    return cudaErrorInvalidValue;
  }
  constexpr size_t smem = T::smem;
  auto kernel = flash_fwd_wgmma_kernel<DQK, DV>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  // the scale is the q.k width's: 1/sqrt(DQK), whatever v's width
  const float scale_log2 = static_cast<float>(kLog2e / sqrt(static_cast<double>(DQK)));
  const dim3 grid((sq + kRows - 1) / kRows, batch * n_heads);
  kernel<<<grid, kThreads, smem, stream>>>(maps, static_cast<__nv_bfloat16*>(out),
                                           static_cast<float*>(lse), sq, sk, n_heads, n_kv,
                                           causal, scale_log2);
  return cudaGetLastError();
}

}  // namespace wg

// The instance a launch at q.k width dqk and v width dv runs: 0 flash_fwd_kernel (float32
// FMA), 1 flash_fwd_mma_kernel (bf16 mma.sync), 2 flash_fwd_wgmma_kernel (bf16 wgmma + TMA:
// (d, d) for d a multiple of 16 up to 128, and (192, 128)); -1 where no instance takes these
// widths as they are (a dtype no instance takes, or dv < dqk outside (192, 128): the wrapper
// zero-pads v to dqk and runs the instance of (dqk, dqk)).
int instance_of(int dqk, int dv, int dtype) {
  if (dtype != 0 && dtype != 1) return -1;
  if (dtype == 1 && dqk == 192 && dv == 128) return 2;
  if (dv != dqk) return -1;
  if (dtype == 0) return 0;
  return dqk % 16 == 0 && dqk <= 128 ? 2 : 1;
}

cudaError_t dispatch_wgmma(const void* q, const void* k, const void* v, void* out, void* lse,
                           int batch, int sq, int sk, int n_heads, int n_kv, int dqk, int dv,
                           int v_ld, int causal, cudaStream_t s) {
#define FLASH_WG(DQK, DV) \
  wg::launch<DQK, DV>(q, k, v, out, lse, batch, sq, sk, n_heads, n_kv, v_ld, causal, s)
  if (dqk == 192 && dv == 128) return FLASH_WG(192, 128);
  if (dv != dqk) return cudaErrorInvalidValue;
  switch (dqk) {
    case 16: return FLASH_WG(16, 16);
    case 32: return FLASH_WG(32, 32);
    case 48: return FLASH_WG(48, 48);
    case 64: return FLASH_WG(64, 64);
    case 80: return FLASH_WG(80, 80);
    case 96: return FLASH_WG(96, 96);
    case 112: return FLASH_WG(112, 112);
    case 128: return FLASH_WG(128, 128);
    default: return cudaErrorInvalidValue;
  }
#undef FLASH_WG
}

// The bf16 instance of (dh, dh): mma.sync at the smallest padded width.
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

// The flash binding: q, k, v, out, the row lse (float32 (B, H, lse_pitch(Sq)), or null), B, Sq,
// Sk, H, Hkv, the q.k width Dqk, v's width Dv, v's row pitch (the elements between one
// (position, head) row of v and the next, Dv for a contiguous v), causal, dtype (0 float32,
// 1 bfloat16) and the stream; returns a cudaError_t (0 on success).  q and k are contiguous
// (B, S, H, Dqk); out is contiguous (B, Sq, H, Dv).  Only the wgmma instance writes the lse:
// another with a non-null lse is refused.  The
// wgmma instance reads v's rows at any pitch TMA takes (16-byte multiples); the mma.sync and
// FMA instances take a contiguous v.  Refuses what the wrapper refuses (a non-positive dim, H
// not a multiple of Hkv, Dqk > 256, Dv > Dqk, a pitch below Dv), widths no instance takes as
// they are (instance_of), a pitch the instance does not take and a grid past the card's
// limits.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      void* lse, int batch, int sq, int sk, int n_heads, int n_kv,
                                      int dqk, int dv, int v_ld, int causal, int dtype,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch <= 0 || sq <= 0 || sk <= 0 || n_heads <= 0 || n_kv <= 0 || dqk <= 0 ||
      dqk > 256 || dv <= 0 || dv > dqk || v_ld < dv || n_heads % n_kv != 0 ||
      static_cast<long long>(batch) * n_heads > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int which = instance_of(dqk, dv, dtype);
  if (which != 2 && (v_ld != dv || lse != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (which) {
    case 0:
      return static_cast<int>(
          dispatch_fma(q, k, v, out, batch, sq, sk, n_heads, n_kv, dqk, causal, s));
    case 1:
      return static_cast<int>(
          dispatch_mma(q, k, v, out, batch, sq, sk, n_heads, n_kv, dqk, causal, s));
    case 2:
      return static_cast<int>(dispatch_wgmma(q, k, v, out, lse, batch, sq, sk, n_heads, n_kv,
                                             dqk, dv, v_ld, causal, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Which instance a launch at these widths and dtype runs (instance_of): 0 float32 FMA,
// 1 bf16 mma.sync, 2 bf16 wgmma + TMA, -1 none takes them as they are.
extern "C" int flash_attention_instance(int dqk, int dv, int dtype) {
  return instance_of(dqk, dv, dtype);
}

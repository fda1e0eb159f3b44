// flash_backward — the attention backward for Hopper (sm_90a): dq, dk and dv of
// csrc/flash_attention.cu's forward without the (Sq, Sk) matrix in device memory.
//
// Replaces no TPU kernel: the JAX reference's backward (src/repro/kernels/ops.py::
// _flash_bwd_rule) is jnp, and the port ran it as plain float32 torch (kernels/ops.py::
// _flash_bwd), which paced a training step.  For q (B, Sq, H, Dh), k and v (B, Sk, Hkv, Dh),
// bf16, Dh a multiple of 16 up to 128 (the widths of the forward's wgmma instance with
// Dqk = Dv), query head h reading kv head h / (H / Hkv), o the forward's output, dO its
// cotangent and lse the row logsumexp the forward's wgmma instance wrote (natural log,
// (B, H, lse_pitch(Sq)) float32):
//
//   P = exp(q k^T / sqrt(Dh) - lse) (causal: key j <= query i), dP = dO v^T,
//   delta = rowsum(dO o), dS = P (dP - delta),
//   dq = dS k / sqrt(Dh), dk = dS^T q / sqrt(Dh), dv = P^T dO,
//
// summed over the H / Hkv query heads of a kv head for dk and dv; the outputs in bf16, in the
// inputs' layouts.  Three kernels behind one entry point, on the caller's stream:
//   * flash_bwd_delta_kernel: delta = rowsum(dO o) in float32 per (batch, head, query), into
//     (B, H, lse_pitch(Sq)), and zeroes the float32 dq workspace.
//   * flash_bwd_wgmma_kernel: one block owns (batch, kv head, 128-key tile), two consumer
//     warpgroups of 64 keys and a producer warpgroup (setmaxnreg: 24 registers a thread there,
//     240 in the consumers).  K and V of the tile are loaded once by TMA; the producer then
//     streams Q, dO, lse and delta tiles of 64 queries for each query head of the group through
//     two mbarrier slots (three measured 5% slower at Dh 128), the causal ones from the
//     diagonal on.  Per tile each warpgroup
//       - forms S^T = K Q^T and dP^T = V dO^T (wgmma m64n64k16 from shared memory, K-major),
//       - makes P^T = exp2(S^T scale log2e - lse log2e) and dS^T = P^T (dP^T - delta) in
//         registers (float32), masking only a tile that crosses the diagonal, Sk or Sq,
//       - adds dV += P^T dO and dK += dS^T Q with P^T (bf16) and dS^T (hi + lo) as A fragments
//         in registers (the accumulators' own layout) and dO, Q read through the descriptor's
//         transpose, dK and dV staying in registers across the whole group and every query
//         tile (so grouped-query attention needs no atomics for them),
//       - writes dS^T's hi and lo terms to shared memory (bf16, 128B-swizzled), beside the other
//         warpgroup's, and forms its columns of dq = dS K over all 128 keys (both operands
//         through the transpose; the columns split at a piece of Dh, 64 and 64 at Dh 128),
//         staged in shared memory a warp at a time and added to the workspace by one TMA bulk
//         reduce-add (cp.reduce.async.bulk) a warp and piece.
//     Blocks are issued longest work first (key tile 0 sees every query tile when causal:
//     the key tile is the grid's slow axis); a warpgroup whose 64 keys all lie above the
//     diagonal or past Sk skips its products and gives zeros to dq.
//   * flash_bwd_dq_kernel: dq = workspace / sqrt(Dh) in bf16.
// The workspace holds (B, H, ceil(Sq / 64)) tiles of 64 x Dh float32 in the order of the
// wgmma accumulators (warp, column group of 8, lane, element), so that a warp's 16 rows of a
// piece lie together; the dq pass reads it in that order.  P enters dV as bf16, as the
// reference's float32 einsums run as one bf16 pass under JAX's default precision on its own
// chip; dS enters dK and dq as the pair hi = bf16(x), lo = bf16(x - hi) (split_bf16, two
// products each), since with dS in one bf16 term a one-step SMOKE Zamba2 train step on the
// card moved an SSD conv bias's update off the CPU's by 1.7 times its bound (near-zero
// gradients flipping sign under AdamW).  The pair brings dq and dk to the plain float32
// backward's agreement (1.2e-3 against 2.7e-3 relative) at no measured cost at the training
// call; P's pair cost 1.1 ms there and moved no check.  The softmax, lse, delta and every sum
// stay float32.
//
// Bound: five products over the pairs the mask keeps, 2 * B * H * pairs * 5 * Dh operations
// (the reference's four einsums and dq; dS's pair issues dK's and dq's twice, seven in all),
// against reading q, k, v, o and dO, writing dq, dk and
// dv and the lse and delta once.  At InternLM2-1.8B's training call (B 8, S 4096, H 16,
// Hkv 8, Dh 128, causal): 1.375 TFLOP (1.39 ms at 989 TFLOP/s) against about 0.8 GB (0.24 ms):
// bound by operations.  Each warpgroup runs its products, its exponentials and its dq
// reduction one after another; the two warpgroups of a block overlap each other.  The dq
// reduction is the design's extra traffic, 64 * Dh float32 a (64-query, 128-key) tile, 4.4 GB
// at the training call, where a variant without it ran 1.2 ms faster than the 4.3.  When each
// warpgroup added its own 64 keys' dq (twice the traffic, both to the same addresses) it took
// 3.5 of 6.1 ms; per-thread 16-byte red.add in place of the bulk reduction measured 3-8%
// slower.
// Plain C entry point, loaded with ctypes.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <math.h>

#include "flash_wgmma.cuh"

namespace {
namespace wg {

constexpr int kBwdKeys = 128;            // key rows of a block, 64 a consumer warpgroup
constexpr int kBwdRows = 64;             // query rows of a Q / dO tile
constexpr int kBwdConsumers = 256;       // two consumer warpgroups
constexpr int kBwdThreads = kBwdConsumers + 128;   // + the producer warpgroup
constexpr int kRowThreads = 256;         // the delta and dq passes: a 64-row tile a block

// The tiles of the Dh instance: K and V (128 keys) and the ring's Q and dO (64 queries) cut
// into the pieces of Dh (Pieces), one after another in a tile, then lse and delta (64 float32
// each) in the slot; after the ring the warpgroups' dS^T (64 keys x 64 queries, bf16), their
// lo terms, and each consumer warp's dq stage.
template <int DH>
struct BwdTiles {
  using P = Pieces<DH>;
  static_assert(DH % 16 == 0 && DH <= 128, "Dh a multiple of 16 up to 128");
  static constexpr uint32_t kv_bytes = kBwdKeys * 2 * DH;
  static constexpr uint32_t row_bytes = kBwdRows * 2 * DH;
  static constexpr uint32_t stat_bytes = kBwdRows * 4;
  __host__ __device__ static constexpr uint32_t kv_offset(int p) {
    return static_cast<uint32_t>(kBwdKeys * 2 * P::col(p));
  }
  __host__ __device__ static constexpr uint32_t row_offset(int p) {
    return static_cast<uint32_t>(kBwdRows * 2 * P::col(p));
  }
  static constexpr uint32_t slot_bytes = (2 * row_bytes + 2 * stat_bytes + 1023) / 1024 * 1024;
  static constexpr uint32_t ds_bytes = 64 * kBwdRows * 2;
  static constexpr uint32_t stage_bytes = 16 * 64 / 8 * 32;   // a warp's piece of dq, float32
  static constexpr int stages = 2;       // 3 measured 5% slower at Dh 128
  static constexpr size_t smem =
      1024 + 2 * static_cast<size_t>(kv_bytes) + 4 * ds_bytes + 8 * stage_bytes + 64 +
      slot_bytes * stages;
  static_assert(smem <= kMaxSmem, "the tiles must fit a block's shared memory");
};

// Tensor maps: q, k, v and dO in the pieces of Dh (4-D, as the forward's; q and dO with boxes
// of 64 rows, k and v of 128), lse and delta 2-D over (Sq, B H) with boxes of 64.
struct BwdMaps {
  CUtensorMap q[3];
  CUtensorMap k[3];
  CUtensorMap v[3];
  CUtensorMap dout[3];
  CUtensorMap lse;
  CUtensorMap delta;
};

// One TMA copy of a (64, 1) float32 box at (row, head) of a 2-D map, completing on `bar`.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int row,
                                            int head, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(row), "r"(head), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t x) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(x) : "memory");
}

__device__ __forceinline__ float2 ld_shared2(uint32_t addr) {
  float2 x;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(x.x), "=f"(x.y) : "r"(addr) : "memory");
  return x;
}

// Make this thread's shared-memory writes visible to wgmma (the async proxy).
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A barrier for the 256 threads of the two consumer warpgroups (named barrier 1).
__device__ __forceinline__ void consumers_barrier() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ void st_shared4(uint32_t addr, float a, float b, float c, float d) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "f"(a), "f"(b), "f"(c),
               "f"(d)
               : "memory");
}

// `bytes` of float32 in shared memory added to global memory by the TMA unit (one bulk
// reduction, 16-byte aligned both ends), in this thread's bulk group.
__device__ __forceinline__ void bulk_reduce_add(float* dst, uint32_t src, uint32_t bytes) {
  asm volatile(
      "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], [%1], %2;\n"
      "cp.async.bulk.commit_group;\n" ::"l"(dst),
      "r"(src), "r"(bytes)
      : "memory");
}

// Wait until this thread's bulk reductions have read their shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Wait until this thread's bulk reductions are done.
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// d (64 x 64, float32) = A (64 x 16) B (16 x 64) (+ d when scale_d), both bf16 from shared
// memory, both K-major.
__device__ __forceinline__ void wgmma_ss_kk(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x N, float32) = A (64 x 16) B (16 x N) (+ d when scale_d), both bf16 from shared
// memory, both MN-major (the descriptors' transpose), N = 16, 32 or 64 by the size of d.
__device__ __forceinline__ void wgmma_ss_mn(float (&d)[8], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_mn(float (&d)[16], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_mn(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// acc (64 x Dh) += A (64 x 16, fragments) B (16 x Dh), B the k-step kk of a tile of `rows` rows
// in the pieces of Dh, read MN-major: one wgmma a piece into its columns of acc (a piece's
// accumulators are contiguous in acc).  (At Dh 128 one wgmma across both pieces, joined by the
// descriptor's leading offset, measured the same.)
template <int DH, int P = 0>
__device__ __forceinline__ void mn_rs(float (&acc)[DH / 2], const uint32_t (&a)[4], uint32_t tile,
                                      int rows, int kk) {
  using PC = Pieces<DH>;
  if constexpr (P < PC::count) {
    constexpr int w = PC::width(P), c = PC::col(P);
    wgmma_rs(*reinterpret_cast<float(*)[w / 2]>(&acc[c / 2]), a,
             gmma_desc(tile + rows * 2 * c + kk * 16 * 2 * w, rows * 2 * w, 16u * w,
                       layout_of(w)));
    mn_rs<DH, P + 1>(acc, a, tile, rows, kk);
  }
}

// dq's columns of piece P of Dh for the 64 queries of a tile: dS (64 queries x the block's 128
// keys, MN-major at sDS, the two warpgroups' dS^T one after the other; its lo terms at sDSlo)
// times piece P of K (128 keys, MN-major), added to the workspace tile `ws`: each warp's 16
// rows of the piece lie together in the workspace's accumulator order, so the warp stages
// them in shared memory (`stage`, its own) and one lane adds them with a bulk reduction.
template <int DH, int P>
__device__ __forceinline__ void dq_piece(uint32_t sDS, uint32_t sDSlo, uint32_t sK,
                                         uint32_t stage, float* ws, int warp, int lane) {
  using PC = Pieces<DH>;
  if constexpr (P < PC::count) {
    constexpr int w = PC::width(P), c = PC::col(P);
    float acc[w / 2];
#pragma unroll
    for (int i = 0; i < w / 2; ++i) acc[i] = 0.f;
    fence_regs(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kBwdKeys / 16; ++kk) {
      const uint64_t da = gmma_desc(sDS + kk * 16 * 128, 8192, 1024, 1);
      const uint64_t db = gmma_desc(sK + kBwdKeys * 2 * c + kk * 16 * 2 * w, kBwdKeys * 2 * w,
                                    16u * w, layout_of(w));
      wgmma_ss_mn(acc, da, db, kk > 0 ? 1 : 0);
      wgmma_ss_mn(acc, gmma_desc(sDSlo + kk * 16 * 128, 8192, 1024, 1), db, 1);
    }
    wg_commit();
    wg_wait0();
    fence_regs(acc);
    if (lane == 0) bulk_wait_read();    // the warp's last reduction has read the stage
    __syncwarp();
#pragma unroll
    for (int j = 0; j < w / 8; ++j) {
      st_shared4(stage + (j * 32 + lane) * 16, acc[4 * j], acc[4 * j + 1], acc[4 * j + 2],
                 acc[4 * j + 3]);
    }
    fence_async_smem();
    __syncwarp();
    if (lane == 0) {
      bulk_reduce_add(ws + (warp * (DH / 8) + c / 8) * 32 * 4, stage, w / 8 * 32 * 16);
    }
  }
}

// A tile's dq over the block's 128 keys, its columns split between the warpgroups at a piece
// boundary: warpgroup 0 takes piece 0, warpgroup 1 the others (Dh 128: 64 columns each; at
// Dh <= 64, one piece, warpgroup 1 takes none).  So each column gets one reduction a tile and
// block, and the two warpgroups never add to the same address.
template <int DH>
__device__ __forceinline__ void dq_part(uint32_t sDS, uint32_t sDSlo, uint32_t sK,
                                        uint32_t stage, int wgi, float* ws, int warp, int lane) {
  if (wgi == 0) {
    dq_piece<DH, 0>(sDS, sDSlo, sK, stage, ws, warp, lane);
  } else {
    dq_piece<DH, 1>(sDS, sDSlo, sK, stage, ws, warp, lane);
    dq_piece<DH, 2>(sDS, sDSlo, sK, stage, ws, warp, lane);
  }
  wg_wait0();                           // a warpgroup with no piece: its dV and dK products
}

// delta[b, h, i] = sum_d dO[b, i, h, d] o[b, i, h, d] in float32 for the 64 queries of tile
// blockIdx.x of (b, h) = blockIdx.y, four threads a row; and the tile's dq workspace zeroed.
template <int DH>
__global__ void __launch_bounds__(kRowThreads)
flash_bwd_delta_kernel(const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
                       float* __restrict__ delta, float* __restrict__ ws, int sq, int n_heads) {
  const int bh = blockIdx.y;
  const int b = bh / n_heads;
  const int h = bh - b * n_heads;
  const int row = static_cast<int>(blockIdx.x) * kBwdRows + (threadIdx.x >> 2);
  const int part = threadIdx.x & 3;
  float sum = 0.f;
  if (row < sq) {
    const int64_t at = ((static_cast<int64_t>(b) * sq + row) * n_heads + h) * DH;
#pragma unroll
    for (int d = 2 * part; d < DH; d += 8) {
      const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(o + at + d));
      const float2 y =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(dout + at + d));
      sum = fmaf(x.x, y.x, fmaf(x.y, y.y, sum));
    }
  }
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  sum += __shfl_xor_sync(0xffffffffu, sum, 2);
  if (row < sq && part == 0) delta[static_cast<int64_t>(bh) * lse_pitch(sq) + row] = sum;
  const int n_qt = (sq + kBwdRows - 1) / kBwdRows;
  float4* tile = reinterpret_cast<float4*>(
      ws + (static_cast<int64_t>(bh) * n_qt + blockIdx.x) * kBwdRows * DH);
  for (int i = threadIdx.x; i < kBwdRows * DH / 4; i += kRowThreads) {
    tile[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// dq[b, i, h] = workspace * scale in bf16, the workspace read in its accumulator order.
template <int DH>
__global__ void __launch_bounds__(kRowThreads)
flash_bwd_dq_kernel(const float* __restrict__ ws, __nv_bfloat16* __restrict__ dq, int sq,
                    int n_heads, float scale) {
  const int bh = blockIdx.y;
  const int b = bh / n_heads;
  const int h = bh - b * n_heads;
  const int q0 = static_cast<int>(blockIdx.x) * kBwdRows;
  const int n_qt = (sq + kBwdRows - 1) / kBwdRows;
  const float4* tile = reinterpret_cast<const float4*>(
      ws + (static_cast<int64_t>(bh) * n_qt + blockIdx.x) * kBwdRows * DH);
  for (int i = threadIdx.x; i < kBwdRows * DH / 4; i += kRowThreads) {
    const float4 x = tile[i];
    const int lane = i & 31;
    const int group = i >> 5;                   // warp * (DH / 8) + column group
    const int warp = group / (DH / 8);
    const int col = (group - warp * (DH / 8)) * 8 + 2 * (lane & 3);
    const int row = q0 + warp * 16 + (lane >> 2);
    if (row < sq) {
      *reinterpret_cast<__nv_bfloat162*>(
          dq + ((static_cast<int64_t>(b) * sq + row) * n_heads + h) * DH + col) =
          __floats2bfloat162_rn(x.x * scale, x.y * scale);
    }
    if (row + 8 < sq) {
      *reinterpret_cast<__nv_bfloat162*>(
          dq + ((static_cast<int64_t>(b) * sq + row + 8) * n_heads + h) * DH + col) =
          __floats2bfloat162_rn(x.z * scale, x.w * scale);
    }
  }
}

// The main kernel: see the head of this file.  Block (b * Hkv + hk, key tile): the key tile is
// the grid's slow axis, so every (batch, kv head)'s longest causal work is issued first.
template <int DH>
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_bwd_wgmma_kernel(const __grid_constant__ BwdMaps maps, float* __restrict__ ws,
                       __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int sq,
                       int sk, int n_heads, int n_kv, int causal, float scale_log2,
                       float scale) {
  using T = BwdTiles<DH>;
  using PC = typename T::P;
  constexpr int kStages = T::stages;
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  const uint32_t base = (smem_u32(wg_smem) + 1023u) & ~1023u;
  const uint32_t sK = base;
  const uint32_t sV = base + T::kv_bytes;
  const uint32_t ring = base + 2 * T::kv_bytes;
  const uint32_t sDS = ring + kStages * T::slot_bytes;
  const uint32_t sDSlo = sDS + 2 * T::ds_bytes;      // the lo terms of both dS^T
  const uint32_t sStage = sDSlo + 2 * T::ds_bytes;   // 8 consumer warps' dq staging
  const uint32_t bars = sStage + 8 * T::stage_bytes;
  auto slot = [&](int s) { return ring + s * T::slot_bytes; };
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (kStages + s); };
  const uint32_t kvbar = bars + 16u * kStages;

  const int k0 = static_cast<int>(blockIdx.y) * kBwdKeys;
  const int b = blockIdx.x / n_kv;
  const int hk = blockIdx.x - b * n_kv;
  const int group = n_heads / n_kv;
  const int n_qt = (sq + kBwdRows - 1) / kBwdRows;
  const int qt0 = causal ? min(k0 / kBwdRows, n_qt) : 0;   // causal: from the diagonal on
  const int per_head = n_qt - qt0;
  const int n_iter = group * per_head;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kBwdConsumers);
    }
    mbar_init(kvbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kBwdConsumers) {           // the producer warpgroup; one thread issues the copies
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == kBwdConsumers) {
      mbar_expect_tx(kvbar, 2 * T::kv_bytes);
#pragma unroll
      for (int p = 0; p < PC::count; ++p) {
        tma_load(sK + T::kv_offset(p), &maps.k[p], PC::col(p), hk, k0, b, kvbar);
        tma_load(sV + T::kv_offset(p), &maps.v[p], PC::col(p), hk, k0, b, kvbar);
      }
      for (int it = 0; it < n_iter; ++it) {
        const int g = it / per_head;
        const int q0 = (qt0 + it - g * per_head) * kBwdRows;
        const int h = hk * group + g;
        const int s = it % kStages;
        mbar_wait(empty(s), ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(full(s), 2 * T::row_bytes + 2 * T::stat_bytes);
        const uint32_t sl = slot(s);
#pragma unroll
        for (int p = 0; p < PC::count; ++p) {
          tma_load(sl + T::row_offset(p), &maps.q[p], PC::col(p), h, q0, b, full(s));
          tma_load(sl + T::row_bytes + T::row_offset(p), &maps.dout[p], PC::col(p), h, q0, b,
                   full(s));
        }
        tma_load_2d(sl + 2 * T::row_bytes, &maps.lse, q0, b * n_heads + h, full(s));
        tma_load_2d(sl + 2 * T::row_bytes + T::stat_bytes, &maps.delta, q0, b * n_heads + h,
                    full(s));
      }
    }
  } else {                              // the two consumer warpgroups
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wgi = tid >> 7;
    const int warp = (tid & 127) >> 5;
    const int lane = tid & 31;
    const int gid = lane >> 2;
    const int tig = lane & 3;
    const int kw = k0 + wgi * 64;                       // the warpgroup's first key
    const int krow = kw + warp * 16 + gid;              // this thread's keys: krow, krow + 8
    const uint32_t sds = sDS + wgi * T::ds_bytes;
    const uint32_t sds_lo = sDSlo + wgi * T::ds_bytes;
    const uint32_t stage = sStage + (tid >> 5) * T::stage_bytes;

    float dk_acc[DH / 2], dv_acc[DH / 2];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

    mbar_wait(kvbar, 0);
    for (int it = 0; it < n_iter; ++it) {
      const int g = it / per_head;
      const int qt = qt0 + it - g * per_head;
      const int q0 = qt * kBwdRows;
      const int h = hk * group + g;
      const int s = it % kStages;
      mbar_wait(full(s), (it / kStages) & 1);
      const uint32_t sQ = slot(s);
      const uint32_t sDO = sQ + T::row_bytes;
      const uint32_t sLse = sQ + 2 * T::row_bytes;
      // every key of the warpgroup masked: no products, and its dS^T is zeros
      const bool idle = kw >= sk || (causal && kw > q0 + kBwdRows - 1);
      uint32_t pf[4][4], dsf[4][4], dslo[4][4];
      if (!idle) {
        // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 queries
        float sacc[32], pacc[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) sacc[i] = pacc[i] = 0.f;
        fence_regs(sacc);
        fence_regs(pacc);
        wg_fence();
#pragma unroll
        for (int p = 0; p < PC::count; ++p) {
          const int w = PC::width(p);
          const uint32_t lay = layout_of(w);
          const uint32_t sbo = 16u * w;
#pragma unroll
          for (int ks = 0; ks < w / 16; ++ks) {
            const uint32_t kv = T::kv_offset(p) + wgi * 64 * 2 * w + 32 * ks;
            const uint32_t rw = T::row_offset(p) + 32 * ks;
            const int acc = (p > 0 || ks > 0) ? 1 : 0;
            wgmma_ss_kk(sacc, gmma_desc(sK + kv, 16, sbo, lay), gmma_desc(sQ + rw, 16, sbo, lay),
                        acc);
            wgmma_ss_kk(pacc, gmma_desc(sV + kv, 16, sbo, lay), gmma_desc(sDO + rw, 16, sbo, lay),
                        acc);
          }
        }
        wg_commit();
        wg_wait0();
        fence_regs(sacc);
        fence_regs(pacc);

        // P^T and dS^T.  Element 4 j + e is key krow (+ 8 for e >= 2), query q0 + 8 j + 2 tig
        // (+ 1 for odd e).
        const bool edge = kw + 64 > sk || q0 + kBwdRows > sq || (causal && kw + 63 > q0);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 ls = ld_shared2(sLse + 4 * (8 * j + 2 * tig));
          const float2 dl = ld_shared2(sLse + T::stat_bytes + 4 * (8 * j + 2 * tig));
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * j + e;
            float pv = fast_ex2(sacc[i] * scale_log2 - ((e & 1) ? ls.y : ls.x) * kLog2e);
            if (edge) {
              const int key = krow + 8 * (e >> 1);
              const int qry = q0 + 8 * j + 2 * tig + (e & 1);
              if (key >= sk || qry >= sq || (causal && key > qry)) pv = 0.f;
            }
            sacc[i] = pv;
            pacc[i] = pv * (pacc[i] - ((e & 1) ? dl.y : dl.x));
          }
        }
        // as bf16 A fragments: k-step kk is accumulator columns 16 kk .. 16 kk + 15
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            pf[kk][e] = pack_bf16(sacc[8 * kk + 2 * e], sacc[8 * kk + 2 * e + 1]);
            split_bf16(pacc[8 * kk + 2 * e], pacc[8 * kk + 2 * e + 1], dsf[kk][e], dslo[kk][e]);
          }
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e) pf[kk][e] = dsf[kk][e] = dslo[kk][e] = 0u;
      }

      // dS^T into shared memory for dq: row = key (128 bytes of 64 queries), 128B swizzle:
      // the 16-byte chunk j of row r lands at chunk j ^ (r % 8), and r % 8 is gid
      consumers_barrier();              // the last tile's dq products have read both dS^T
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = 2 * kk + (e >> 1);
          const int r = warp * 16 + gid + 8 * (e & 1);
          st_shared(sds + r * 128 + ((j ^ gid) << 4) + 4 * tig, dsf[kk][e]);
          st_shared(sds_lo + r * 128 + ((j ^ gid) << 4) + 4 * tig, dslo[kk][e]);
        }
      }
      fence_async_smem();

      if (!idle) {
        // dV += P^T dO and dK += dS^T Q: A from registers, dO and Q MN-major
        fence_regs(pf);
        fence_regs(dsf);
        fence_regs(dslo);
        fence_regs(dk_acc);
        fence_regs(dv_acc);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          mn_rs<DH>(dv_acc, pf[kk], sDO, kBwdRows, kk);
          mn_rs<DH>(dk_acc, dsf[kk], sQ, kBwdRows, kk);
          mn_rs<DH>(dk_acc, dslo[kk], sQ, kBwdRows, kk);
        }
        wg_commit();
      }

      // dq of these 64 queries over the block's 128 keys; its wait also completes dV and dK
      consumers_barrier();              // both dS^T are written
      dq_part<DH>(sDS, sDSlo, sK, stage, wgi,
                  ws + ((static_cast<int64_t>(b) * n_heads + h) * n_qt + qt) * kBwdRows * DH,
                  warp, lane);
      fence_regs(pf);
      fence_regs(dsf);
      fence_regs(dslo);
      fence_regs(dk_acc);
      fence_regs(dv_acc);
      mbar_arrive(empty(s));            // this thread is done with the slot
    }

    if (lane == 0) bulk_wait();         // the stage is read before the block ends
    // dk = scale dK and dv = dV for keys krow and krow + 8
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = krow + 8 * r;
      if (key >= sk) continue;
      const int64_t at = ((static_cast<int64_t>(b) * sk + key) * n_kv + hk) * DH;
#pragma unroll
      for (int j = 0; j < DH / 8; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(dk + at + 8 * j + 2 * tig) = __floats2bfloat162_rn(
            dk_acc[4 * j + 2 * r] * scale, dk_acc[4 * j + 2 * r + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + at + 8 * j + 2 * tig) =
            __floats2bfloat162_rn(dv_acc[4 * j + 2 * r], dv_acc[4 * j + 2 * r + 1]);
      }
    }
  }
}

// A 2-D float32 map over (Sq, B H) rows `pitch` elements apart, with a box of (64, 1): rows
// past Sq come in as zeros.
bool encode_stats(EncodeTiled fn, CUtensorMap* map, const void* ptr, int sq, int bh, int pitch) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(sq), static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(pitch) * 4};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kBwdRows), 1};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(ptr), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DH>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* o,
                       const void* dout, const void* lse, void* dq, void* dk, void* dv,
                       void* ws, void* delta, int batch, int sq, int sk, int n_heads, int n_kv,
                       int causal, cudaStream_t stream) {
  using T = BwdTiles<DH>;
  using PC = typename T::P;
  bind_context();
  const EncodeTiled fn = encode_fn();
  if (fn == nullptr) return cudaErrorNotSupported;
  BwdMaps maps;
  memset(&maps, 0, sizeof(maps));
  for (int p = 0; p < PC::count; ++p) {
    const int w = PC::width(p);
    if (!encode(fn, &maps.q[p], q, batch, sq, n_heads, DH, DH, w, kBwdRows) ||
        !encode(fn, &maps.dout[p], dout, batch, sq, n_heads, DH, DH, w, kBwdRows) ||
        !encode(fn, &maps.k[p], k, batch, sk, n_kv, DH, DH, w, kBwdKeys) ||
        !encode(fn, &maps.v[p], v, batch, sk, n_kv, DH, DH, w, kBwdKeys)) {
      return cudaErrorInvalidValue;
    }
  }
  const int pitch = lse_pitch(sq);
  if (!encode_stats(fn, &maps.lse, lse, sq, batch * n_heads, pitch) ||
      !encode_stats(fn, &maps.delta, delta, sq, batch * n_heads, pitch)) {
    return cudaErrorInvalidValue;
  }
  const double scale = 1.0 / sqrt(static_cast<double>(DH));
  const int n_qt = (sq + kBwdRows - 1) / kBwdRows;
  const dim3 rows(n_qt, batch * n_heads);
  flash_bwd_delta_kernel<DH><<<rows, kRowThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(o), static_cast<const __nv_bfloat16*>(dout),
      static_cast<float*>(delta), static_cast<float*>(ws), sq, n_heads);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto kernel = flash_bwd_wgmma_kernel<DH>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(T::smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(batch * n_kv, (sk + kBwdKeys - 1) / kBwdKeys);
  kernel<<<grid, kBwdThreads, T::smem, stream>>>(
      maps, static_cast<float*>(ws), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), sq, sk, n_heads, n_kv, causal,
      static_cast<float>(kLog2e * scale), static_cast<float>(scale));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<DH><<<rows, kRowThreads, 0, stream>>>(
      static_cast<const float*>(ws), static_cast<__nv_bfloat16*>(dq), sq, n_heads,
      static_cast<float>(scale));
  return cudaGetLastError();
}

}  // namespace wg

// The widths and dtype the backward takes: bf16 (dtype 1) with Dqk = Dv = Dh, Dh a multiple of
// 16 up to 128 (those of the forward's wgmma instance at equal widths).
bool takes(int dqk, int dv, int dtype) {
  return dtype == 1 && dqk == dv && dqk > 0 && dqk % 16 == 0 && dqk <= 128;
}

}  // namespace

// The backward binding: q, k, v, o, dO, lse (the forward's, float32 (B, H, lse_pitch(Sq))),
// dq, dk, dv (outputs in the inputs' layouts), the float32 workspace (flash_backward_workspace
// elements) and delta (B H lse_pitch(Sq)), then B, Sq, Sk, H, Hkv, Dh, causal and the stream;
// returns a cudaError_t (0 on success).  Every tensor is contiguous and starts on 16 bytes.
// Refuses a non-positive dim, H not a multiple of Hkv, a width flash_backward_instance does
// not take and a grid past the card's limits.
extern "C" int flash_backward_launch(const void* q, const void* k, const void* v, const void* o,
                                     const void* dout, const void* lse, void* dq, void* dk,
                                     void* dv, void* ws, void* delta, int batch, int sq, int sk,
                                     int n_heads, int n_kv, int dh, int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch <= 0 || sq <= 0 || sk <= 0 || n_heads <= 0 || n_kv <= 0 || n_heads % n_kv != 0 ||
      !takes(dh, dh, 1) || static_cast<long long>(batch) * n_heads > 65535 ||
      (sk + 127) / 128 > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#define FLASH_BWD(DH)                                                                          \
  wg::launch_bwd<DH>(q, k, v, o, dout, lse, dq, dk, dv, ws, delta, batch, sq, sk, n_heads, n_kv, \
                     causal, s)
  switch (dh) {
    case 16: return static_cast<int>(FLASH_BWD(16));
    case 32: return static_cast<int>(FLASH_BWD(32));
    case 48: return static_cast<int>(FLASH_BWD(48));
    case 64: return static_cast<int>(FLASH_BWD(64));
    case 80: return static_cast<int>(FLASH_BWD(80));
    case 96: return static_cast<int>(FLASH_BWD(96));
    case 112: return static_cast<int>(FLASH_BWD(112));
    case 128: return static_cast<int>(FLASH_BWD(128));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FLASH_BWD
}

// 1 where the backward takes these widths and dtype (0 float32, 1 bfloat16), else 0.
extern "C" int flash_backward_instance(int dqk, int dv, int dtype) {
  return takes(dqk, dv, dtype) ? 1 : 0;
}

// The layout a caller allocates, owned here: the row pitch of the (B, H, pitch) float32 lse (the
// forward writes it there) and delta, and the float32 elements of the dq workspace at
// (B, H, Sq, Dh): B H ceil(Sq / 64) tiles of 64 x Dh.
extern "C" int flash_backward_lse_pitch(int sq) { return wg::lse_pitch(sq); }

extern "C" long long flash_backward_workspace(int batch, int n_heads, int sq, int dh) {
  const long long n_qt = (sq + wg::kBwdRows - 1) / wg::kBwdRows;
  return static_cast<long long>(batch) * n_heads * n_qt * wg::kBwdRows * dh;
}

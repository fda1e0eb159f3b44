// ssd_scan — the Mamba2 SSD chunk scan (state-space duality) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py::ssd_scan (kernel body
// _ssd_kernel).  For xs (B, L, H, P), B and C (B, L, N) shared by the heads, dt (B, L, H) and
// a (H,) float32, chunk by chunk of Q rows, per (batch, head):
//
//   cum   = cumsum(dt * a)                                   (Q,)
//   y     = ((C B^T) o tril(exp(cum_i - cum_j)) o dt_j) x  +  (C o exp(cum)) state^T
//   state = state * exp(cum_Q) + x^T (exp(cum_Q - cum) * dt o B)
//
// with the (P, N) float32 state carried from chunk to chunk; everything float32 inside, y in
// xs's dtype, and the final state written as a second output (the reference's ssd_forward
// returns it; the TPU kernel does not).  Every exponent is a difference <= 0: cum falls
// without bound (a < 0, dt > 0), so exp(cum_i) * exp(-cum_j) would overflow.
//
// The TPU kernel walks a (B*H, L/Q) grid whose trailing chunk axis runs in order, its state in
// VMEM scratch, and holds the whole (Q, Q) chunk matrix (256 KB of float32 at Q = 256: more
// than the 227 KB of shared memory a Hopper block can have).  Hopper blocks run in no order,
// and B*H blocks (320 at Zamba2, B = 4) fill 132 SMs 1.2 times.  Two instances by dtype:
//
//   * bfloat16 (the model's path): the chunk-parallel order of Mamba2's own kernels, three
//     launches on one stream (one wrapper call, one counted launch):
//       1. chunk states, grid (chunk, head, batch) -- 5,120 blocks at Zamba2's long prefill,
//          not 320: each chunk's own contribution s_c = x^T (exp(cum_Q - cum) dt o B) (P x N,
//          K = Q) and its total decay exponent cum_Q;
//       2. state passing, per (batch, head) and 256 state elements: S_in[c] = S, then
//          S = S exp(cum_Q[c]) + s_c, 16 steps; writes every entering state in place of s_c
//          and the final state;
//       3. chunk scan, grid (64-row tile of a chunk, head, batch): y = exp(cum_i) C_i S_in^T
//          plus G x over the 64-column tiles at or below the diagonal, G = (C B^T) o L o dt_j,
//          the exponents in base 2 and the mask applied only on the diagonal and last tiles.
//     Every product runs on the tensor cores (mma.sync m16n8k16, float32 accumulators): C, B
//     and x are bf16 inputs, so C B^T and the x-side operands are exact; the float32 operands
//     (G, S_in and the decay-weighted B) go in as hi = bf16(v), lo = bf16(v - hi) pairs, 16
//     significant bits, as the TPU kernel's float32 dots keep them.  mma.sync, not wgmma: the
//     tiles are 16 rows a warp and the A side of G x is made in registers from the C B^T
//     accumulators, and the products are not what bounds the scan (pass 3).  Tiles come in as
//     16-byte cp.async copies (rows of N or P a multiple of 8; scalar loads otherwise); x and the
//     weighted B reach the tensor cores transposed through ldmatrix.trans, with no transposed
//     copy.  C B^T is recomputed per head (the (B, L/Q, Q, Q) float32 buffer it would take,
//     16.8 MB at the long prefill, would be read back by 80 heads for 4 GFLOP of products
//     that cost less than the read).
//   * float32: ssd_scan_kernel, one block per (batch, head) walking its chunks with the state
//     in shared memory and float32 FMAs on the CUDA cores in 64-row tiles, so float32 callers
//     keep the reference's 2e-4.
//
// P <= 64 and N <= 128 (the shared-memory plan; every configuration of the port is inside),
// Q <= 1024, any L a multiple of Q; sizes off the tiles are zero-padded.
//
// Bound: the function's own bytes are xs, B, C, dt read once, y and the (B, H, P, N) float32
// final state written once; the operations are C B^T once per (batch, chunk), lower triangle
// only, Q (Q + 1) N; the masked product with x, Q (Q + 1) P per (batch, head, chunk); and the
// state terms, 2 P N per row and head for the read (past the first chunk) and 2 P N for the
// update; at the card's rate for the operands' type (bf16: 989 TFLOP/s).  At one Zamba2-2.7B
// layer with B = 4, L = 4096 (H = 80, P = 64, N = 64, Q = 256) in bf16: 347.6 MB (0.104 ms at
// 3.35 TB/s) and 42.6 GFLOP (0.043 ms): bound by bytes.  The bf16 design moves more: the
// (B, L/Q, H, P, N) float32 chunk states (83.9 MB) are written by pass 1, read and written by
// pass 2 and read by pass 3 (335.5 MB), and x, B and dt are read by passes 1 and 3 (+172.5 MB;
// the B rows once per head, mostly from L2): 855.6 MB, a floor of 0.255 ms.  Plain C entry
// point, loaded with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;           // float32: thread (ty, tx), ty = tid / 16, tx = tid % 16
constexpr int kThreads128 = 128;        // the bf16 passes' blocks: 4 warps
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kT = 64;                  // rows of a row tile (i) and of a column tile (j)
constexpr int kPMax = 64;
constexpr int kLX = kPMax + 1;          // row stride of the x tile
constexpr int kLG = kT + 1;             // row stride of the G tile

__device__ __forceinline__ float to_f32(float x) { return x; }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }

template <int NMAX>
size_t smem_bytes(int q) {
  return sizeof(float) * (static_cast<size_t>(2 * kT) * (NMAX + 1) + kT * kLX + kT * kLG +
                          static_cast<size_t>(kPMax) * (NMAX + 1) + 2 * static_cast<size_t>(q));
}

// Rows [r0, r0 + kT) of a (rows, width) slab, `stride` elements a row, into a float tile of
// row stride ld; rows at or past n_rows load as zeros.
template <typename T>
__device__ __forceinline__ void load_rows(float* tile, int ld, const T* base, int64_t stride,
                                          int r0, int n_rows, int width) {
  for (int i = threadIdx.x; i < kT * width; i += kThreads) {
    const int r = i / width;
    const int c = i - r * width;
    float x = 0.f;
    if (r0 + r < n_rows) x = to_f32(base[static_cast<int64_t>(r0 + r) * stride + c]);
    tile[r * ld + c] = x;
  }
}

template <typename T, int NMAX>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ xs, const T* __restrict__ bmat,
                const T* __restrict__ cmat, const T* __restrict__ dt,
                const float* __restrict__ a_h, T* __restrict__ y, float* __restrict__ state_out,
                int seq, int n_heads, int p_dim, int n_dim, int q) {
  constexpr int LN = NMAX + 1;          // odd: rows of B, C and the state in distinct banks
  constexpr int NC = NMAX / 16;         // state columns a thread owns: tx + 16 c
  extern __shared__ float smem[];
  float* sC = smem;                     // kT x LN: C rows of the row tile
  float* sB = sC + kT * LN;             // kT x LN: B rows of the column tile
  float* sX = sB + kT * LN;             // kT x kLX: x rows of the column tile
  float* sG = sX + kT * kLX;            // kT x kLG: decayed, masked C B^T
  float* sS = sG + kT * kLG;            // kPMax x LN: the state (p, n)
  float* sDt = sS + kPMax * LN;         // q
  float* sCum = sDt + q;                // q

  const int b = blockIdx.x / n_heads;
  const int h = blockIdx.x - b * n_heads;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const float a = a_h[h];
  const int64_t x_rs = static_cast<int64_t>(n_heads) * p_dim;   // xs / y row stride
  const T* xb = xs + static_cast<int64_t>(b) * seq * x_rs + static_cast<int64_t>(h) * p_dim;
  T* yb = y + static_cast<int64_t>(b) * seq * x_rs + static_cast<int64_t>(h) * p_dim;
  const T* bb = bmat + static_cast<int64_t>(b) * seq * n_dim;
  const T* cb = cmat + static_cast<int64_t>(b) * seq * n_dim;
  const T* db = dt + static_cast<int64_t>(b) * seq * n_heads + h;

  for (int i = tid; i < kPMax * LN; i += kThreads) sS[i] = 0.f;
  const int n_tiles = (q + kT - 1) / kT;

  for (int l0 = 0; l0 < seq; l0 += q) {
    __syncthreads();                    // the last chunk's readers of sDt / sCum are done
    for (int i = tid; i < q; i += kThreads) {
      sDt[i] = to_f32(db[static_cast<int64_t>(l0 + i) * n_heads]);
    }
    __syncthreads();
    if (tid < 32) {                     // cum = cumsum(dt * a), a warp scan
      float carry = 0.f;
      for (int base = 0; base < q; base += 32) {
        const int i = base + tid;
        float v = i < q ? sDt[i] * a : 0.f;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const float t = __shfl_up_sync(0xffffffffu, v, off);
          if (tid >= off) v += t;
        }
        v += carry;
        if (i < q) sCum[i] = v;
        carry = __shfl_sync(0xffffffffu, v, 31);
      }
    }
    __syncthreads();

    for (int it = 0; it < n_tiles; ++it) {
      const int i0 = it * kT;
      load_rows(sC, LN, cb + static_cast<int64_t>(l0) * n_dim, n_dim, i0, q, n_dim);
      __syncthreads();

      // the state entering the chunk: acc[i, p] = exp(cum_i) * sum_n C[i, n] S[p, n]
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
      for (int n = 0; n < n_dim; ++n) {
        float ca[4], sp[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) ca[r] = sC[(ty + 16 * r) * LN + n];
#pragma unroll
        for (int c = 0; c < 4; ++c) sp[c] = sS[(tx + 16 * c) * LN + n];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(ca[r], sp[c], acc[r][c]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + ty + 16 * r;
        const float e = i < q ? expf(sCum[i]) : 0.f;
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] *= e;
      }

      for (int jt = 0; jt <= it; ++jt) {
        const int j0 = jt * kT;
        load_rows(sB, LN, bb + static_cast<int64_t>(l0) * n_dim, n_dim, j0, q, n_dim);
        load_rows(sX, kLX, xb + static_cast<int64_t>(l0) * x_rs, x_rs, j0, q, p_dim);
        __syncthreads();
        // G[i, j] = (C_i . B_j) exp(cum_i - cum_j) dt_j for j <= i, else 0
        float g[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) g[r][c] = 0.f;
        for (int n = 0; n < n_dim; ++n) {
          float ca[4], bc[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) ca[r] = sC[(ty + 16 * r) * LN + n];
#pragma unroll
          for (int c = 0; c < 4; ++c) bc[c] = sB[(tx + 16 * c) * LN + n];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) g[r][c] = fmaf(ca[r], bc[c], g[r][c]);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = i0 + ty + 16 * r;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int j = j0 + tx + 16 * c;
            float val = 0.f;
            if (j <= i && i < q) val = g[r][c] * expf(sCum[i] - sCum[j]) * sDt[j];
            sG[(ty + 16 * r) * kLG + tx + 16 * c] = val;
          }
        }
        __syncthreads();
        // acc[i, p] += sum_j G[i, j] x[j, p]
        for (int jj = 0; jj < kT; ++jj) {
          float ga[4], xv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) ga[r] = sG[(ty + 16 * r) * kLG + jj];
#pragma unroll
          for (int c = 0; c < 4; ++c) xv[c] = sX[jj * kLX + tx + 16 * c];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(ga[r], xv[c], acc[r][c]);
        }
        __syncthreads();                // sB, sX, sG free for the next column tile
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + ty + 16 * r;
        if (i >= q) continue;
        T* yrow = yb + static_cast<int64_t>(l0 + i) * x_rs;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int p = tx + 16 * c;
          if (p < p_dim) yrow[p] = from_f32<T>(acc[r][c]);
        }
      }
    }

    // state = state * exp(cum_Q) + sum_j x[j, p] (exp(cum_Q - cum_j) dt_j) B[j, n]
    const float cum_last = sCum[q - 1];
    float st[4][NC];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < NC; ++c) st[r][c] = 0.f;
    for (int jt = 0; jt < n_tiles; ++jt) {
      const int j0 = jt * kT;
      __syncthreads();
      load_rows(sB, LN, bb + static_cast<int64_t>(l0) * n_dim, n_dim, j0, q, n_dim);
      load_rows(sX, kLX, xb + static_cast<int64_t>(l0) * x_rs, x_rs, j0, q, p_dim);
      __syncthreads();
      const int rows = min(kT, q - j0);
      for (int jj = 0; jj < rows; ++jj) {
        const float w = expf(cum_last - sCum[j0 + jj]) * sDt[j0 + jj];
        float xa[4], bn[NC];
#pragma unroll
        for (int r = 0; r < 4; ++r) xa[r] = sX[jj * kLX + ty + 16 * r] * w;
#pragma unroll
        for (int c = 0; c < NC; ++c) bn[c] = sB[jj * LN + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < NC; ++c) st[r][c] = fmaf(xa[r], bn[c], st[r][c]);
      }
    }
    __syncthreads();                    // every reader of the old state is done
    const float decay = expf(cum_last);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int p = ty + 16 * r;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int n = tx + 16 * c;
        if (p < p_dim && n < n_dim) sS[p * LN + n] = sS[p * LN + n] * decay + st[r][c];
      }
    }
  }
  __syncthreads();
  float* so = state_out + (static_cast<int64_t>(b) * n_heads + h) * p_dim * n_dim;
  for (int i = tid; i < p_dim * n_dim; i += kThreads) {
    const int p = i / n_dim;
    const int n = i - p * n_dim;
    so[i] = sS[p * LN + n];
  }
}

template <typename T, int NMAX>
cudaError_t launch(const void* xs, const void* bm, const void* cm, const void* dt,
                   const void* a, void* y, void* state, int batch, int seq, int n_heads,
                   int p_dim, int n_dim, int q, cudaStream_t stream) {
  const size_t smem = smem_bytes<NMAX>(q);
  auto kernel = ssd_scan_kernel<T, NMAX>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<batch * n_heads, kThreads, smem, stream>>>(
      static_cast<const T*>(xs), static_cast<const T*>(bm), static_cast<const T*>(cm),
      static_cast<const T*>(dt), static_cast<const float*>(a), static_cast<T*>(y),
      static_cast<float*>(state), seq, n_heads, p_dim, n_dim, q);
  return cudaGetLastError();
}

// ---- bfloat16: the chunk-parallel design on the tensor cores ----

using bf16 = __nv_bfloat16;
constexpr int kLX16 = kPMax + 8;        // row stride of a bf16 x tile (j, p)

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

// Four 8x8 bf16 matrices from shared memory, each transposed: thread l gives the address of
// row l % 8 of matrix l / 8 and receives, for matrix m, M[2 (l % 4)][l / 4] and
// M[2 (l % 4) + 1][l / 4] in r[m] -- the mma fragment of the transposed matrix.
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float x0, float x1) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Two float32 values as two packed bf16 pairs: hi = bf16(x), lo = bf16(x - hi), so that
// hi + lo carries 16 significant bits of x (relative error at most 2^-17).
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x0 - hf.x, x1 - hf.y);
}

// 16 bytes global -> shared without a register stop (cp.async); src_bytes 0 writes zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {   // commits and waits for every copy
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// 2^x on the special-function unit (ex2.approx.ftz: about 2 ulp; subnormal results flush to
// zero, far below bf16's use here).
__device__ __forceinline__ float fast_ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Rows [r0, r0 + ROWS) of a bf16 slab (`stride` elements a row) into a bf16 tile of row stride
// ld and width W, by NT threads: zeros at rows >= n_rows and columns >= width.  With `vec`
// (width a multiple of 8 and 16-byte aligned rows) each thread issues 16-byte cp.async copies,
// which land by the caller's cp_async_wait_all(); otherwise plain scalar loads.  Either way the
// tile is complete after cp_async_wait_all() and a barrier.
template <int W, int ROWS, int NT>
__device__ __forceinline__ void load_bf16_tile(bf16* tile, int ld, const bf16* base,
                                               int64_t stride, int r0, int n_rows, int width,
                                               bool vec) {
  constexpr int kCpr = W / 8;           // 16-byte pieces of a tile row
  if (vec) {
    for (int i = threadIdx.x; i < ROWS * kCpr; i += NT) {
      const int r = i / kCpr;
      const int col = (i % kCpr) * 8;
      const bool in = r0 + r < n_rows && col < width;
      cp_async16(tile + r * ld + col,
                 in ? base + static_cast<int64_t>(r0 + r) * stride + col : base, in);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * W; i += NT) {
      const int r = i / W;
      const int col = i % W;
      bf16 x = __float2bfloat16(0.f);
      if (r0 + r < n_rows && col < width) x = base[static_cast<int64_t>(r0 + r) * stride + col];
      tile[r * ld + col] = x;
    }
  }
}

// dt of chunk rows [0, n) into sDt, by all NT threads at once (the rows are H apart).
template <int NT>
__device__ __forceinline__ void load_dt(const bf16* db, int64_t stride, int n, float* sDt) {
  for (int i = threadIdx.x; i < n; i += NT) {
    sDt[i] = __bfloat162float(db[static_cast<int64_t>(i) * stride]);
  }
}

// cum = cumsum(dt * a) over rows [0, n) from sDt into sCum: a warp scan by warp 0, after a
// barrier that follows load_dt (the chunk scan passes a * log2(e), for exponents in base 2).
__device__ __forceinline__ void scan_dt(float a, int n, const float* sDt, float* sCum) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  float carry = 0.f;
  for (int base = 0; base < n; base += 32) {
    const int i = base + lane;
    float v = i < n ? sDt[i] * a : 0.f;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float t = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += t;
    }
    v += carry;
    if (i < n) sCum[i] = v;
    carry = __shfl_sync(0xffffffffu, v, 31);
  }
}

// The row stride of a bf16 (row, n) tile: 8 elements of pad put the 8 rows of an mma
// fragment or an ldmatrix in distinct banks.
template <int NMAX>
__host__ __device__ constexpr int ln16() { return NMAX + 8; }

inline size_t round4(int q) { return (static_cast<size_t>(q) + 3) & ~static_cast<size_t>(3); }

template <int NMAX>
size_t chunk_state_smem(int q) {
  return sizeof(bf16) * (static_cast<size_t>(kT) * kLX16 + 2 * static_cast<size_t>(kT) *
                         ln16<NMAX>()) + 2 * sizeof(float) * static_cast<size_t>(q);
}

// Pass 1, one block per (chunk, head, batch): the chunk's own state contribution
//   s_c[p, n] = sum_j x[j, p] w_j B[j, n],   w_j = exp(cum_Q - cum_j) dt_j,
// an (P x N) product over K = Q on the tensor cores: A = x^T straight from the (j, p) tile
// through ldmatrix.trans, B = w o B as the pair hi + lo of bf16 tiles; and the chunk's total
// decay exponent cum_Q (<= 0) for pass 2.  Warp w owns state rows p = 16 w .. 16 w + 15.
template <int NMAX>
__global__ void __launch_bounds__(kThreads128)
ssd_chunk_state_kernel(const bf16* __restrict__ xs, const bf16* __restrict__ bmat,
                       const bf16* __restrict__ dt, const float* __restrict__ a_h,
                       float* __restrict__ states, float* __restrict__ tot, int seq,
                       int n_heads, int p_dim, int n_dim, int q, int vec_x, int vec_b) {
  constexpr int LN = ln16<NMAX>();
  constexpr int NT = NMAX / 8;          // state column tiles of 8
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sX = reinterpret_cast<bf16*>(smem_raw);   // kT x kLX16: x rows (j, p)
  bf16* sBh = sX + kT * kLX16;                     // kT x LN: hi of w o B (j, n)
  bf16* sBl = sBh + kT * LN;                       // kT x LN: lo of w o B
  float* sDt = reinterpret_cast<float*>(sBl + kT * LN);   // q
  float* sCum = sDt + q;                                   // q

  const int c = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int n_chunks = seq / q;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int64_t l0 = static_cast<int64_t>(b) * seq + static_cast<int64_t>(c) * q;
  const int64_t x_rs = static_cast<int64_t>(n_heads) * p_dim;
  const bf16* xb = xs + l0 * x_rs + static_cast<int64_t>(h) * p_dim;
  const bf16* bb = bmat + l0 * n_dim;

  load_dt<kThreads128>(dt + l0 * n_heads + h, n_heads, q, sDt);
  __syncthreads();
  scan_dt(a_h[h], q, sDt, sCum);
  __syncthreads();
  const float cum_q = sCum[q - 1];
  const int64_t bch = (static_cast<int64_t>(b) * n_chunks + c) * n_heads + h;
  if (tid == 0) tot[bch] = cum_q;

  float acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

  for (int j0 = 0; j0 < q; j0 += kT) {
    __syncthreads();                    // the last tile's readers are done
    load_bf16_tile<kPMax, kT, kThreads128>(sX, kLX16, xb, x_rs, j0, q, p_dim, vec_x);
    // w o B, split into hi + lo, 8 columns a trip
    for (int i = tid; i < kT * (NMAX / 8); i += kThreads128) {
      const int r = i / (NMAX / 8);
      const int col = (i % (NMAX / 8)) * 8;
      const int j = j0 + r;
      float v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = 0.f;
      if (j < q && col < n_dim) {
        const float w = __expf(cum_q - sCum[j]) * sDt[j];
        const bf16* src = bb + static_cast<int64_t>(j) * n_dim + col;
        if (vec_b) {
          const uint4 raw = *reinterpret_cast<const uint4*>(src);
          const bf16* e8 = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] = __bfloat162float(e8[e]) * w;
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            if (col + e < n_dim) v[e] = __bfloat162float(src[e]) * w;
          }
        }
      }
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) split_bf16(v[2 * e], v[2 * e + 1], hi[e], lo[e]);
      *reinterpret_cast<uint4*>(sBh + r * LN + col) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(sBl + r * LN + col) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
    cp_async_wait_all();
    __syncthreads();

    const int mi = lane >> 3;           // the ldmatrix matrix this lane addresses
    const int mr = lane & 7;            // and its row
#pragma unroll
    for (int kk = 0; kk < kT / 16; ++kk) {
      // A = x^T (rows p, k = j): matrices (j 0-7 | 8-15) x (p 0-7 | 8-15), a0..a3
      uint32_t af[4];
      ldsm_x4_t(af, sX + (kk * 16 + (mi >> 1) * 8 + mr) * kLX16 + warp * 16 + (mi & 1) * 8);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        // B = (w o B) (k = j, n): matrices (j 0-7 | 8-15) for column tiles 2 np, 2 np + 1
        const int off = (kk * 16 + (mi & 1) * 8 + mr) * LN + np * 16 + (mi >> 1) * 8;
        uint32_t bh[4], bl[4];
        ldsm_x4_t(bh, sBh + off);
        ldsm_x4_t(bl, sBl + off);
        mma_bf16(acc[2 * np], af, bh[0], bh[1]);
        mma_bf16(acc[2 * np], af, bl[0], bl[1]);
        mma_bf16(acc[2 * np + 1], af, bh[2], bh[3]);
        mma_bf16(acc[2 * np + 1], af, bl[2], bl[3]);
      }
    }
  }

  float* so = states + bch * p_dim * n_dim;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = warp * 16 + gid + (e >> 1) * 8;
      const int n = nt * 8 + tig * 2 + (e & 1);
      if (p < p_dim && n < n_dim) so[p * n_dim + n] = acc[nt][e];
    }
  }
}

// Pass 2, per (batch, head) and 256 state elements a block: walks the chunks in order,
// replacing each chunk's s_c by the state entering it, S_in[c] = S, then
// S = S exp(cum_Q[c]) + s_c; the last S is the final state.  The loads of 8 chunks are issued
// before their dependent updates, so the walk waits on memory once per 8 chunks, not per chunk.
__global__ void __launch_bounds__(256)
ssd_state_pass_kernel(float* __restrict__ states, const float* __restrict__ tot,
                      float* __restrict__ state_out, int n_chunks, int n_heads, int pn) {
  constexpr int kBatch = 8;
  const int e = blockIdx.x * 256 + threadIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  if (e >= pn) return;
  float s = 0.f;
  for (int c0 = 0; c0 < n_chunks; c0 += kBatch) {
    float contrib[kBatch], decay[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int64_t bch = (static_cast<int64_t>(b) * n_chunks + c0 + u) * n_heads + h;
      contrib[u] = c0 + u < n_chunks ? states[bch * pn + e] : 0.f;
      decay[u] = c0 + u < n_chunks ? __expf(tot[bch]) : 1.f;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (c0 + u < n_chunks) {
        const int64_t bch = (static_cast<int64_t>(b) * n_chunks + c0 + u) * n_heads + h;
        states[bch * pn + e] = s;
        s = s * decay[u] + contrib[u];
      }
    }
  }
  state_out[(static_cast<int64_t>(b) * n_heads + h) * pn + e] = s;
}

// Pass 3, one block per (64-row tile of a chunk, head, batch), the tiles of a chunk issued
// longest-first: for rows i of the tile,
//   y[i] = exp(cum_i) (C_i S_in^T)  +  sum over 64-column tiles J <= I of G_IJ x_J,
//   G[i, j] = (C_i . B_j) exp(cum_i - cum_j) dt_j for j <= i, else 0,
// every product on the tensor cores: C_i S_in^T with S_in split into hi + lo bf16 as its
// fragments are read; C_I B_J^T exact (bf16 operands); G x_J with G as hi + lo A fragments
// made in registers from the C B^T accumulators (the flash kernel's P V conversion) and x_J
// through ldmatrix.trans.  The S_in tile and the first column tile come by cp.async with the
// C tile.  G is the kernel's own cost (dropping its exponents took 0.22 of 0.97 ms; dropping
// the loads or the products, 0.05 each): cum is kept in base 2, each thread reads its column
// pair's cum and dt once, and the mask is applied only on the diagonal tile and the chunk's
// last row tile.  (Double-buffered column tiles measured no faster, and row tiles of 128 with
// 8 warps slower: 145 registers a thread leave one block an SM.)  Warp w owns rows
// 16 w .. 16 w + 15 of the tile and skips a column tile wholly above its rows.

template <int NMAX>
size_t chunk_scan_smem(int q) {
  return sizeof(bf16) * (static_cast<size_t>(kT) * ln16<NMAX>() +
                         static_cast<size_t>(kT) * (ln16<NMAX>() + kLX16)) +
         sizeof(float) * (static_cast<size_t>(kPMax) * ln16<NMAX>() + 2 * round4(q));
}

template <int NMAX>
__global__ void __launch_bounds__(kThreads128)
ssd_chunk_scan_kernel(const bf16* __restrict__ xs, const bf16* __restrict__ bmat,
                      const bf16* __restrict__ cmat, const bf16* __restrict__ dt,
                      const float* __restrict__ a_h, const float* __restrict__ states,
                      bf16* __restrict__ y, int seq, int n_heads, int p_dim, int n_dim, int q,
                      int vec_x, int vec_b) {
  constexpr int LN = ln16<NMAX>();
  constexpr int KN = NMAX / 16;         // k steps over the state width
  constexpr int PT = kPMax / 8;         // output column tiles of 8
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sC = reinterpret_cast<bf16*>(smem_raw);   // kT x LN: C rows of the row tile
  bf16* sB = sC + kT * LN;                        // kT x LN: B rows of the column tile
  bf16* sX = sB + kT * LN;                         // kT x kLX16: x rows of the column tile
  float* sS = reinterpret_cast<float*>(sX + kT * kLX16);   // kPMax x LN: S_in (p, n)
  float* sDt = sS + kPMax * LN;                                  // q, rounded up to 4
  float* sCum = sDt + ((q + 3) & ~3);                            // q: cum * log2(e)

  const int n_it = (q + kT - 1) / kT;
  const int c = blockIdx.x / n_it;
  const int it = n_it - 1 - static_cast<int>(blockIdx.x % n_it);   // longest first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int n_chunks = seq / q;
  const int i0 = it * kT;
  const int i_end = min(q, i0 + kT);   // rows of this tile: [i0, i_end)
  const int n_jt = (i_end + kT - 1) / kT;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int mi = lane >> 3;
  const int mr = lane & 7;
  const int64_t l0 = static_cast<int64_t>(b) * seq + static_cast<int64_t>(c) * q;
  const int64_t x_rs = static_cast<int64_t>(n_heads) * p_dim;
  const bf16* xb = xs + l0 * x_rs + static_cast<int64_t>(h) * p_dim;
  const bf16* bb = bmat + l0 * n_dim;
  const bf16* cb = cmat + l0 * n_dim;
  const int64_t bch = (static_cast<int64_t>(b) * n_chunks + c) * n_heads + h;
  const float* s_in = states + bch * p_dim * n_dim;

  auto load_column_tile = [&](int jt) {
    load_bf16_tile<NMAX, kT, kThreads128>(sB, LN, bb, n_dim, jt * kT, q, n_dim, vec_b);
    load_bf16_tile<kPMax, kT, kThreads128>(sX, kLX16, xb, x_rs, jt * kT, q, p_dim, vec_x);
  };

  load_bf16_tile<NMAX, kT, kThreads128>(sC, LN, cb, n_dim, i0, q, n_dim, vec_b);
  load_column_tile(0);
  load_dt<kThreads128>(dt + l0 * n_heads + h, n_heads, i_end, sDt);
  const bool carry = c > 0;             // S_in is zero for the first chunk
  if (carry) {                          // S_in (float32) with the C tile, 16 bytes a copy
    const bool vec_s = n_dim % 4 == 0;
    for (int i = tid; i < kPMax * (NMAX / 4); i += kThreads128) {
      const int p = i / (NMAX / 4);
      const int n = (i % (NMAX / 4)) * 4;
      if (vec_s) {
        const bool in = p < p_dim && n < n_dim;
        cp_async16(sS + p * LN + n, in ? s_in + p * n_dim + n : s_in, in);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sS[p * LN + n + e] = p < p_dim && n + e < n_dim ? s_in[p * n_dim + n + e] : 0.f;
        }
      }
    }
  }
  __syncthreads();
  scan_dt(a_h[h] * kLog2e, i_end, sDt, sCum);
  cp_async_wait_all();
  __syncthreads();

  const int row0 = i0 + warp * 16 + gid;          // chunk row of fragment rows e < 2
  const int rows[2] = {row0, row0 + 8};
  const bool live = i0 + warp * 16 < q;           // the warp has rows in the chunk
  // the warp's C rows as the A fragment of k step kk, read from shared memory at each use
  const bf16* c_row = sC + (warp * 16 + gid) * LN + tig * 2;
  auto c_frag = [&](int kk, uint32_t (&f)[4]) {
    f[0] = ld32(c_row + kk * 16);
    f[1] = ld32(c_row + 8 * LN + kk * 16);
    f[2] = ld32(c_row + kk * 16 + 8);
    f[3] = ld32(c_row + 8 * LN + kk * 16 + 8);
  };
  float cum_i[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) cum_i[r] = rows[r] < q ? sCum[rows[r]] : 0.f;

  float acc[PT][4];
#pragma unroll
  for (int pt = 0; pt < PT; ++pt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[pt][e] = 0.f;

  if (carry && live) {                  // exp(cum_i) (C_i S_in^T)
#pragma unroll
    for (int kk = 0; kk < KN; ++kk) {
      uint32_t ca[4];
      c_frag(kk, ca);
#pragma unroll
      for (int pt = 0; pt < PT; ++pt) {
        // the B fragment (k = n, column p) of S_in, split into hi + lo as it is read
        const float* sp = sS + (pt * 8 + gid) * LN + kk * 16 + tig * 2;
        const float2 v0 = *reinterpret_cast<const float2*>(sp);
        const float2 v1 = *reinterpret_cast<const float2*>(sp + 8);
        uint32_t h0, l0, h1, l1;
        split_bf16(v0.x, v0.y, h0, l0);
        split_bf16(v1.x, v1.y, h1, l1);
        mma_bf16(acc[pt], ca, h0, h1);
        mma_bf16(acc[pt], ca, l0, l1);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float e = rows[r] < q ? fast_ex2(cum_i[r]) : 0.f;
#pragma unroll
      for (int pt = 0; pt < PT; ++pt) {
        acc[pt][2 * r] *= e;
        acc[pt][2 * r + 1] *= e;
      }
    }
  }

  for (int jt = 0; jt < n_jt; ++jt) {
    if (jt > 0) {                       // the first column tile came with the C tile
      __syncthreads();                  // every warp is done with the last one
      load_column_tile(jt);
      cp_async_wait_all();
      __syncthreads();
    }
    const int j0 = jt * kT;
    const bf16* tB = sB;
    const bf16* tX = sX;
    if (live && j0 <= i0 + warp * 16 + 15) {
      // C_I B_J^T: 16 rows x 64 columns a warp
      float g[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) g[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KN; ++kk) {
        uint32_t ca[4];
        c_frag(kk, ca);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const bf16* bp = tB + (nt * 8 + gid) * LN + kk * 16 + tig * 2;
          mma_bf16(g[nt], ca, ld32(bp), ld32(bp + 8));
        }
      }
      // G = (C B^T) o exp(cum_i - cum_j) o dt_j, zero above the diagonal and past q; only
      // the diagonal tile and the chunk's last row tile need the mask
      const bool edge = jt == it || i0 + kT > q;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int jb = j0 + nt * 8 + tig * 2;     // this thread's two columns jb, jb + 1
        float2 cj = make_float2(0.f, 0.f), dj = make_float2(0.f, 0.f);
        if (jb < i_end) {
          cj = *reinterpret_cast<const float2*>(sCum + jb);
          dj = *reinterpret_cast<const float2*>(sDt + jb);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float w = fast_ex2(cum_i[e >> 1] - ((e & 1) ? cj.y : cj.x)) *
                          ((e & 1) ? dj.y : dj.x);
          const bool keep = !edge || (jb + (e & 1) <= rows[e >> 1] && rows[e >> 1] < q);
          g[nt][e] = keep ? g[nt][e] * w : 0.f;
        }
      }
      // y += G x_J: the G fragments of column tiles 2 kk, 2 kk + 1 are the A fragment of key
      // step kk, as hi + lo
#pragma unroll
      for (int kk = 0; kk < kT / 16; ++kk) {
        uint32_t hi[4], lo[4];
        split_bf16(g[2 * kk][0], g[2 * kk][1], hi[0], lo[0]);
        split_bf16(g[2 * kk][2], g[2 * kk][3], hi[1], lo[1]);
        split_bf16(g[2 * kk + 1][0], g[2 * kk + 1][1], hi[2], lo[2]);
        split_bf16(g[2 * kk + 1][2], g[2 * kk + 1][3], hi[3], lo[3]);
#pragma unroll
        for (int pp = 0; pp < PT / 2; ++pp) {
          uint32_t xf[4];
          ldsm_x4_t(xf, tX + (kk * 16 + (mi & 1) * 8 + mr) * kLX16 + pp * 16 + (mi >> 1) * 8);
          mma_bf16(acc[2 * pp], hi, xf[0], xf[1]);
          mma_bf16(acc[2 * pp], lo, xf[0], xf[1]);
          mma_bf16(acc[2 * pp + 1], hi, xf[2], xf[3]);
          mma_bf16(acc[2 * pp + 1], lo, xf[2], xf[3]);
        }
      }
    }
  }

  bf16* yb = y + l0 * x_rs + static_cast<int64_t>(h) * p_dim;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= q) continue;
    bf16* yrow = yb + static_cast<int64_t>(rows[r]) * x_rs;
#pragma unroll
    for (int pt = 0; pt < PT; ++pt) {
      const int p = pt * 8 + tig * 2;
      if (p < p_dim) yrow[p] = __float2bfloat16(acc[pt][2 * r]);
      if (p + 1 < p_dim) yrow[p + 1] = __float2bfloat16(acc[pt][2 * r + 1]);
    }
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

// The three passes of the bf16 scan on one stream.  `states` (B, L/Q, H, P, N) and `tot`
// (B, L/Q, H) float32 are the wrapper's scratch.
template <int NMAX>
cudaError_t launch_chunked(const void* xs, const void* bm, const void* cm, const void* dt,
                           const void* a, void* y, void* state, void* states, void* tot,
                           int batch, int seq, int n_heads, int p_dim, int n_dim, int q,
                           cudaStream_t stream) {
  const int n_chunks = seq / q;
  const int n_it = (q + kT - 1) / kT;
  const int vec_x = p_dim % 8 == 0 && aligned16(xs);
  const int vec_b = n_dim % 8 == 0 && aligned16(bm) && aligned16(cm);
  const size_t smem_a = chunk_state_smem<NMAX>(q);
  const size_t smem_c = chunk_scan_smem<NMAX>(q);
  cudaError_t err = allow_smem(ssd_chunk_state_kernel<NMAX>, smem_a);
  if (err == cudaSuccess) err = allow_smem(ssd_chunk_scan_kernel<NMAX>, smem_c);
  if (err != cudaSuccess) return err;
  const bf16* x16 = static_cast<const bf16*>(xs);
  const bf16* b16 = static_cast<const bf16*>(bm);
  const bf16* dt16 = static_cast<const bf16*>(dt);
  const float* af = static_cast<const float*>(a);
  float* st = static_cast<float*>(states);
  float* tt = static_cast<float*>(tot);
  ssd_chunk_state_kernel<NMAX><<<dim3(n_chunks, n_heads, batch), kThreads128, smem_a, stream>>>(
      x16, b16, dt16, af, st, tt, seq, n_heads, p_dim, n_dim, q, vec_x, vec_b);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int pn = p_dim * n_dim;
  ssd_state_pass_kernel<<<dim3((pn + 255) / 256, n_heads, batch), 256, 0, stream>>>(
      st, tt, static_cast<float*>(state), n_chunks, n_heads, pn);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_chunk_scan_kernel<NMAX><<<dim3(n_chunks * n_it, n_heads, batch), kThreads128, smem_c,
                                stream>>>(
      x16, b16, static_cast<const bf16*>(cm), dt16, af, st, static_cast<bf16*>(y), seq,
      n_heads, p_dim, n_dim, q, vec_x, vec_b);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_fma(const void* xs, const void* bm, const void* cm, const void* dt,
                         const void* a, void* y, void* state, int batch, int seq, int n_heads,
                         int p_dim, int n_dim, int q, cudaStream_t s) {
  if (n_dim <= 64) {
    return launch<T, 64>(xs, bm, cm, dt, a, y, state, batch, seq, n_heads, p_dim, n_dim, q, s);
  }
  return launch<T, 128>(xs, bm, cm, dt, a, y, state, batch, seq, n_heads, p_dim, n_dim, q, s);
}

}  // namespace

// The SSD binding: xs, B, C, dt, a, y, the final state, the bf16 instance's scratch (chunk
// states (B, L/Q, H, P, N) and decays (B, L/Q, H), float32; unused for float32), then B, L, H,
// P, N, Q, dtype (0 float32, 1 bfloat16) and the stream; returns a cudaError_t (0 on
// success).  Refuses what the wrapper refuses (a non-positive dim, P > 64, N > 128, Q > 1024,
// L not a multiple of Q), a grid past the card's limits and missing scratch.
extern "C" int ssd_scan_launch(const void* xs, const void* bm, const void* cm, const void* dt,
                               const void* a, void* y, void* state, void* states, void* tot,
                               int batch, int seq, int n_heads, int p_dim, int n_dim, int q,
                               int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch <= 0 || seq <= 0 || n_heads <= 0 || p_dim <= 0 || n_dim <= 0 || q <= 0 ||
      p_dim > kPMax || n_dim > 128 || q > 1024 || seq % q != 0 ||
      static_cast<long long>(batch) * n_heads > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 0) {
    return static_cast<int>(dispatch_fma<float>(xs, bm, cm, dt, a, y, state, batch, seq,
                                                n_heads, p_dim, n_dim, q, s));
  }
  if (dtype == 1) {
    if (states == nullptr || tot == nullptr || n_heads > 65535 || batch > 65535) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    if (n_dim <= 64) {
      return static_cast<int>(launch_chunked<64>(xs, bm, cm, dt, a, y, state, states, tot,
                                                 batch, seq, n_heads, p_dim, n_dim, q, s));
    }
    return static_cast<int>(launch_chunked<128>(xs, bm, cm, dt, a, y, state, states, tot,
                                                batch, seq, n_heads, p_dim, n_dim, q, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

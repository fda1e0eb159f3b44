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
// returns it; the TPU kernel does not).
//
// The TPU kernel walks a (B*H, L/Q) grid whose trailing chunk axis runs in order, its state in
// VMEM scratch, and holds the whole (Q, Q) chunk matrix (256 KB of float32 at Q = 256: more
// than the 227 KB of shared memory a Hopper block can have).  Here one block owns one
// (batch, head) and loops over its chunks, the state in shared memory, and computes y in row
// tiles of 64: for row tile I it forms the state term, then for each column tile J <= I the
// 64 x 64 tile G = (C_I B_J^T) o exp(cum_i - cum_j) o dt_j (zero above the diagonal) and
// adds G x_J.  The decay is formed from the difference cum_i - cum_j <= 0, never as
// exp(cum_i) * exp(-cum_j): cum falls without bound (a < 0, dt > 0), and every exponent here
// is <= 0.  B and C are read by batch, not by batch*head; the heads of one batch read the same
// rows, mostly from L2.  The state update walks the column tiles once more after the chunk's
// y.  The cumsum is a warp scan.  P <= 64 and N <= 128 (the shared-memory plan; every
// configuration of the port is inside), Q <= 1024.
//
// Bound: the bytes are xs, B, C, dt read once, y and the (B, H, P, N) float32 final state
// written once.  The operations are the function's own need: C B^T once per (batch, chunk),
// lower triangle only, Q (Q + 1) N; the masked product with x, Q (Q + 1) P per (batch, head,
// chunk); and the state terms, 2 P N per row and head for the read (past the first chunk)
// and 2 P N for the update; at the card's rate for the operands' type (bf16: 989 TFLOP/s).
// At one Zamba2-2.7B layer with B = 4, L = 4096 (H = 80, P = 64, N = 64, Q = 256) in bf16:
// 348 MB (0.104 ms at 3.35 TB/s) and 43 GFLOP (0.043 ms): bound by bytes.  (The TPU kernel
// recomputes C B^T per head and forms the whole Q x Q square, 107 GFLOP at this shape; this
// kernel also recomputes C B^T per head, over the tiles at or below the diagonal.)  This
// first kernel does its products as float32 FMAs on the CUDA cores and runs B*H blocks (320
// at Zamba2, B = 4); tensor-core tiles and a chunk-parallel two-pass scan are later steps.
// Plain C entry point, loaded with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;           // thread (ty, tx): ty = tid / 16, tx = tid % 16
constexpr int kT = 64;                  // rows of a row tile (i) and of a column tile (j)
constexpr int kPMax = 64;
constexpr int kLX = kPMax + 1;          // row stride of the x tile
constexpr int kLG = kT + 1;             // row stride of the G tile

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

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

template <typename T>
cudaError_t dispatch(const void* xs, const void* bm, const void* cm, const void* dt,
                     const void* a, void* y, void* state, int batch, int seq, int n_heads,
                     int p_dim, int n_dim, int q, cudaStream_t s) {
  if (n_dim <= 64) {
    return launch<T, 64>(xs, bm, cm, dt, a, y, state, batch, seq, n_heads, p_dim, n_dim, q, s);
  }
  return launch<T, 128>(xs, bm, cm, dt, a, y, state, batch, seq, n_heads, p_dim, n_dim, q, s);
}

}  // namespace

// The SSD binding: xs, B, C, dt, a, y, the final state, then B, L, H, P, N, Q, dtype
// (0 float32, 1 bfloat16) and the stream; returns a cudaError_t (0 on success).  Refuses what
// the wrapper refuses (a non-positive dim, P > 64, N > 128, Q > 1024, L not a multiple of Q).
extern "C" int ssd_scan_launch(const void* xs, const void* bm, const void* cm, const void* dt,
                               const void* a, void* y, void* state, int batch, int seq,
                               int n_heads, int p_dim, int n_dim, int q, int dtype,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch <= 0 || seq <= 0 || n_heads <= 0 || p_dim <= 0 || n_dim <= 0 || q <= 0 ||
      p_dim > kPMax || n_dim > 128 || q > 1024 || seq % q != 0 ||
      static_cast<long long>(batch) * n_heads > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 0) {
    return static_cast<int>(dispatch<float>(xs, bm, cm, dt, a, y, state, batch, seq, n_heads,
                                            p_dim, n_dim, q, s));
  }
  if (dtype == 1) {
    return static_cast<int>(dispatch<__nv_bfloat16>(xs, bm, cm, dt, a, y, state, batch, seq,
                                                    n_heads, p_dim, n_dim, q, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

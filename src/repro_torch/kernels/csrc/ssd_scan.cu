// Mamba2 SSD chunked scan for Hopper (sm_90a), with the (P, N) state
// carried from chunk to chunk inside one block.
//
// Replaces the Pallas TPU kernel repro/kernels/ssd_scan.py::ssd_scan (body
// _ssd_kernel).  x (B, S, H, P) float32 or bfloat16; post-softplus dt
// (B, S, H), negative A (H,), B_ and C_ (B, S, N), one group shared by every
// head, all float32; all contiguous.  Writes y (B, S, H, P) in x's dtype and
// the final state (B, H, P, N) in float32, where
//   state_i = exp(dt_i A) state_{i-1} + dt_i x_i B_i^T,   y_i = C_i . state_i.
// In chunks of Q rows, with cum the inclusive prefix sum of dt A in the
// chunk, as the Pallas kernel and models/ssm.ssd_chunked compute it:
//   y_i   = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//           + exp(cum_i) C_i . state^T
//   state = exp(cum_last) state + sum_j exp(cum_last - cum_j) dt_j x_j B_j^T
// x and y are read and written where they lie, row stride H*P: no
// transposed copy.  A short last chunk (S % Q != 0) is masked: its missing
// rows count as dt = 0, x = B = C = 0, which leaves the state and every
// earlier output unchanged (the Pallas version asserts S % Q == 0).
//
// Bound: per (batch, head) and chunk the work is the causal half of the
// Q x Q products (C B^T over N, then times x over P), the state term and
// the state update (Q P N each); C B^T does not depend on the head.  The
// serve path's 32-row prefills are bound by bytes (x, B, C read and y and
// the state written once), a long prefill by arithmetic.  This first
// version computes in float32 on the CUDA cores (no mma / wgmma, no TMA),
// and every head's block computes its own C B^T; both are later work.
//
// Design: one block of 256 threads per (head, batch) walks the chunks in
// order, the state (P, N) in shared memory as float32.  Per chunk: dt and
// the prefix sum cum by a block-wide scan; then for each 64-row output tile
// I, first the state term, then for each tile J <= I the 64x64 tile
// G = C_I B_J^T, masked (j <= i) and decayed, into shared memory, times x_J;
// then the state update, streamed over the J tiles.  The exponential is
// taken only where j <= i, where cum_i - cum_j <= 0, so no inf is formed.
// Thread (ty, tx) = (tid / 16, tid % 16) owns rows ty + 16 a and columns
// tx + 16 b of each 64-row product, in registers.  Rows of B, C and the
// state are padded by one float, so the column reads hit distinct banks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;                 // rows of a row tile
constexpr int kGrid = 16;                 // the 16 x 16 thread grid
constexpr int kRows = kTile / kGrid;      // tile rows (and G columns) a thread owns
constexpr int kLdM = kTile + 1;
constexpr int kMaxDim = 128;              // largest P and N
constexpr int kMaxChunk = 1024;
constexpr int kMaxDevices = 16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// shared memory in floats: cum, dt and w (Q each), the scan's warp sums,
// the state (P x (N+1)), the C and B tiles (64 x (N+1)), the x tile
// (64 x P) and the masked G tile (64 x 65)
__host__ __device__ constexpr size_t smem_floats(int Q, int P, int N) {
  return (size_t)3 * Q + kWarps + (size_t)P * (N + 1) +
         (size_t)2 * kTile * (N + 1) + (size_t)kTile * P +
         (size_t)kTile * kLdM;
}

// rows [0, 64) of an (rows, cols) slab with row stride `stride` -> float32
// tile with row stride `ld`; rows at or past `valid` are zero
template <typename T>
__device__ __forceinline__ void load_tile(float* __restrict__ dst, int ld,
                                          const T* __restrict__ src,
                                          size_t stride, int cols, int valid) {
  for (int idx = threadIdx.x; idx < kTile * cols; idx += kThreads) {
    const int r = idx / cols, c = idx % cols;
    dst[r * ld + c] = r < valid ? to_f32(src[(size_t)r * stride + c]) : 0.f;
  }
}

// PC: columns of P a thread owns in a y tile (and rows of P in the state
// update); NC: columns of N it owns in the state update.  4 for P, N <= 64,
// 8 up to 128.
template <typename T, int PC, int NC>
__global__ void __launch_bounds__(kThreads)
ssd_fwd(const T* __restrict__ x, const float* __restrict__ dt,
        const float* __restrict__ A, const float* __restrict__ Bm,
        const float* __restrict__ Cm, T* __restrict__ y,
        float* __restrict__ state_out, int S, int H, int P, int N, int Q) {
  extern __shared__ float smem[];
  const int ldN = N + 1;
  float* s_cum = smem;                 // Q
  float* s_dt = s_cum + Q;             // Q
  float* s_w = s_dt + Q;               // Q: exp(cum_last - cum_j) dt_j
  float* s_warp = s_w + Q;             // kWarps
  float* s_state = s_warp + kWarps;    // P x ldN
  float* s_c = s_state + P * ldN;      // kTile x ldN
  float* s_b = s_c + kTile * ldN;      // kTile x ldN
  float* s_x = s_b + kTile * ldN;      // kTile x P
  float* s_m = s_x + kTile * P;        // kTile x kLdM

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int tx = tid % kGrid, ty = tid / kGrid;
  const float a = A[h];
  const size_t x_stride = (size_t)H * P;

  for (int e = tid; e < P * ldN; e += kThreads) s_state[e] = 0.f;

  const int n_chunks = (S + Q - 1) / Q;
  for (int c = 0; c < n_chunks; ++c) {
    const int s0 = c * Q;
    const int L = min(Q, S - s0);  // valid rows of this chunk

    // dt and cum = inclusive prefix sum of dt * A over the chunk, by warp
    // shuffles, then across the warps, 256 rows at a time
    float carry = 0.f;
    for (int base = 0; base < Q; base += kThreads) {
      const int q = base + tid;
      const float d = q < L ? dt[((size_t)b * S + s0 + q) * H + h] : 0.f;
      float v = d * a;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, v, off);
        if (lane >= off) v += t;
      }
      if (lane == 31) s_warp[warp] = v;
      __syncthreads();
      if (warp == 0) {
        float w = lane < kWarps ? s_warp[lane] : 0.f;
#pragma unroll
        for (int off = 1; off < kWarps; off <<= 1) {
          const float t = __shfl_up_sync(0xffffffffu, w, off);
          if (lane >= off) w += t;
        }
        if (lane < kWarps) s_warp[lane] = w;
      }
      __syncthreads();
      v += carry + (warp > 0 ? s_warp[warp - 1] : 0.f);
      if (q < Q) {
        s_dt[q] = d;
        s_cum[q] = v;
      }
      carry += s_warp[kWarps - 1];
      __syncthreads();
    }
    const float cum_last = s_cum[Q - 1];  // = cum at row L - 1: dt is 0 after
    for (int q = tid; q < Q; q += kThreads)
      s_w[q] = expf(cum_last - s_cum[q]) * s_dt[q];
    __syncthreads();

    const int n_tiles = (L + kTile - 1) / kTile;
    for (int I = 0; I < n_tiles; ++I) {
      const int i0 = I * kTile;
      load_tile<float>(s_c, ldN, Cm + ((size_t)b * S + s0 + i0) * N, N, N,
                       L - i0);
      __syncthreads();

      float acc[kRows][PC];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int k = 0; k < PC; ++k) acc[r][k] = 0.f;

      if (c > 0) {  // the carried state's term: exp(cum_i) C_i . state^T
        for (int n = 0; n < N; ++n) {
          float cv[kRows], sv[PC];
#pragma unroll
          for (int r = 0; r < kRows; ++r) cv[r] = s_c[(ty + kGrid * r) * ldN + n];
#pragma unroll
          for (int k = 0; k < PC; ++k) {
            const int p = tx + kGrid * k;
            sv[k] = p < P ? s_state[p * ldN + n] : 0.f;
          }
#pragma unroll
          for (int r = 0; r < kRows; ++r)
#pragma unroll
            for (int k = 0; k < PC; ++k) acc[r][k] = fmaf(cv[r], sv[k], acc[r][k]);
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const int i = i0 + ty + kGrid * r;
          const float e = i < L ? expf(s_cum[i]) : 0.f;
#pragma unroll
          for (int k = 0; k < PC; ++k) acc[r][k] *= e;
        }
      }

      for (int J = 0; J <= I; ++J) {
        const int j0 = J * kTile;
        const int j_valid = min(kTile, L - j0);
        load_tile<float>(s_b, ldN, Bm + ((size_t)b * S + s0 + j0) * N, N, N,
                         j_valid);
        load_tile<T>(s_x, P, x + (((size_t)b * S + s0 + j0) * H + h) * P,
                     x_stride, P, j_valid);
        __syncthreads();

        // G = C_I B_J^T for this thread's 4 x 4 entries, then the causal
        // mask, the decay and dt_j, into s_m
        float g[kRows][kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r)
#pragma unroll
          for (int k = 0; k < kRows; ++k) g[r][k] = 0.f;
        for (int n = 0; n < N; ++n) {
          float cv[kRows], bv[kRows];
#pragma unroll
          for (int r = 0; r < kRows; ++r) cv[r] = s_c[(ty + kGrid * r) * ldN + n];
#pragma unroll
          for (int k = 0; k < kRows; ++k) bv[k] = s_b[(tx + kGrid * k) * ldN + n];
#pragma unroll
          for (int r = 0; r < kRows; ++r)
#pragma unroll
            for (int k = 0; k < kRows; ++k) g[r][k] = fmaf(cv[r], bv[k], g[r][k]);
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const int i = i0 + ty + kGrid * r;
#pragma unroll
          for (int k = 0; k < kRows; ++k) {
            const int j = j0 + tx + kGrid * k;
            const float m = (j <= i && i < L)
                                ? g[r][k] * expf(s_cum[i] - s_cum[j]) * s_dt[j]
                                : 0.f;
            s_m[(ty + kGrid * r) * kLdM + tx + kGrid * k] = m;
          }
        }
        __syncthreads();

        // acc += M x_J
        for (int jj = 0; jj < j_valid; ++jj) {
          float mv[kRows], xv[PC];
#pragma unroll
          for (int r = 0; r < kRows; ++r) mv[r] = s_m[(ty + kGrid * r) * kLdM + jj];
#pragma unroll
          for (int k = 0; k < PC; ++k) {
            const int p = tx + kGrid * k;
            xv[k] = p < P ? s_x[jj * P + p] : 0.f;
          }
#pragma unroll
          for (int r = 0; r < kRows; ++r)
#pragma unroll
            for (int k = 0; k < PC; ++k) acc[r][k] = fmaf(mv[r], xv[k], acc[r][k]);
        }
        __syncthreads();  // s_b, s_x and s_m are free for the next tile
      }

#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int i = i0 + ty + kGrid * r;
        if (i >= L) continue;
        T* yrow = y + (((size_t)b * S + s0 + i) * H + h) * P;
#pragma unroll
        for (int k = 0; k < PC; ++k) {
          const int p = tx + kGrid * k;
          if (p < P) store(&yrow[p], acc[r][k]);
        }
      }
    }

    // state = exp(cum_last) state + sum_j w_j x_j B_j^T; thread rows
    // p = ty + 16 a, columns n = tx + 16 b
    float sacc[PC][NC];
#pragma unroll
    for (int r = 0; r < PC; ++r)
#pragma unroll
      for (int k = 0; k < NC; ++k) sacc[r][k] = 0.f;
    for (int J = 0; J < n_tiles; ++J) {
      const int j0 = J * kTile;
      const int j_valid = min(kTile, L - j0);
      load_tile<float>(s_b, ldN, Bm + ((size_t)b * S + s0 + j0) * N, N, N,
                       j_valid);
      load_tile<T>(s_x, P, x + (((size_t)b * S + s0 + j0) * H + h) * P,
                   x_stride, P, j_valid);
      __syncthreads();
      for (int jj = 0; jj < j_valid; ++jj) {
        const float w = s_w[j0 + jj];
        float xv[PC], bv[NC];
#pragma unroll
        for (int r = 0; r < PC; ++r) {
          const int p = ty + kGrid * r;
          xv[r] = p < P ? w * s_x[jj * P + p] : 0.f;
        }
#pragma unroll
        for (int k = 0; k < NC; ++k) {
          const int n = tx + kGrid * k;
          bv[k] = n < N ? s_b[jj * ldN + n] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < PC; ++r)
#pragma unroll
          for (int k = 0; k < NC; ++k) sacc[r][k] = fmaf(xv[r], bv[k], sacc[r][k]);
      }
      __syncthreads();
    }
    const float decay = expf(cum_last);
#pragma unroll
    for (int r = 0; r < PC; ++r) {
      const int p = ty + kGrid * r;
#pragma unroll
      for (int k = 0; k < NC; ++k) {
        const int n = tx + kGrid * k;
        if (p < P && n < N)
          s_state[p * ldN + n] = decay * s_state[p * ldN + n] + sacc[r][k];
      }
    }
    __syncthreads();
  }

  float* out = state_out + ((size_t)b * H + h) * P * N;
  for (int e = tid; e < P * N; e += kThreads)
    out[e] = s_state[(e / N) * ldN + e % N];
}

template <typename T, int PC, int NC>
cudaError_t launch(const void* x, const void* dt, const void* A,
                   const void* Bm, const void* Cm, void* y, void* state,
                   int Bsz, int S, int H, int P, int N, int Q,
                   cudaStream_t stream) {
  // above 48 KB a block's dynamic shared memory must be allowed explicitly:
  // once per instance and device, for the largest P, N and chunk it takes
  static bool allowed[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices || !allowed[dev]) {
    const size_t most = smem_floats(kMaxChunk, kMaxDim, kMaxDim) * sizeof(float);
    err = cudaFuncSetAttribute(ssd_fwd<T, PC, NC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)most);
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices) allowed[dev] = true;
  }
  const size_t smem = smem_floats(Q, P, N) * sizeof(float);
  const dim3 grid(H, Bsz);
  ssd_fwd<T, PC, NC><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(Bm),
      static_cast<const float*>(Cm), static_cast<T*>(y),
      static_cast<float*>(state), S, H, P, N, Q);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const void* dt, const void* A,
                     const void* Bm, const void* Cm, void* y, void* state,
                     int Bsz, int S, int H, int P, int N, int Q,
                     cudaStream_t st) {
  const bool wide_p = P > 64, wide_n = N > 64;
  if (!wide_p && !wide_n)
    return launch<T, 4, 4>(x, dt, A, Bm, Cm, y, state, Bsz, S, H, P, N, Q, st);
  if (!wide_p)
    return launch<T, 4, 8>(x, dt, A, Bm, Cm, y, state, Bsz, S, H, P, N, Q, st);
  if (!wide_n)
    return launch<T, 8, 4>(x, dt, A, Bm, Cm, y, state, Bsz, S, H, P, N, Q, st);
  return launch<T, 8, 8>(x, dt, A, Bm, Cm, y, state, Bsz, S, H, P, N, Q, st);
}

}  // namespace

// Launches on `stream` without synchronising; returns the launch's CUDA
// error (0 on success).  dtype of x and y: 0 float32, 1 bfloat16.  chunk is
// the rows per chunk, 1..1024; P and N are 1..128.
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* A,
                               const void* Bm, const void* Cm, void* y,
                               void* state, int Bsz, int S, int H, int P,
                               int N, int chunk, int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (Bsz <= 0 || S <= 0 || H <= 0 || P <= 0 || N <= 0 || P > kMaxDim ||
      N > kMaxDim || chunk <= 0 || chunk > kMaxChunk) {
    err = cudaErrorInvalidValue;
  } else if (dtype == 1) {
    err = dispatch<__nv_bfloat16>(x, dt, A, Bm, Cm, y, state, Bsz, S, H, P, N,
                                  chunk, st);
  } else if (dtype == 0) {
    err = dispatch<float>(x, dt, A, Bm, Cm, y, state, Bsz, S, H, P, N, chunk,
                          st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}

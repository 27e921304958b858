// Flash attention for Hopper (sm_90a): grouped-query attention with causal
// and sliding-window masks and an online softmax.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::
// flash_attention (body _flash_kernel).  q (B, H, S, hd), k and v
// (B, KV, S, hd), all contiguous, one dtype (float32 or bfloat16);
// out (B, H, S, hd) in that dtype.  Query head h reads KV head h / (H / KV),
// so K and V are never replicated in memory.  Key j is visible to query i
// when j <= i (causal) and i - j < window (window >= 0; -1 = no window).
// A row with no visible key writes zeros: the reference's alive / safe
// logic with the finite sentinel -1e30, so no inf - inf ever occurs.
//
// Bound: causal attention needs about 2*B*H*S^2*hd flops against
// 2*(B*H + B*KV)*S*hd elements of traffic (q, k and v read once, o written
// once), i.e. about S/2 flops per element: from a few hundred tokens on it
// is bound by arithmetic, at the serve path's 32 tokens by bytes.  This first version computes in float32 on the CUDA cores,
// not on the tensor cores (no mma / wgmma, no TMA); that is later work.
//
// Design: one block of 128 threads per (q tile of 64 rows, head, batch).
// The Q tile, then each K tile and V tile in turn (sharing one buffer), and
// the 64x64 probability tile live in shared memory as float32, rows padded
// by one float so the column reads below hit distinct banks.  Thread
// (ty, tx) = (tid / 8, tid % 8) owns query rows ty + 16*i (i < 4), score
// columns tx + 8*j (j < 8) and output columns tx + 8*c (c < hd/8), with its
// rows' running max, sum and accumulator in float32 registers; the eight
// threads of a row are neighbouring lanes and reduce by shuffle.  The KV
// loop visits only tiles that meet the causal diagonal / window band (the
// Pallas grid visits them all and masks).  Query rows and key rows past S
// are masked, so S need not be a multiple of the tile.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBlockQ = 64;
constexpr int kBlockKV = 64;
constexpr int kThreads = 128;
constexpr int kLanesPerRow = 8;                        // tx
constexpr int kRowGroups = kThreads / kLanesPerRow;    // ty: 16
constexpr int kRows = kBlockQ / kRowGroups;            // rows a thread owns: 4
constexpr int kCols = kBlockKV / kLanesPerRow;         // score cols a thread owns: 8
constexpr int kLdP = kBlockKV + 1;
constexpr int kMaxDevices = 16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// rows [row0, row0 + 64) of an (S, HD) matrix -> float32 tile with row
// stride HD + 1; rows at or past S are zero (their scores are masked, and a
// zero V row keeps 0 * value finite)
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* __restrict__ dst,
                                          const T* __restrict__ src, int row0,
                                          int S) {
  constexpr int kLd = HD + 1;
  for (int idx = threadIdx.x; idx < kBlockQ * HD; idx += kThreads) {
    const int r = idx / HD, c = idx % HD;
    const int row = row0 + r;
    dst[r * kLd + c] = row < S ? to_f32(src[(size_t)row * HD + c]) : 0.f;
  }
}

__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int off = 1; off < kLanesPerRow; off <<= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 1; off < kLanesPerRow; off <<= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int HD>
constexpr size_t smem_bytes() {
  return (size_t)(kBlockQ * (HD + 1) + kBlockKV * (HD + 1) + kBlockQ * kLdP) *
         sizeof(float);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int H, int KV, int S,
          float scale, int causal, int window) {
  static_assert(HD % kLanesPerRow == 0, "head_dim must split over 8 lanes");
  constexpr int kLd = HD + 1;
  constexpr int kOut = HD / kLanesPerRow;  // output cols a thread owns
  extern __shared__ float smem[];
  float* sQ = smem;                      // kBlockQ x kLd
  float* sKV = sQ + kBlockQ * kLd;       // kBlockKV x kLd: K, then V
  float* sP = sKV + kBlockKV * kLd;      // kBlockQ x kLdP probabilities

  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const T* qh = q + ((size_t)b * H + h) * S * HD;
  const T* kh = k + ((size_t)b * KV + kvh) * S * HD;
  const T* vh = v + ((size_t)b * KV + kvh) * S * HD;
  const int tx = threadIdx.x % kLanesPerRow;
  const int ty = threadIdx.x / kLanesPerRow;

  // keys [kv_begin, kv_end) are the only ones any row of this tile can see
  const int q_last = min(q0 + kBlockQ, S) - 1;
  const int kv_end = causal ? q_last + 1 : S;
  const int kv_begin = window >= 0 ? max(0, q0 - window + 1) : 0;
  const int t_begin = kv_begin / kBlockKV;
  const int t_end = (kv_end + kBlockKV - 1) / kBlockKV;

  load_tile<T, HD>(sQ, qh, q0, S);

  float m[kRows], l[kRows], acc[kRows][kOut];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kOut; ++c) acc[i][c] = 0.f;
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * kBlockKV;
    __syncthreads();  // Q is loaded; the last tile's V and P reads are done
    load_tile<T, HD>(sKV, kh, k0, S);
    __syncthreads();

    // scores s = q . k over hd, for this thread's 4 rows x 8 cols
    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = sQ[(ty + kRowGroups * i) * kLd + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = sKV[(tx + kLanesPerRow * j) * kLd + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // mask, then the online softmax update of each row
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = ty + kRowGroups * i;
      const int qp = q0 + row;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kp = k0 + tx + kLanesPerRow * j;
        bool ok = kp < S;
        if (causal) ok = ok && kp <= qp;
        if (window >= 0) ok = ok && qp - kp < window;
        s[i][j] = ok ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const bool alive = m_new > 0.5f * kNegInf;
      const float corr = alive ? expf(m[i] - m_new) : 1.f;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = alive ? expf(s[i][j] - m_new) : 0.f;
        rs += p;
        sP[row * kLdP + tx + kLanesPerRow * j] = p;
      }
      l[i] = l[i] * corr + row_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kOut; ++c) acc[i][c] *= corr;
    }
    __syncthreads();  // every K read is done and P is complete
    load_tile<T, HD>(sKV, vh, k0, S);
    __syncthreads();

    // acc += P @ V for this thread's 4 rows x hd/8 cols
#pragma unroll 4
    for (int c2 = 0; c2 < kBlockKV; ++c2) {
      float pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = sP[(ty + kRowGroups * i) * kLdP + c2];
#pragma unroll
      for (int c = 0; c < kOut; ++c) {
        const float vv = sKV[c2 * kLd + tx + kLanesPerRow * c];
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

  T* oh = o + ((size_t)b * H + h) * S * HD;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qp = q0 + ty + kRowGroups * i;
    if (qp >= S) continue;
    const float inv = 1.f / (l[i] > 0.f ? l[i] : 1.f);
#pragma unroll
    for (int c = 0; c < kOut; ++c)
      store(&oh[(size_t)qp * HD + tx + kLanesPerRow * c], acc[i][c] * inv);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B,
                   int H, int KV, int S, int causal, int window,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  // above 48 KB a block's dynamic shared memory must be allowed explicitly,
  // once per instance and device
  static bool allowed[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices || !allowed[dev]) {
    err = cudaFuncSetAttribute(flash_fwd<T, HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices) allowed[dev] = true;
  }
  const dim3 grid((S + kBlockQ - 1) / kBlockQ, H, B);
  flash_fwd<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, KV, S,
      1.f / sqrtf((float)HD), causal, window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(const void* q, const void* k, const void* v, void* o,
                        int B, int H, int KV, int S, int head_dim, int causal,
                        int window, cudaStream_t stream) {
  switch (head_dim) {
    case 64:
      return launch<T, 64>(q, k, v, o, B, H, KV, S, causal, window, stream);
    case 80:
      return launch<T, 80>(q, k, v, o, B, H, KV, S, causal, window, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, H, KV, S, causal, window, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Launches on `stream` without synchronising; returns the launch's CUDA
// error (0 on success).  dtype: 0 float32, 1 bfloat16.  window < 0: none.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int H,
                                      int KV, int S, int head_dim, int dtype,
                                      int causal, int window, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (H <= 0 || KV <= 0 || H % KV != 0 || S <= 0 || B <= 0) {
    err = cudaErrorInvalidValue;
  } else if (dtype == 1) {
    err = dispatch_hd<__nv_bfloat16>(q, k, v, o, B, H, KV, S, head_dim, causal,
                                     window, st);
  } else if (dtype == 0) {
    err = dispatch_hd<float>(q, k, v, o, B, H, KV, S, head_dim, causal, window,
                             st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}

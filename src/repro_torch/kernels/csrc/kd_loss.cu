// Fused per-row distillation loss for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/kd_loss.py::kd_loss (body
// _kd_kernel).  Per row r of (N, V) student logits s and teacher logits t:
//
//   loss[r] = alpha * CE(s_r, label_r) + (1 - alpha) * T^2 * KL(softmax(t_r/T) || softmax(s_r/T))
//
// with both softmaxes reduced online (running max + rescaled sums), so no
// (N, V) intermediate is ever written:
//
//   CE = (m1 + log l1) - s[label]
//   KL = (stt - sts) / lt - (mt + log lt) + (ms + log ls)
//
// Bound: memory.  Each logit is read once and does a few dozen flops, far
// below the H100's ~20 flops/byte balance point for float32 outside the
// tensor cores, so the least time is (2*N*V*elt + 8*N) bytes over HBM
// bandwidth.  Design: every lane keeps the nine float32 accumulators in
// registers and strides the vocab with coalesced loads, four columns per
// step so four loads per tensor are in flight before any exp.  A warp owns
// a row, eight rows to a block; lanes merge their (max, sum) pairs by
// shuffle with rescaling.  Ragged rows and the vocab tail are masked.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// The reference's finite sentinel: merging two empty states gives
// exp(-1e30 - -1e30) * 0 = 0, never inf - inf = NaN.
constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;

struct KdState {
  float m1, l1, gold;       // student at T = 1: max, rescaled sum, gold logit
  float ms, ls;             // student at T
  float mt, lt, stt, sts;   // teacher at T: max, sum p, sum p*t/T, sum p*s/T
};

__device__ __forceinline__ void kd_init(KdState& a) {
  a.m1 = kNegInf; a.l1 = 0.f; a.gold = 0.f;
  a.ms = kNegInf; a.ls = 0.f;
  a.mt = kNegInf; a.lt = 0.f; a.stt = 0.f; a.sts = 0.f;
}

__device__ __forceinline__ void kd_merge(KdState& a, const KdState& b) {
  float m = fmaxf(a.m1, b.m1);
  a.l1 = a.l1 * expf(a.m1 - m) + b.l1 * expf(b.m1 - m);
  a.m1 = m;
  a.gold += b.gold;
  m = fmaxf(a.ms, b.ms);
  a.ls = a.ls * expf(a.ms - m) + b.ls * expf(b.ms - m);
  a.ms = m;
  m = fmaxf(a.mt, b.mt);
  const float ca = expf(a.mt - m), cb = expf(b.mt - m);
  a.lt = a.lt * ca + b.lt * cb;
  a.stt = a.stt * ca + b.stt * cb;
  a.sts = a.sts * ca + b.sts * cb;
  a.mt = m;
}

__device__ __forceinline__ KdState kd_shfl_xor(const KdState& a, int off) {
  KdState o;
  o.m1 = __shfl_xor_sync(0xffffffffu, a.m1, off);
  o.l1 = __shfl_xor_sync(0xffffffffu, a.l1, off);
  o.gold = __shfl_xor_sync(0xffffffffu, a.gold, off);
  o.ms = __shfl_xor_sync(0xffffffffu, a.ms, off);
  o.ls = __shfl_xor_sync(0xffffffffu, a.ls, off);
  o.mt = __shfl_xor_sync(0xffffffffu, a.mt, off);
  o.lt = __shfl_xor_sync(0xffffffffu, a.lt, off);
  o.stt = __shfl_xor_sync(0xffffffffu, a.stt, off);
  o.sts = __shfl_xor_sync(0xffffffffu, a.sts, off);
  return o;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// One warp per row; kWarps rows per block.
template <typename T>
__global__ void __launch_bounds__(kThreads)
kd_loss_kernel(const T* __restrict__ student, const T* __restrict__ teacher,
               const int32_t* __restrict__ labels, float* __restrict__ out,
               int64_t n_rows, int64_t vocab, float alpha, float inv_t) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int64_t row = (int64_t)blockIdx.x * kWarps + warp;
  if (row >= n_rows) return;  // a whole warp: the shuffles below stay full

  KdState st;
  kd_init(st);
  const T* srow = student + row * vocab;
  const T* trow = teacher + row * vocab;
  const int64_t label = labels[row];
  for (int64_t base = 0; base < vocab; base += 32 * kUnroll) {
    float x[kUnroll], y[kUnroll];
    bool ok[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const int64_t col = base + j * 32 + lane;
      ok[j] = col < vocab;
      x[j] = ok[j] ? to_f32(srow[col]) : kNegInf;
      y[j] = ok[j] ? to_f32(trow[col]) : kNegInf;
    }

    // student at T = 1 (CE); masked columns add nothing, and a step with
    // none valid leaves the state as it was (max unchanged, corr = 1)
    float cm = x[0];
#pragma unroll
    for (int j = 1; j < kUnroll; ++j) cm = fmaxf(cm, x[j]);
    float m = fmaxf(st.m1, cm);
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      if (ok[j]) acc += expf(x[j] - m);
      if (ok[j] && base + j * 32 + lane == label) st.gold += x[j];
    }
    st.l1 = st.l1 * expf(st.m1 - m) + acc;
    st.m1 = m;

    // student at T
    float xs[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) xs[j] = x[j] * inv_t;
    cm = xs[0];
#pragma unroll
    for (int j = 1; j < kUnroll; ++j) cm = fmaxf(cm, xs[j]);
    m = fmaxf(st.ms, cm);
    acc = 0.f;
#pragma unroll
    for (int j = 0; j < kUnroll; ++j)
      if (ok[j]) acc += expf(xs[j] - m);
    st.ls = st.ls * expf(st.ms - m) + acc;
    st.ms = m;

    // teacher at T: weights p and the p-weighted sums of t/T and s/T
    float ys[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) ys[j] = y[j] * inv_t;
    cm = ys[0];
#pragma unroll
    for (int j = 1; j < kUnroll; ++j) cm = fmaxf(cm, ys[j]);
    m = fmaxf(st.mt, cm);
    const float corr = expf(st.mt - m);
    float pl = 0.f, ptt = 0.f, pts = 0.f;
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      if (ok[j]) {
        const float p = expf(ys[j] - m);
        pl += p;
        ptt += p * ys[j];
        pts += p * xs[j];
      }
    }
    st.lt = st.lt * corr + pl;
    st.stt = st.stt * corr + ptt;
    st.sts = st.sts * corr + pts;
    st.mt = m;
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const KdState o = kd_shfl_xor(st, off);
    kd_merge(st, o);
  }
  if (lane != 0) return;

  const float ce = (st.m1 + logf(st.l1)) - st.gold;
  const float kl = (st.stt - st.sts) / st.lt - (st.mt + logf(st.lt)) +
                   (st.ms + logf(st.ls));
  const float t2 = 1.f / (inv_t * inv_t);
  out[row] = alpha * ce + (1.f - alpha) * t2 * kl;
}

template <typename T>
void launch(const void* s, const void* t, const void* labels, void* out,
            int64_t n_rows, int64_t vocab, float alpha, float inv_t,
            cudaStream_t stream) {
  const T* sp = static_cast<const T*>(s);
  const T* tp = static_cast<const T*>(t);
  const int32_t* lp = static_cast<const int32_t*>(labels);
  float* op = static_cast<float*>(out);
  const unsigned blocks = (unsigned)((n_rows + kWarps - 1) / kWarps);
  kd_loss_kernel<T><<<blocks, kThreads, 0, stream>>>(sp, tp, lp, op, n_rows,
                                                     vocab, alpha, inv_t);
}

}  // namespace

// student/teacher: contiguous (n_rows, vocab) float32 (is_bf16 = 0) or
// bfloat16 (is_bf16 = 1); labels: (n_rows,) int32; out: (n_rows,) float32.
// Launches on `stream` without synchronising; returns cudaGetLastError().
extern "C" int kd_loss_launch(const void* student, const void* teacher,
                              const void* labels, void* out, int64_t n_rows,
                              int64_t vocab, int is_bf16, float alpha,
                              float inv_t, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    launch<__nv_bfloat16>(student, teacher, labels, out, n_rows, vocab, alpha,
                          inv_t, s);
  } else {
    launch<float>(student, teacher, labels, out, n_rows, vocab, alpha, inv_t,
                  s);
  }
  return (int)cudaGetLastError();
}

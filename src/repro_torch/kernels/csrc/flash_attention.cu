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
// head_dim 64, 80 and 128; S need not be a multiple of a tile.
//
// Bound: causal attention needs about 2*B*H*S^2*hd flops against
// 2*(B*H + B*KV)*S*hd elements of traffic (q, k and v read once, o written
// once), i.e. about S/2 flops per element: from a few hundred tokens on it
// is bound by the tensor cores' arithmetic, at the serve path's 32 tokens
// by bytes and, in practice, by the latency of one block.
//
// bfloat16: warp-specialised wgmma + TMA kernel (flash_fwd_bf16).
//   Tiles: 128 query rows a block (two consumer warpgroups of 64 rows, the
//   height of one wgmma) and KV tiles of 128 rows, in a ring of 2 K/V
//   stages.  Q, K and V are loaded by TMA as boxes of 64 columns x 128 rows
//   with the 128-byte swizzle, over a 3-D view (hd, rows, heads) so that
//   rows past S are zero-filled by TMA instead of read from the next head.
//   head_dim 80 loads two such boxes (columns 80..127 zero-filled) and
//   computes at a padded 128 in shared memory, storing 80 columns: 60 % more
//   MMA work at hd 80, where attention is under 1 % of the prefill.
//   Shared memory: (1 + 2 stages x 2) tiles of 128 x hdp bf16 plus barriers
//   and alignment: 164,936 B at hdp 128, 83,016 B at hdp 64, one block an
//   SM (flash_attention_smem_bytes reports it).
//   Warpgroup 0 is the producer: after setmaxnreg.dec one thread issues
//   cp.async.bulk.tensor loads of Q once, then of K and V tile by tile.
//   Each stage has "full" mbarriers for K and for V (so Q.K^T starts before
//   V lands) and "empty" ones for K and for V that every consumer thread
//   arrives on: K is released as soon as S is computed, so the next K load
//   overlaps the rest of the tile.
//   Warpgroups 1 and 2 (setmaxnreg.inc 240) compute S = Q K^T with
//   wgmma.mma_async m64n128k16 bf16 -> f32, both operands K-major from
//   shared memory; the online softmax on the accumulator fragment in
//   registers (ex2.approx with scale*log2 e folded into one FMA; the mask
//   only on tiles that cross the diagonal, the window's edge or S; tiles
//   wholly outside the band are never loaded); then O += P V with P rounded
//   to bf16 in registers as wgmma's A operand (the f32 m64n128 accumulator
//   fragment is, pair by pair, the bf16 A fragment of k16) and V from
//   shared memory as an MN-major B (wgmma's transpose bit).  Rounding P is
//   the one place the kernel rounds what the reference keeps in float32.
//   Inside a warpgroup tile i's mask and softmax run while tile i-1's P V
//   product is on the tensor cores (S_i is issued, then P_{i-1} V_{i-1},
//   then the warpgroup waits for S_i alone); the exponentials would
//   otherwise cost about half the time of the products.
//   The epilogue stages O (normalised, bf16) in the warpgroup's own rows of
//   the Q buffer and writes it with 16-byte stores.
//   Schedule: grid (query batches, q tiles) with the q tile index reversed,
//   so the heaviest causal tiles of every head start first and the light
//   ones fill the tail.  Short prompts (S <= 64) pack the query heads of one
//   KV group into the rows of one tile (their rows are adjacent in q's
//   layout), so a 32-token prefill with 6 heads a group fills 192 rows over
//   one K/V load; the mask then uses a row's position within its head.
//   A barrier wait that spins past 2^24 polls traps, so a fault shows as a
//   launch error rather than a hung card.
//
// float32: the CUDA-core kernel (flash_fwd_f32), kept for parity checks
//   against the host at 2e-5, which neither bf16 nor TF32 tensor cores can
//   meet.  One block of 128 threads per (q tile of 64 rows, head, batch);
//   Q, each K and V tile in turn (sharing one buffer) and the 64x64
//   probability tile in shared memory as float32, rows padded by one float;
//   thread (ty, tx) = (tid / 8, tid % 8) owns query rows ty + 16*i (i < 4),
//   score columns tx + 8*j (j < 8) and output columns tx + 8*c, with its
//   rows' running max, sum and accumulator in registers; the eight threads
//   of a row reduce by shuffle.  It too skips KV tiles outside the band and
//   masks ragged S.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kMaxDevices = 16;

// -- float32: the CUDA-core kernel ----------------------------------------------
constexpr int kBlockQ = 64;
constexpr int kBlockKV = 64;
constexpr int kThreads = 128;
constexpr int kLanesPerRow = 8;                        // tx
constexpr int kRowGroups = kThreads / kLanesPerRow;    // ty: 16
constexpr int kRows = kBlockQ / kRowGroups;            // rows a thread owns: 4
constexpr int kCols = kBlockKV / kLanesPerRow;         // score cols a thread owns: 8
constexpr int kLdP = kBlockKV + 1;

// rows [row0, row0 + 64) of an (S, HD) matrix -> tile with row stride
// HD + 1; rows at or past S are zero (their scores are masked, and a zero V
// row keeps 0 * value finite)
template <int HD>
__device__ __forceinline__ void load_tile(float* __restrict__ dst,
                                          const float* __restrict__ src,
                                          int row0, int S) {
  constexpr int kLd = HD + 1;
  for (int idx = threadIdx.x; idx < kBlockQ * HD; idx += kThreads) {
    const int r = idx / HD, c = idx % HD;
    const int row = row0 + r;
    dst[r * kLd + c] = row < S ? src[(size_t)row * HD + c] : 0.f;
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
constexpr size_t smem_bytes_f32() {
  return (size_t)(kBlockQ * (HD + 1) + kBlockKV * (HD + 1) + kBlockQ * kLdP) *
         sizeof(float);
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, int H,
              int KV, int S, float scale, int causal, int window) {
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
  const float* qh = q + ((size_t)b * H + h) * S * HD;
  const float* kh = k + ((size_t)b * KV + kvh) * S * HD;
  const float* vh = v + ((size_t)b * KV + kvh) * S * HD;
  const int tx = threadIdx.x % kLanesPerRow;
  const int ty = threadIdx.x / kLanesPerRow;

  // keys [kv_begin, kv_end) are the only ones any row of this tile can see
  const int q_last = min(q0 + kBlockQ, S) - 1;
  const int kv_end = causal ? q_last + 1 : S;
  const int kv_begin = window >= 0 ? max(0, q0 - window + 1) : 0;
  const int t_begin = kv_begin / kBlockKV;
  const int t_end = (kv_end + kBlockKV - 1) / kBlockKV;

  load_tile<HD>(sQ, qh, q0, S);

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
    load_tile<HD>(sKV, kh, k0, S);
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
    load_tile<HD>(sKV, vh, k0, S);
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

  float* oh = o + ((size_t)b * H + h) * S * HD;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qp = q0 + ty + kRowGroups * i;
    if (qp >= S) continue;
    const float inv = 1.f / (l[i] > 0.f ? l[i] : 1.f);
#pragma unroll
    for (int c = 0; c < kOut; ++c)
      oh[(size_t)qp * HD + tx + kLanesPerRow * c] = acc[i][c] * inv;
  }
}

// -- bfloat16: the wgmma + TMA kernel -------------------------------------------
constexpr int kM = 128;         // query rows a block: two warpgroups of 64
constexpr int kN = 128;         // key rows a tile
constexpr int kStages = 2;      // K/V ring
constexpr int kWsThreads = 384; // producer warpgroup + two consumers
constexpr int kPackMaxS = 64;   // S at or below which a KV group's heads pack
constexpr int kBoxCols = 64;    // a TMA box: 64 bf16 columns = 128 B
constexpr int kBoxBytes = 128 * 128;  // a box of 128 rows (kM == kN == 128)
constexpr uint32_t kMaxPolls = 1u << 24;
constexpr float kLog2e = 1.4426950408889634f;

// shared memory of one block at padded head_dim HDP, in bytes from a
// 1024-aligned base: Q, K[stages], V[stages], then 1 + 4 * stages mbarriers
template <int HDP>
struct Layout {
  static constexpr int kTile = kM * HDP * 2;
  static constexpr int kQ = 0;
  static constexpr int kK = kTile;
  static constexpr int kV = kTile * (1 + kStages);
  static constexpr int kBar = kTile * (1 + 2 * kStages);
  static constexpr int kBytes = kBar + 8 * (1 + 4 * kStages) + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// waits until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t polls = 0;; ++polls) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (polls > kMaxPolls) __trap();
  }
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// wgmma shared-memory descriptor for the 128-byte swizzle: start address,
// leading and stride byte offsets (16-byte units), layout type 1 (B128)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// waits until at most N committed wgmma groups are still running
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of accumulator registers
// across an asynchronous wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

#define WG_D8(i)                                                        \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),           \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64x128 f32) (+)= A (64x16, shared, K-major) * B (16x128, shared,
// K-major)
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24), WG_D8(32), WG_D8(40),
        WG_D8(48), WG_D8(56)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64x128 f32) += A (64x16 bf16, registers) * B (16x128, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], uint32_t a0,
                                              uint32_t a1, uint32_t a2,
                                              uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24), WG_D8(32), WG_D8(40),
        WG_D8(48), WG_D8(56)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// d (64x64 f32) += A (64x16 bf16, registers) * B (16x64, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], uint32_t a0,
                                             uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

#undef WG_D8

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// issues S (this warpgroup's 64 rows x kN keys) = Q K^T over HDP columns
// as one wgmma group.  Both tiles are boxes of 64 columns; a k16 step
// advances 32 bytes inside a 128-byte swizzled row, a box kBoxBytes.
// K-major, 8-row groups 1024 B apart.
template <int HDP>
__device__ __forceinline__ void qk_issue(float (&s)[kN / 2], uint32_t q_addr,
                                         uint32_t k_addr) {
  fence_regs(s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HDP / 16; ++kk) {
    const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
    wgmma_ss_n128(s, sw128_desc(q_addr + off, 16, 1024),
                  sw128_desc(k_addr + off, 16, 1024), kk > 0);
  }
  wgmma_commit();
}

// issues O (64 rows x HDP) += P (64 x kN, bf16 registers) V (kN x HDP) as
// one wgmma group.  V is MN-major: a k16 step is 16 key rows (2048 B), the
// next 64 columns are the next box (leading byte offset), 8-row groups
// 1024 B apart.
template <int HDP>
__device__ __forceinline__ void pv_issue(float (&o)[HDP / 2],
                                         uint32_t (&p)[kN / 4],
                                         uint32_t v_addr) {
  fence_regs(o);
  fence_regs(p);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kN / 16; ++kk) {
    const uint64_t db = sw128_desc(v_addr + kk * 16 * 128, kBoxBytes, 1024);
    if constexpr (HDP == 128) {
      wgmma_rs_n128(o, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                    p[4 * kk + 3], db);
    } else {
      wgmma_rs_n64(o, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3],
                   db);
    }
  }
  wgmma_commit();
}

// the mask of one tile: key kp is visible to a row at position qp when
// kp < S, kp <= qp (causal) and qp - kp < window
__device__ __forceinline__ void mask_tile(float (&s)[kN / 2], int k0,
                                          const int (&pos)[2], int quad,
                                          int S, int causal, int window) {
#pragma unroll
  for (int j = 0; j < kN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kp = k0 + 8 * j + 2 * quad + (e & 1);
      const int qp = pos[e >> 1];
      bool ok = kp < S;
      if (causal) ok = ok && kp <= qp;
      if (window >= 0) ok = ok && qp - kp < window;
      if (!ok) s[4 * j + e] = kNegInf;
    }
}

// the online softmax of one tile: scores become probabilities in place, the
// rows' running max m and partial sums l (this lane's columns) move on, and
// corr is what the running output must be multiplied by.  A row lives on
// the 4 lanes of a quad; a row with no visible key yet stays at zero.
__device__ __forceinline__ void softmax_tile(float (&s)[kN / 2], float (&m)[2],
                                             float (&l)[2], float (&corr)[2],
                                             float scale_log2) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < kN / 8; ++j) {
    mx[0] = fmaxf(mx[0], fmaxf(s[4 * j], s[4 * j + 1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
  float msc[2], rs[2] = {0.f, 0.f};
  bool alive[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    alive[r] = mx[r] > 0.5f * kNegInf;
    corr[r] = alive[r] ? fast_exp2((m[r] - mx[r]) * scale_log2) : 1.f;
    msc[r] = mx[r] * scale_log2;
    m[r] = mx[r];
  }
#pragma unroll
  for (int j = 0; j < kN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      const float v =
          alive[r] ? fast_exp2(fmaf(s[4 * j + e], scale_log2, -msc[r])) : 0.f;
      s[4 * j + e] = v;
      rs[r] += v;
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + rs[r];
}

// probabilities -> the bf16 A fragment of the P V product: accumulator
// registers (4j .. 4j + 3) are, pair by pair, A registers (2j, 2j + 1)
__device__ __forceinline__ void to_bf16(const float (&s)[kN / 2],
                                        uint32_t (&p)[kN / 4]) {
#pragma unroll
  for (int j = 0; j < kN / 8; ++j) {
    p[2 * j] = pack_bf16(s[4 * j], s[4 * j + 1]);
    p[2 * j + 1] = pack_bf16(s[4 * j + 2], s[4 * j + 3]);
  }
}

template <int N>
__device__ __forceinline__ void rescale(float (&o)[N], const float (&corr)[2]) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    o[4 * j] *= corr[0];
    o[4 * j + 1] *= corr[0];
    o[4 * j + 2] *= corr[1];
    o[4 * j + 3] *= corr[1];
  }
}

template <int HD>
__global__ void __launch_bounds__(kWsThreads, 1)
flash_fwd_bf16(const __grid_constant__ CUtensorMap qmap,
               const __grid_constant__ CUtensorMap kmap,
               const __grid_constant__ CUtensorMap vmap,
               __nv_bfloat16* __restrict__ o, int H, int KV, int S, int pack,
               int R, int causal, int window, float scale_log2) {
  constexpr int HDP = HD <= 64 ? 64 : 128;  // padded head_dim in shared memory
  constexpr int kBoxes = HDP / kBoxCols;
  using L = Layout<HDP>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sbase = smem_u32(base);
  const uint32_t bar_q = sbase + L::kBar;
  const uint32_t bar_k = bar_q + 8;              // K landed, per stage
  const uint32_t bar_v = bar_k + 8 * kStages;    // V landed
  const uint32_t bar_ek = bar_v + 8 * kStages;   // K read by every consumer
  const uint32_t bar_ev = bar_ek + 8 * kStages;  // V read by every consumer

  // query batch n: `pack` adjacent heads of one batch row, R = pack * S
  // rows; q tiles in reverse so the heaviest causal tiles start first
  const int n = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kM;
  const int heads_per_n = H / pack;
  const int b = n / heads_per_n;
  const int h0 = (n % heads_per_n) * pack;
  const int kv_z = b * KV + h0 / (H / KV);
  // keys any row of this tile can see: packed tiles (S <= 64) take one
  // tile; otherwise rows are positions q0 .. q0 + kM - 1
  int t_begin = 0, t_end = 1;
  if (pack == 1) {
    const int kv_end = causal ? min(q0 + kM, S) : S;
    const int kv_begin = window >= 0 ? max(0, q0 - window + 1) : 0;
    t_begin = kv_begin / kN;
    t_end = (kv_end + kN - 1) / kN;
  }
  const int n_tiles = max(0, t_end - t_begin);
  const int live_wgs = min(2, (R - q0 + 63) / 64);

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_k + 8 * s, 1);
      mbar_init(bar_v + 8 * s, 1);
      mbar_init(bar_ek + 8 * s, live_wgs * 128);
      mbar_init(bar_ev + 8 * s, live_wgs * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warpgroup = threadIdx.x / 128;
  if (warpgroup == 0) {
    // producer: one thread issues every TMA load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0 && n_tiles > 0) {
      mbar_expect_tx(bar_q, L::kTile);
#pragma unroll
      for (int bx = 0; bx < kBoxes; ++bx)
        tma_load(sbase + L::kQ + bx * kBoxBytes, &qmap, bar_q, bx * kBoxCols,
                 q0, n);
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % kStages;
        const uint32_t ph = (i / kStages) & 1;
        const int k0 = (t_begin + i) * kN;
        mbar_wait(bar_ek + 8 * st, ph ^ 1);
        mbar_expect_tx(bar_k + 8 * st, L::kTile);
#pragma unroll
        for (int bx = 0; bx < kBoxes; ++bx)
          tma_load(sbase + L::kK + st * L::kTile + bx * kBoxBytes, &kmap,
                   bar_k + 8 * st, bx * kBoxCols, k0, kv_z);
        mbar_wait(bar_ev + 8 * st, ph ^ 1);
        mbar_expect_tx(bar_v + 8 * st, L::kTile);
#pragma unroll
        for (int bx = 0; bx < kBoxes; ++bx)
          tma_load(sbase + L::kV + st * L::kTile + bx * kBoxBytes, &vmap,
                   bar_v + 8 * st, bx * kBoxCols, k0, kv_z);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wg = warpgroup - 1;
    const int row_lo = q0 + 64 * wg;  // first packed row of this warpgroup
    if (row_lo >= R) return;          // past the end: not counted on "empty"
    const int t = threadIdx.x - 128 * warpgroup;
    const int warp = t / 32, lane = t % 32;
    const int quad = lane % 4;
    // this thread's two rows of the accumulator fragment, local and packed
    const int lr[2] = {64 * wg + 16 * warp + lane / 4,
                       64 * wg + 16 * warp + lane / 4 + 8};
    int pos[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + lr[r];
      pos[r] = pack > 1 ? row % S : row;  // position within its head
    }
    const uint32_t q_addr = sbase + L::kQ + 64 * wg * 128;

    float acc[HDP / 2];
#pragma unroll
    for (int i = 0; i < HDP / 2; ++i) acc[i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

    // tile i's softmax runs while tile i-1's P V product is on the tensor
    // cores: issue S_i = Q K_i^T, issue O += P_{i-1} V_{i-1}, wait for S_i,
    // mask and softmax it, wait for the product, then rescale O and round
    // P_i.  K is released once S is computed, V once its product is done.
    auto k_addr = [&](int i) { return sbase + L::kK + (i % kStages) * L::kTile; };
    auto v_addr = [&](int i) { return sbase + L::kV + (i % kStages) * L::kTile; };
    auto parity = [](int i) { return (uint32_t)((i / kStages) & 1); };
    // the mask, only where a tile meets the diagonal, the window's edge, S,
    // or packed rows
    auto masked = [&](int k0) {
      return pack > 1 || k0 + kN > S || (causal && k0 + kN - 1 > row_lo) ||
             (window >= 0 && k0 <= row_lo + 63 - window);
    };
    if (n_tiles > 0) {
      float s[kN / 2], corr[2];
      uint32_t p[kN / 4];
      mbar_wait(bar_q, 0);
      mbar_wait(bar_k, 0);
      qk_issue<HDP>(s, q_addr, k_addr(0));
      wgmma_wait<0>();
      fence_regs(s);
      mbar_arrive(bar_ek);
      if (masked(t_begin * kN))
        mask_tile(s, t_begin * kN, pos, quad, S, causal, window);
      softmax_tile(s, m, l, corr, scale_log2);
      to_bf16(s, p);
      for (int i = 1; i < n_tiles; ++i) {
        const int k0 = (t_begin + i) * kN;
        mbar_wait(bar_k + 8 * (i % kStages), parity(i));
        qk_issue<HDP>(s, q_addr, k_addr(i));
        mbar_wait(bar_v + 8 * ((i - 1) % kStages), parity(i - 1));
        pv_issue<HDP>(acc, p, v_addr(i - 1));
        wgmma_wait<1>();
        fence_regs(s);
        mbar_arrive(bar_ek + 8 * (i % kStages));
        if (masked(k0)) mask_tile(s, k0, pos, quad, S, causal, window);
        softmax_tile(s, m, l, corr, scale_log2);
        wgmma_wait<0>();
        fence_regs(acc);
        fence_regs(p);
        mbar_arrive(bar_ev + 8 * ((i - 1) % kStages));
        rescale(acc, corr);
        to_bf16(s, p);
      }
      const int last = n_tiles - 1;
      mbar_wait(bar_v + 8 * (last % kStages), parity(last));
      pv_issue<HDP>(acc, p, v_addr(last));
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(bar_ev + 8 * (last % kStages));
    }

    // epilogue: normalise, stage bf16 rows in this warpgroup's part of the
    // Q buffer (same swizzle: 16-byte chunk c of row r at c ^ (r % 8)),
    // then 16-byte stores of the rows below R and the HD real columns
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      inv[r] = l[r] > 0.f ? 1.f / l[r] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < HDP / 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = lr[r];
        const int chunk = (j % 8) ^ (row % 8);
        uint8_t* dst = base + L::kQ + (j / 8) * kBoxBytes + row * 128 +
                       chunk * 16 + quad * 4;
        *reinterpret_cast<uint32_t*>(dst) =
            pack_bf16(acc[4 * j + 2 * r] * inv[r],
                      acc[4 * j + 2 * r + 1] * inv[r]);
      }
    named_bar_sync(1 + wg, 128);
    constexpr int kChunks = HD / 8;  // 16-byte chunks of a stored row
    __nv_bfloat16* on = o + (size_t)n * R * HD;
    for (int idx = t; idx < 64 * kChunks; idx += 128) {
      const int row = 64 * wg + idx / kChunks, c = idx % kChunks;
      if (q0 + row >= R) break;  // rows grow with idx
      const int chunk = (c % 8) ^ (row % 8);
      const uint4 val = *reinterpret_cast<const uint4*>(
          base + L::kQ + (c / 8) * kBoxBytes + row * 128 + chunk * 16);
      *reinterpret_cast<uint4*>(on + (size_t)(q0 + row) * HD + c * 8) = val;
    }
  }
}

// -- launchers -------------------------------------------------------------------
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, found through the runtime so that
// the library needs no -lcuda
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* sym = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &sym,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(sym);
  }
  return fn;
}

// a bf16 (hd, rows, batches) view of a contiguous (batches, rows, hd) array,
// loaded as boxes of 64 columns x 128 rows x 1 with the 128-byte swizzle;
// whatever lies past hd or rows is zero-filled
bool encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, int hd,
            int rows, int batches) {
  const cuuint64_t dims[3] = {(cuuint64_t)hd, (cuuint64_t)rows,
                              (cuuint64_t)batches};
  const cuuint64_t strides[2] = {(cuuint64_t)hd * 2,
                                 (cuuint64_t)rows * hd * 2};
  const cuuint32_t box[3] = {kBoxCols, 128, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// above 48 KB a block's dynamic shared memory must be allowed explicitly,
// once per kernel and device
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, bool (&allowed)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices || !allowed[dev]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices) allowed[dev] = true;
  }
  return cudaSuccess;
}

template <int HD>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       int B, int H, int KV, int S, int causal, int window,
                       cudaStream_t stream) {
  constexpr size_t smem = smem_bytes_f32<HD>();
  static bool allowed[kMaxDevices] = {};
  cudaError_t err = allow_smem(flash_fwd_f32<HD>, smem, allowed);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBlockQ - 1) / kBlockQ, H, B);
  flash_fwd_f32<HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), H, KV, S,
      1.f / sqrtf((float)HD), causal, window);
  return cudaGetLastError();
}

template <int HD>
constexpr int smem_bytes_bf16() {
  return Layout<(HD <= 64 ? 64 : 128)>::kBytes;
}

template <int HD>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        int B, int H, int KV, int S, int causal, int window,
                        cudaStream_t stream) {
  constexpr int smem = smem_bytes_bf16<HD>();
  static bool allowed[kMaxDevices] = {};
  cudaError_t err = allow_smem(flash_fwd_bf16<HD>, smem, allowed);
  if (err != cudaSuccess) return err;
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return cudaErrorNotSupported;
  // short prompts pack the heads of a KV group into one tile's rows
  const int pack = S <= kPackMaxS ? H / KV : 1;
  const int R = pack * S;
  const int n_q = B * H / pack;
  CUtensorMap qmap, kmap, vmap;
  if (!encode(fn, &qmap, q, HD, R, n_q) || !encode(fn, &kmap, k, HD, S, B * KV) ||
      !encode(fn, &vmap, v, HD, S, B * KV))
    return cudaErrorInvalidValue;
  const dim3 grid(n_q, (R + kM - 1) / kM);
  flash_fwd_bf16<HD><<<grid, kWsThreads, smem, stream>>>(
      qmap, kmap, vmap, static_cast<__nv_bfloat16*>(o), H, KV, S, pack, R,
      causal, window, kLog2e / sqrtf((float)HD));
  return cudaGetLastError();
}

template <bool Bf16>
cudaError_t dispatch_hd(const void* q, const void* k, const void* v, void* o,
                        int B, int H, int KV, int S, int head_dim, int causal,
                        int window, cudaStream_t stream) {
  switch (head_dim) {
#define FA_CASE(HD)                                                         \
  case HD:                                                                  \
    return Bf16 ? launch_bf16<HD>(q, k, v, o, B, H, KV, S, causal, window,  \
                                  stream)                                   \
                : launch_f32<HD>(q, k, v, o, B, H, KV, S, causal, window,   \
                                 stream);
    FA_CASE(64)
    FA_CASE(80)
    FA_CASE(128)
#undef FA_CASE
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
    err = dispatch_hd<true>(q, k, v, o, B, H, KV, S, head_dim, causal, window,
                            st);
  } else if (dtype == 0) {
    err = dispatch_hd<false>(q, k, v, o, B, H, KV, S, head_dim, causal,
                             window, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}

// Dynamic shared memory of one block of the kernel for this head_dim and
// dtype (0 float32, 1 bfloat16), in bytes; -1 for a head_dim it lacks.
extern "C" int flash_attention_smem_bytes(int head_dim, int dtype) {
  switch (head_dim) {
    case 64:
      return dtype == 1 ? smem_bytes_bf16<64>() : (int)smem_bytes_f32<64>();
    case 80:
      return dtype == 1 ? smem_bytes_bf16<80>() : (int)smem_bytes_f32<80>();
    case 128:
      return dtype == 1 ? smem_bytes_bf16<128>() : (int)smem_bytes_f32<128>();
    default:
      return -1;
  }
}

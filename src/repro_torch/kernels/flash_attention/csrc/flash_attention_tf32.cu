// Blocked online-softmax attention in f32 on Hopper's tensor cores (sm_90a),
// every product taken in 3xTF32: TMA loads into a shared-memory ring, wgmma
// for Q K^T, mma.sync for P V, a warp-specialised block.
//
// Replaces, for f32, the TPU kernel
// src/repro/kernels/flash_attention/flash_attention.py::_flash_kernel
// (pallas_call at line 107), whose dots run in f32; bf16 runs the kernel of
// flash_attention_wgmma.cu. Same function: q [B, H, Sq, d] against k, v
// [B, KV, Skv, d], scores scaled by 1/sqrt(d) in f32, a top-left causal mask
// (row >= col) applied before the running max, keys at or past Skv masked,
// running max / denominator / accumulator in f32, fully masked rows giving 0
// (the `l == 0 -> 1` guard), output in f32. Two liberties, both the same
// function:
//   * GQA: query head h reads kv head h / G directly, so the caller does not
//     materialise the reference wrapper's repeated K/V (jnp.repeat).
//   * Layout: every tensor is addressed through its batch, head and sequence
//     strides (the last dim contiguous), so the model's [B, S, H, d]
//     activations are read and written in place, without the two transposes
//     the reference makes around its call.
// Nothing is padded in device memory: rows past Sq or Skv load as zeros
// (TMA's out-of-bounds fill), keys at or past Skv are masked and query rows
// at or past Sq are never written. A query-row offset `q_off` (>= 0, any
// value) makes q's row r the keys' row q_off + r for the causal mask and the
// causal tile skip: a rank's slice of a sequence's rows keeps the whole
// sequence's diagonal.
//
// 3xTF32. The card has no f32 tensor-core product; TF32 (10 bits of
// mantissa) runs at 495 TFLOP/s. Each operand x is split as hi = x truncated
// to tf32 and lo = (x - hi) truncated to tf32, and each product is taken as
// lo.hi + hi.lo + hi.hi with f32 accumulation (lo.lo, below f32's rounding,
// is dropped): the same function as f32 FMAs to within f32's own rounding,
// at an effective 495 / 3 = 165 TFLOP/s against 67 TFLOP/s of f32 FMAs. The
// tensor cores read the top 19 bits of a 32-bit operand, so a tile of f32 as
// TMA lands it is its own hi (truncated); only lo needs a tile of its own.
//
// Bound on an H100 at the training shape (B=2, H=32, KV=8, S=4096, d=128,
// causal): operations. 2*B*H*S^2*d flops over the causal half (QK and PV)
// are ~275 GFLOP: 1.67 ms at 3xTF32's 165 TFLOP/s (4.10 ms at 67 TFLOP/s of
// f32 FMAs), against ~336 MB of q, k, v and o read or written once (~0.1 ms
// at 3.35 TB/s).
//
// Design:
//   * One block of three warpgroups per (b*h, tile of 128 query rows), the
//     q-tile index on the grid's slow axis, heaviest first (the last tile of
//     a causal call sees the most keys). Key tiles of 64 rows.
//   * Warpgroup 2 produces. One thread issues TMA loads of the Q tile (once)
//     and of K and V tiles into a ring of kStages stages (two where they fit
//     in 227 KB, d <= 80; one at d = 96, 112, 128), with separate full and
//     empty mbarriers for K and V, so that the next K tile loads while the
//     consumers run P V and the next V tile while they run Q K^T. Three
//     warps (the splitters) write lo of the Q tile once and of each K tile
//     as it lands, into tiles of the same swizzled layout (so elementwise),
//     then fence them for the async proxy and arrive on a ready barrier.
//     Warpgroup 2 gives up registers (setmaxnreg 40) to the two consumer
//     warpgroups (232), each of which owns 64 query rows (wgmma's M).
//   * S = Q K^T: wgmma m64n64k8 tf32, both operands K-major in shared memory
//     as TMA lands them, three a k8 step (Q_lo K, Q K_lo, Q K), d / 8 steps.
//     Q and K rows are cut into boxes of one swizzle span: 128 bytes (32
//     columns) where d is a multiple of 32, 64 bytes at d = 16, 32 bytes (8
//     columns, one k8 step a box) at d = 48, 80, 112.
//   * The online softmax runs on that fragment: the four threads sharing a
//     row reduce its max with two shuffles; exp2f with scale*log2(e) folded
//     in; masks only on tiles that cross the causal frontier or Skv; causal
//     tiles past the frontier are never loaded.
//   * O += P V: V is d-contiguous, which for this product is N-major, and
//     wgmma takes a tf32 B operand only K-major (the transpose bit exists for
//     16-bit types alone). Of the two ways out, writing V^T (hi and lo) to
//     shared memory after each tile lands, or mma.sync with B fragments
//     loaded by plain shared-memory loads, this kernel takes the second: no
//     transpose pass, no 2 x 32 KB of V^T tiles at d = 128 (which would
//     leave no room for the ring), and V's lo made in registers. Each warp
//     runs mma.sync m16n8k8 tf32 on its 16 rows, three a (k8, n8) block. P
//     is wgmma's score fragment reused in registers: mma's A fragment wants
//     keys t and t + 4 of a k8 block in thread t where the score fragment
//     holds keys 2t and 2t + 1, so the block's keys are taken in the order
//     (0, 2, 4, 6, 1, 3, 5, 7) and V's rows read in that same order; no
//     shuffle. V is loaded by TMA in 128-byte swizzled boxes of 32 columns
//     (the last one zero past d): a warp's loads of one B fragment (rows 2t
//     or 2t + 1, 8 columns) then fall in 32 distinct banks. The O fragment
//     of mma.sync is the wgmma accumulator's layout, so O is one d / 2-
//     register array; each tile's P V is summed in a fresh one and joins
//     O, rescaled by the running max's step, in one f32 FMA.
//   * Epilogue: the `l == 0` guard, divide by l, f32 stores through the
//     output's strides; rows at or past Sq are never written.
//
// Plain C interface, loaded with ctypes (repro_torch/kernels/_build.py).
// cuTensorMapEncodeTiled is a driver function: it is fetched at run time
// through cudaGetDriverEntryPoint, so the library links nothing.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "smem_limit.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kBQ = 128;        // query rows a block: two warpgroups of 64
constexpr int kBK = 64;         // keys a tile
constexpr int kConsumers = 256;
constexpr int kSplitters = 96;  // warps 1-3 of the producer warpgroup
constexpr int kThreads = 384;
constexpr float kNegInf = -1e30f;
constexpr uint32_t kTf32Mask = 0xffffe000u;  // sign, exponent, 10 bits
constexpr size_t kSmemLimit = 232448;        // 227 KB a block

// Shared-memory geometry at head dim HD: Q and its lo (128 rows), then
// kStages stages of K, K's lo (64 rows each) and V (64 rows), then the
// barriers.
template <int HD>
struct Geom {
  static_assert(HD % 16 == 0 && HD >= 16 && HD <= 128, "head dim");
  // Q and K: a row in boxes of one swizzle span
  static constexpr int kSwizzle =  // bytes
      HD % 32 == 0 ? 128 : (HD == 16 ? 64 : 32);
  static constexpr int kBoxCols = kSwizzle / 4;   // floats a box row
  static constexpr int kBoxes = HD / kBoxCols;    // boxes a tile row
  static constexpr int kQBoxBytes = kBQ * kSwizzle;
  static constexpr int kKBoxBytes = kBK * kSwizzle;
  static constexpr int kQBytes = kBoxes * kQBoxBytes;
  static constexpr int kKBytes = kBoxes * kKBoxBytes;
  // the descriptor's layout type: B128, B64, B32
  static constexpr uint64_t kLayout =
      kSwizzle == 128 ? 1 : (kSwizzle == 64 ? 2 : 3);
  static constexpr CUtensorMapSwizzle kMapSwizzle =
      kSwizzle == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                      : (kSwizzle == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                        : CU_TENSOR_MAP_SWIZZLE_32B);
  // V: 128-byte boxes of 32 columns, the last one zero past d
  static constexpr int kVBoxes = (HD + 31) / 32;
  static constexpr int kVBoxBytes = kBK * 128;
  static constexpr int kVBytes = kVBoxes * kVBoxBytes;
  static constexpr int kStageBytes = 2 * kKBytes + kVBytes;
  // Q's tiles and barriers (2) and the alignment slack, then a stage's
  // tiles and barriers (5)
  static constexpr size_t kFixed = 2 * kQBytes + 8 * 2 + 1024;
  static constexpr size_t kPerStage = kStageBytes + 8 * 5;
  static constexpr int kStages = kFixed + 2 * kPerStage <= kSmemLimit ? 2 : 1;
  static constexpr size_t kSmem = kFixed + kStages * kPerStage;
  static_assert(kSmem <= kSmemLimit, "shared memory");
};

struct Params {
  float* o;
  long long ob, oh, os;  // output strides in elements: batch, head, row
  int H, G, Sq, Skv, n_q_tiles, causal;
  int q_off;             // the keys' row of q's row 0 (causal mask)
  float scale_log2;      // 1/sqrt(d) * log2(e)
};

__device__ __forceinline__ float tf32_trunc(float x) {
  return __uint_as_float(__float_as_uint(x) & kTf32Mask);
}
__device__ __forceinline__ float tf32_lo(float x) {
  return tf32_trunc(x - tf32_trunc(x));  // x - hi is exact
}

// lo of each value of a tile, written to the same place of its lo tile.
__device__ __forceinline__ void split_tile(const float4* src, float4* dst,
                                           int n4, int tid) {
  for (int i = tid; i < n4; i += kSplitters) {
    const float4 x = src[i];
    dst[i] = make_float4(tf32_lo(x.x), tf32_lo(x.y), tf32_lo(x.z),
                         tf32_lo(x.w));
  }
}

// Make this thread's shared-memory writes visible to the async proxy
// (the wgmma that reads them).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// D[16 x 8] += A[16 x 8] . B[8 x 8] in tf32, one warp.
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_tf32_kernel(const __grid_constant__ CUtensorMap tm_q,
                                const __grid_constant__ CUtensorMap tm_k,
                                const __grid_constant__ CUtensorMap tm_v,
                                const Params prm) {
  using G = Geom<HD>;
  constexpr int kStages = G::kStages;
  extern __shared__ unsigned char smem_raw[];
  // 1024-byte alignment: the 128-byte swizzle repeats every 8 rows.
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const smem = smem_raw + (base - raw);  // generic pointer
  const uint32_t q_s = base;
  const uint32_t qlo_s = q_s + G::kQBytes;
  const uint32_t stage0 = qlo_s + G::kQBytes;  // stage s: K, K's lo, V
  auto k_s = [&](int s) { return stage0 + s * G::kStageBytes; };
  auto v_s = [&](int s) { return k_s(s) + 2 * G::kKBytes; };
  const uint32_t bars = stage0 + kStages * G::kStageBytes;
  const uint32_t q_full = bars, q_ready = bars + 8;
  auto k_full = [&](int s) { return bars + 16 + 40 * s; };
  auto k_ready = [&](int s) { return k_full(s) + 8; };
  auto k_empty = [&](int s) { return k_full(s) + 16; };
  auto v_full = [&](int s) { return k_full(s) + 24; };
  auto v_empty = [&](int s) { return k_full(s) + 32; };

  const int bh = blockIdx.x;
  const int qt = prm.n_q_tiles - 1 - static_cast<int>(blockIdx.y);
  const int b = bh / prm.H, h = bh - b * prm.H, kvh = h / prm.G;
  const int q0 = qt * kBQ;
  const int n_kv = (prm.Skv + kBK - 1) / kBK;
  // the causal frontier of the tile's last real row, as a key row
  const int last_row = prm.q_off + min(q0 + kBQ, prm.Sq) - 1;
  const int n_tiles = prm.causal ? min(n_kv, last_row / kBK + 1) : n_kv;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_ready, kSplitters);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(k_ready(s), kSplitters);
      mbar_init(k_empty(s), kConsumers);
      mbar_init(v_full(s), 1);
      mbar_init(v_empty(s), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: one thread issues every load, three warps split ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    const int ptid = threadIdx.x - 256;
    if (ptid == 0) {
      mbar_expect_tx(q_full, G::kQBytes);
      for (int c = 0; c < G::kBoxes; ++c)
        tma_load(q_s + c * G::kQBoxBytes, &tm_q, q_full, c * G::kBoxCols, q0,
                 h, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        const uint32_t parity = ((t / kStages) - 1) & 1;
        if (t >= kStages) mbar_wait(k_empty(s), parity);
        mbar_expect_tx(k_full(s), G::kKBytes);
        for (int c = 0; c < G::kBoxes; ++c)
          tma_load(k_s(s) + c * G::kKBoxBytes, &tm_k, k_full(s),
                   c * G::kBoxCols, t * kBK, kvh, b);
        if (t >= kStages) mbar_wait(v_empty(s), parity);
        mbar_expect_tx(v_full(s), G::kVBytes);
        for (int c = 0; c < G::kVBoxes; ++c)
          tma_load(v_s(s) + c * G::kVBoxBytes, &tm_v, v_full(s), c * 32,
                   t * kBK, kvh, b);
      }
    } else if (ptid >= 32) {
      const int tid = ptid - 32;
      const float4* q_tile = reinterpret_cast<const float4*>(smem);
      mbar_wait(q_full, 0);
      split_tile(q_tile, reinterpret_cast<float4*>(smem + G::kQBytes),
                 G::kQBytes / 16, tid);
      fence_proxy_async();
      mbar_arrive(q_ready);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        unsigned char* const k_tile = smem + (k_s(s) - base);
        mbar_wait(k_full(s), (t / kStages) & 1);
        split_tile(reinterpret_cast<const float4*>(k_tile),
                   reinterpret_cast<float4*>(k_tile + G::kKBytes),
                   G::kKBytes / 16, tid);
        fence_proxy_async();
        mbar_arrive(k_ready(s));
      }
    }
  } else {
    // ---- consumers: 64 query rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int lane = threadIdx.x & 31;
    const int warp = (threadIdx.x / 32) & 3;
    const int g = lane / 4, t4 = lane & 3;
    const int row_lo = q0 + wg * 64;            // this warpgroup's first row
    const int r0 = row_lo + warp * 16 + g;      // rows r0 and r0 + 8
    const int key_lo = prm.q_off + row_lo;      // their rows as key rows
    const int key_r0 = prm.q_off + r0;
    const int cq = 2 * t4;                      // column offset in an n8 block

    float o[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

    // K-major operands (Q, K): 8-row groups one swizzle span of rows apart
    constexpr uint32_t kGroup = 8 * G::kSwizzle;
    const uint32_t q_wg = q_s + wg * 64 * G::kSwizzle;
    const uint32_t qlo_wg = qlo_s + wg * 64 * G::kSwizzle;

    mbar_wait(q_full, 0);
    mbar_wait(q_ready, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kStages;
      const uint32_t parity = (t / kStages) & 1;
      const int k0 = t * kBK;
      const uint32_t k_t = k_s(s), klo_t = k_t + G::kKBytes;
      mbar_wait(k_full(s), parity);
      mbar_wait(k_ready(s), parity);

      // S = Q K^T over d, 8 at a time, lo.hi + hi.lo + hi.hi
      float sc[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 8; ++kk) {
        const int box = kk * 8 / G::kBoxCols;
        const uint32_t col = (kk * 8 % G::kBoxCols) * 4;
        const uint32_t qo = box * G::kQBoxBytes + col;
        const uint32_t ko = box * G::kKBoxBytes + col;
        const uint64_t dq = make_desc(q_wg + qo, 16, kGroup, G::kLayout);
        const uint64_t dk = make_desc(k_t + ko, 16, kGroup, G::kLayout);
        wgmma_tf32_n64(sc, make_desc(qlo_wg + qo, 16, kGroup, G::kLayout),
                       dk, kk > 0);
        wgmma_tf32_n64(sc, dq, make_desc(klo_t + ko, 16, kGroup, G::kLayout),
                       1);
        wgmma_tf32_n64(sc, dq, dk, 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(sc);
      mbar_arrive(k_empty(s));

      // scale (log2 units) and mask: element 4j + 2i + c is row r0 + 8i,
      // key k0 + 8j + cq + c
      const bool edge = k0 + kBK > prm.Skv ||
                        (prm.causal && k0 + kBK - 1 > key_lo);
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        float x = sc[e] * prm.scale_log2;
        if (edge) {
          const int row = key_r0 + 8 * ((e >> 1) & 1);
          const int col = k0 + 8 * (e >> 2) + cq + (e & 1);
          if (col >= prm.Skv || (prm.causal && col > row)) x = kNegInf;
        }
        sc[e] = x;
      }
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = kNegInf;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * i], sc[4 * j + 2 * i + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[i], mx);
        alpha[i] = exp2f(m[i] - m_new);
        m[i] = m_new;
      }
      // p in place of the scores, and this thread's share of the row sums
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int i = (e >> 1) & 1;
        sc[e] = exp2f(sc[e] - m[i]);
        sum[i] += sc[e];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + sum[i];

      // PV = P V, a k8 block of keys at a time, lo.hi + hi.lo + hi.hi: A's
      // columns t and t + 4 are keys 2t and 2t + 1 of the block (elements
      // 4kk + c of rows r0, 4kk + 2 + c of rows r0 + 8), B's rows t and
      // t + 4 the same keys of V. Each tile's product starts from 0 and
      // joins O in an f32 FMA: with O summed over the whole sequence inside
      // the tensor cores (whose f32 sums do not round to nearest), the
      // error at S = 4096 was about 1.7 times as large.
      float pv[HD / 2];
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) pv[i] = 0.f;
      mbar_wait(v_full(s), parity);
      const unsigned char* const v_tile = smem + (v_s(s) - base);
#pragma unroll
      for (int kk = 0; kk < kBK / 8; ++kk) {
        const float pa[4] = {sc[4 * kk], sc[4 * kk + 2], sc[4 * kk + 1],
                             sc[4 * kk + 3]};
        uint32_t a_hi[4], a_lo[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          a_hi[r] = __float_as_uint(tf32_trunc(pa[r]));
          a_lo[r] = __float_as_uint(tf32_lo(pa[r]));
        }
        const int ra = 8 * kk + cq;   // keys ra (b0) and ra + 1 (b1)
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) {
          const int c = 8 * j + g;    // V's column
          const int chunk = (c & 31) >> 2;   // 16-byte chunk of a box row
          const unsigned char* box = v_tile + (c >> 5) * G::kVBoxBytes +
                                     (c & 3) * 4;
          const float v0 = *reinterpret_cast<const float*>(
              box + ra * 128 + ((chunk ^ (ra & 7)) << 4));
          const float v1 = *reinterpret_cast<const float*>(
              box + (ra + 1) * 128 + ((chunk ^ ((ra + 1) & 7)) << 4));
          const uint32_t b_hi0 = __float_as_uint(tf32_trunc(v0));
          const uint32_t b_hi1 = __float_as_uint(tf32_trunc(v1));
          const uint32_t b_lo0 = __float_as_uint(tf32_lo(v0));
          const uint32_t b_lo1 = __float_as_uint(tf32_lo(v1));
          mma_tf32(pv + 4 * j, a_lo, b_hi0, b_hi1);
          mma_tf32(pv + 4 * j, a_hi, b_lo0, b_lo1);
          mma_tf32(pv + 4 * j, a_hi, b_hi0, b_hi1);
        }
      }
      mbar_arrive(v_empty(s));
#pragma unroll
      for (int e = 0; e < HD / 2; ++e)
        o[e] = fmaf(o[e], alpha[(e >> 1) & 1], pv[e]);
    }

    // epilogue: full row sums, the l == 0 guard, f32 stores below Sq
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float li = l[i];
      li += __shfl_xor_sync(0xffffffffu, li, 1);
      li += __shfl_xor_sync(0xffffffffu, li, 2);
      const float inv = 1.f / (li == 0.f ? 1.f : li);
      const int row = r0 + 8 * i;
      if (row < prm.Sq) {
        float* dst = prm.o + b * prm.ob + h * prm.oh +
                     static_cast<long long>(row) * prm.os + cq;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j)
          *reinterpret_cast<float2*>(dst + 8 * j) =
              make_float2(o[4 * j + 2 * i] * inv, o[4 * j + 2 * i + 1] * inv);
      }
    }
  }
}

// A 4-D map (d, S, heads, B) over an f32 view; boxes of box_cols columns by
// box_rows rows. Returns 0 or the driver's CUresult.
int make_map(CUtensorMap* map, EncodeTiled encode, const void* ptr, int d,
             int S, int heads, int B, const long long* strides, int box_cols,
             int box_rows, CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(B)};
  // bytes between rows, heads and batches (strides[] are batch, head, row)
  const cuuint64_t gstrides[3] = {static_cast<cuuint64_t>(strides[2]) * 4,
                                  static_cast<cuuint64_t>(strides[1]) * 4,
                                  static_cast<cuuint64_t>(strides[0]) * 4};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows), 1, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return static_cast<int>(encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(ptr), dims,
      gstrides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE));
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const Params& prm,
           int B, int KV, const long long* strides, cudaStream_t stream) {
  using G = Geom<HD>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kNoEncoder;
  CUtensorMap tm_q, tm_k, tm_v;
  int r = make_map(&tm_q, encode, q, HD, prm.Sq, prm.H, B, strides,
                   G::kBoxCols, kBQ, G::kMapSwizzle);
  if (r == 0)
    r = make_map(&tm_k, encode, k, HD, prm.Skv, KV, B, strides + 3,
                 G::kBoxCols, kBK, G::kMapSwizzle);
  if (r == 0)
    r = make_map(&tm_v, encode, v, HD, prm.Skv, KV, B, strides + 6, 32, kBK,
                 CU_TENSOR_MAP_SWIZZLE_128B);
  if (r != 0) return kEncodeFailed - r;
  auto kernel = flash_attention_tf32_kernel<HD>;
  static unsigned long long set_on = 0;
  const cudaError_t e = allow_smem(kernel, G::kSmem, set_on);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<dim3(B * prm.H, prm.n_q_tiles), kThreads, G::kSmem, stream>>>(
      tm_q, tm_k, tm_v, prm);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// f32 only; hd a multiple of 16 from 16 to 128. Pointers are device
// pointers, 16-byte aligned, with the strides (in elements) of the batch,
// head and sequence dims given in `strides` as q, k, v, o triples; the last
// dim is contiguous and every stride a multiple of 16 bytes below 2^40
// bytes. q_off >= 0 is the keys' row of q's row 0 under the causal mask,
// q_off + Sq below 2^31. Grid: B*H blocks on x, ceil(Sq / 128) <= 65535 on
// y. Returns 0, a cudaError_t, or -1 (no tensor-map encoder in the driver) /
// -1000 - r (the encoder refused a map with CUresult r). Launches on
// `stream`, does not synchronise and allocates nothing.
int flash_attention_tf32_launch(const void* q, const void* k, const void* v,
                                void* o, int B, int H, int KV, int Sq,
                                int Skv, int hd, int causal, int q_off,
                                float scale, const long long* strides,
                                cudaStream_t stream) {
  if (B < 1 || H < 1 || KV < 1 || H % KV || Sq < 1 || Skv < 1 || q_off < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params prm{static_cast<float*>(o), strides[9], strides[10],
                   strides[11], H, H / KV, Sq, Skv, (Sq + kBQ - 1) / kBQ,
                   causal, q_off, scale * 1.4426950408889634f};
  switch (hd) {
    case 16: return launch<16>(q, k, v, prm, B, KV, strides, stream);
    case 32: return launch<32>(q, k, v, prm, B, KV, strides, stream);
    case 48: return launch<48>(q, k, v, prm, B, KV, strides, stream);
    case 64: return launch<64>(q, k, v, prm, B, KV, strides, stream);
    case 80: return launch<80>(q, k, v, prm, B, KV, strides, stream);
    case 96: return launch<96>(q, k, v, prm, B, KV, strides, stream);
    case 112: return launch<112>(q, k, v, prm, B, KV, strides, stream);
    case 128: return launch<128>(q, k, v, prm, B, KV, strides, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Dynamic shared memory a block of the kernel takes at head dim hd, in
// bytes (0 for a head dim it does not take).
int flash_attention_tf32_smem_bytes(int hd) {
  switch (hd) {
    case 16: return static_cast<int>(Geom<16>::kSmem);
    case 32: return static_cast<int>(Geom<32>::kSmem);
    case 48: return static_cast<int>(Geom<48>::kSmem);
    case 64: return static_cast<int>(Geom<64>::kSmem);
    case 80: return static_cast<int>(Geom<80>::kSmem);
    case 96: return static_cast<int>(Geom<96>::kSmem);
    case 112: return static_cast<int>(Geom<112>::kSmem);
    case 128: return static_cast<int>(Geom<128>::kSmem);
  }
  return 0;
}

}  // extern "C"

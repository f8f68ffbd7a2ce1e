// Backward of the bf16 flash attention on Hopper's tensor cores (sm_90a):
// TMA loads into a shared-memory ring, wgmma products, a warp-specialised
// block, as in flash_attention_wgmma.cu.
//
// Replaces no TPU kernel: the reference's Pallas kernel
// (src/repro/kernels/flash_attention/flash_attention.py::_flash_kernel) has
// no custom_vjp and cannot be differentiated. It replaces, for bf16 CUDA
// inputs, the port's plain backward (flash_attention.py `_plain_backward`:
// the f32 score tensor recomputed and differentiated by autograd). Same
// function: with P = softmax(scale Q K^T) under the top-left causal mask
// (query row r is key row q_off + r) and D = rowsum(dO o O),
//   dS = P o (dO V^T - D),  dQ = scale dS K,  dK = scale dS^T Q,  dV = P^T dO,
// summed over the G query heads that share a kv head, in f32, stored in
// bf16 through each gradient's strides.
//
// Bound on an H100 at granite-moe's training shape (B=4, H=16, KV=8,
// S=4096, d=64, causal): operations. The five products a kept (query, key)
// pair (Q K^T, dO V^T, dV, dQ, dK) are 10*d flops: 3.44e11, ~0.35 ms at
// 989 TFLOP/s, against ~0.1 GB of q, k, v, o, dO and the gradients
// (~0.03 ms at 3.35 TB/s). This design does 22*d a pair (below): its own
// floor is ~0.76 ms.
//
// Design:
//   * The forward (flash_attention_wgmma.cu) saves the row log-sum-exp in
//     log2 units and the output's low half, bf16(o - bf16(o)), in the order
//     of its threads' fragments. The dQ kernel's block of the same rows
//     first takes D = rowsum(dO o (O + O_lo)) in f32 and writes it for dK
//     and dV: from O rounded once to bf16 the error of D reaches dQ and dK
//     past the port's bar (rtol 1e-2, atol 1e-3 against autograd of the
//     plain version). Each dQ thread reads the fragment its counterpart in
//     the forward wrote, so the two kernels must keep one mapping of block,
//     thread and element to (row, column): 128 rows a block, consumer
//     warpgroup w's warp j holding rows 64w + 16j + lane/4 and + 8, columns
//     8i + 2 (lane % 4) and + 1 (the wgmma m64 accumulator's layout).
//   * P = exp2(S * scale * log2(e) - lse) and dS are recomputed on the
//     fragment of the score product, in f32, and fed to the tensor cores
//     as two bf16 halves (hi = bf16(x), lo = bf16(x - hi), two wgmmas into
//     one f32 accumulator), as the forward feeds P: one rounding of P (dV)
//     or of dS (dQ, dK) misses the same bar.
//   * Three kernels of one template, each with one accumulator of 128 rows
//     x d (two consumer warpgroups of 64 rows, wgmma's M) and a loop over
//     tiles of 64 columns that a producer warpgroup's one thread loads by
//     TMA into a two-stage ring:
//       dQ: a block per (b, query head, 128 query rows); its kv head's
//           K, V tiles (up to the causal frontier); S = Q K^T,
//           dP = dO V^T, acc += dS K.
//       dK: a block per (b, kv head, 128 keys); the G query heads' Q, dO
//           tiles and their lse and D (bulk copies), from the first tile
//           that sees a key of the block; S^T = K Q^T, dP^T = V dO^T,
//           acc += dS^T Q. GQA's sum over the group stays in registers.
//       dV: as dK without dP: acc += P^T dO.
//     No atomics: every gradient is written once by one block, and two
//     calls give the same bits. One accumulator a kernel keeps every head
//     dim at 32 + 32 + 32 registers of scores, dP and halves beside d / 2
//     of accumulator. dV recomputes S (2*d a pair of the 22*d).
//   * The score products: wgmma m64n64k16 with both operands K-major in
//     shared memory (tiles in boxes of one swizzle span of columns, as in
//     the forward). The accumulating products: the fragment becomes the
//     register A operand in place, B = the column tile (K, Q or dO), which
//     is d-contiguous: MN-major, one m64n{d}k16 a 16-column step.
//   * Masks only on tiles that cross the causal frontier, Sq or Skv; rows
//     and columns past Sq or Skv load as zeros. Heaviest blocks first: dQ's
//     last query tile, dK's and dV's first key tile.
//
// Plain C interface, loaded with ctypes (repro_torch/kernels/_build.py).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "smem_limit.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kRows = 128;    // accumulator rows a block: two warpgroups of 64
constexpr int kCols = 64;     // columns a tile of the loop
constexpr int kStages = 2;    // column-tile ring depth
constexpr int kConsumers = 256;
constexpr int kThreads = 384;

enum Mode { kDQ, kDK, kDV };

// Shared-memory geometry at head dim d: two row tiles (128 rows), then the
// ring, each stage two column tiles (64 rows) and the columns' lse and D.
template <int HD>
struct Geom {
  static_assert(HD % 16 == 0 && HD >= 16 && HD <= 128, "head dim");
  static constexpr int kSwizzle =  // bytes
      HD % 64 == 0 ? 128 : (HD == 32 ? 64 : 32);
  static constexpr int kBoxCols = kSwizzle / 2;  // elements a box row
  static constexpr int kBoxes = HD / kBoxCols;   // boxes a tile row
  static constexpr int kRowBox = kRows * kSwizzle;
  static constexpr int kColBox = kCols * kSwizzle;
  static constexpr int kRowTile = kBoxes * kRowBox;
  static constexpr int kColTile = kBoxes * kColBox;
  static constexpr int kStatBytes = 1024;  // 2 x 64 floats, kept aligned
  static constexpr int kStageBytes = 2 * kColTile + kStatBytes;
  // the descriptor's layout type: B128, B64, B32
  static constexpr uint64_t kLayout =
      kSwizzle == 128 ? 1 : (kSwizzle == 64 ? 2 : 3);
  static constexpr CUtensorMapSwizzle kMapSwizzle =
      kSwizzle == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                      : (kSwizzle == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                        : CU_TENSOR_MAP_SWIZZLE_32B);
  static constexpr size_t kSmem =
      static_cast<size_t>(2 * kRowTile + kStages * kStageBytes) +
      8 * (2 * kStages + 1) + 1024;  // tiles, barriers, alignment slack
};

struct Params {
  __nv_bfloat16* out;    // dq, dk or dv
  long long ob, oh, os;  // its strides in elements: batch, head, row
  const float* lse;      // [B * H, sq_pad], log2 units of the scaled scores
  float* dsum;           // D = rowsum(dO o O), [B * H, sq_pad]: dQ writes it
  // what dQ reads to take D: O and dO at their strides, O's low half in
  // the forward's fragment order (flash_attention_wgmma.cu, Params::o_lo)
  const __nv_bfloat16 *o, *d_o, *o_lo;
  long long o_b, o_h, o_s, g_b, g_h, g_s;
  int H, G, Sq, Skv, sq_pad, causal;
  int q_off;             // the keys' row of q's row 0 (causal mask)
  float scale_log2;      // 1/sqrt(d) * log2(e)
  float scale;           // of the stored gradient: 1/sqrt(d), or 1 for dv
};

template <int HD>
__device__ __forceinline__ void wgmma_acc(float (&acc)[HD / 2],
                                          const uint32_t* a, uint64_t db) {
  if constexpr (HD == 16) wgmma_rs_n16(acc, a, db, 1);
  if constexpr (HD == 32) wgmma_rs_n32(acc, a, db, 1);
  if constexpr (HD == 48) wgmma_rs_n48(acc, a, db, 1);
  if constexpr (HD == 64) wgmma_rs_n64(acc, a, db, 1);
  if constexpr (HD == 80) wgmma_rs_n80(acc, a, db, 1);
  if constexpr (HD == 96) wgmma_rs_n96(acc, a, db, 1);
  if constexpr (HD == 112) wgmma_rs_n112(acc, a, db, 1);
  if constexpr (HD == 128) wgmma_rs_n128(acc, a, db, 1);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// One block of the dQ, dK or dV kernel. Row tiles: A1 (Q, or K) and A2
// (dO, or V; none for dV), 128 rows. Column tiles: X (K, or Q) and Y (V, or
// dO), 64 rows. S = A1 X^T, dP = A2 Y^T, acc += dS X (dV: acc += P Y).
template <int HD, int MODE>
__device__ __forceinline__ void bwd_block(const CUtensorMap* tm_a1,
                                          const CUtensorMap* tm_a2,
                                          const CUtensorMap* tm_x,
                                          const CUtensorMap* tm_y,
                                          const Params& prm) {
  using G = Geom<HD>;
  constexpr bool kRowStats = MODE == kDQ;  // lse, D by row, else by column
  constexpr bool kDP = MODE != kDV;
  extern __shared__ unsigned char smem_raw[];
  // 1024-byte alignment: the 128-byte swizzle repeats every 8 rows.
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const unsigned char* base_ptr = smem_raw + (base - raw);
  const uint32_t a1_s = base;
  const uint32_t a2_s = a1_s + G::kRowTile;
  const uint32_t ring = a2_s + G::kRowTile;
  const uint32_t bars = ring + kStages * G::kStageBytes;
  auto full_bar = [&](int s) { return bars + 8 * s; };
  auto empty_bar = [&](int s) { return bars + 8 * (kStages + s); };
  const uint32_t a_bar = bars + 16 * kStages;

  // the block's rows: (b, row head, tile), heaviest first
  const int row_heads = kRowStats ? prm.H : prm.H / prm.G;
  const int b = blockIdx.x / row_heads;
  const int rh = blockIdx.x - b * row_heads;
  const int rt = kRowStats ? static_cast<int>(gridDim.y - 1 - blockIdx.y)
                           : static_cast<int>(blockIdx.y);
  const int r_first = rt * kRows;
  // its column tiles: dQ, the kv head's keys up to the causal frontier of
  // its last real row; dK, dV, each query head of the group from the first
  // tile whose last row sees the block's first key
  int t_first, per_head, n_iter;
  if constexpr (kRowStats) {
    const int n_kv = (prm.Skv + kCols - 1) / kCols;
    const int last = prm.q_off + min(r_first + kRows, prm.Sq) - 1;
    t_first = 0;
    per_head = prm.causal ? min(n_kv, last / kCols + 1) : n_kv;
    n_iter = per_head;
  } else {
    const int n_q = (prm.Sq + kCols - 1) / kCols;
    t_first = prm.causal ? max(0, r_first - prm.q_off) / kCols : 0;
    per_head = max(0, n_q - t_first);
    n_iter = prm.G * per_head;
  }
  auto column = [&](int it, int& head, int& col0) {
    if constexpr (kRowStats) {
      head = rh / prm.G;
      col0 = it * kCols;
    } else {
      const int j = it / per_head;
      head = rh * prm.G + j;
      col0 = (t_first + it - j * per_head) * kCols;
    }
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_bar(s), 1);
      mbar_init(empty_bar(s), kConsumers);
    }
    mbar_init(a_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: one thread issues every load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 256) {
      mbar_expect_tx(a_bar, (kDP ? 2 : 1) * G::kRowTile);
      for (int c = 0; c < G::kBoxes; ++c) {
        tma_load(a1_s + c * G::kRowBox, tm_a1, a_bar, c * G::kBoxCols,
                 r_first, rh, b);
        if (kDP)
          tma_load(a2_s + c * G::kRowBox, tm_a2, a_bar, c * G::kBoxCols,
                   r_first, rh, b);
      }
      for (int it = 0; it < n_iter; ++it) {
        const int s = it % kStages;
        if (it >= kStages) mbar_wait(empty_bar(s), ((it / kStages) - 1) & 1);
        int head, col0;
        column(it, head, col0);
        const uint32_t x_s = ring + s * G::kStageBytes;
        const uint32_t y_s = x_s + G::kColTile;
        mbar_expect_tx(full_bar(s),
                       2 * G::kColTile + (kRowStats ? 0 : 2 * kCols * 4));
        for (int c = 0; c < G::kBoxes; ++c) {
          tma_load(x_s + c * G::kColBox, tm_x, full_bar(s), c * G::kBoxCols,
                   col0, head, b);
          tma_load(y_s + c * G::kColBox, tm_y, full_bar(s), c * G::kBoxCols,
                   col0, head, b);
        }
        if (!kRowStats) {
          const long long at =
              static_cast<long long>(b * prm.H + head) * prm.sq_pad + col0;
          bulk_load(y_s + G::kColTile, prm.lse + at, kCols * 4, full_bar(s));
          bulk_load(y_s + G::kColTile + kCols * 4, prm.dsum + at, kCols * 4,
                    full_bar(s));
        }
      }
    }
  } else {
    // ---- consumers: 64 rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int lane = threadIdx.x & 31;
    const int warp = (threadIdx.x / 32) & 3;
    const int row_lo = r_first + wg * 64;          // this warpgroup's first row
    const int r0 = row_lo + warp * 16 + lane / 4;  // rows r0 and r0 + 8
    const int cq = 2 * (lane & 3);                 // column offset in an n8 block

    float lse_r[2] = {0.f, 0.f}, d_r[2] = {0.f, 0.f};
    if constexpr (kRowStats) {
      // D of rows r0 and r0 + 8: this thread's d / 4 columns of each (the
      // fragment's, 8j + cq and + 1), summed over the quad; 0 past Sq. The
      // forward's block of these rows had this thread hold the same
      // elements: its low half is one contiguous run.
      const long long at = static_cast<long long>(b * prm.H + rh) * prm.sq_pad;
      const uint4* lo4 = reinterpret_cast<const uint4*>(
          prm.o_lo + (at + r_first) * HD + threadIdx.x * (HD / 2));
      uint32_t lo[HD / 4];  // elements 4j + 2i and + 1 in word 2j + i
#pragma unroll
      for (int c = 0; c < HD / 16; ++c) {
        const uint4 u = lo4[c];
        lo[4 * c] = u.x;
        lo[4 * c + 1] = u.y;
        lo[4 * c + 2] = u.z;
        lo[4 * c + 3] = u.w;
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = r0 + 8 * i;
        float dsum = 0.f;
        if (row < prm.Sq) {
          const __nv_bfloat16* o = prm.o + b * prm.o_b + rh * prm.o_h +
                                   static_cast<long long>(row) * prm.o_s + cq;
          const __nv_bfloat16* g = prm.d_o + b * prm.g_b + rh * prm.g_h +
                                   static_cast<long long>(row) * prm.g_s + cq;
#pragma unroll
          for (int j = 0; j < HD / 8; ++j) {
            const float2 hi = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(o + 8 * j));
            const float2 rest = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(&lo[2 * j + i]));
            const float2 gr = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(g + 8 * j));
            dsum += gr.x * (hi.x + rest.x) + gr.y * (hi.y + rest.y);
          }
        }
        dsum += __shfl_xor_sync(0xffffffffu, dsum, 1);
        dsum += __shfl_xor_sync(0xffffffffu, dsum, 2);
        d_r[i] = dsum;
        lse_r[i] = prm.lse[at + row];
        if (cq == 0) prm.dsum[at + row] = dsum;
      }
    }
    float acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;

    // K-major operands: 8-row groups one swizzle span of rows apart. The
    // MN-major column tile: 16-row steps, spans of columns a box apart.
    constexpr uint32_t kGroup = 8 * G::kSwizzle;
    const uint32_t a1_wg = a1_s + wg * 64 * G::kSwizzle;
    const uint32_t a2_wg = a2_s + wg * 64 * G::kSwizzle;

    mbar_wait(a_bar, 0);
    for (int it = 0; it < n_iter; ++it) {
      const int s = it % kStages;
      int head, col0;
      column(it, head, col0);
      const uint32_t x_s = ring + s * G::kStageBytes;
      const uint32_t y_s = x_s + G::kColTile;
      const float* st_lse = reinterpret_cast<const float*>(
          base_ptr + (y_s + G::kColTile - base));
      const float* st_d = st_lse + kCols;
      mbar_wait(full_bar(s), (it / kStages) & 1);

      // S = A1 X^T and dP = A2 Y^T over d, 16 at a time
      float sc[32], dp[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int box = kk * 16 / G::kBoxCols;
        const uint32_t col_b = (kk * 16 % G::kBoxCols) * 2;
        const uint32_t a_off = box * G::kRowBox + col_b;
        const uint32_t x_off = box * G::kColBox + col_b;
        wgmma_ss_n64(sc, make_desc(a1_wg + a_off, 16, kGroup, G::kLayout),
                     make_desc(x_s + x_off, 16, kGroup, G::kLayout), kk > 0);
        if constexpr (kDP)
          wgmma_ss_n64(dp, make_desc(a2_wg + a_off, 16, kGroup, G::kLayout),
                       make_desc(y_s + x_off, 16, kGroup, G::kLayout),
                       kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(sc);
      if constexpr (kDP) reg_fence(dp);

      // P (dV) or dS (dQ, dK) as hi + lo A operands: element 4j + 2i + c is
      // row r0 + 8i, column col0 + 8j + cq + c; the operand of 16-column
      // step kk, register r, holds elements 8kk + 2r and 8kk + 2r + 1
      const bool edge =
          kRowStats ? (col0 + kCols > prm.Skv ||
                       (prm.causal && col0 + kCols - 1 > prm.q_off + row_lo))
                    : (col0 + kCols > prm.Sq ||
                       (prm.causal && prm.q_off + col0 < row_lo + 63));
      uint32_t m_hi[4][4], m_lo[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = r & 1;
          const int row = r0 + 8 * i;
          float x[2];
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int e = 8 * kk + 2 * r + c;
            const int cl = 8 * (e >> 2) + cq + c;  // column within the tile
            const int col = col0 + cl;
            const float lse = kRowStats ? lse_r[i] : st_lse[cl];
            float p = exp2f(sc[e] * prm.scale_log2 - lse);
            if (edge) {
              const bool keep =
                  kRowStats
                      ? (col < prm.Skv && (!prm.causal || prm.q_off + row >= col))
                      : (col < prm.Sq && (!prm.causal || prm.q_off + col >= row));
              if (!keep) p = 0.f;
            }
            if constexpr (kDP)
              x[c] = p * (dp[e] - (kRowStats ? d_r[i] : st_d[cl]));
            else
              x[c] = p;
          }
          const __nv_bfloat162 hi = __floats2bfloat162_rn(x[0], x[1]);
          const float2 hf = __bfloat1622float2(hi);
          m_hi[kk][r] = pack_bf16(hi);
          m_lo[kk][r] = pack_bf16(__floats2bfloat162_rn(x[0] - hf.x,
                                                        x[1] - hf.y));
        }
      }

      // acc += M_hi Z + M_lo Z, 16 columns at a time
      const uint32_t z_s = MODE == kDV ? y_s : x_s;
      reg_fence(acc);
      reg_fence(m_hi);
      reg_fence(m_lo);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t dz = make_desc(z_s + kk * 16 * G::kSwizzle,
                                      G::kColBox, kGroup, G::kLayout);
        wgmma_acc<HD>(acc, m_hi[kk], dz);
        wgmma_acc<HD>(acc, m_lo[kk], dz);
      }
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(acc);
      reg_fence(m_hi);
      reg_fence(m_lo);
      mbar_arrive(empty_bar(s));
    }

    // epilogue: scaled bf16 stores of the rows below Sq (dQ) or Skv
    const int n_rows = kRowStats ? prm.Sq : prm.Skv;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = r0 + 8 * i;
      if (row < n_rows) {
        __nv_bfloat16* dst = prm.out + b * prm.ob + rh * prm.oh +
                             static_cast<long long>(row) * prm.os + cq;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
              __floats2bfloat162_rn(acc[4 * j + 2 * i] * prm.scale,
                                    acc[4 * j + 2 * i + 1] * prm.scale);
      }
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                                  const __grid_constant__ CUtensorMap tm_do,
                                  const __grid_constant__ CUtensorMap tm_k,
                                  const __grid_constant__ CUtensorMap tm_v,
                                  const Params prm) {
  bwd_block<HD, kDQ>(&tm_q, &tm_do, &tm_k, &tm_v, prm);
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_bwd_dk_kernel(const __grid_constant__ CUtensorMap tm_k,
                                  const __grid_constant__ CUtensorMap tm_v,
                                  const __grid_constant__ CUtensorMap tm_q,
                                  const __grid_constant__ CUtensorMap tm_do,
                                  const Params prm) {
  bwd_block<HD, kDK>(&tm_k, &tm_v, &tm_q, &tm_do, prm);
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_bwd_dv_kernel(const __grid_constant__ CUtensorMap tm_k,
                                  const __grid_constant__ CUtensorMap tm_q,
                                  const __grid_constant__ CUtensorMap tm_do,
                                  const Params prm) {
  bwd_block<HD, kDV>(&tm_k, &tm_k, &tm_q, &tm_do, prm);
}

// A 4-D map (d, S, heads, B) over a bf16 view; boxes of one swizzle span of
// columns by `rows` rows. Returns 0 or the driver's CUresult.
template <int HD>
int make_map(CUtensorMap* map, EncodeTiled encode, const void* ptr, int S,
             int heads, int B, const long long* strides, int rows) {
  using G = Geom<HD>;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(HD),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(B)};
  // bytes between rows, heads and batches (strides[] are batch, head, row)
  const cuuint64_t gstrides[3] = {static_cast<cuuint64_t>(strides[2]) * 2,
                                  static_cast<cuuint64_t>(strides[1]) * 2,
                                  static_cast<cuuint64_t>(strides[0]) * 2};
  const cuuint32_t box[4] = {G::kBoxCols, static_cast<cuuint32_t>(rows), 1,
                             1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return static_cast<int>(encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      gstrides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, G::kMapSwizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE));
}

struct Tensors {
  const void *q, *k, *v, *o, *o_lo, *d_o;
  const float* lse;
  float* dsum;
  void *dq, *dk, *dv;
};

template <int HD>
int launch(const Tensors& t, int B, int H, int KV, int Sq, int Skv,
           int causal, int q_off, float scale, const long long* st,
           cudaStream_t stream) {
  using G = Geom<HD>;
  // The encoder is a driver call: make the device's context current on
  // this thread first (autograd runs the backward on a thread of its own,
  // where no runtime call may have done so yet).
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaSetDevice(dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kNoEncoder;
  // strides: q, k, v, o, dO, dq, dk, dv, three each
  const long long *sq_ = st, *sk = st + 3, *sv = st + 6, *so = st + 9,
                  *sg = st + 12, *sdq = st + 15, *sdk = st + 18,
                  *sdv = st + 21;
  CUtensorMap q128, do128, k64, v64, k128, v128, q64, do64;
  int r = make_map<HD>(&q128, encode, t.q, Sq, H, B, sq_, kRows);
  if (r == 0) r = make_map<HD>(&do128, encode, t.d_o, Sq, H, B, sg, kRows);
  if (r == 0) r = make_map<HD>(&k64, encode, t.k, Skv, KV, B, sk, kCols);
  if (r == 0) r = make_map<HD>(&v64, encode, t.v, Skv, KV, B, sv, kCols);
  if (r == 0) r = make_map<HD>(&k128, encode, t.k, Skv, KV, B, sk, kRows);
  if (r == 0) r = make_map<HD>(&v128, encode, t.v, Skv, KV, B, sv, kRows);
  if (r == 0) r = make_map<HD>(&q64, encode, t.q, Sq, H, B, sq_, kCols);
  if (r == 0) r = make_map<HD>(&do64, encode, t.d_o, Sq, H, B, sg, kCols);
  if (r != 0) return kEncodeFailed - r;

  const int q_tiles = (Sq + kRows - 1) / kRows;
  const int k_tiles = (Skv + kRows - 1) / kRows;
  auto params = [&](void* out, const long long* s_out, float s) {
    return Params{static_cast<__nv_bfloat16*>(out), s_out[0], s_out[1],
                  s_out[2], t.lse, t.dsum,
                  static_cast<const __nv_bfloat16*>(t.o),
                  static_cast<const __nv_bfloat16*>(t.d_o),
                  static_cast<const __nv_bfloat16*>(t.o_lo), so[0], so[1],
                  so[2], sg[0], sg[1], sg[2], H, H / KV, Sq, Skv,
                  q_tiles * kRows, causal, q_off,
                  scale * 1.4426950408889634f, s};
  };
  static unsigned long long set_dq = 0, set_dk = 0, set_dv = 0;
  auto dq = flash_attention_bwd_dq_kernel<HD>;
  auto dk = flash_attention_bwd_dk_kernel<HD>;
  auto dv = flash_attention_bwd_dv_kernel<HD>;
  e = allow_smem(dq, G::kSmem, set_dq);
  if (e == cudaSuccess) e = allow_smem(dk, G::kSmem, set_dk);
  if (e == cudaSuccess) e = allow_smem(dv, G::kSmem, set_dv);
  if (e != cudaSuccess) return static_cast<int>(e);
  // dQ first: it writes D, which dK and dV read
  dq<<<dim3(B * H, q_tiles), kThreads, G::kSmem, stream>>>(
      q128, do128, k64, v64, params(t.dq, sdq, scale));
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  dk<<<dim3(B * KV, k_tiles), kThreads, G::kSmem, stream>>>(
      k128, v128, q64, do64, params(t.dk, sdk, scale));
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  dv<<<dim3(B * KV, k_tiles), kThreads, G::kSmem, stream>>>(
      k128, q64, do64, params(t.dv, sdv, 1.f));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// bf16 only; hd a multiple of 16 from 16 to 128. q, k, v, o, o_lo, d_o and
// the gradients dq, dk, dv are device pointers, 16-byte aligned, with the
// strides (in elements) of their batch, head and sequence dims given in
// `strides` as triples in that order (o_lo has none); the last dim is
// contiguous and every stride a multiple of 16 bytes below 2^40 bytes. lse
// and o_lo are the forward's (flash_attention_bf16_lse_launch): lse [B * H,
// sq_pad] f32 with sq_pad = ceil(Sq / 128) * 128, o_lo [B * H, sq_pad, hd]
// bf16 in fragment order; dsum is scratch of lse's shape. Grids: B*H (dq)
// or B*KV (dk, dv) blocks on x, ceil(Sq / 128) or ceil(Skv / 128) <= 65535
// on y. Returns 0, a cudaError_t, or -1 / -1000 - r as
// flash_attention_bf16_launch. Launches three kernels on `stream`, does not
// synchronise and allocates nothing.
int flash_attention_bf16_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* o_lo, const void* d_o, const float* lse, float* dsum,
    void* dq, void* dk, void* dv, int B, int H, int KV, int Sq, int Skv,
    int hd, int causal, int q_off, float scale, const long long* strides,
    cudaStream_t stream) {
  if (B < 1 || H < 1 || KV < 1 || H % KV || Sq < 1 || Skv < 1 || q_off < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Tensors t{q, k, v, o, o_lo, d_o, lse, dsum, dq, dk, dv};
  switch (hd) {
    case 16: return launch<16>(t, B, H, KV, Sq, Skv, causal, q_off, scale, strides, stream);
    case 32: return launch<32>(t, B, H, KV, Sq, Skv, causal, q_off, scale, strides, stream);
    case 48: return launch<48>(t, B, H, KV, Sq, Skv, causal, q_off, scale, strides, stream);
    case 64: return launch<64>(t, B, H, KV, Sq, Skv, causal, q_off, scale, strides, stream);
    case 80: return launch<80>(t, B, H, KV, Sq, Skv, causal, q_off, scale, strides, stream);
    case 96: return launch<96>(t, B, H, KV, Sq, Skv, causal, q_off, scale, strides, stream);
    case 112: return launch<112>(t, B, H, KV, Sq, Skv, causal, q_off, scale, strides, stream);
    case 128: return launch<128>(t, B, H, KV, Sq, Skv, causal, q_off, scale, strides, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"

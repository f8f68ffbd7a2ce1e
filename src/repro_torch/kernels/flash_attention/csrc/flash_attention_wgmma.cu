// Blocked online-softmax attention in bf16 on Hopper's tensor cores
// (sm_90a): TMA loads into a shared-memory ring, wgmma products, a warp-
// specialised block.
//
// Replaces, for bf16, the TPU kernel
// src/repro/kernels/flash_attention/flash_attention.py::_flash_kernel
// (pallas_call at line 107); f32 runs the 3xTF32 tensor-core kernel of
// flash_attention_tf32.cu. Same function: q [B, H, Sq, d] against k, v
// [B, KV, Skv, d], scores scaled by 1/sqrt(d) in f32, a top-left causal mask
// (row >= col) applied before the running max, keys at or past Skv masked,
// running max / denominator / accumulator in f32, fully masked rows giving 0
// (the `l == 0 -> 1` guard), output in bf16. The same two liberties as the
// f32 kernel: query head h reads kv head h / G directly (GQA), and
// every tensor is addressed through its batch, head and sequence strides
// (the model's [B, S, H, d] activations are read and written in place).
//
// Bound on an H100 at the training shape (B=2, H=32, KV=8, S=4096, d=128,
// causal): operations. 4*d flops a kept (query, key) pair, QK and PV, are
// ~0.28 ms at 989 TFLOP/s, against ~168 MB of q, k, v and o (~0.05 ms at
// 3.35 TB/s). This kernel does 6*d a pair, see P below: its own floor is
// ~0.42 ms. At zamba2's training shape (B=2, H=KV=32, S=4096, d=80,
// causal) the same counts give ~0.174 ms of operations against ~0.050 ms
// of bytes, and a floor of ~0.26 ms for this kernel.
//
// Design:
//   * One block of three warpgroups per (b*h, tile of 128 query rows). The
//     q-tile index is the grid's slow axis and runs heaviest first (the
//     last tile of a causal call sees the most keys), so the causal tail is
//     short for the whole grid, not only within one head.
//   * Warpgroup 2 is the producer: one thread issues TMA loads of the Q
//     tile (once) and of K and V tiles of 128 keys into a ring of kStages
//     stages, with a full and an empty mbarrier per stage. It gives up
//     registers (setmaxnreg) to the two consumer warpgroups 0 and 1, each
//     of which owns 64 query rows (wgmma's M).
//   * Head dims 16 to 128 in steps of 16, none padded. Tensor maps are 4-D
//     (d, S, heads, B) over the view's byte strides, so strided views need
//     no copy. Rows past Sq or Skv load as zeros. A tile is cut into boxes
//     of 128 rows by one swizzle span of columns: 128 bytes where d is a
//     multiple of 64 (one box a row at d = 64, two at d = 128), 64 bytes at
//     d = 32, and 32 bytes (16 columns) at every other d, d / 16 boxes a
//     row (d = 16, 48, 80, 96, 112); the wgmma descriptors name the same
//     swizzle.
//   * S = Q K^T: wgmma m64n128k16 with both operands K-major in shared
//     memory, accumulated in 64 f32 registers a thread, d / 16 k16 steps
//     (at a 32-byte swizzle one box a step).
//   * The online softmax runs on that fragment: the four threads sharing a
//     row reduce its max with two shuffles; exp2f with scale*log2(e)
//     folded in; masks only on tiles that cross the causal frontier or Skv;
//     causal tiles past the frontier are never loaded.
//   * O += P V: the score fragment becomes wgmma's register A operand in
//     place (FlashAttention-3's reuse). P goes in as two bf16 halves,
//     hi = bf16(p) and lo = bf16(p - hi), two wgmmas into the same f32 O:
//     P rounded once to bf16 misses the port's bar against the plain
//     version (rtol 1e-2, atol 1e-3) where a few large p*v terms cancel,
//     hi + lo keeps p to ~16 bits. V is d-contiguous, so B is MN-major
//     (the transpose bit). One m64n{d}k16 a 16-key step (N = d is a legal
//     wgmma N at every d taken) whose descriptor steps one box between
//     swizzle spans of columns (its leading byte offset): the accumulator
//     stays one d / 2-register fragment, and the tensor cores see one
//     product of the full width instead of d / 16 narrow ones.
//   * Epilogue: the `l == 0` guard, divide by l, bf16 stores through the
//     output's strides; rows at or past Sq are never written. For training
//     (flash_attention_bf16_lse_launch) also what the backward kernels
//     (flash_attention_bwd.cu) read: the row log-sum-exp and the output's
//     low half, bf16(o - bf16(o)), each thread's fragment in 16-byte
//     stores. The dQ kernel's block of the same rows reads that fragment
//     back in the same thread, so the two kernels' mappings of block,
//     thread and element to (row, column) must stay the same: 128 rows a
//     block, consumer warpgroup w's warp j holding rows 64w + 16j + lane/4
//     and + 8, columns 8i + 2 (lane % 4) and + 1.
//   * A query-row offset `q_off` (>= 0, not necessarily a multiple of a
//     tile) makes q's row r the keys' row q_off + r for the causal mask, the
//     edge test and the tile count (up to the key tile of the block's last
//     real row): a rank's slice of a sequence's rows keeps the diagonal.
//     Key tile 0 holds key 0, which every row sees, so no row's first tile
//     is wholly masked.
//
// Plain C interface, loaded with ctypes (repro_torch/kernels/_build.py).
// cuTensorMapEncodeTiled is a driver function: it is fetched at run time
// through cudaGetDriverEntryPoint, so the library links nothing.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "smem_limit.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kBQ = 128;      // query rows a block: two warpgroups of 64
constexpr int kBK = 128;      // keys a tile
constexpr int kStages = 2;    // K/V ring depth
constexpr int kConsumers = 256;
constexpr int kThreads = 384;
constexpr float kNegInf = -1e30f;

// Shared-memory geometry of a 128-row tile of d bf16 values.
template <int HD>
struct Geom {
  static_assert(HD % 16 == 0 && HD >= 16 && HD <= 128, "head dim");
  static constexpr int kSwizzle =  // bytes
      HD % 64 == 0 ? 128 : (HD == 32 ? 64 : 32);
  static constexpr int kBoxCols = kSwizzle / 2;   // elements a box row
  static constexpr int kBoxes = HD / kBoxCols;    // boxes a tile row
  static constexpr int kBoxBytes = 128 * kSwizzle;
  static constexpr int kTileBytes = kBoxes * kBoxBytes;
  // the descriptor's layout type: B128, B64, B32
  static constexpr uint64_t kLayout =
      kSwizzle == 128 ? 1 : (kSwizzle == 64 ? 2 : 3);
  static constexpr CUtensorMapSwizzle kMapSwizzle =
      kSwizzle == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                      : (kSwizzle == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                        : CU_TENSOR_MAP_SWIZZLE_32B);
  static constexpr size_t kSmem =
      static_cast<size_t>(kTileBytes) * (1 + 2 * kStages) +
      8 * (2 * kStages + 1) + 1024;  // tiles, barriers, alignment slack
};

struct Params {
  __nv_bfloat16* o;
  long long ob, oh, os;  // output strides in elements: batch, head, row
  // For the backward kernels (flash_attention_bwd.cu), or null: the
  // output's low half, bf16(o - bf16(o)), in fragment order ([B * H,
  // n_q_tiles, 256 consumer threads, d / 2]: each thread's accumulator
  // fragment contiguous, word 2j + i holding elements 4j + 2i and + 1), and
  // the row log-sum-exp in log2 units of the scaled scores, [B * H,
  // n_q_tiles * 128]; both for every row of every tile, the padding rows'
  // too.
  __nv_bfloat16* o_lo;
  float* lse;
  int H, G, Sq, Skv, n_q_tiles, causal;
  int q_off;             // the keys' row of q's row 0 (causal mask)
  float scale_log2;      // 1/sqrt(d) * log2(e)
};

template <int HD>
__device__ __forceinline__ void wgmma_pv(float (&o)[HD / 2],
                                         const uint32_t* a, uint64_t db) {
  if constexpr (HD == 16) wgmma_rs_n16(o, a, db, 1);
  if constexpr (HD == 32) wgmma_rs_n32(o, a, db, 1);
  if constexpr (HD == 48) wgmma_rs_n48(o, a, db, 1);
  if constexpr (HD == 64) wgmma_rs_n64(o, a, db, 1);
  if constexpr (HD == 80) wgmma_rs_n80(o, a, db, 1);
  if constexpr (HD == 96) wgmma_rs_n96(o, a, db, 1);
  if constexpr (HD == 112) wgmma_rs_n112(o, a, db, 1);
  if constexpr (HD == 128) wgmma_rs_n128(o, a, db, 1);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                                 const __grid_constant__ CUtensorMap tm_k,
                                 const __grid_constant__ CUtensorMap tm_v,
                                 const Params prm) {
  using G = Geom<HD>;
  extern __shared__ unsigned char smem_raw[];
  // 1024-byte alignment: the 128-byte swizzle repeats every 8 rows.
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t kv_s = q_s + G::kTileBytes;  // stage s: K, then V
  const uint32_t bars = kv_s + 2 * kStages * G::kTileBytes;
  auto full_bar = [&](int s) { return bars + 8 * s; };
  auto empty_bar = [&](int s) { return bars + 8 * (kStages + s); };
  const uint32_t q_bar = bars + 16 * kStages;

  const int bh = blockIdx.x;
  const int qt = prm.n_q_tiles - 1 - static_cast<int>(blockIdx.y);
  const int b = bh / prm.H, h = bh - b * prm.H, kvh = h / prm.G;
  const int q0 = qt * kBQ;
  const int n_kv = (prm.Skv + kBK - 1) / kBK;
  // the causal frontier of the tile's last real row, as a key row
  const int last_row = prm.q_off + min(q0 + kBQ, prm.Sq) - 1;
  const int n_tiles = prm.causal ? min(n_kv, last_row / kBK + 1) : n_kv;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_bar(s), 1);
      mbar_init(empty_bar(s), kConsumers);
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: one thread issues every load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 256) {
      mbar_expect_tx(q_bar, G::kTileBytes);
      for (int c = 0; c < G::kBoxes; ++c)
        tma_load(q_s + c * G::kBoxBytes, &tm_q, q_bar, c * G::kBoxCols, q0, h,
                 b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        if (t >= kStages) mbar_wait(empty_bar(s), ((t / kStages) - 1) & 1);
        const uint32_t k_s = kv_s + 2 * s * G::kTileBytes;
        const uint32_t v_s = k_s + G::kTileBytes;
        mbar_expect_tx(full_bar(s), 2 * G::kTileBytes);
        for (int c = 0; c < G::kBoxes; ++c) {
          tma_load(k_s + c * G::kBoxBytes, &tm_k, full_bar(s),
                   c * G::kBoxCols, t * kBK, kvh, b);
          tma_load(v_s + c * G::kBoxBytes, &tm_v, full_bar(s),
                   c * G::kBoxCols, t * kBK, kvh, b);
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int lane = threadIdx.x & 31;
    const int warp = (threadIdx.x / 32) & 3;
    const int row_lo = q0 + wg * 64;            // this warpgroup's first row
    const int r0 = row_lo + warp * 16 + lane / 4;  // rows r0 and r0 + 8
    const int key_lo = prm.q_off + row_lo;      // their rows as key rows
    const int key_r0 = prm.q_off + r0;
    const int cq = 2 * (lane & 3);              // column offset in an n8 block

    float o[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

    // K-major operands (Q, K): 8-row groups one swizzle span of rows apart.
    // V (MN-major): 8-key groups the same, spans of columns a box apart.
    constexpr uint32_t kGroup = 8 * G::kSwizzle;
    const uint32_t q_wg = q_s + wg * 64 * G::kSwizzle;

    mbar_wait(q_bar, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kStages;
      const int k0 = t * kBK;
      const uint32_t k_s = kv_s + 2 * s * G::kTileBytes;
      const uint32_t v_s = k_s + G::kTileBytes;
      mbar_wait(full_bar(s), (t / kStages) & 1);

      // S = Q K^T over d, 16 at a time
      float sc[64];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int box = kk * 16 / G::kBoxCols;
        const uint32_t off = box * G::kBoxBytes + (kk * 16 % G::kBoxCols) * 2;
        wgmma_ss_n128(sc, make_desc(q_wg + off, 16, kGroup, G::kLayout),
                      make_desc(k_s + off, 16, kGroup, G::kLayout), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(sc);

      // scale (log2 units) and mask: element 4j + 2i + c is row r0 + 8i,
      // key k0 + 8j + cq + c
      const bool edge = k0 + kBK > prm.Skv ||
                        (prm.causal && k0 + kBK - 1 > key_lo);
#pragma unroll
      for (int e = 0; e < 64; ++e) {
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
        for (int j = 0; j < 16; ++j)
          mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * i], sc[4 * j + 2 * i + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[i], mx);
        alpha[i] = exp2f(m[i] - m_new);
        m[i] = m_new;
      }
      // p, this thread's share of the row sums, and P as hi + lo A operands
      uint32_t p_hi[8][4], p_lo[8][4];
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int e = 8 * kk + 2 * r;  // i = r & 1
          const float p0 = exp2f(sc[e] - m[r & 1]);
          const float p1 = exp2f(sc[e + 1] - m[r & 1]);
          sum[r & 1] += p0 + p1;
          const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
          const float2 hf = __bfloat1622float2(hi);
          p_hi[kk][r] = pack_bf16(hi);
          p_lo[kk][r] = pack_bf16(__floats2bfloat162_rn(p0 - hf.x, p1 - hf.y));
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + sum[i];
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        o[4 * j] *= alpha[0];
        o[4 * j + 1] *= alpha[0];
        o[4 * j + 2] *= alpha[1];
        o[4 * j + 3] *= alpha[1];
      }

      // O += P_hi V + P_lo V, 16 keys at a time
      reg_fence(o);
      reg_fence(p_hi);
      reg_fence(p_lo);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const uint64_t dv = make_desc(v_s + kk * 16 * G::kSwizzle,
                                      G::kBoxBytes, kGroup, G::kLayout);
        wgmma_pv<HD>(o, p_hi[kk], dv);
        wgmma_pv<HD>(o, p_lo[kk], dv);
      }
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(o);
      reg_fence(p_hi);
      reg_fence(p_lo);
      mbar_arrive(empty_bar(s));
    }

    // epilogue: full row sums, the l == 0 guard, bf16 stores below Sq; for
    // the backward, the row's log-sum-exp and the output's low half
    // (16-byte stores of this thread's fragment, elements 4j + 2i and + 1
    // in word 2j + i)
    uint32_t lo[HD / 4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float li = l[i];
      li += __shfl_xor_sync(0xffffffffu, li, 1);
      li += __shfl_xor_sync(0xffffffffu, li, 2);
      const float inv = 1.f / (li == 0.f ? 1.f : li);
      const int row = r0 + 8 * i;
      if (prm.lse != nullptr && cq == 0)
        prm.lse[static_cast<long long>(bh) * prm.n_q_tiles * kBQ + row] =
            m[i] + log2f(li);
      const long long at = b * prm.ob + h * prm.oh +
                           static_cast<long long>(row) * prm.os + cq;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        const float x0 = o[4 * j + 2 * i] * inv;
        const float x1 = o[4 * j + 2 * i + 1] * inv;
        const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
        if (prm.o_lo != nullptr) {
          const __nv_bfloat162 rest = __floats2bfloat162_rn(
              x0 - __bfloat162float(hi.x), x1 - __bfloat162float(hi.y));
          lo[2 * j + i] = *reinterpret_cast<const uint32_t*>(&rest);
        }
        if (row < prm.Sq)
          *reinterpret_cast<__nv_bfloat162*>(prm.o + at + 8 * j) = hi;
      }
    }
    if (prm.o_lo != nullptr) {
      uint4* dst = reinterpret_cast<uint4*>(
          prm.o_lo + ((static_cast<long long>(bh) * prm.n_q_tiles + qt) *
                          kConsumers + threadIdx.x) * (HD / 2));
#pragma unroll
      for (int c = 0; c < HD / 16; ++c)
        dst[c] = make_uint4(lo[4 * c], lo[4 * c + 1], lo[4 * c + 2],
                            lo[4 * c + 3]);
    }
  }
}

// A 4-D map (d, S, heads, B) over a bf16 view; boxes of one swizzle span of
// columns by 128 rows. Returns 0 or the driver's CUresult.
template <int HD>
int make_map(CUtensorMap* map, EncodeTiled encode, const void* ptr, int S,
             int heads, int B, const long long* strides) {
  using G = Geom<HD>;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(HD),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(B)};
  // bytes between rows, heads and batches (strides[] are batch, head, row)
  const cuuint64_t gstrides[3] = {static_cast<cuuint64_t>(strides[2]) * 2,
                                  static_cast<cuuint64_t>(strides[1]) * 2,
                                  static_cast<cuuint64_t>(strides[0]) * 2};
  const cuuint32_t box[4] = {G::kBoxCols, 128, 1, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return static_cast<int>(encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      gstrides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
      G::kMapSwizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE));
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const Params& prm,
           int B, int KV, const long long* strides, cudaStream_t stream) {
  using G = Geom<HD>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kNoEncoder;
  CUtensorMap tm_q, tm_k, tm_v;
  int r = make_map<HD>(&tm_q, encode, q, prm.Sq, prm.H, B, strides);
  if (r == 0) r = make_map<HD>(&tm_k, encode, k, prm.Skv, KV, B, strides + 3);
  if (r == 0) r = make_map<HD>(&tm_v, encode, v, prm.Skv, KV, B, strides + 6);
  if (r != 0) return kEncodeFailed - r;
  auto kernel = flash_attention_wgmma_kernel<HD>;
  static unsigned long long set_on = 0;
  const cudaError_t e = allow_smem(kernel, G::kSmem, set_on);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<dim3(B * prm.H, prm.n_q_tiles), kThreads, G::kSmem, stream>>>(
      tm_q, tm_k, tm_v, prm);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// bf16 only; hd a multiple of 16 from 16 to 128. Pointers are device pointers, 16-byte
// aligned, with the strides (in elements) of the batch, head and sequence
// dims given in `strides` as q, k, v, o triples; the last dim is
// contiguous and every stride a multiple of 16 bytes below 2^40 bytes.
// q_off >= 0 is the keys' row of q's row 0 under the causal mask, q_off +
// Sq below 2^31. Grid: B*H blocks on x, ceil(Sq / 128) <= 65535 on y.
// Returns 0, a cudaError_t, or -1 (no tensor-map encoder in the driver) /
// -1000 - r (the encoder refused a map with CUresult r). Launches on
// `stream`, does not synchronise and allocates nothing.
// o_lo (bf16, [B * H, ceil(Sq / 128) * 128, hd] in fragment order, see
// Params) and lse (f32, [B * H, ceil(Sq / 128) * 128]) are what the backward
// kernels read; the forward alone (flash_attention_bf16_launch) passes
// neither.
int flash_attention_bf16_lse_launch(const void* q, const void* k,
                                    const void* v, void* o, void* o_lo,
                                    float* lse, int B, int H, int KV, int Sq,
                                    int Skv, int hd, int causal, int q_off,
                                    float scale, const long long* strides,
                                    cudaStream_t stream) {
  if (B < 1 || H < 1 || KV < 1 || H % KV || Sq < 1 || Skv < 1 || q_off < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params prm{static_cast<__nv_bfloat16*>(o), strides[9], strides[10],
                   strides[11], static_cast<__nv_bfloat16*>(o_lo), lse, H,
                   H / KV, Sq, Skv, (Sq + kBQ - 1) / kBQ, causal, q_off,
                   scale * 1.4426950408889634f};
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

// The forward alone: no low half, no log-sum-exp.
int flash_attention_bf16_launch(const void* q, const void* k, const void* v,
                                void* o, int B, int H, int KV, int Sq,
                                int Skv, int hd, int causal, int q_off,
                                float scale, const long long* strides,
                                cudaStream_t stream) {
  return flash_attention_bf16_lse_launch(q, k, v, o, nullptr, nullptr, B, H,
                                         KV, Sq, Skv, hd, causal, q_off,
                                         scale, strides, stream);
}

// Dynamic shared memory a block of the kernel takes at head dim hd, in
// bytes (0 for a head dim it does not take).
int flash_attention_bf16_smem_bytes(int hd) {
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

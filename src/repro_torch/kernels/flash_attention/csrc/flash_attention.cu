// Blocked online-softmax attention (the forward of flash attention) in f32
// on CUDA cores, for Hopper (sm_90a). bf16 calls go to the tensor-core
// kernel of flash_attention_wgmma.cu.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/flash_attention.py
// ::_flash_kernel (pallas_call at line 107). Same function: q [B, H, Sq, d]
// against k, v [B, KV, Skv, d], scores scaled by 1/sqrt(d) in f32, a top-left
// causal mask (row >= col) applied before the running max, keys at or past
// Skv masked, running max / denominator / accumulator in f32, fully masked
// rows giving 0 (the `l == 0 -> 1` guard), output in q's type. Two liberties,
// both the same function:
//   * GQA: query head h reads kv head h / G directly, so the caller does not
//     materialise the reference wrapper's repeated K/V (jnp.repeat).
//   * Layout: every tensor is addressed through its batch, head and sequence
//     strides (the last dim contiguous), so the model's [B, S, H, d]
//     activations are read and written in place, without the two transposes
//     the reference makes around its call.
// Nothing is padded: keys at or past Skv are masked (their rows are never
// loaded into the P.V sum) and query rows at or past Sq are never written.
// A query-row offset `q_off` (>= 0, any value) makes q's row r the keys'
// row q_off + r for the causal mask and the causal tile skip: a rank's
// slice of a sequence's rows keeps the whole sequence's diagonal.
//
// Bound on an H100 at the training shape (B=2, H=32, KV=8, S=4096, d=128,
// causal) in f32: operations. 2*B*H*S^2*d flops (QK and PV over the causal
// half, ~4.1 ms at 67 TFLOP/s outside the tensor cores) against ~336 MB of
// q, k, v and o read or written once (~0.1 ms at 3.35 TB/s).
//
// What the design does about that bound, in this first version:
//   * One block of 256 threads per (b*h, tile of BQ query rows). It loops
//     over KV tiles of BK rows up to the causal frontier (the reference's
//     tile skip) in place of the TPU's sequential grid axis. Blocks are
//     launched heaviest-first (last query tile first) to shorten the tail.
//   * The Q tile and a two-stage ring of K/V tiles sit in shared memory in
//     f32, copied with 16-byte cp.async, so the next tile's loads
//     fly while the current one is computed. Rows are padded by 16 bytes so
//     that the score phase's 16-byte row reads hit distinct banks.
//   * Scores, the online softmax and the accumulator never leave the block:
//     each thread owns RQ rows x CK keys of the score tile and RQ rows x d/16
//     columns of the accumulator in registers; the 16 lanes sharing a row
//     reduce its max and sum with 4 shuffles, and the probabilities go
//     through shared memory only within that half-warp.
//   * The products are f32 FMAs on CUDA cores, as the reference's f32 dots.
//   * Head dims 16 to 128 in steps of 16: a thread's d/16 accumulator
//     columns are read from V in 16-byte loads where d/16 is a multiple of
//     4 (d = 64, 128), one float at a time otherwise.
//
// Plain C interface, loaded with ctypes (repro_torch/kernels/_build.py).

#include <cuda_runtime.h>

#include "smem_limit.cuh"

namespace {

constexpr int kThreads = 256;  // 16 x 16: ty selects rows, tx keys/columns
// Query and key rows per tile, 16 x 4 each: every thread holds 4 rows x 4
// keys of the score tile. The TPU kernel's 128 would need more registers
// than a thread has for the accumulator at d = 128.
constexpr int kRQ = 4, kCK = 4;
constexpr int kBQ = 16 * kRQ;
constexpr float kNegInf = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int H, G, Sq, Skv, n_q_tiles, causal, q_off;
  float scale;
  // strides in elements: batch, head, sequence (the last dim is contiguous)
  long long qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os;
};

// 16 bytes of shared memory: 4 floats.
__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  out[0] = a.x;
  out[1] = a.y;
  out[2] = a.z;
  out[3] = a.w;
}
// N consecutive shared-memory floats; 16-byte loads where the run is a
// whole number of 16-byte chunks (the caller keeps it aligned).
template <int N>
__device__ __forceinline__ void load_n(const float* p, float* out) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int c = 0; c < N / 4; ++c) load16(p + c * 4, out + c * 4);
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e) out[e] = p[e];
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// Wait until at most one committed group (the newest) is still in flight.
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Max and sum over the 16 lanes of a half-warp (the lanes sharing ty).
__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Dynamic shared memory: Q [BQ][LD] and K/V [2 stages][2][BK][LD]
// (LD = d plus 16 bytes of padding), then P [BQ][BK + 16]. At most 189,440
// bytes (d = 128), within Hopper's 227 KB a block.
constexpr size_t smem_bytes(int hd, int bq, int bk) {
  return ((static_cast<size_t>(bq) + 4 * static_cast<size_t>(bk)) *
              (static_cast<size_t>(hd) + 4) +
          static_cast<size_t>(bq) * (bk + 16)) *
         sizeof(float);
}

template <int HD, int RQ, int CK>
__global__ void __launch_bounds__(kThreads, 2)
    flash_attention_kernel(const Params prm) {
  static_assert(HD % 16 == 0 && HD >= 16 && HD <= 128, "head dim");
  constexpr int BQ = 16 * RQ, BK = 16 * CK;
  constexpr int EPC = 4;  // floats per 16 bytes
  constexpr int LD = HD + EPC;
  constexpr int PLD = BK + 16;
  constexpr int CHUNKS = HD / EPC;  // 16-byte chunks per row
  constexpr int DPT = HD / 16;      // accumulator columns per thread

  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);
  float* kv_s = q_s + BQ * LD;
  float* p_s = kv_s + 4 * BK * LD;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int qt = prm.n_q_tiles - 1 - static_cast<int>(blockIdx.x);
  const int bh = blockIdx.y;
  const int b = bh / prm.H, h = bh - b * prm.H, kvh = h / prm.G;
  const int Sq = prm.Sq, Skv = prm.Skv;
  const int q0 = qt * BQ;
  const int q_rows = min(BQ, Sq - q0);

  const float* qg = static_cast<const float*>(prm.q) + b * prm.qb + h * prm.qh;
  const float* kg =
      static_cast<const float*>(prm.k) + b * prm.kb + kvh * prm.kh;
  const float* vg =
      static_cast<const float*>(prm.v) + b * prm.vb + kvh * prm.vh;
  float* og = static_cast<float*>(prm.o) + b * prm.ob + h * prm.oh;

  // KV tiles up to the causal frontier of the last real row of this tile
  // (its key row: q_off further on).
  const int n_kv = (Skv + BK - 1) / BK;
  const int n_tiles =
      prm.causal ? min(n_kv, (prm.q_off + q0 + q_rows - 1) / BK + 1) : n_kv;

  // Q tile; rows past Sq are zero-filled so no stale bits enter a sum.
  for (int i = tid; i < BQ * CHUNKS; i += kThreads) {
    const int r = i / CHUNKS, c = i - r * CHUNKS;
    float* dst = q_s + r * LD + c * EPC;
    if (r < q_rows)
      cp_async16(dst, qg + static_cast<long long>(q0 + r) * prm.qs + c * EPC);
    else
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
  }

  auto load_tile = [&](int t, int stage) {
    const int k0 = t * BK;
    const int rows = min(BK, Skv - k0);
    float* ks = kv_s + stage * 2 * BK * LD;
    float* vs = ks + BK * LD;
    for (int i = tid; i < rows * CHUNKS; i += kThreads) {
      const int r = i / CHUNKS, c = i - r * CHUNKS;
      cp_async16(ks + r * LD + c * EPC,
                 kg + static_cast<long long>(k0 + r) * prm.ks + c * EPC);
      cp_async16(vs + r * LD + c * EPC,
                 vg + static_cast<long long>(k0 + r) * prm.vs + c * EPC);
    }
  };

  float acc[RQ][DPT];
  float m[RQ], l[RQ];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < DPT; ++e) acc[i][e] = 0.f;
  }

  if (n_tiles > 0) load_tile(0, 0);
  cp_async_commit();  // with the Q tile

  for (int t = 0; t < n_tiles; ++t) {
    const int stage = t & 1;
    // The other stage was last read by tile t - 1, which ended in a barrier.
    if (t + 1 < n_tiles) load_tile(t + 1, stage ^ 1);
    cp_async_commit();  // possibly empty, so "all but one" means "tile t"
    cp_async_wait_one();
    __syncthreads();

    const float* ks = kv_s + stage * 2 * BK * LD;
    const float* vs = ks + BK * LD;
    const int k0 = t * BK;

    // 1. Scores: row ty + 16 i against key tx + 16 j, f32 FMAs over d.
    float s[RQ][CK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < CK; ++j) s[i][j] = 0.f;
#pragma unroll 2
    for (int d0 = 0; d0 < HD; d0 += 8) {
      float kf[CK][8];
#pragma unroll
      for (int j = 0; j < CK; ++j)
        load_n<8>(ks + (tx + 16 * j) * LD + d0, kf[j]);
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        float qf[8];
        load_n<8>(q_s + (ty + 16 * i) * LD + d0, qf);
#pragma unroll
        for (int j = 0; j < CK; ++j)
#pragma unroll
          for (int e = 0; e < 8; ++e) s[i][j] = fmaf(qf[e], kf[j][e], s[i][j]);
      }
    }

    // 2. Scale, mask (before the max), online-softmax update.
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int row = prm.q_off + q0 + ty + 16 * i;  // the keys' row
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool ok = col < Skv && (!prm.causal || row >= col);
        s[i][j] = ok ? s[i][j] * prm.scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
        p_s[(ty + 16 * i) * PLD + tx + 16 * j] = s[i][j];
      }
      l[i] = l[i] * alpha + half_warp_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < DPT; ++e) acc[i][e] *= alpha;
    }
    __syncwarp();  // a row's probabilities come from its own half-warp

    // 3. acc += P . V over this tile's real keys.
    const int rows = min(BK, Skv - k0);
    for (int c = 0; c < rows; ++c) {
      float vf[DPT];
      load_n<DPT>(vs + c * LD + tx * DPT, vf);
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        const float p = p_s[(ty + 16 * i) * PLD + c];
#pragma unroll
        for (int e = 0; e < DPT; ++e) acc[i][e] = fmaf(p, vf[e], acc[i][e]);
      }
    }
    __syncthreads();  // the stage and P are rewritten by the next tile
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row < Sq) {
      const float li = l[i] == 0.f ? 1.f : l[i];  // fully masked rows -> 0
      float* dst = og + static_cast<long long>(row) * prm.os + tx * DPT;
#pragma unroll
      for (int e = 0; e < DPT; ++e) dst[e] = acc[i][e] / li;
    }
  }
}

template <int HD>
int launch(const Params& prm, int BH, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes(HD, 16 * kRQ, 16 * kCK);
  auto kernel = flash_attention_kernel<HD, kRQ, kCK>;
  static unsigned long long set_on = 0;
  if (smem > 48 * 1024) {
    const cudaError_t e = allow_smem(kernel, smem, set_on);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<dim3(prm.n_q_tiles, BH), kThreads, smem, stream>>>(prm);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// f32 only; hd a multiple of 16 from 16 to 128; q_off >= 0 the keys' row of
// q's row 0 under the causal mask, q_off + Sq below 2^31.
// Pointers are device pointers, 16-byte aligned, with the strides (in
// elements) of the batch, head and sequence dims given in `strides` as
// q, k, v, o triples; the last dim is contiguous and every stride a multiple
// of 16 bytes. Returns the cudaError_t of the launch (0 on success).
// Launches on `stream`, does not synchronise and allocates nothing.
int flash_attention_f32_launch(const void* q, const void* k, const void* v,
                               void* o, int B, int H, int KV, int Sq, int Skv,
                               int hd, int causal, int q_off,
                               float scale, const long long* strides,
                               cudaStream_t stream) {
  if (B < 1 || H < 1 || KV < 1 || H % KV || Sq < 1 || Skv < 1 || q_off < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params prm{q, k, v, o, H, H / KV, Sq, Skv, (Sq + kBQ - 1) / kBQ, causal,
             q_off, scale, strides[0], strides[1], strides[2], strides[3],
             strides[4], strides[5], strides[6], strides[7], strides[8],
             strides[9], strides[10], strides[11]};
  switch (hd) {
    case 16: return launch<16>(prm, B * H, stream);
    case 32: return launch<32>(prm, B * H, stream);
    case 48: return launch<48>(prm, B * H, stream);
    case 64: return launch<64>(prm, B * H, stream);
    case 80: return launch<80>(prm, B * H, stream);
    case 96: return launch<96>(prm, B * H, stream);
    case 112: return launch<112>(prm, B * H, stream);
    case 128: return launch<128>(prm, B * H, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"

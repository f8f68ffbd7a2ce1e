// One-token GQA decode attention over a KV cache, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_decode/flash_decode.py
// ::_decode_kernel (pallas_call at line 90). Same function: q [B, KV, G, hd]
// against k/v [B, KV, T, hd]; cache slots t >= lengths[b] are masked; the
// online-softmax state is f32; the output is [B, KV, G, hd] in q's type.
//
// Bound on an H100: memory. Every cached element feeds 4 * G flops (QK and
// PV), far below the card's ~295 flops per byte ridge, so the least time is
// the K and V rows below each sequence's length read once:
//     2 * KV * hd * sum_b min(lengths[b], T) * sizeof(dtype) bytes
// (2 * B * KV * T * hd * sizeof(dtype) at full length) over 3.35 TB/s.
//
// What the design does about that bound:
//   * Rows at or past a sequence's length are never read.
//   * One thread block per (b, kv) pair sweeps that pair's cache once, in
//     tiles of bk rows, with a loop in place of the TPU's sequential grid
//     axis. K and V tiles are copied global -> shared with 16-byte cp.async
//     in a two-stage ring, so the next tile's loads are in flight while the
//     current tile is computed.
//   * The G query rows of the kv head stay in shared memory (f32) for the
//     whole sweep, so K and V are read once for all G heads of the group.
//   * Scores never leave the block: running max, sum and accumulator stay in
//     shared memory in f32.
//
// Known limit: the grid has only B * KV blocks. At B = 4 and KV = 8 that is
// 32 blocks for the card's 132 SMs, so most of its bandwidth sits unused.
// Splitting T across blocks (flash-decoding), TMA and wgmma are later work.
//
// Plain C interface, loaded with ctypes (repro_torch/kernels/_build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
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

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Dynamic shared memory: [2 stages][K, V][bk][hd] in the input type, then f32
// q [G][hd], acc [G][hd], p [G][bk], m [G], l [G], alpha [G].
size_t smem_bytes(int elem_size, int G, int hd, int bk) {
  return 4 * static_cast<size_t>(bk) * hd * elem_size +
         (2 * static_cast<size_t>(G) * hd + static_cast<size_t>(G) * bk +
          3 * static_cast<size_t>(G)) * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int* __restrict__ lengths, T* __restrict__ out,
                        int KV, int G, int T_len, int hd, int bk,
                        float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int bh = blockIdx.x;  // b * KV + kv
  const int b = bh / KV;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const size_t tile_elems = static_cast<size_t>(bk) * hd;
  T* kv_s = reinterpret_cast<T*>(smem);
  float* q_s = reinterpret_cast<float*>(smem + 4 * tile_elems * sizeof(T));
  float* acc_s = q_s + G * hd;
  float* p_s = acc_s + G * hd;
  float* m_s = p_s + G * bk;
  float* l_s = m_s + G;
  float* a_s = l_s + G;

  const int len = min(lengths[b], T_len);
  const int n_tiles = len > 0 ? (len + bk - 1) / bk : 0;
  const T* k_bh = k + static_cast<size_t>(bh) * T_len * hd;
  const T* v_bh = v + static_cast<size_t>(bh) * T_len * hd;
  const int row_chunks = hd * static_cast<int>(sizeof(T)) / 16;

  for (int i = tid; i < G * hd; i += kThreads) {
    q_s[i] = to_f32(q[static_cast<size_t>(bh) * G * hd + i]);
    acc_s[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }

  // Rows [t0, t0 + rows) of one (b, kv) pair are one contiguous byte range,
  // laid out in shared memory as they are in the cache.
  auto load_tile = [&](int tile, int stage) {
    const int t0 = tile * bk;
    const int n = min(bk, len - t0) * row_chunks;
    char* ks = reinterpret_cast<char*>(kv_s + stage * 2 * tile_elems);
    char* vs = ks + tile_elems * sizeof(T);
    const char* kg = reinterpret_cast<const char*>(k_bh + static_cast<size_t>(t0) * hd);
    const char* vg = reinterpret_cast<const char*>(v_bh + static_cast<size_t>(t0) * hd);
    for (int i = tid; i < n; i += kThreads) {
      cp_async16(ks + 16 * static_cast<size_t>(i), kg + 16 * static_cast<size_t>(i));
      cp_async16(vs + 16 * static_cast<size_t>(i), vg + 16 * static_cast<size_t>(i));
    }
  };

  if (n_tiles > 0) load_tile(0, 0);
  cp_async_commit();
  __syncthreads();

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int stage = tile & 1;
    // The other stage was last read by tile - 1, which ended in a barrier.
    if (tile + 1 < n_tiles) load_tile(tile + 1, stage ^ 1);
    cp_async_commit();  // possibly empty, so that "all but one" means "this tile"
    cp_async_wait_one();
    __syncthreads();

    const T* ks = kv_s + stage * 2 * tile_elems;
    const T* vs = ks + tile_elems;
    const int rows = min(bk, len - tile * bk);

    // 1. Scores, one warp per key row, lanes across hd.
    for (int j = warp; j < rows; j += kWarps) {
      const T* kr = ks + static_cast<size_t>(j) * hd;
      for (int g = 0; g < G; ++g) {
        const float* qg = q_s + g * hd;
        float s = 0.f;
        for (int d = lane; d < hd; d += 32) s += qg[d] * to_f32(kr[d]);
        s = warp_sum(s);
        if (lane == 0) p_s[g * bk + j] = s * scale;
      }
    }
    __syncthreads();

    // 2. Online-softmax update, one warp per query row: p <- exp(s - m_new).
    for (int g = warp; g < G; g += kWarps) {
      float* pg = p_s + g * bk;
      float mx = kNegInf;
      for (int j = lane; j < rows; j += 32) mx = fmaxf(mx, pg[j]);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, warp_max(mx));
      float sum = 0.f;
      for (int j = lane; j < rows; j += 32) {
        const float e = expf(pg[j] - m_new);
        pg[j] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // 3. acc <- acc * alpha + p @ V; each thread owns fixed (g, d) entries.
    for (int i = tid; i < G * hd; i += kThreads) {
      const int g = i / hd, d = i - g * hd;
      const float* pg = p_s + g * bk;
      float a = acc_s[i] * a_s[g];
      for (int j = 0; j < rows; ++j)
        a += pg[j] * to_f32(vs[static_cast<size_t>(j) * hd + d]);
      acc_s[i] = a;
    }
    __syncthreads();
  }

  for (int i = tid; i < G * hd; i += kThreads) {
    const float l = l_s[i / hd];
    store(out + static_cast<size_t>(bh) * G * hd + i,
          acc_s[i] / (l == 0.f ? 1.f : l));
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* lengths,
           void* out, int B, int KV, int G, int T_len, int hd, int bk,
           float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(sizeof(T), G, hd, bk);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  flash_decode_kernel<T><<<B * KV, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, static_cast<T*>(out), KV, G, T_len,
      hd, bk, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Shared memory one block needs; the wrapper checks it against the card.
long long flash_decode_smem_bytes(int elem_size, int G, int hd, int bk) {
  return static_cast<long long>(smem_bytes(elem_size, G, hd, bk));
}

// dtype: 0 = float32, 1 = bfloat16. Pointers are device pointers of
// contiguous tensors, 16-byte aligned; hd is a multiple of 8. Returns the
// cudaError_t of the launch (0 on success). Launches on `stream`, does not
// synchronise and allocates nothing.
int flash_decode_launch(int dtype, const void* q, const void* k,
                        const void* v, const int* lengths, void* out, int B,
                        int KV, int G, int T_len, int hd, int bk, float scale,
                        cudaStream_t stream) {
  if (dtype == 0)
    return launch<float>(q, k, v, lengths, out, B, KV, G, T_len, hd, bk,
                         scale, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, lengths, out, B, KV, G, T_len, hd,
                                 bk, scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"

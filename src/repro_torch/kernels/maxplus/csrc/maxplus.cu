// Max-plus (tropical) matrix product for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/maxplus/maxplus.py
// ::_maxplus_kernel (pallas_call at line 69). Same function, f32:
//     C[i, j] = max(NEG_INF, max_k (A[i, k] + B[k, j])),   NEG_INF = -1e9,
// the TPU kernel's output tile starting at NEG_INF being its floor. NaN
// propagates, as jnp.maximum and torch.maximum propagate it.
//
// Bound on an H100: operations. Each (i, j, k) costs one FADD and one
// FMNMX; (max, +) has no tensor-core path and sm_90 has no fused add-max.
// An SM issues at most 128 thread-instructions a clock (4 schedulers x 32
// lanes), and FMNMX runs at 64 results a clock on compute capability 9.0
// (CUDA C++ Programming Guide, arithmetic instruction throughput), so the
// least time is M * N * K / (64 * 132 SMs * clock) either way: 4.1 ms for
// n = 4096 at 1.98 GHz, 0.0116 ms for n = 579. Bytes (A, B read once, C
// written once) are far below that at every n the compiler produces.
//
// What the design does about that bound:
//   * The card has to be full before any of that rate is reached, and the
//     compile's closures are small (n = 69-579): one 128 x 128 tile a block
//     gave 25 blocks for 132 SMs at n = 579. So the wrapper picks the tile
//     by size: 128 x 128 (256 threads of 8 x 8) once those tiles alone give
//     every SM a block, else 64 x 64 (256 threads of 4 x 4), and below that
//     it splits K over gridDim.z. Each split writes its partial maxima to a
//     workspace and a second kernel takes their max. (max, +) is exact and
//     order-free, so the split result equals the unsplit one bit for bit,
//     NaN included; each split keeps the NEG_INF floor, which max leaves as
//     it is.
//   * Every shared-memory operand feeds TM (or TN) add/max pairs from a
//     thread's register micro-tile of running maxima.
//   * A K loop inside the block (the TPU's sequential grid axis) stages
//     16-deep slices of A (transposed, k-major, padded against bank
//     conflicts) and B in shared memory, double-buffered with 4-byte
//     cp.async so the next slice is in flight while this one is reduced.
//   * A thread's rows and columns are groups of 4, 64 apart, so its float4
//     shared-memory reads are contiguous across the warp.
//   * Ragged M / N / K edges are masked in the kernel, not padded by the
//     wrapper: an out-of-range element is staged as NEG_INF, so a masked k
//     adds at most -2e9, under the floor, exactly as the TPU kernel's
//     NEG_INF padding does.
//   * The running max is PTX max.NaN.f32 (one FMNMX.NAN), not fmaxf, which
//     returns the other operand when one is NaN.
//
// Plain C interface, loaded with ctypes (repro_torch/kernels/_build.py).

#include <cuda_runtime.h>

namespace {

constexpr int kBK = 16;
constexpr int kThreads = 256;  // 16 x 16
constexpr int kPadA = 4;       // keeps float4 alignment, 2-way store conflicts
constexpr float kNegInf = -1e9f;

__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// Wait until at most one committed group (the newest) is still in flight.
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// One BM x BN output tile over the K range [z * kc, (z + 1) * kc) of split
// z = blockIdx.z, written to C + z * M * N. A thread's TM x TN micro-tile is
// (TM / 4) x (TN / 4) groups of 4 x 4, the groups 64 rows (columns) apart.
template <int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__(kThreads)
    maxplus_kernel(const float* __restrict__ A, const float* __restrict__ B,
                   float* __restrict__ C, int M, int N, int K, int kc) {
  static_assert(BM / TM == 16 && BN / TN == 16, "16 x 16 threads");
  constexpr int GM = TM / 4, GN = TN / 4;    // groups of 4 a thread
  constexpr int SM = BM / GM, SN = BN / GN;  // their spacing: 64
  __shared__ __align__(16) float As[2][kBK][BM + kPadA];  // As[k][m]
  __shared__ __align__(16) float Bs[2][kBK][BN];          // Bs[k][n]

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int kb = blockIdx.z * kc, ke = min(K, kb + kc);
  float* Cz = C + static_cast<size_t>(blockIdx.z) * M * N;

  auto load = [&](int kt, int s) {
    const int k0 = kb + kt * kBK;
    // A: consecutive threads walk along a row of A (coalesced reads) and
    // store it transposed.
    for (int e = tid; e < BM * kBK; e += kThreads) {
      const int kk = e % kBK, mm = e / kBK;
      const int gm = m0 + mm, gk = k0 + kk;
      float* dst = &As[s][kk][mm];
      if (gm < M && gk < ke)
        cp_async4(dst, A + static_cast<size_t>(gm) * K + gk);
      else
        *dst = kNegInf;
    }
    for (int e = tid; e < kBK * BN; e += kThreads) {
      const int nn = e % BN, kk = e / BN;
      const int gk = k0 + kk, gn = n0 + nn;
      float* dst = &Bs[s][kk][nn];
      if (gk < ke && gn < N)
        cp_async4(dst, B + static_cast<size_t>(gk) * N + gn);
      else
        *dst = kNegInf;
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = kNegInf;

  const int n_k = (ke - kb + kBK - 1) / kBK;
  load(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < n_k; ++kt) {
    const int s = kt & 1;
    // The other stage was last read by slice kt - 1, which ended in a barrier.
    if (kt + 1 < n_k) load(kt + 1, s ^ 1);
    cp_async_commit();  // possibly empty, so that "all but one" means "this slice"
    cp_async_wait_one();
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      float a[TM], b[TN];
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        const float4 x =
            *reinterpret_cast<const float4*>(&As[s][k][g * SM + ty * 4]);
        a[4 * g] = x.x, a[4 * g + 1] = x.y, a[4 * g + 2] = x.z,
        a[4 * g + 3] = x.w;
      }
#pragma unroll
      for (int g = 0; g < GN; ++g) {
        const float4 x =
            *reinterpret_cast<const float4*>(&Bs[s][k][g * SN + tx * 4]);
        b[4 * g] = x.x, b[4 * g + 1] = x.y, b[4 * g + 2] = x.z,
        b[4 * g + 3] = x.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          acc[i][j] = max_nan(acc[i][j], a[i] + b[j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = m0 + (i / 4) * SM + ty * 4 + i % 4;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = n0 + (j / 4) * SN + tx * 4 + j % 4;
      if (col < N) Cz[static_cast<size_t>(row) * N + col] = acc[i][j];
    }
  }
}

// C[i] = max over the splits s of W[s, i]: the second pass of a K split.
__global__ void __launch_bounds__(kThreads)
    maxplus_reduce_kernel(const float* __restrict__ W, float* __restrict__ C,
                          long long mn, int splits) {
  const long long step = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < mn; i += step) {
    float x = W[i];
    for (int s = 1; s < splits; ++s) x = max_nan(x, W[s * mn + i]);
    C[i] = x;
  }
}

template <int BM, int TM>
int launch_tiles(const float* A, const float* B, float* C, int M, int N,
                 int K, int kc, int splits, cudaStream_t stream) {
  const dim3 grid((N + BM - 1) / BM, (M + BM - 1) / BM, splits);
  if (grid.y > 65535u || grid.z > 65535u)
    return static_cast<int>(cudaErrorInvalidValue);
  maxplus_kernel<BM, BM, TM, TM><<<grid, kThreads, 0, stream>>>(A, B, C, M, N,
                                                                K, kc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// A [M, K], B [K, N], C [M, N]: device pointers of contiguous float32
// tensors, M, N, K >= 1. `tile` is 128 or 64 (a block's BM = BN); K is cut
// into splits of `k_chunk` (a multiple of 16) rows: with one split (k_chunk
// >= K) the kernel writes C; with more it writes W [splits, M, N] and a
// second kernel reduces W into C. Returns the cudaError_t of the launches
// (0 on success). Launches on `stream`, does not synchronise, allocates
// nothing.
int maxplus_launch(const float* A, const float* B, float* C, float* W, int M,
                   int N, int K, int tile, int k_chunk, cudaStream_t stream) {
  if (M < 1 || N < 1 || K < 1 || k_chunk < 1 || k_chunk % kBK)
    return static_cast<int>(cudaErrorInvalidValue);
  const int splits = (K + k_chunk - 1) / k_chunk;
  if (splits > 1 && W == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  float* out = splits > 1 ? W : C;
  int err;
  if (tile == 128)
    err = launch_tiles<128, 8>(A, B, out, M, N, K, k_chunk, splits, stream);
  else if (tile == 64)
    err = launch_tiles<64, 4>(A, B, out, M, N, K, k_chunk, splits, stream);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  if (err != 0 || splits == 1) return err;
  const long long mn = static_cast<long long>(M) * N;
  const long long blocks = (mn + kThreads - 1) / kThreads;
  maxplus_reduce_kernel<<<static_cast<unsigned>(blocks < 4096 ? blocks
                                                              : 4096),
                          kThreads, 0, stream>>>(W, C, mn, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

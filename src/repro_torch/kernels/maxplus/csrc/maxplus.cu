// Max-plus (tropical) matrix product for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/maxplus/maxplus.py
// ::_maxplus_kernel (pallas_call at line 69). Same function, f32:
//     C[i, j] = max(NEG_INF, max_k (A[i, k] + B[k, j])),   NEG_INF = -1e9,
// the TPU kernel's output tile starting at NEG_INF being its floor.
//
// Bound on an H100: operations. Each (i, j, k) costs one FADD and one
// FMNMX; (max, +) has no tensor-core path and sm_90 has no fused add-max.
// An SM issues at most 128 thread-instructions a clock (4 schedulers x 32
// lanes), and FMNMX runs at 64 results a clock on compute capability 9.0
// (CUDA C++ Programming Guide, arithmetic instruction throughput), so the
// least time is M * N * K / (64 * 132 SMs * clock) either way: 4.1 ms for
// n = 4096 at 1.98 GHz. Bytes (A, B read once, C written once) are far
// below that at every n the compiler produces.
//
// What the design does about that bound:
//   * Each block owns a 128 x 128 output tile; 256 threads each keep an
//     8 x 8 register micro-tile of running maxima, so every shared-memory
//     operand feeds 8 add/max pairs.
//   * A K loop inside the block (the TPU's sequential grid axis) stages
//     16-deep slices of A (transposed, k-major, padded against bank
//     conflicts) and B in shared memory, double-buffered with 4-byte
//     cp.async so the next slice is in flight while this one is reduced.
//   * A thread's rows and columns are two groups of 4, 64 apart, so its
//     float4 shared-memory reads are contiguous across the warp.
//   * Ragged M / N / K edges are masked in the kernel, not padded by the
//     wrapper: an out-of-range element is staged as NEG_INF, so a masked k
//     adds at most -2e9, under the floor, exactly as the TPU kernel's
//     NEG_INF padding does. Adds and max are exact and order-free, so the
//     result equals the plain version bit for bit (fmaxf drops NaN where
//     torch.max keeps it; timing matrices hold none).
//
// Plain C interface, loaded with ctypes (repro_torch/kernels/_build.py).

#include <cuda_runtime.h>

namespace {

constexpr int kBM = 128, kBN = 128, kBK = 16;
constexpr int kThreads = 256;
constexpr int kPadA = 4;  // keeps float4 alignment, 2-way store conflicts
constexpr float kNegInf = -1e9f;

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

__global__ void __launch_bounds__(kThreads)
    maxplus_kernel(const float* __restrict__ A, const float* __restrict__ B,
                   float* __restrict__ C, int M, int N, int K) {
  __shared__ __align__(16) float As[2][kBK][kBM + kPadA];  // As[k][m]
  __shared__ __align__(16) float Bs[2][kBK][kBN];          // Bs[k][n]

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;

  auto load = [&](int kt, int s) {
    const int k0 = kt * kBK;
    // A: consecutive threads walk along a row of A (coalesced reads) and
    // store it transposed.
    for (int e = tid; e < kBM * kBK; e += kThreads) {
      const int kk = e % kBK, mm = e / kBK;
      const int gm = m0 + mm, gk = k0 + kk;
      float* dst = &As[s][kk][mm];
      if (gm < M && gk < K)
        cp_async4(dst, A + static_cast<size_t>(gm) * K + gk);
      else
        *dst = kNegInf;
    }
    for (int e = tid; e < kBK * kBN; e += kThreads) {
      const int nn = e % kBN, kk = e / kBN;
      const int gk = k0 + kk, gn = n0 + nn;
      float* dst = &Bs[s][kk][nn];
      if (gk < K && gn < N)
        cp_async4(dst, B + static_cast<size_t>(gk) * N + gn);
      else
        *dst = kNegInf;
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = kNegInf;

  const int n_k = (K + kBK - 1) / kBK;
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
      const float4 a0 = *reinterpret_cast<const float4*>(&As[s][k][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[s][k][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[s][k][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Bs[s][k][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaxf(acc[i][j], a[i] + b[j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (col < N) C[static_cast<size_t>(row) * N + col] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" {

// A [M, K], B [K, N], C [M, N]: device pointers of contiguous float32
// tensors, M, N, K >= 1. Returns the cudaError_t of the launch (0 on
// success). Launches on `stream`, does not synchronise, allocates nothing.
int maxplus_launch(const float* A, const float* B, float* C, int M, int N,
                   int K, cudaStream_t stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  if (grid.y > 65535u) return static_cast<int>(cudaErrorInvalidValue);
  maxplus_kernel<<<grid, kThreads, 0, stream>>>(A, B, C, M, N, K);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

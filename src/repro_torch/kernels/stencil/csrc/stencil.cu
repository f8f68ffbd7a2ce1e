// Same-padded 3x3 correlation of an f32 image, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/stencil/stencil.py
// ::_stencil_kernel (pallas_call at line 52). Same function: x [H, W] with a
// zero halo, out[r, c] = sum over (dy, dx) in row-major order of
// w[dy, dx] * x[r + dy - 1, c + dx - 1], summed in f32.
//
// Bound on an H100: bytes. Nine multiply-adds a pixel against 8 bytes a
// pixel (x read once, out written once) is about 2 flops a byte, far under
// the card's ridge, so the least time is 2 * H * W * 4 bytes over 3.35
// TB/s: 0.073 ms for the gaussian app's 4800 x 6400 frame.
//
// What the design does about that bound:
//   * Each block stages one (32 + 2) x (32 + 2) patch of x, halo included,
//     in shared memory, with zeros outside the image, so every input pixel
//     is read from device memory about once (the halo rows and columns are
//     shared with neighbouring blocks through L2). The TPU kernel's three
//     row-shifted copies of the padded image are not needed, nor is any
//     padding copy: edges are masked in the kernel.
//   * 256 threads, 32 across a row, so each warp reads and writes 128
//     contiguous bytes; each thread computes 4 rows of one column.
//   * The nine weights are launch arguments, held in registers.
//   * Products and sums are rounded one by one (__fmul_rn, __fadd_rn) in
//     the reference's (dy, dx) order, starting from 0: the plain version's
//     arithmetic, without the FMA contraction nvcc would otherwise apply.
//
// Plain C interface, loaded with ctypes (repro_torch/kernels/_build.py).

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;        // output tile is kTile x kTile
constexpr int kRowsPerThread = 4;
constexpr int kThreadsY = kTile / kRowsPerThread;
constexpr int kHalo = kTile + 2;

struct Weights {
  float w[9];
};

__global__ void __launch_bounds__(kTile* kThreadsY)
    stencil3x3_kernel(const float* __restrict__ x, float* __restrict__ out,
                      int H, int W, Weights wt) {
  __shared__ float patch[kHalo][kHalo + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kTile + tx;
  const int c0 = blockIdx.x * kTile, r0 = blockIdx.y * kTile;

  for (int i = tid; i < kHalo * kHalo; i += kTile * kThreadsY) {
    const int r = i / kHalo, c = i % kHalo;
    const int gr = r0 + r - 1, gc = c0 + c - 1;
    patch[r][c] = (gr >= 0 && gr < H && gc >= 0 && gc < W)
                      ? __ldg(x + static_cast<size_t>(gr) * W + gc)
                      : 0.f;
  }
  __syncthreads();

  const int gc = c0 + tx;
  if (gc >= W) return;
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) {
    const int r = ty + j * kThreadsY;
    const int gr = r0 + r;
    if (gr >= H) break;
    float acc = 0.f;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
        acc = __fadd_rn(acc,
                        __fmul_rn(wt.w[dy * 3 + dx], patch[r + dy][tx + dx]));
    out[static_cast<size_t>(gr) * W + gc] = acc;
  }
}

}  // namespace

extern "C" {

// x, out: device pointers of contiguous float32 [H, W] tensors, H, W >= 1;
// w: the nine weights, row-major, in host memory. Returns the cudaError_t of
// the launch (0 on success). Launches on `stream`, does not synchronise,
// allocates nothing.
int stencil3x3_launch(const float* x, float* out, int H, int W,
                      const float* w, cudaStream_t stream) {
  Weights wt;
  for (int i = 0; i < 9; ++i) wt.w[i] = w[i];
  const dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile);
  if (grid.y > 65535u) return static_cast<int>(cudaErrorInvalidValue);
  stencil3x3_kernel<<<grid, dim3(kTile, kThreadsY), 0, stream>>>(x, out, H,
                                                                   W, wt);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

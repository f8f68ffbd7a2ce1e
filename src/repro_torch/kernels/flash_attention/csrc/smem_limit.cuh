// Host helper shared by the two flash_attention kernels.

#pragma once

#include <cuda_runtime.h>

// Raises `kernel`'s dynamic shared-memory limit to `bytes` once on each
// device (the attribute is per device; `set_on` holds one bit a device, and
// a device past the 64th is set on every call), so a later launch, also
// inside a CUDA graph capture, makes no runtime call but cudaGetDevice and
// the launch itself.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes,
                       unsigned long long& set_on) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (set_on & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(bytes));
  if (e == cudaSuccess) set_on |= bit;
  return e;
}

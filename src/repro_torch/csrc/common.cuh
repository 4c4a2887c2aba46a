// Shared helpers for the port's kernels: every library built from one
// csrc/*.cu file exports plain C launchers that take device pointers and a
// cudaStream_t as void*, launch on that stream, and return
// cudaGetLastError() so the Python wrapper can raise on a refused launch.
#pragma once

#include <cuda_runtime.h>

#define REPRO_EXPORT extern "C" __attribute__((visibility("default")))

// Each library exports `<prefix>_error_string` so a wrapper can name the
// error its launcher returned.
#define REPRO_DEFINE_ERROR_STRING(prefix)                          \
  REPRO_EXPORT const char* prefix##_error_string(int code) {       \
    return cudaGetErrorString(static_cast<cudaError_t>(code));     \
  }

#include <atomic>

namespace repro_torch {

// Above 48 KB a block's dynamic shared memory must be opted into per
// kernel; below it the attribute call is skipped.
template <class Kernel>
inline cudaError_t allow_dynamic_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// The same opt-in, made once per kernel and device for the most dynamic
// shared memory that kernel ever asks for, instead of once per launch.
template <auto kKernel>
inline cudaError_t allow_dynamic_smem_once(size_t max_bytes) {
  static std::atomic<unsigned long long> done{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = allow_dynamic_smem(kKernel, max_bytes);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

}  // namespace repro_torch

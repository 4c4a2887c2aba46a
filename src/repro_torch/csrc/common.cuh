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

// cp.async: a copy from device memory into shared memory that runs while
// the thread goes on (16 bytes on the vector path, else 4), gathered into
// groups by commit() and waited for by wait<N>() (all but the newest N
// groups complete).
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

template <bool kVec>
__device__ __forceinline__ void copy(float* dst, const float* src) {
  if constexpr (kVec) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src));
  }
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

}  // namespace repro_torch

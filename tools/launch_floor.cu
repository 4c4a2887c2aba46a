// The launch floor: an empty kernel behind the same plain C interface as
// K1's launcher (src/repro_torch/csrc/hash_mm.cu, hash_mm_launch) and
// launched the same way as K1 and K4 (csrc/small_gemm.cuh: one
// cudaLaunchKernelEx with programmatic stream serialization, the kernel
// waiting on griddepcontrol and then releasing the next one), so that
// chip_smoke.py can time what the ctypes route and one launch cost before
// a kernel does any work.  It reads and writes nothing; one block of one
// warp.  Built by chip_smoke.py beside the port's kernels, with the same
// nvcc flags; no path of the port calls it.
#include "common.cuh"

namespace {

__global__ void empty_kernel() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;\n" ::);
}

}  // namespace

REPRO_DEFINE_ERROR_STRING(launch_floor)

REPRO_EXPORT int launch_floor_launch(const float*, const float*,
                                     const float*, float, int, int, int,
                                     int, int, int*, float*, void* stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1);
  cfg.blockDim = dim3(32);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, empty_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The same call with no launch: the ctypes route alone.
REPRO_EXPORT int launch_floor_call(const float*, const float*, const float*,
                                   float, int, int, int, int, int, int*,
                                   float*, void*) {
  return 0;
}

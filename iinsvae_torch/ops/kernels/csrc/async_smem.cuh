// Dynamic shared memory above the default 48 KB, and 16-byte (or 4-byte)
// cp.async copies into it: the staging of K3 and K3b (strided_conv.cuh), of
// K1b's residual-block and range-chain paths (in_chain_bwd.cu) and of K4b
// (mlp_chain_bwd.cu). Pointers of 16-byte copies are 16-byte aligned.
#pragma once

#include <cuda_runtime.h>

// Opt the kernel in to `bytes` of dynamic shared memory where that is over
// the default 48 KB; the attribute is set once for each size.
template <typename Kernel>
int allow_smem(Kernel kernel, int bytes, int* set_to) {
  if (bytes <= 48 * 1024 || bytes <= *set_to) return 0;
  const int err = static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
  if (!err) *set_to = bytes;
  return err;
}

// Copy 16 bytes from src (global) to dst (shared), or zero dst where !valid.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0));
}

// Copy 4 bytes from src (global) to dst (shared), or zero dst where !valid.
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most n of this thread's committed copy groups are in flight.
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

// Commit this thread's copies and wait for all of them.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

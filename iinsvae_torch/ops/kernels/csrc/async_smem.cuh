// Dynamic shared memory above the default 48 KB, and 16-byte (or 4-byte)
// cp.async copies into it: the staging of K3 and K3b (strided_conv.cuh), of
// K1b's residual-block and range-chain paths (in_chain_bwd.cu), of K4b
// (mlp_chain_bwd.cu) and of K7b (res_block_2d_bwd.cu). Pointers of 16-byte
// copies are 16-byte aligned. And bulk copies (one instruction a block of
// bytes, the copy engine's 1-D form) that complete on an mbarrier: the taps
// of K1's and K5's residual blocks (in_chain.cu), the tile's x of K4's
// restorer path (mlp_chain.cu). And a prefetch into L2.
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

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// An mbarrier of one arrival, for a block's bulk copies; then fence.mbarrier_init and a
// __syncthreads before any copy names it.
__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// The barrier's one arrival, expecting `bytes` of bulk copies before its phase 0 completes.
__device__ __forceinline__ void mbar_expect_tx(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the barrier's phase of the given parity (0: its first) completes: its copies have
// landed and are visible to the waiting thread. Traps after about 2 s at the H100's clock
// rather than hang.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity = 0) {
  const long long start = clock64();
  for (;;) {
    unsigned done;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > 4000000000LL) __trap();
  }
}

// Copy `bytes` (a multiple of 16, both ends 16-byte aligned) from src (global) to dst (shared)
// as one bulk copy that completes its bytes on bar.
__device__ __forceinline__ void bulk_copy(float* dst, const float* src, unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Ask L2 to fetch `bytes` (a multiple of 16, src 16-byte aligned) ahead of plain loads.
__device__ __forceinline__ void prefetch_l2(const float* src, unsigned bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;" ::"l"(src), "r"(bytes) : "memory");
}

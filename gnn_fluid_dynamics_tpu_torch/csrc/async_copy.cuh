// Hopper's asynchronous copies into shared memory, shared by K1 and K2
// (face_block.cu, cell_block.cu through gn_wgmma.cuh) and K6 and K7
// (table_dual.cu, table_single.cu through table_mma.cuh): mbarriers,
// bulk copies (cp.async.bulk) and bulk tensor copies (cp.async.bulk.tensor),
// their completion counted in bytes on an mbarrier, and 16-byte cp.async
// copies; and, on the host, the one-time opt-in to more shared memory.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace gfd {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One thread initialises; then fence_barrier_init and a __syncthreads.
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// Arrives once and adds `bytes` to what the barrier's phase waits for.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// Arrives once, adding no bytes.
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Whether the phase of parity `parity` has completed; does not wait.
__device__ __forceinline__ bool mbar_test(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Spins until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// `bytes` (a multiple of 16; both addresses 16-byte aligned) from global to
// shared memory, counted on `bar`.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// A 2-D box of a tensor (its map made on the host with
// cuTensorMapEncodeTiled, passed as a __grid_constant__ parameter) to
// shared memory at column x, row y, counted on `bar`.
__device__ __forceinline__ void tensor_copy_2d(uint32_t dst, const void* map,
                                               int x, int y, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(bar)
      : "memory");
}

// An L2 cache policy that evicts what it covers first: for data read once.
__device__ __forceinline__ uint64_t l2_evict_first() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
               : "=l"(policy));
  return policy;
}

// tensor_copy_2d under the L2 cache policy `policy`.
__device__ __forceinline__ void tensor_copy_2d(uint32_t dst, const void* map,
                                               int x, int y, uint32_t bar,
                                               uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.L2::cache_hint [%0], [%1, {%2, %3}], [%4], %5;" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(bar),
      "l"(policy)
      : "memory");
}

// The same for a 5-D box, at coordinates (c0, .., c4).
__device__ __forceinline__ void tensor_copy_5d(uint32_t dst, const void* map,
                                               int c0, int c1, int c2, int c3,
                                               int c4, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5, %6}], [%7];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(c4), "r"(bar)
      : "memory");
}

// 16 bytes from global to shared memory, bypassing L1.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// Makes this thread's generic-proxy writes to shared memory (stores and
// cp.async) visible to the async proxy (wgmma operand reads).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Host: raises `kernel`'s dynamic shared memory limit to `bytes` on
// `device` (below 64) the first time, one bit of `done` per device. The
// attribute stays set, so later launches skip the call.
inline cudaError_t smem_opt_in_once(const void* kernel, int device, int bytes,
                                    std::atomic<uint64_t>& done) {
  const uint64_t bit = uint64_t(1) << (device & 63);
  if (done.load() & bit) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

}  // namespace gfd

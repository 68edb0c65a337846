// One shared-memory slot per block, fed by Hopper's 1-D bulk copy (sm_90a),
// for the persistent augmentation kernels (csrc/warp.cu,
// csrc/photometric.cu).
//
// Each block of a persistent grid walks items (an image, or a tile of packed
// rows) blockIdx.x, blockIdx.x + gridDim.x, ... One thread loads an item
// into the slot with `cp.async.bulk.shared::cluster.global.mbarrier::
// complete_tx::bytes` (no tensor map: the item is one contiguous, 16-byte
// aligned run of bytes), and the slot's mbarrier says when its bytes have
// landed; its phase flips once per item, so item i waits on parity i & 1.
// The block computes the item in shared memory, writes the result back into
// the slot and stores it with one `cp.async.bulk.global.shared::cta` bulk
// store. That thread then waits until the store has read the slot
// (`cp.async.bulk.wait_group.read`) and loads the next item into it. The
// blocks resident on an SM overlap one another's copies and compute; on the
// H100 a deeper ring per block did not run faster than as many blocks per
// SM with one slot each (PERF.md), so a block keeps one slot.
//
// Per-item scalars (warp coefficients, photometric parameters) are loaded
// by the issuing thread or warp into the block's parameter area before the
// bulk copy is issued: `__syncwarp()` orders a warp's writes before lane
// 0's `mbarrier.arrive.expect_tx`, the arrive releases them and the waiting
// threads' `mbarrier.try_wait` acquires them, with the bytes.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ring {

constexpr int kThreads = 256;
constexpr int kSmemMax = 232448;  // 227 KB, the most a block may use

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// arrive on the slot's barrier and add `bytes` to the transaction count
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// spin until the barrier's phase of parity `parity` has completed; a slot
// that never fills (a copy that cannot land) traps, so the launch fails
// with an error instead of holding the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done;
  for (uint32_t tries = 0;; ++tries) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (done) return;
    if (tries == (1u << 26)) __trap();
  }
}

// global -> shared, `bytes` a multiple of 16, both addresses 16-byte aligned
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// make this thread's generic-proxy shared-memory writes visible to the
// async proxy (the bulk store that follows the next __syncthreads)
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// shared -> global, committed as one bulk group
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               :: "l"(dst), "r"(smem_addr(src)), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// wait until the bulk stores have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// The number of items a block walks: blockIdx.x + i * gridDim.x < items.
__device__ __forceinline__ int local_items(int items) {
  return (items - static_cast<int>(blockIdx.x) + static_cast<int>(gridDim.x) - 1) /
         static_cast<int>(gridDim.x);
}

// A walk over the (a, l) cells of an a_n x l_n grid, thread t starting at
// cell t and stepping by the block's thread count, with no division per
// cell: the start and the step are split into (a, l) once.
//   for (int a = w.a0, l = w.l0; a < a_n; w.next(a, l)) ...
struct Walk {
  int a0, l0, sa, sl, l_n;
  __device__ __forceinline__ explicit Walk(int l_n_) : l_n(l_n_) {
    a0 = static_cast<int>(threadIdx.x) / l_n;
    l0 = static_cast<int>(threadIdx.x) - a0 * l_n;
    sa = kThreads / l_n;
    sl = kThreads - sa * l_n;
  }
  __device__ __forceinline__ void next(int& a, int& l) const {
    a += sa;
    l += sl;
    if (l >= l_n) {
      l -= l_n;
      ++a;
    }
  }
};

// What a bulk copy takes: an address on a 16-byte boundary.
inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// Allow a kernel all of the 227 KB that its static shared memory leaves as
// dynamic shared memory, once per device (`done` holds a bit per device
// ordinal).
template <typename K>
inline cudaError_t allow_max_smem(K kernel, unsigned* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = 1u << (dev & 31);
  if (*done & bit) return cudaSuccess;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  // a kernel's static shared memory counts against the same 227 KB
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemMax - static_cast<int>(attr.sharedSizeBytes));
  if (err == cudaSuccess) *done |= bit;
  return err;
}

// Resident blocks of `kernel` per SM at `smem` bytes of dynamic shared
// memory (0 when it does not fit), for the host's grid plan.
template <typename K>
inline int blocks_per_sm(K kernel, unsigned* done, int smem) {
  if (smem > kSmemMax || allow_max_smem(kernel, done) != cudaSuccess) return 0;
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads, smem)
      != cudaSuccess)
    return 0;
  return n;
}

}  // namespace ring

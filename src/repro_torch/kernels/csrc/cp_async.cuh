// Asynchronous global -> shared copies, shared by the kernels that stage
// tiles of rows in shared memory (gon_step.cu, argmin_rows.cu).
//   * cp.async (sm_80+): a copy issued by a thread lands in shared memory
//     without passing through its registers; `commit` closes a group of
//     copies and `wait<N>` blocks the thread until at most N of its groups
//     are in flight. Each thread waits only for its own copies, so a
//     __syncthreads() after the wait makes a whole tile visible to the block.
//   * cp.async.bulk (sm_90): one thread hands a whole 16-byte aligned span
//     to the copy engine, and the stage's mbarrier completes when its bytes
//     have landed.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace repro {

constexpr int kMaxDevices = 64;

__device__ __forceinline__ unsigned shared_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 4 bytes; both addresses 4-byte aligned.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(shared_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Misalignment of a float pointer below 16 bytes, in floats (0..3). A span
// staged at dst[misalign(src) + e] has both sides of element e at the same
// offset modulo 16 bytes: its body goes by 16-byte aligned bulk copies, a
// head and a tail of up to 3 floats by 4-byte ones, whatever the source's
// alignment (a machine's rows start at b·per·d floats; a ring slot or a
// view may start anywhere).
__device__ __forceinline__ int misalign(const float* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

// Bulk copies (cp.async.bulk, sm_90): one thread asks the copy engine for a
// whole span of 16-byte aligned bytes, and an mbarrier counts the bytes in.
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(shared_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrive once on `bar` and add `bytes` to the bytes its phase waits for.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   shared_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Block until the phase of `bar` with the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(shared_addr(bar)),
      "r"(parity)
      : "memory");
}

// Order this thread's earlier shared-memory accesses before later bulk
// copies into the same bytes.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_copy(float* dst, const float* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(shared_addr(dst)),
      "l"(src), "r"(bytes), "r"(shared_addr(bar))
      : "memory");
}

// Bytes of the 16-byte aligned body of n floats at `src` (stage_span's
// layout): what a bulk copy of the span brings in.
__device__ __forceinline__ unsigned span_body_bytes(const float* src, int n) {
  const int head = min(n, (4 - misalign(src)) & 3);
  return 16u * static_cast<unsigned>((n - head) >> 2);
}

// stage_span with the body as one bulk copy that completes on `bar`: every
// thread calls it; thread 0 issues the body, and up to 3 + 3 threads copy
// the head and tail by 4-byte cp.async.
__device__ __forceinline__ void stage_span_bulk(float* dst, const float* src, int n,
                                                uint64_t* bar) {
  const int a = misalign(src);
  const int head = min(n, (4 - a) & 3);
  const int body = (n - head) >> 2;
  const int tail = head + (body << 2);
  float* d = dst + a;
  const int t = threadIdx.x;
  if (t < head) cp_async4(d + t, src + t);
  if (t >= 4 && t - 4 < n - tail) cp_async4(d + tail + t - 4, src + tail + t - 4);
  if (t == 0 && body > 0) bulk_copy(d + head, src + head, 16u * body, bar);
}

// Let `kernel` take `smem` bytes of dynamic shared memory on `device`, and
// ask for the largest shared-memory carveout, so that the CTAs a plan counts
// on fit one SM (the default carveout may leave room for fewer).
// `allowed` is the caller's record for this kernel, one entry a device: the
// attributes are set once, not at every launch.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, int smem, int device,
                              std::atomic<int>* allowed) {
  if (device >= 0 && device < kMaxDevices && smem <= allowed[device].load()) {
    return cudaSuccess;
  }
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  }
  if (err == cudaSuccess && device >= 0 && device < kMaxDevices) {
    allowed[device].store(smem);
  }
  return err;
}

}  // namespace repro

// Shared helpers for the port's hand-written sm_90a kernels.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// dtype codes passed across the plain C interface (see _build.py)
#define REPRO_F32 0
#define REPRO_BF16 1

// The most dynamic shared memory one block may ask for on sm_90.
constexpr int kMaxDynamicSmem = 232448;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T zero_of();
template <>
__device__ __forceinline__ float zero_of<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

// N consecutive elements from shared memory as f32.  `p` must be aligned
// to min(N, 4) * sizeof(T) bytes; N = 1, 2 or a multiple of 4.
template <int N>
__device__ __forceinline__ void load_f32(const float* p, float (&v)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 x = *reinterpret_cast<const float4*>(p + i);
      v[i] = x.x; v[i + 1] = x.y; v[i + 2] = x.z; v[i + 3] = x.w;
    }
  } else if constexpr (N == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    v[0] = x.x; v[1] = x.y;
  } else {
    v[0] = p[0];
  }
}

template <int N>
__device__ __forceinline__ void load_f32(const __nv_bfloat16* p, float (&v)[N]) {
  if constexpr (N == 1) {
    v[0] = __bfloat162float(p[0]);
  } else if constexpr (N == 2) {
    const float2 x =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    v[0] = x.x; v[1] = x.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const uint2 raw = *reinterpret_cast<const uint2*>(p + i);
      const float2 lo =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
      const float2 hi =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
      v[i] = lo.x; v[i + 1] = lo.y; v[i + 2] = hi.x; v[i + 3] = hi.y;
    }
  }
}

// --- cp.async (sm_80+): 16-byte global -> shared copies ------------------

// Copies 16 bytes, or writes 16 zero bytes when `full` is false (the
// source is then not read, but must still be a valid address).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = full ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

// Copies the first `src_bytes` (0-16) of 16 bytes and zero-fills the rest.
__device__ __forceinline__ void cp_async16_n(void* smem, const void* gmem,
                                             int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copies `src_bytes` (0-4) of a 4-byte chunk and zero-fills the rest;
// the source must be a valid address even when nothing is read.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

// --- mbarrier and bulk copy (sm_90): one thread moves a whole run --------

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// A barrier that completes a phase once `count` threads have arrived and
// the bytes they announced have landed.
__device__ __forceinline__ void mbar_init(std::uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Makes initialised barriers visible to the bulk-copy unit.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrive once, announcing `bytes` that bulk copies will complete.
__device__ __forceinline__ void mbar_expect_tx(std::uint64_t* bar,
                                               unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Spin until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(std::uint64_t* bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// One bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from global to shared memory, completed on `bar`.
__device__ __forceinline__ void bulk_copy_g2s(void* smem, const void* gmem,
                                              unsigned bytes,
                                              std::uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(smem)),
      "l"(gmem), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__host__ __device__ inline bool aligned16(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15) == 0;
}

// Makes `device` current for the guard's lifetime, switching only when it
// is not already (the caller's device is restored at the end).
class DeviceGuard {
 public:
  explicit DeviceGuard(int device) {
    if (cudaGetDevice(&old_) == cudaSuccess && old_ != device &&
        cudaSetDevice(device) == cudaSuccess)
      restore_ = true;
  }
  ~DeviceGuard() {
    if (restore_) cudaSetDevice(old_);
  }

 private:
  int old_ = -1;
  bool restore_ = false;
};

// Launch Kernel with `smem` bytes of dynamic shared memory.  Above 48 KB
// the function's limit is raised first, once per kernel and device: the
// call costs far more host time than a launch.
template <auto Kernel, typename... Args>
static cudaError_t launch_with_smem(dim3 grid, int threads, size_t smem,
                                    cudaStream_t stream, Args... args) {
  if (smem > (size_t)kMaxDynamicSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    constexpr int kDevices = 64;
    static bool raised[kDevices] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev >= kDevices || !raised[dev]) {
      err = cudaFuncSetAttribute(
          Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxDynamicSmem);
      if (err != cudaSuccess) return err;
      if (dev < kDevices) raised[dev] = true;
    }
  }
  Kernel<<<grid, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

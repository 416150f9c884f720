// Shared helpers for the port's hand-written sm_90a kernels.
#pragma once

#include <cuda.h>

#include <cstdint>
#include <mutex>

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

// Arrive once, announcing nothing.
__device__ __forceinline__ void mbar_arrive(std::uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
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

// --- wgmma (sm_90a): a warpgroup's asynchronous products ------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving reads or writes of accumulators across
// the asynchronous products.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// A tile of 64 rows of 128 bytes (64 bf16) in the 128-byte swizzle, as a
// TMA box of 64 x 64 bf16 lays it down: 8 KB.
constexpr int kSwizzledTileBytes = 64 * 128;

// wgmma's shared-memory descriptors for the 128-byte swizzle: rows of 128
// bytes, 8-row groups 1024 bytes apart.  K-major: the 16 columns of one
// step lie inside a row (advance 32 bytes a step).  MN-major: the operand's
// contiguous dimension runs along the rows, in 64-column chunks of 64 rows
// kSwizzledTileBytes apart (advance 16 rows, 2048 bytes, a step).
__device__ __forceinline__ std::uint64_t kmajor(unsigned addr) {
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}
__device__ __forceinline__ std::uint64_t mnmajor(unsigned addr) {
  return ((addr & 0x3FFFF) >> 4) |
         ((std::uint64_t)(kSwizzledTileBytes >> 4) << 16) | (64ull << 32) |
         (1ull << 62);
}

// cuTensorMapEncodeTiled, from the driver through the runtime: no link to
// libcuda.  Null when the driver has none.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  static std::once_flag once;
  std::call_once(once, [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(f);
  });
  return fn;
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

// The device's SM count, asked once per device; 0 when the query fails.
inline int sm_count(int device) {
  constexpr int kDevices = 64;
  static int sms[kDevices];
  static std::once_flag once[kDevices];
  if (device < 0 || device >= kDevices) return 0;
  std::call_once(once[device], [device] {
    if (cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount,
                               device) != cudaSuccess)
      sms[device] = 0;
  });
  return sms[device];
}

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

// Weight-omega encode coded[i] = sum_{j<w} coef[i,j] * blocks[sup[i,j]]
// (see cyclic_encode.py).
//
// A gather-axpy bound by memory.  grid.y is the coded shard i, grid.x
// walks its (T x C) plane; each thread owns ELEMS elements spaced one
// block apart (so every load and store of a warp is coalesced), sums the
// w support slots in f32 registers and stores once.  The support index
// and coefficient of a slot are the same for the whole block and are read
// as broadcasts.  An index out of range traps.
#include "common.cuh"

constexpr int kThreads = 256;
constexpr int kElems = 4;

template <typename T>
__global__ void cyclic_encode_kernel(const T* __restrict__ blocks,
                                     const int* __restrict__ sup,
                                     const float* __restrict__ coef,
                                     float* __restrict__ out, int k,
                                     long long plane, int w) {
  const int i = blockIdx.y;
  const long long base = (long long)blockIdx.x * kThreads * kElems + threadIdx.x;
  float acc[kElems];
#pragma unroll
  for (int e = 0; e < kElems; ++e) acc[e] = 0.f;

  for (int j = 0; j < w; ++j) {
    const int s = sup[i * w + j];
    const float cf = coef[i * w + j];
    if (s < 0 || s >= k) __trap();
    const T* src = blocks + (long long)s * plane;
#pragma unroll
    for (int e = 0; e < kElems; ++e) {
      const long long p = base + (long long)e * kThreads;
      if (p < plane) acc[e] = fmaf(cf, to_f32(src[p]), acc[e]);
    }
  }
  float* dst = out + (long long)i * plane;
#pragma unroll
  for (int e = 0; e < kElems; ++e) {
    const long long p = base + (long long)e * kThreads;
    if (p < plane) dst[p] = acc[e];
  }
}

extern "C" int repro_cyclic_encode(const void* blocks, int dtype,
                                   const void* sup, const void* coef,
                                   void* out, int k, long long plane, int n,
                                   int w, void* stream) {
  const long long per_block = (long long)kThreads * kElems;
  const long long gx = (plane + per_block - 1) / per_block;
  if (gx <= 0 || gx > 0x7fffffffLL || n <= 0 || n > 65535)
    return cudaErrorInvalidValue;
  const dim3 grid((unsigned)gx, n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* sp = static_cast<const int*>(sup);
  const float* cp = static_cast<const float*>(coef);
  float* o = static_cast<float*>(out);
  if (dtype == REPRO_F32)
    cyclic_encode_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(blocks), sp, cp, o, k, plane, w);
  else if (dtype == REPRO_BF16)
    cyclic_encode_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(blocks), sp, cp, o, k, plane, w);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

// Fastest-k decode U = Hinv @ Y (see decode_matmul.py).
//
// Hinv (k x k, f32) is staged once per block into shared memory, zero-
// padded to KMAX x KMAX.  Each thread owns one column p of Y: it loads
// Y[:, p] into KMAX registers, then writes U[i, p] = sum_j Hinv[i, j] Y[j, p]
// for every i < k with f32 FFMA in j order.  Threads of a warp take
// neighbouring columns, so every load and store is coalesced and every
// shared read is a broadcast.
#include "common.cuh"

constexpr int kThreads = 256;

template <typename T, int KMAX>
__global__ void decode_matmul_kernel(const float* __restrict__ hinv,
                                     const T* __restrict__ y,
                                     float* __restrict__ u, int k,
                                     long long P) {
  __shared__ float sH[KMAX * KMAX];
  for (int e = threadIdx.x; e < KMAX * KMAX; e += kThreads) {
    const int i = e / KMAX, j = e % KMAX;
    sH[e] = (i < k && j < k) ? hinv[i * k + j] : 0.f;
  }
  __syncthreads();
  const long long p = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (p >= P) return;
  float yv[KMAX];
#pragma unroll
  for (int j = 0; j < KMAX; ++j) yv[j] = j < k ? to_f32(y[(long long)j * P + p]) : 0.f;
  for (int i = 0; i < k; ++i) {
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < KMAX; ++j) acc = fmaf(sH[i * KMAX + j], yv[j], acc);
    u[(long long)i * P + p] = acc;
  }
}

template <typename T>
static cudaError_t launch_typed(const float* hinv, const void* y, float* u,
                                int k, long long P, cudaStream_t s) {
  const long long gx = (P + kThreads - 1) / kThreads;
  if (gx <= 0 || gx > 0x7fffffffLL) return cudaErrorInvalidValue;
  const T* yy = static_cast<const T*>(y);
  if (k <= 16)
    decode_matmul_kernel<T, 16><<<(unsigned)gx, kThreads, 0, s>>>(hinv, yy, u, k, P);
  else if (k <= 32)
    decode_matmul_kernel<T, 32><<<(unsigned)gx, kThreads, 0, s>>>(hinv, yy, u, k, P);
  else if (k <= 64)
    decode_matmul_kernel<T, 64><<<(unsigned)gx, kThreads, 0, s>>>(hinv, yy, u, k, P);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

extern "C" int repro_decode_matmul(const void* hinv, const void* y,
                                   int y_dtype, void* u, int k, long long P,
                                   void* stream) {
  const float* h = static_cast<const float*>(hinv);
  float* out = static_cast<float*>(u);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (y_dtype == REPRO_F32) return launch_typed<float>(h, y, out, k, P, s);
  if (y_dtype == REPRO_BF16)
    return launch_typed<__nv_bfloat16>(h, y, out, k, P, s);
  return cudaErrorInvalidValue;
}

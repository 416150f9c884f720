// Block-sparse worker product C = A^T B from packed A (see bcsr_matmul.py).
//
// One thread block per (output block-row g, N-tile).  The block walks the
// J packed slots of its block-row in a loop, staging the (bk x bm) A tile
// and the (bk x bn) B tile that the slot's K-block index selects in shared
// memory, and accumulates bm x bn outputs in f32 registers (RPT rows per
// thread, FFMA only).  C is written once.  With `rows` non-null, output
// block-row g reads packed block-row rows[g / mb] * mb + g % mb, so the
// fastest-k live workers are multiplied straight out of the full packed
// operand.  Rows of B past K and columns past N read as zero; columns past
// N are never written.  An index out of range traps.
#include "common.cuh"

template <typename TA, typename TB, int RPT>
__global__ void bcsr_matmul_kernel(const TA* __restrict__ a_data,
                                   const int* __restrict__ a_idx,
                                   const TB* __restrict__ b,
                                   const int* __restrict__ rows,
                                   float* __restrict__ c,
                                   int mb, int n_src, int J, int bk, int bm,
                                   int K, int N, int bn) {
  extern __shared__ float smem[];
  float* As = smem;             // bk x bm
  float* Bs = smem + bk * bm;   // bk x bn

  const int g = blockIdx.x;
  const int n0 = blockIdx.y * bn;
  const int src = rows ? rows[g / mb] * mb + g % mb : g;
  if (src < 0 || src >= n_src) __trap();

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int col = tid % bn;
  const int row0 = tid / bn;
  const int rstride = nthreads / bn;   // == bm / RPT

  float acc[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) acc[r] = 0.f;

  const TA* a_row = a_data + (size_t)src * J * bk * bm;
  const int* idx_row = a_idx + (size_t)src * J;
  const int tile = bk * bm;
  const int btile = bk * bn;
  for (int j = 0; j < J; ++j) {
    const int kblk = idx_row[j];
    if (kblk < 0 || kblk * bk >= K) __trap();
    const TA* a_tile = a_row + (size_t)j * tile;
    for (int e = tid; e < tile; e += nthreads) As[e] = to_f32(a_tile[e]);
    for (int e = tid; e < btile; e += nthreads) {
      const int kr = kblk * bk + e / bn;
      const int cn = n0 + e % bn;
      Bs[e] = (kr < K && cn < N) ? to_f32(b[(size_t)kr * N + cn]) : 0.f;
    }
    __syncthreads();
    for (int kk = 0; kk < bk; ++kk) {
      const float bv = Bs[kk * bn + col];
      const float* a_k = As + kk * bm + row0;
#pragma unroll
      for (int r = 0; r < RPT; ++r) acc[r] = fmaf(a_k[r * rstride], bv, acc[r]);
    }
    __syncthreads();
  }

  const int cn = n0 + col;
  if (cn < N) {
    float* c_blk = c + (size_t)g * bm * N + cn;
#pragma unroll
    for (int r = 0; r < RPT; ++r) c_blk[(size_t)(row0 + r * rstride) * N] = acc[r];
  }
}

template <typename TA, typename TB>
static cudaError_t launch_typed(const void* a_data, const int* a_idx,
                                const void* b, const int* rows, float* c,
                                int n_out, int mb, int n_src, int J, int bk,
                                int bm, int K, int N, int bn, int rpt,
                                cudaStream_t stream) {
  const int threads = bm * bn / rpt;
  const dim3 grid(n_out, (N + bn - 1) / bn);
  const size_t smem = (size_t)(bk * bm + bk * bn) * sizeof(float);
  const TA* a = static_cast<const TA*>(a_data);
  const TB* bb = static_cast<const TB*>(b);
#define REPRO_BCSR_CASE(R)                                                  \
  case R:                                                                   \
    bcsr_matmul_kernel<TA, TB, R><<<grid, threads, smem, stream>>>(         \
        a, a_idx, bb, rows, c, mb, n_src, J, bk, bm, K, N, bn);             \
    break;
  switch (rpt) {
    REPRO_BCSR_CASE(1)
    REPRO_BCSR_CASE(2)
    REPRO_BCSR_CASE(4)
    REPRO_BCSR_CASE(8)
    REPRO_BCSR_CASE(16)
    REPRO_BCSR_CASE(32)
    default:
      return cudaErrorInvalidValue;
  }
#undef REPRO_BCSR_CASE
  return cudaGetLastError();
}

extern "C" int repro_bcsr_matmul(const void* a_data, int a_dtype,
                                 const void* a_idx, const void* b,
                                 int b_dtype, const void* rows, void* c,
                                 int n_out, int mb, int n_src, int J, int bk,
                                 int bm, int K, int N, int bn, int rpt,
                                 void* stream) {
  const int* idx = static_cast<const int*>(a_idx);
  const int* rw = static_cast<const int*>(rows);
  float* out = static_cast<float*>(c);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a_dtype == REPRO_F32 && b_dtype == REPRO_F32)
    return launch_typed<float, float>(a_data, idx, b, rw, out, n_out, mb,
                                      n_src, J, bk, bm, K, N, bn, rpt, s);
  if (a_dtype == REPRO_F32 && b_dtype == REPRO_BF16)
    return launch_typed<float, __nv_bfloat16>(a_data, idx, b, rw, out, n_out,
                                              mb, n_src, J, bk, bm, K, N, bn,
                                              rpt, s);
  if (a_dtype == REPRO_BF16 && b_dtype == REPRO_F32)
    return launch_typed<__nv_bfloat16, float>(a_data, idx, b, rw, out, n_out,
                                              mb, n_src, J, bk, bm, K, N, bn,
                                              rpt, s);
  if (a_dtype == REPRO_BF16 && b_dtype == REPRO_BF16)
    return launch_typed<__nv_bfloat16, __nv_bfloat16>(
        a_data, idx, b, rw, out, n_out, mb, n_src, J, bk, bm, K, N, bn, rpt,
        s);
  return cudaErrorInvalidValue;
}

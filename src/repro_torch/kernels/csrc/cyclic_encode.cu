// Weight-omega encode coded[i] = sum_{j<w} coef[i,j] * blocks[sup[i,j]]
// (see cyclic_encode.py).
//
// Bound by bytes, so every source element is read from device memory once.
// One block owns a chunk of CHUNK = 256 * E consecutive positions p of the
// flat (T x C) plane for all n shards: it copies the chunk of every one of
// the k sources into shared memory, then writes each shard's chunk as the
// w-term sum over its support, in f32 registers, stored once.  A grid that
// walked the shards one after another instead re-reads each source, from
// device memory once it has left L2, for every shard that uses it.
//
// The sources are read in place through (block_stride, row_stride):
// element (j, t, c) is at blocks[j * block_stride + t * row_stride + c], so
// split_block_columns' strided view of A or B needs no copy.  When the base,
// both strides and C are multiples of 16 bytes, the copy moves 16-byte
// vectors; otherwise single elements, several in flight per thread.  The
// output (n, T, C) is contiguous; each thread stores its E consecutive
// elements as one vector when the plane size allows.  An index out of range
// traps.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

struct EncodeArgs {
  const void* blocks;
  long long block_stride, row_stride;
  const int* sup;      // (n, w)
  const float* coef;   // (n, w)
  float* out;          // (n, T, C)
  int k, C, n, w, plane;
};

template <typename T, int E>
__host__ __device__ constexpr int source_bytes(int k) {
  return ((k * kThreads * E * (int)sizeof(T)) + 15) / 16 * 16;
}

template <typename T, bool VEC, int E>
__global__ void __launch_bounds__(kThreads)
cyclic_encode_kernel(EncodeArgs p) {
  constexpr int CHUNK = kThreads * E;
  extern __shared__ __align__(16) unsigned char smem[];
  T* src = reinterpret_cast<T*>(smem);                       // k x CHUNK
  int* ssup = reinterpret_cast<int*>(smem + source_bytes<T, E>(p.k));
  float* scoef = reinterpret_cast<float*>(ssup + p.n * p.w);

  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * CHUNK;
  for (int e = tid; e < p.n * p.w; e += kThreads) {
    const int s = p.sup[e];
    if (s < 0 || s >= p.k) __trap();
    ssup[e] = s;
    scoef[e] = p.coef[e];
  }

  // copy the chunk of all k sources: U loads in flight per thread
  using V = typename std::conditional<VEC, uint4, T>::type;
  constexpr int PER_V = (int)(sizeof(V) / sizeof(T));
  constexpr int PER_ROW = CHUNK / PER_V;
  constexpr int U = VEC ? 4 : 8;
  const T* blocks = static_cast<const T*>(p.blocks);
  const int total = p.k * PER_ROW;
  for (int q0 = tid; q0 < total; q0 += kThreads * U) {
    V v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int q = q0 + u * kThreads;
      const int pp = p0 + (q % PER_ROW) * PER_V;
      if (q < total && pp < p.plane) {   // VEC: C % PER_V == 0, all or none
        const int t = pp / p.C, c = pp - t * p.C;
        v[u] = *reinterpret_cast<const V*>(
            blocks + (q / PER_ROW) * p.block_stride + t * p.row_stride + c);
      } else {
        v[u] = V{};
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int q = q0 + u * kThreads;
      if (q < total)
        *reinterpret_cast<V*>(src + (q / PER_ROW) * CHUNK +
                              (q % PER_ROW) * PER_V) = v[u];
    }
  }
  __syncthreads();

  const int pe = p0 + tid * E;            // this thread's first element
  if (pe >= p.plane) return;
  const bool vec_out = p.plane % E == 0;  // then pe + E <= plane as well
  for (int i = 0; i < p.n; ++i) {
    float acc[E];
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] = 0.f;
    for (int j = 0; j < p.w; ++j) {
      const float cf = scoef[i * p.w + j];
      float v[E];
      load_f32<E>(src + ssup[i * p.w + j] * CHUNK + tid * E, v);
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] = fmaf(cf, v[e], acc[e]);
    }
    float* dst = p.out + (long long)i * p.plane + pe;
    if constexpr (E == 4) {
      if (vec_out) {
        *reinterpret_cast<float4*>(dst) =
            make_float4(acc[0], acc[1], acc[2], acc[3]);
        continue;
      }
    } else if constexpr (E == 2) {
      if (vec_out) {
        *reinterpret_cast<float2*>(dst) = make_float2(acc[0], acc[1]);
        continue;
      }
    }
#pragma unroll
    for (int e = 0; e < E; ++e)
      if (pe + e < p.plane) dst[e] = acc[e];
  }
}

template <typename T, bool VEC, int E>
cudaError_t launch(const EncodeArgs& p, cudaStream_t stream) {
  constexpr int CHUNK = kThreads * E;
  const unsigned blocks = (unsigned)((p.plane + CHUNK - 1) / CHUNK);
  const size_t smem =
      source_bytes<T, E>(p.k) + (size_t)p.n * p.w * (sizeof(int) + sizeof(float));
  return launch_with_smem<cyclic_encode_kernel<T, VEC, E>>(
      dim3(blocks), kThreads, smem, stream, p);
}

template <typename T, bool VEC>
cudaError_t by_elems(const EncodeArgs& p, int elems, cudaStream_t stream) {
  switch (elems) {
    case 1: return launch<T, VEC, 1>(p, stream);
    case 2: return launch<T, VEC, 2>(p, stream);
    case 4: return launch<T, VEC, 4>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch(const EncodeArgs& p, int elems, cudaStream_t stream) {
  constexpr int V = 16 / (int)sizeof(T);
  const bool vec = aligned16(p.blocks) && p.block_stride % V == 0 &&
                   p.row_stride % V == 0 && p.C % V == 0;
  return vec ? by_elems<T, true>(p, elems, stream)
             : by_elems<T, false>(p, elems, stream);
}

}  // namespace

extern "C" int repro_cyclic_encode(const void* blocks, int dtype,
                                   long long block_stride,
                                   long long row_stride, const void* sup,
                                   const void* coef, void* out, int k, int T,
                                   int C, int n, int w, int elems,
                                   int device, void* stream) {
  const long long plane = (long long)T * C;
  if (k <= 0 || n <= 0 || w <= 0 || plane <= 0 || plane > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  EncodeArgs p{blocks, block_stride, row_stride,
               static_cast<const int*>(sup), static_cast<const float*>(coef),
               static_cast<float*>(out), k, C, n, w, (int)plane};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  DeviceGuard guard(device);
  if (dtype == REPRO_F32) return dispatch<float>(p, elems, s);
  if (dtype == REPRO_BF16) return dispatch<__nv_bfloat16>(p, elems, s);
  return cudaErrorInvalidValue;
}

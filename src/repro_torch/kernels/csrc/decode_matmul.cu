// Fastest-k decode U = Hinv @ Y, stored straight into the caller's layout
// (see decode_matmul.py).
//
// Unknown i's panel U[i] is a Q x C matrix.  Its element (q, p) is
//   sum_j Hinv[i, j] * Y_j(q, p),
//   Y_j(q, p) = y[row_j * s_w + q * s_q + p * s_p],
// with row_j = rows[j] (the live results, read in place) or j, summed with
// f32 FFMA in j order.  With i = ia * kb + ib it is stored at
//   out[(ia * Q + q) * ldo + ib * C + p]
// when ia * Q + q < row_lim and ib * C + p < col_lim, and dropped otherwise.
// The wrapper's layouts are this map with other scalars; elements of Y
// outside the Q x C panels (pad columns) are never decoded.
//
// Two kernels, by which axis of Y has unit stride:
//   * decode_rows (s_p == 1: flat, mm, gather): Y and the output agree, so
//     each thread owns N neighbouring p of one q, loads the k inputs as
//     N-wide vectors and stores N-wide vectors of its unknowns;
//   * decode_transposed (s_q == 1: mv, Y as bcsr_matmul leaves it, the
//     requests innermost): a block copies a tile of all k inputs, TC
//     panel columns by TQ rows, into shared memory with 16-byte loads,
//     then its threads walk p, so the stores run along the output's rows.
// A thread issues all its loads (Y, and its share of Hinv) before it
// stores any, and a block meets one barrier.  Where the positions alone
// leave too few threads to fill the card (the LM head's matvec decodes
// 18k outputs per unknown), the unknowns are split into groups, one per
// thread (transposed) or per grid row (rows), so each thread's chain of
// dependent FMAs is short, and a thread decodes four unknowns at once.
// Hinv sits in shared memory with rows padded to 16 bytes (k <= 64:
// 16 KB) and is read as broadcast float4s.  The loops over the inputs are
// unrolled to KMAX (16, 32 or 64) and leave at k, so no FMA is spent on
// padding.
#include <algorithm>
#include <type_traits>

#include "common.cuh"

struct DecodeArgs {
  const float* hinv;   // (k, k) f32
  const void* y;
  const int* rows;     // (k,) rows of y holding the live results, or null
  void* out;
  int k, kb;           // unknowns; unknowns side by side in one output row
  long long Q, C;      // panel rows and columns per unknown
  long long s_w, s_q, s_p;            // element strides of y
  long long ldo, row_lim, col_lim;    // output row stride and clip
};

constexpr int kThreads = 128;

__device__ __forceinline__ void to_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void to_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);   // round to nearest even, as .to(bfloat16)
}

// N consecutive f32 values stored as T; `p` aligned to N elements.
template <int N>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[N]) {
  if constexpr (N == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (N == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    p[0] = v[0];
  }
}

template <int N>
__device__ __forceinline__ void store_vec(__nv_bfloat16* p,
                                          const float (&v)[N]) {
  if constexpr (N == 4) {
    __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    uint2 raw;
    raw.x = *reinterpret_cast<unsigned*>(&lo);
    raw.y = *reinterpret_cast<unsigned*>(&hi);
    *reinterpret_cast<uint2*>(p) = raw;
  } else if constexpr (N == 2) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v[0], v[1]);
  } else {
    p[0] = __float2bfloat16_rn(v[0]);
  }
}

// Offset in y of live result j.
__device__ __forceinline__ long long base_of(const DecodeArgs& a, int j) {
  return (long long)(a.rows ? __ldg(a.rows + j) : j) * a.s_w;
}

// Row pitch of Hinv in shared memory: rows start 16-byte aligned.
__device__ __forceinline__ int hinv_pitch(int k) { return (k + 3) & ~3; }

// Hinv into shared memory (pitch hinv_pitch(k)).  All of a thread's loads
// are issued before its first store, so they are in flight together with
// the caller's loads of Y.
template <int KMAX>
__device__ __forceinline__ void stage_inverse(const DecodeArgs& a, float* sH) {
  constexpr int IT = (KMAX * KMAX + kThreads - 1) / kThreads;
  const int kk = a.k * a.k, hp = hinv_pitch(a.k);
  float h[IT];
#pragma unroll
  for (int it = 0; it < IT; ++it) {
    const int e = threadIdx.x + it * kThreads;
    if (e < kk) h[it] = __ldg(a.hinv + e);
  }
#pragma unroll
  for (int it = 0; it < IT; ++it) {
    const int e = threadIdx.x + it * kThreads;
    if (e < kk) sH[(e / a.k) * hp + e % a.k] = h[it];
  }
}

// Unknowns decoded together: their FMA chains interleave, which hides the
// FMA latency, while the code stays linear in KMAX.
constexpr int kUnknownsAtOnce = 4;

// Decodes panel elements (q, p .. p+N-1) of unknowns [i0, i1) from the k
// inputs yv[j][.] and stores them.  The N columns lie inside one panel.
template <typename Tout, int KMAX, int N>
__device__ __forceinline__ void decode_store(const DecodeArgs& a,
                                             const float* sH,
                                             const float (&yv)[KMAX][N],
                                             long long q, long long p,
                                             int i0, int i1) {
  constexpr int U = kUnknownsAtOnce;
  Tout* out = static_cast<Tout*>(a.out);
  const int k = a.k, hp = hinv_pitch(k);
  for (int i = i0; i < i1; i += U) {
    float acc[U][N];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int v = 0; v < N; ++v) acc[u][v] = 0.f;
#pragma unroll
    for (int j4 = 0; j4 < KMAX / 4; ++j4) {
      if (4 * j4 >= k) break;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (i + u >= i1) break;
        const float4 h =
            *reinterpret_cast<const float4*>(sH + (i + u) * hp + 4 * j4);
        const float hj[4] = {h.x, h.y, h.z, h.w};
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          if (4 * j4 + t < k) {
#pragma unroll
            for (int v = 0; v < N; ++v)
              acc[u][v] = fmaf(hj[t], yv[4 * j4 + t][v], acc[u][v]);
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (i + u >= i1) break;
      const int ia = (i + u) / a.kb, ib = (i + u) - ia * a.kb;
      const long long row = ia * a.Q + q, col = ib * a.C + p;
      if (row >= a.row_lim || col >= a.col_lim) continue;
      Tout* dst = out + row * a.ldo + col;
      if (col + N <= a.col_lim) {
        store_vec<N>(dst, acc[u]);
      } else {
#pragma unroll
        for (int v = 0; v < N; ++v)
          if (col + v < a.col_lim) to_out(dst + v, acc[u][v]);
      }
    }
  }
}

// s_p == 1.  Thread x of grid row y owns the N neighbouring columns
// p .. p+N-1 of panel row q (x = q * C/N + p/N) and decodes unknowns
// [y * S, y * S + S), S = ceil(k / gridDim.y).  Needs C, s_q, s_w and ldo
// divisible by N and y, out aligned to N elements (the launcher picks
// N = 1 otherwise).
template <typename Tin, typename Tout, int KMAX, int N>
__global__ void __launch_bounds__(kThreads) decode_rows_kernel(DecodeArgs a) {
  __shared__ __align__(16) float sH[KMAX * KMAX];
  const long long cv = a.C / N;
  const long long pos = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long q = pos / cv, p = (pos - q * cv) * N;
  const bool mine = pos < a.Q * cv;
  float yv[KMAX][N];
  if (mine) {
    const Tin* src = static_cast<const Tin*>(a.y) + q * a.s_q + p;
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      if (j >= a.k) break;
      load_f32<N>(src + base_of(a, j), yv[j]);
    }
  }
  stage_inverse<KMAX>(a, sH);
  __syncthreads();
  if (!mine) return;
  const int S = (a.k + gridDim.y - 1) / gridDim.y;
  const int i0 = blockIdx.y * S;
  decode_store<Tout, KMAX, N>(a, sH, yv, q, p, i0, min(a.k, i0 + S));
}

// s_q == 1.  Block (bx, by) decodes panel columns [bx*TC, +TC) and rows
// [by*TQ, +TQ), TC * TQ <= kThreads; thread t takes position t % (TC*TQ)
// for the t / (TC*TQ)-th of kThreads / (TC*TQ) groups of unknowns.
// Shared memory: Hinv, then the tile as [k][TC][pitch] f32 with an odd
// pitch, so that lanes on neighbouring columns read distinct banks.
// With TQ == Q == s_p, each input's tile is one run of y, read with
// 16-byte loads when `vec` (the launcher checked the alignment).
template <typename Tin, typename Tout, int KMAX>
__global__ void __launch_bounds__(kThreads)
    decode_transposed_kernel(DecodeArgs a, int TC, int TQ, bool vec) {
  extern __shared__ __align__(16) float smem[];
  constexpr int V = 16 / sizeof(Tin);
  const int k = a.k;
  const int pitch = TQ | 1;
  float* sH = smem;
  float* sY = smem + k * hinv_pitch(k);
  const long long p0 = (long long)blockIdx.x * TC;
  const long long q0 = (long long)blockIdx.y * TQ;
  const int tc = (int)min((long long)TC, a.C - p0);
  const int tq = (int)min((long long)TQ, a.Q - q0);
  const int run = tc * tq;
  const Tin* y = static_cast<const Tin*>(a.y) + p0 * a.s_p + q0;
  auto put = [&](int j, int idx, float v) {
    const int cc = idx / tq, qq = idx - cc * tq;
    sY[(j * TC + cc) * pitch + qq] = v;
  };

  if (vec) {
    // k * (run / V) vectors, at most KMAX / V per thread
    const int nvec = run / V;
    float v[KMAX / V][V];
#pragma unroll
    for (int it = 0; it < KMAX / V; ++it) {
      const int e = threadIdx.x + it * kThreads;
      if (e < k * nvec) {
        const int j = e / nvec;
        load_f32<V>(y + base_of(a, j) + (e - j * nvec) * V, v[it]);
      }
    }
    stage_inverse<KMAX>(a, sH);
#pragma unroll
    for (int it = 0; it < KMAX / V; ++it) {
      const int e = threadIdx.x + it * kThreads;
      if (e < k * nvec) {
        const int j = e / nvec, first = (e - j * nvec) * V;
#pragma unroll
        for (int u = 0; u < V; ++u) put(j, first + u, v[it][u]);
      }
    }
    const int tail = run - nvec * V;   // the last tile's ragged end
    for (int e = threadIdx.x; e < k * tail; e += kThreads) {
      const int j = e / tail, idx = nvec * V + (e - j * tail);
      put(j, idx, to_f32(y[base_of(a, j) + idx]));
    }
  } else {
    // k * run elements, at most KMAX per thread
    float v[KMAX];
#pragma unroll
    for (int it = 0; it < KMAX; ++it) {
      const int e = threadIdx.x + it * kThreads;
      if (e < k * run) {
        const int j = e / run, idx = e - j * run;
        const int cc = idx / tq, qq = idx - cc * tq;
        v[it] = to_f32(y[base_of(a, j) + cc * a.s_p + qq]);
      }
    }
    stage_inverse<KMAX>(a, sH);
#pragma unroll
    for (int it = 0; it < KMAX; ++it) {
      const int e = threadIdx.x + it * kThreads;
      if (e < k * run) put(e / run, e - (e / run) * run, v[it]);
    }
  }
  __syncthreads();

  const int tile = TC * TQ, groups = kThreads / tile;
  const int S = (k + groups - 1) / groups, group = threadIdx.x / tile;
  const int cc = threadIdx.x % TC, qq = (threadIdx.x % tile) / TC;
  if (group >= groups || qq >= tq || cc >= tc || group * S >= k) return;
  float yv[KMAX][1];
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    if (j >= k) break;
    yv[j][0] = sY[(j * TC + cc) * pitch + qq];
  }
  decode_store<Tout, KMAX, 1>(a, sH, yv, q0 + qq, p0 + cc, group * S,
                              min(k, group * S + S));
}

static bool aligned_to(const void* p, size_t bytes) {
  return (reinterpret_cast<std::uintptr_t>(p) % bytes) == 0;
}

// Enough blocks to keep every SM busy: the unknowns are split into grid
// rows until there are this many blocks per SM, or one unknown per row.
constexpr int kBlocksPerSm = 4;

template <typename Tin, typename Tout, int KMAX, int N>
static cudaError_t launch_rows(const DecodeArgs& a, int sms, cudaStream_t s) {
  const long long blocks = (a.Q * (a.C / N) + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  int groups = 1;
  while (groups < a.k && blocks * groups < (long long)kBlocksPerSm * sms)
    ++groups;
  const int per = (a.k + groups - 1) / groups;
  groups = (a.k + per - 1) / per;   // no empty grid row
  decode_rows_kernel<Tin, Tout, KMAX, N>
      <<<dim3((unsigned)blocks, groups), kThreads, 0, s>>>(a);
  return cudaGetLastError();
}

// N-wide vectors where the layout is aligned and they still leave a block
// for every SM; one column per thread otherwise.
template <typename Tin, typename Tout, int KMAX>
static cudaError_t dispatch_rows(const DecodeArgs& a, int sms,
                                 cudaStream_t s) {
  constexpr int N = KMAX <= 16 ? 4 : KMAX <= 32 ? 2 : 1;
  const bool vec = N > 1 && a.C % N == 0 && a.s_q % N == 0 &&
                   a.s_w % N == 0 && a.ldo % N == 0 &&
                   aligned_to(a.y, N * sizeof(Tin)) &&
                   aligned_to(a.out, N * sizeof(Tout)) &&
                   a.Q * (a.C / N) >= (long long)sms * kThreads;
  if constexpr (N > 1)
    if (vec) return launch_rows<Tin, Tout, KMAX, N>(a, sms, s);
  return launch_rows<Tin, Tout, KMAX, 1>(a, sms, s);
}

// Tiles of TQ <= 8 rows (requests) by TC columns, TC * TQ <= kThreads;
// TC starts at a warp's width and halves, down to 4 columns, until there
// are kBlocksPerSm blocks per SM; the threads a smaller tile leaves split
// the unknowns.
template <typename Tin, typename Tout, int KMAX>
static cudaError_t dispatch_transposed(const DecodeArgs& a, int sms,
                                       cudaStream_t s) {
  const int TQ = (int)std::min<long long>(a.Q, 8);
  const long long gy = (a.Q + TQ - 1) / TQ;
  int TC = std::min(32, kThreads / TQ);
  while (TC > 4 && ((a.C + TC - 1) / TC) * gy < (long long)kBlocksPerSm * sms)
    TC /= 2;
  const long long gx = (a.C + TC - 1) / TC;
  if (gx > 0x7fffffffLL || gy > 65535) return cudaErrorInvalidValue;
  constexpr int V = 16 / sizeof(Tin);
  const bool vec = TQ == a.Q && a.s_p == a.Q && (TC * a.s_p) % V == 0 &&
                   a.s_w % V == 0 && aligned_to(a.y, 16);
  const size_t smem = sizeof(float) * ((size_t)a.k * ((a.k + 3) & ~3) +
                                       (size_t)a.k * TC * (TQ | 1));
  return launch_with_smem<decode_transposed_kernel<Tin, Tout, KMAX>>(
      dim3((unsigned)gx, (unsigned)gy), kThreads, smem, s, a, TC, TQ, vec);
}

template <typename Tin, typename Tout>
static cudaError_t dispatch(const DecodeArgs& a, int device, cudaStream_t s) {
  const int sms = sm_count(device);
  if (sms <= 0) return cudaErrorInvalidDevice;
  if (a.s_p == 1) {
    if (a.k <= 16) return dispatch_rows<Tin, Tout, 16>(a, sms, s);
    if (a.k <= 32) return dispatch_rows<Tin, Tout, 32>(a, sms, s);
    return dispatch_rows<Tin, Tout, 64>(a, sms, s);
  }
  // the transposed layout (mv) always stores f32
  if constexpr (!std::is_same_v<Tout, float>) return cudaErrorInvalidValue;
  if (a.k <= 16) return dispatch_transposed<Tin, float, 16>(a, sms, s);
  if (a.k <= 32) return dispatch_transposed<Tin, float, 32>(a, sms, s);
  return dispatch_transposed<Tin, float, 64>(a, sms, s);
}

// geom: y_dtype, out_dtype, k, kb, Q, C, s_w, s_q, s_p, ldo, row_lim,
// col_lim, device -- the call's layout, which the wrapper builds once per
// layout (a launch argument list that short costs the host less).
extern "C" int repro_decode_matmul(const void* hinv, const void* y,
                                   const void* rows, void* out,
                                   const long long* geom, void* stream) {
  const int y_dtype = (int)geom[0], out_dtype = (int)geom[1];
  const int k = (int)geom[2], kb = (int)geom[3], device = (int)geom[12];
  const long long Q = geom[4], C = geom[5], s_q = geom[7], s_p = geom[8];
  if (k < 1 || k > 64 || kb < 1 || k % kb || Q < 1 || C < 1 ||
      (s_p != 1 && s_q != 1))
    return cudaErrorInvalidValue;
  const DecodeArgs a{static_cast<const float*>(hinv), y,
                     static_cast<const int*>(rows), out, k, kb, Q, C,
                     geom[6], s_q, s_p, geom[9], geom[10], geom[11]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  DeviceGuard guard(device);
  if (y_dtype == REPRO_F32 && out_dtype == REPRO_F32)
    return dispatch<float, float>(a, device, s);
  if (y_dtype == REPRO_BF16 && out_dtype == REPRO_F32)
    return dispatch<__nv_bfloat16, float>(a, device, s);
  if (y_dtype == REPRO_BF16 && out_dtype == REPRO_BF16)
    return dispatch<__nv_bfloat16, __nv_bfloat16>(a, device, s);
  return cudaErrorInvalidValue;
}

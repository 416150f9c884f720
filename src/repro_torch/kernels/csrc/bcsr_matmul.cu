// Block-sparse worker product C = A^T B from packed A (see bcsr_matmul.py).
//
// Tiles are 32 x 32 (the cuda backend's packing tile).  One warp (narrow)
// or one block (wide) per (output block-row g, N-tile).  Output block-row g
// belongs to worker
// w = rows[g / mb] (or g / mb without rows) and reads packed block-row
// src = w * mb + g % mb and, when B is given per worker, the B at
// b + w * b_worker_stride.  So one launch covers every live worker of a
// matvec (shared B, stride 0) or of a matmat (one coded B shard each).
//
// It walks only the first counts[src] slots of its block-row: pad
// slots are never read.  Their K-block indices are loaded once into shared
// memory.  The slots' A tiles and the B tiles they select stream through a
// ring of S stages filled by 16-byte cp.async copies, S - 1 slots ahead of
// the one being multiplied, behind one barrier per slot.  Rows of B past K
// and columns past N are zero-filled by the copy; columns past N are never
// written.  When B's rows are not 16-byte aligned (N not a multiple of
// 16 / sizeof(TB)) its tile is staged by plain loads instead.
//
// Two layouts.  In both every output is one f32 accumulator summed over
// the slots and the tile's K rows in order, as the plain version sums them:
//   * narrow (N < 64, the matvec): a warp owns a block-row and an 8-column
//     N-tile, with its own ring, synchronised by __syncwarp only; four
//     independent warps to a block.  Lane = output column c; per K row a
//     lane reads one A value and one broadcast row of 8 B values (8 FMAs
//     for 2-3 shared loads).  Bound by the bytes of A.
//   * wide (N >= 64, the matmat): a block of 256 threads owns a block-row
//     and a 128-column N-tile, each thread a 4 x 4 register tile; per K row
//     one 4-vector of A and one of B (16 FMAs for 2 shared loads).
// bf16 operands are converted to f32 once per slot (f32 FFMA only).
// An index out of range traps.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kTile = 32;

struct BcsrArgs {
  const void* a_data;      // (n_workers * mb, J, 32, 32) TA
  const int* a_idx;        // (n_workers * mb, J)
  const int* counts;       // (n_workers * mb,) or null: all J slots
  const void* b;           // (K, N) or (n_workers, K, N) TB
  long long b_worker_stride;
  const int* rows;         // (n_out / mb,) or null
  float* c;                // (n_out * 32, N)
  int mb, n_workers, J, K, N, n_tiles;
};

// The two layouts (see the top of the file).
constexpr int kNarrow = 0, kWide = 1;

// One ring: STAGES slots of (A tile, B tile), filled by THREADS threads.
// The wide kernel has one ring per block, the narrow one one per warp.
template <typename TA, typename TB, int KIND>
struct Shape {
  static constexpr int BN = KIND == kNarrow ? 8 : 128;
  static constexpr int THREADS = KIND == kNarrow ? 32 : 256;
  static constexpr int STAGES = KIND == kWide ? 3 : 4;
  static constexpr int A_BYTES = kTile * kTile * (int)sizeof(TA);
  static constexpr int B_BYTES = kTile * BN * (int)sizeof(TB);
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int RING = STAGES * STAGE;
  // a bf16 operand is converted to f32 once per slot, into these buffers
  // (the wide kernel A and B, the narrow one B, whose rows every lane
  // reads), so the FMA loop reads f32 only
  static constexpr bool CONVERT_A = KIND == kWide && !std::is_same<TA, float>::value;
  static constexpr bool CONVERT_B = !std::is_same<TB, float>::value;
  static constexpr int F32_BYTES =
      (CONVERT_A ? kTile * kTile * 4 : 0) + (CONVERT_B ? kTile * BN * 4 : 0);
  static constexpr int SMEM = RING + F32_BYTES;   // plus the slot indices
};

// The f32 copy of `n` elements from `src` into `dst`, `per` consecutive
// elements per thread (a multiple of 4, both 16-byte aligned).
template <typename T, int per>
__device__ __forceinline__ void to_f32_buffer(const T* src, float* dst, int n,
                                              int tid, int threads) {
  for (int e = tid * per; e < n; e += threads * per) {
    float v[per];
    load_f32<per>(src + e, v);
#pragma unroll
    for (int i = 0; i < per; i += 4)
      *reinterpret_cast<float4*>(dst + e + i) =
          make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  }
}

constexpr int kNarrowWarps = 4;

// Issue the copies of one slot: its A tile and the B tile its K-block
// selects, columns [n0, n0 + BN).  `tid` counts the ring's threads.
template <typename TA, typename TB, int KIND, bool BVEC>
__device__ __forceinline__ void load_stage(unsigned char* stage,
                                           const TA* a_tile, const TB* b_w,
                                           int kblk, int K, int N, int n0,
                                           int tid) {
  using S = Shape<TA, TB, KIND>;
  for (int q = tid; q < S::A_BYTES / 16; q += S::THREADS)
    cp_async16(stage + q * 16,
               reinterpret_cast<const unsigned char*>(a_tile) + q * 16, true);
  TB* bs = reinterpret_cast<TB*>(stage + S::A_BYTES);
  const int k0 = kblk * kTile;
  if constexpr (BVEC) {
    constexpr int V = 16 / (int)sizeof(TB);
    constexpr int per_row = S::BN / V;
    for (int q = tid; q < kTile * per_row; q += S::THREADS) {
      const int r = q / per_row, cv = (q % per_row) * V;
      const int kr = k0 + r, cn = n0 + cv;
      const bool full = kr < K && cn < N;   // N % V == 0: all or nothing
      const TB* src = full ? b_w + (size_t)kr * N + cn : b_w;
      cp_async16(bs + r * S::BN + cv, src, full);
    }
  } else {
    for (int e = tid; e < kTile * S::BN; e += S::THREADS) {
      const int r = e / S::BN, cn = n0 + e % S::BN, kr = k0 + r;
      bs[e] = (kr < K && cn < N) ? b_w[(size_t)kr * N + cn] : zero_of<TB>();
    }
  }
}

// Where output block-row g reads: its worker's B, its packed block-row and
// that row's real slot count.  Traps on an index out of range.
struct RowSrc {
  int w, src, cnt;
};

__device__ __forceinline__ RowSrc row_source(const BcsrArgs& p, int g) {
  const int w = p.rows ? p.rows[g / p.mb] : g / p.mb;
  if (w < 0 || w >= p.n_workers) __trap();
  const int src = w * p.mb + g % p.mb;
  const int cnt = p.counts ? p.counts[src] : p.J;
  if (cnt < 0 || cnt > p.J) __trap();
  return {w, src, cnt};
}

// The real slots' K-block indices into shared memory, checked.
__device__ __forceinline__ void load_slot_index(const BcsrArgs& p, int src,
                                                int cnt, int* sidx, int tid,
                                                int threads) {
  const int* idx_row = p.a_idx + (size_t)src * p.J;
  for (int j = tid; j < cnt; j += threads) {
    const int kb = idx_row[j];
    if (kb < 0 || (long long)kb * kTile >= p.K) __trap();
    sidx[j] = kb;
  }
}

// The slot loop shared by both layouts: the ring is filled STAGES - 1
// slots ahead of the slot `compute` multiplies; `sync` is the barrier of
// the ring's threads (__syncthreads or __syncwarp).
template <typename TA, typename TB, int KIND, bool BVEC, typename Sync,
          typename Compute>
__device__ __forceinline__ void slot_loop(const BcsrArgs& p, unsigned char* ring,
                                          const int* sidx, const TA* a_row,
                                          const TB* b_w, int cnt, int n0,
                                          int tid, Sync sync,
                                          Compute compute) {
  using S = Shape<TA, TB, KIND>;
#pragma unroll
  for (int s = 0; s < S::STAGES - 1; ++s) {
    if (s < cnt)
      load_stage<TA, TB, KIND, BVEC>(ring + s * S::STAGE,
                                     a_row + (size_t)s * kTile * kTile, b_w,
                                     sidx[s], p.K, p.N, n0, tid);
    cp_async_commit();   // one group per slot, empty past cnt
  }
  for (int j = 0; j < cnt; ++j) {
    cp_async_wait<S::STAGES - 2>();   // slot j's copies have landed
    sync();                           // ... for every thread; stage j-1 free
    const int nxt = j + S::STAGES - 1;
    if (nxt < cnt)
      load_stage<TA, TB, KIND, BVEC>(ring + (nxt % S::STAGES) * S::STAGE,
                                     a_row + (size_t)nxt * kTile * kTile, b_w,
                                     sidx[nxt], p.K, p.N, n0, tid);
    cp_async_commit();
    const unsigned char* stage = ring + (j % S::STAGES) * S::STAGE;
    compute(reinterpret_cast<const TA*>(stage),
            reinterpret_cast<const TB*>(stage + S::A_BYTES));
  }
  cp_async_wait<0>();
}

// Narrow: warp `warp` of the block owns output block-row
// blockIdx.x / n_tiles * kNarrowWarps + warp.
template <typename TA, typename TB, bool BVEC>
__global__ void __launch_bounds__(32 * kNarrowWarps)
bcsr_narrow_kernel(BcsrArgs p, int n_out) {
  using S = Shape<TA, TB, kNarrow>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per_warp = S::SMEM + ((p.J * (int)sizeof(int) + 15) & ~15);
  unsigned char* ring = smem + warp * per_warp;
  float* fb = reinterpret_cast<float*>(ring + S::RING);
  int* sidx = reinterpret_cast<int*>(ring + S::SMEM);

  const int g = blockIdx.x / p.n_tiles * kNarrowWarps + warp;
  const int n0 = (blockIdx.x % p.n_tiles) * S::BN;
  if (g >= n_out) return;           // no block-wide barrier below
  const RowSrc r = row_source(p, g);
  load_slot_index(p, r.src, r.cnt, sidx, lane, 32);
  __syncwarp();

  float acc[8];
#pragma unroll
  for (int n = 0; n < 8; ++n) acc[n] = 0.f;
  const TA* a_row =
      static_cast<const TA*>(p.a_data) + (size_t)r.src * p.J * kTile * kTile;
  const TB* b_w = static_cast<const TB*>(p.b) + (size_t)r.w * p.b_worker_stride;
  slot_loop<TA, TB, kNarrow, BVEC>(
      p, ring, sidx, a_row, b_w, r.cnt, n0, lane, [] { __syncwarp(); },
      [&](const TA* as, const TB* bs) {
        const float* b32;
        if constexpr (S::CONVERT_B) {
          to_f32_buffer<TB, 8>(bs, fb, kTile * S::BN, lane, 32);  // row lane
          __syncwarp();
          b32 = fb;
        } else {
          b32 = bs;
        }
#pragma unroll 8
        for (int kk = 0; kk < kTile; ++kk) {
          const float a = to_f32(as[kk * kTile + lane]);
          float bv[8];
          load_f32<8>(b32 + kk * S::BN, bv);
#pragma unroll
          for (int n = 0; n < 8; ++n) acc[n] = fmaf(a, bv[n], acc[n]);
        }
      });

  float* dst = p.c + ((size_t)g * kTile + lane) * p.N + n0;
  if (aligned16(p.c) && (p.N & 3) == 0) {   // chunks of 4: all or nothing
    *reinterpret_cast<float4*>(dst) = make_float4(acc[0], acc[1], acc[2], acc[3]);
    if (n0 + 4 < p.N)
      *reinterpret_cast<float4*>(dst + 4) =
          make_float4(acc[4], acc[5], acc[6], acc[7]);
  } else {
#pragma unroll
    for (int n = 0; n < 8; ++n)
      if (n0 + n < p.N) dst[n] = acc[n];
  }
}

template <typename TA, typename TB, bool BVEC>
__global__ void __launch_bounds__(256) bcsr_wide_kernel(BcsrArgs p, int n_out) {
  using S = Shape<TA, TB, kWide>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* fa = reinterpret_cast<float*>(smem + S::RING);
  float* fb = fa + (S::CONVERT_A ? kTile * kTile : 0);
  int* sidx = reinterpret_cast<int*>(smem + S::SMEM);
  const int tid = threadIdx.x;
  const int g = blockIdx.x / p.n_tiles;
  const int n0 = (blockIdx.x % p.n_tiles) * S::BN;
  const RowSrc r = row_source(p, g);
  load_slot_index(p, r.src, r.cnt, sidx, tid, S::THREADS);
  __syncthreads();

  // rows 4 tc .. 4 tc + 3 and columns 4 tn .. 4 tn + 3 of the tile
  const int tc = tid & 7, tn = tid >> 3;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jn = 0; jn < 4; ++jn) acc[i][jn] = 0.f;
  const TA* a_row =
      static_cast<const TA*>(p.a_data) + (size_t)r.src * p.J * kTile * kTile;
  const TB* b_w = static_cast<const TB*>(p.b) + (size_t)r.w * p.b_worker_stride;
  slot_loop<TA, TB, kWide, BVEC>(
      p, smem, sidx, a_row, b_w, r.cnt, n0, tid, [] { __syncthreads(); },
      [&](const TA* as, const TB* bs) {
        const float* a32;
        const float* b32;
        if constexpr (S::CONVERT_A) {
          to_f32_buffer<TA, 4>(as, fa, kTile * kTile, tid, S::THREADS);
          a32 = fa;
        } else {
          a32 = as;
        }
        if constexpr (S::CONVERT_B) {
          to_f32_buffer<TB, 8>(bs, fb, kTile * S::BN, tid, S::THREADS);
          b32 = fb;
        } else {
          b32 = bs;
        }
        if constexpr (S::CONVERT_A || S::CONVERT_B) __syncthreads();
#pragma unroll 8
        for (int kk = 0; kk < kTile; ++kk) {
          float av[4], bv[4];
          load_f32<4>(a32 + kk * kTile + 4 * tc, av);
          load_f32<4>(b32 + kk * S::BN + 4 * tn, bv);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int jn = 0; jn < 4; ++jn)
              acc[i][jn] = fmaf(av[i], bv[jn], acc[i][jn]);
        }
      });

  const bool vec_out = aligned16(p.c) && (p.N & 3) == 0;
  const int col = n0 + 4 * tn;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float* dst = p.c + ((size_t)g * kTile + 4 * tc + i) * p.N + col;
    if (vec_out && col + 3 < p.N) {
      *reinterpret_cast<float4*>(dst) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    } else {
#pragma unroll
      for (int jn = 0; jn < 4; ++jn)
        if (col + jn < p.N) dst[jn] = acc[i][jn];
    }
  }
}

template <typename TA, typename TB, int KIND, bool BVEC>
cudaError_t launch(const BcsrArgs& p, int n_out, cudaStream_t stream) {
  using S = Shape<TA, TB, KIND>;
  BcsrArgs q = p;
  q.n_tiles = (p.N + S::BN - 1) / S::BN;
  const size_t idx_bytes = ((size_t)p.J * sizeof(int) + 15) & ~(size_t)15;
  const long long rows =
      KIND == kNarrow ? (n_out + kNarrowWarps - 1) / kNarrowWarps : n_out;
  const long long blocks = rows * q.n_tiles;
  if (blocks <= 0 || blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks);
  if constexpr (KIND == kNarrow)
    return launch_with_smem<bcsr_narrow_kernel<TA, TB, BVEC>>(
        grid, 32 * kNarrowWarps, kNarrowWarps * (S::SMEM + idx_bytes), stream,
        q, n_out);
  else
    return launch_with_smem<bcsr_wide_kernel<TA, TB, BVEC>>(
        grid, S::THREADS, S::SMEM + idx_bytes, stream, q, n_out);
}

template <typename TA, typename TB, int KIND>
cudaError_t launch_b(const BcsrArgs& p, int n_out, cudaStream_t stream) {
  constexpr int V = 16 / (int)sizeof(TB);
  const bool bvec = aligned16(p.b) && p.N % V == 0;
  return bvec ? launch<TA, TB, KIND, true>(p, n_out, stream)
              : launch<TA, TB, KIND, false>(p, n_out, stream);
}

template <typename TA, typename TB>
cudaError_t dispatch(const BcsrArgs& p, int n_out, cudaStream_t stream) {
  return p.N < 64 ? launch_b<TA, TB, kNarrow>(p, n_out, stream)
                  : launch_b<TA, TB, kWide>(p, n_out, stream);
}

}  // namespace

extern "C" int repro_bcsr_matmul(const void* a_data, int a_dtype,
                                 const void* a_idx, const void* counts,
                                 const void* b, int b_dtype,
                                 long long b_worker_stride, const void* rows,
                                 void* c, int n_out, int mb, int n_workers,
                                 int J, int K, int N, int device,
                                 void* stream) {
  if (!aligned16(a_data) || mb <= 0 || n_workers <= 0 || J <= 0 || K <= 0 ||
      N <= 0 || n_out <= 0)
    return cudaErrorInvalidValue;
  BcsrArgs p{a_data, static_cast<const int*>(a_idx),
             static_cast<const int*>(counts), b, b_worker_stride,
             static_cast<const int*>(rows), static_cast<float*>(c),
             mb, n_workers, J, K, N, 1};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  DeviceGuard guard(device);
  if (a_dtype == REPRO_F32 && b_dtype == REPRO_F32)
    return dispatch<float, float>(p, n_out, s);
  if (a_dtype == REPRO_F32 && b_dtype == REPRO_BF16)
    return dispatch<float, __nv_bfloat16>(p, n_out, s);
  if (a_dtype == REPRO_BF16 && b_dtype == REPRO_F32)
    return dispatch<__nv_bfloat16, float>(p, n_out, s);
  if (a_dtype == REPRO_BF16 && b_dtype == REPRO_BF16)
    return dispatch<__nv_bfloat16, __nv_bfloat16>(p, n_out, s);
  return cudaErrorInvalidValue;
}

// Block-sparse worker product C = A^T B from packed A (see bcsr_matmul.py).
//
// Tiles are 32 x 32 (the cuda backend's packing tile).  Output block-row g
// belongs to worker w = rows[g / mb] (or g / mb without rows) and reads
// packed block-row src = w * mb + g % mb and, when B is given per worker,
// the B at b + w * b_worker_stride.  So one launch covers every live worker
// of a matvec (shared B, stride 0) or of a matmat (one coded B shard each).
// A block-row walks only its first counts[src] slots (pad slots are never
// read), in order; their K-block indices are loaded once into shared memory
// and checked.  Rows of B past K are zero-filled; columns past N are never
// written.  Every output is one f32 FFMA chain over the slots and the
// tile's K rows in order, as the plain version sums it: no split of K, no
// reduction across lanes, no atomics.  An index out of range traps.
//
// Two layouts, by N:
//   * narrow (N < 64, every matvec): bound by the bytes of A.  The old
//     narrow kernel staged B by plain loads unless its rows were 16-byte
//     aligned (the warp stalled once a slot), computed 8 columns at every
//     N and left a fraction of a wave at the end of a large grid.  Here
//     one warp owns one (block-row, column tile): lane = output column c,
//     NC = N columns of B (N <= 8; tiles of 8 above), so no FMA or B load
//     is spent past N.  Each warp streams its block-row's slots through
//     its own ring of 3 stages.  Lane 0 brings a slot's 32 x 32 A tile in
//     with one bulk copy (TMA) and, when the slot's 32 rows of B are
//     whole and 16-byte aligned (N <= 8, B contiguous), its B tile with
//     another, both completed on the stage's mbarrier: the lanes spend no
//     instruction on copies.  Otherwise the lanes stage B by 16- or
//     4-byte cp.async (plain loads only for a bf16 B of odd width or one
//     not 4-byte aligned).  Each K row's NC values of B are read by the
//     widest loads its alignment allows, known when compiled, since what
//     bounds the FMA loop is shared-memory loads; a bf16 B tile is widened
//     to f32 once a slot.  Warps are persistent: one-warp blocks, as many
//     as the card holds at once (its SM count times the blocks an SM holds
//     at this shared memory), cut so that every warp walks the same number
//     of tasks, give or take one, and the last round is full.  The code
//     is kept small (one fill site, rare B paths out of line): on grids
//     of a few warps an SM a larger kernel measured slower.
//   * wide (N >= 64, the matmat): a block of 256 threads owns a block-row
//     and a 128-column N-tile, each thread a 4 x 4 register tile; per K row
//     one 4-vector of A and one of B (16 FMAs for 2 shared loads).  Its
//     slots' A and B tiles stream through a ring of 3 stages filled by
//     16-byte cp.async copies, behind one barrier per slot; when B's rows
//     are not 16-byte aligned its tile is staged by plain loads.
// bf16 A is widened to f32 exactly; B is read as the f32 or bf16 it is
// given, a bf16 tile widened to f32 once per slot.  The products are f32
// FFMA only.
#include <mutex>
#include <type_traits>
#include <utility>

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

// One ring: STAGES slots of (A tile, B tile), filled by THREADS threads,
// one per block of the wide kernel.  (The narrow kernel has its own,
// `Narrow` below.)
template <typename TA, typename TB, int KIND>
struct Shape {
  static constexpr int BN = KIND == kNarrow ? 8 : 128;
  static constexpr int THREADS = KIND == kNarrow ? 32 : 256;
  static constexpr int STAGES = KIND == kWide ? 3 : 4;
  static constexpr int A_BYTES = kTile * kTile * (int)sizeof(TA);
  static constexpr int B_BYTES = kTile * BN * (int)sizeof(TB);
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int RING = STAGES * STAGE;
  // a bf16 operand is converted to f32 once per slot, into these buffers,
  // so the FMA loop reads f32 only
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

// --- narrow: one warp per (block-row, column tile), persistent ------------

constexpr int kNarrowStages = 3;

// How the lanes stage a slot's B tile (chosen on the host from N, the
// column count and B's alignment).  With N == NC (N <= 8) the tile is 32
// whole rows of B, contiguous: 16- or 4-byte chunks of it.  Column tiles
// (N > 8) go row by row in 16- or 4-byte chunks.  Else plain loads.
enum BStaging : int { kFlat16, kFlat4, kRows16, kRows4, kPlain };

// One warp's shared memory: a ring of kNarrowStages (A tile, B tile)
// stages, one mbarrier a stage, a bf16 B tile widened to f32 (the slot
// being multiplied, once, rather than every value in every K row), then
// the block-row's slot indices.
template <typename TA, typename TB, int NC>
struct Narrow {
  static constexpr int A_BYTES = kTile * kTile * (int)sizeof(TA);
  static constexpr int B_BYTES = kTile * NC * (int)sizeof(TB);   // 64 B x k
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int RING = kNarrowStages * STAGE;
  static constexpr int BARS = (kNarrowStages * 8 + 15) & ~15;
  static constexpr bool WIDEN_B = !std::is_same<TB, float>::value;
  static constexpr int F32_B = WIDEN_B ? kTile * NC * 4 : 0;
  static size_t smem(int J) {
    return RING + BARS + F32_B +
           (((size_t)J * sizeof(int) + 15) & ~(size_t)15);
  }
};

// Values I .. NC - 1 of a B row in shared memory as f32, the row starting
// OFF bytes past a multiple of 16: each load the widest that the address
// and the values left allow (a row of 5 f32 takes 2-3 loads, not 5).
template <int NC, int OFF, int I = 0>
__device__ __forceinline__ void load_row(const float* p, float (&v)[NC]) {
  if constexpr (I < NC) {
    constexpr int at = (OFF + 4 * I) % 16;
    if constexpr (at == 0 && NC - I >= 4) {
      const float4 x = *reinterpret_cast<const float4*>(p + I);
      v[I] = x.x; v[I + 1] = x.y; v[I + 2] = x.z; v[I + 3] = x.w;
      load_row<NC, OFF, I + 4>(p, v);
    } else if constexpr (at % 8 == 0 && NC - I >= 2) {
      const float2 x = *reinterpret_cast<const float2*>(p + I);
      v[I] = x.x; v[I + 1] = x.y;
      load_row<NC, OFF, I + 2>(p, v);
    } else {
      v[I] = p[I];
      load_row<NC, OFF, I + 1>(p, v);
    }
  }
}

// K row I of eight: a = A[I][lane] (at `as`, the lane's column of the
// first), the NC values of B's row I (at `bs`, the first of the eight,
// 16-byte aligned), one FMA into each column's sum.
template <int NC, int I, typename TA>
__device__ __forceinline__ void fma_row(const TA* as, const float* bs,
                                        float (&acc)[NC]) {
  const float a = to_f32(as[I * kTile]);
  float bv[NC];
  load_row<NC, I * NC * 4 % 16>(bs + I * NC, bv);
#pragma unroll
  for (int n = 0; n < NC; ++n) acc[n] = fmaf(a, bv[n], acc[n]);
}

// Eight K rows in order.  Eight rows of B are 32 * NC bytes, so each
// row's offset from 16-byte alignment is known when compiled.
template <int NC, typename TA, int... I>
__device__ __forceinline__ void fma_rows(const TA* as, const float* bs,
                                         float (&acc)[NC],
                                         std::integer_sequence<int, I...>) {
  (fma_row<NC, I>(as, bs, acc), ...);
}

// One CH-byte (16 or 4) cp.async chunk: its first n bytes from `src`, the
// rest zero-filled.
template <int CH>
__device__ __forceinline__ void cp_chunk(unsigned char* dst,
                                         const unsigned char* src, int n) {
  if constexpr (CH == 16)
    cp_async16_n(dst, src, n);
  else
    cp_async4(dst, src, n);
}

// N == NC: the tile is B's 32 * NC elements from row k0 on, whole; the
// chunk that holds B's end is cut there and the rest zero-filled.
template <int CH, typename TB, int NC>
__device__ __forceinline__ void stage_b_flat(TB* bs, const TB* b_w, int k0,
                                             int K, int lane) {
  constexpr int CHUNKS = kTile * NC * (int)sizeof(TB) / CH;
  const auto* src =
      reinterpret_cast<const unsigned char*>(b_w + (size_t)k0 * NC);
  const long long left = (long long)(K - k0) * NC * (long long)sizeof(TB);
  for (int q = lane; q < CHUNKS; q += 32) {
    const long long rest = left - (long long)CH * q;
    const int n = rest >= CH ? CH : (rest > 0 ? (int)rest : 0);
    cp_chunk<CH>(reinterpret_cast<unsigned char*>(bs) + CH * q,
                 n ? src + CH * q : src, n);
  }
}

// Column tiles: rows k0 .. k0 + 31, columns n0 .. n0 + NC - 1, row by row.
// A chunk of a row past K is zero-filled, one past N is never copied (its
// column is never written).  B's row length and alignment are whole
// chunks (checked on the host), so a chunk is all in N or all out.
template <int CH, typename TB, int NC>
__device__ __forceinline__ void stage_b_rows(TB* bs, const TB* b_w, int k0,
                                             int K, int N, int n0, int lane) {
  constexpr int E = CH / (int)sizeof(TB);   // elements a chunk
  if constexpr (NC % E == 0) {
    constexpr int PER_ROW = NC / E;
    for (int q = lane; q < kTile * PER_ROW; q += 32) {
      const int r = q / PER_ROW, cn = (q % PER_ROW) * E, n = n0 + cn;
      if (n >= N) continue;
      const bool in = k0 + r < K;
      const TB* src = in ? b_w + (size_t)(k0 + r) * N + n : b_w;
      cp_chunk<CH>(reinterpret_cast<unsigned char*>(bs + r * NC + cn),
                   reinterpret_cast<const unsigned char*>(src), in ? CH : 0);
    }
  }
}

// Out of line: the kernel's hot path copies B in bulk (see fill below).
template <typename TB, int NC>
__device__ __noinline__ void stage_b(TB* bs, const TB* b_w, int k0, int K,
                                     int N, int n0, int mode, int lane) {
  switch (mode) {
    case kFlat16: stage_b_flat<16, TB, NC>(bs, b_w, k0, K, lane); break;
    case kFlat4: stage_b_flat<4, TB, NC>(bs, b_w, k0, K, lane); break;
    case kRows16: stage_b_rows<16, TB, NC>(bs, b_w, k0, K, N, n0, lane); break;
    case kRows4: stage_b_rows<4, TB, NC>(bs, b_w, k0, K, N, n0, lane); break;
    default:
      for (int e = lane; e < kTile * NC; e += 32) {
        const int r = e / NC, n = n0 + e % NC;
        bs[e] = (k0 + r < K && n < N) ? b_w[(size_t)(k0 + r) * N + n]
                                      : zero_of<TB>();
      }
  }
}

// Narrow: each one-warp block walks tasks blockIdx.x, + gridDim.x, ...;
// task t is output block-row t / n_tiles, columns (t % n_tiles) * NC on.
// Lane = the output column c of the block-row's 32.
template <typename TA, typename TB, int NC>
__global__ void __launch_bounds__(32)
bcsr_narrow_kernel(BcsrArgs p, int n_tasks, int b_mode) {
  using S = Narrow<TA, TB, NC>;
  constexpr int ST = kNarrowStages;
  extern __shared__ __align__(16) unsigned char smem[];
  auto* bars = reinterpret_cast<std::uint64_t*>(smem + S::RING);
  float* fb = reinterpret_cast<float*>(smem + S::RING + S::BARS);
  int* sidx = reinterpret_cast<int*>(smem + S::RING + S::BARS + S::F32_B);
  const int lane = threadIdx.x;
  if (lane == 0) {
    for (int s = 0; s < ST; ++s) mbar_init(bars + s, 1);
    mbar_fence_init();
  }
  __syncwarp();

  // the ring's next stage to fill, and to read with the parity of its use
  int fill_at = 0, read_at = 0;
  unsigned parity = 0;
  for (int task = blockIdx.x; task < n_tasks; task += gridDim.x) {
    const int g = task / p.n_tiles, n0 = (task % p.n_tiles) * NC;
    const RowSrc r = row_source(p, g);
    __syncwarp();     // the last task's reads of the ring and indices are done
    load_slot_index(p, r.src, r.cnt, sidx, lane, 32);
    __syncwarp();
    const TA* a_row =
        static_cast<const TA*>(p.a_data) + (size_t)r.src * p.J * kTile * kTile;
    const TB* b_w =
        static_cast<const TB*>(p.b) + (size_t)r.w * p.b_worker_stride;
    // slot j into the next stage: its A tile by one bulk copy and, when the
    // tile lies whole in B's contiguous rows, its B tile by another, both
    // from lane 0 and completed on the stage's mbarrier; else the lanes
    // stage B by cp.async
    auto fill = [&](int j) {
      unsigned char* stage = smem + fill_at * S::STAGE;
      std::uint64_t* bar = bars + fill_at;
      fill_at = fill_at + 1 == ST ? 0 : fill_at + 1;
      const int k0 = sidx[j] * kTile;
      const bool bulk_b = b_mode == kFlat16 && k0 + kTile <= p.K;
      if (lane == 0) {
        mbar_expect_tx(bar, S::A_BYTES + (bulk_b ? S::B_BYTES : 0));
        bulk_copy_g2s(stage, a_row + (size_t)j * kTile * kTile, S::A_BYTES,
                      bar);
        if (bulk_b)
          bulk_copy_g2s(stage + S::A_BYTES, b_w + (size_t)k0 * NC,
                        S::B_BYTES, bar);
      }
      if (!bulk_b)
        stage_b<TB, NC>(reinterpret_cast<TB*>(stage + S::A_BYTES), b_w, k0,
                        p.K, p.N, n0, b_mode, lane);
    };

    float acc[NC];
#pragma unroll
    for (int n = 0; n < NC; ++n) acc[n] = 0.f;
    // step j fills slot j + ST - 1 and, from j = 0 on, multiplies slot j:
    // the first ST - 1 steps only fill (one fill site keeps the code small)
    for (int j = 1 - ST; j < r.cnt; ++j) {
      if (j >= 0) {
        cp_async_wait<ST - 2>();            // this lane's copies of slot j
        mbar_wait(bars + read_at, parity);  // the bulk copies of slot j
        __syncwarp();                       // every lane's; slot j-1 is free
      }
      if (j + ST - 1 < r.cnt) fill(j + ST - 1);
      cp_async_commit();                    // one group a slot, maybe empty
      if (j < 0) continue;
      const unsigned char* stage = smem + read_at * S::STAGE;
      if (++read_at == ST) read_at = 0, parity ^= 1;
      const TA* as = reinterpret_cast<const TA*>(stage) + lane;
      const float* b32;
      if constexpr (S::WIDEN_B) {
        const TB* bs = reinterpret_cast<const TB*>(stage + S::A_BYTES);
        if constexpr (NC % 4 == 0) {   // row `lane`, whole 8-byte pieces
#pragma unroll
          for (int i = 0; i < NC; i += 4) {
            float v[4];
            load_f32<4>(bs + lane * NC + i, v);
            *reinterpret_cast<float4*>(fb + lane * NC + i) =
                make_float4(v[0], v[1], v[2], v[3]);
          }
        } else {
          for (int e = lane; e < kTile * NC; e += 32) fb[e] = to_f32(bs[e]);
        }
        __syncwarp();
        b32 = fb;
      } else {
        b32 = reinterpret_cast<const float*>(stage + S::A_BYTES);
      }
#pragma unroll
      for (int k8 = 0; k8 < kTile; k8 += 8)
        fma_rows<NC>(as + k8 * kTile, b32 + k8 * NC, acc,
                     std::make_integer_sequence<int, 8>{});
    }
    cp_async_wait<0>();

    float* dst = p.c + ((size_t)g * kTile + lane) * p.N + n0;
    bool stored = false;
    if constexpr (NC % 4 == 0) {
      if (aligned16(p.c) && (p.N & 3) == 0) {   // chunks of 4: all or nothing
#pragma unroll
        for (int n = 0; n < NC; n += 4)
          if (n0 + n < p.N)
            *reinterpret_cast<float4*>(dst + n) =
                make_float4(acc[n], acc[n + 1], acc[n + 2], acc[n + 3]);
        stored = true;
      }
    }
    if (!stored) {
#pragma unroll
      for (int n = 0; n < NC; ++n)
        if (n0 + n < p.N) dst[n] = acc[n];
    }
  }
}

template <typename TA, typename TB, bool BVEC>
cudaError_t launch_wide(const BcsrArgs& p, int n_out, cudaStream_t stream) {
  using S = Shape<TA, TB, kWide>;
  BcsrArgs q = p;
  q.n_tiles = (p.N + S::BN - 1) / S::BN;
  const size_t idx_bytes = ((size_t)p.J * sizeof(int) + 15) & ~(size_t)15;
  const long long blocks = (long long)n_out * q.n_tiles;
  if (blocks <= 0 || blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  return launch_with_smem<bcsr_wide_kernel<TA, TB, BVEC>>(
      dim3((unsigned)blocks), S::THREADS, S::SMEM + idx_bytes, stream, q,
      n_out);
}

// What the launch geometry reads of a card, once per device.
struct Card {
  int sms = 0, smem_per_sm = 0, reserved_per_block = 0, blocks_per_sm = 0;
};

constexpr int kDevices = 64;

const Card* card_of(int dev) {
  static Card cards[kDevices];
  static std::once_flag once[kDevices];
  if (dev < 0 || dev >= kDevices) return nullptr;
  std::call_once(once[dev], [dev] {
    Card c;
    if (cudaDeviceGetAttribute(&c.sms, cudaDevAttrMultiProcessorCount, dev) ==
            cudaSuccess &&
        cudaDeviceGetAttribute(&c.smem_per_sm,
                               cudaDevAttrMaxSharedMemoryPerMultiprocessor,
                               dev) == cudaSuccess &&
        cudaDeviceGetAttribute(&c.reserved_per_block,
                               cudaDevAttrReservedSharedMemoryPerBlock,
                               dev) == cudaSuccess &&
        cudaDeviceGetAttribute(&c.blocks_per_sm,
                               cudaDevAttrMaxBlocksPerMultiprocessor,
                               dev) == cudaSuccess)
      cards[dev] = c;
  });
  return cards[dev].sms > 0 ? &cards[dev] : nullptr;
}

// Persistent one-warp blocks for `tasks` equal tasks: as many as the card
// holds at once at `smem` bytes a block, cut to the fewest that still take
// the tasks in the same number of rounds, so that every warp has that many
// tasks or one fewer.
long long narrow_blocks(long long tasks, size_t smem, const Card& card) {
  const size_t per_block = ((smem + 127) & ~(size_t)127) +
                           (size_t)card.reserved_per_block;
  long long per_sm = (long long)card.smem_per_sm / (long long)per_block;
  if (per_sm > card.blocks_per_sm) per_sm = card.blocks_per_sm;
  if (per_sm < 1) per_sm = 1;
  const long long resident = per_sm * card.sms;
  const long long rounds = (tasks + resident - 1) / resident;
  return (tasks + rounds - 1) / rounds;
}

// How the lanes stage B's tile (see BStaging): the widest cp.async chunk
// that B's base, its per-worker stride and its row length all allow.
template <typename TB, int NC>
int b_staging(const BcsrArgs& p, int n_tiles) {
  constexpr long long sz = sizeof(TB);
  const auto base = reinterpret_cast<std::uintptr_t>(p.b);
  const long long stride = p.b_worker_stride * sz, row = p.N * sz;
  auto fits = [&](long long ch) {
    return base % ch == 0 && stride % ch == 0;
  };
  if (n_tiles == 1 && p.N == NC) {
    if (fits(16)) return kFlat16;
    return fits(4) ? kFlat4 : kPlain;
  }
  if (row % 16 == 0 && fits(16)) return kRows16;
  if (row % 4 == 0 && fits(4)) return kRows4;
  return kPlain;
}

template <typename TA, typename TB, int NC>
cudaError_t launch_narrow(const BcsrArgs& p, int n_out, int dev,
                          cudaStream_t stream) {
  using S = Narrow<TA, TB, NC>;
  constexpr auto kernel = bcsr_narrow_kernel<TA, TB, NC>;
  BcsrArgs q = p;
  q.n_tiles = (p.N + NC - 1) / NC;
  const long long tasks = (long long)n_out * q.n_tiles;
  const Card* card = card_of(dev);
  if (tasks <= 0 || tasks > 0x7fffffffLL || card == nullptr)
    return cudaErrorInvalidValue;
  // the geometry counts on the largest shared-memory carveout
  static std::once_flag once[kDevices];
  static cudaError_t carveout[kDevices];
  std::call_once(once[dev], [dev] {
    carveout[dev] = cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
        (int)cudaSharedmemCarveoutMaxShared);
  });
  if (carveout[dev] != cudaSuccess) return carveout[dev];
  const size_t smem = S::smem(p.J);
  return launch_with_smem<kernel>(
      dim3((unsigned)narrow_blocks(tasks, smem, *card)), 32, smem, stream, q,
      (int)tasks, b_staging<TB, NC>(q, q.n_tiles));
}

template <typename TA, typename TB>
cudaError_t dispatch(const BcsrArgs& p, int n_out, int dev,
                     cudaStream_t stream) {
  if (p.N >= 64) {
    constexpr int V = 16 / (int)sizeof(TB);
    const bool bvec = aligned16(p.b) && p.N % V == 0;
    return bvec ? launch_wide<TA, TB, true>(p, n_out, stream)
                : launch_wide<TA, TB, false>(p, n_out, stream);
  }
  switch (p.N) {
    case 1: return launch_narrow<TA, TB, 1>(p, n_out, dev, stream);
    case 2: return launch_narrow<TA, TB, 2>(p, n_out, dev, stream);
    case 3: return launch_narrow<TA, TB, 3>(p, n_out, dev, stream);
    case 4: return launch_narrow<TA, TB, 4>(p, n_out, dev, stream);
    case 5: return launch_narrow<TA, TB, 5>(p, n_out, dev, stream);
    case 6: return launch_narrow<TA, TB, 6>(p, n_out, dev, stream);
    case 7: return launch_narrow<TA, TB, 7>(p, n_out, dev, stream);
    default: return launch_narrow<TA, TB, 8>(p, n_out, dev, stream);
  }
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
    return dispatch<float, float>(p, n_out, device, s);
  if (a_dtype == REPRO_F32 && b_dtype == REPRO_BF16)
    return dispatch<float, __nv_bfloat16>(p, n_out, device, s);
  if (a_dtype == REPRO_BF16 && b_dtype == REPRO_F32)
    return dispatch<__nv_bfloat16, float>(p, n_out, device, s);
  if (a_dtype == REPRO_BF16 && b_dtype == REPRO_BF16)
    return dispatch<__nv_bfloat16, __nv_bfloat16>(p, n_out, device, s);
  return cudaErrorInvalidValue;
}

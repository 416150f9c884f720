// The held experts' SwiGLU FFN of a decode step, over the slots routed to
// them (see held_experts.py):
//   y[slot] = w[slot] * (silu(x[token] Wg[e]) * (x[token] Wu[e])) Wd[e]
//   out[token] = sum, in top-k order, of y over the token's held slots.
//
// Replaces no TPU kernel: the JAX package has no held-expert path.  It was
// added because the decode step ran every held expert over every token (8
// experts x 1024 rows for ~171 routed slots, ~48x the products) and
// weighted and summed the (8, t, d) result in f32, ~5 ms of a Kimi-K2
// decode step on an H100, since a path sized by the routed slots needed a
// host read of the counts.
//
// What bounds it: bytes.  Each held expert's three matrices (3 x 7168 x
// 2048 bf16, 88 MB) are read once for the ~21 tokens routed to it: ~21
// flops a byte, far under the ~295 at which the tensor cores would set the
// pace.  The slot lists (`order`, `ends`) are built on the card, so
// nothing waits on the host.
//
// The design, five launches on one stream:
//   * sort: the slot lists, a stable counting sort of the keys in one
//     block (one launch where a library sort takes seven);
//   * gather: the routed rows of x into an expert-ordered bf16 buffer,
//     only the n = ends[held - 1] rows there are (read on the card);
//   * gate and up (held_ffn_kernel<true>): a block per (expert, 64 columns
//     of the intermediate width).  One producer thread streams the
//     expert's 64 x 64 tiles of x, Wg and Wu through a four-stage ring by
//     TMA in the swizzled layout wgmma reads (of x only the 16-row boxes
//     that hold the expert's slots); one consumer warpgroup adds x Wg and
//     x Wu into f32 registers (64 rows, those past its count stale and
//     never stored) and stores
//     silu(g) u once, in bf16, as the plain chain feeds Wd a bf16
//     operand.  An expert of more than 64 slots walks its rows in tiles
//     of 64; one of none exits;
//   * down (held_ffn_kernel<false>): a block per (expert, 64 columns of
//     the hidden width), Wd through a six-stage ring, each slot's f32 row
//     times its routing weight written at the slot's (token, place);
//   * combine: each token's held slots summed in top-k order in f32, no
//     atomics, so two calls on the same input are bitwise equal.
#include <cmath>

#include "common.cuh"

namespace {

constexpr int kRows = 64;    // an expert's rows a tile: one wgmma M tile
constexpr int kCols = 64;    // a chunk of output columns; the depth a stage
constexpr int kBoxRows = 16; // the gathered rows' TMA box: the rows a tile has
constexpr int kTile = kSwizzledTileBytes;   // a weight chunk's 64 x 64 tile
constexpr int kConsumers = 128;             // one warpgroup
constexpr int kThreads = kConsumers + 32;   // and the producer's warp

// A stage: the tile's gathered rows (64 x 64), then the matrices' 64 x 64
// tiles (Wg and Wu, or Wd).  96 KB of stages, two blocks an SM.
template <bool kGateUp>
struct Ffn {
  static constexpr int kWeightBytes = (kGateUp ? 2 : 1) * kTile;
  static constexpr int kStageBytes = kTile + kWeightBytes;
  static constexpr int kStages = kGateUp ? 4 : 6;
  static constexpr int kBarOff = kStages * kStageBytes;
  static constexpr int kSmem = kBarOff + 2 * kStages * 8 + 1024;
};

struct FfnArgs {
  const long long* ends;    // (held + 1): expert e's slots are ends[e-1] ..
  const long long* order;   // (t k): each slot's token * k + place
  const float* weights;     // (t k): each (token, place)'s routing weight
  void* out;                // h (slots, fe) bf16, or y (t k, d) f32
  int depth, width;         // the contraction, and the output's width
};

// A 64 x 64 box of a 2-d tensor map into shared memory, completed on `bar`.
__device__ __forceinline__ void tma_tile(void* dst, const CUtensorMap* map,
                                         int col, int row,
                                         std::uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<std::uint64_t>(map)), "r"(col), "r"(row),
      "r"(smem_u32(bar))
      : "memory");
}

// D (64 x 64, f32) += A (64 x 16) B (16 x 64), A K-major and B MN-major,
// both bf16 in shared memory behind descriptors.
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], std::uint64_t a,
                                            std::uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

// Block (64 output columns blockIdx.x, expert blockIdx.y).  A: the expert's gathered rows (x, or h), as many 16-row
// boxes as the tile has rows (the rest of its 64 keep stale values, whose
// product rows are never stored); B: its matrix (Wg and Wu, or Wd), all
// experts' rows stacked, so expert e's start at row e * depth.
template <bool kGateUp>
__global__ void __launch_bounds__(kThreads, 2)
    held_ffn_kernel(const __grid_constant__ CUtensorMap am,
                    const __grid_constant__ CUtensorMap bm0,
                    const __grid_constant__ CUtensorMap bm1,
                    const FfnArgs p) {
  using S = Ffn<kGateUp>;
  constexpr int kStages = S::kStages, kAcc = kGateUp ? 2 : 1;
  const int e = blockIdx.y, n0 = blockIdx.x * kCols;
  const long long lo = e ? p.ends[e - 1] : 0;
  const int count = (int)(p.ends[e] - lo);
  if (count <= 0) return;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  auto* bars = reinterpret_cast<std::uint64_t*>(smem + S::kBarOff);
  std::uint64_t *full = bars, *empty = bars + kStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);                    // the producer
      mbar_init(&empty[s], kConsumers / 32);     // each consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int steps = p.depth / kCols, tiles = (count + kRows - 1) / kRows;

  if (threadIdx.x >= kConsumers) {
    if (threadIdx.x != kConsumers) return;
    int it = 0;
    for (int m = 0; m < tiles; ++m) {
      const int rows = min(count - m * kRows, kRows);
      const int boxes = (rows + kBoxRows - 1) / kBoxRows;
      for (int k = 0; k < steps; ++k, ++it) {
        const int s = it % kStages;
        mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
        unsigned char* stage = smem + s * S::kStageBytes;
        const int b_row = e * p.depth + k * kCols;
        mbar_expect_tx(&full[s], boxes * (kTile / (kRows / kBoxRows)) +
                                     S::kWeightBytes);
        for (int b = 0; b < boxes; ++b)
          tma_tile(stage + b * kBoxRows * 128, &am, k * kCols,
                   (int)lo + m * kRows + b * kBoxRows, &full[s]);
        tma_tile(stage + kTile, &bm0, n0, b_row, &full[s]);
        if constexpr (kGateUp)
          tma_tile(stage + 2 * kTile, &bm1, n0, b_row, &full[s]);
      }
    }
    return;
  }

  const int t = threadIdx.x, lane = t & 31;
  // an accumulator's element 4 j + 2 h + i sits at row r0 + 8 h and
  // column 8 j + cq + i
  const int r0 = (t >> 5) * 16 + (lane >> 2), cq = 2 * (lane & 3);
  int it = 0;
  for (int m = 0; m < tiles; ++m) {
    // x Wg (or h Wd) sums into acc[0], x Wu into acc[1]
    float acc[kAcc][32];
#pragma unroll
    for (int a = 0; a < kAcc; ++a)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[a][i] = 0.f;
    for (int k = 0; k < steps; ++k, ++it) {
      const int s = it % kStages;
      mbar_wait(&full[s], (it / kStages) & 1);
      const unsigned a = smem_u32(smem + s * S::kStageBytes);
#pragma unroll
      for (int q = 0; q < kAcc; ++q) fence_regs(acc[q]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int q = 0; q < kAcc; ++q)
          wgmma_m64n64k16(acc[q], kmajor(a + kk * 32),
                          mnmajor(a + (1 + q) * kTile + kk * 16 * 128));
      wgmma_commit();
      wgmma_wait();
#pragma unroll
      for (int q = 0; q < kAcc; ++q) fence_regs(acc[q]);
      if (lane == 0) mbar_arrive(&empty[s]);
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m * kRows + r0 + 8 * h;
      if (row >= count) continue;
      if constexpr (kGateUp) {
        __nv_bfloat16* dst = static_cast<__nv_bfloat16*>(p.out) +
                             (lo + row) * p.width + n0 + cq;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int i = 4 * j + 2 * h;
          const float g0 = acc[0][i], g1 = acc[0][i + 1];
          *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
              __floats2bfloat162_rn(g0 / (1.f + expf(-g0)) * acc[1][i],
                                    g1 / (1.f + expf(-g1)) * acc[1][i + 1]);
        }
      } else {
        const long long slot = p.order[lo + row];
        const float w = p.weights[slot];
        float* dst = static_cast<float*>(p.out) + slot * p.width + n0 + cq;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<float2*>(dst + 8 * j) =
              make_float2(acc[0][4 * j + 2 * h] * w,
                          acc[0][4 * j + 2 * h + 1] * w);
      }
    }
  }
}

// The slot lists from the keys, on the card: order[ends[b-1] + r] is the
// r-th flat place (token * k + j, increasing) keyed b, so each held
// expert's slots are in token order and the places held nowhere last;
// ends[b] counts them through.  One block: each thread owns consecutive
// tokens, and the keys go four at a time, each pass one block-wide scan
// of the four keys' counts over the threads.
constexpr int kSortThreads = 1024;

__device__ __forceinline__ int4 operator+(int4 a, int4 b) {
  return make_int4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}
__device__ __forceinline__ int4 operator-(int4 a, int4 b) {
  return make_int4(a.x - b.x, a.y - b.y, a.z - b.z, a.w - b.w);
}
__device__ __forceinline__ int4 shfl_up(int4 v, int by) {
  return make_int4(__shfl_up_sync(0xffffffffu, v.x, by),
                   __shfl_up_sync(0xffffffffu, v.y, by),
                   __shfl_up_sync(0xffffffffu, v.z, by),
                   __shfl_up_sync(0xffffffffu, v.w, by));
}
// An inclusive scan over a warp's lanes.
__device__ __forceinline__ int4 warp_scan(int4 v, int lane) {
#pragma unroll
  for (int by = 1; by < 32; by <<= 1) {
    const int4 u = shfl_up(v, by);
    if (lane >= by) v = v + u;
  }
  return v;
}
// One of four counters, by the key's offset q = 0 .. 3 (no local memory).
__device__ __forceinline__ void bump(int4& c, long long q) {
  c.x += q == 0;
  c.y += q == 1;
  c.z += q == 2;
  c.w += q == 3;
}

__global__ void __launch_bounds__(kSortThreads)
    held_sort_kernel(const long long* key, long long* order, long long* ends,
                     int t, int k, int bins) {
  __shared__ int4 warp_sums[kSortThreads / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (t + kSortThreads - 1) / kSortThreads;
  const long long lo = (long long)min(tid * per, t) * k,
                  hi = (long long)min(tid * per + per, t) * k;
  long long base = 0;    // the first slot of key b0, the same in every thread
  for (int b0 = 0; b0 < bins; b0 += 4) {
    int4 c = make_int4(0, 0, 0, 0);
    for (long long i = lo; i < hi; ++i) bump(c, key[i] - b0);
    const int4 inc = warp_scan(c, lane);
    if (lane == 31) warp_sums[warp] = inc;
    __syncthreads();
    if (warp == 0) warp_sums[lane] = warp_scan(warp_sums[lane], lane);
    __syncthreads();
    const int4 total = warp_sums[kSortThreads / 32 - 1];
    const int4 mine = (warp ? warp_sums[warp - 1] : make_int4(0, 0, 0, 0)) +
                      inc - c;
    const long long s0 = base, s1 = s0 + total.x, s2 = s1 + total.y,
                    s3 = s2 + total.z;
    long long at0 = s0 + mine.x, at1 = s1 + mine.y, at2 = s2 + mine.z,
              at3 = s3 + mine.w;
    for (long long i = lo; i < hi; ++i) {
      const long long q = key[i] - b0;
      if (q == 0) order[at0++] = i;
      else if (q == 1) order[at1++] = i;
      else if (q == 2) order[at2++] = i;
      else if (q == 3) order[at3++] = i;
    }
    if (tid < 4 && b0 + tid < bins)
      ends[b0 + tid] = (tid == 0 ? s1 : tid == 1 ? s2 : tid == 2 ? s3
                                                     : s3 + total.w);
    base = s3 + total.w;
    __syncthreads();     // warp_sums is the next pass's
  }
}

// Slot s < n of the expert order takes row order[s] / k of x: a block a
// row, in 16-byte pieces.
__global__ void __launch_bounds__(256)
    held_gather_kernel(const uint4* x, const long long* order,
                       const long long* ends, uint4* xs, int held, int k,
                       int pieces) {
  const long long n = ends[held - 1];
  for (long long s = blockIdx.x; s < n; s += gridDim.x) {
    const uint4* src = x + order[s] / k * pieces;
    uint4* dst = xs + s * pieces;
    for (int c = threadIdx.x; c < pieces; c += blockDim.x) dst[c] = src[c];
  }
}

// Token blockIdx.x, its 4-column pieces from (blockIdx.y * 256 + thread):
// the sum over places j = 0 .. k-1 of the slots held here, in that order.
__global__ void __launch_bounds__(256)
    held_combine_kernel(const float4* y, const long long* key, float4* out,
                        int held, int k, int pieces) {
  const long long token = blockIdx.x;
  const int c = blockIdx.y * blockDim.x + threadIdx.x;
  if (c >= pieces) return;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int j = 0; j < k; ++j) {
    const long long slot = token * k + j;
    if (key[slot] >= held) continue;
    const float4 v = y[slot * pieces + c];
    acc.x += v.x;
    acc.y += v.y;
    acc.z += v.z;
    acc.w += v.w;
  }
  out[token * pieces + c] = acc;
}

// A map over a row-major bf16 matrix (rows, cols), read in boxes of 64
// columns x 64 rows with the 128-byte swizzle; rows past `rows` read as
// zeros.
bool tile_map(CUtensorMap* map, const void* base, int cols, long long rows,
              int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {kCols, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return encoder()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                   const_cast<void*>(base), dims, strides, box, unit,
                   CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

constexpr int kDevices = 64;

// Two blocks an SM count on the largest shared-memory carveout: asked
// once per kernel and device.
template <bool kGateUp>
cudaError_t launch_ffn(int device, const CUtensorMap& am,
                       const CUtensorMap& bm0, const CUtensorMap& bm1,
                       const FfnArgs& p, int held, cudaStream_t stream) {
  constexpr auto kernel = held_ffn_kernel<kGateUp>;
  static std::once_flag once[kDevices];
  static cudaError_t carveout[kDevices];
  std::call_once(once[device], [device] {
    carveout[device] = cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
        (int)cudaSharedmemCarveoutMaxShared);
  });
  if (carveout[device] != cudaSuccess) return carveout[device];
  return launch_with_smem<kernel>(dim3(p.width / kCols, held), kThreads,
                                  Ffn<kGateUp>::kSmem, stream, am, bm0, bm1,
                                  p);
}

}  // namespace

// geom (6 int64): tokens t, hidden width d, intermediate width fe, held
// experts, top-k, device.  x (t, d) bf16; w_gate, w_up (held, d, fe) and
// w_down (held, fe, d) bf16; weights (t, k) f32; key (t, k) int64, the held
// expert of each (token, place), `held` where none.  Written: the slot
// lists order (t k) and ends (held + 1) int64, scratch xs (t min(k, held),
// d) and h (t min(k, held), fe) bf16 and y (t k, d) f32, and out (t, d)
// f32.
extern "C" int repro_held_experts(const void* x, const void* w_gate,
                                  const void* w_up, const void* w_down,
                                  const void* weights, const void* key,
                                  void* order, void* ends, void* xs, void* h,
                                  void* y, void* out, const long long* geom,
                                  void* stream) {
  const long long t = geom[0];
  const int d = (int)geom[1], fe = (int)geom[2], held = (int)geom[3],
            k = (int)geom[4], device = (int)geom[5];
  if (k < 1 || t < 1 || t > 0x7fffffffLL / k || held < 1 || d < kCols ||
      fe < kCols || d % kCols || fe % kCols || device < 0 ||
      device >= kDevices)
    return cudaErrorInvalidValue;
  if (encoder() == nullptr) return cudaErrorNotSupported;
  DeviceGuard guard(device);
  const int sms = sm_count(device);
  if (sms < 1) return cudaErrorInvalidDevice;
  const long long slots = t * (k < held ? k : held);
  CUtensorMap xm, hm, gm, um, dm;
  if (!tile_map(&xm, xs, d, slots, kBoxRows) ||
      !tile_map(&hm, h, fe, slots, kBoxRows) ||
      !tile_map(&gm, w_gate, fe, (long long)held * d, kRows) ||
      !tile_map(&um, w_up, fe, (long long)held * d, kRows) ||
      !tile_map(&dm, w_down, d, (long long)held * fe, kRows))
    return cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* key_ = static_cast<const long long*>(key);
  auto* order_ = static_cast<long long*>(order);
  auto* ends_ = static_cast<long long*>(ends);

  held_sort_kernel<<<1, kSortThreads, 0, st>>>(key_, order_, ends_, (int)t,
                                                k, held + 1);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  held_gather_kernel<<<(unsigned)(slots < 4LL * sms ? slots : 4LL * sms), 256,
                       0, st>>>(static_cast<const uint4*>(x), order_, ends_,
                                static_cast<uint4*>(xs), held, k, d / 8);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const auto* w = static_cast<const float*>(weights);
  err = launch_ffn<true>(device, xm, gm, um, {ends_, order_, w, h, d, fe},
                         held, st);
  if (err != cudaSuccess) return err;
  err = launch_ffn<false>(device, hm, dm, dm, {ends_, order_, w, y, fe, d},
                          held, st);
  if (err != cudaSuccess) return err;
  held_combine_kernel<<<dim3((unsigned)t, (d / 4 + 255) / 256), 256, 0, st>>>(
      static_cast<const float4*>(y), key_, static_cast<float4*>(out), held,
      k, d / 4);
  return cudaGetLastError();
}

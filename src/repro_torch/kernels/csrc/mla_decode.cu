// Latent attention's absorbed decode, every head of every session at once
// (see mla_decode.py):
//   o[b, h] = sum_l softmax_l(s * ([q^ | q_pe][b, h] . [c | kr][b, l])) c[b, l]
// over the cached positions l < length.
//
// Replaces no TPU kernel: the JAX package has no latent attention.  It
// was added because the plain chain (a product over kr, one over c that
// writes bf16 scores (B, L, H) to device memory, two transposing copies
// around a softmax, and the product of the probabilities with c) took
// 60-70% of a Kimi-K2 decode step's busy time on an H100: the scores went
// through device memory about eight times and c was read twice.
//
// What bounds it: bytes.  A session's 64 heads share its cache, so each
// cached position (1,152 bytes: 512 of c and 64 of kr, bf16) is read once
// for 2 * 64 * (576 + 512) flops, ~120 flops a byte, under the ~295 at
// which the tensor cores become the limit.
//
// The design (FlashMLA's layout on Hopper):
//   * a persistent grid, one block an SM, each walking sessions; a
//     session's heads are one 64-row wgmma tile (rows past H are zero);
//   * one producer thread keeps a ring of two stages filled by TMA: each
//     stage holds 64 positions of [c | kr] as nine 64 x 64 chunks in the
//     128-byte swizzle wgmma reads (72 KB).  The tensor maps stop at
//     `length`, so rows past it land as zeros and a stale or NaN row of
//     the buffer is never read; Q (72 KB) is loaded once a session, after
//     the first stage of the next session is on its way;
//   * two consumer warpgroups: each computes half of the tile's scores
//     (64 heads x 32 positions, f32, in registers), the two exchange row
//     maxima through shared memory, keep the running max and sum of an
//     online softmax in f32 (exp2 with the scale folded in), round the
//     probabilities to bf16 into one shared 64 x 64 tile P, and each adds
//     P times its half of the tile's c (64 x 256) into its f32 output
//     (128 registers a thread);
//   * the output is divided by the row sums and written once, bf16.
#include <cmath>

#include "common.cuh"

namespace {

constexpr int kHeads = 64;         // a session's heads: one wgmma M tile
constexpr int kLatent = 512;       // c's width
constexpr int kRope = 64;          // kr's width
constexpr int kPos = 64;           // cache positions a tile
constexpr int kCols = 64;          // bf16 columns of one 128-byte swizzled chunk
constexpr int kChunks = (kLatent + kRope) / kCols;   // 9: eight of c, one of kr
constexpr int kChunkBytes = 64 * kCols * 2;         // 64 rows: 8 KB
constexpr int kTileBytes = kChunks * kChunkBytes;   // Q, or one stage: 72 KB
constexpr int kStages = 2;
constexpr int kConsumers = 256;    // two warpgroups
constexpr int kThreads = kConsumers + 128;          // and the producer's
constexpr int kHalf = kLatent / 2; // output columns a consumer warpgroup owns

// shared memory, from a 1024-byte aligned base (the swizzle's period)
constexpr int kQOff = 0;
constexpr int kStageOff = kTileBytes;
constexpr int kPOff = kStageOff + kStages * kTileBytes;
constexpr int kMaxOff = kPOff + kChunkBytes;        // row maxima, 2 x 64 f32
constexpr int kSumOff = kMaxOff + 2 * kHeads * 4;   // row sums, 2 x 64 f32
constexpr int kBarOff = kSumOff + 2 * kHeads * 4;   // full[2], empty[2], q
constexpr int kSmem = kBarOff + 8 * (2 * kStages + 2) + 1024;

struct MlaArgs {
  __nv_bfloat16* out;   // (batch, heads, 512), contiguous
  int batch, heads, length;
  float scale_log2;     // the softmax scale times log2(e)
  // q_hat's and q_pe's maps take (column, session, head) coordinates
  // where the tensor's session stride is the smaller (see box_map)
  int qn_rows_outer, qp_rows_outer;
};

// A 64 x 64 box of a 3-d tensor map (columns, rows, sessions) into shared
// memory, completed on `bar`.
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map,
                                        int col, int row, int session,
                                        std::uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<std::uint64_t>(map)), "r"(col), "r"(row),
      "r"(session), "r"(smem_u32(bar))
      : "memory");
}

// Q, the keys and P are K-major operands (kmajor), the values MN-major
// (mnmajor: 64-column chunks kChunkBytes apart, a chunk's 64 rows).
static_assert(kChunkBytes == kSwizzledTileBytes, "mnmajor's chunk stride");

// The two consumer warpgroups meet here (barrier 0 is the block's).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// D (64 x 32, f32) += A (64 x 16) B (16 x 32), A and B bf16 in shared
// memory behind descriptors; B K-major.
__device__ __forceinline__ void wgmma_m64n32k16(float (&d)[16], std::uint64_t a,
                                             std::uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(1));
}

// D (64 x 256, f32) += A (64 x 16) B (16 x 256), A and B bf16 in shared
// memory behind descriptors; B MN-major.
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], std::uint64_t a,
                                             std::uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(1));
}


__device__ __forceinline__ void produce(unsigned char* smem,
                                        const CUtensorMap* qn,
                                        const CUtensorMap* qp,
                                        const CUtensorMap* cm,
                                        const CUtensorMap* km,
                                        const MlaArgs& p, int tiles) {
  auto* bars = reinterpret_cast<std::uint64_t*>(smem + kBarOff);
  std::uint64_t *full = bars, *empty = bars + kStages;
  std::uint64_t *qfull = bars + 2 * kStages, *qempty = qfull + 1;
  int it = 0, k = 0;
  for (int b = blockIdx.x; b < p.batch; b += gridDim.x, ++k) {
    for (int t = 0; t < tiles; ++t, ++it) {
      const int s = it % kStages;
      mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
      unsigned char* stage = smem + kStageOff + s * kTileBytes;
      mbar_expect_tx(&full[s], kTileBytes);
#pragma unroll
      for (int j = 0; j < kChunks - 1; ++j)
        tma_box(stage + j * kChunkBytes, cm, j * kCols, t * kPos, b, &full[s]);
      tma_box(stage + (kChunks - 1) * kChunkBytes, km, 0, t * kPos, b,
              &full[s]);
      if (t == 0) {   // the last session's scores are done with Q
        mbar_wait(qempty, (k & 1) ^ 1);
        mbar_expect_tx(qfull, kTileBytes);
        const int qn_y = p.qn_rows_outer ? b : 0;
        const int qp_y = p.qp_rows_outer ? b : 0;
#pragma unroll
        for (int j = 0; j < kChunks - 1; ++j)
          tma_box(smem + kQOff + j * kChunkBytes, qn, j * kCols, qn_y,
                  b - qn_y, qfull);
        tma_box(smem + kQOff + (kChunks - 1) * kChunkBytes, qp, 0, qp_y,
                b - qp_y, qfull);
      }
    }
  }
}

__device__ __forceinline__ void consume(unsigned char* smem,
                                        const MlaArgs& p, int tiles,
                                        int wg) {
  auto* bars = reinterpret_cast<std::uint64_t*>(smem + kBarOff);
  std::uint64_t *full = bars, *empty = bars + kStages;
  std::uint64_t *qfull = bars + 2 * kStages, *qempty = qfull + 1;
  float* row_max = reinterpret_cast<float*>(smem + kMaxOff);
  float* row_sum = reinterpret_cast<float*>(smem + kSumOff);
  unsigned char* ptile = smem + kPOff;
  const unsigned q_addr = smem_u32(smem + kQOff);
  const unsigned p_addr = smem_u32(ptile);
  const int t = threadIdx.x & 127, lane = t & 31;
  // an accumulator's element i of n8 block j sits at row r0 + 8 * ((i / 2) & 1)
  // and column 8 * j + cq + (i & 1)
  const int r0 = (t >> 5) * 16 + (lane >> 2), cq = 2 * (lane & 3);
  int it = 0, k = 0;
  for (int b = blockIdx.x; b < p.batch; b += gridDim.x, ++k) {
    float o[kHalf / 2];
#pragma unroll
    for (int i = 0; i < kHalf / 2; ++i) o[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    mbar_wait(qfull, k & 1);
    for (int tile = 0; tile < tiles; ++tile, ++it) {
      const int s = it % kStages;
      const unsigned kv = smem_u32(smem + kStageOff + s * kTileBytes);
      mbar_wait(&full[s], (it / kStages) & 1);

      // this warpgroup's 32 positions of the scores: Q [c | kr]^T
      float sc[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) sc[i] = 0.f;
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < kChunks; ++j)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_m64n32k16(
              sc, kmajor(q_addr + j * kChunkBytes + kk * 32),
              kmajor(kv + j * kChunkBytes + wg * 32 * 128 + kk * 32));
      wgmma_commit();
      wgmma_wait();
      fence_regs(sc);
      if (tile == tiles - 1 && lane == 0) mbar_arrive(qempty);

      // scaled into the exp2 domain, positions past length to -inf
      const int pos = tile * kPos + wg * 32 + cq;
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const bool live = pos + 8 * (i / 4) + (i & 1) < p.length;
        sc[i] = live ? sc[i] * p.scale_log2 : -INFINITY;
        mx[(i / 2) & 1] = fmaxf(mx[(i / 2) & 1], sc[i]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        if ((lane & 3) == 0) row_max[wg * kHeads + r0 + 8 * h] = mx[h];
      }
      consumers_sync();
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float other = row_max[(1 - wg) * kHeads + r0 + 8 * h];
        const float mn = fmaxf(m[h], fmaxf(mx[h], other));
        alpha[h] = exp2f(m[h] - mn);
        m[h] = mn;
        l[h] *= alpha[h];
      }
      // probabilities: summed in f32, rounded to bf16 into P's swizzled rows
#pragma unroll
      for (int i = 0; i < 16; i += 2) {
        const int h = (i / 2) & 1;
        const float p0 = exp2f(sc[i] - m[h]), p1 = exp2f(sc[i + 1] - m[h]);
        l[h] += p0 + p1;
        const int row = r0 + 8 * h, col = wg * 32 + 8 * (i / 4) + cq;
        *reinterpret_cast<__nv_bfloat162*>(
            ptile + row * 128 + (((col >> 3) ^ (row & 7)) << 4) +
            (col & 7) * 2) = __floats2bfloat162_rn(p0, p1);
      }
#pragma unroll
      for (int i = 0; i < kHalf / 2; ++i) o[i] *= alpha[(i / 2) & 1];
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      consumers_sync();

      // this warpgroup's 256 output columns: o += P c
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_m64n256k16(o, kmajor(p_addr + kk * 32),
                         mnmajor(kv + wg * (kHalf / kCols) * kChunkBytes +
                                 kk * 16 * 128));
      wgmma_commit();
      wgmma_wait();
      fence_regs(o);
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    // the row sums of both halves, then o / sum, stored once
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      if ((lane & 3) == 0) row_sum[wg * kHeads + r0 + 8 * h] = l[h];
    }
    consumers_sync();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + 8 * h;
      const float inv = 1.f / (row_sum[row] + row_sum[kHeads + row]);
      if (row >= p.heads) continue;
      __nv_bfloat16* dst =
          p.out + ((long long)b * p.heads + row) * kLatent + wg * kHalf + cq;
#pragma unroll
      for (int j = 0; j < kHalf / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
            __floats2bfloat162_rn(o[4 * j + 2 * h] * inv,
                                  o[4 * j + 2 * h + 1] * inv);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    mla_decode_kernel(const __grid_constant__ CUtensorMap qn,
                      const __grid_constant__ CUtensorMap qp,
                      const __grid_constant__ CUtensorMap cm,
                      const __grid_constant__ CUtensorMap km,
                      const MlaArgs p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  if (threadIdx.x == 0) {
    auto* bars = reinterpret_cast<std::uint64_t*>(smem + kBarOff);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&bars[s], 1);                    // full: the producer
      mbar_init(&bars[kStages + s], kConsumers / 32);   // empty: each warp
    }
    mbar_init(&bars[2 * kStages], 1);
    mbar_init(&bars[2 * kStages + 1], kConsumers / 32);
    mbar_fence_init();
  }
  __syncthreads();
  const int tiles = (p.length + kPos - 1) / kPos;
  const int wg = threadIdx.x / 128;
  if (wg == kConsumers / 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == kConsumers)
      produce(smem, &qn, &qp, &cm, &km, p, tiles);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    consume(smem, p, tiles, wg);
  }
}

// A map over a bf16 tensor (sessions, rows, cols) with unit column stride,
// read in boxes of 64 columns x 64 rows of one session, with the 128-byte
// swizzle; rows past `rows` read as zeros.  The two outer dimensions go in
// the order of their strides, the smaller first, as a map lays them out:
// `*rows_outer` says whether the rows went second.
bool box_map(CUtensorMap* map, int* rows_outer, const void* base, int cols,
             int rows, int sessions, long long row_stride,
             long long session_stride) {
  *rows_outer = sessions > 1 && session_stride < row_stride;
  const bool swap = *rows_outer != 0;
  const cuuint64_t dims[3] = {(cuuint64_t)cols,
                              (cuuint64_t)(swap ? sessions : rows),
                              (cuuint64_t)(swap ? rows : sessions)};
  const cuuint64_t strides[2] = {
      (cuuint64_t)(swap ? session_stride : row_stride) * 2,
      (cuuint64_t)(swap ? row_stride : session_stride) * 2};
  const cuuint32_t box[3] = {kCols, swap ? 1u : 64u, swap ? 64u : 1u};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encoder()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                   const_cast<void*>(base), dims, strides, box, unit,
                   CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// geom (12 int64): batch, heads, length, then the session and row strides
// (elements) of q_hat, q_pe, c and kr, then the device.
extern "C" int repro_mla_decode(const void* q_hat, const void* q_pe,
                                const void* c, const void* kr, void* out,
                                const long long* geom, float scale,
                                void* stream) {
  const int batch = (int)geom[0], heads = (int)geom[1], length = (int)geom[2];
  const int device = (int)geom[11];
  if (batch < 1 || heads < 1 || heads > kHeads || length < 1)
    return cudaErrorInvalidValue;
  if (encoder() == nullptr) return cudaErrorNotSupported;
  DeviceGuard guard(device);
  const int sms = sm_count(device);
  if (sms < 1) return cudaErrorInvalidDevice;
  CUtensorMap qn, qp, cm, km;
  int qn_outer, qp_outer, c_outer, kr_outer;
  if (!box_map(&qn, &qn_outer, q_hat, kLatent, heads, batch, geom[4],
               geom[3]) ||
      !box_map(&qp, &qp_outer, q_pe, kRope, heads, batch, geom[6], geom[5]) ||
      !box_map(&cm, &c_outer, c, kLatent, length, batch, geom[8], geom[7]) ||
      !box_map(&km, &kr_outer, kr, kRope, length, batch, geom[10], geom[9]) ||
      c_outer || kr_outer)   // the kernel walks a cache's rows per session
    return cudaErrorInvalidValue;
  const MlaArgs p{static_cast<__nv_bfloat16*>(out), batch, heads, length,
                  scale * 1.4426950408889634f, qn_outer, qp_outer};
  return launch_with_smem<mla_decode_kernel>(
      dim3(batch < sms ? batch : sms), kThreads, kSmem,
      static_cast<cudaStream_t>(stream), qn, qp, cm, km, p);
}

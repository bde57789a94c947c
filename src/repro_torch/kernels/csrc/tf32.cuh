// The 3xTF32 product shared by the port's K1 (kernels/similarity/csrc/similarity.cu) and K4
// (kernels/gemm/csrc/gemm.cu): the rounding that splits a float32 into TF32 hi + lo, the
// K-major descriptor of a 128 B swizzled tile 32 floats deep, wgmma m64n128k8 TF32 x TF32 ->
// f32, and the one main loop both kernels run (tile order, TMA maps and ring, producer, the
// consumers' promoted products). Each kernel keeps its own split pre-pass and epilogue.
// kernels/_build.py hashes this header with each of them, so an edit here rebuilds both.

#pragma once

#include <cstddef>
#include <cstdint>

#include "hopper.cuh"  // mbarriers, TMA, wgmma descriptors and fences, the map encoder

namespace hopper {

// Round to TF32 (10 fraction bits), to nearest with ties away from zero; the 13 low bits,
// which cvt leaves unspecified and the tensor cores ignore, are cleared, so that v - hi is
// exactly the remainder.
__device__ __forceinline__ float tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return __uint_as_float(r & 0xFFFFE000u);
}

// K-major operand: rows of a 128 B swizzled tile at `tile` (8-row groups at SBO = 1024 B),
// the 8 floats [8 kk, 8 kk + 8) of the K tile. They lie inside one swizzle row, so the
// leading offset is unused (1) and a step along K moves the start address only.
__device__ __forceinline__ uint64_t desc_k_major(uint32_t tile, int kk) {
  return make_desc(tile + 32 * kk, 16, 8 * 128, 1);
}

// acc (64 x 128, f32) = A (64 x 8, tf32, smem) . B (128 x 8, tf32, smem)^T + (scale_d ? acc : 0),
// both operands K-major.
__device__ __forceinline__ void mma_tf32(float (&d)[64], uint64_t a, uint64_t b, int scale_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// The main loop's shape. One block of kThreads an SM computes one kBM x kBN tile of
// out = x . y^T, x (m, k_pad) and y (n, k_pad) being float32 planes of TF32 values (hi, and
// with kSplit lo), K-major, zeros past k up to whole kKT tiles.
constexpr int kKT = 32;         // K tile: 32 floats = one 128-byte swizzle row
constexpr int kBM = 128;        // rows of out a tile (two consumers of 64)
constexpr int kBN = 128;        // columns of out a tile
constexpr int kStages = 3;      // ring of K tiles
constexpr int kBand = 16;       // row blocks a band (tf32x3_tile)
constexpr int kConsumers = 2;
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr uint32_t kTileBytes = kBM * kKT * 4;  // one plane of x or y in a stage: 16 KB
static_assert(kBM == kBN, "x and y tiles share one TMA box");

// A stage holds x hi, y hi, then (split) x lo, y lo, each 1024-byte aligned.
template <bool kSplit>
__host__ __device__ constexpr uint32_t stage_bytes() {
  return (kSplit ? 4 : 2) * kTileBytes;
}
// The ring, then full and empty mbarriers a stage; 1024 bytes of slack align the base.
template <bool kSplit>
__host__ __device__ constexpr size_t smem_bytes() {
  return 1024 + kStages * stage_bytes<kSplit>() + 8 * 2 * kStages;
}

// One block's tile of out = x . y^T (m x n): the main loop over n_kt K tiles, then
// `epilogue(acc, r0, c0)` in each consumer thread, in the block's dynamic shared memory
// `smem` (smem_bytes<kSplit>() of it).
// - Tile blockIdx.x of the 1-D grid is numbered in bands of kBand row blocks: a band's x
//   tiles stay in the 50 MB L2 while every column block of y passes over them, so y is read
//   from device memory once a band and x about once in all.
// - Warpgroup 0 is the producer: its thread 0 issues TMA loads of the x and y tiles (hi,
//   and with kSplit lo) into a ring of kStages stages with full and empty mbarriers,
//   kStages tiles ahead.
// - Consumer warpgroup w (1 or 2) owns rows [64 (w - 1), 64 w) of the tile and runs wgmma
//   from shared memory: in each 8-deep step lo.hi and hi.lo first (kSplit), then hi.hi,
//   each K tile summed from zero in `part` by the tensor cores, whose adder truncates, then
//   promoted into acc with IEEE float32 adds (as FP8 GEMMs do). While one consumer adds,
//   the other's products keep the tensor cores busy.
// - acc is in wgmma's layout: thread (warp i, lane) of a consumer holds rows r0 and r0 + 8
//   of out, r0 = row0 + 64 (w - 1) + 16 i + lane / 4; in each 8-column block j, columns
//   c0 + 8 j and + 1, c0 = col0 + 2 (lane % 4), as acc[4 j + 2 r] and acc[4 j + 2 r + 1]
//   for row r0 + 8 r.
template <bool kSplit, typename Epilogue>
__device__ __forceinline__ void tf32x3_tile(uint8_t* smem, const CUtensorMap* xmap,
                                            const CUtensorMap* ymap, int m, int n, int n_kt,
                                            Epilogue&& epilogue) {
  const uint32_t ring = (smem_u32(smem) + 1023u) & ~1023u;
  const uint32_t bars = ring + kStages * stage_bytes<kSplit>();
  auto stage = [ring](int s) { return ring + s * stage_bytes<kSplit>(); };
  auto full = [bars](int s) { return bars + 8u * s; };
  auto empty = [bars](int s) { return bars + 8u * (kStages + s); };

  // tile -> (row block, column block), in bands of kBand row blocks
  const int n_rb = (m + kBM - 1) / kBM, n_cb = (n + kBN - 1) / kBN;
  const int t = blockIdx.x;
  const int band = t / (kBand * n_cb);
  const int rb0 = band * kBand;
  const int rows_in_band = min(kBand, n_rb - rb0);
  const int local = t - band * kBand * n_cb;
  const int row0 = (rb0 + local % rows_in_band) * kBM;
  const int col0 = (local / rows_in_band) * kBN;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 128 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer: x hi, y hi (and x lo, y lo) of each K tile, kStages tiles ahead
    if (threadIdx.x == 0) {
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % kStages;
        mbar_wait(empty(s), ((kt / kStages) & 1) ^ 1);  // the first round passes at once
        mbar_expect_tx(full(s), stage_bytes<kSplit>());
        const uint32_t st = stage(s);
        tma_load(st, xmap, full(s), kt * kKT, row0, 0);
        tma_load(st + kTileBytes, ymap, full(s), kt * kKT, col0, 0);
        if (kSplit) {
          tma_load(st + 2 * kTileBytes, xmap, full(s), kt * kKT, row0, 1);
          tma_load(st + 3 * kTileBytes, ymap, full(s), kt * kKT, col0, 1);
        }
      }
    }
    return;
  }

  const int w = threadIdx.x / 128 - 1;
  const int tid = threadIdx.x % 128;
  float acc[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int s = kt % kStages;
    const uint32_t st = stage(s);
    const uint32_t xh = st + w * (kTileBytes / 2), yh = st + kTileBytes;
    const uint32_t xl = xh + 2 * kTileBytes, yl = yh + 2 * kTileBytes;
    mbar_wait(full(s), (kt / kStages) & 1);
    fence_regs(part);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKT / 8; ++kk) {
      // the first product of the tile starts part from zero
      if (kSplit) {
        mma_tf32(part, desc_k_major(xl, kk), desc_k_major(yh, kk), kk > 0);
        mma_tf32(part, desc_k_major(xh, kk), desc_k_major(yl, kk));
      }
      mma_tf32(part, desc_k_major(xh, kk), desc_k_major(yh, kk), kSplit || kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(part);
    mbar_arrive(empty(s));  // this K tile's stage may be overwritten
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += part[i];
  }

  epilogue(acc, row0 + 64 * w + 16 * (tid / 32) + (tid % 32) / 4, col0 + 2 * (tid % 4));
}

// Columns col and col + 1 of a row of out with n columns: one aligned 8-byte store when
// `pairs` (n even, so an even col is 8-byte aligned) and both lie inside, else each that does.
__device__ __forceinline__ void store_pair(float* orow, int col, int n, bool pairs, float v0,
                                           float v1) {
  if (pairs && col + 1 < n) {
    *reinterpret_cast<float2*>(orow + col) = make_float2(v0, v1);
  } else {
    if (col < n) orow[col] = v0;
    if (col + 1 < n) orow[col + 1] = v1;
  }
}

// A 3-D map (k_pad, rows, planes) over float32 (planes, rows, k_pad) planes, read in boxes of
// (kKT, kBM, 1) with the 128 B swizzle. Rows past `rows` arrive as zeros.
inline cudaError_t make_map(EncodeTiled encode, CUtensorMap* map, const float* ptr, int rows,
                            int k_pad, int planes) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(k_pad), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(planes)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(k_pad) * 4,
                                 static_cast<cuuint64_t>(k_pad) * 4 * rows};
  const cuuint32_t box[3] = {kKT, kBM, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r =
      encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(ptr), dims, strides,
             box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace hopper

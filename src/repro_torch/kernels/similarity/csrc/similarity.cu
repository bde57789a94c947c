// Pairwise similarity S[i, j] = h(||x_i - y_j||) for MSET2 and AAKR, on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/similarity/similarity.py:similarity_pallas.
// Same formulation: d2 = ||x||^2 + ||y||^2 - 2 x.y^T, the product accumulated in float32 over
// the signal dimension, then a fused epilogue clamps d2 >= 0 and applies the kind:
//   kind 0, inverse_distance: 1 / (1 + sqrt(d2) / gamma)
//   kind 1, gaussian:         exp(-d2 / (2 gamma^2))
//
// What bounds it: 2*m*b*n operations against (m + b)*n inputs and m*b outputs, so at the
// MSET2 shapes (n = 1024 signals) it is bound by operations. The tensor cores' TF32 rate is
// 7x the CUDA cores' float32 FMA rate, but one TF32 product keeps 11 significant bits and
// misses the float32 bar of 5e-6. So the product is taken in three TF32 products ("3xTF32"):
// v = hi + lo with hi = tf32(v) and lo = tf32(v - hi), and x.y = xl.yh + xh.yl + xh.yh with
// float32 accumulation (xl.yl, below 2^-22 relative, is dropped). tests/test_torch_similarity.py
// emulates this arithmetic on the CPU, with an ideal accumulator and with a truncating one,
// alone and promoted as below.
//
// Two kernels, launched in turn on one stream:
// - split_kernel<T>: one warp a row of x (and of y, unless y is x) writes hi and lo into
//   (2, rows, n_pad) float32 scratch, n_pad = n rounded up to the 32-float K tile with zeros
//   past n (so every TMA row stride is legal and the padding adds nothing to the product),
//   and the row's float32 squared norm. bfloat16 values are TF32 values already (8
//   significant bits), so for them lo = 0 and only hi is written.
// - similarity_tc_kernel<kind, split>: one block of 384 threads an SM computes one 128 x 128
//   tile of S. Warpgroup 0 is the producer, one thread of which issues TMA loads of the x and
//   y tiles (hi and lo planes, 32 floats deep, 128 B swizzle) into a ring of 3 stages with
//   full and empty mbarriers; two consumer warpgroups own 64 rows of the tile each and run
//   wgmma m64n128k8 TF32 x TF32 -> f32 from shared memory, both operands K-major (row-major
//   x (m, n) and y (b, n) are that already): in each 8-deep step lo.hi and hi.lo first, then
//   hi.hi. Each K tile's products are summed from zero by the tensor cores, whose adder
//   truncates, and then added into a second register accumulator with IEEE float32 adds
//   (promotion, as FP8 GEMMs do). A truncating adder over all 1024 signals would drift to
//   ~3e-6 on MSET2's telemetry, most of the 5e-6 bar (the CPU model in
//   tests/test_torch_similarity.py); promoted, chip_smoke.py finds the kernel closer to a
//   float64 product than the plain float32 version on the full-width cell. While one
//   consumer waits for its tile's products and adds them, the other's keep the tensor
//   cores busy. The epilogue is fused: d2 = max(x2 + y2 - 2 acc, 0), the kind, masked
//   stores.
// - Tiles are numbered on a 1-D grid in bands of 16 row blocks: a band's x tiles (hi + lo,
//   16 MB at n = 1024) stay in the 50 MB L2 while every column block of y passes over them,
//   so y is read from device memory once a band and x about once in all.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "../../csrc/hopper.cuh"  // mbarriers, TMA, wgmma descriptors and fences

namespace {

using namespace hopper;

constexpr int kKT = 32;         // K tile: 32 floats = one 128-byte swizzle row
constexpr int kBM = 128;        // rows of S a tile (two consumers of 64)
constexpr int kBN = 128;        // columns of S a tile
constexpr int kStages = 3;      // ring of K tiles
constexpr int kBand = 16;       // row blocks a band (tile order, above)
constexpr int kConsumers = 2;
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kSplitRows = 8;   // rows (warps) a block of split_kernel
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

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// Round to TF32 (10 fraction bits), to nearest with ties away from zero; the 13 low bits,
// which cvt leaves unspecified and the tensor cores ignore, are cleared, so that v - hi is
// exactly the remainder.
__device__ __forceinline__ float tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return __uint_as_float(r & 0xFFFFE000u);
}

template <typename T>
__global__ void __launch_bounds__(32 * kSplitRows)
    split_kernel(const T* __restrict__ src, float* __restrict__ dst, float* __restrict__ norm2,
                 int rows, int n, int n_pad, int split) {
  const int row = blockIdx.x * kSplitRows + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const T* s = src + static_cast<size_t>(row) * n;
  float* hi = dst + static_cast<size_t>(row) * n_pad;
  float* lo = hi + static_cast<size_t>(rows) * n_pad;
  float sum = 0.0f;
  for (int k = lane; k < n_pad; k += 32) {
    const float v = k < n ? to_f32(s[k]) : 0.0f;
    sum = fmaf(v, v, sum);
    const float h = tf32_rna(v);
    hi[k] = h;
    if (split) lo[k] = tf32_rna(v - h);
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) norm2[row] = sum;
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

// Grid: one block a 128 x 128 tile of S, numbered in bands (above). Block: warpgroup 0 is
// the producer (thread 0 issues every TMA load); consumer warpgroup w (1 or 2) owns rows
// [64 (w - 1), 64 w) of the tile. In a consumer, thread (warp i, lane) holds rows
// 16 i + lane / 4 and that + 8; in each 8-column block of the accumulator, columns
// 2 (lane % 4) and + 1 (wgmma's layout).
template <int kKind, bool kSplit>
__global__ void __launch_bounds__(kThreads, 1)
    similarity_tc_kernel(const __grid_constant__ CUtensorMap xmap,
                         const __grid_constant__ CUtensorMap ymap,
                         const float* __restrict__ x2, const float* __restrict__ y2,
                         float* __restrict__ out, int m, int b, int n_kt, float epi) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = ring + kStages * stage_bytes<kSplit>();
  auto stage = [ring](int s) { return ring + s * stage_bytes<kSplit>(); };
  auto full = [bars](int s) { return bars + 8u * s; };
  auto empty = [bars](int s) { return bars + 8u * (kStages + s); };

  // tile -> (row block, column block), in bands of kBand row blocks
  const int n_rb = (m + kBM - 1) / kBM, n_cb = (b + kBN - 1) / kBN;
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
        tma_load(st, &xmap, full(s), kt * kKT, row0, 0);
        tma_load(st + kTileBytes, &ymap, full(s), kt * kKT, col0, 0);
        if (kSplit) {
          tma_load(st + 2 * kTileBytes, &xmap, full(s), kt * kKT, row0, 1);
          tma_load(st + 3 * kTileBytes, &ymap, full(s), kt * kKT, col0, 1);
        }
      }
    }
    return;
  }

  const int w = threadIdx.x / 128 - 1;
  const int tid = threadIdx.x % 128;
  // Each K tile is summed from zero in `part` by the tensor cores, whose adder truncates,
  // and then promoted into acc with IEEE float32 adds (above).
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

  // epilogue: d2 = max(x2 + y2 - 2 acc, 0), the kind, masked stores
  const int r0 = row0 + 64 * w + 16 * (tid / 32) + (tid % 32) / 4;
  const int c0 = col0 + 2 * (tid % 4);
  const bool pairs = (b % 2) == 0;  // then a pair of columns is one aligned 8-byte store
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= m) continue;
    const float xr = x2[row];
    float* orow = out + static_cast<size_t>(row) * b;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int col = c0 + 8 * j;
      float v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float yc = col + e < b ? y2[col + e] : 0.0f;
        const float d2 = fmaxf(xr + yc - 2.0f * acc[4 * j + 2 * r + e], 0.0f);
        // epi is gamma for inverse_distance and 2 gamma^2 for gaussian
        v[e] = kKind == 0 ? 1.0f / (1.0f + sqrtf(d2) / epi) : expf(-d2 / epi);
      }
      if (pairs && col + 1 < b) {
        *reinterpret_cast<float2*>(orow + col) = make_float2(v[0], v[1]);
      } else {
        if (col < b) orow[col] = v[0];
        if (col + 1 < b) orow[col + 1] = v[1];
      }
    }
  }
}

// A 3-D map (n_pad, rows, planes) over float32 (planes, rows, n_pad) scratch, read in boxes
// of (32, 128, 1) with the 128 B swizzle. Rows past `rows` arrive as zeros.
cudaError_t make_map(EncodeTiled encode, CUtensorMap* map, float* ptr, int rows, int n_pad,
                     int planes) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(n_pad), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(planes)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(n_pad) * 4,
                                 static_cast<cuuint64_t>(n_pad) * 4 * rows};
  const cuuint32_t box[3] = {kKT, kBM, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, ptr, dims, strides, box,
                            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename T>
cudaError_t split(const void* src, float* dst, float* norm2, int rows, int n, int n_pad,
                  cudaStream_t stream) {
  const int blocks = (rows + kSplitRows - 1) / kSplitRows;
  split_kernel<T><<<blocks, 32 * kSplitRows, 0, stream>>>(
      static_cast<const T*>(src), dst, norm2, rows, n, n_pad, sizeof(T) == 4);
  return cudaGetLastError();
}

template <int kKind, bool kSplit>
cudaError_t product(const CUtensorMap& xm, const CUtensorMap& ym, const float* x2,
                    const float* y2, float* out, int m, int b, int n_pad, float epi,
                    unsigned tiles, cudaStream_t stream) {
  const cudaError_t err =
      cudaFuncSetAttribute(similarity_tc_kernel<kKind, kSplit>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem_bytes<kSplit>()));
  if (err != cudaSuccess) return err;
  similarity_tc_kernel<kKind, kSplit><<<tiles, kThreads, smem_bytes<kSplit>(), stream>>>(
      xm, ym, x2, y2, out, m, b, n_pad / kKT, epi);
  return cudaGetLastError();
}

}  // namespace

// x (m, n) and y (b, n) row-major, both float32 (dtype 0) or bfloat16 (dtype 1); out (m, b)
// float32. Scratch, allocated by the caller: x_split (planes, m, n_pad) and x2 (m,), y_split
// (planes, b, n_pad) and y2 (b,), float32, with planes = 2 for float32 (hi, lo) and 1 for
// bfloat16, n_pad a positive multiple of 32 >= n, and 16-byte aligned split buffers. With
// same != 0, y is x: y_split and y2 are x_split and x2, and y is split once. Everything on
// CUDA device `device`. Launches on `stream` and does not synchronise. Returns the
// cudaError_t of the first launch that failed (0 on success). This library carries its own
// CUDA runtime, whose current device is set here, not by PyTorch.
extern "C" int similarity_launch(const void* x, const void* y, float* x_split, float* y_split,
                                 float* x2, float* y2, float* out, int m, int b, int n,
                                 int n_pad, int dtype, int kind, float epi, int same, int device,
                                 void* stream) {
  const long long tiles =
      static_cast<long long>((m + kBM - 1) / kBM) * static_cast<long long>((b + kBN - 1) / kBN);
  if (m <= 0 || b <= 0 || n < 0 || n_pad < n || n_pad <= 0 || n_pad % kKT != 0 ||
      (dtype != 0 && dtype != 1) || (kind != 0 && kind != 1) || (same && m != b) ||
      tiles > 0x7FFFFFFFLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int planes = dtype == 0 ? 2 : 1;

  err = dtype == 0 ? split<float>(x, x_split, x2, m, n, n_pad, s)
                   : split<__nv_bfloat16>(x, x_split, x2, m, n, n_pad, s);
  if (err == cudaSuccess && !same) {
    err = dtype == 0 ? split<float>(y, y_split, y2, b, n, n_pad, s)
                     : split<__nv_bfloat16>(y, y_split, y2, b, n, n_pad, s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);

  EncodeTiled encode;
  if ((err = encode_tiled(&encode)) != cudaSuccess) return static_cast<int>(err);
  CUtensorMap xm, ym;
  if ((err = make_map(encode, &xm, x_split, m, n_pad, planes)) != cudaSuccess ||
      (err = make_map(encode, &ym, same ? x_split : y_split, b, n_pad, planes)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  const float* y2p = same ? x2 : y2;
  const unsigned t = static_cast<unsigned>(tiles);
  if (dtype == 0) {
    err = kind == 0 ? product<0, true>(xm, ym, x2, y2p, out, m, b, n_pad, epi, t, s)
                    : product<1, true>(xm, ym, x2, y2p, out, m, b, n_pad, epi, t, s);
  } else {
    err = kind == 0 ? product<0, false>(xm, ym, x2, y2p, out, m, b, n_pad, epi, t, s)
                    : product<1, false>(xm, ym, x2, y2p, out, m, b, n_pad, epi, t, s);
  }
  return static_cast<int>(err);
}

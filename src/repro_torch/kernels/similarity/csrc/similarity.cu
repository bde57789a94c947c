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
//   tile of S, its main loop the one K4 runs too (kernels/csrc/tf32.cuh). Warpgroup 0 is
//   the producer, one thread of which issues TMA loads of the x and y tiles (hi and lo
//   planes, 32 floats deep, 128 B swizzle) into a ring of 3 stages with full and empty
//   mbarriers; two consumer warpgroups own 64 rows of the tile each and run
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
#include "../../csrc/tf32.cuh"    // the TF32 split and the shared 3xTF32 main loop

namespace {

using namespace hopper;

constexpr int kSplitRows = 8;  // rows (warps) a block of split_kernel

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

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

// Grid: one block a 128 x 128 tile of S, numbered in bands. Block: the shared main loop
// (tf32x3_tile), then each consumer's fused epilogue on its rows.
template <int kKind, bool kSplit>
__global__ void __launch_bounds__(kThreads, 1)
    similarity_tc_kernel(const __grid_constant__ CUtensorMap xmap,
                         const __grid_constant__ CUtensorMap ymap,
                         const float* __restrict__ x2, const float* __restrict__ y2,
                         float* __restrict__ out, int m, int b, int n_kt, float epi) {
  extern __shared__ uint8_t smem_raw[];
  // epilogue: d2 = max(x2 + y2 - 2 acc, 0), the kind, masked stores
  tf32x3_tile<kSplit>(smem_raw, &xmap, &ymap, m, b, n_kt, [=](float (&acc)[64], int r0, int c0) {
    const bool pairs = (b % 2) == 0;
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
        store_pair(orow, col, b, pairs, v[0], v[1]);
      }
    }
  });
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

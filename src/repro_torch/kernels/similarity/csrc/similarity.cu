// Pairwise similarity S[i, j] = h(||x_i - y_j||) for MSET2 and AAKR, on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/similarity/similarity.py:similarity_pallas.
// Same formulation: d2 = ||x||^2 + ||y||^2 - 2 x.y^T, the product accumulated in float32 over
// the signal dimension, then a fused epilogue clamps d2 >= 0 and applies the kind:
//   kind 0, inverse_distance: 1 / (1 + sqrt(d2) / gamma)
//   kind 1, gaussian:         exp(-d2 / (2 gamma^2))
// The row norms x2, y2 come in precomputed (the TPU path leaves them to XLA as well).
//
// What bounds it: 2*m*b*n float32 operations against (m + b)*n inputs and m*b outputs, so at
// the MSET2 shapes (n = 1024 signals) it is bound by operations, and by IEEE float32 FMA on
// the CUDA cores: TF32 tensor cores keep ~3 decimal digits and cannot meet the 5e-6 bar.
// Design: each block owns a 128x128 output tile; 16x16 threads each hold an 8x8 register tile
// of accumulators (64 FMAs for every 16 shared-memory reads). The block walks n in stages of
// 16, converting to float32 on load and staging x and y transposed in shared memory, and masks
// the ragged edges itself (zeros add nothing to the dot product), so no padded copies are made.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreadsX = 16;  // threads along b (columns of S)
constexpr int kThreadsY = 16;  // threads along m (rows of S)
constexpr int kTM = 8;         // rows of S per thread
constexpr int kTN = 8;         // columns of S per thread
constexpr int kBM = kThreadsY * kTM;  // 128
constexpr int kBN = kThreadsX * kTN;  // 128
constexpr int kBK = 16;               // depth of one shared-memory stage
constexpr int kThreads = kThreadsX * kThreadsY;
constexpr int kPad = 4;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// Stage rows [row0, row0 + kRows) x depth [k0, k0 + kBK) of src (rows, n) into dst[k][row].
template <typename T, int kRows>
__device__ __forceinline__ void stage(float (*dst)[kRows + kPad], const T* __restrict__ src,
                                      int row0, int rows, int k0, int n, int tid) {
#pragma unroll
  for (int s = 0; s < kRows * kBK / kThreads; ++s) {
    const int e = tid + s * kThreads;
    const int r = e / kBK, kk = e % kBK;
    const int gr = row0 + r, gk = k0 + kk;
    dst[kk][r] = (gr < rows && gk < n) ? to_f32(src[static_cast<size_t>(gr) * n + gk]) : 0.0f;
  }
}

template <typename T, int kKind>
__global__ void __launch_bounds__(kThreads)
    similarity_kernel(const T* __restrict__ x, const T* __restrict__ y,
                      const float* __restrict__ x2, const float* __restrict__ y2,
                      float* __restrict__ out, int m, int b, int n, float epi) {
  __shared__ float xs[kBK][kBM + kPad];
  __shared__ float ys[kBK][kBN + kPad];

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kThreadsX + tx;
  const int row0 = blockIdx.y * kBM;
  const int col0 = blockIdx.x * kBN;

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < n; k0 += kBK) {
    stage<T, kBM>(xs, x, row0, m, k0, n, tid);
    stage<T, kBN>(ys, y, col0, b, k0, n, tid);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[kTM], c[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) a[i] = xs[kk][ty + i * kThreadsY];
#pragma unroll
      for (int j = 0; j < kTN; ++j) c[j] = ys[kk][tx + j * kThreadsX];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], c[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int gr = row0 + ty + i * kThreadsY;
    if (gr >= m) continue;
    const float xr = x2[gr];
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int gc = col0 + tx + j * kThreadsX;
      if (gc >= b) continue;
      const float d2 = fmaxf(xr + y2[gc] - 2.0f * acc[i][j], 0.0f);
      // epi is gamma for inverse_distance and 2 gamma^2 for gaussian
      const float s = kKind == 0 ? 1.0f / (1.0f + sqrtf(d2) / epi) : expf(-d2 / epi);
      out[static_cast<size_t>(gr) * b + gc] = s;
    }
  }
}

template <typename T>
void launch(const void* x, const void* y, const float* x2, const float* y2, float* out, int m,
            int b, int n, int kind, float epi, cudaStream_t stream) {
  const dim3 block(kThreadsX, kThreadsY);
  const dim3 grid((b + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  const T* xt = static_cast<const T*>(x);
  const T* yt = static_cast<const T*>(y);
  if (kind == 0) {
    similarity_kernel<T, 0><<<grid, block, 0, stream>>>(xt, yt, x2, y2, out, m, b, n, epi);
  } else {
    similarity_kernel<T, 1><<<grid, block, 0, stream>>>(xt, yt, x2, y2, out, m, b, n, epi);
  }
}

}  // namespace

// x (m, n) and y (b, n) row-major, both float32 (dtype 0) or bfloat16 (dtype 1); x2 (m,), y2 (b,)
// float32 squared row norms; out (m, b) float32, all on CUDA device `device`. Launches on
// `stream` and does not synchronise. Returns the cudaError_t of the launch (0 on success).
// This library carries its own CUDA runtime, whose current device is set here, not by PyTorch.
extern "C" int similarity_launch(const void* x, const void* y, const float* x2, const float* y2,
                                 float* out, int m, int b, int n, int dtype, int kind, float epi,
                                 int device, void* stream) {
  if (m <= 0 || b <= 0 || n < 0 || (dtype != 0 && dtype != 1) || (kind != 0 && kind != 1) ||
      (m + kBM - 1) / kBM > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float>(x, y, x2, y2, out, m, b, n, kind, epi, s);
  } else {
    launch<__nv_bfloat16>(x, y, x2, y2, out, m, b, n, kind, epi, s);
  }
  return static_cast<int>(cudaGetLastError());
}

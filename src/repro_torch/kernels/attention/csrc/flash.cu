// Flash attention (online softmax over streamed KV tiles) on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/attention/flash.py:flash_attention.
// Same function: s = (q . k) * scale with scale = hd^-1/2, keys past S and (when causal)
// keys after the query masked with -1e30, a running max m, denominator l and accumulator
// acc kept in float32, and out = acc / max(l, 1e-30) cast to q's dtype.
//
// Differences in method, not in function:
// - One block per (query tile of 64 rows, batch x head). A loop inside the block walks
//   the KV tiles in order; it takes the place of the Pallas kernel's sequential
//   innermost grid axis, and m, l and acc stay in registers for the whole loop.
// - Causal: the loop stops at the diagonal tile. The Pallas kernel visits and masks
//   every tile; a tile above the diagonal adds exactly 0 there.
// - GQA: query head h reads KV head h / (H / K) in place; no repeated copy is made.
// - Ragged S is masked here, with no padded copies; q, k and v are read through their
//   strides, so (B, S, H, hd) tensors and their views need no transposed copies.
//
// What bounds it: 4 * B * H * hd * S^2 / 2 operations (causal) against (q, k, v, o)
// bytes, so at serving shapes it is bound by operations. This first kernel computes in
// IEEE float32 FMA on the CUDA cores (the float32 test bar, 2e-5, rules out TF32), with
// 4 x 4 scores and 4 x hd/16 outputs per thread from float32 tiles in shared memory.
// Tensor cores (mma/wgmma), TMA and warp specialisation are left to a later redesign.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBQ = 64;                // query rows per block
constexpr int kBKV = 64;               // keys per KV tile
constexpr int kTX = 16;                // threads along keys / head dims
constexpr int kTY = 16;                // threads along query rows
constexpr int kThreads = kTX * kTY;    // 256
constexpr int kRows = kBQ / kTY;       // query rows per thread: ty + kTY * i
constexpr int kCols = kBKV / kTX;      // score columns per thread: tx + kTX * j
constexpr float kNegInf = -1e30f;      // as the Pallas kernel: exp(-inf - -inf) is NaN

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

struct Strides {
  int64_t b, s, h;  // in elements; the head dim is contiguous
};

// Stage rows [row0, row0 + kN) of one head of src into dst[r][d] (row pitch D + 1, so that
// threads reading one d across rows hit distinct banks). Rows past S are zero.
template <typename T, int D, int kN>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src, int64_t row_stride,
                                      int row0, int S) {
  for (int e = threadIdx.x; e < kN * D; e += kThreads) {
    const int r = e / D, d = e % D;
    const int gr = row0 + r;
    dst[r * (D + 1) + d] = gr < S ? to_f32(src[static_cast<int64_t>(gr) * row_stride + d]) : 0.0f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, int S, int H, int group, Strides qs_, Strides ks_,
                 Strides vs_, Strides os_, float scale, int causal) {
  constexpr int kDC = D / kTX;  // output columns per thread: tx + kTX * c
  extern __shared__ float smem[];
  float* qs = smem;                    // [kBQ][D + 1]
  float* kvs = qs + kBQ * (D + 1);     // [kBKV][D + 1]: the K tile, then the V tile
  float* ps = kvs + kBKV * (D + 1);    // [kBQ][kBKV + 1]: probabilities of this tile

  const int tx = threadIdx.x % kTX, ty = threadIdx.x / kTX;
  // heaviest causal tiles (the last query rows) first, for a shorter tail
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int b = blockIdx.y / H, h = blockIdx.y % H, kh = h / group;
  const T* qb = q + b * qs_.b + h * qs_.h;
  const T* kb = k + b * ks_.b + kh * ks_.h;
  const T* vb = v + b * vs_.b + kh * vs_.h;

  stage<T, D, kBQ>(qs, qb, qs_.s, q0, S);

  float m[kRows], l[kRows], acc[kRows][kDC];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < kDC; ++c) acc[i][c] = 0.0f;
  }

  const int n_tiles_all = (S + kBKV - 1) / kBKV;
  const int n_tiles = causal ? min(n_tiles_all, (q0 + kBQ - 1) / kBKV + 1) : n_tiles_all;

  for (int t = 0; t < n_tiles; ++t) {
    const int kv0 = t * kBKV;
    __syncthreads();  // the previous tile's P.V is done with kvs and ps
    stage<T, D, kBKV>(kvs, kb, ks_.s, kv0, S);
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[kRows], c[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) a[i] = qs[(ty + kTY * i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) c[j] = kvs[(tx + kTX * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(a[i], c[j], s[i][j]);
    }

    // Online softmax. The kTX threads of one row are 16 consecutive lanes of one warp;
    // xor shuffles give every one of them the same max and the same sum.
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = q0 + ty + kTY * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int col = kv0 + tx + kTX * j;
        const bool keep = col < S && (!causal || col <= row);
        s[i][j] = keep ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = kTX / 2; off > 0; off /= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off, kTX));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps[(ty + kTY * i) * (kBKV + 1) + tx + kTX * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = kTX / 2; off > 0; off /= 2)
        sum += __shfl_xor_sync(0xffffffffu, sum, off, kTX);
      l[i] = alpha * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kDC; ++c) acc[i][c] *= alpha;
    }

    __syncthreads();  // every thread is done reading the K tile; ps is complete
    stage<T, D, kBKV>(kvs, vb, vs_.s, kv0, S);
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBKV; ++kk) {
      float a[kRows], c[kDC];
#pragma unroll
      for (int i = 0; i < kRows; ++i) a[i] = ps[(ty + kTY * i) * (kBKV + 1) + kk];
#pragma unroll
      for (int cc = 0; cc < kDC; ++cc) c[cc] = kvs[kk * (D + 1) + tx + kTX * cc];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int cc = 0; cc < kDC; ++cc) acc[i][cc] = fmaf(a[i], c[cc], acc[i][cc]);
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty + kTY * i;
    if (row >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* orow = o + b * os_.b + static_cast<int64_t>(row) * os_.s + h * os_.h;
#pragma unroll
    for (int c = 0; c < kDC; ++c) store(orow + tx + kTX * c, acc[i][c] / denom);
  }
}

constexpr size_t smem_bytes(int D) {
  return sizeof(float) * (static_cast<size_t>(kBQ + kBKV) * (D + 1) + kBQ * (kBKV + 1));
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int S, int H,
                   int K, const Strides& qs, const Strides& ks, const Strides& vs,
                   const Strides& os, float scale, int causal, cudaStream_t stream) {
  // Above 48 KB a block gets dynamic shared memory only after this attribute is set;
  // without it the launch is refused and never runs.
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes(D)));
  if (attr != cudaSuccess) return attr;
  const dim3 grid((S + kBQ - 1) / kBQ, B * H);
  flash_kernel<T, D><<<grid, kThreads, smem_bytes(D), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), S, H, H / K, qs, ks, vs, os, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int hd, const void* q, const void* k, const void* v, void* o, int B, int S,
                     int H, int K, const Strides& qs, const Strides& ks, const Strides& vs,
                     const Strides& os, float scale, int causal, cudaStream_t stream) {
  switch (hd) {
    case 16:
      return launch<T, 16>(q, k, v, o, B, S, H, K, qs, ks, vs, os, scale, causal, stream);
    case 32:
      return launch<T, 32>(q, k, v, o, B, S, H, K, qs, ks, vs, os, scale, causal, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, B, S, H, K, qs, ks, vs, os, scale, causal, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, S, H, K, qs, ks, vs, os, scale, causal, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, S, H, hd), k and v (B, S, K, hd) and o (B, S, H, hd), all float32 (dtype 0) or all
// bfloat16 (dtype 1), on CUDA device `device`, each with a contiguous head dim and the other
// strides (in elements) given. hd in {16, 32, 64, 128}, H % K == 0. Launches on `stream` and
// does not synchronise. Returns the cudaError_t of the launch (0 on success). This library
// carries its own CUDA runtime, whose current device is set here, not by PyTorch.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      int B, int S, int H, int K, int hd, long long qsb,
                                      long long qss, long long qsh, long long ksb, long long kss,
                                      long long ksh, long long vsb, long long vss, long long vsh,
                                      long long osb, long long oss, long long osh, int dtype,
                                      int causal, float scale, int device, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || K <= 0 || H % K != 0 || B * H > 65535 ||
      (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh}, os{osb, oss, osh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0
          ? dispatch<float>(hd, q, k, v, o, B, S, H, K, qs, ks, vs, os, scale, causal, s)
          : dispatch<__nv_bfloat16>(hd, q, k, v, o, B, S, H, K, qs, ks, vs, os, scale, causal, s);
  return static_cast<int>(err);
}

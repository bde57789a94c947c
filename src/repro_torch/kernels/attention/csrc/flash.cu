// Flash attention (online softmax over streamed KV tiles) on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/attention/flash.py:flash_attention.
// Same function: s = (q . k) * scale with scale = hd^-1/2, keys past S and (when causal)
// keys after the query masked with -1e30, a running max m, denominator l and accumulator
// acc kept in float32, P . V in float32, and out = acc / max(l, 1e-30) cast to q's dtype.
//
// Shared by both kernels, differences in method, not in function:
// - 64 query rows of one (batch, head) belong to one block (float32) or one consumer
//   warpgroup (bfloat16), whose loop walks the KV tiles in order; it takes the place of
//   the Pallas kernel's sequential innermost grid axis, and m, l and acc stay in
//   registers for the whole loop.
// - Causal: the loop stops at the diagonal tile. The Pallas kernel visits and masks
//   every tile; a tile above the diagonal adds exactly 0 there. The heaviest causal
//   query tiles are launched first.
// - GQA: query head h reads KV head h / (H / K) in place; no repeated copy is made.
// - Ragged S is masked here, with no padded copies; q, k and v are read through their
//   strides, so (B, S, H, hd) tensors and their views need no transposed copies.
//
// What bounds it: 4 * B * H * hd * S^2 / 2 operations (causal) against (q, k, v, o)
// bytes, so at serving shapes it is bound by operations: the tensor cores' bf16 rate.
//
// bfloat16 (tc::flash_tc_kernel): the tensor cores, fed by TMA.
// - Warp specialised, one block of 384 threads per SM: warpgroup 0 is the producer, one
//   thread of which issues TMA loads of Q (once) and of K and V tiles into a ring of 2 K
//   and 2 V stages, each signalled by an mbarrier; two consumer warpgroups own 64 query
//   rows each of a 128-row tile and read the same K and V tiles, so one's softmax
//   overlaps the other's products. setmaxnreg moves registers from the producer (40) to
//   the consumers (232). ptxas allocates every region within the entry count (168 here),
//   which is why two consumers share one block: at two blocks of 256 threads an SM, the
//   entry count is 128 and the hd = 128 consumer spills.
// - TMA maps are 4-D (hd, heads, S, B) from the tensors' strides, in boxes of 64 rows by
//   min(hd, 64) columns with the swizzle of one box row (32, 64 or 128 bytes; at hd = 128
//   a row is two boxes). Rows past S arrive as zeros and keys >= S are still masked: a
//   zero K row scores 0, not -inf.
// - S = Q . K^T: wgmma m64n64k16, bf16 x bf16 with f32 accumulation, Q and K both K-major
//   from shared memory; scale is applied in f32 afterwards.
// - The online softmax runs on the accumulator registers, in units of log2(e): one FMA
//   (s * scale * log2(e) - m) and one ex2 an element. The four threads of a row agree on
//   its max by shuffles. Masks are applied on the diagonal tile and the ragged last one.
//   acc is rescaled only when a row of the warp has a new max (else alpha is exactly 1).
// - acc += P . V: wgmma m64n{hd}k16 with P from registers (the S accumulator is already in
//   the A-fragment layout) and V from shared memory, transposed by the instruction (tnspB).
//   P is split into bf16 hi = bf16(p) and lo = bf16(p - hi), and both are multiplied:
//   hi + lo carries p to about 2^-18, so P . V keeps the float32 P of the Pallas kernel
//   and the output stays within one bf16 ulp of the plain version; P rounded once to bf16
//   does not (tests/test_torch_attention.py). The split costs 1.5x the function's tensor
//   work; the bound above counts the function's own work.
// - Each consumer runs S, softmax, P . V in turn. What limits it is the softmax's and the
//   split's instructions on the CUDA cores, which take about as long as the tile's
//   products; forcing the two consumers to alternate on the tensor cores (ping-pong) was
//   slower.
//
// float32 (flash_kernel): IEEE float32 FMA on the CUDA cores, since the float32 bar of
// 2e-5 rules out TF32: 4 x 4 scores and 4 x hd/16 outputs per thread from float32 tiles in
// shared memory, K and V staged in turn through one buffer.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "../../csrc/hopper.cuh"  // mbarriers, TMA, wgmma descriptors and fences

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
__device__ __forceinline__ void store(float* p, float v) { *p = v; }

struct Strides {
  int64_t b, s, h;  // in elements; the head dim is contiguous
};

// ===================================================================================
// float32: IEEE FMA on the CUDA cores (the float32 instance is the only one launched)
// ===================================================================================

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

cudaError_t dispatch_f32(int hd, const void* q, const void* k, const void* v, void* o, int B,
                         int S, int H, int K, const Strides& qs, const Strides& ks,
                         const Strides& vs, const Strides& os, float scale, int causal,
                         cudaStream_t stream) {
  switch (hd) {
    case 16:
      return launch<float, 16>(q, k, v, o, B, S, H, K, qs, ks, vs, os, scale, causal, stream);
    case 32:
      return launch<float, 32>(q, k, v, o, B, S, H, K, qs, ks, vs, os, scale, causal, stream);
    case 64:
      return launch<float, 64>(q, k, v, o, B, S, H, K, qs, ks, vs, os, scale, causal, stream);
    case 128:
      return launch<float, 128>(q, k, v, o, B, S, H, K, qs, ks, vs, os, scale, causal, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// ===================================================================================
// bfloat16: tensor cores (wgmma), TMA loads, one producer and two consumer warpgroups
// ===================================================================================
namespace tc {

constexpr int kConsumers = 2;                    // consumer warpgroups, 64 query rows each
constexpr int kThreads = 128 * (1 + kConsumers);  // warpgroup 0 loads: one thread issues TMA
constexpr int kStages = 2;                       // ring of K tiles and ring of V tiles
constexpr float kLog2e = 1.4426950408889634f;
using namespace hopper;

// One 64-row tile of D bf16 columns in shared memory, as TMA writes it: boxes of min(D, 64)
// columns (one swizzle row of 32, 64 or 128 bytes), side by side at D = 128. Row r of a
// box is at r * kRowBytes, with its 16-byte chunks permuted by the swizzle.
template <int D>
struct Tile {
  static constexpr int kBoxCols = D < 64 ? D : 64;
  static constexpr int kBoxes = D / kBoxCols;
  static constexpr uint32_t kRowBytes = kBoxCols * 2;
  static constexpr uint32_t kBoxBytes = kBQ * kRowBytes;
  static constexpr uint32_t kBytes = kBoxes * kBoxBytes;
  // the wgmma descriptor's layout code for this swizzle: 1 = 128 B, 2 = 64 B, 3 = 32 B
  static constexpr uint64_t kLayout = kRowBytes == 128 ? 1 : kRowBytes == 64 ? 2 : 3;
};
static_assert(kBQ == kBKV, "Q and KV tiles share one TMA box");

// Q (one tile per consumer), the K ring, the V ring (each tile 1024-byte aligned for the
// 128 B swizzle), then 1 + 4 * kStages mbarriers; 1024 bytes of slack align the base.
template <int D>
constexpr size_t smem_bytes() {
  return 1024 + (kConsumers + 2 * kStages) * Tile<D>::kBytes + 8 * (1 + 4 * kStages);
}

// Rows [row0, row0 + 64) of one head into a tile; the caller has told `bar` to expect them.
template <int D>
__device__ __forceinline__ void load_tile(const CUtensorMap* map, uint32_t dst, uint32_t bar,
                                          int head, int row0, int b) {
  using T = Tile<D>;
#pragma unroll
  for (int box = 0; box < T::kBoxes; ++box)
    tma_load(dst + box * T::kBoxBytes, map, bar, box * T::kBoxCols, head, row0, b);
}

// K-major operand (Q as A, K as B): 64 rows, the 16 head dims [16 kk, 16 kk + 16). Rows go
// in groups of 8 at SBO = 8 rows; the 16 dims lie inside one swizzle row, so the leading
// offset is unused (1), and a step along the head dim moves the start address only.
template <int D>
__device__ __forceinline__ uint64_t desc_k_major(uint32_t tile, int kk) {
  using T = Tile<D>;
  const int col = 16 * kk;
  const uint32_t addr = tile + (col / T::kBoxCols) * T::kBoxBytes + (col % T::kBoxCols) * 2;
  return make_desc(addr, 16, 8 * T::kRowBytes, T::kLayout);
}

// MN-major operand (V as B, transposed): the 16 keys [16 kk, 16 kk + 16) by all D head
// dims. Keys go in groups of 8 at SBO = 8 rows; the head dims are contiguous inside a
// swizzle row, and the next 64 of them (D = 128) are the next box, at LBO.
template <int D>
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t tile, int kk) {
  using T = Tile<D>;
  return make_desc(tile + 16 * kk * T::kRowBytes, T::kBoxBytes, 8 * T::kRowBytes, T::kLayout);
}

// 2^x, one MUFU instruction; results below 2^-126 flush to 0.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// S (64 x 64, f32) = A (64 x 16, smem) . B (64 x 16, smem)^T, both K-major.
__device__ __forceinline__ void mma_qk_first(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]),
        "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]),
        "=f"(d[14]), "=f"(d[15]), "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]),
        "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]),
        "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31])
      : "l"(a), "l"(b), "r"(0));
}

// S (64 x 64, f32) += A (64 x 16, smem) . B (64 x 16, smem)^T, both K-major.
__device__ __forceinline__ void mma_qk_acc(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

// O (64 x 16, f32) += A (64 x 16, bf16 registers) . B (16 x 16, smem, MN-major: tnspB).
__device__ __forceinline__ void mma_pv(float (&d)[8], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// O (64 x 32, f32) += A (64 x 16, bf16 registers) . B (16 x 32, smem, MN-major: tnspB).
__device__ __forceinline__ void mma_pv(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// O (64 x 64, f32) += A (64 x 16, bf16 registers) . B (16 x 64, smem, MN-major: tnspB).
__device__ __forceinline__ void mma_pv(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// O (64 x 128, f32) += A (64 x 16, bf16 registers) . B (16 x 128, smem, MN-major: tnspB).
__device__ __forceinline__ void mma_pv(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// p = hi + lo in bf16 pairs, each pair in one register (low half = lower column):
// hi = bf16(p), lo = bf16(p - hi). Together they carry p to about 2^-18 relative.
__device__ __forceinline__ void split_pair(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// Grid (B * H, query tiles of 128 rows). Block: warpgroup 0 is the producer (thread 0
// issues every TMA load); consumer warpgroup w (1 or 2) owns query rows
// [64 (w - 1), 64 w) of the tile, and both read the same K and V tiles. In a consumer,
// thread (warp i, lane) holds rows 16 i + lane / 4 and that + 8; in each 8-column block
// of an accumulator, columns 2 (lane % 4) and + 1 (wgmma's layout).
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ o,
                    int S, int H, int group, Strides os_, float scale, int causal) {
  using T = Tile<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sq = (smem_u32(smem_raw) + 1023u) & ~1023u;  // Q: sq + w * T::kBytes
  const uint32_t sk = sq + kConsumers * T::kBytes;            // K ring: sk + stage * T::kBytes
  const uint32_t sv = sk + kStages * T::kBytes;               // V ring
  const uint32_t bars = sv + kStages * T::kBytes;             // full_q, then per stage:
  const uint32_t full_q = bars;                               // full_k, full_v, empty_k, empty_v
  auto full_k = [bars](int s) { return bars + 8u * (1 + 4 * s); };
  auto full_v = [bars](int s) { return bars + 8u * (2 + 4 * s); };
  auto empty_k = [bars](int s) { return bars + 8u * (3 + 4 * s); };
  auto empty_v = [bars](int s) { return bars + 8u * (4 + 4 * s); };

  const int b = blockIdx.x / H, h = blockIdx.x % H, kh = h / group;
  // heaviest causal tiles (the last query rows) first, across all heads, for a shorter tail
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kConsumers * kBQ;
  // consumers whose rows start below S; the others have nothing to compute
  const int active = min(kConsumers, (S - q0 + kBQ - 1) / kBQ);
  const int n_tiles_all = (S + kBKV - 1) / kBKV;
  // KV tiles of the consumer whose rows start at row0: causal stops at its diagonal
  auto tiles_for = [=](int row0) {
    return causal ? min(n_tiles_all, row0 / kBKV + 1) : n_tiles_all;
  };

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty_k(s), 128 * active);
      mbar_init(empty_v(s), 128 * active);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer: few registers; two tiles of K and V in flight ahead of the consumers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(full_q, active * T::kBytes);
      for (int w = 0; w < active; ++w)
        load_tile<D>(&qmap, sq + w * T::kBytes, full_q, h, q0 + w * kBQ, b);
      // the last active consumer needs the most tiles; the other skips its surplus
      const int n_tiles = tiles_for(q0 + (active - 1) * kBQ);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        const uint32_t parity = ((t / kStages) & 1) ^ 1;  // the first round passes at once
        mbar_wait(empty_k(s), parity);
        mbar_expect_tx(full_k(s), T::kBytes);
        load_tile<D>(&kmap, sk + s * T::kBytes, full_k(s), kh, t * kBKV, b);
        mbar_wait(empty_v(s), parity);
        mbar_expect_tx(full_v(s), T::kBytes);
        load_tile<D>(&vmap, sv + s * T::kBytes, full_v(s), kh, t * kBKV, b);
      }
    }
    return;
  }

  const int w = threadIdx.x / 128 - 1;
  if (w >= active) return;
  // consumer: the accumulators and the P fragments live in registers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int tid = threadIdx.x % 128;
  const int qw = q0 + w * kBQ;                           // this consumer's first row
  const int r0 = 16 * (tid / 32) + (tid % 32) / 4;       // rows qw + r0 and qw + r0 + 8
  const int c0 = 2 * (tid % 4);                          // columns c0, c0 + 1 of each 8-block
  const uint32_t sqw = sq + w * T::kBytes;
  // Skipping the other consumer's last tile needs no arrival: the producer never waits
  // for the release of the last tile.
  const int n_tiles = tiles_for(qw);

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
  const float scale_log2 = scale * kLog2e;  // scores in units of log2(e): exp is one ex2

  mbar_wait(full_q, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages;
    const uint32_t parity = (t / kStages) & 1;
    const uint32_t skt = sk + s * T::kBytes, svt = sv + s * T::kBytes;

    // S = Q . K^T on the tensor cores, f32 accumulation, D / 16 steps of 16 head dims
    float sc[32];
    mbar_wait(full_k(s), parity);
    wgmma_fence();
    mma_qk_first(sc, desc_k_major<D>(sqw, 0), desc_k_major<D>(skt, 0));
#pragma unroll
    for (int kk = 1; kk < D / 16; ++kk)
      mma_qk_acc(sc, desc_k_major<D>(sqw, kk), desc_k_major<D>(skt, kk));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);
    mbar_arrive(empty_k(s));  // the K tile may be overwritten

    // mask only the diagonal tile and the ragged last one
    const int kv0 = t * kBKV;
    if ((causal && t == n_tiles - 1) || kv0 + kBKV > S) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = kv0 + 8 * (i / 4) + c0 + (i & 1);
        const int row = qw + r0 + 8 * ((i >> 1) & 1);
        if (col >= S || (causal && col > row)) sc[i] = kNegInf;
      }
    }

    // Online softmax, in units of log2(e) so that exp is one ex2: m is the running max of
    // s * scale * log2(e), scaled in f32 after the product. The four threads of a row
    // (lanes 4g..4g+3) agree on its max; the max is taken before scaling, which commutes
    // with it (scale > 0 and rounding is monotonic).
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int i = 0; i < 32; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r] * scale_log2);
      alpha[r] = ex2(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
    // p in f32; l sums this thread's columns of f32 p (the four are added at the end)
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      sc[i] = ex2(fmaf(sc[i], scale_log2, -m[r]));
      l[r] += sc[i];
    }
    // rescale acc unless no row of the warp has a new max (alpha = 1 exactly then)
    if (__any_sync(0xffffffffu, alpha[0] != 1.0f || alpha[1] != 1.0f)) {
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
    }

    // The S accumulator is already P's A-fragment layout: for keys [16 kk, 16 kk + 16),
    // register j of the fragment is the pair sc[8 kk + 2 j], sc[8 kk + 2 j + 1].
    uint32_t p_hi[4][4], p_lo[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        split_pair(sc[8 * kk + 2 * j], sc[8 * kk + 2 * j + 1], p_hi[kk][j], p_lo[kk][j]);

    // acc += P_hi . V + P_lo . V: P . V in f32 to about 2^-18, as the Pallas kernel's f32 P
    mbar_wait(full_v(s), parity);
    fence_regs(acc);
    fence_regs(p_hi);
    fence_regs(p_lo);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) mma_pv(acc, p_hi[kk], desc_mn_major<D>(svt, kk));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) mma_pv(acc, p_lo[kk], desc_mn_major<D>(svt, kk));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    fence_regs(p_hi);
    fence_regs(p_lo);
    mbar_arrive(empty_v(s));  // the V tile may be overwritten
  }

  // out = acc / max(l, 1e-30), rounded to bf16, written through the output's strides
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qw + r0 + 8 * r;
    if (row >= S) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    __nv_bfloat16* orow = o + b * os_.b + static_cast<int64_t>(row) * os_.s + h * os_.h + c0;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      __nv_bfloat162 pair;
      pair.x = __float2bfloat16_rn(acc[4 * j + 2 * r] / denom);
      pair.y = __float2bfloat16_rn(acc[4 * j + 2 * r + 1] / denom);
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) = pair;
    }
  }
}

// A 4-D map (head dim, heads, S, B) over a bf16 tensor with a contiguous head dim and the
// given strides, read in boxes of (min(D, 64), 1, 64, 1) with the swizzle of one box row.
template <int D>
cudaError_t make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int B, int S,
                     int heads, const Strides& st) {
  using T = Tile<D>;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st.h) * 2,
                                 static_cast<cuuint64_t>(st.s) * 2,
                                 static_cast<cuuint64_t>(st.b) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(T::kBoxCols), 1, kBKV, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle = T::kRowBytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : T::kRowBytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                          : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                            strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int S, int H,
                   int K, const Strides& qs, const Strides& ks, const Strides& vs,
                   const Strides& os, float scale, int causal, cudaStream_t stream) {
  const int n_q = (S + kConsumers * kBQ - 1) / (kConsumers * kBQ);
  if (n_q > 65535) return cudaErrorInvalidValue;
  EncodeTiled encode;
  cudaError_t err = encode_tiled(&encode);
  if (err != cudaSuccess) return err;
  CUtensorMap qm, km, vm;
  if ((err = make_map<D>(encode, &qm, q, B, S, H, qs)) != cudaSuccess) return err;
  if ((err = make_map<D>(encode, &km, k, B, S, K, ks)) != cudaSuccess) return err;
  if ((err = make_map<D>(encode, &vm, v, B, S, K, vs)) != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_bytes<D>()));
  if (err != cudaSuccess) return err;
  flash_tc_kernel<D><<<dim3(B * H, n_q), kThreads, smem_bytes<D>(), stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), S, H, H / K, os, scale, causal);
  return cudaGetLastError();
}

}  // namespace tc

cudaError_t dispatch_bf16(int hd, const void* q, const void* k, const void* v, void* o, int B,
                          int S, int H, int K, const Strides& qs, const Strides& ks,
                          const Strides& vs, const Strides& os, float scale, int causal,
                          cudaStream_t stream) {
  switch (hd) {
    case 16:
      return tc::launch<16>(q, k, v, o, B, S, H, K, qs, ks, vs, os, scale, causal, stream);
    case 32:
      return tc::launch<32>(q, k, v, o, B, S, H, K, qs, ks, vs, os, scale, causal, stream);
    case 64:
      return tc::launch<64>(q, k, v, o, B, S, H, K, qs, ks, vs, os, scale, causal, stream);
    case 128:
      return tc::launch<128>(q, k, v, o, B, S, H, K, qs, ks, vs, os, scale, causal, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, S, H, hd), k and v (B, S, K, hd) and o (B, S, H, hd), all float32 (dtype 0, the
// FMA kernel) or all bfloat16 (dtype 1, the tensor-core kernel), on CUDA device `device`,
// each with a contiguous head dim and the other strides (in elements) given. bfloat16 q, k
// and v are read by TMA: 16-byte aligned, with strides that are multiples of 8 elements.
// hd in {16, 32, 64, 128}, H % K == 0. Launches on `stream` and does not synchronise.
// Returns the cudaError_t of the launch (0 on success). This library carries its own CUDA
// runtime, whose current device is set here, not by PyTorch.
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
          ? dispatch_f32(hd, q, k, v, o, B, S, H, K, qs, ks, vs, os, scale, causal, s)
          : dispatch_bf16(hd, q, k, v, o, B, S, H, K, qs, ks, vs, os, scale, causal, s);
  return static_cast<int>(err);
}

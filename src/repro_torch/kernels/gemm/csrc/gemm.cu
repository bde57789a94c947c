// out = x . y^T in float32 on Hopper's (sm_90a) tensor cores, as three TF32 products.
//
// Replaces no Pallas kernel: the JAX package leaves MSET2's W = Ginv K and X_hat = W^T D to
// XLA's dot, and so did the port, to cuBLAS. The configurations hold float32 with TF32 off, so
// cuBLAS takes those products on the CUDA cores' FMA units (~50 of their 67 TFLOP/s at
// 8192^3). This kernel takes them on the tensor cores instead, at float32's accuracy, with
// K1's arithmetic (similarity.cu): each operand split into TF32 hi + lo,
// x.y = xl.yh + xh.yl + xh.yh, each 32-deep K tile summed from zero by the tensor cores'
// truncating adder and then promoted into an IEEE float32 accumulator.
// tests/test_torch_gemm.py emulates this on the CPU.
//
// What bounds it: 2 m n k operations against (m + n) k inputs and m n outputs, so at MSET2's
// shapes (k = 8,192 memory vectors) the operations, three times over; the split passes
// before it are bound by bytes (one read, two planes written).
//
// Three kernels, launched by the wrapper on one stream:
// - gemm_split_rows_kernel: a row-major (rows, k) operand, K-major already (Ginv), into hi
//   and lo planes (2, rows, k_pad) of float32 scratch, one warp a row; k_pad is k rounded up
//   to the 32-float K tile, zeros past k, so every TMA row stride is legal and the padding
//   adds nothing to the product.
// - gemm_split_t_kernel: a row-major (k, rows) operand (K from K1, W as this kernel wrote it,
//   D: each one's rows are the contraction) into the same planes of its transpose, through a
//   32 x 32 tile in shared memory, so that both reads and writes are whole 128-byte lines.
//   TF32 wgmma reads both operands K-major, so the transpose has to be made somewhere; here
//   it costs one pass.
// - gemm_tf32x3_kernel: K1's main loop (kernels/csrc/tf32.cuh, shared with similarity.cu)
//   with no epilogue but the stores. One block of 384 threads an SM computes one 128 x 128
//   tile of out, tiles numbered in bands of 16 row blocks. Warpgroup 0 is the producer, one
//   thread of which issues TMA loads of the x and y tiles (hi and lo planes, 32 floats deep,
//   128 B swizzle) into a ring of 3 stages; two consumer warpgroups own 64 rows of the tile
//   each and run wgmma m64n128k8 from shared memory: in each 8-deep step lo.hi and hi.lo
//   first, then hi.hi, summed from zero a K tile, then added into the float32 accumulator.
//   Masked stores of the accumulator end it.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "../../csrc/hopper.cuh"  // mbarriers, TMA, wgmma descriptors and fences
#include "../../csrc/tf32.cuh"    // the TF32 split and the shared 3xTF32 main loop

namespace {

using namespace hopper;

constexpr int kSplitRows = 8;  // rows (warps) a block of gemm_split_rows_kernel
constexpr int kTT = 32;        // the transposing split's tile

__global__ void __launch_bounds__(32 * kSplitRows)
    gemm_split_rows_kernel(const float* __restrict__ src, float* __restrict__ dst, int rows,
                           int k, int k_pad) {
  const int row = blockIdx.x * kSplitRows + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const float* s = src + static_cast<size_t>(row) * k;
  float* hi = dst + static_cast<size_t>(row) * k_pad;
  float* lo = hi + static_cast<size_t>(rows) * k_pad;
#pragma unroll 4
  for (int c = lane; c < k_pad; c += 32) {
    const float v = c < k ? s[c] : 0.0f;
    const float h = tf32_rna(v);
    hi[c] = h;
    lo[c] = tf32_rna(v - h);
  }
}

// Block (blockIdx.x, blockIdx.y) reads src rows [32 y, 32 y + 32) (along k) by columns
// [32 x, 32 x + 32) (along rows) and writes the transposed tile's hi and lo; zeros past k.
__global__ void __launch_bounds__(32 * 8)
    gemm_split_t_kernel(const float* __restrict__ src, float* __restrict__ dst, int rows, int k,
                        int k_pad) {
  __shared__ float tile[kTT][kTT + 1];  // +1: a column of the tile falls in 32 banks
  const int r0 = blockIdx.x * kTT, c0 = blockIdx.y * kTT;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
#pragma unroll
  for (int i = ty; i < kTT; i += 8) {
    const int c = c0 + i, r = r0 + tx;
    tile[i][tx] = c < k && r < rows ? src[static_cast<size_t>(c) * rows + r] : 0.0f;
  }
  __syncthreads();
#pragma unroll
  for (int i = ty; i < kTT; i += 8) {
    const int r = r0 + i;
    if (r >= rows) continue;
    const float v = tile[tx][i];
    const float h = tf32_rna(v);
    float* hi = dst + static_cast<size_t>(r) * k_pad + c0 + tx;
    hi[0] = h;
    hi[static_cast<size_t>(rows) * k_pad] = tf32_rna(v - h);
  }
}

// Grid: one block a 128 x 128 tile of out, numbered in bands. Block: the shared main loop
// (tf32x3_tile), then each consumer's masked stores of its rows.
__global__ void __launch_bounds__(kThreads, 1)
    gemm_tf32x3_kernel(const __grid_constant__ CUtensorMap xmap,
                       const __grid_constant__ CUtensorMap ymap, float* __restrict__ out, int m,
                       int n, int n_kt) {
  extern __shared__ uint8_t smem_raw[];
  tf32x3_tile<true>(smem_raw, &xmap, &ymap, m, n, n_kt, [=](float (&acc)[64], int r0, int c0) {
    const bool pairs = (n % 2) == 0;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + 8 * r;
      if (row >= m) continue;
      float* orow = out + static_cast<size_t>(row) * n;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        store_pair(orow, c0 + 8 * j, n, pairs, acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
      }
    }
  });
}

}  // namespace

// Split src into hi and lo planes dst (2, rows, k_pad), float32, k_pad a positive multiple of
// 32 >= k, zeros past k: src is (rows, k) row-major, or with transposed != 0 (k, rows)
// row-major, whose transpose is split. On CUDA device `device`, launched on `stream`, not
// synchronised; returns the cudaError_t of the launch (0 on success). This library carries
// its own CUDA runtime, whose current device is set here, not by PyTorch.
extern "C" int gemm_split_launch(const float* src, float* dst, int rows, int k, int k_pad,
                                 int transposed, int device, void* stream) {
  if (rows <= 0 || k < 0 || k_pad < k || k_pad <= 0 || k_pad % kKT != 0 ||
      (transposed && k_pad / kTT > 65535)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (transposed) {
    const dim3 grid((rows + kTT - 1) / kTT, k_pad / kTT);
    gemm_split_t_kernel<<<grid, 32 * 8, 0, s>>>(src, dst, rows, k, k_pad);
  } else {
    const int blocks = (rows + kSplitRows - 1) / kSplitRows;
    gemm_split_rows_kernel<<<blocks, 32 * kSplitRows, 0, s>>>(src, dst, rows, k, k_pad);
  }
  return static_cast<int>(cudaGetLastError());
}

// out (m, n) row-major float32 = x . y^T from the split planes x_split (2, m, k_pad) and
// y_split (2, n, k_pad) that gemm_split_launch wrote, 16-byte aligned. Device, stream and
// return value as above.
extern "C" int gemm_tf32x3_launch(const float* x_split, const float* y_split, float* out, int m,
                                  int n, int k_pad, int device, void* stream) {
  const long long tiles =
      static_cast<long long>((m + kBM - 1) / kBM) * static_cast<long long>((n + kBN - 1) / kBN);
  if (m <= 0 || n <= 0 || k_pad <= 0 || k_pad % kKT != 0 || tiles > 0x7FFFFFFFLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  EncodeTiled encode;
  if ((err = encode_tiled(&encode)) != cudaSuccess) return static_cast<int>(err);
  CUtensorMap xm, ym;
  if ((err = make_map(encode, &xm, x_split, m, k_pad, 2)) != cudaSuccess ||
      (err = make_map(encode, &ym, y_split, n, k_pad, 2)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  err = cudaFuncSetAttribute(gemm_tf32x3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_bytes<true>()));
  if (err != cudaSuccess) return static_cast<int>(err);
  gemm_tf32x3_kernel<<<static_cast<unsigned>(tiles), kThreads, smem_bytes<true>(),
                       static_cast<cudaStream_t>(stream)>>>(xm, ym, out, m, n, k_pad / kKT);
  return static_cast<int>(cudaGetLastError());
}

// Two-sided SPRT (sequential probability ratio test) over MSET2 residuals, on Hopper (sm_90a).
//
// The port's own kernel (K3): it replaces the lax.scan of src/repro/mset/sprt.py:sprt, which the
// JAX package compiles into one loop and eager PyTorch would run as a Python loop over time, four
// launches a step. For each signal j and time t, with z = (r[t, j] - mu[j]) / sigma[j]:
//   sp = max(sp + (M z - M^2/2), lower), sn = max(sn + (-M z - M^2/2), lower)   (NaN propagates)
//   alarm[t, j] = sp >= upper || sn >= upper; each sum that reached upper restarts at 0.
// Outputs: alarms (T, n) as bytes of 0 or 1 (a torch.bool tensor), and the sums after the restart
// in one (T, 2, n) float32 array, [positive, negative] a step, the plain version's layout.
//
// What bounds it: bytes. It reads the residuals once (4 T n bytes) and writes 9 T n bytes, a few
// operations an element; 65,536 x 1024 residuals are 0.27 GB in and 0.60 GB out, 0.26 ms at
// 3.35 TB/s. The recursion is sequential in t, so one thread walks time for one signal with both
// sums in registers, and a warp's 32 signals make each load and store one coalesced row segment.
// Blocks are one warp, so 1024 signals spread over 32 SMs instead of packing onto 8. Only the sums
// carry a dependence: the residuals of the next kChunk steps are loaded while the current chunk's
// recursion runs, so each thread keeps a chunk of loads in flight. A time-parallel (chunked) scan
// that fills the whole card is later work.
//
// Bit-equality with the plain version (kernels/sprt/ref.py) and the JAX package: every float op is
// an IEEE round-to-nearest intrinsic in the plain version's order (subtract mu, divide by sigma,
// multiply by M, subtract M^2/2, add, clamp, compare), since nvcc would otherwise contract
// M * z - M^2/2 into one FMA while torch runs the multiply and the subtract as two kernels. The
// clamp is written s < lower ? lower : s, which keeps a NaN as torch's clamp does (fmaxf would not).

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 32;  // one warp a block (above)
constexpr int kChunk = 32;    // steps loaded ahead of the recursion

struct Params {
  const float* r;
  const float* mu;  // null: no mean to subtract
  const float* sigma;
  uint8_t* alarms;
  float* llr;
  long long T;
  int n;
  float m_pos, m_neg, half_m2, upper, lower;
};

__device__ __forceinline__ void load_chunk(const Params& p, int j, long long t0, float (&v)[kChunk]) {
#pragma unroll
  for (int u = 0; u < kChunk; ++u) {
    const long long t = t0 + u;
    v[u] = t < p.T ? __ldcs(p.r + static_cast<size_t>(t) * p.n + j) : 0.0f;
  }
}

__device__ __forceinline__ float update(float s, float inc, float lower) {
  s = __fadd_rn(s, inc);
  return s < lower ? lower : s;  // NaN < lower is false: a NaN sum stays NaN
}

__global__ void __launch_bounds__(kThreads) sprt_kernel(const Params p) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= p.n) return;
  const bool has_mu = p.mu != nullptr;
  const float mu = has_mu ? p.mu[j] : 0.0f;
  const float sigma = p.sigma[j];
  const size_t row = static_cast<size_t>(p.n);
  float sp = 0.0f, sn = 0.0f;
  float cur[kChunk], nxt[kChunk];
  load_chunk(p, j, 0, cur);
  for (long long t0 = 0; t0 < p.T; t0 += kChunk) {
    load_chunk(p, j, t0 + kChunk, nxt);
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      const long long t = t0 + u;
      if (t < p.T) {
        const float x = has_mu ? __fsub_rn(cur[u], mu) : cur[u];
        const float z = __fdiv_rn(x, sigma);
        sp = update(sp, __fsub_rn(__fmul_rn(p.m_pos, z), p.half_m2), p.lower);
        sn = update(sn, __fsub_rn(__fmul_rn(p.m_neg, z), p.half_m2), p.lower);
        const bool hp = sp >= p.upper, hn = sn >= p.upper;
        if (hp) sp = 0.0f;  // restart after a decision
        if (hn) sn = 0.0f;
        const size_t at = static_cast<size_t>(t) * row + j;
        __stcs(p.alarms + at, static_cast<uint8_t>(hp || hn));
        __stcs(p.llr + 2 * static_cast<size_t>(t) * row + j, sp);
        __stcs(p.llr + (2 * static_cast<size_t>(t) + 1) * row + j, sn);
      }
    }
#pragma unroll
    for (int u = 0; u < kChunk; ++u) cur[u] = nxt[u];
  }
}

}  // namespace

// Launch on `stream`; returns a cudaError_t (0 on success). mu may be null. Nothing is
// allocated and nothing synchronises.
extern "C" int sprt_launch(const float* r, const float* mu, const float* sigma, uint8_t* alarms,
                           float* llr, long long T, int n, float m_pos, float m_neg, float half_m2,
                           float upper, float lower, int device, void* stream) {
  if (T <= 0 || n <= 0 || r == nullptr || sigma == nullptr || alarms == nullptr ||
      llr == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Params p{r, mu, sigma, alarms, llr, T, n, m_pos, m_neg, half_m2, upper, lower};
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  sprt_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

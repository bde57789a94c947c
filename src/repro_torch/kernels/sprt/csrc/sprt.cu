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
// 3.35 TB/s. The recursion is sequential in t, and one thread walking all of time for one signal
// takes ~100 ns a step whatever n is. So time is cut into C chunks of L steps that run side by
// side: a chunked, time-parallel scan in two launches. The wrapper picks L so that C x n threads
// fill the card; with one chunk (n alone fills it, or T is short) pass 1 is the whole recursion.
//
// Pass 1 (sprt_scan_kernel, speculative): one thread for each (chunk c, signal j) runs chunk c's
// steps. Chunk 0 starts from the true start (0, 0), every later chunk from a guess, (lower, lower).
// Adjacent threads take adjacent signals, so each load and store is a coalesced row segment; each
// thread keeps the next kAhead steps' loads in flight.
//
// Pass 2 (sprt_fixup_kernel, exact): the true start of chunk c is the pair stored at chunk c-1's
// last step, once chunk c-1 is exact. The recursion forgets its past whenever a sum is clamped to
// lower or restarted at 0: once the true trajectory and pass 1's meet, bit for bit, they stay
// together. So chunk c is re-run from its true start, rewriting alarm and sums step by step, only
// while the re-run state entering a step differs in its bits (NaN and signed zeros included) from
// pass 1's state entering it; usually for no step or a few. Chunks are taken in order for each
// signal, as a walk from chunk 1 to chunk C-1 would take them, and give the same outputs and the
// same count of re-run steps; but one warp holds a signal and its 32 lanes take 32 chunks at once.
// Each lane loads its chunk's head (the pair ending the chunk before, and the first kHead steps'
// residuals and pass-1 sums: fixed addresses, loaded together) and re-runs the head with no
// branch, from the pair pass 1 stored. That pair is the true start unless the chunk before is
// rewritten to its end; when no chunk of the group is (the rule: a re-run meets pass 1 within a
// few steps), each lane writes its own head. Otherwise the group is resolved lane by lane, in
// order, the rewritten end state passed on by a shuffle, steps past the head loaded kWindow at a
// time. A chunk that never meets (a NaN residual: a NaN sum never meets a finite one; or a periodic
// input whose restarts keep their own phase) is rewritten to its end, so such a signal is walked
// step by step from there on: correct, and as slow as one thread walking time. A walk of one
// thread a signal took ~0.8 us a chunk, latency-bound on each chunk's branches and loads; two
// passes were kept over one kernel with decoupled look-back, which would chain the chunks' blocks
// through device memory and make pass 1 wait on that chain.
//
// Bit-equality with the plain version (kernels/sprt/ref.py) and the JAX package: every float op is
// an IEEE round-to-nearest intrinsic in the plain version's order (subtract mu, divide by sigma,
// multiply by M, subtract M^2/2, add, clamp, compare), since nvcc would otherwise contract
// M * z - M^2/2 into one FMA while torch runs the multiply and the subtract as two kernels. The
// clamp is written s < lower ? lower : s, which keeps a NaN as torch's clamp does (fmaxf would
// not).

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 128;     // pass 1: threads a block, fewer when n is small
constexpr int kAhead = 16;        // pass 1: steps loaded ahead of the recursion
constexpr int kFixThreads = 128;  // pass 2: four warps a block, one signal a warp
constexpr int kHead = 4;          // pass 2: steps of a chunk re-run speculatively
constexpr int kWindow = 8;        // pass 2: steps loaded together past the head
constexpr unsigned kAll = 0xffffffffu;

struct Params {
  const float* r;
  const float* mu;  // null: no mean to subtract
  const float* sigma;
  uint8_t* alarms;
  float* llr;
  long long T;
  long long L;     // chunk length in steps
  int n;
  int sig_blocks;  // pass-1 blocks a chunk
  float m_pos, m_neg, half_m2, upper, lower;
};

__device__ __forceinline__ float update(float s, float inc, float lower) {
  s = __fadd_rn(s, inc);
  return s < lower ? lower : s;  // NaN < lower is false: a NaN sum stays NaN
}

// One step of the recursion on residual x; returns the alarm.
__device__ __forceinline__ bool step(const Params& p, float x, float mu, float sigma, float& sp,
                                     float& sn) {
  const float v = p.mu != nullptr ? __fsub_rn(x, mu) : x;
  const float z = __fdiv_rn(v, sigma);
  sp = update(sp, __fsub_rn(__fmul_rn(p.m_pos, z), p.half_m2), p.lower);
  sn = update(sn, __fsub_rn(__fmul_rn(p.m_neg, z), p.half_m2), p.lower);
  const bool hp = sp >= p.upper, hn = sn >= p.upper;
  if (hp) sp = 0.0f;  // restart after a decision
  if (hn) sn = 0.0f;
  return hp || hn;
}

__device__ __forceinline__ size_t at(const Params& p, long long t, int j) {
  return static_cast<size_t>(t) * static_cast<size_t>(p.n) + j;
}

__device__ __forceinline__ float* pos(const Params& p, long long t, int j) {
  return p.llr + 2 * static_cast<size_t>(t) * static_cast<size_t>(p.n) + j;
}

__device__ __forceinline__ float* neg(const Params& p, long long t, int j) {
  return pos(p, t, j) + p.n;
}

__device__ __forceinline__ bool same(float a, float b, float c, float d) {
  return __float_as_uint(a) == __float_as_uint(c) && __float_as_uint(b) == __float_as_uint(d);
}

__device__ __forceinline__ void store(const Params& p, long long t, int j, bool alarm, float sp,
                                      float sn) {
  p.alarms[at(p, t, j)] = static_cast<uint8_t>(alarm);
  *pos(p, t, j) = sp;
  *neg(p, t, j) = sn;
}

__global__ void __launch_bounds__(kThreads) sprt_scan_kernel(const Params p) {
  const long long c = blockIdx.x / p.sig_blocks;
  const int j = static_cast<int>(blockIdx.x % p.sig_blocks) * blockDim.x + threadIdx.x;
  if (j >= p.n) return;
  const float mu = p.mu != nullptr ? p.mu[j] : 0.0f;
  const float sigma = p.sigma[j];
  const long long t_begin = c * p.L;
  const long long t_end = t_begin + p.L < p.T ? t_begin + p.L : p.T;
  float sp = c == 0 ? 0.0f : p.lower, sn = sp;  // the true start, or the guess
  float cur[kAhead], nxt[kAhead];
  const auto load = [&](long long t0, float(&buf)[kAhead]) {
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const long long t = t0 + u;
      buf[u] = t < t_end ? __ldcs(p.r + at(p, t, j)) : 0.0f;
    }
  };
  load(t_begin, cur);
  for (long long t0 = t_begin; t0 < t_end; t0 += kAhead) {
    load(t0 + kAhead, nxt);
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const long long t = t0 + u;
      if (t < t_end) {
        const bool alarm = step(p, cur[u], mu, sigma, sp, sn);
        __stcs(p.alarms + at(p, t, j), static_cast<uint8_t>(alarm));
        __stcs(pos(p, t, j), sp);
        __stcs(neg(p, t, j), sn);
      }
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) cur[u] = nxt[u];
  }
}

// Re-run from step t while the true state (sp, sn) differs from pass 1's state entering the step
// (gp, gn), rewriting each step; steps are loaded kWindow at a time. Returns the step it stopped
// at: t1, or the first step whose entering states agree. The sums are read with plain loads.
__device__ __forceinline__ long long walk(const Params& p, int j, long long t, long long t1,
                                          float mu, float sigma, float& sp, float& sn, float& gp,
                                          float& gn) {
  while (t < t1 && !same(sp, sn, gp, gn)) {
    float wx[kWindow], wp[kWindow], wn[kWindow];
#pragma unroll
    for (int u = 0; u < kWindow; ++u) {
      const bool in_chunk = t + u < t1;
      wx[u] = in_chunk ? __ldg(p.r + at(p, t + u, j)) : 0.0f;
      wp[u] = in_chunk ? *pos(p, t + u, j) : 0.0f;
      wn[u] = in_chunk ? *neg(p, t + u, j) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kWindow; ++u) {
      if (t < t1 && !same(sp, sn, gp, gn)) {
        store(p, t, j, step(p, wx[u], mu, sigma, sp, sn), sp, sn);
        gp = wp[u];
        gn = wn[u];
        ++t;
      }
    }
  }
  return t;
}

// One warp a signal; lane l takes chunk c0 + l of each group of 32 chunks. rerun, when not null,
// gets the steps re-run added to rerun[0] and the most re-run in one chunk of one signal in
// rerun[1].
__global__ void __launch_bounds__(kFixThreads) sprt_fixup_kernel(const Params p,
                                                                 unsigned long long* rerun) {
  const long long thread = static_cast<long long>(blockIdx.x) * kFixThreads + threadIdx.x;
  const int j = static_cast<int>(thread / 32);
  const int lane = threadIdx.x % 32;
  if (j >= p.n) return;  // the whole warp
  const float mu = p.mu != nullptr ? p.mu[j] : 0.0f;
  const float sigma = p.sigma[j];
  const long long C = (p.T + p.L - 1) / p.L;
  bool carried = false;  // the chunk before the group was rewritten to its end, ending in (tp, tn)
  float tp = 0.0f, tn = 0.0f;
  unsigned long long total = 0, most = 0;
  for (long long c0 = 1; c0 < C; c0 += 32) {
    const long long c = c0 + lane;
    const bool live = c < C;
    const long long t0 = c * p.L;
    const long long t1 = t0 + p.L < p.T ? t0 + p.L : p.T;
    // Speculate: the chunk's start is pass 1's end of the chunk before. It is the true start unless
    // that chunk is rewritten to its end, which the ordered resolution below takes care of.
    float sp = live ? *pos(p, t0 - 1, j) : 0.0f, sn = live ? *neg(p, t0 - 1, j) : 0.0f;
    float hx[kHead], hp[kHead], hn[kHead];
#pragma unroll
    for (int w = 0; w < kHead; ++w) {
      const bool in_chunk = live && t0 + w < t1;
      hx[w] = in_chunk ? __ldg(p.r + at(p, t0 + w, j)) : 0.0f;
      hp[w] = in_chunk ? *pos(p, t0 + w, j) : 0.0f;
      hn[w] = in_chunk ? *neg(p, t0 + w, j) : 0.0f;
    }
    float gp = p.lower, gn = p.lower;  // pass 1's state entering step t0 + ran
    float op[kHead], on[kHead];
    bool oa[kHead];
    int ran = 0;
    bool run = live;
#pragma unroll
    for (int w = 0; w < kHead; ++w) {  // no branch: the lanes' chunks re-run side by side
      run = run && t0 + w < t1 && !same(sp, sn, gp, gn);
      float np = sp, nn = sn;
      oa[w] = step(p, hx[w], mu, sigma, np, nn);
      op[w] = np;
      on[w] = nn;
      sp = run ? np : sp;
      sn = run ? nn : sn;
      gp = run ? hp[w] : gp;
      gn = run ? hn[w] : gn;
      ran += run;
    }
    const bool more = run && t0 + kHead < t1 && !same(sp, sn, gp, gn);
    const bool to_end = live && t0 + ran == t1;
    const unsigned slow = __ballot_sync(kAll, more || to_end);
    if (!carried && slow == 0) {
      // No chunk of the group is rewritten to its end: each lane's speculation was right.
#pragma unroll
      for (int w = 0; w < kHead; ++w) {
        if (w < ran) store(p, t0 + w, j, oa[w], op[w], on[w]);
      }
      total += ran;
      most = ran > most ? ran : most;
      continue;
    }
    // Otherwise resolve the group's chunks in order, one lane at a time.
    for (int l = 0; l < 32 && c0 + l < C; ++l) {
      bool ended = false;
      if (lane == l) {
        long long t = t0 + ran;
        if (carried) {  // start again from the true start, with nothing rewritten yet
          sp = tp;
          sn = tn;
          gp = gn = p.lower;
          t = t0;
        } else {
#pragma unroll
          for (int w = 0; w < kHead; ++w) {
            if (w < ran) store(p, t0 + w, j, oa[w], op[w], on[w]);
          }
        }
        t = walk(p, j, t, t1, mu, sigma, sp, sn, gp, gn);
        const unsigned long long steps = static_cast<unsigned long long>(t - t0);
        total += steps;
        most = steps > most ? steps : most;
        ended = t == t1;  // rewritten to the end: the next chunk starts from (sp, sn)
      }
      carried = __shfl_sync(kAll, ended, l);
      tp = __shfl_sync(kAll, sp, l);
      tn = __shfl_sync(kAll, sn, l);
    }
  }
  if (rerun != nullptr) {
#pragma unroll
    for (int d = 16; d > 0; d /= 2) {
      total += __shfl_down_sync(kAll, total, d);
      const unsigned long long other = __shfl_down_sync(kAll, most, d);
      most = other > most ? other : most;
    }
    if (lane == 0) {
      atomicAdd(rerun, total);
      atomicMax(rerun + 1, most);
    }
  }
}

}  // namespace

// Launch both passes on `stream`, with chunks of L steps; returns a cudaError_t (0 on success).
// mu and rerun may be null. Nothing is allocated and nothing synchronises.
extern "C" int sprt_launch(const float* r, const float* mu, const float* sigma, uint8_t* alarms,
                           float* llr, long long T, int n, long long L, float m_pos, float m_neg,
                           float half_m2, float upper, float lower, unsigned long long* rerun,
                           int device, void* stream) {
  if (T <= 0 || n <= 0 || L <= 0 || r == nullptr || sigma == nullptr || alarms == nullptr ||
      llr == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long C = (T + L - 1) / L;
  const int threads = n < kThreads ? (n + 31) / 32 * 32 : kThreads;
  const int sig_blocks = (n + threads - 1) / threads;
  const long long fix_blocks = (32LL * n + kFixThreads - 1) / kFixThreads;
  if (C > INT_MAX / sig_blocks || fix_blocks > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Params p{r, mu, sigma, alarms, llr, T, L, n, sig_blocks,
                 m_pos, m_neg, half_m2, upper, lower};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  sprt_scan_kernel<<<static_cast<unsigned>(C * sig_blocks), threads, 0, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || C == 1) return static_cast<int>(err);
  sprt_fixup_kernel<<<static_cast<unsigned>(fix_blocks), kFixThreads, 0, s>>>(p, rerun);
  return static_cast<int>(cudaGetLastError());
}

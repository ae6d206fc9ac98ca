// Kernel B3/B4: k fused K-slot exclusion steps per replica.
//
// Replaces both TPU kernels hydrolim_tpu/ops/pallas_exclusion.py:403
// (`exclusion_multi_step`, B3) and hydrolim_tpu/ops/pallas_exclusion_rb.py:222
// (`exclusion_multi_step_rb`, B4).  They compute one law in two layouts,
// (R, Kp, Lp) and (K, R, Lp), chosen to fill the TPU's sublanes; here both
// are the (B, K, L) slot field of ops/exclusion_kernel.py.
//
// What bounds it on an H100: a step couples each site to its neighbours
// three times over (neighbour occupancy gates the hops, admission at the
// destination decides who leaves the source, the new slots gather the
// incomers), and with local m each site reads a band of 2r+1 sites.  So
// a step is a chain of phases with a block barrier between each, and a
// replica is one unit of synchronisation: one block, one SM.  The sweep's
// 33 replicas fill 33 of 132 SMs and leave 99 idle.  Per slot-step the
// work is a few float compares, one expf, one Philox call for occupied
// slots only, and at most 4K^2 integer compares per site for admission;
// the bytes are the replica's slots, read and written once per call.
// What bounds the step is therefore latency: three barriers and the
// dependent chain of each phase, not bytes and not arithmetic throughput.
//
// Design: one block per replica keeps its (K, L) slots in shared memory
// for all k steps (double-buffered), with per-site occupancy, signed
// counts, admission masks and per-slot events and priorities beside them
// ((13K + 12)·L bytes and the band's taps, 51 KB at K=3, L=1000; dynamic
// shared memory).
// Threads own sites, looping when L exceeds the block.  Per step:
//   P2  per site: m (global, from the exact integer sums of the previous
//       phase; or local, the band of weights applied to the signed and
//       total counts: the interior sites [lo, hi) that the band's builder
//       found to share one row of taps, translated, read those taps from
//       shared memory; the sites near the walls and the wrap read their
//       rows, strided, from device memory), then per slot the rates
//       from the PRE-step neighbour occupancy, the event and the priority;
//   P3  per destination site: the <= 2K candidates from x-1 (right
//       movers) and x+1 (left movers); a candidate is admitted iff fewer
//       than free = K - occ candidates have a smaller priority (the same
//       outcome as K rounds of "admit the minimum while free > round":
//       priorities are unique by their row ids);
//   P4  per site: stayers (negated on a flip), then right-, then left-
//       incomers, packed front-first into the other buffer; the same
//       thread counts the new site for the next step's m (P1).
// Three barriers per step.  K is a template parameter (1..8), so the
// candidate loops unroll into registers.
//
// Arithmetic that must equal the plain version's bit for bit is written
// with __fmul_rn/__fadd_rn/__fdiv_rn (never contracted into an FMA), in
// the plain version's order; the smoothing sums run over ascending input
// sites.  expf is the card's, as torch.exp's on the card.
//
// Later work, not done here: spreading a replica over a thread-block
// cluster, or several small replicas per block, to use the idle SMs.
//
// Random bits: injected (noise, (B, k, 2, K, L) uint32 held in int32;
// draw 0 = event, 1 = priority) or native Philox4x32-10 with key
// (seed[b], b) and counter (k*L + x, step0 + s, 0, 0), words 0 and 1.
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int kMaxThreads = 1024;
constexpr uint32_t kSent = 0x7FFFFFFFu;
constexpr int8_t kNone = 0, kLeft = 1, kRight = 2, kFlip = 3;

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sites x-1 and x+1, or -1 past a wall.
__device__ __forceinline__ int left_of(int x, int L, int periodic) {
  return x > 0 ? x - 1 : (periodic ? L - 1 : -1);
}
__device__ __forceinline__ int right_of(int x, int L, int periodic) {
  return x + 1 < L ? x + 1 : (periodic ? 0 : -1);
}

template <int K>
__global__ void __launch_bounds__(kMaxThreads)
exclusion_kernel(const float* __restrict__ scal, const int* __restrict__ seeds,
                 int step0, const int* __restrict__ slots_in,
                 int* __restrict__ slots_out, const int* __restrict__ noise,
                 const int* __restrict__ band_idx,
                 const float* __restrict__ band_w,
                 const float* __restrict__ band_taps, int W, int radius,
                 int lo, int hi, int L, int k_steps, float dt, int periodic,
                 int bidirectional) {
  extern __shared__ int smem[];
  __shared__ int red[2][32];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int KL = K * L;
  int* cur = smem;                              // (K, L) slots
  int* nxt = smem + KL;                         // (K, L) next slots
  int* occ = smem + 2 * KL;                     // (L,) occupancy
  int* cnt = occ + L;                           // (L,) signed count
  int* inmask = cnt + L;                        // (L,) admitted incomers
  uint32_t* prio = reinterpret_cast<uint32_t*>(inmask + L);   // (K, L)
  float* taps = reinterpret_cast<float*>(prio + KL);          // (W,)
  int8_t* ev = reinterpret_cast<int8_t*>(taps + W);           // (K, L)

  const bool local_m = band_w != nullptr;
  // Sites x in [lo, hi) read inputs x - radius + t with band_taps (the
  // band's builder checked that their rows are exactly these): the taps
  // come from shared memory and the inputs need no index table.  The other
  // sites read their row of the band from global memory.
  for (int t = tid; t < W && lo < hi; t += nt) taps[t] = band_taps[t];
  const float neg_beta = -scal[3 * b];
  const float p_dif = __fmul_rn(scal[3 * b + 1], dt);
  const float p_act = __fmul_rn(scal[3 * b + 2], dt);
  const uint2 key = make_uint2((uint32_t)seeds[b], (uint32_t)b);
  const size_t off = (size_t)b * KL;

  // P1: per-site occupancy and signed count, and their block sums (warp
  // partials in `red`); later steps do this inside P4
  {
    int ls = 0, ln = 0;
    for (int x = tid; x < L; x += nt) {
      int o = 0, c = 0;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int v = slots_in[off + k * L + x];
        cur[k * L + x] = v;
        o += v != 0;
        c += (v > 0) - (v < 0);
      }
      occ[x] = o;
      cnt[x] = c;
      ls += c;
      ln += o;
    }
    ls = warp_sum(ls);
    ln = warp_sum(ln);
    if ((tid & 31) == 0) {
      red[0][tid >> 5] = ls;
      red[1][tid >> 5] = ln;
    }
  }
  __syncthreads();

  for (int s = 0; s < k_steps; ++s) {
    float m_glob = 0.f;
    if (!local_m) {
      int S = 0, N = 0;
      for (int w = 0; w < (nt >> 5); ++w) {
        S += red[0][w];
        N += red[1][w];
      }
      m_glob = __fdiv_rn((float)S, fmaxf((float)N, 1.0f));
    }
    const int* nz =
        noise ? noise + ((size_t)b * k_steps + s) * 2 * KL : nullptr;

    // P2: m, rates, events and priorities
    for (int x = tid; x < L; x += nt) {
      float m = m_glob;
      if (local_m) {
        float c0 = 0.f, c1 = 0.f;
        if (x >= lo && x < hi) {
          for (int t = 0; t < W; ++t) {
            const int i = x - radius + t;
            c0 = __fadd_rn(c0, __fmul_rn(taps[t], (float)cnt[i]));
            c1 = __fadd_rn(c1, __fmul_rn(taps[t], (float)occ[i]));
          }
        } else {
          const int* bi = band_idx + (size_t)x * W;
          const float* bw = band_w + (size_t)x * W;
          for (int t = 0; t < W; ++t) {
            const int i = bi[t];
            const float w = bw[t];
            c0 = __fadd_rn(c0, __fmul_rn(w, (float)cnt[i]));
            c1 = __fadd_rn(c1, __fmul_rn(w, (float)occ[i]));
          }
        }
        m = c1 > 0.f ? __fdiv_rn(c0, c1) : 0.f;
        m = fminf(fmaxf(m, -1.f), 1.f);
      }
      const int xl = left_of(x, L, periodic);
      const int xr = right_of(x, L, periodic);
      const bool lf = xl >= 0 && occ[xl] < K;
      const bool rf = xr >= 0 && occ[xr] < K;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int v = cur[k * L + x];
        int8_t e = kNone;
        uint32_t pr = kSent;
        if (v != 0) {
          const bool plus = v > 0;
          const float c = expf(__fmul_rn(__fmul_rn(neg_beta, plus ? 1.f : -1.f),
                                         m));
          float rl = lf ? p_dif : 0.f;
          if (bidirectional && !plus && lf) rl = __fadd_rn(rl, p_act);
          float rr = rf ? p_dif : 0.f;
          if (plus && rf) rr = __fadd_rn(rr, p_act);
          const float t1 = rl;
          const float t2 = __fadd_rn(t1, rr);
          const float t3 = __fadd_rn(t2, __fmul_rn(c, dt));
          uint32_t ub, pb;
          if (nz) {
            ub = (uint32_t)nz[k * L + x];
            pb = (uint32_t)nz[KL + k * L + x];
          } else {
            const uint4 r = hydrolim::philox4x32_10(
                make_uint4((uint32_t)(k * L + x), (uint32_t)(step0 + s), 0u,
                           0u),
                key);
            ub = r.x;
            pb = r.y;
          }
          const float u = hydrolim::bits_to_uniform(ub);
          if (u < t1) e = kLeft;
          else if (u < t2) e = kRight;
          else if (u < t3) e = kFlip;
          const uint32_t rand_hi = (pb >> 1) & 0x7FFFFFF0u;
          if (e == kRight) pr = rand_hi | (uint32_t)k;
          else if (e == kLeft) pr = rand_hi | (uint32_t)(K + k);
        }
        ev[k * L + x] = e;
        prio[k * L + x] = pr;
      }
    }
    __syncthreads();

    // P3: admission at each destination site
    for (int x = tid; x < L; x += nt) {
      const int xl = left_of(x, L, periodic);
      const int xr = right_of(x, L, periodic);
      const int free_ = K - occ[x];
      int mask = 0;
      if (free_ > 0) {
        uint32_t c[2 * K];
#pragma unroll
        for (int k = 0; k < K; ++k) {
          c[k] = (xl >= 0 && ev[k * L + xl] == kRight) ? prio[k * L + xl]
                                                       : kSent;
          c[K + k] = (xr >= 0 && ev[k * L + xr] == kLeft) ? prio[k * L + xr]
                                                          : kSent;
        }
#pragma unroll
        for (int q = 0; q < 2 * K; ++q) {
          int rank = 0;
#pragma unroll
          for (int j = 0; j < 2 * K; ++j) rank += c[j] < c[q];
          if (c[q] != kSent && rank < free_) mask |= 1 << q;
        }
      }
      inmask[x] = mask;
    }
    __syncthreads();

    // P4: leavers out, flips, stable front-pack; then P1 of the next step
    int ls = 0, ln = 0;
    for (int x = tid; x < L; x += nt) {
      const int xl = left_of(x, L, periodic);
      const int xr = right_of(x, L, periodic);
      const int to_left = xl >= 0 ? inmask[xl] >> K : 0;    // bits k
      const int to_right = xr >= 0 ? inmask[xr] : 0;        // bits k
      const int in = inmask[x];
      int n = 0, o = 0, cs = 0;
      auto push = [&](int v) {
        if (n < K) nxt[(n++) * L + x] = v;
        o += 1;
        cs += v > 0 ? 1 : -1;
      };
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int v = cur[k * L + x];
        if (v == 0) continue;
        const int8_t e = ev[k * L + x];
        if (e == kRight && ((to_right >> k) & 1)) continue;
        if (e == kLeft && ((to_left >> k) & 1)) continue;
        push(e == kFlip ? -v : v);
      }
#pragma unroll
      for (int k = 0; k < K; ++k)
        if ((in >> k) & 1) push(cur[k * L + xl]);
#pragma unroll
      for (int k = 0; k < K; ++k)
        if ((in >> (K + k)) & 1) push(cur[k * L + xr]);
      for (int k = n; k < K; ++k) nxt[k * L + x] = 0;
      occ[x] = o;
      cnt[x] = cs;
      ls += cs;
      ln += o;
    }
    ls = warp_sum(ls);
    ln = warp_sum(ln);
    if ((tid & 31) == 0) {
      red[0][tid >> 5] = ls;
      red[1][tid >> 5] = ln;
    }
    __syncthreads();
    int* t = cur;
    cur = nxt;
    nxt = t;
  }

  for (int i = tid; i < KL; i += nt) slots_out[off + i] = cur[i];
}

template <int K>
int launch(const float* scal, const int* seeds, int step0,
           const int* slots_in, int* slots_out, const int* noise,
           const int* band_idx, const float* band_w, const float* band_taps,
           int W, int radius, int lo, int hi, int B, int L, int k_steps,
           float dt, int periodic, int bidirectional,
           size_t smem, int threads, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      exclusion_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  exclusion_kernel<K><<<B, threads, smem, stream>>>(
      scal, seeds, step0, slots_in, slots_out, noise, band_idx, band_w,
      band_taps, W, radius, lo, hi, L, k_steps, dt, periodic, bidirectional);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int exclusion_multi_step_launch(
    const float* scal, const int* seeds, int step0, const int* slots_in,
    int* slots_out, const int* noise, const int* band_idx,
    const float* band_w, const float* band_taps, int W, int radius, int lo,
    int hi, int B, int K, int L, int k_steps, float dt, int periodic,
    int bidirectional, void* stream) {
  const size_t smem = (size_t)(13 * K + 12) * L + 4 * (size_t)W;
  int threads = (L + 31) / 32 * 32;
  threads = threads > kMaxThreads ? kMaxThreads : threads;
  cudaStream_t st = (cudaStream_t)stream;
#define HYDROLIM_CASE(k)                                                    \
  case k:                                                                   \
    return launch<k>(scal, seeds, step0, slots_in, slots_out, noise,        \
                     band_idx, band_w, band_taps, W, radius, lo, hi, B, L,  \
                     k_steps, dt, periodic, bidirectional, smem, threads,   \
                     st);
  switch (K) {
    HYDROLIM_CASE(1)
    HYDROLIM_CASE(2)
    HYDROLIM_CASE(3)
    HYDROLIM_CASE(4)
    HYDROLIM_CASE(5)
    HYDROLIM_CASE(6)
    HYDROLIM_CASE(7)
    HYDROLIM_CASE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef HYDROLIM_CASE
}

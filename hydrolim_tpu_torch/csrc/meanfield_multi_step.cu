// Kernel B1: k fused mean-field tau-leap steps per replica.
//
// Replaces the TPU kernel hydrolim_tpu/ops/pallas_stepper.py
// (`_kernel`, called through `meanfield_multi_step`).
//
// What bounds it on an H100: every step of a replica needs the global
// magnetization m = sum(sigma)/N of that replica, so a step ends in one
// replica-wide exchange.  Per particle-step the work is a quarter of a
// Philox4x32-10 call (the generator is part of the function and stays), one
// 24-bit uniform and four threshold compares.  Measured with CUDA events
// (PERF.md; no counter could be read): a step has a floor of ~1.2-1.3 us
// (m, two expf, the exchange of sum(sigma) across the cluster, one
// dependent pass), reached at the main path's 417 groups per CTA and not
// lowered by fewer; past it ~1.5 ns per group of four particles on an SM,
// which is issue-bound (the headline's 12,500 groups per CTA).  The parent
// kernel ran a replica on one SM, with a barrier and a serial read of 32
// partials per step, and at N=1e5 (1.2 MB of int32 state) every
// particle-step read device memory.
//
// Design:
//   - a thread-block cluster of C CTAs (C <= 8) per replica; CTA r owns the
//     Philox groups [r*Gc, (r+1)*Gc).  Each warp sums its flips' dS (one
//     redux) and pushes the sum, tagged with the step, into a
//     per-step-parity slot of every CTA of the cluster (distributed shared
//     memory, lane l stores to CTA l); every warp then polls its own CTA's
//     C x warps slots lane-parallel until all carry the step's tag, and
//     sums them (redux).  No barrier per step: a barrier.cluster arrive /
//     wait round trip cost more than the tagged push and poll (1.83 against
//     1.55 us per step at C=2, in successive runs), and a short sleep
//     between polls leaves the issue slots to warps still stepping (1.39 ->
//     1.21 us at C=3, in one run).
//     Between push and poll a thread draws the next step's bits of its
//     first group.
//   - the particle update is branch-free (selects), since a warp's
//     particles take different events.
//   - the state stays on chip for the whole call, one 32-bit word per
//     particle: pos in bits 0-15 (L <= 65536), sigma + 1 in bits 16-17
//     (sigma in {-1, 0, +1}: sigma = 0 stays inert, as in the plain
//     version), this call's winding change in bits 18-31 (signed; the
//     launch plan splits a call so that |dwind| <= ceil(k/L) + 1 fits).
//     Registers hold it when a CTA owns <= 4 groups per thread (kRegs, P
//     groups per thread, statically indexed), shared memory otherwise
//     (kShared, 16 bytes per group).  wind_out = wind_in + dwind on the way
//     out.  What fits neither (L > 65536, or > ~14k groups per CTA at C=8)
//     keeps the unpacked int32 state in the output arrays (kGlobal).
//   - groups are spread over the threads pass-major, with the multiple of
//     32 threads that leaves the fewest thread-slots idle over all passes.
//   - the launch plan (C, mode, threads, split) is chosen in Python
//     (ops/stepper_kernel.py) from the co-resident cluster count that
//     meanfield_max_active_clusters reports, so all B clusters run at once.
//
// The function is the parent kernel's bit for bit: the same Philox key
// (seed[b], b0 + b) and counter (group g, step0 + s), the same threshold
// arithmetic (__fmul_rn/__fadd_rn, expf), an exact integer sum(sigma) and
// m = (float)S / (float)N over the true N.
//
// Random bits: either injected (noise, (B, noise_k, N) uint32 held in int32,
// the TPU kernel's noise= layout without lane padding) or native Philox.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxCluster = 8;
enum Mode { kRegs = 0, kShared = 1, kGlobal = 2 };

constexpr uint32_t kPosMask = 0xFFFFu;
constexpr int kSigShift = 16;
constexpr int kWindShift = 18;

struct Params {
  const float* scal;
  const int* seeds;
  int step0;
  int b0;  // the global index of the launch's first replica (its key)
  const int *pos_in, *sig_in, *wnd_in;
  int *pos_out, *sig_out, *wnd_out;
  const int* noise;  // this launch's first step; (B, noise_k, n)
  int noise_k, n, L, k_steps, groups_per_cta, cluster;
  float dt;
  int bidirectional;
};

struct Thresholds {
  float t1, t2, t3_all, e_p, e_m;
  bool bidi;
};

// The event of one particle: the move delta (-1, 0, +1), or a flip.
// Branch-free (selects only): a warp's particles take different events,
// and divergent branches cost more than the few selects.
__device__ __forceinline__ int event(uint32_t bits, int sg,
                                     const Thresholds& t, bool& flip) {
  const bool plus = sg > 0;
  const float u = hydrolim::bits_to_uniform(bits);
  const float t3 = t.bidi ? t.t3_all : (plus ? t.t3_all : t.t2);
  const float t4 = __fadd_rn(t3, plus ? t.e_p : t.e_m);
  flip = u >= t3 && u < t4;
  return u < t.t1 ? -1 : u < t.t2 ? 1 : u < t3 ? (t.bidi ? sg : 1) : 0;
}

__device__ __forceinline__ uint32_t pack(int pos, int sg) {
  return ((uint32_t)pos & kPosMask) | ((uint32_t)(sg + 1) << kSigShift);
}
__device__ __forceinline__ int sig_of(uint32_t w) {
  return (int)((w >> kSigShift) & 3u) - 1;
}

// One step of a packed particle; dS collects the change of sum(sigma).
__device__ __forceinline__ uint32_t step_packed(uint32_t w, uint32_t bits,
                                                const Thresholds& t, int L,
                                                int& dS) {
  const int sg = sig_of(w);
  bool flip;
  const int raw = (int)(w & kPosMask) + event(bits, sg, t, flip);
  const int wound = raw < 0 ? -1 : (raw >= L ? 1 : 0);
  w = (w & ~kPosMask) | (uint32_t)(raw - wound * L);
  w += (uint32_t)wound << kWindShift;
  w += flip ? (uint32_t)(-2 * sg) << kSigShift : 0u;
  dS -= flip ? 2 * sg : 0;
  return w;
}

// One step of an unpacked particle in device memory (kGlobal).
__device__ __forceinline__ void step_global(int* pos, int* sig, int* wnd,
                                            uint32_t bits,
                                            const Thresholds& t, int L,
                                            int& dS) {
  const int sg = *sig;
  bool flip;
  const int delta = event(bits, sg, t, flip);
  if (flip) {
    *sig = -sg;
    dS -= 2 * sg;
  } else if (delta != 0) {
    const int raw = *pos + delta;
    const int wound = raw < 0 ? -1 : (raw >= L ? 1 : 0);
    *pos = raw - wound * L;
    *wnd += wound;
  }
}

// Word q of a group, by a compile-time q (keeps the group in registers).
__device__ __forceinline__ uint32_t& word(uint4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// The replica-wide sum of v over the C CTAs of the cluster (C = 1 is a
// cluster of one), without a barrier.  push: each warp's sum (one redux)
// goes, with the sum's tag, as one 64-bit word into slot
// [tag & 1][rank * warps + warp] of every CTA of the cluster (distributed
// shared memory; lane l stores to CTA l).  poll: every warp reads the
// C x warps slots of its own CTA lane-parallel until each carries the tag,
// then sums them (redux).  Value and tag travel in one word, so a slot
// never shows a value without its tag; a slot is rewritten (tag + 2) only
// after every warp of the cluster has pushed tag + 1, which each does after
// it has read tag.  Between push and poll a thread draws the next step's
// bits.
constexpr uint32_t kNoTag = 0xFFFFFFFFu;

__device__ __forceinline__ void replica_push(int v, uint64_t* slots,
                                             uint32_t tag, int C, int rank) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint64_t* half = slots + (tag & 1u) * kMaxCluster * 32;
  v = __reduce_add_sync(0xffffffffu, v);
  if (lane < C) {
    volatile uint64_t* peer = cg::this_cluster().map_shared_rank(half, lane);
    peer[rank * (blockDim.x >> 5) + warp] =
        ((uint64_t)tag << 32) | (uint32_t)v;
  }
}

__device__ __forceinline__ int replica_poll(const uint64_t* slots,
                                            uint32_t tag, int C) {
  const int lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  const volatile uint64_t* half = slots + (tag & 1u) * kMaxCluster * 32;
  int s = 0;
  for (int i = lane; i < C * nw; i += 32) {
    uint64_t w;
    // a short sleep between polls leaves the issue slots to the warps
    // still stepping their particles
    for (w = half[i]; (uint32_t)(w >> 32) != tag; w = half[i])
      __nanosleep(32);
    s += (int)(uint32_t)w;
  }
  return __reduce_add_sync(0xffffffffu, s);
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void load_bits(const Params& a, const int* nz,
                                          uint2 key, int g, int s,
                                          uint32_t (&w)[4]) {
  if (nz) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = 4 * g + q;
      w[q] = i < a.n ? (uint32_t)nz[i] : 0u;
    }
  } else {
    const uint4 r = hydrolim::philox4x32_10(
        make_uint4((uint32_t)g, (uint32_t)(a.step0 + s), 0u, 0u), key);
    w[0] = r.x; w[1] = r.y; w[2] = r.z; w[3] = r.w;
  }
}

// MODE kRegs: P groups per thread in registers; kShared / kGlobal: any
// number of passes (P unused).
template <int MODE, int P>
__global__ void __launch_bounds__(kMaxThreads)
meanfield_kernel(const Params a) {
  extern __shared__ uint4 sstate[];  // kShared: groups_per_cta packed groups
  __shared__ uint64_t slots[2 * kMaxCluster * 32];
  const int C = a.cluster;
  const int rank = C > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const int b = blockIdx.x / C;
  const int tid = threadIdx.x, T = blockDim.x;
  const int n = a.n, L = a.L;
  const int G = (n + 3) >> 2;
  const int g_lo = rank * a.groups_per_cta;
  const int g_hi = min(G, g_lo + a.groups_per_cta);
  const int passes = MODE == kRegs ? P : (a.groups_per_cta + T - 1) / T;
  const size_t off = (size_t)b * n;

  const float beta = a.scal[3 * b];
  // __fmul_rn/__fadd_rn are never contracted into FMAs: the thresholds
  // round exactly as the plain version's separate multiply and add
  const float dt = a.dt;
  const float p_dif = __fmul_rn(a.scal[3 * b + 1], dt);
  const float p_act = __fmul_rn(a.scal[3 * b + 2], dt);
  Thresholds th;
  th.t1 = p_dif;
  th.t2 = __fadd_rn(th.t1, p_dif);
  th.t3_all = __fadd_rn(th.t2, p_act);
  th.bidi = a.bidirectional != 0;

  uint4 reg[MODE == kRegs ? P : 1];
  int local = 0;
#pragma unroll
  for (int j = 0; j < (MODE == kRegs ? P : 1); ++j)
    reg[j] = make_uint4(0u, 0u, 0u, 0u);
  // load: each thread owns its groups for the whole call
#pragma unroll
  for (int j = 0; j < (MODE == kRegs ? P : 1); ++j) {
    for (int jj = j; jj < passes; jj += (MODE == kRegs ? P : 1)) {
      const int g = g_lo + tid + jj * T;
      if (g >= g_hi) continue;
      uint32_t w[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = 4 * g + q;
        w[q] = 0u;
        if (i < n) {
          const int pos = a.pos_in[off + i], sg = a.sig_in[off + i];
          local += sg;
          w[q] = pack(pos, sg);
          if (MODE == kGlobal) {
            a.pos_out[off + i] = pos;
            a.sig_out[off + i] = sg;
            a.wnd_out[off + i] = a.wnd_in[off + i];
          }
        }
      }
      const uint4 v = make_uint4(w[0], w[1], w[2], w[3]);
      if (MODE == kRegs) reg[j] = v;
      if (MODE == kShared) sstate[g - g_lo] = v;
    }
  }
  for (int i = tid; i < 2 * kMaxCluster * 32; i += T)
    slots[i] = (uint64_t)kNoTag << 32;
  // every CTA of the cluster runs, its slots cleared, before any push
  cluster_sync();
  replica_push(local, slots, 0u, C, rank);
  const uint2 key = make_uint2((uint32_t)a.seeds[b], (uint32_t)(a.b0 + b));
  const int* nz0 = a.noise ? a.noise + (size_t)b * a.noise_k * n : nullptr;
  // registers: the bits of the thread's first group are drawn one step
  // ahead, while the step's barrier completes
  const int g_first = g_lo + tid;
  uint32_t ahead[4] = {0u, 0u, 0u, 0u};
  if (MODE == kRegs && a.k_steps > 0) load_bits(a, nz0, key, g_first, 0, ahead);
  int S = replica_poll(slots, 0u, C);

  const float n_f = (float)n;
  for (int s = 0; s < a.k_steps; ++s) {
    const float m = (float)S / n_f;
    th.e_p = __fmul_rn(expf(-beta * m), dt);
    th.e_m = __fmul_rn(expf(beta * m), dt);
    const int* nz = nz0 ? nz0 + (size_t)s * n : nullptr;
    int dS = 0;
    if (MODE == kRegs) {
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const int g = g_lo + tid + j * T;
        if (g < g_hi) {
          uint32_t w[4];
          if (j == 0) {
#pragma unroll
            for (int q = 0; q < 4; ++q) w[q] = ahead[q];
          } else {
            load_bits(a, nz, key, g, s, w);
          }
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (4 * g + q < n)
              word(reg[j], q) = step_packed(word(reg[j], q), w[q], th, L, dS);
        }
      }
    } else {
      // two groups per iteration: their bits are drawn side by side (two
      // independent Philox chains), a group past g_hi is drawn and dropped
      for (int j = 0; j < passes; j += 2) {
        const int g0 = g_lo + tid + j * T;
        if (g0 >= g_hi) break;
        uint32_t w[2][4];
        load_bits(a, nz, key, g0, s, w[0]);
        load_bits(a, nz, key, g0 + T, s, w[1]);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int g = g0 + h * T;
          if (g >= g_hi) break;
          if (MODE == kShared) {
            const uint4 old = sstate[g - g_lo];
            uint4 v = old;
#pragma unroll
            for (int q = 0; q < 4; ++q)
              if (4 * g + q < n)
                word(v, q) = step_packed(word(v, q), w[h][q], th, L, dS);
            if (v.x != old.x || v.y != old.y || v.z != old.z ||
                v.w != old.w)
              sstate[g - g_lo] = v;
          } else {
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const size_t i = off + 4 * g + q;
              if (4 * g + q < n)
                step_global(a.pos_out + i, a.sig_out + i, a.wnd_out + i,
                            w[h][q], th, L, dS);
            }
          }
        }
      }
    }
    replica_push(dS, slots, (uint32_t)s + 1u, C, rank);
    if (MODE == kRegs && s + 1 < a.k_steps)
      load_bits(a, nz ? nz + n : nullptr, key, g_first, s + 1, ahead);
    S += replica_poll(slots, (uint32_t)s + 1u, C);
  }
  // no CTA leaves while a peer may still push into its shared memory
  cluster_sync();

  // unpack: wind_out = wind_in + this call's winding change
#pragma unroll
  for (int j = 0; j < (MODE == kGlobal ? 0 : MODE == kRegs ? P : 1); ++j) {
    for (int jj = j; jj < passes; jj += (MODE == kRegs ? P : 1)) {
      const int g = g_lo + tid + jj * T;
      if (g >= g_hi) continue;
      uint4 v = MODE == kRegs ? reg[j] : sstate[g - g_lo];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = 4 * g + q;
        if (i < n) {
          const uint32_t x = word(v, q);
          a.pos_out[off + i] = (int)(x & kPosMask);
          a.sig_out[off + i] = sig_of(x);
          a.wnd_out[off + i] = a.wnd_in[off + i] + ((int)x >> kWindShift);
        }
      }
    }
  }
}

using KernelFn = void (*)(const Params);

KernelFn pick(int mode, int P) {
  if (mode == kRegs) {
    if (P == 1) return meanfield_kernel<kRegs, 1>;
    if (P == 2) return meanfield_kernel<kRegs, 2>;
    if (P == 4) return meanfield_kernel<kRegs, 4>;
    return nullptr;
  }
  if (mode == kShared) return meanfield_kernel<kShared, 1>;
  if (mode == kGlobal) return meanfield_kernel<kGlobal, 1>;
  return nullptr;
}

cudaError_t configure(KernelFn fn, int mode, int C, int B, int threads,
                      int groups_per_cta, void* stream,
                      cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr) {
  if (!fn || C < 1 || C > kMaxCluster || threads < 32 ||
      threads > kMaxThreads || threads % 32)
    return cudaErrorInvalidValue;
  const size_t smem = mode == kShared ? (size_t)groups_per_cta * 16 : 0;
  if (smem) {
    cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(B * C);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

}  // namespace

// How many clusters of this shape the card holds at once.
extern "C" int meanfield_max_active_clusters(int mode, int P, int C,
                                             int threads, int groups_per_cta,
                                             int* out) {
  const KernelFn fn = pick(mode, P);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e = configure(fn, mode, C, 1, threads, groups_per_cta, nullptr,
                            cfg, attr);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveClusters(out, fn, &cfg);
}

extern "C" int meanfield_multi_step_launch(
    const float* scal, const int* seeds, int step0, int b0, const int* pos_in,
    const int* sig_in, const int* wnd_in, int* pos_out, int* sig_out,
    int* wnd_out, const int* noise, int noise_k, int B, int n, int L,
    int k_steps, float dt, int bidirectional, int mode, int P, int C,
    int threads, int groups_per_cta, void* stream) {
  const KernelFn fn = pick(mode, P);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e = configure(fn, mode, C, B, threads, groups_per_cta, stream,
                            cfg, attr);
  if (e != cudaSuccess) return (int)e;
  const Params p{scal,    seeds,   step0,   b0,      pos_in,  sig_in, wnd_in,
                 pos_out, sig_out, wnd_out, noise,   noise_k, n,
                 L,       k_steps, groups_per_cta,    C,      dt,
                 bidirectional};
  e = cudaLaunchKernelEx(&cfg, fn, p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

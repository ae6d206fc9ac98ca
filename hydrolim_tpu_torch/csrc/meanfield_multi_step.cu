// Kernel B1: k fused mean-field tau-leap steps per replica.
//
// Replaces the TPU kernel hydrolim_tpu/ops/pallas_stepper.py
// (`_kernel`, called through `meanfield_multi_step`).
//
// What bounds it on an H100: every step of a replica needs the global
// magnetization m = sum(sigma)/N of that replica, so the replica is one
// unit of synchronisation, one SM.  Per particle-step the work is one
// 24-bit uniform (a quarter of a Philox4x32-10 call), four threshold
// compares, a 4-byte read of sigma, and a write of pos/sigma/wind only on
// an event.  A step is ceil(N/4096) passes of up to 1024 threads, then one
// barrier.  Step times against N (CUDA events, PERF.md; no counter trace)
// split into a fixed ~0.85 us per step (the barrier, the serial read of 32
// warp partials, m and two expf), ~0.55 us for a pass of one thread (one
// dependent chain), and ~1.4 us for each further full pass of 32 warps.
// That last part grows with the work, as an issue-bound loop would; that
// it is issue-bound is a hypothesis, since no issue-slot counter was read.
// Injected bits run slower than native Philox, so the generator is not the
// cost.  Bytes matter only when the state is in device memory and events
// are frequent.
//
// Design: one CTA per replica loops over all k steps, particles strided over
// the threads in groups of four (one Philox call per group).  The state
// lives in shared memory when 12*N bytes fit (N up to ~17k), in device
// memory otherwise.  sum(sigma) is kept as an exact integer: one block
// reduction at entry, then each step adds -2*sigma over that step's flips
// (one barrier per step: the warp partials are double-buffered by step
// parity).  m = (float)S / (float)N divides by the true N.
//
// Later work, not done here: spreading one replica over a thread-block
// cluster (distributed shared memory for the reduction) so the N=1e5 state
// stays on chip, and packing the state into 16+8 bits.
//
// Random bits: either injected (noise, (B, k, N) uint32 held in int32, the
// TPU kernel's noise= layout without lane padding) or native Philox with
// key (seed[b], b) and counter (particle group, step0 + s, 0, 0).
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int kMaxThreads = 1024;
constexpr size_t kMaxSmemState = 200 * 1024;

// Block-wide integer sum with one barrier.  `buf` holds two halves of 32
// warp partials; consecutive calls must alternate `parity`.
__device__ __forceinline__ int block_sum(int v, int* buf, int parity) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  int* half = buf + 32 * parity;
  if ((threadIdx.x & 31) == 0) half[threadIdx.x >> 5] = v;
  __syncthreads();
  int s = 0;
  const int nw = blockDim.x >> 5;
  for (int w = 0; w < nw; ++w) s += half[w];
  return s;
}

__global__ void __launch_bounds__(kMaxThreads)
meanfield_kernel(const float* __restrict__ scal, const int* __restrict__ seeds,
                 int step0, const int* __restrict__ pos_in,
                 const int* __restrict__ sig_in,
                 const int* __restrict__ wnd_in, int* __restrict__ pos_out,
                 int* __restrict__ sig_out, int* __restrict__ wnd_out,
                 const int* __restrict__ noise, int n, int L, int k_steps,
                 float dt, int bidirectional, int use_smem) {
  extern __shared__ int smem[];
  __shared__ int red[64];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t off = (size_t)b * n;
  const float beta = scal[3 * b];
  // __fmul_rn/__fadd_rn are never contracted into FMAs: the thresholds
  // round exactly as the plain version's separate multiply and add
  const float p_dif = __fmul_rn(scal[3 * b + 1], dt);
  const float p_act = __fmul_rn(scal[3 * b + 2], dt);

  int* pos = use_smem ? smem : pos_out + off;
  int* sig = use_smem ? smem + n : sig_out + off;
  int* wnd = use_smem ? smem + 2 * n : wnd_out + off;
  for (int i = tid; i < n; i += blockDim.x) {
    pos[i] = pos_in[off + i];
    sig[i] = sig_in[off + i];
    wnd[i] = wnd_in[off + i];
  }
  __syncthreads();

  int local = 0;
  for (int i = tid; i < n; i += blockDim.x) local += sig[i];
  int S = block_sum(local, red, 0);
  int parity = 1;

  const float n_f = (float)n;
  const uint2 key = make_uint2((uint32_t)seeds[b], (uint32_t)b);
  const int n_groups = (n + 3) >> 2;
  const float t1 = p_dif;
  const float t2 = __fadd_rn(t1, p_dif);
  const float t3_all = __fadd_rn(t2, p_act);

  for (int s = 0; s < k_steps; ++s) {
    const float m = (float)S / n_f;
    const float e_p = __fmul_rn(expf(-beta * m), dt);
    const float e_m = __fmul_rn(expf(beta * m), dt);
    const int* nz = noise ? noise + ((size_t)b * k_steps + s) * n : nullptr;
    int dS = 0;
    for (int g = tid; g < n_groups; g += blockDim.x) {
      uint32_t w[4];
      if (nz) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = 4 * g + q;
          w[q] = i < n ? (uint32_t)nz[i] : 0u;
        }
      } else {
        const uint4 r = hydrolim::philox4x32_10(
            make_uint4((uint32_t)g, (uint32_t)(step0 + s), 0u, 0u), key);
        w[0] = r.x; w[1] = r.y; w[2] = r.z; w[3] = r.w;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = 4 * g + q;
        if (i >= n) break;
        const int sg = sig[i];
        const bool plus = sg > 0;
        const float u = hydrolim::bits_to_uniform(w[q]);
        const float t3 = bidirectional ? t3_all : (plus ? t3_all : t2);
        const float t4 = __fadd_rn(t3, plus ? e_p : e_m);
        int delta = 0;
        if (u < t1) {
          delta = -1;
        } else if (u < t2) {
          delta = 1;
        } else if (u < t3) {
          delta = bidirectional ? sg : 1;
        } else if (u < t4) {
          sig[i] = -sg;
          dS -= 2 * sg;
        }
        if (delta != 0) {
          int raw = pos[i] + delta;
          if (raw < 0) {
            raw += L;
            wnd[i] -= 1;
          } else if (raw >= L) {
            raw -= L;
            wnd[i] += 1;
          }
          pos[i] = raw;
        }
      }
    }
    S += block_sum(dS, red, parity);
    parity ^= 1;
  }

  if (use_smem) {
    __syncthreads();
    for (int i = tid; i < n; i += blockDim.x) {
      pos_out[off + i] = pos[i];
      sig_out[off + i] = sig[i];
      wnd_out[off + i] = wnd[i];
    }
  }
}

}  // namespace

extern "C" int meanfield_multi_step_launch(
    const float* scal, const int* seeds, int step0, const int* pos_in,
    const int* sig_in, const int* wnd_in, int* pos_out, int* sig_out,
    int* wnd_out, const int* noise, int B, int n, int L, int k_steps,
    float dt, int bidirectional, void* stream) {
  size_t smem = (size_t)3 * n * sizeof(int);
  const int use_smem = smem <= kMaxSmemState;
  if (use_smem) {
    cudaError_t e = cudaFuncSetAttribute(
        meanfield_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  } else {
    smem = 0;
  }
  int threads = ((n + 3) / 4 + 31) / 32 * 32;
  threads = threads < 32 ? 32 : (threads > kMaxThreads ? kMaxThreads : threads);
  meanfield_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
      scal, seeds, step0, pos_in, sig_in, wnd_in, pos_out, sig_out, wnd_out,
      noise, n, L, k_steps, dt, bidirectional, use_smem);
  return (int)cudaGetLastError();
}

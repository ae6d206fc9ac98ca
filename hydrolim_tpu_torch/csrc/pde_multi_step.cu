// Kernel B2: k fused IMEX PDE steps per replica, with the tracer ensemble.
//
// Replaces the TPU kernel hydrolim_tpu/ops/pallas_pde.py (`_kernel`, called
// through `pde_multi_step`), in its global-magnetization, periodic,
// bidirectional configuration with the exact implicit solve (or none at
// gamma = 0) and up to 62 recorded Fourier bins.
//
// What bounds it on an H100: per step a replica is a few thousand flops on
// 2*L field values and n_t tracers -- far too little work to be bound by
// bandwidth or arithmetic.  It is bound by latency: the implicit diffusion
// solve is a sequential recurrence over the L sites, and every reduction
// (m, Var, tracer mean and variance, mass renormalisation) is a block-wide
// barrier.  The TPU kernel's dense (L, L) inverse matmul is not carried
// over: at L = 1000 it is 4 MB, does not fit shared memory, and re-reading
// it from L2 every step for every replica would set the pace.
//
// Design: one CTA per replica, looping over the chunk's k steps.  The
// fields (2*L f32), their updates, the solve factors and a cos/sin table
// live in shared memory (about 40 KB at L = 1000).  The periodic solve
// (1+2c) x - c (x[i-1] + x[i+1]) = rho is exact: Thomas on the
// corner-reduced tridiagonal with a Sherman-Morrison correction, factored
// on the host in float64 (ops/diffusion.py), applied here in f32 -- one
// thread per field, the two fields in two warps concurrently.  Tracers take
// one thread each; their windowed displacement ring (window x n_t f32,
// 400 KB at the sweep's shape) stays in device memory, touched once per
// tracer-step.  Spectra are taken directly: one warp per (bin, re|im) sums
// total(x) * table[(k x) mod L] over the lattice.
//
// Later work, not done here: parallel cyclic reduction for the solve (the
// recurrence is the critical path), several replicas per CTA at small L,
// the smooth / narrow / pointwise magnetization modes, the banded solve,
// anchored_minus and Neumann.
//
// Random bits: injected (noise, (B, k, 3, n_t) uint32 held in int32: flip,
// Box-Muller u2, u3) or native Philox with key (seed[b], b) and counter
// (tracer, step0 + s, 0, 0), whose first three words are the three draws.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Block-wide sum of NV values with one barrier.  `scratch` ([kWarps][NV])
// must not be reused before another barrier has passed.
template <int NV>
__device__ __forceinline__ void block_sum(float (&v)[NV], float* scratch) {
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < NV; ++i) v[i] = warp_sum(v[i]);
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int i = 0; i < NV; ++i) scratch[warp * NV + i] = v[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += scratch[w * NV + i];
    v[i] = s;
  }
}

__device__ __forceinline__ float cw(float beta, float s, float m) {
  return fminf(fmaxf(expf(-beta * s * m), 1e-8f), 1e8f);
}

struct Args {
  const float* scal;  // (B, 4) [beta, lam, gamma, 0]
  const int* seeds;
  int step0;
  const float *rp_in, *rm_in, *pos_in, *spin_in, *hist_in;
  float *rp_out, *rm_out, *pos_out, *spin_out, *hist_out, *recs;
  const float* factors;  // (3, L) [1/pivot, c', z] or null (no solve)
  const float* trig;     // (2, L) [cos, sin](2 pi j / L) or null
  const int* noise;
  int L, n_t, window, k_steps, kmax;
  float dt, dx, c, v_last, fac, w_dt, w_2dt;
};

__global__ void __launch_bounds__(kThreads) pde_kernel(Args a) {
  extern __shared__ float sm[];
  const int b = blockIdx.x, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int L = a.L, n_t = a.n_t, kmax = a.kmax;
  const bool solve = a.factors != nullptr;

  float* P = sm;
  float* M = P + L;
  float* P2 = M + L;
  float* M2 = P2 + L;
  float* inv = M2 + L;
  float* cp = inv + L;
  float* zz = cp + L;
  float* cosT = zz + L;
  float* sinT = cosT + L;
  float* DR = sinT + L;
  float* spec = DR + n_t;        // 2*kmax
  float* coef = spec + 2 * kmax;  // 2
  float* redA = coef + 2;         // kWarps * 2
  float* redB = redA + kWarps * 2;
  float* redD = redB + kWarps * 2;

  const float beta = a.scal[4 * b], lam = a.scal[4 * b + 1];
  const float noise_amp = sqrtf(__fmul_rn(2.f * a.scal[4 * b + 2], a.dt));
  const float inv_L = 1.f / (float)L;
  const float inv_nt = 1.f / (float)(n_t > 1 ? n_t : 1);
  const float dt = a.dt, dx = a.dx;
  const size_t foff = (size_t)b * L, toff = (size_t)b * n_t;
  const int rw = 4 + 2 * kmax;
  const uint2 key = make_uint2((uint32_t)a.seeds[b], (uint32_t)b);

  for (int x = tid; x < L; x += kThreads) {
    P[x] = a.rp_in[foff + x];
    M[x] = a.rm_in[foff + x];
    if (solve) {
      inv[x] = a.factors[x];
      cp[x] = a.factors[L + x];
      zz[x] = a.factors[2 * L + x];
    }
    if (kmax > 0) {
      cosT[x] = a.trig[x];
      sinT[x] = a.trig[L + x];
    }
  }
  const float* hin = a.hist_in + (size_t)b * a.window * n_t;
  float* hist = a.hist_out + (size_t)b * a.window * n_t;
  for (int j = tid; j < n_t; j += kThreads) {
    a.pos_out[toff + j] = a.pos_in[toff + j];
    a.spin_out[toff + j] = a.spin_in[toff + j];
    for (int w = 0; w < a.window; ++w) hist[w * n_t + j] = hin[w * n_t + j];
  }
  __syncthreads();

  for (int s = 0; s < a.k_steps; ++s) {
    const int n = a.step0 + s;

    // -- global magnetization of the pre-step densities -------------------
    float vA[2] = {0.f, 0.f};
    for (int x = tid; x < L; x += kThreads) {
      vA[0] += P[x] - M[x];
      vA[1] += P[x] + M[x];
    }
    block_sum<2>(vA, redA);
    const float m = vA[0] / (vA[1] + 1e-12f);
    const float t_mean = vA[1] * inv_L;

    // -- spectra: one warp per (bin, re|im) -------------------------------
    for (int q = warp; q < 2 * kmax; q += kWarps) {
      const int k = q < kmax ? q : q - kmax;
      const float* tab = q < kmax ? cosT : sinT;
      const int step_k = (32 * k) % L;
      int kx = (k * lane) % L;
      float acc = 0.f;
      for (int x = lane; x < L; x += 32) {
        acc += (P[x] + M[x]) * tab[kx];
        kx += step_k;
        if (kx >= L) kx -= L;
      }
      acc = warp_sum(acc);
      if (lane == 0) spec[q] = q < kmax ? acc * inv_L : -acc * inv_L;
    }

    // -- tracers: CW flip, Euler-Maruyama, displacement ring --------------
    const int* nz =
        a.noise ? a.noise + (size_t)(b * a.k_steps + s) * 3 * n_t : nullptr;
    const int slot = n % a.window;
    float vB[2] = {0.f, 0.f};
    for (int j = tid; j < n_t; j += kThreads) {
      uint32_t w0, w1, w2;
      if (nz) {
        w0 = (uint32_t)nz[j];
        w1 = (uint32_t)nz[n_t + j];
        w2 = (uint32_t)nz[2 * n_t + j];
      } else {
        const uint4 r = hydrolim::philox4x32_10(
            make_uint4((uint32_t)j, (uint32_t)n, 0u, 0u), key);
        w0 = r.x; w1 = r.y; w2 = r.z;
      }
      float spin = a.spin_out[toff + j];
      float pos = a.pos_out[toff + j];
      const float rate = cw(beta, spin, m);
      if (hydrolim::bits_to_uniform(w0) < rate * dt) spin = -spin;
      if (noise_amp > 0.f) {  // gamma = 0: no diffusion noise to draw
        const float u2 = fmaxf(hydrolim::bits_to_uniform(w1), 1e-12f);
        const float u3 = hydrolim::bits_to_uniform(w2);
        const float z = sqrtf(-2.f * logf(u2)) *
                        cosf(6.2831854820251465f * u3);
        pos = pos + lam * spin * dt + noise_amp * z;
      } else {
        pos = pos + lam * spin * dt;
      }
      // read the slot being overwritten first: it holds the position
      // `window` steps ago
      const float old = hist[slot * n_t + j];
      hist[slot * n_t + j] = pos;
      a.pos_out[toff + j] = pos;
      a.spin_out[toff + j] = spin;
      DR[j] = pos - old;
      vB[1] += pos - old;
    }
    for (int x = tid; x < L; x += kThreads) {
      const float d = P[x] + M[x] - t_mean;
      vB[0] += d * d;
    }
    block_sum<2>(vB, redB);
    const float var = vB[0] * inv_L;
    const float mean_dr = vB[1] * inv_nt;

    // -- implicit diffusion: exact periodic solve, in place ---------------
    if (solve) {
      if (lane == 0 && warp < 2) {
        float* F = warp == 0 ? P : M;
        float prev = F[0] * inv[0];
        F[0] = prev;
        for (int i = 1; i < L; ++i) {
          prev = (F[i] + a.c * prev) * inv[i];
          F[i] = prev;
        }
        for (int i = L - 2; i >= 0; --i) {
          prev = F[i] - cp[i] * prev;
          F[i] = prev;
        }
        coef[warp] = a.fac * (prev + a.v_last * F[L - 1]);
      }
      __syncthreads();
      const float cP = coef[0], cM = coef[1];
      for (int x = tid; x < L; x += kThreads) {
        P[x] -= cP * zz[x];
        M[x] -= cM * zz[x];
      }
      __syncthreads();
    }

    // -- upwind advection + CW reaction + clip, then mass renorm ----------
    const float cw_m = cw(beta, -1.f, m), cw_p = cw(beta, 1.f, m);
    float vD[3] = {0.f, 0.f, 0.f};
    for (int x = tid; x < L; x += kThreads) {
      const int xl = x == 0 ? L - 1 : x - 1;
      const int xr = x == L - 1 ? 0 : x + 1;
      const float p1 = P[x], m1 = M[x];
      const float adv_p = -lam * ((p1 - P[xl]) / dx);
      const float adv_m = lam * ((M[xr] - m1) / dx);
      const float R_p = cw_m * m1 - cw_p * p1;
      const float p2 = fmaxf(p1 + dt * (adv_p + R_p), 0.f);
      const float m2 = fmaxf(m1 + dt * (adv_m - R_p), 0.f);
      P2[x] = p2;
      M2[x] = m2;
      vD[0] += p1 + m1;
      vD[1] += p2 + m2;
    }
    for (int j = tid; j < n_t; j += kThreads) {
      const float d = DR[j] - mean_dr;
      vD[2] += d * d;
    }
    block_sum<3>(vD, redD);
    const float scale = vD[0] / fmaxf(vD[1], 1e-30f);
    for (int x = tid; x < L; x += kThreads) {
      P[x] = P2[x] * scale;
      M[x] = M2[x] * scale;
    }

    if (tid == 0) {
      const bool valid = n >= a.window;
      const float var_dr = vD[2] * inv_nt;
      float* row = a.recs + ((size_t)b * a.k_steps + s) * rw;
      row[0] = m;
      row[1] = var;
      row[2] = valid ? mean_dr / a.w_dt : NAN;
      row[3] = valid ? var_dr / a.w_2dt : NAN;
      for (int q = 0; q < 2 * kmax; ++q) row[4 + q] = spec[q];
    }
    // the next step's spectra read P and M across threads
    __syncthreads();
  }

  for (int x = tid; x < L; x += kThreads) {
    a.rp_out[foff + x] = P[x];
    a.rm_out[foff + x] = M[x];
  }
}

}  // namespace

extern "C" size_t pde_multi_step_smem_bytes(int L, int n_t, int kmax) {
  return sizeof(float) *
         ((size_t)9 * L + n_t + 2 * kmax + 2 + 3 * kWarps * 2 + kWarps);
}

extern "C" int pde_multi_step_launch(
    const float* scal, const int* seeds, int step0, const float* rp_in,
    const float* rm_in, const float* pos_in, const float* spin_in,
    const float* hist_in, float* rp_out, float* rm_out, float* pos_out,
    float* spin_out, float* hist_out, float* recs, const float* factors,
    const float* trig, const int* noise, int B, int L, int n_t, int window,
    int k_steps, int kmax, float dt, float dx, float c, float v_last,
    float fac, float w_dt, float w_2dt, void* stream) {
  Args a{scal,    seeds,   step0,   rp_in,  rm_in,    pos_in,  spin_in,
         hist_in, rp_out,  rm_out,  pos_out, spin_out, hist_out, recs,
         factors, trig,    noise,   L,      n_t,      window,  k_steps,
         kmax,    dt,      dx,      c,      v_last,   fac,     w_dt,
         w_2dt};
  const size_t smem = pde_multi_step_smem_bytes(L, n_t, kmax);
  cudaError_t e = cudaFuncSetAttribute(
      pde_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  pde_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// Kernel B2: k fused IMEX PDE steps per replica, with the tracer ensemble.
//
// Replaces the TPU kernel hydrolim_tpu/ops/pallas_pde.py (`_kernel`, called
// through `pde_multi_step`) in every mode it has: the magnetization global,
// pointwise or smoothed (narrow taps or the full circulant), a periodic or
// a Neumann lattice, the bidirectional or the anchored_minus model, and the
// exact, banded or no implicit solve, with any number of recorded Fourier
// bins.
//
// What bounds it on an H100: per step a replica is a few thousand flops on
// 2*L field values and n_t tracers (up to 2*L^2 FMAs with the full
// smoothing circulant) -- too little work per replica to be bound by
// bandwidth.  It is bound by latency: the exact solve is a sequential
// recurrence over the L sites, and every reduction (m, Var, tracer mean and
// variance, mass renormalisation) is a block-wide barrier.  The TPU
// kernel's dense (L, L) matrices are not carried over: at L = 1000 each is
// 4 MB and does not fit shared memory.
//
// Design: one CTA per replica, looping over the chunk's k steps.  The two
// fields, two scratch fields and, for a local magnetization, the m field
// live in shared memory (5*L floats: 160 KB at L = 8192).  What is the same
// for every replica -- the tridiagonal factors, the tap tables, the cos/sin
// table -- is read from device memory through L1.
//   - m: pointwise (P-M)/(P+M), or the symmetric-circulant tap routine on
//     the numerator and denominator; kept per site in shared memory, read
//     by the tracer gather at int(mod(pos, xlim)/dx) mod L.
//   - the tap routine sum_d w(d) (x[i-d] + x[i+d]) (indices mod L) serves
//     the narrow smoothing, the full circulant (d up to L/2; for even L the
//     host halves the d = L/2 tap, so its pair adds it once) and the banded
//     solve.  Each thread keeps its sites' sums in registers; the full
//     circulant costs 2 L^2 FMAs per step with two shared-memory loads per
//     pair of FMAs.
//   - exact solve (1+2c) x_i - a_i x_{i-1} - c x_{i+1} = rho_i: Thomas with
//     a per-row sub-diagonal a_i (Neumann's mirrored last row carries 2c)
//     and, when periodic, a Sherman-Morrison correction for the corners;
//     factored on the host in float64 (ops/diffusion.py), applied here in
//     f32 -- one thread per field, the two fields in two warps.
//   - upwind advection, CW reaction, clip and mass renormalisation, in the
//     bidirectional branch, or in anchored_minus (reaction first, then the
//     advection of rho_+* alone, read across a barrier).
// Tracers take one thread each; their windowed displacement ring stays in
// device memory, touched once per tracer-step.  Spectra: one warp per
// (bin, re|im) sums total(x) * table[(k x) mod L]; lane 0 writes the record.
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

enum MMode { kGlobal = 0, kPointwise = 1, kTaps = 2 };
enum SolveMode { kNoSolve = 0, kExact = 1, kBanded = 2 };

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

// The symmetric circulant at site x on two fields at once:
//   oa = w[0] a[x] + sum_{d=1..R} w[d] (a[x-d] + a[x+d]),  indices mod L.
__device__ __forceinline__ void taps2(const float* __restrict__ a,
                                      const float* __restrict__ b,
                                      const float* __restrict__ w, int R,
                                      int L, int x, float& oa, float& ob) {
  const float w0 = __ldg(w);
  float sa = w0 * a[x], sb = w0 * b[x];
  int lo = x, hi = x;
  for (int d = 1; d <= R; ++d) {
    lo = lo == 0 ? L - 1 : lo - 1;
    hi = hi == L - 1 ? 0 : hi + 1;
    const float wd = __ldg(w + d);
    sa += wd * (a[lo] + a[hi]);
    sb += wd * (b[lo] + b[hi]);
  }
  oa = sa;
  ob = sb;
}

struct Args {
  const float* scal;  // (B, 4) [beta, lam, gamma, 0]
  const int* seeds;
  int step0;
  const float *rp_in, *rm_in, *pos_in, *spin_in, *hist_in;
  float *rp_out, *rm_out, *pos_out, *spin_out, *hist_out, *recs;
  const float* factors;      // (4, L) [1/pivot, c', z, a] (exact solve)
  const float* solve_taps;   // (solve_r + 1,) half taps (banded solve)
  const float* smooth_taps;  // (smooth_r + 1,) half taps (smoothed m)
  const float* trig;         // (2, L) [cos, sin](2 pi j / L) or null
  const int* noise;
  int L, n_t, window, k_steps, kmax, m_mode, solve_mode, solve_r, smooth_r;
  int periodic, bidirectional;
  float dt, dx, xlim, v_last, fac, w_dt, w_2dt;
};

__global__ void __launch_bounds__(kThreads) pde_kernel(Args a) {
  extern __shared__ float sm[];
  const int b = blockIdx.x, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int L = a.L, n_t = a.n_t, kmax = a.kmax;
  const bool local_m = a.m_mode != kGlobal;

  // state (P, M) and scratch (Q, N) swap roles from step to step
  float* P = sm;
  float* M = P + L;
  float* Q = M + L;
  float* N = Q + L;
  float* mS = N + L;                       // L floats when local_m
  float* DR = mS + (local_m ? L : 0);      // n_t
  float* coef = DR + n_t;                  // 2
  float* redA = coef + 2;                  // kWarps * 2
  float* redB = redA + kWarps * 2;         // kWarps * 2
  float* redD = redB + kWarps * 2;         // kWarps * 3

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
    float* row = a.recs + ((size_t)b * a.k_steps + s) * rw;

    // -- magnetization of the pre-step densities --------------------------
    if (a.m_mode == kTaps) {
      for (int x = tid; x < L; x += kThreads) {
        Q[x] = P[x] - M[x];
        N[x] = P[x] + M[x];
      }
      __syncthreads();
    }
    float vA[2] = {0.f, 0.f};
    for (int x = tid; x < L; x += kThreads) {
      const float p = P[x], q = M[x];
      if (a.m_mode == kGlobal) {
        vA[0] += p - q;
      } else {
        float mx;
        if (a.m_mode == kPointwise) {
          mx = (p - q) / (p + q + 1e-12f);
        } else {
          float sn, sd;
          taps2(Q, N, a.smooth_taps, a.smooth_r, L, x, sn, sd);
          mx = sn / (sd + 1e-12f);
        }
        mS[x] = mx;
        vA[0] += mx;
      }
      vA[1] += p + q;
    }
    block_sum<2>(vA, redA);  // its barrier also publishes mS
    const float m_glob = vA[0] / (vA[1] + 1e-12f);
    const float m_mean = local_m ? vA[0] * inv_L : m_glob;
    const float t_mean = vA[1] * inv_L;

    // -- spectra: one warp per (bin, re|im) -------------------------------
    for (int q = warp; q < 2 * kmax; q += kWarps) {
      const int k = q < kmax ? q : q - kmax;
      const float* tab = a.trig + (q < kmax ? 0 : L);
      const int step_k = (int)((32LL * k) % L);
      int kx = (int)(((long long)k * lane) % L);
      float acc = 0.f;
      for (int x = lane; x < L; x += 32) {
        acc += (P[x] + M[x]) * __ldg(tab + kx);
        kx += step_k;
        if (kx >= L) kx -= L;
      }
      acc = warp_sum(acc);
      if (lane == 0) row[4 + q] = q < kmax ? acc * inv_L : -acc * inv_L;
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
      float m_tr = m_glob;
      if (local_m) {  // m at the tracer's site, floor-mod as jnp.mod
        float pw = fmodf(pos, a.xlim);
        if (pw != 0.f && ((pw < 0.f) != (a.xlim < 0.f))) pw += a.xlim;
        m_tr = mS[((int)(pw / dx)) % L];
      }
      const float rate = cw(beta, spin, m_tr);
      if (hydrolim::bits_to_uniform(w0) < rate * dt) spin = -spin;
      // rounded as the plain version rounds, (pos + λσ·dt) + noise: at
      // small dt the window's displacement is a few ulps of pos
      pos = __fadd_rn(pos, __fmul_rn(__fmul_rn(lam, spin), dt));
      if (noise_amp > 0.f) {  // gamma = 0: no diffusion noise to draw
        const float u2 = fmaxf(hydrolim::bits_to_uniform(w1), 1e-12f);
        const float u3 = hydrolim::bits_to_uniform(w2);
        const float z = sqrtf(-2.f * logf(u2)) *
                        cosf(6.2831854820251465f * u3);
        pos = __fadd_rn(pos, __fmul_rn(noise_amp, z));
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

    // -- implicit diffusion: (P1, M1) are the solved fields ---------------
    float *P1 = P, *M1 = M, *P2 = Q, *M2 = N;
    if (a.solve_mode == kExact) {  // in place
      if (lane == 0 && warp < 2) {
        float* F = warp == 0 ? P : M;
        const float* inv = a.factors;
        const float* cp = inv + L;
        const float* sub = inv + 3 * L;
        float prev = F[0] * __ldg(inv);
        F[0] = prev;
#pragma unroll 4
        for (int i = 1; i < L; ++i) {
          prev = (F[i] + __ldg(sub + i) * prev) * __ldg(inv + i);
          F[i] = prev;
        }
#pragma unroll 4
        for (int i = L - 2; i >= 0; --i) {
          prev = F[i] - __ldg(cp + i) * prev;
          F[i] = prev;
        }
        coef[warp] = a.fac * (prev + a.v_last * F[L - 1]);
      }
      __syncthreads();
      if (a.periodic) {  // Sherman-Morrison correction of the corners
        const float cP = coef[0], cM = coef[1];
        const float* zz = a.factors + 2 * L;
        for (int x = tid; x < L; x += kThreads) {
          const float z = __ldg(zz + x);
          P[x] -= cP * z;
          M[x] -= cM * z;
        }
        __syncthreads();
      }
    } else if (a.solve_mode == kBanded) {
      for (int x = tid; x < L; x += kThreads) {
        float sp, sq;
        taps2(P, M, a.solve_taps, a.solve_r, L, x, sp, sq);
        Q[x] = sp;
        N[x] = sq;
      }
      __syncthreads();
      P1 = Q; M1 = N; P2 = P; M2 = M;
    }

    // -- upwind advection + CW reaction + clip, then mass renorm ----------
    const float cwm_g = cw(beta, -1.f, m_glob), cwp_g = cw(beta, 1.f, m_glob);
    const bool walls = !a.periodic;
    float vD[3] = {0.f, 0.f, 0.f};
    // the new state, and the two buffers that become the scratch
    float *P_new, *M_new, *Q_new, *N_new;
    if (a.bidirectional) {
      for (int x = tid; x < L; x += kThreads) {
        const int xl = x == 0 ? L - 1 : x - 1;
        const int xr = x == L - 1 ? 0 : x + 1;
        const float p1 = P1[x], m1 = M1[x];
        float dp = (p1 - P1[xl]) / dx;
        float dm = (M1[xr] - m1) / dx;
        if (walls && x == 0) dp = 0.f;
        if (walls && x == L - 1) dm = 0.f;
        const float mx = local_m ? mS[x] : m_glob;
        const float cwm = local_m ? cw(beta, -1.f, mx) : cwm_g;
        const float cwp = local_m ? cw(beta, 1.f, mx) : cwp_g;
        const float R_p = cwm * m1 - cwp * p1;
        const float p2 = fmaxf(p1 + dt * (-lam * dp + R_p), 0.f);
        const float m2 = fmaxf(m1 + dt * (lam * dm - R_p), 0.f);
        P2[x] = p2;
        M2[x] = m2;
        vD[0] += p1 + m1;
        vD[1] += p2 + m2;
      }
      P_new = P2; M_new = M2; Q_new = P1; N_new = M1;
    } else {  // anchored_minus: reaction first, then rho_+* is advected
      for (int x = tid; x < L; x += kThreads) {
        const float p1 = P1[x], m1 = M1[x];
        const float mx = local_m ? mS[x] : m_glob;
        const float cwm = local_m ? cw(beta, -1.f, mx) : cwm_g;
        const float cwp = local_m ? cw(beta, 1.f, mx) : cwp_g;
        const float R_p = cwm * m1 - cwp * p1;
        P2[x] = fmaxf(p1 + dt * R_p, 0.f);
        M2[x] = fmaxf(m1 - dt * R_p, 0.f);
        vD[0] += p1 + m1;
      }
      __syncthreads();  // rho_+* is read across threads below
      for (int x = tid; x < L; x += kThreads) {
        const int xl = x == 0 ? L - 1 : x - 1;
        const float ps = P2[x];
        float dp = (ps - P2[xl]) / dx;
        if (walls && x == 0) dp = 0.f;
        const float p2 = fmaxf(ps + dt * (-lam * dp), 0.f);
        P1[x] = p2;
        vD[1] += p2 + M2[x];
      }
      P_new = P1; M_new = M2; Q_new = P2; N_new = M1;
    }
    for (int j = tid; j < n_t; j += kThreads) {
      const float d = DR[j] - mean_dr;
      vD[2] += d * d;
    }
    block_sum<3>(vD, redD);
    const float scale = vD[0] / fmaxf(vD[1], 1e-30f);
    for (int x = tid; x < L; x += kThreads) {
      P_new[x] *= scale;
      M_new[x] *= scale;
    }
    P = P_new; M = M_new; Q = Q_new; N = N_new;

    if (tid == 0) {
      const bool valid = n >= a.window;
      const float var_dr = vD[2] * inv_nt;
      row[0] = m_mean;
      row[1] = var;
      row[2] = valid ? mean_dr / a.w_dt : NAN;
      row[3] = valid ? var_dr / a.w_2dt : NAN;
    }
    // the next step reads P and M across threads
    __syncthreads();
  }

  for (int x = tid; x < L; x += kThreads) {
    a.rp_out[foff + x] = P[x];
    a.rm_out[foff + x] = M[x];
  }
}

}  // namespace

extern "C" size_t pde_multi_step_smem_bytes(int L, int n_t, int local_m) {
  return sizeof(float) * ((size_t)(local_m ? 5 : 4) * L + n_t + 2 +
                          7 * kWarps);
}

extern "C" int pde_multi_step_launch(
    const float* scal, const int* seeds, int step0, const float* rp_in,
    const float* rm_in, const float* pos_in, const float* spin_in,
    const float* hist_in, float* rp_out, float* rm_out, float* pos_out,
    float* spin_out, float* hist_out, float* recs, const float* factors,
    const float* solve_taps, const float* smooth_taps, const float* trig,
    const int* noise, int B, int L, int n_t, int window, int k_steps,
    int kmax, int m_mode, int solve_mode, int solve_r, int smooth_r,
    int periodic, int bidirectional, float dt, float dx, float xlim,
    float v_last, float fac, float w_dt, float w_2dt, void* stream) {
  Args a{scal,    seeds,    step0,      rp_in,     rm_in,       pos_in,
         spin_in, hist_in,  rp_out,     rm_out,    pos_out,     spin_out,
         hist_out, recs,    factors,    solve_taps, smooth_taps, trig,
         noise,   L,        n_t,        window,    k_steps,     kmax,
         m_mode,  solve_mode, solve_r,  smooth_r,  periodic,    bidirectional,
         dt,      dx,       xlim,       v_last,    fac,         w_dt,
         w_2dt};
  const size_t smem = pde_multi_step_smem_bytes(L, n_t, m_mode != kGlobal);
  cudaError_t e = cudaFuncSetAttribute(
      pde_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  pde_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

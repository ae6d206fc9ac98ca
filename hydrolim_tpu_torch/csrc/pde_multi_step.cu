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
// 2*L field values and n_t tracers, plus 2*L^2 FMAs with the full smoothing
// circulant -- too little work per replica to be bound by bandwidth, and
// every reduction (m, Var, tracer mean and variance, mass renormalisation)
// is a block-wide barrier.  The parent kernel spent ~37 of its ~43 us
// exact-solve step in two threads running Thomas' recurrences, and its full
// circulant (one site per thread, two shared-memory loads per pair of
// FMAs) ~46 us on top.  The TPU kernel's dense (L, L) matrices are not
// carried over: at L = 1000 each is 4 MB and does not fit shared memory.
//
// Design: one CTA per replica, looping over the chunk's k steps.  The two
// fields, two scratch fields and, for a local magnetization, the m field
// live in shared memory (5*L floats: 160 KB at L = 8192), with a buffer of
// the circulant's partial sums where it fits.  What is the same for every
// replica -- the tridiagonal factors, the padded tap tables, the cos/sin
// table -- is read from device memory through L1.
//   - m: pointwise (P-M)/(P+M), or the blocked circulant on the numerator
//     and denominator; kept per site in shared memory, read by the tracer
//     gather at int(mod(pos, xlim)/dx) mod L.
//   - the blocked circulant sum_d w(d) (x[i-d] + x[i+d]) (indices mod L)
//     serves the narrow smoothing, the full circulant (d up to L/2; for
//     even L the host halves the d = L/2 tap, so its pair adds it once) and
//     the banded solve.  A thread computes kBlock consecutive sites of one
//     field over one slice of the taps, sliding two windows through
//     registers (a circular buffer whose slots rotate at compile time), so
//     tap d -> d+1 loads one new value per side for kBlock outputs; kBlock
//     is odd, so a warp's loads at stride kBlock are free of bank
//     conflicts; one field at a time keeps the windows within the 64
//     registers a thread of a 1024-thread block has.  The slices' partial
//     sums meet in shared memory in slice order.  The host
//     pads the tap table with zeros to whole slices (ops/pde_kernel.py
//     tap_plan).  What remains is the sums' own FP32 work, 2*L^2 FMAs per
//     step for the full circulant.
//   - exact solve (1+2c) x_i - a_i x_{i-1} - c x_{i+1} = rho_i: both sweeps
//     of Thomas are first-order affine recurrences with coefficients fixed
//     from step to step (forward y_i = alpha_i y_{i-1} + inv_i rho_i, back
//     x_i = y_i - c'_i x_{i+1}), so each runs as a block scan of affine
//     maps: a run of consecutive sites per thread composed in registers, a
//     warp scan by shuffle, one cross-warp level (the warp totals through
//     shared memory, composed by a shuffle scan); the two fields at once on
//     the two halves of the block.  Neumann's mirrored last row carries 2c
//     in a_i; periodic adds a Sherman-Morrison correction for the corners
//     from x_0 and x_{L-1}, applied where the next phase reads the solved
//     fields.  Factors come from the host in float64 (ops/diffusion.py); the
//     scan composes its maps in float64 (latency-bound, so at little cost)
//     and stores f32 fields, closer to the exact solve than f32 Thomas.
//   - upwind advection, CW reaction, clip and mass renormalisation, in the
//     bidirectional branch, or in anchored_minus (reaction first, then the
//     advection of rho_+* alone, read across a barrier).
// Tracers take one thread each; their windowed displacement ring stays in
// device memory, touched once per tracer-step.  Spectra: no later step
// reads them, so they are off the step's chain: with kmax > 0 each step
// stores its total density row into a (B, k, L) scratch (coalesced, and
// marked evict-first, __stcs, so that a scratch of many steps does not
// push the tracers' ring out of L2) and the spectra kernel
// (csrc/pde_spectra.cu), launched right after on the same stream,
// computes all the steps' bins across the card.
//
// Random bits: injected (noise, (B, k, 3, n_t) uint32 held in int32: flip,
// Box-Muller u2, u3) or native Philox with key (seed[b], b0 + b), b0 the
// global index of the launch's first replica, and counter
// (tracer, step0 + s, 0, 0), whose first three words are the three draws.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kHalf = kThreads / 2;  // the scan solve: one field per half
constexpr int kBlock = 9;            // sites per unit of the circulant

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

__device__ __forceinline__ int wrap(int i, int L) {
  i %= L;
  return i < 0 ? i + L : i;
}

// One tap of the circulant on a unit's S outputs; u (the tap's place in
// its chunk) is a constant once the caller's loop is unrolled, so the slots
// are registers.
template <int S>
__device__ __forceinline__ void tap_sum(const float (&lw)[S],
                                        const float (&rw)[S], float (&acc)[S],
                                        float wd, int u) {
#pragma unroll
  for (int s = 0; s < S; ++s)
    acc[s] = fmaf(wd, lw[(s + 2 * S - 1 - u) % S] + rw[(s + 1 + u) % S],
                  acc[s]);
}

// The symmetric circulant on one field,
//   o[x] = w[0] a[x] + sum_{d>=1} w[d] (a[x-d] + a[x+d]),  indices mod L,
// w padded with zeros to 1 + ns*len taps (len a multiple of kBlock).  Work
// unit (slice, block) = sites [kBlock*block, +kBlock) over taps
// [1 + slice*len, 1 + (slice+1)*len); slice 0 adds the centre tap.  With
// ns == 1 each unit hands its sums to consume(x, o); otherwise the units
// write `part` ([ns][L]) and, after a barrier, consume() runs per site on
// the slices' sums in slice order (a unit and the per-site pass give a
// thread the same sites in both fields, so a second call may read what the
// first one's consume() wrote).  Every thread must call it.
template <typename F>
__device__ __forceinline__ void circulant(const float* __restrict__ a,
                                          const float* __restrict__ w,
                                          int L, int nb, int ns, int len,
                                          float* part, F consume) {
  constexpr int S = kBlock;
  for (int unit = threadIdx.x; unit < nb * ns; unit += kThreads) {
    const int sl = unit / nb, x0 = (unit - sl * nb) * S;
    const int d0 = sl * len;  // the window before the slice's first tap
    float lw[S], rw[S], acc[S];
    int lo = wrap(x0 - d0, L), hi = wrap(x0 + d0, L);
#pragma unroll
    for (int s = 0; s < S; ++s) {  // slot s holds x0 + s -/+ d0
      lw[s] = a[lo];
      rw[s] = a[hi];
      lo = lo == L - 1 ? 0 : lo + 1;
      hi = hi == L - 1 ? 0 : hi + 1;
    }
    const float w0 = sl == 0 ? __ldg(w) : 0.f;
#pragma unroll
    for (int s = 0; s < S; ++s) acc[s] = w0 * lw[s];
    lo = wrap(x0 - d0, L);              // the next left site is lo - 1
    hi = wrap(x0 + S - 1 + d0, L);      // the next right site is hi + 1
    const float* wp = w + 1 + d0;
    for (int c = 0; c < len; c += S) {
#pragma unroll
      for (int u = 0; u < S; ++u) {
        // tap d = d0 + c + u + 1 = 1 + u (mod S): left site x0 + s - d
        // sits in slot (s - 1 - u) mod S, right site x0 + s + d in slot
        // (s + 1 + u) mod S; the new values enter slots S-1-u and u
        lo = lo == 0 ? L - 1 : lo - 1;
        hi = hi == L - 1 ? 0 : hi + 1;
        lw[S - 1 - u] = a[lo];
        rw[u] = a[hi];
        tap_sum<S>(lw, rw, acc, __ldg(wp + c + u), u);
      }
    }
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int x = x0 + s;
      if (x >= L) break;
      if (ns == 1) {
        consume(x, acc[s]);
      } else {
        part[sl * L + x] = acc[s];
      }
    }
  }
  if (ns > 1) {
    __syncthreads();
    for (int x = threadIdx.x; x < L; x += kThreads) {
      float o = part[x];
      for (int sl = 1; sl < ns; ++sl) o += part[sl * L + x];
      consume(x, o);
    }
    __syncthreads();  // `part` is free again
  }
}

// An affine map v -> a v + b, in float64; after(l, e) is l o e.
struct Aff {
  double a, b;
};
__device__ __forceinline__ Aff after(Aff l, Aff e) {
  return {l.a * e.a, fma(l.a, e.b, l.b)};
}
__device__ __forceinline__ Aff shfl_up(Aff v, int d) {
  return {__shfl_up_sync(0xffffffffu, v.a, d),
          __shfl_up_sync(0xffffffffu, v.b, d)};
}
__device__ __forceinline__ Aff shfl_down(Aff v, int d) {
  return {__shfl_down_sync(0xffffffffu, v.a, d),
          __shfl_down_sync(0xffffffffu, v.b, d)};
}

// One sweep of the scan solve over this thread's run [lo, hi) of field F
// on its half of the block (kHalf threads, one field each).  Forward:
// y_i = alpha_i y_{i-1} + inv_i F_i from y_{-1} = 0; back (rev): x_i =
// -c'_i x_{i+1} + F_i from x_L = 0 (c'_{L-1} = 0).  `tot` holds the half's
// kHalf/32 warp totals; the caller's barrier must separate two uses of it.
// Writes the result over F[lo, hi).
__device__ __forceinline__ void scan_sweep(float* F, int lo, int hi,
                                           const double* __restrict__ coef,
                                           const double* __restrict__ inv,
                                           bool rev, Aff* tot) {
  const int lane = threadIdx.x & 31, wh = (threadIdx.x & (kHalf - 1)) >> 5;
  constexpr int kHalfWarps = kHalf / 32;
  Aff v{1.0, 0.0};
  if (!rev) {
    for (int i = lo; i < hi; ++i) {
      const double al = __ldg(coef + i);
      v = {al * v.a, fma(al, v.b, (double)F[i] * __ldg(inv + i))};
    }
  } else {
    for (int i = hi - 1; i >= lo; --i) {
      const double ng = -__ldg(coef + i);
      v = {ng * v.a, fma(ng, v.b, (double)F[i])};
    }
  }
  // inclusive warp scan in sweep order (rev: lane 31 first)
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Aff o = rev ? shfl_down(v, d) : shfl_up(v, d);
    if (rev ? lane + d < 32 : lane >= d) v = after(v, o);
  }
  if (lane == (rev ? 0 : 31)) tot[wh] = v;
  Aff e = rev ? shfl_down(v, 1) : shfl_up(v, 1);
  if (lane == (rev ? 31 : 0)) e = {1.0, 0.0};
  __syncthreads();
  // the warps before this one in sweep order: lane l < kHalfWarps takes the
  // total of the warp at sweep position l, and a shuffle scan composes them
  Aff t{1.0, 0.0};
  if (lane < kHalfWarps) t = tot[rev ? kHalfWarps - 1 - lane : lane];
#pragma unroll
  for (int d = 1; d < kHalfWarps; d <<= 1) {
    const Aff o = shfl_up(t, d);
    if (lane >= d) t = after(t, o);
  }
  const int at = rev ? kHalfWarps - 1 - wh : wh;  // this warp's position
  Aff q{__shfl_sync(0xffffffffu, t.a, at > 0 ? at - 1 : 0),
        __shfl_sync(0xffffffffu, t.b, at > 0 ? at - 1 : 0)};
  if (at == 0) q = {1.0, 0.0};
  double y = after(e, q).b;  // the value entering the run
  if (!rev) {
    for (int i = lo; i < hi; ++i) {
      y = fma(__ldg(coef + i), y, (double)F[i] * __ldg(inv + i));
      F[i] = (float)y;
    }
  } else {
    for (int i = hi - 1; i >= lo; --i) {
      y = fma(-__ldg(coef + i), y, (double)F[i]);
      F[i] = (float)y;
    }
  }
}

struct Args {
  const float* scal;  // (B, 4) [beta, lam, gamma, 0]
  const int* seeds;
  int step0;
  int b0;
  const float *rp_in, *rm_in, *pos_in, *spin_in, *hist_in;
  float *rp_out, *rm_out, *pos_out, *spin_out, *hist_out, *recs;
  const double* scan;        // (4, L) [1/pivot, c', alpha, z] (exact solve)
  const float* solve_taps;   // (1 + sv_ns*sv_len,) padded taps (banded)
  const float* smooth_taps;  // (1 + sm_ns*sm_len,) padded taps (smoothed m)
  float* dens;               // (B, k, L) total density per step (kmax > 0)
  const int* noise;
  int L, n_t, window, k_steps, kmax, m_mode, solve_mode;
  int sm_nb, sm_ns, sm_len, sv_nb, sv_ns, sv_len;  // circulant plans
  int periodic, bidirectional;
  float dt, dx, xlim, v_last, fac, w_dt, w_2dt;
};

__global__ void __launch_bounds__(kThreads) pde_kernel(Args a) {
  // the scan's double-word table first, so it is 16-byte aligned whatever
  // L and n_t
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x, tid = threadIdx.x;
  const int L = a.L, n_t = a.n_t, kmax = a.kmax;
  const bool local_m = a.m_mode != kGlobal;

  Aff* scanT = reinterpret_cast<Aff*>(smem);  // 2 x kWarps
  // state (P, M) and scratch (Q, N) swap roles from step to step
  float* P = reinterpret_cast<float*>(scanT + 2 * kWarps);
  float* M = P + L;
  float* Q = M + L;
  float* N = Q + L;
  float* mS = N + L;                       // L floats when local_m
  float* DR = mS + (local_m ? L : 0);      // n_t
  float* redA = DR + n_t;                  // kWarps * 2
  float* redB = redA + kWarps * 2;         // kWarps * 2
  float* redD = redB + kWarps * 2;         // kWarps * 3
  float* part = redD + kWarps * 3;         // circulant partial sums

  const float beta = a.scal[4 * b], lam = a.scal[4 * b + 1];
  const float noise_amp = sqrtf(__fmul_rn(2.f * a.scal[4 * b + 2], a.dt));
  const float inv_L = 1.f / (float)L;
  const float inv_nt = 1.f / (float)(n_t > 1 ? n_t : 1);
  const float dt = a.dt, dx = a.dx;
  const size_t foff = (size_t)b * L, toff = (size_t)b * n_t;
  const int rw = 4 + 2 * kmax;
  const uint2 key = make_uint2((uint32_t)a.seeds[b], (uint32_t)(a.b0 + b));

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
    float* drow =
        a.dens ? a.dens + ((size_t)b * a.k_steps + s) * L : nullptr;

    // -- magnetization of the pre-step densities --------------------------
    if (a.m_mode == kTaps) {
      for (int x = tid; x < L; x += kThreads) {
        Q[x] = P[x] - M[x];
        N[x] = P[x] + M[x];
        if (drow) __stcs(drow + x, N[x]);
      }
      __syncthreads();
    }
    float vA[2] = {0.f, 0.f};
    if (a.m_mode == kTaps) {  // mS holds the smoothed numerator between
      circulant(Q, a.smooth_taps, L, a.sm_nb, a.sm_ns, a.sm_len, part,
                [&](int x, float sn) { mS[x] = sn; });
      circulant(N, a.smooth_taps, L, a.sm_nb, a.sm_ns, a.sm_len, part,
                [&](int x, float sd) {
                  const float mx = mS[x] / (sd + 1e-12f);
                  mS[x] = mx;
                  vA[0] += mx;
                });
      for (int x = tid; x < L; x += kThreads) vA[1] += P[x] + M[x];
    } else {
      for (int x = tid; x < L; x += kThreads) {
        const float p = P[x], q = M[x];
        if (drow) __stcs(drow + x, p + q);
        if (a.m_mode == kGlobal) {
          vA[0] += p - q;
        } else {
          const float mx = (p - q) / (p + q + 1e-12f);
          mS[x] = mx;
          vA[0] += mx;
        }
        vA[1] += p + q;
      }
    }
    block_sum<2>(vA, redA);  // its barrier also publishes mS
    const float m_glob = vA[0] / (vA[1] + 1e-12f);
    const float m_mean = local_m ? vA[0] * inv_L : m_glob;
    const float t_mean = vA[1] * inv_L;

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
    // the periodic exact solve's corner correction: P1[x] - cP z[x]
    float cP = 0.f, cM = 0.f;
    const double* zz = nullptr;
    if (a.solve_mode == kExact) {  // in place: two scan sweeps per field
      const int h = tid / kHalf, t = tid - h * kHalf;
      const int run = (L + kHalf - 1) / kHalf;
      const int lo = min(L, t * run), hi = min(L, lo + run);
      float* F = h == 0 ? P : M;
      const double* g = a.scan;
      scan_sweep(F, lo, hi, g + 2 * L, g, false, scanT + h * (kHalf / 32));
      scan_sweep(F, lo, hi, g + L, nullptr, true,
                 scanT + kWarps + h * (kHalf / 32));
      __syncthreads();
      if (a.periodic) {  // Sherman-Morrison: x - c z, applied where read
        cP = a.fac * (P[0] + a.v_last * P[L - 1]);
        cM = a.fac * (M[0] + a.v_last * M[L - 1]);
        zz = g + 3 * L;
      }
    } else if (a.solve_mode == kBanded) {
      circulant(P, a.solve_taps, L, a.sv_nb, a.sv_ns, a.sv_len, part,
                [&](int x, float v) { Q[x] = v; });
      circulant(M, a.solve_taps, L, a.sv_nb, a.sv_ns, a.sv_len, part,
                [&](int x, float v) { N[x] = v; });
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
        float p1 = P1[x], m1 = M1[x], pl = P1[xl], mr = M1[xr];
        if (zz) {
          const float z = (float)__ldg(zz + x);
          p1 -= cP * z;
          m1 -= cM * z;
          pl -= cP * (float)__ldg(zz + xl);
          mr -= cM * (float)__ldg(zz + xr);
        }
        float dp = (p1 - pl) / dx;
        float dm = (mr - m1) / dx;
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
        float p1 = P1[x], m1 = M1[x];
        if (zz) {
          const float z = (float)__ldg(zz + x);
          p1 -= cP * z;
          m1 -= cM * z;
        }
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

extern "C" size_t pde_multi_step_smem_bytes(int L, int n_t, int local_m,
                                            int part_floats) {
  return sizeof(Aff) * 2 * kWarps +
         sizeof(float) * ((size_t)(local_m ? 5 : 4) * L + n_t + 7 * kWarps +
                          (size_t)part_floats);
}

extern "C" int pde_multi_step_launch(
    const float* scal, const int* seeds, int step0, int b0,
    const float* rp_in,
    const float* rm_in, const float* pos_in, const float* spin_in,
    const float* hist_in, float* rp_out, float* rm_out, float* pos_out,
    float* spin_out, float* hist_out, float* recs, const double* scan,
    const float* solve_taps, const float* smooth_taps, float* dens,
    const int* noise, int B, int L, int n_t, int window,
    int k_steps, int kmax, int m_mode, int solve_mode, int sm_nb, int sm_ns,
    int sm_len, int sv_nb, int sv_ns, int sv_len, int part_floats,
    int periodic, int bidirectional, float dt, float dx, float xlim,
    float v_last, float fac, float w_dt, float w_2dt, void* stream) {
  Args a{scal,     seeds,      step0,   b0,      rp_in,       rm_in,
         pos_in,   spin_in,    hist_in, rp_out,  rm_out,      pos_out,
         spin_out, hist_out,   recs,    scan,    solve_taps,  smooth_taps,
         dens,     noise,      L,       n_t,     window,
         k_steps,  kmax,       m_mode,  solve_mode, sm_nb,    sm_ns,
         sm_len,   sv_nb,      sv_ns,   sv_len,  periodic,    bidirectional,
         dt,       dx,         xlim,    v_last,  fac,         w_dt,
         w_2dt};
  const size_t smem =
      pde_multi_step_smem_bytes(L, n_t, m_mode != kGlobal, part_floats);
  cudaError_t e = cudaFuncSetAttribute(
      pde_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  pde_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

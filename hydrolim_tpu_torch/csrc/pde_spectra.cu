// Kernel B2's spectra: the first kmax rfft bins of each step's total
// density, divided by L, for all the steps of a call at once.
//
// Replaces the spectra of the TPU kernel hydrolim_tpu/ops/pallas_pde.py
// (`_kernel`, called through `pde_multi_step`): there one HIGHEST-precision
// (R, Lp) @ (Lp, 128) product per step against the record slab, kmax <= 62.
// Here the step kernel (csrc/pde_multi_step.cu) stores each step's density
// row into a (B, k, L) scratch, and this kernel computes the (B*k) x
// 2*kmax bins -- any kmax <= L/2 + 1 -- right after it on the same stream,
// off the steps' dependency chain.
//
// What bounds it on an H100: a row of L densities in, 2*kmax bins out; an
// FFT does about 5/2 L log2 L operations a row, so at the single run's 50
// steps of L = 1000 by 501 bins the bytes (0.4 MB: ~0.12 us) bound it, and
// the launch and the sums' dependent chains are what is left to pay.  The
// direct sum against the table trig[(k x) mod L] (2*L*2*kmax operations a
// row) costs 40x the FFT's at 501 bins.
//
// Design: one split of the DFT (Cooley-Tukey, L = n1 * n2, n1 chosen by
// the wrapper: ops/pde_kernel.spectra_plan).  With x = n2*j1 + j2 and
// k = k1 + n1*k2,
//   X[k] = sum_j2 W_L^(j2 k1) W_n2^(j2 k2) sum_j1 x[n2 j1 + j2] W_n1^(j1 k1),
// every twiddle W_m^e = exp(-2 pi i e / m) read from the (2, L) [cos, sin]
// table at (e L / m) mod L.  Stage 1: one thread per (row, k1 < min(n1,
// kmax), j2), n1 terms, then the twiddle W_L^(j2 k1); stage 2: one thread
// per (row, k < kmax), n2 complex terms.  A block takes `rpb` rows, staged
// with the table in shared memory (coalesced loads); in stage 1 a warp's
// lanes are consecutive j2 of one k1 (consecutive densities, one table
// word), in stage 2 consecutive k (rows of the stage-1 table n2 words
// apart: no bank conflict where n2 is odd, as at L = 1000; one table word
// per k2).  At L = 1000 (n1 = 40, n2 = 25) and 501 bins that is 130k FMAs
// a row against the direct sum's 1M, in chains of 40 and 25.  A prime L
// gets n1 = L: the direct sum.  Where the table and a row do not fit a
// block's shared memory (L past ~19,000 at 8 bins, the lattices of a
// cluster of kernel B2), the block reads them from device memory through
// the read-only path (the table is L2-resident: 512 kB at L = 65,536), and
// the stage-1 sums go to shared memory where they fit, else to a scratch
// in device memory (`ys`, rpb rows a block); the sums are the same.
// FP32 FMAs (no TF32: the reference ran the spectra at Precision.HIGHEST);
// the sums are shorter than the direct sum's, so no less accurate.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;

// Table and rows from shared memory (kStage) or through the read-only path.
template <bool kStage>
__device__ __forceinline__ float ld(const float* p) {
  return kStage ? *p : __ldg(p);
}

template <bool kStage>
__global__ void __launch_bounds__(kThreads)
spectra_kernel(const float* __restrict__ dens, const float* __restrict__ trig,
               float* __restrict__ recs, float* ys, int rows, int L,
               int kmax, int rw, int n1, int rpb) {
  extern __shared__ float sm[];
  const int n2 = L / n1, k1n = min(n1, kmax), per = n2 * k1n;
  const int r0 = blockIdx.x * rpb, nr = min(rpb, rows - r0);
  const float* src = dens + (size_t)r0 * L;
  const float *cs = trig, *sn = trig + L, *X = src;
  float* Yr = ys ? ys + (size_t)blockIdx.x * rpb * 2 * per : sm;
  if (kStage) {
    float* t = sm;                  // (2, L) cos, sin(2 pi j / L)
    float* x = t + 2 * L;           // (rpb, L) densities
    Yr = x + (size_t)rpb * L;       // (rpb, k1n, n2) stage 1, real
    for (int i = threadIdx.x; i < 2 * L; i += kThreads) t[i] = trig[i];
    for (int i = threadIdx.x; i < nr * L; i += kThreads) x[i] = src[i];
    cs = t;
    sn = t + L;
    X = x;
    __syncthreads();
  }
  float* Yi = Yr + (size_t)rpb * per;

  // stage 1: Y[k1][j2] = W_L^(j2 k1) sum_j1 x[n2 j1 + j2] W_n1^(j1 k1)
  for (int t = threadIdx.x; t < nr * per; t += kThreads) {
    const int r = t / per, q = t - r * per;
    const int k1 = q / n2, j2 = q - k1 * n2;
    const float* xs = X + (size_t)r * L + j2;
    const int step = n2 * k1;     // < L
    int e = 0;
    float re = 0.f, im = 0.f;     // sum x cos, sum x sin
    for (int j1 = 0; j1 < n1; ++j1) {
      const float v = ld<kStage>(xs + j1 * n2);
      re = fmaf(v, ld<kStage>(cs + e), re);
      im = fmaf(v, ld<kStage>(sn + e), im);
      e += step;
      if (e >= L) e -= L;
    }
    const int tw = j2 * k1;       // < L
    const float c = ld<kStage>(cs + tw), s = ld<kStage>(sn + tw);
    // (re - i im)(c - i s)
    Yr[t] = fmaf(re, c, -im * s);
    Yi[t] = -fmaf(re, s, im * c);
  }
  __syncthreads();

  // stage 2: X[k1 + n1 k2] = sum_j2 Y[k1][j2] W_n2^(j2 k2)
  const float inv_L = 1.f / (float)L;
  for (int t = threadIdx.x; t < nr * kmax; t += kThreads) {
    const int r = t / kmax, k = t - r * kmax;
    const int k1 = k % n1, k2 = k / n1;
    const float* yr = Yr + (size_t)r * per + k1 * n2;
    const float* yi = Yi + (size_t)r * per + k1 * n2;
    const int step = n1 * k2;     // < L
    int e = 0;
    float xr = 0.f, xi = 0.f;
    for (int j2 = 0; j2 < n2; ++j2) {
      const float c = ld<kStage>(cs + e), s = ld<kStage>(sn + e);
      // (yr + i yi)(c - i s)
      xr = fmaf(yr[j2], c, fmaf(yi[j2], s, xr));
      xi = fmaf(yi[j2], c, fmaf(-yr[j2], s, xi));
      e += step;
      if (e >= L) e -= L;
    }
    float* out = recs + (size_t)(r0 + r) * rw + 4;
    out[k] = xr * inv_L;
    out[kmax + k] = xi * inv_L;
  }
}

}  // namespace

// stage: the table and the rows in shared memory; else through the
// read-only path, and the stage-1 sums in `ys` (rows x 2 x per floats) when
// it is given, else in shared memory.
extern "C" int pde_spectra_launch(const float* dens, const float* trig,
                                  float* recs, float* ys, int rows, int L,
                                  int kmax, int rw, int n1, int rpb,
                                  int stage, void* stream) {
  if (rows < 1 || L < 1 || kmax < 1 || 2 * kmax > rw - 4 || n1 < 1 ||
      L % n1 != 0 || kmax > L / 2 + 1 || rpb < 1 || (stage && ys))
    return (int)cudaErrorInvalidValue;
  // ops/pde_kernel.py spectra_smem_bytes
  const size_t per = (size_t)(L / n1) * (size_t)(n1 < kmax ? n1 : kmax);
  const size_t smem =
      sizeof(float) * ((stage ? 2 * (size_t)L + (size_t)rpb * L : 0) +
                       (ys ? 0 : 2 * (size_t)rpb * per));
  const int blocks = (rows + rpb - 1) / rpb;
  auto fn = stage ? spectra_kernel<true> : spectra_kernel<false>;
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  fn<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      dens, trig, recs, ys, rows, L, kmax, rw, n1, rpb);
  return (int)cudaGetLastError();
}

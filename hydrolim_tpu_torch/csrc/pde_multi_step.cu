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
// 2*L field values and n_t tracers (2*(2r+1)*L FMAs for a banded solve or
// a narrow smoothing, 2*L^2 with the full smoothing circulant, ~10 n log2 n
// flops and three passes of n complex values by its FFT): too little
// work per replica to be bound by bandwidth, and every reduction (m, Var,
// tracer mean and variance, mass renormalisation) is a barrier.  On one
// CTA a replica's taps run on one SM (the L = 8192 banded step: 127 taps x
// 2 fields x 8192 sites, ~9 us at full issue), and one CTA's shared memory
// holds 5 fields of at most ~11,600 sites.
//
// Design: C CTAs per replica, by one of two routes that run one step body
// (`b2_steps`, templated on how the CTAs meet):
//   - the cluster route (`pde_kernel`, ClusterNet): a thread-block cluster
//     of C = 1, 2, 4, 8 or 16 CTAs; the fields live in the CTAs' shared
//     memory, a neighbour's sites are read through distributed shared
//     memory (cluster.map_shared_rank) after a cluster barrier;
//   - the device-memory route (`pde_gmem_kernel`, GmemNet), past what a
//     cluster's shared memory holds: G = 1 .. 256 CTAs, all co-resident (a
//     cooperative launch), the fields in device memory (L2-resident up to a
//     few million sites), each phase streaming a CTA's segment from there;
//     a neighbour's sites are plain loads after a barrier of the replica's
//     G CTAs (an arrival counter, released and acquired by fences).
// On the device-memory route the full smoothing is no circulant but an FFT
// convolution (`fft_smooth`, m_mode kFft, in a kernel of its own,
// `pde_gmem_fft_kernel`): the direct circulant's 2 L^2 FMAs a field are
// 3.4e10 at L = 131,072, about a millisecond a step.
//
// The FFT stage.  One complex transform of n = n1 * n2 points (z = num +
// i den, two fields for one) in three passes that meet through a complex
// scratch in device memory (columns; rows with the spectrum between the
// forward and the inverse transform; columns), each pass's units spread
// over the replica's G CTAs.  What bounds it: its fewest operations are
// ~10 n log2 n flops a step, well under a microsecond; what it pays is
// (i) the replica barriers between the passes, a few microseconds each
// (the arrival counter's round trips through L2, and the slowest CTA),
// (ii) past ~2 million sites the scratch's traffic in device memory (the
// fields, then 8 n bytes written and read twice, ~64 MB a replica at
// 4,194,304: past the 50 MB L2), and below that the latency of each
// unit's loads, with one CTA an SM (512 threads at 128 registers), and
// (iii) the sub-transforms' shared-memory traffic and registers: a step
// that held a thread's 16 values across a barrier spilled.  What the
// design does:
//   - no pass of its own for m: pass 1 reads the step's state (srcP sc,
//     srcM sc) itself, forms num + i den in registers, and stores the
//     state and the spectra's row on the way (each site once), so the
//     state lands in the scratch rows, which swap roles with P, M; pass 3
//     forms m = num / (den + 1e-12) and its sum, and the step's first
//     reduction (cta_total) is its barrier: two replica barriers for the
//     smoothing and m, where the first design took four and two more
//     field passes;
//   - a CTA's units two deep: unit u + G is copied into the second
//     landing buffer with cp.async (16 bytes a copy: two complex values,
//     or four sites of a power-of-two row; 4 for a wrapped row, which has
//     no alignment) while unit u runs, its steps out of place between its
//     landing buffer and a third buffer (an item read, turned and stored
//     at once: one barrier a step, nothing held across it; three buffers
//     of 8192 values, 204 KB);
//   - wide runs: n1 = G where n allows (fft_plan), so passes 1 and 3 take
//     n2 / G columns a unit, 16 or more: 128-byte runs of the scratch or
//     longer, where the first design read 4-8 columns (32-64 bytes) at
//     4,194,304;
//   - Stockham steps (self-sorting, natural order in and out): radix-8
//     butterflies in registers (one radix 4 or 2 step first), twiddles
//     from r-major per-step tables (a warp's lanes on consecutive entries,
//     through L1), complex products as fused multiply-adds, so no bit
//     reversal, and the buffer padded by 2 values every 32, which spreads
//     the strided steps' stores over the banks;
//   - the first step of a pass reads its copied unit, the last writes the
//     pass's result straight to device memory with the pass's twiddle or
//     the spectrum, read before the item's butterflies.
// Two CTAs an SM would hide more latency, but the step body's 128
// registers a thread allow one.
// ops/pde_kernel.py picks the route and C (pde_route_plan).  The lattice is
// padded to Lp = the next power of two, and CTA r owns sites [r*seg,
// (r+1)*seg) of it, seg = Lp / C, and tracers [r*tseg, (r+1)*tseg), tseg =
// ntp / C (ntp = n_t padded to a power of two).
//
// Every result is the same bit for bit at every C and on both routes,
// because no arithmetic depends on which CTA does it or where the fields
// live -- except the full smoothing, a direct circulant on the cluster
// route and an FFT convolution on the device-memory route, which agree to
// float32 roundoff and not bit for bit (so do the steps that read m):
//   - a sum over sites (or tracers) is the adjacent-pairing binary tree
//     over the Lp (ntp) padded leaves: a warp's butterfly over 32 sites, a
//     tree over the warp's chunks (in groups of 32, the groups' totals
//     paired in turn), over the CTA's 16 warps, over the C CTAs, each an
//     aligned power-of-two range of the one tree (padding adds 0.0,
//     exactly);
//   - the circulant sum_d w(d) (x[i-d] + x[i+d]) (indices mod L) serves the
//     narrow smoothing, the full circulant (d up to L/2; for even L the
//     host halves the d = L/2 tap, so its pair adds it once) and the banded
//     solve.  Its law: the taps are cut into ns slices of `len` taps
//     (ops/pde_kernel.py tap_plan, a function of L and the radius), each
//     site's slice is one fused multiply-add chain from its outermost tap
//     inward, the centre tap w(0) x[i] last, and the slices' sums are added
//     from the last slice to the first: the smallest terms first.  (Summed
//     outward, from w(0) x[i], a tap's term falls below half an ulp of the
//     running sum and is dropped or rounded up as the field's binade
//     decides: the banded solve then moved the mass by -4e-8 .. +1.6e-8 a
//     step, against the +1.06e-8 its float32 taps carry.)  A thread
//     computes kBlock consecutive sites of one field over one slice,
//     sliding two windows through registers (a circular buffer whose slots
//     rotate at compile time, so tap d -> d-1 loads one new value per side
//     for kBlock outputs; kBlock is odd, so loads at stride kBlock are free
//     of bank conflicts).  The inputs it reads -- a tile of the segment
//     (the whole segment on the cluster route) and `tb` taps of ring on
//     each side, wrapping around the lattice -- are first staged into this
//     CTA's shared memory; past one stage of taps (the full circulant at
//     large L) the taps run in passes, outermost first, the chains' partial
//     sums kept in shared memory between them;
//   - the exact solve (1+2c) x_i - a_i x_{i-1} - c x_{i+1} = rho_i: both
//     sweeps of Thomas are first-order affine recurrences with coefficients
//     fixed from step to step (forward y_i = alpha_i y_{i-1} + inv_i rho_i,
//     back x_i = y_i - c'_i x_{i+1}), so each runs as a scan of affine maps
//     over 16 tiles of 32 runs of `run` = Lp/512 (at least 1) sites: a run
//     composed in registers, a 32-lane shuffle scan per tile, the tiles'
//     totals published and scanned the same way in every CTA; the two
//     fields at once on the two halves of the block.  A CTA takes tiles
//     [r*ntl, (r+1)*ntl), ntl = tiles / C, or, past 16 CTAs, tile r (the
//     rest wait).  Neumann's mirrored last row carries 2c in a_i; periodic
//     adds a Sherman-Morrison correction for the corners from x_0 and
//     x_{L-1}, applied where the next phase reads the solved fields.
//     Factors come from the host in float64 (ops/diffusion.py); the scan
//     composes its maps in float64 and stores f32 fields;
//   - upwind advection, CW reaction, clip and mass renormalisation, in the
//     bidirectional branch, or in anchored_minus (reaction first, then the
//     advection of rho_+* alone, read across a barrier); a segment's edge
//     reads its neighbour's site.  The file is compiled with --fmad=false
//     (ops/_build.py), so these products and sums are rounded one by one
//     as the plain version rounds them; the circulant's and the scan's
//     fused multiply-adds are written out.  The renormalisation's scale is
//     applied where the next step (or the final store) reads the fields.
// Barriers per step: the three reductions (m; Var and the tracers' mean
// displacement; the masses and the tracers' variance), one before a
// smoothing's staging or two more in the FFT stage, one after a banded
// solve, three in an exact solve and one in anchored_minus.
// Tracers take one thread each, in the CTA that owns them; a tracer reads
// m at int(mod(pos, xlim)/dx) mod L from the CTA owning that site; their
// windowed displacement ring stays in device memory, touched once per
// tracer-step.  Spectra: no later step reads them, so they are off the
// step's chain: with kmax > 0 each step stores its total density row into
// a (B, k, L) scratch (coalesced, and marked evict-first, __stcs, so that a
// scratch of many steps does not push the tracers' ring out of L2) and the
// spectra kernel (csrc/pde_spectra.cu), launched right after on the same
// stream, computes all the steps' bins across the card.
//
// Random bits: injected (noise, (B, k, 3, n_t) uint32 held in int32: flip,
// Box-Muller u2, u3) or native Philox with key (seed[b], b0 + b), b0 the
// global index of the launch's first replica, and counter
// (tracer, step0 + s, 0, 0), whose first three words are the three draws.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "philox.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;  // 128 registers a thread: no spills
constexpr int kWarps = kThreads / 32;
constexpr int kHalf = kThreads / 2;  // the scan solve: one field per half
constexpr int kHalfWarps = kHalf / 32;
constexpr int kBlock = 9;            // sites per unit of the circulant
constexpr int kTiles = 32;           // scan tiles of the exact solve
constexpr int kMaxCluster = 16;
constexpr int kMaxCtas = 256;        // CTAs per replica, device-memory route
constexpr int kMaxSeg = 1 << 24;     // sites per CTA, device-memory route
constexpr int kPub = 4;              // floats a CTA publishes a reduction
constexpr int kBar = 32;             // words per replica's arrival counter

constexpr int kFftMaxSub = 8192;     // points of an FFT sub-transform
constexpr unsigned kFull = 0xffffffffu;

enum MMode { kGlobal = 0, kPointwise = 1, kTaps = 2, kFft = 3 };
enum SolveMode { kNoSolve = 0, kExact = 1, kBanded = 2 };

// This CTA's share of the lattice and of the tracers.
struct Geo {
  int C, rank, L, seg, shift, lo, nloc;  // sites [lo, lo + nloc)
  int tseg, t0, tloc;                    // tracers [t0, t0 + tloc)
};

__device__ __forceinline__ void cluster_sync(int C) {
  if (C > 1) {
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  } else {
    __syncthreads();
  }
}

// The same shared-memory object in CTA `r` of the cluster.
template <typename T>
__device__ __forceinline__ T* at_rank(T* p, int r, int C) {
  return C > 1 ? cg::this_cluster().map_shared_rank(p, (unsigned)r) : p;
}

// A barrier of a replica's G co-resident CTAs through device memory: each
// CTA adds one to the replica's counter (which only grows; G is a power of
// two, so the wrap at 2^32 keeps the arithmetic) and waits until the
// counter reaches the end of its generation.  The fences on either side
// release this CTA's writes and acquire the others' (as cooperative
// groups' grid barrier does).
__device__ __forceinline__ void replica_sync(unsigned* ctr, int G) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    const unsigned old = atomicAdd(ctr, 1u);
    const unsigned target = (old & ~(unsigned)(G - 1)) + (unsigned)G;
    while ((int)(*(volatile unsigned*)ctr - target) < 0) {
    }
    __threadfence();
  }
  __syncthreads();
}

// How a replica's CTAs meet on the cluster route: cluster barriers, and
// the published totals read through distributed shared memory.
struct ClusterNet {
  static constexpr bool kGlobalMem = false;
  static constexpr int kUnroll = 1;  // chunks a warp loads at once
  int C;
  __device__ __forceinline__ void sync() const { cluster_sync(C); }
  __device__ __forceinline__ float* mine(float* pub, int) const { return pub; }
  __device__ __forceinline__ const float* pub_of(float* pub, int r) const {
    return at_rank(pub, r, C);
  }
  template <typename T>
  __device__ __forceinline__ T* tt_of(T* tt, int r) const {
    return at_rank(tt, r, C);
  }
};

// ... and on the device-memory route: the replica's counter, and the
// published totals in one device array per replica.
struct GmemNet {
  static constexpr bool kGlobalMem = true;
  static constexpr int kUnroll = 8;  // loads in flight from L2 / HBM
  int G;
  unsigned* ctr;
  __device__ __forceinline__ void sync() const {
    if (G > 1) {
      replica_sync(ctr, G);
    } else {
      __syncthreads();
    }
  }
  __device__ __forceinline__ float* mine(float* pub, int r) const {
    return pub + r * kPub;
  }
  __device__ __forceinline__ const float* pub_of(float* pub, int r) const {
    return pub + r * kPub;
  }
  template <typename T>
  __device__ __forceinline__ T* tt_of(T* tt, int) const {
    return tt;
  }
};

// Site j (global, in [0, L)) of a field whose segment is `buf`.
template <class Net>
__device__ __forceinline__ float site(const Geo& g, float* buf, int j) {
  if constexpr (Net::kGlobalMem) {
    return buf[j - g.lo];
  } else {
    const int r = j >> g.shift;
    if (r == g.rank) return buf[j - g.lo];
    return at_rank(buf, r, g.C)[j - (r << g.shift)];
  }
}

__device__ __forceinline__ int wrap(int i, int L) {
  i %= L;
  return i < 0 ? i + L : i;
}

// The adjacent-pairing butterfly: lane pairs (l, l^1), then pairs of pairs,
// ...; every lane ends with the same sum (addition commutes exactly).
template <int NV>
__device__ __forceinline__ void warp_tree(float (&v)[NV]) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
#pragma unroll
    for (int i = 0; i < NV; ++i) v[i] += __shfl_xor_sync(kFull, v[i], o);
  }
}

// Ask for the line holding *p in this SM's L1 (a hint: no result, no
// ordering), so that a pass whose every leaf loads, then stores, keeps
// several chunks' loads in flight.
__device__ __forceinline__ void prefetch_l1(const float* p) {
  asm volatile("prefetch.global.L1 [%0];" ::"l"(p));
}

struct NoPrefetch {
  __device__ __forceinline__ void operator()(int) const {}
};

// Sums of NV quantities over an aligned power-of-two range of n_alloc
// leaves (sites or tracers) of which the first n_real are real: chunk c =
// leaves [32c, 32c + 32), the warp's k chunks consecutive, in groups of at
// most 32 (a chunk a lane), the groups' totals paired as one tree (kGroups;
// without it at most 32 chunks a warp, one group: the same sums).  f(i, v)
// fills v with leaf i's values (called only for real leaves); U chunks are
// read before their butterflies, after pf(i) has asked for each of their
// leaves (U > 1).  Every lane of a warp ends with the warp's total.
template <int NV, int U, bool kGroups, typename F,
          typename Pf = NoPrefetch>
__device__ __forceinline__ void warp_sums(int n_alloc, int n_real,
                                          float (&tot)[NV], F f,
                                          Pf pf = Pf()) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nch = n_alloc > 32 ? n_alloc >> 5 : 1;
  const int k = nch > kWarps ? nch / kWarps : 1;
#pragma unroll
  for (int q = 0; q < NV; ++q) tot[q] = 0.f;
  if constexpr (!kGroups) {  // at most 32 chunks a warp (n_alloc <= 16384)
    for (int i = 0; i < k; ++i) {
      const int c = warp * k + i;
      if (c >= nch) break;
      const int x = c * 32 + lane;
      float v[NV];
#pragma unroll
      for (int q = 0; q < NV; ++q) v[q] = 0.f;
      if (x < n_real) f(x, v);
      warp_tree(v);
#pragma unroll
      for (int q = 0; q < NV; ++q) tot[q] = lane == i ? v[q] : tot[q];
    }
    if (k > 1) warp_tree(tot);
    return;
  }
  const int kg = k > 32 ? 32 : k;  // chunks of a group
  const int ng = k / kg;           // groups, a power of two
  float lv[12][NV];                // the groups' tree: pending left halves
  for (int gi = 0; gi < ng; ++gi) {
    float gt[NV];
#pragma unroll
    for (int q = 0; q < NV; ++q) gt[q] = 0.f;
    const int c0 = warp * k + gi * kg;
    for (int i0 = 0; i0 < kg; i0 += U) {
      float v[U][NV];
      if constexpr (U > 1) {
#pragma unroll
        for (int j = 0; j < U; ++j) {
          const int x = (c0 + i0 + j) * 32 + lane;
          if (i0 + j < kg && c0 + i0 + j < nch && x < n_real) pf(x);
        }
      }
#pragma unroll
      for (int j = 0; j < U; ++j) {
#pragma unroll
        for (int q = 0; q < NV; ++q) v[j][q] = 0.f;
        const int c = c0 + i0 + j;
        if (i0 + j < kg && c < nch) {
          const int x = c * 32 + lane;
          if (x < n_real) f(x, v[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < U; ++j) {
        warp_tree(v[j]);
#pragma unroll
        for (int q = 0; q < NV; ++q) gt[q] = lane == i0 + j ? v[j][q] : gt[q];
      }
    }
    if (kg > 1) warp_tree(gt);
    if (ng == 1) {
#pragma unroll
      for (int q = 0; q < NV; ++q) tot[q] = gt[q];
      break;
    }
    int z = gi, l = 0;
    while (z & 1) {  // group gi closes the subtrees its trailing ones end
#pragma unroll
      for (int q = 0; q < NV; ++q) gt[q] = lv[l][q] + gt[q];
      z >>= 1;
      ++l;
    }
#pragma unroll
    for (int q = 0; q < NV; ++q) lv[l][q] = gt[q];
    if (gi == ng - 1) {
#pragma unroll
      for (int q = 0; q < NV; ++q) tot[q] = gt[q];
    }
  }
}

// The replica's total of the warps' totals: the CTA's warps through
// `scratch` ([kWarps][NV]), then the C CTAs' totals, published at `pub`
// and read after a barrier of the replica (a lane adds C/32 of them as one
// tree past 32 CTAs).  Every thread ends with the totals.  A slot may be
// written again only after another barrier of the replica.
template <int NV, class Net>
__device__ __forceinline__ void cta_total(const Geo& g, const Net& net,
                                          float (&v)[NV], float* scratch,
                                          float* pub) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
#pragma unroll
    for (int q = 0; q < NV; ++q) scratch[warp * NV + q] = v[q];
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < NV; ++q) v[q] = lane < kWarps ? scratch[lane * NV + q]
                                                    : 0.f;
  warp_tree(v);
  if (g.C > 1) {
    if (threadIdx.x == 0) {
      float* p = net.mine(pub, g.rank);
#pragma unroll
      for (int q = 0; q < NV; ++q) p[q] = v[q];
    }
    net.sync();
    if constexpr (!Net::kGlobalMem) {  // at most 16 CTAs: one a lane
      const float* src = lane < g.C ? net.pub_of(pub, lane) : nullptr;
#pragma unroll
      for (int q = 0; q < NV; ++q) v[q] = src ? src[q] : 0.f;
      warp_tree(v);
      return;
    }
    const int per = g.C > 32 ? g.C >> 5 : 1;  // CTAs a lane adds
    float t[8][NV];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int q = 0; q < NV; ++q) t[i][q] = 0.f;
      if (i < per && lane * per + i < g.C) {
        const float* src = net.pub_of(pub, lane * per + i);
#pragma unroll
        for (int q = 0; q < NV; ++q) t[i][q] = src[q];
      }
    }
#pragma unroll
    for (int w = 1; w < 8; w <<= 1) {
#pragma unroll
      for (int i = 0; i < 8; i += 2 * w) {
        if (w < per) {
#pragma unroll
          for (int q = 0; q < NV; ++q) t[i][q] += t[i + w][q];
        }
      }
    }
#pragma unroll
    for (int q = 0; q < NV; ++q) v[q] = t[0][q];
    warp_tree(v);
  }
}

__device__ __forceinline__ float cw(float beta, float s, float m) {
  return fminf(fmaxf(expf(-beta * s * m), 1e-8f), 1e8f);
}

// One tap of the circulant on a unit's S outputs, taps taken inward: u
// (the tap's place in its chunk) is a constant once the caller's loop is
// unrolled, so the slots are registers.
template <int S>
__device__ __forceinline__ void tap_sum(const float (&lw)[S],
                                        const float (&rw)[S], float (&acc)[S],
                                        float wd, int u) {
#pragma unroll
  for (int s = 0; s < S; ++s)
    acc[s] = fmaf(wd, lw[(s + u + 1) % S] + rw[(s + 2 * S - 1 - u) % S],
                  acc[s]);
}

// One circulant law and its staging: taps w padded with zeros to
// 1 + ns*len; `tb` taps per pass (a multiple of kBlock), `fp` fields per
// field group.
struct Circ {
  const float* w;
  int ns, len, tb, fp;
};

// The symmetric circulant on the two fields a[0], a[1] (this CTA's
// segments of them; every CTA's must be complete, and stay unchanged until
// the next barrier of the replica),
//   o[x] = sum_{d>=1} w[d] (a[x-d] + a[x+d]) + w[0] a[x],  indices mod L,
// handed to consume(f, i, o) for local site i of field f.  The segment
// runs in tiles of T sites.  Work unit (field, slice, block) = sites
// [kBlock*block, +kBlock) of the tile over the slice's taps in the pass.
// `win` holds `wf` floats for each field of a group: a pass over taps
// (E0, E1] stages sites [lo - E1, lo + n + 9 - E0) and, from offset T + 9
// + tb, [lo + E0, lo + n + 9 + E1) (one window [lo - E1, lo + n + 9 + E1)
// when E0 = 0).  The passes run from the outermost taps inward.  Chains
// that outlive a pass, and the slices when ns > 1, meet in `part`
// ([fp][ns][T]).  Every thread must call it.
template <class Net, typename F>
__device__ __forceinline__ void circulant(const Geo& g, float* a0, float* a1,
                                          const Circ& c, int T, float* win,
                                          int wf, float* part, F consume) {
  constexpr int S = kBlock;
  const int tid = threadIdx.x, L = g.L;
  const int R = c.ns * c.len;
  const bool direct = c.ns == 1 && c.tb >= R;
  for (int t_lo = 0; t_lo < g.nloc; t_lo += T) {
    const int n = min(T, g.nloc - t_lo);
    const int lo = g.lo + t_lo;  // the tile's first site
    const int nu = (n + S - 1) / S;
    for (int f0 = 0; f0 < 2; f0 += c.fp) {
      const int nf = min(c.fp, 2 - f0);
      int E1 = R;
      do {
        const int E0 = max(0, E1 - c.tb);
        // -- stage the pass's inputs ---------------------------------------
        const int n_one = n + S + (E0 == 0 ? 2 * E1 : E1 - E0);
        for (int fi = 0; fi < nf; ++fi) {
          float* a = f0 + fi == 0 ? a0 : a1;
          float* lb = win + fi * wf;
#pragma unroll 4
          for (int i = tid; i < n_one; i += kThreads)
            lb[i] = site<Net>(g, a, wrap(lo - E1 + i, L));
          if (E0 > 0) {
            float* rb = lb + T + S + c.tb;
#pragma unroll 4
            for (int i = tid; i < n_one; i += kThreads)
              rb[i] = site<Net>(g, a, wrap(lo + E0 + i, L));
          }
        }
        __syncthreads();
        // -- the chains of the slices that meet (E0, E1] ------------------
        const int s_lo = c.len ? E0 / c.len : 0;
        const int s_hi = c.len ? (E1 - 1) / c.len : 0;
        const int nsl = max(1, s_hi - s_lo + 1);
        for (int item = tid; item < nf * nsl * nu; item += kThreads) {
          const int fi = item / (nsl * nu);
          const int rem = item - fi * nsl * nu;
          const int sl = s_lo + rem / nu, unit = rem - (rem / nu) * nu;
          const int t0 = max(E0, sl * c.len), t1 = min(E1, (sl + 1) * c.len);
          const float* lb = win + fi * wf;
          const float* rb = E0 == 0 ? lb + E1 : lb + T + S + c.tb;
          const int x0 = unit * S;
          float lw[S], rw[S], acc[S];
          // the windows of tap t1 + 1: left slot s holds site x0 + s - t1 - 1
          // (slot 0 is loaded before its first use), right slot s site
          // x0 + s + t1 + 1 (slot S-1 likewise)
          lw[0] = 0.f;
          rw[S - 1] = 0.f;
#pragma unroll
          for (int s = 1; s < S; ++s) lw[s] = lb[x0 + s - t1 - 1 + E1];
#pragma unroll
          for (int s = 0; s < S - 1; ++s) rw[s] = rb[x0 + s + t1 + 1 - E0];
          float* pp = part + ((size_t)fi * c.ns + sl) * T;
          if (t1 == (sl + 1) * c.len) {  // the slice's outermost taps
#pragma unroll
            for (int s = 0; s < S; ++s) acc[s] = 0.f;
          } else {
#pragma unroll
            for (int s = 0; s < S; ++s)
              acc[s] = x0 + s < n ? pp[x0 + s] : 0.f;
          }
          const float* lo_p = lb + x0 + S - 1 + E1;  // x0 + 8 - d at lo_p[-d]
          const float* hi_p = rb + x0 - E0;          // x0 + d at hi_p[d]
          for (int cc = t1; cc > t0; cc -= S) {
#pragma unroll
            for (int u = 0; u < S; ++u) {
              // tap d = cc - u: left site x0 + s - d sits in slot
              // (s + u + 1) mod S, right site x0 + s + d in slot
              // (s - u - 1) mod S; the new values enter slots u and S-1-u
              const int d = cc - u;
              lw[u] = lo_p[-d];
              rw[S - 1 - u] = hi_p[d];
              tap_sum<S>(lw, rw, acc, __ldg(c.w + d), u);
            }
          }
          if (t0 == 0) {  // slice 0 ends with the centre tap
            const float w0 = __ldg(c.w);
#pragma unroll
            for (int s = 0; s < S; ++s)
              acc[s] = fmaf(w0, lb[x0 + s + E1], acc[s]);
          }
#pragma unroll
          for (int s = 0; s < S; ++s) {
            const int x = x0 + s;
            if (x >= n) break;
            if (direct) {
              consume(f0 + fi, t_lo + x, acc[s]);
            } else {
              pp[x] = acc[s];
            }
          }
        }
        __syncthreads();  // the windows are free again
        E1 = E0;
      } while (E1 > 0);
      if (!direct) {  // the slices' sums, the last slice first
        for (int x = tid; x < n; x += kThreads) {
          for (int fi = 0; fi < nf; ++fi) {
            const float* pp = part + (size_t)fi * c.ns * T;
            float o = pp[(size_t)(c.ns - 1) * T + x];
            for (int sl = c.ns - 2; sl >= 0; --sl) o += pp[(size_t)sl * T + x];
            consume(f0 + fi, t_lo + x, o);
          }
        }
        __syncthreads();  // `part` is free again
      }
    }
  }
}


// -- the full smoothing's FFT stage (m_mode kFft) ---------------------------

constexpr int kFftPad = 16;  // a buffer skips 2 values every 32 (banks)

// Element a of a unit's buffer, padded: a warp's stores at a Stockham
// step's strides 1 and 8 (rows, or columns under 16 wide) meet every bank
// twice, as a contiguous run does, and an even element stays 16-byte
// aligned (cp.async of two values).
__device__ __forceinline__ int fpad(int a) { return a + ((a >> 5) << 1); }
// values of a unit's buffer: padded, and even (each buffer 16-byte aligned)
__host__ __device__ __forceinline__ int fft_unit_values(int buf) {
  return (buf + buf / kFftPad + 1) & ~1;
}

// cp.async: `bytes` from device memory into shared memory without the
// registers, the copy waited on by cp_async_wait; `src_bytes` 0 writes
// zeros.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
// 16 bytes (both addresses 16-byte aligned), through L2 only
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// every group but the newest `N` has landed (this thread's copies)
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The stage's complex products, a fused multiply-add each part (the file
// is built with --fmad=false, so they are written out): a * b, a *
// conj(b).
__device__ __forceinline__ float2 fcmul(float2 a, float2 b) {
  return make_float2(__fmaf_rn(a.x, b.x, -(a.y * b.y)),
                     __fmaf_rn(a.x, b.y, a.y * b.x));
}
__device__ __forceinline__ float2 fcmulc(float2 a, float2 b) {
  return make_float2(__fmaf_rn(a.x, b.x, a.y * b.y),
                     __fmaf_rn(a.y, b.x, -(a.x * b.y)));
}

// d * W_8^e (its conjugate when kInv); e a constant once unrolled.  W_8 =
// c (1 - i), so the product is a sum and a difference scaled by c.
template <bool kInv>
__device__ __forceinline__ float2 rot8(float2 d, int e) {
  constexpr float c = 0.70710678118654752f;
  if (e == 0) return d;
  if (e == 2) return kInv ? make_float2(-d.y, d.x) : make_float2(d.y, -d.x);
  const float s = c * (d.x + d.y), t = c * (d.y - d.x);
  if (e == 1) return kInv ? make_float2(-t, s) : make_float2(s, t);
  return kInv ? make_float2(-s, -t) : make_float2(t, -s);  // e == 3
}

__host__ __device__ constexpr int brev_small(int s, int R) {
  return R == 8 ? ((s & 1) << 2) | (s & 2) | (s >> 2)
                : R == 4 ? ((s & 1) << 1) | (s >> 1) : s;
}

// The R-point DFT (R = 2, 4, 8) of u in registers, natural order in and
// out: a radix-2 decimation-in-frequency network whose bit-reversed outputs
// are renamed at compile time.  Conjugate twiddles when kInv (unscaled).
template <int R, bool kInv>
__device__ __forceinline__ void dft_small(float2 (&u)[R]) {
#pragma unroll
  for (int h = R / 2; h >= 1; h >>= 1) {
#pragma unroll
    for (int b = 0; b < R; b += 2 * h) {
#pragma unroll
      for (int r = 0; r < h; ++r) {
        const float2 a = u[b + r], d = u[b + r + h];
        u[b + r] = make_float2(a.x + d.x, a.y + d.y);
        u[b + r + h] =
            rot8<kInv>(make_float2(a.x - d.x, a.y - d.y), r * (4 / h));
      }
    }
  }
  float2 t[R];
#pragma unroll
  for (int s = 0; s < R; ++s) t[s] = u[brev_small(s, R)];
#pragma unroll
  for (int s = 0; s < R; ++s) u[s] = t[s];
}

// A unit of the FFT stage: `cnt` sequences of length N in a padded
// buffer, element a of sequence c at a * cnt + c (kCols: columns,
// interleaved) or c * N + a (rows); the steps run out of place, from `a`
// into `b`, which then swap.
template <bool kCols>
struct FftUnit {
  float2 *a, *b;
  int N, cnt;
  __device__ __forceinline__ int at(int e, int c) const {
    return fpad(kCols ? e * cnt + c : c * N + e);
  }
  // the unpadded distance between elements e and e + 1 of a sequence
  __device__ __forceinline__ int step() const { return kCols ? cnt : 1; }
};

// The padded places of `r` elements d apart from the element at unpadded
// place x: where d is a multiple of 32 they are fpad(x) + r (d + d / 16)
// (the pad grows by 2 every 32), else fpad of each.
template <int R>
__device__ __forceinline__ void fpad_run(int x, int d, int (&at)[R]) {
  if ((d & 31) == 0) {
    const int a0 = fpad(x), dp = d + (d >> 4);
#pragma unroll
    for (int r = 0; r < R; ++r) at[r] = a0 + r * dp;
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) at[r] = fpad(x + r * d);
  }
}

// One radix-R Stockham step (self-sorting: natural order in and out) of
// every sequence of the unit, p the product of the radices before it:
// work item i < T = N / R of a sequence takes its elements i + r T, turns
// them by W_(pR)^(r k), k = i mod p (tw: (r - 1) p + k, r-major, so a
// warp's lanes read consecutive entries), and stores the R-point DFT at
// j + s p, j = (i - k) R + k.  Columns put the sequence index in the low
// bits of the item (a warp's lanes on consecutive addresses), rows the
// element.  An item is read, turned and stored at once (out of place:
// nothing is held across a barrier).  The first step (kFirst) reads
// through ld(e, c), the others buffer a; the last (kLast) writes st(e, c,
// v, ax(e, c)) (ax, a device-memory factor, is read before the item's
// butterflies so that its latency overlaps them), the others into buffer
// b.  All threads must call it; it ends with a barrier of the block.
template <int R, bool kInv, bool kFirst, bool kLast, bool kCols,
          typename Ld, typename Ax, typename St>
__device__ __forceinline__ void stock_step(const FftUnit<kCols>& q, int p,
                                           const float2* __restrict__ tw,
                                           Ld ld, Ax ax, St st) {
  const int T = q.N / R, total = q.cnt * T;
  const int lgc = __ffs(q.cnt) - 1, lgT = __ffs(T) - 1;
#pragma unroll 1
  for (int b = threadIdx.x; b < total; b += kThreads) {
    const int c = kCols ? b & (q.cnt - 1) : b >> lgT;
    const int i = kCols ? b >> lgc : b & (T - 1);
    const int k = i & (p - 1), j = (i - k) * R + k;
    float2 v[R], w[R], x[kLast ? R : 1];
    if constexpr (kLast) {
#pragma unroll
      for (int s = 0; s < R; ++s) x[s] = ax(j + s * p, c);
    }
    if (p > 1) {
#pragma unroll
      for (int r = 1; r < R; ++r) w[r] = __ldg(tw + (r - 1) * p + k);
    }
    if constexpr (kFirst) {
#pragma unroll
      for (int r = 0; r < R; ++r) v[r] = ld(i + r * T, c);
    } else {
      int at[R];
      fpad_run<R>(kCols ? i * q.cnt + c : c * q.N + i, T * q.step(), at);
#pragma unroll
      for (int r = 0; r < R; ++r) v[r] = q.a[at[r]];
    }
    if (p > 1) {
#pragma unroll
      for (int r = 1; r < R; ++r)
        v[r] = kInv ? fcmulc(v[r], w[r]) : fcmul(v[r], w[r]);
    }
    dft_small<R, kInv>(v);
    if constexpr (kLast) {
#pragma unroll
      for (int s = 0; s < R; ++s) st(j + s * p, c, v[s], x[s]);
    } else {
      int at[R];
      fpad_run<R>(kCols ? j * q.cnt + c : c * q.N + j, p * q.step(), at);
#pragma unroll
      for (int s = 0; s < R; ++s) q.b[at[s]] = v[s];
    }
  }
  __syncthreads();
}

// The unit's length-N transforms (forward, or inverse unscaled): one step
// of radix 2 or 4 where log2 N is no multiple of 3 (p = 1: no twiddles),
// then radix-8 steps (ops/pde_kernel.py fft_radices), with their twiddles
// from `tw` (stockham_angles' order); the first step reads through ld
// where kLd (else buffer a), the last writes through st (see
// stock_step).  The unit's buffers swap after every step but the last.
template <bool kInv, bool kCols, bool kLd, typename Ld, typename Ax,
          typename St>
__device__ __forceinline__ void fft_unit(FftUnit<kCols>& q,
                                         const float2* __restrict__ tw,
                                         Ld ld, Ax ax, St st) {
  const int lg = __ffs(q.N) - 1, n8 = lg / 3, rem = lg % 3;
  const auto swap = [&]() {
    float2* t = q.a;
    q.a = q.b;
    q.b = t;
  };
  int p = 1;
  if (rem) {  // the first step: p = 1 reads no twiddle
    const bool only = n8 == 0;
    if (rem == 2) {
      if (only) {
        stock_step<4, kInv, kLd, true, kCols>(q, 1, tw, ld, ax, st);
      } else {
        stock_step<4, kInv, kLd, false, kCols>(q, 1, tw, ld, ax, st);
      }
    } else if (only) {
      stock_step<2, kInv, kLd, true, kCols>(q, 1, tw, ld, ax, st);
    } else {
      stock_step<2, kInv, kLd, false, kCols>(q, 1, tw, ld, ax, st);
    }
    if (!only) swap();
    p = 1 << rem;
    tw += p - 1;
  }
  for (int s = 0; s < n8; ++s) {
    const bool first = p == 1, last = s == n8 - 1;
    if (first && last) {
      stock_step<8, kInv, kLd, true, kCols>(q, p, tw, ld, ax, st);
    } else if (first) {
      stock_step<8, kInv, kLd, false, kCols>(q, p, tw, ld, ax, st);
    } else if (last) {
      stock_step<8, kInv, false, true, kCols>(q, p, tw, ld, ax, st);
    } else {
      stock_step<8, kInv, false, false, kCols>(q, p, tw, ld, ax, st);
    }
    if (!last) swap();
    tw += 7 * p;
    p *= 8;
  }
}

// Where a CTA's thread 0 marks the stage (clock64, summed over the steps,
// i the interval ending at the mark): 0 pass 1's first unit landed, 1
// pass 1, 2 its barrier, 3 pass 2's first unit landed, 4 the forward
// transforms, 5 the inverse ones, 6 its barrier, 7 pass 3's first unit
// landed, 8 pass 3, 9 the reduction of m with its barrier; 10 the whole
// step, 11 the steps.  Kept in registers, stored into trace[kMarks (b G +
// rank) + i] once a launch.
constexpr int kMarks = 12;
struct FftTrace {
  unsigned long long* t;  // this CTA's kMarks slots, or null
  long long last;
  long long acc[kMarks];
  __device__ __forceinline__ bool on() const {
    return t != nullptr && threadIdx.x == 0;
  }
  __device__ __forceinline__ void mark(int i) {
    if (!on()) return;
    const long long now = clock64();
    acc[i] += now - last;
    last = now;
  }
};

// A pass's units u = rank, rank + G, ... < nu on this CTA, two deep:
// load(u, dst) issues unit u's copies (cp.async) into one of the landing
// buffers bf[0], bf[1], which land while run(u, buf, partner) works on the
// one before, its steps going back and forth between its landing buffer
// and bf[2].  run must end with a barrier of the block (stock_step's),
// after which its landing buffer takes the next copies.  The first unit's
// landing is marked `landed` (FftTrace).
template <typename Load, typename Run>
__device__ __forceinline__ void fft_pass(const Geo& g, int nu,
                                         float2* const (&bf)[3], Load load,
                                         Run run, FftTrace& tr, int landed) {
  if (g.rank < nu) load(g.rank, bf[0]);
  cp_async_commit();
  int i = 0;
  for (int u = g.rank; u < nu; u += g.C, ++i) {
    if (u + g.C < nu) load(u + g.C, bf[(i + 1) & 1]);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // unit u's copies, every thread's, have landed
    if (i == 0) tr.mark(landed);
    run(u, bf[i & 1], bf[2]);
  }
  cp_async_wait<0>();
}

// The FFT stage's operands (ops/pde_kernel.py fft_plan): the
// transform n = n1 * n2, the row wrapped by `wrap` sites on each side,
// w1 columns (passes 1, 3) and w2 rows (pass 2) a unit of `ub` (padded)
// values; `buf`, three such buffers in shared memory.
struct FftArgs {
  const float2* tw;    // (n) W_n^(n2' k1) at k1 * n2 + n2', then the
                       // Stockham steps' of length n2 and of length n1
  const float* spec;   // (n) the taps' spectrum K[k1 + n1 k2] at k1 n2 + k2
  float2* x;           // (n) this replica's complex scratch
  float2* buf;         // shared: three unit buffers
  int n1, n2, w1, w2, wrap, ub;
};

// The full smoothing by FFT (m_mode kFft, the device-memory route), and
// with it the m pass: with p = srcP sc, q = srcM sc (the step's state),
// z[t] = p - q + i (p + q) of site (t - wrap) mod L for t < L + 2 wrap and
// 0 up to n, and y = z convolved circularly on n with the taps (their real
// spectrum), m of site j is Re y[j + wrap] / (Im y[j + wrap] + 1e-12),
// stored into mS.  The transform runs in four steps, t = n2' + n2 n1' and
// k = k1 + n1 k2:
//   pass 1: each column n2', the length-n1 transform over n1', times
//           W_n^(n2' k1), into x[k1 n2 + n2']; its first step also stores
//           p and q into the rows P1, M1 (the state the rest of the step
//           reads) and p + q into the spectra's row `dens`, once a site;
//   pass 2: each row k1, the length-n2 transform over n2', times the
//           spectrum, the inverse length-n2 transform, times W_n^-(n2' k1);
//   pass 3: each column n2', the inverse length-n1 transform over k1, over
//           n: m of site t - wrap.
// CTA r takes units r, r + G, ... of each pass; a barrier of the replica
// ends passes 1 and 2, the caller's reduction (cta_total) pass 3.
// v[0], v[1]: this thread's sums of m and of p + q over the sites it
// stored.  Every thread must call it.  Not inlined: it takes the 128
// registers a thread has for itself, apart from the step body's (inlined,
// the two spill).
template <class Net>
__device__ __noinline__ void fft_smooth(
    const Geo& g, const Net& net, const FftArgs& f, const float* srcP,
    const float* srcM, float sc, float* P1, float* M1, float* dens,
    float* mS, float (&v)[2], FftTrace& tr) {
  const int L = g.L, n1 = f.n1, n2 = f.n2, w1 = f.w1, w2 = f.w2;
  const int lw1 = __ffs(w1) - 1, wrap = f.wrap;
  const int span = L + 2 * wrap, S1 = n1 * w1;
  // a power-of-two row (no wrap, n = L) copies four sites at once where a
  // unit's columns come four by four
  const bool aligned = wrap == 0 && w1 >= 4;
  const float inv_n = 1.f / (float)(n1 * n2);  // a power of two: exact
  const float2* tw_n2 = f.tw + (size_t)n1 * n2;
  const float2* tw_n1 = tw_n2 + n2 - 1;
  float2* x = f.x;
  float2* const bf[3] = {f.buf, f.buf + f.ub, f.buf + 2 * f.ub};
  const auto nox = [](int, int) { return make_float2(0.f, 0.f); };
  float tot = 0.f, msum = 0.f;

  // pass 1: the box of n1 rows x w1 columns of the fields, as floats
  // (the P row at [0, S1), the M row after it), zeros past the padded row
  fft_pass(
      g, n2 >> lw1, bf,
      [&](int u, float2* dst) {
        float* fp = reinterpret_cast<float*>(dst);
        const int c0 = u << lw1;
        if (aligned) {  // four sites a copy, none past the row
          for (int e = 4 * threadIdx.x; e < S1; e += 4 * kThreads) {
            const int j = (e >> lw1) * n2 + c0 + (e & (w1 - 1));
            cp_async16(fp + e, srcP + j);
            cp_async16(fp + S1 + e, srcM + j);
          }
          return;
        }
        for (int e = threadIdx.x; e < S1; e += kThreads) {
          const int t = (e >> lw1) * n2 + c0 + (e & (w1 - 1));
          int j = t - wrap;
          j = j < 0 ? j + L : (j >= L ? j - L : j);
          const int ok = t < span ? 4 : 0;
          cp_async4(fp + e, srcP + (ok ? j : 0), ok);
          cp_async4(fp + S1 + e, srcM + (ok ? j : 0), ok);
        }
      },
      [&](int u, float2* in, float2* part) {
        const float* fp = reinterpret_cast<const float*>(in);
        const int c0 = u << lw1;
        FftUnit<true> q{in, part, n1, w1};
        fft_unit<false, true, true>(
            q, tw_n1,
            [&](int a, int c) {
              const int e = a * w1 + c;
              const float p = fp[e] * sc, q = fp[S1 + e] * sc;
              const int j = a * n2 + c0 + c - wrap;
              if (j >= 0 && j < L) {
                P1[j] = p;
                M1[j] = q;
                if (dens) __stcs(dens + j, p + q);
                tot += p + q;
              }
              return make_float2(p - q, p + q);
            },
            [&](int a, int c) {
              return __ldg(f.tw + (size_t)a * n2 + c0 + c);
            },
            [&](int a, int c, float2 z, float2 w) {
              x[(size_t)a * n2 + c0 + c] = fcmul(z, w);
            });
      },
      tr, 0);
  tr.mark(1);
  net.sync();
  tr.mark(2);
  // pass 2: w2 rows of x
  fft_pass(
      g, n1 / w2, bf,
      [&](int u, float2* dst) {  // two values a copy: rows are even
        const float2* src = x + (size_t)u * w2 * n2;
        for (int e = 2 * threadIdx.x; e < w2 * n2; e += 2 * kThreads)
          cp_async16(dst + fpad(e), src + e);
      },
      [&](int u, float2* in, float2* part) {
        FftUnit<false> q{in, part, n2, w2};
        const size_t r0 = (size_t)u * w2 * n2;
        fft_unit<false, false, false>(
            q, tw_n2, nox,
            [&](int a, int c) {
              return make_float2(__ldg(f.spec + r0 + c * n2 + a), 0.f);
            },
            [&](int a, int c, float2 z, float2 k) {
              q.b[q.at(a, c)] = make_float2(z.x * k.x, z.y * k.x);
            });
        float2* t = q.a;  // the spectrum's product is in b
        q.a = q.b;
        q.b = t;
        tr.mark(4);
        fft_unit<true, false, false>(
            q, tw_n2, nox,
            [&](int a, int c) { return __ldg(f.tw + r0 + c * n2 + a); },
            [&](int a, int c, float2 z, float2 w) {
              x[r0 + c * n2 + a] = fcmulc(z, w);
            });
        tr.mark(5);
      },
      tr, 3);
  net.sync();
  tr.mark(6);
  // pass 3: the box of n1 rows x w1 columns of x
  fft_pass(
      g, n2 >> lw1, bf,
      [&](int u, float2* dst) {
        const int c0 = u << lw1;
        if (w1 == 1) {  // one column: single values
          for (int e = threadIdx.x; e < S1; e += kThreads)
            cp_async8(dst + fpad(e), x + (size_t)e * n2 + c0);
          return;
        }
        for (int e = 2 * threadIdx.x; e < S1; e += 2 * kThreads)
          cp_async16(dst + fpad(e),
                     x + (size_t)(e >> lw1) * n2 + c0 + (e & (w1 - 1)));
      },
      [&](int u, float2* in, float2* part) {
        const int c0 = u << lw1;
        FftUnit<true> q{in, part, n1, w1};
        fft_unit<true, true, false>(
            q, tw_n1, nox, nox,
            [&](int a, int c, float2 y, float2) {
              const int j = a * n2 + c0 + c - wrap;
              if (j >= 0 && j < L) {
                const float mx = (y.x * inv_n) / (y.y * inv_n + 1e-12f);
                mS[j] = mx;
                msum += mx;
              }
            });
      },
      tr, 7);
  tr.mark(8);
  v[0] = msum;
  v[1] = tot;
}

// An affine map v -> a v + b, in float64; after(l, e) is l o e.
struct Aff {
  double a, b;
};
__device__ __forceinline__ Aff after(Aff l, Aff e) {
  return {l.a * e.a, fma(l.a, e.b, l.b)};
}
__device__ __forceinline__ Aff shfl_up(Aff v, int d) {
  return {__shfl_up_sync(kFull, v.a, d), __shfl_up_sync(kFull, v.b, d)};
}
__device__ __forceinline__ Aff shfl_down(Aff v, int d) {
  return {__shfl_down_sync(kFull, v.a, d), __shfl_down_sync(kFull, v.b, d)};
}
__device__ __forceinline__ Aff shfl_idx(Aff v, int l) {
  return {__shfl_sync(kFull, v.a, l), __shfl_sync(kFull, v.b, l)};
}

// One sweep of the scan solve of field F (this CTA's segment; the tiles it
// takes may lie in other segments on the device-memory route) on this
// thread's half of the block.  Forward: y_i = alpha_i y_{i-1} + inv_i F_i
// from y_{-1} = 0; back (rev): x_i = -c'_i x_{i+1} + F_i from x_L = 0
// (c'_{L-1} = 0).  Tile t = sites [t*32*run, (t+1)*32*run), lane l's run
// its [l*run, (l+1)*run); sites past L are the identity.  `tt` ([kTiles]
// per field) takes the tiles' totals; the caller's barrier must separate
// two uses of it.  Writes the result over F.
template <class Net>
__device__ __forceinline__ void scan_sweep(const Geo& g, const Net& net,
                                           float* F, int run, int ntiles,
                                           int h,
                                           const double* __restrict__ coef,
                                           const double* __restrict__ inv,
                                           bool rev, Aff* tt) {
  const int lane = threadIdx.x & 31, wh = (threadIdx.x & (kHalf - 1)) >> 5;
  const int ntl = ntiles >= g.C ? ntiles / g.C : 1;  // this CTA's tiles
  const Aff id{1.0, 0.0};
  Aff e[2] = {id, id};
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int tl = wh + u * kHalfWarps;
    const int gt = g.rank * ntl + tl;
    if (tl >= ntl || gt >= ntiles) break;
    const int lo = gt * 32 * run + lane * run;
    const int hi = min(g.L, lo + run);
    Aff v = id;
    if (!rev) {
      for (int i = lo; i < hi; ++i) {
        const double al = __ldg(coef + i);
        v = {al * v.a, fma(al, v.b, (double)F[i - g.lo] * __ldg(inv + i))};
      }
    } else {
      for (int i = hi - 1; i >= lo; --i) {
        const double ng = -__ldg(coef + i);
        v = {ng * v.a, fma(ng, v.b, (double)F[i - g.lo])};
      }
    }
    // inclusive scan of the tile in sweep order (rev: lane 31 first)
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const Aff o = rev ? shfl_down(v, d) : shfl_up(v, d);
      if (rev ? lane + d < 32 : lane >= d) v = after(v, o);
    }
    if (lane == (rev ? 0 : 31)) tt[h * kTiles + gt] = v;
    Aff ex = rev ? shfl_down(v, 1) : shfl_up(v, 1);
    if (lane == (rev ? 31 : 0)) ex = id;
    e[u] = ex;
  }
  net.sync();
  // the tiles in sweep order: lane p takes the total of the tile at sweep
  // position p, from the CTA that owns it, and a shuffle scan composes them
  const int p_tile = rev ? ntiles - 1 - lane : lane;
  Aff t = id;
  if (lane < ntiles) t = net.tt_of(tt, p_tile / ntl)[h * kTiles + p_tile];
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Aff o = shfl_up(t, d);
    if (lane >= d) t = after(t, o);
  }
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int tl = wh + u * kHalfWarps;
    const int gt = g.rank * ntl + tl;
    if (tl >= ntl || gt >= ntiles) break;
    const int at = rev ? ntiles - 1 - gt : gt;  // the tile's position
    Aff q = shfl_idx(t, at > 0 ? at - 1 : 0);
    if (at == 0) q = id;
    double y = after(e[u], q).b;  // the value entering the run
    const int lo = gt * 32 * run + lane * run;
    const int hi = min(g.L, lo + run);
    if (!rev) {
      for (int i = lo; i < hi; ++i) {
        y = fma(__ldg(coef + i), y, (double)F[i - g.lo] * __ldg(inv + i));
        F[i - g.lo] = (float)y;
      }
    } else {
      for (int i = hi - 1; i >= lo; --i) {
        y = fma(-__ldg(coef + i), y, (double)F[i - g.lo]);
        F[i - g.lo] = (float)y;
      }
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
  const float* solve_taps;   // (1 + sv.ns*sv.len,) padded taps (banded)
  const float* smooth_taps;  // (1 + sm.ns*sm.len,) padded taps (smoothed m)
  float* dens;               // (B, k, L) total density per step (kmax > 0)
  const int* noise;
  int L, n_t, window, k_steps, kmax, m_mode, solve_mode;
  int C, seg, tseg, run, ntiles;  // the plan: CTAs per replica, ...
  int sm_ns, sm_len, sm_tb, sm_fp, sv_ns, sv_len, sv_tb, sv_fp;
  int wf;                         // staging window floats a field
  int T;                          // sites of a circulant tile
  int periodic, bidirectional;
  float dt, dx, xlim, v_last, fac, w_dt, w_2dt;
  // the device-memory route's device scratch, per replica of the launch:
  float* gfld;     // (B, 2 + local m + smoothed, L): Q, N, m, denominator
  float* gpub;     // (B, 3, C, kPub) published totals of the reductions
  double* gtt;     // (B, 4 * kTiles, 2) the scan's tile totals
  unsigned* gbar;  // (B, kBar) the replica's arrival counter (zeroed)
  // the FFT stage (m_mode kFft): its twiddles, (n + n2 + n1 - 2) [re,
  // im], the taps' spectrum (n), the complex scratch (B, n); ops/
  // pde_kernel.py FftPlan: n = n1 * n2, w1, w2, wrap, and a unit's values;
  // its marks (FftTrace), (B, G, kMarks), or null
  const float2* fft_tw;
  const float* fft_spec;
  float2* gfft;
  unsigned long long* fft_trace;
  int fft_n1, fft_n2, fft_w1, fft_w2, fft_wrap, fft_buf;
};

// A CTA's scratch on chip, whichever the route: the reductions' warp
// totals, the tracers' displacements, the staging windows and partial
// sums; and where its published totals and scan tile totals live.
struct Scratch {
  float *redA, *redB, *redD, *pubA, *pubB, *pubD, *DR, *win, *part;
  Aff* tt;
  float2* fbuf = nullptr;  // the FFT stage's three unit buffers (kFft)
};

__device__ __forceinline__ Geo geo_of(const Args& a, int C, int rank) {
  Geo g;
  g.C = C;
  g.rank = rank;
  g.L = a.L;
  g.seg = a.seg;
  g.shift = __ffs(a.seg) - 1;
  g.lo = rank * a.seg;
  g.nloc = max(0, min(a.L - g.lo, a.seg));
  g.tseg = a.tseg;
  g.t0 = rank * a.tseg;
  g.tloc = max(0, min(a.n_t - g.t0, a.tseg));
  return g;
}

// Replica b's k steps on this CTA; P, M, Q, N (and mS, dS where used) are
// this CTA's segments of the four fields (state P, M; scratch Q, N, which
// swap roles from step to step), of m and of the smoothed denominator.
// kFft: the full smoothing by the FFT stage (m_mode kFft, a kernel of its
// own, so that the other modes' kernels compile as they would without it).
template <class Net, bool kFft = false>
__device__ __forceinline__ void b2_steps(const Args& a, const Geo& g,
                                         const Net& net, int b, float* P,
                                         float* M, float* Q, float* N,
                                         float* mS, float* dS,
                                         const Scratch& sc_) {
  constexpr int U = Net::kUnroll;
  const int tid = threadIdx.x;
  const int rank = g.rank;
  const int L = a.L, n_t = a.n_t, kmax = a.kmax;
  const bool local_m = a.m_mode != kGlobal;
  const bool taps = a.m_mode == kTaps;
  float* DR = sc_.DR;
  const Circ smc{a.smooth_taps, a.sm_ns, a.sm_len, a.sm_tb, a.sm_fp};
  const Circ svc{a.solve_taps, a.sv_ns, a.sv_len, a.sv_tb, a.sv_fp};
  const float beta = a.scal[4 * b], lam = a.scal[4 * b + 1];
  const float noise_amp = sqrtf(__fmul_rn(2.f * a.scal[4 * b + 2], a.dt));
  const float inv_L = 1.f / (float)L;
  const float inv_nt = 1.f / (float)(n_t > 1 ? n_t : 1);
  const float dt = a.dt, dx = a.dx;
  const size_t foff = (size_t)b * L + g.lo, toff = (size_t)b * n_t;
  const int rw = 4 + 2 * kmax;
  const uint2 key = make_uint2((uint32_t)a.seeds[b], (uint32_t)(a.b0 + b));

  const float* hin = a.hist_in + (size_t)b * a.window * n_t;
  float* hist = a.hist_out + (size_t)b * a.window * n_t;
  for (int j = g.t0 + tid; j < g.t0 + g.tloc; j += kThreads) {
    a.pos_out[toff + j] = a.pos_in[toff + j];
    a.spin_out[toff + j] = a.spin_in[toff + j];
    for (int w = 0; w < a.window; ++w) hist[w * n_t + j] = hin[w * n_t + j];
  }
  // every CTA of the replica runs before any remote read
  net.sync();

  // the state the next step reads is (srcP, srcM) times the last step's
  // renormalisation `sc`; the step's first pass stores it into (P, M)
  const float* srcP = a.rp_in + foff;
  const float* srcM = a.rm_in + foff;
  float sc = 1.f;
  // the device-memory route's prefetches of a pass's fields
  const auto pf = [](const float* p) {
    if constexpr (Net::kGlobalMem) prefetch_l1(p);
  };
  FftTrace tr{nullptr, 0, {}};
  if constexpr (kFft) {
    if (a.fft_trace) tr.t = a.fft_trace + kMarks * ((size_t)b * g.C + rank);
  }
  for (int s = 0; s < a.k_steps; ++s) {
    const long long t_step = kFft ? clock64() : 0;
    const int n = a.step0 + s;
    float* row = a.recs + ((size_t)b * a.k_steps + s) * rw;
    float* drow = a.dens ? a.dens + ((size_t)b * a.k_steps + s) * L + g.lo
                         : nullptr;

    // -- magnetization of the pre-step densities --------------------------
    float vA[2];
    if constexpr (kFft) {  // m and the state from the FFT stage
      const FftArgs fa{a.fft_tw, a.fft_spec,
                       a.gfft + (size_t)b * a.fft_n1 * a.fft_n2, sc_.fbuf,
                       a.fft_n1, a.fft_n2, a.fft_w1, a.fft_w2, a.fft_wrap,
                       fft_unit_values(a.fft_buf)};
      tr.last = clock64();
      fft_smooth(g, net, fa, srcP - g.lo, srcM - g.lo, sc, Q - g.lo,
                 N - g.lo, drow ? drow - g.lo : nullptr, mS - g.lo, vA, tr);
      warp_tree(vA);
      // the state is in (Q, N) now, and (P, M) the scratch: pass 1 read
      // srcP and srcM across the replica, so none could be stored over
      float* t = P;
      P = Q;
      Q = t;
      t = M;
      M = N;
      N = t;
    } else if (taps) {  // the smoothed numerator and denominator
      for (int x0 = tid; x0 < g.nloc; x0 += 4 * kThreads) {
        float p[4], q[4];  // four sites' loads before their stores
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int x = x0 + j * kThreads;
          p[j] = x < g.nloc ? srcP[x] * sc : 0.f;
          q[j] = x < g.nloc ? srcM[x] * sc : 0.f;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int x = x0 + j * kThreads;
          if (x >= g.nloc) break;
          P[x] = p[j];
          M[x] = q[j];
          Q[x] = p[j] - q[j];
          N[x] = p[j] + q[j];
          if (drow) __stcs(drow + x, p[j] + q[j]);
        }
      }
      net.sync();
      circulant<Net>(g, Q, N, smc, a.T, sc_.win, a.wf, sc_.part,
                     [&](int f, int x, float o) {
                       (f == 0 ? mS : dS)[x] = o;
                     });
      warp_sums<2, U, Net::kGlobalMem>(
          a.seg, g.nloc, vA,
          [&](int x, float (&v)[2]) {
            const float mx = mS[x] / (dS[x] + 1e-12f);
            mS[x] = mx;
            v[0] = mx;
            v[1] = P[x] + M[x];
          },
          [&](int x) {
            pf(mS + x);
            pf(dS + x);
          });
    } else {
      warp_sums<2, U, Net::kGlobalMem>(
          a.seg, g.nloc, vA,
          [&](int x, float (&v)[2]) {
            const float p = srcP[x] * sc, q = srcM[x] * sc;
            P[x] = p;
            M[x] = q;
            if (drow) __stcs(drow + x, p + q);
            if (a.m_mode == kGlobal) {
              v[0] = p - q;
            } else {
              const float mx = (p - q) / (p + q + 1e-12f);
              mS[x] = mx;
              v[0] = mx;
            }
            v[1] = p + q;
          },
          [&](int x) {
            pf(srcP + x);
            pf(srcM + x);
          });
    }
    cta_total<2>(g, net, vA, sc_.redA, sc_.pubA);  // also publishes mS
    if constexpr (kFft) tr.mark(9);
    const float m_glob = vA[0] / (vA[1] + 1e-12f);
    const float m_mean = local_m ? vA[0] * inv_L : m_glob;
    const float t_mean = vA[1] * inv_L;

    // -- tracers: CW flip, Euler-Maruyama, displacement ring --------------
    const int* nz =
        a.noise ? a.noise + (size_t)(b * a.k_steps + s) * 3 * n_t : nullptr;
    const int slot = n % a.window;
    float vB[2], vT[1];
    warp_sums<1, 1, true>(a.tseg, g.tloc, vT,
                          [&](int jl, float (&v)[1]) {
      const int j = g.t0 + jl;
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
        m_tr = site<Net>(g, mS, ((int)(pw / dx)) % L);
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
      DR[jl] = pos - old;
      v[0] = pos - old;
    });
    float vS[1];
    warp_sums<1, U, Net::kGlobalMem>(a.seg, g.nloc, vS,
                                     [&](int x, float (&v)[1]) {
      const float d = P[x] + M[x] - t_mean;
      v[0] = d * d;
    });
    vB[0] = vS[0];
    vB[1] = vT[0];
    cta_total<2>(g, net, vB, sc_.redB, sc_.pubB);
    const float var = vB[0] * inv_L;
    const float mean_dr = vB[1] * inv_nt;

    // -- implicit diffusion: (P1, M1) are the solved fields ---------------
    float *P1 = P, *M1 = M, *P2 = Q, *M2 = N;
    // the periodic exact solve's corner correction: P1[x] - cP z[x]
    float cP = 0.f, cM = 0.f;
    const double* zz = nullptr;
    if (a.solve_mode == kExact) {  // in place: two scan sweeps per field
      const int h = tid / kHalf;
      float* F = h == 0 ? P : M;
      const double* gs = a.scan;
      scan_sweep(g, net, F, a.run, a.ntiles, h, gs + 2 * L, gs, false,
                 sc_.tt);
      scan_sweep(g, net, F, a.run, a.ntiles, h, gs + L, nullptr, true,
                 sc_.tt + 2 * kTiles);
      net.sync();  // the solved fields, for the corners and the edges
      if (a.periodic) {  // Sherman-Morrison: x - c z, applied where read
        cP = a.fac * (site<Net>(g, P, 0) + a.v_last * site<Net>(g, P, L - 1));
        cM = a.fac * (site<Net>(g, M, 0) + a.v_last * site<Net>(g, M, L - 1));
        zz = gs + 3 * L;
      }
    } else if (a.solve_mode == kBanded) {
      circulant<Net>(g, P, M, svc, a.T, sc_.win, a.wf, sc_.part,
                     [&](int f, int x, float o) { (f == 0 ? Q : N)[x] = o; });
      net.sync();  // the solved fields, for the edges
      P1 = Q; M1 = N; P2 = P; M2 = M;
    }

    // -- upwind advection + CW reaction + clip, then mass renorm ----------
    const float cwm_g = cw(beta, -1.f, m_glob), cwp_g = cw(beta, 1.f, m_glob);
    const bool walls = !a.periodic;
    float vD[3];
    // the new state, and the two buffers that become the scratch
    float *P_new, *M_new, *Q_new, *N_new;
    if (a.bidirectional) {
      float v01[2];
      warp_sums<2, U, Net::kGlobalMem>(a.seg, g.nloc, v01,
                                       [&](int x, float (&v)[2]) {
        const int xg = g.lo + x;
        const int xl = xg == 0 ? L - 1 : xg - 1;
        const int xr = xg == L - 1 ? 0 : xg + 1;
        float p1 = P1[x], m1 = M1[x];
        float pl = x > 0 ? P1[x - 1] : site<Net>(g, P1, xl);
        float mr = x + 1 < g.nloc ? M1[x + 1] : site<Net>(g, M1, xr);
        if (zz) {
          const float z = (float)__ldg(zz + xg);
          p1 -= cP * z;
          m1 -= cM * z;
          pl -= cP * (float)__ldg(zz + xl);
          mr -= cM * (float)__ldg(zz + xr);
        }
        float dp = (p1 - pl) / dx;
        float dm = (mr - m1) / dx;
        if (walls && xg == 0) dp = 0.f;
        if (walls && xg == L - 1) dm = 0.f;
        const float mx = local_m ? mS[x] : m_glob;
        const float cwm = local_m ? cw(beta, -1.f, mx) : cwm_g;
        const float cwp = local_m ? cw(beta, 1.f, mx) : cwp_g;
        const float R_p = cwm * m1 - cwp * p1;
        const float p2 = fmaxf(p1 + dt * (-lam * dp + R_p), 0.f);
        const float m2 = fmaxf(m1 + dt * (lam * dm - R_p), 0.f);
        P2[x] = p2;
        M2[x] = m2;
        v[0] = p1 + m1;
        v[1] = p2 + m2;
      }, [&](int x) {
        pf(P1 + x);
        pf(M1 + x);
        if (local_m) pf(mS + x);
      });
      vD[0] = v01[0];
      vD[1] = v01[1];
      P_new = P2; M_new = M2; Q_new = P1; N_new = M1;
    } else {  // anchored_minus: reaction first, then rho_+* is advected
      float v0[1], v1[1];
      warp_sums<1, U, Net::kGlobalMem>(a.seg, g.nloc, v0,
                                       [&](int x, float (&v)[1]) {
        float p1 = P1[x], m1 = M1[x];
        if (zz) {
          const float z = (float)__ldg(zz + g.lo + x);
          p1 -= cP * z;
          m1 -= cM * z;
        }
        const float mx = local_m ? mS[x] : m_glob;
        const float cwm = local_m ? cw(beta, -1.f, mx) : cwm_g;
        const float cwp = local_m ? cw(beta, 1.f, mx) : cwp_g;
        const float R_p = cwm * m1 - cwp * p1;
        P2[x] = fmaxf(p1 + dt * R_p, 0.f);
        M2[x] = fmaxf(m1 - dt * R_p, 0.f);
        v[0] = p1 + m1;
      }, [&](int x) {
        pf(P1 + x);
        pf(M1 + x);
        if (local_m) pf(mS + x);
      });
      net.sync();  // rho_+* is read across threads and CTAs below
      warp_sums<1, U, Net::kGlobalMem>(a.seg, g.nloc, v1,
                                       [&](int x, float (&v)[1]) {
        const int xg = g.lo + x;
        const float ps = P2[x];
        const float pl =
            x > 0 ? P2[x - 1] : site<Net>(g, P2, xg == 0 ? L - 1 : xg - 1);
        float dp = (ps - pl) / dx;
        if (walls && xg == 0) dp = 0.f;
        const float p2 = fmaxf(ps + dt * (-lam * dp), 0.f);
        P1[x] = p2;
        v[0] = p2 + M2[x];
      }, [&](int x) {
        pf(P2 + x);
        pf(M2 + x);
      });
      vD[0] = v0[0];
      vD[1] = v1[0];
      P_new = P1; M_new = M2; Q_new = P2; N_new = M1;
    }
    float vV[1];
    warp_sums<1, 1, true>(a.tseg, g.tloc, vV,
                          [&](int jl, float (&v)[1]) {
      const float d = DR[jl] - mean_dr;
      v[0] = d * d;
    });
    vD[2] = vV[0];
    cta_total<3>(g, net, vD, sc_.redD, sc_.pubD);
    sc = vD[0] / fmaxf(vD[1], 1e-30f);  // applied where the state is read
    P = P_new; M = M_new; Q = Q_new; N = N_new;
    srcP = P;
    srcM = M;

    if (rank == 0 && tid == 0) {
      const bool valid = n >= a.window;
      const float var_dr = vD[2] * inv_nt;
      row[0] = m_mean;
      row[1] = var;
      row[2] = valid ? mean_dr / a.w_dt : NAN;
      row[3] = valid ? var_dr / a.w_2dt : NAN;
    }
    // the next step reads P and M across threads
    __syncthreads();
    if constexpr (kFft) {
      if (tr.on()) {
        tr.acc[10] += clock64() - t_step;
        tr.acc[11] += 1;
      }
    }
  }

#pragma unroll 4
  for (int x = tid; x < g.nloc; x += kThreads) {
    a.rp_out[foff + x] = srcP[x] * sc;
    a.rm_out[foff + x] = srcM[x] * sc;
  }
  if constexpr (kFft) {
    if (tr.on()) {
      for (int i = 0; i < kMarks; ++i) tr.t[i] = (unsigned long long)tr.acc[i];
    }
  }
  // no CTA leaves while another may still read its shared memory
  if constexpr (!Net::kGlobalMem) net.sync();
}

// Shared memory of a cluster-route CTA, in this order (ops/pde_kernel.py
// cta_smem_bytes): the scan's tile totals (2 sweeps x 2 fields x kTiles
// double-word maps, first, so they are 16-byte aligned), the reductions'
// warp totals (7 x kWarps) and published totals (8), the fields P, M, Q, N
// (seg each), m and the smoothed denominator (seg each, where used), the
// tracers' displacements (tseg), the staging windows (fp * wf) and the
// partial sums.
__global__ void __launch_bounds__(kThreads) pde_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = a.C;
  const int rank = C > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const int b = blockIdx.x / C;
  const bool local_m = a.m_mode != kGlobal, taps = a.m_mode == kTaps;
  const Geo g = geo_of(a, C, rank);

  Scratch s;
  s.tt = reinterpret_cast<Aff*>(smem);  // [2][2][kTiles]
  s.redA = reinterpret_cast<float*>(s.tt + 4 * kTiles);  // kWarps * 2
  s.redB = s.redA + kWarps * 2;                          // kWarps * 2
  s.redD = s.redB + kWarps * 2;                          // kWarps * 3
  s.pubA = s.redD + kWarps * 3;                          // 2
  s.pubB = s.pubA + 2;                                   // 3
  s.pubD = s.pubB + 3;                                   // 3
  float* P = s.pubD + 3;
  float* M = P + a.seg;
  float* Q = M + a.seg;
  float* N = Q + a.seg;
  float* mS = N + a.seg;                      // seg when local_m
  float* dS = mS + (local_m ? a.seg : 0);     // seg when taps
  s.DR = dS + (taps ? a.seg : 0);             // tseg
  s.win = s.DR + a.tseg;                      // fp * wf
  s.part = s.win + max(a.sm_fp, a.sv_fp) * a.wf;
  b2_steps(a, g, ClusterNet{C}, b, P, M, Q, N, mS, dS, s);
}

// Shared memory of a device-memory-route CTA (ops/pde_kernel.py
// gmem_smem_bytes): the reductions' warp totals (7 x kWarps) and the
// tracers' displacements (tseg), then the staging windows (fp * wf) and
// the partial sums; where kFft, from the next 16-byte boundary, the FFT
// stage's three unit buffers, which the banded solve's windows and partial
// sums share (the solve runs after the smoothing).  The fields are rows of
// rp_out, rm_out (the state) and gfld.
template <bool kFft>
__device__ __forceinline__ void gmem_steps(const Args& a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = a.C;
  const int b = blockIdx.x / G, rank = blockIdx.x % G;
  const bool local_m = a.m_mode != kGlobal;
  const bool taps = a.m_mode == kTaps;
  const Geo g = geo_of(a, G, rank);

  Scratch s;
  s.redA = reinterpret_cast<float*>(smem);
  s.redB = s.redA + kWarps * 2;
  s.redD = s.redB + kWarps * 2;
  s.DR = s.redD + kWarps * 3;
  s.win = s.DR + a.tseg;
  if constexpr (kFft) {
    s.fbuf = reinterpret_cast<float2*>(
        smem + ((4 * (7 * kWarps + a.tseg) + 15) & ~15));
    s.win = reinterpret_cast<float*>(s.fbuf);
  }
  s.part = s.win + max(a.sm_fp, a.sv_fp) * a.wf;
  float* pub = a.gpub + (size_t)b * 3 * G * kPub;
  s.pubA = pub;
  s.pubB = pub + G * kPub;
  s.pubD = pub + 2 * G * kPub;
  s.tt = reinterpret_cast<Aff*>(a.gtt) + (size_t)b * 4 * kTiles;
  const size_t L = (size_t)a.L;
  const size_t nfs = 2 + (local_m ? 1 : 0) + (taps ? 1 : 0);
  float* fb = a.gfld + (size_t)b * nfs * L + g.lo;
  float* mS = fb + 2 * L;
  float* dS = mS + (local_m ? L : 0);
  b2_steps<GmemNet, kFft>(
      a, g, GmemNet{G, a.gbar + (size_t)b * kBar}, b,
      a.rp_out + (size_t)b * L + g.lo, a.rm_out + (size_t)b * L + g.lo, fb,
      fb + L, mS, dS, s);
}

__global__ void __launch_bounds__(kThreads) pde_gmem_kernel(Args a) {
  gmem_steps<false>(a);
}

// The device-memory route with the full smoothing's FFT stage.  Its CTAs
// are pde_gmem_kernel's (512 threads, at most 128 registers each: one an
// SM, so no second CTA an SM whatever the shared memory), so that
// kernel's occupancy query serves both.
__global__ void __launch_bounds__(kThreads) pde_gmem_fft_kernel(Args a) {
  gmem_steps<true>(a);
}

cudaError_t configure(int route, bool fft, int C, size_t smem, int B,
                      void* stream, cudaLaunchConfig_t& cfg,
                      cudaLaunchAttribute& attr) {
  const void* fn = route == 0 ? (const void*)pde_kernel
                   : fft      ? (const void*)pde_gmem_fft_kernel
                              : (const void*)pde_gmem_kernel;
  const int top = route == 0 ? kMaxCluster : kMaxCtas;
  if (C < 1 || C > top || (C & (C - 1))) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  if (route == 0 && C > 8) {
    e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
  }
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(B * C);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  if (route == 0) {
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = C;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
  } else {  // every CTA resident at once, or the launch fails
    attr.id = cudaLaunchAttributeCooperative;
    attr.val.cooperative = 1;
  }
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

}  // namespace

// How many clusters of C CTAs with `smem` bytes each the card holds at
// once.
extern "C" int pde_max_active_clusters(int C, int smem, int* out) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e =
      configure(0, false, C, (size_t)smem, 1, nullptr, cfg, attr);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveClusters(out, pde_kernel, &cfg);
}

// How many CTAs of the device-memory route with `smem` bytes each the card
// holds at once (CTAs an SM holds times the SMs).
extern "C" int pde_gmem_max_ctas(int smem, int* out) {
  cudaError_t e = cudaFuncSetAttribute(
      pde_gmem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0, dev = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pde_gmem_kernel,
                                                    kThreads, (size_t)smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  *out = per_sm * sms;
  return 0;
}

extern "C" int pde_multi_step_launch(
    const float* scal, const int* seeds, int step0, int b0,
    const float* rp_in, const float* rm_in, const float* pos_in,
    const float* spin_in, const float* hist_in, float* rp_out,
    float* rm_out, float* pos_out, float* spin_out, float* hist_out,
    float* recs, const double* scan, const float* solve_taps,
    const float* smooth_taps, float* dens, const int* noise, float* gfld,
    float* gpub, double* gtt, unsigned* gbar, const float* fft_tw,
    const float* fft_spec, float* gfft, unsigned long long* fft_trace,
    int B, int L,
    int n_t, int window, int k_steps, int kmax, int m_mode, int solve_mode,
    int route, int C, int seg, int tseg, int run, int ntiles, int sm_ns,
    int sm_len, int sm_tb, int sm_fp, int sv_ns, int sv_len, int sv_tb,
    int sv_fp, int wf, int T, int smem, int fft_n1, int fft_n2, int fft_w1,
    int fft_w2, int fft_wrap, int fft_buf, int periodic, int bidirectional,
    float dt, float dx, float xlim, float v_last, float fac, float w_dt,
    float w_2dt, void* stream) {
  // what the kernels' indexing assumes (ops/pde_kernel.py pde_launch_plan,
  // gmem_launch_plan)
  if (seg < 32 || (seg & (seg - 1)) || tseg < 1 || (tseg & (tseg - 1)) ||
      (size_t)seg * C < (size_t)L || (size_t)tseg * C < (size_t)n_t ||
      ntiles < 1 || ntiles > kTiles || (ntiles >= C && ntiles % C) ||
      (size_t)ntiles * 32 * run < (size_t)L || T < 1 ||
      sm_tb < 1 || sv_tb < 1 || sm_tb % kBlock || sv_tb % kBlock ||
      sm_fp < 1 || sm_fp > 2 || sv_fp < 1 || sv_fp > 2)
    return (int)cudaErrorInvalidValue;
  if (route == 0 && ((C - 1) * seg >= L || ntiles < C || T != seg ||
                     seg > 16384))
    return (int)cudaErrorInvalidValue;
  if (route == 1 && (seg > kMaxSeg || !gfld || !gpub || !gtt || !gbar))
    return (int)cudaErrorInvalidValue;
  if (route != 0 && route != 1) return (int)cudaErrorInvalidValue;
  const auto pow2 = [](int v) { return v >= 1 && (v & (v - 1)) == 0; };
  if (m_mode < kGlobal || m_mode > kFft) return (int)cudaErrorInvalidValue;
  // the FFT stage: a unit holds at most kFftMaxSub values, its three
  // buffers fit the CTA's shared memory
  if (m_mode == kFft &&
      (route != 1 || !fft_tw || !fft_spec || !gfft || !pow2(fft_n1) ||
       !pow2(fft_n2) || fft_n1 < 2 || fft_n1 > fft_n2 ||
       fft_n2 > kFftMaxSub || !pow2(fft_w1) || !pow2(fft_w2) ||
       fft_w1 > fft_n2 || fft_w2 > fft_n1 || fft_n1 * fft_w1 > fft_buf ||
       fft_n2 * fft_w2 > fft_buf || fft_buf > kFftMaxSub ||
       ((4 * (7 * kWarps + tseg) + 15) & ~15) +
               24 * fft_unit_values(fft_buf) > smem ||
       fft_wrap < 0 || 2 * fft_wrap > L ||
       (size_t)fft_n1 * fft_n2 < (size_t)L + 2 * fft_wrap))
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const bool fft = m_mode == kFft;
  cudaError_t e =
      configure(route, fft, C, (size_t)smem, B, stream, cfg, attr);
  if (e != cudaSuccess) return (int)e;
  const Args a{scal,       seeds,     step0,     b0,          rp_in,
               rm_in,      pos_in,    spin_in,   hist_in,     rp_out,
               rm_out,     pos_out,   spin_out,  hist_out,    recs,
               scan,       solve_taps, smooth_taps, dens,     noise,
               L,          n_t,       window,    k_steps,     kmax,
               m_mode,     solve_mode, C,        seg,         tseg,
               run,        ntiles,    sm_ns,     sm_len,      sm_tb,
               sm_fp,      sv_ns,     sv_len,    sv_tb,       sv_fp,
               wf,         T,         periodic,  bidirectional, dt,
               dx,         xlim,      v_last,    fac,         w_dt,
               w_2dt,      gfld,      gpub,      gtt,         gbar,
               reinterpret_cast<const float2*>(fft_tw), fft_spec,
               reinterpret_cast<float2*>(gfft), fft_trace, fft_n1, fft_n2,
               fft_w1,     fft_w2,    fft_wrap,  fft_buf};
  e = route == 0 ? cudaLaunchKernelEx(&cfg, pde_kernel, a)
      : fft      ? cudaLaunchKernelEx(&cfg, pde_gmem_fft_kernel, a)
                 : cudaLaunchKernelEx(&cfg, pde_gmem_kernel, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

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
// incomers), and with local m each site reads a band of W sites.  So a
// step is a chain of phases with a barrier between each.  Per slot-step the
// work is a few float compares, one expf and one Philox call per particle,
// and at most 4K^2 integer compares per site for admission; the bytes are
// the replica's slots, read and written once per call.  Neither bytes nor
// the issue rate bound the narrow-band and global-m steps, but latency:
// each phase is a chain of dependent shared-memory loads per site (the
// band's taps in P2, the candidates in P3, the incomers in P4), so a phase
// over a CTA's sites takes its longest chain times its passes.  One block
// per replica took 6.2 us per step at L=1000 (B=33 used 33 of 132 SMs),
// 2.7 us at L=250 and 30.6 us at L=4000; PERF.md section 5 has where the
// redesigned step's time goes.
//
// A wide or dense band (W of several hundred to L taps: the sigma sweep's
// sigma=0.1 and 0.3, the phase diagram's sigma >= ~0.1 on the torus) is
// bound by the issue rate instead: each row is W dependent rounded
// multiply-adds on two sums, 4 FP32 instructions a tap that the law keeps
// (no FMA, no reordering), so B*L*W*4/32 warp instructions a step over the
// card's 4 schedulers per SM.  What held it back was the band's read:
// rows outside the interior read their W weights one row per thread from
// device memory (32 cache lines per warp load), and the halo that carried
// the band's inputs (reach + 2 >= L/2) kept such a band on one CTA, one SM
// per replica.  The design below reads every weight from shared memory or
// coalesced, and spreads such a replica over a cluster by exchanging the
// counts instead of the slots.
//
// Design:
//   - a thread-block cluster of C <= 8 CTAs per replica; CTA r owns the
//     segment [r*L/C, (r+1)*L/C) and keeps it, with a halo of h sites on
//     each side (none past a wall; C = 1 has none and wraps in itself), in
//     shared memory for all k steps.  Each CTA computes the phases on the
//     sites that its segment's new slots depend on: events and priorities
//     (P2) on the segment +-2, admission (P3) on the segment +-1, the pack
//     (P4) on the segment; these read the pre-step slots on the segment
//     +-h, h = max(3, band reach + 2) (ops/exclusion_kernel.halo_width).
//     The recomputed halo phases equal the neighbour's own bit for bit: the
//     bits are read, or drawn, by site.
//   - one handoff per step: the P4 thread of each of a segment's first and
//     last h sites pushes its K new slots, each tagged with the step in one
//     64-bit word, into the neighbour's halo mailbox in distributed shared
//     memory (double-buffered by step parity); after its own P4 each CTA
//     polls its mailbox until the words carry the step's tag.  No
//     barrier.cluster per step (kernel B1 measured that round trip as most
//     of its step): a word cannot show a value without its tag.
//   - global m: N is conserved in a call (no exits) and counted once; each
//     warp pushes the sum of its sites' signed counts, tagged, to every CTA
//     of the cluster, and every warp polls and sums them (kernel B1's
//     exchange).
//   - draws only for particles: in P2 a warp compacts the occupied slots of
//     its 32 sites (ballot-free: a shuffle prefix of per-site counts and a
//     byte queue in shared memory), so each lane runs Philox, expf and the
//     thresholds for one particle rather than for one slot row of its site.
//   - three block barriers per step, over the CTA's ~seg/32 warps.  K is a
//     template parameter (1..8), so the candidate loops unroll.
//   - the band (local m): each row's taps read the count array (cnt, occ
//     as float2, continued periodically past its ends by band_pad entries)
//     at consecutive entries from the row's first input, stepping back W
//     entries where its rotation krot wraps, with no branch per tap (a
//     branch per tap kept each tap's loads from overlapping the last's:
//     one load latency a tap); the weights come from the rotation vector
//     utaps, held twice over in shared memory, where every row of the warp
//     rotates it (a periodic band, dense or not; a reflect band's
//     interior), else from the transposed table in device memory, four
//     taps interleaved, (W/4, L, 4): lane x reads the 16 bytes of taps
//     4q..4q+3 of its row, a warp 512 contiguous bytes.  Every replica
//     reads the table from L2 each step, so these rows are bound by L2's
//     rate, not by the FP32 issue.  (One tap a load in a (W, L) table
//     streamed at ~1.75 TB/s whatever C.)
//     A row of no rotation reads its index table
//     (ops/exclusion_kernel.kernel_rotation).
//   - a band whose halo does not fit a cluster (exchange): the segments
//     keep a halo of 3 sites of slots, which the local phases need, and
//     every CTA keeps the whole lattice's count field, which only m reads:
//     after its P4 each CTA pushes its segment's (cnt, occ), tagged with
//     the step, into the field mailbox of every CTA of the cluster
//     (double-buffered by step parity), and at the end of the step polls
//     its own mailbox for the whole field.  So a dense band runs on C CTAs
//     of C SMs, and the plan's C equals C = 1 bit for bit.
//   - no tensor cores and no TMA: the smoothing sums must run in ascending
//     input order with one rounded multiply and one rounded add per tap (the
//     plain version's bit equality), which a tensor-core product reorders;
//     and the slots are read and written once per call, so no bytes are
//     worth an asynchronous pipeline.
//   - the launch plan (C, h, exchange, threads) is chosen in Python
//     (ops/exclusion_kernel.exclusion_launch_plan) from the co-resident
//     cluster count that exclusion_max_active_clusters reports.
//
// Arithmetic that must equal the plain version's bit for bit is written
// with __fmul_rn/__fadd_rn/__fdiv_rn (never contracted into an FMA), in
// the plain version's order; the smoothing sums run in the band row's
// (ascending input) order.  A tap of weight 0 adds +-0 to a sum that is
// never -0, so it may read any site: a wall's row reads a pad of the count
// array for its taps past the wall.  expf is the card's, as torch.exp's on
// the card.
//
// Random bits: injected (noise, (B, k, 2, K, L) uint32 held in int32;
// draw 0 = event, 1 = priority) or native Philox4x32-10 with key
// (seed[b], b0 + b), b0 the global index of the launch's first replica,
// and counter (k*L + x, step0 + s, 0, 0), words 0 and 1.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxCluster = 8;
constexpr size_t kHalfSm = 116 * 1024;   // more than half an SM's 228 KB
constexpr uint32_t kSent = 0x7FFFFFFFu;
constexpr uint32_t kNoTag = 0xFFFFFFFFu;
constexpr int8_t kNone = 0, kLeft = 1, kRight = 2, kFlip = 3;
constexpr unsigned kFull = 0xffffffffu;
// tagged Σσ partials of global m: [step parity][rank * warps + warp]
constexpr int kSlotWords = 2 * kMaxCluster * 32;
// polls of a tagged word before a lost handoff traps (a fault the wrapper
// reports) instead of spinning on the card: seconds, far past any step
constexpr unsigned kMaxPolls = 1u << 26;

struct Params {
  const float* scal;
  const int* seeds;
  int step0;
  int b0;
  const int* slots_in;
  int* slots_out;
  const int* noise;
  const int* band_idx;
  const float* band_w;
  const float* band_wt;
  const float* band_utaps;
  const int* band_krot;
  const int* band_on;
  int W, radius, L, k_steps;
  float dt;
  int periodic, bidirectional, cluster, halo, exchange;
};

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// Sites of the largest CTA window: the whole lattice at C = 1, else the
// longest segment and two halos.
__host__ __device__ inline int window_cap(int L, int C, int h) {
  return C == 1 ? L : cdiv(L, C) + 2 * h;
}

// Entries kept past each end of a count array for a band of W taps.
__host__ __device__ inline int band_pad(int W) { return W ? W / 2 + 4 : 0; }

// Dynamic shared memory of one CTA (ops/exclusion_kernel.cta_smem_bytes):
// the halo mailboxes, global m's tagged partials, with `exchange` the count
// field's mailbox and the field, the window's (cnt, occ) (padded where the
// band reads it), two (K, window) slot buffers, the admission masks, (K,
// window) priorities and events, the band's rotation vector twice over and
// a K-byte draw queue per thread.
__host__ __device__ inline size_t smem_bytes(int K, int L, int W, int C,
                                             int h, int threads,
                                             bool global_m, bool exchange) {
  const size_t win = (size_t)window_cap(L, C, h);
  const size_t P = (size_t)band_pad(W);
  return (C == 1 ? 0 : (size_t)32 * K * h) +
         (global_m ? (size_t)8 * kSlotWords : 0) +
         (exchange ? 24 * (size_t)L + 16 * P : 16 * P) +
         (size_t)(13 * K + 12) * win + 8 * (size_t)W + (size_t)K * threads;
}

// f[j] and, where j lies within `P` of an end, its copy past the other end
// (the array continued periodically: f[j - n] = f[j + n] = f[j]).
__device__ __forceinline__ void put_count(float2* f, int n, int P, int j,
                                          float2 v) {
  f[j] = v;
  if (j >= n - P) f[j - n] = v;
  if (j < P) f[j + n] = v;
}

__device__ __forceinline__ int warp_sum(int v) {
  return __reduce_add_sync(kFull, v);
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ uint64_t tagged(uint32_t tag, int v) {
  return ((uint64_t)tag << 32) | (uint32_t)v;
}

// Global m's exchange (kernel B1's): each warp's sum goes, with the step's
// tag, into slot [tag & 1][rank * warps + warp] of every CTA of the cluster
// (lane l stores to CTA l); every warp polls its own CTA's C x warps slots
// lane-parallel until each carries the tag, then sums them.  A slot is
// rewritten (tag + 2) only after every warp of the cluster has pushed
// tag + 1, which each does after it has read tag.
__device__ __forceinline__ void replica_push(int v, uint64_t* slots,
                                             uint32_t tag, int C, int rank) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint64_t* half = slots + (tag & 1u) * kMaxCluster * 32;
  v = warp_sum(v);
  if (lane < C) {
    volatile uint64_t* peer = cg::this_cluster().map_shared_rank(half, lane);
    peer[rank * (blockDim.x >> 5) + warp] = tagged(tag, v);
  }
}

__device__ __forceinline__ int replica_poll(const uint64_t* slots,
                                            uint32_t tag, int C) {
  const int lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  const volatile uint64_t* half = slots + (tag & 1u) * kMaxCluster * 32;
  int s = 0;
  for (int i = lane; i < C * nw; i += 32) {
    uint64_t w;
    unsigned polls = 0;
    for (w = half[i]; (uint32_t)(w >> 32) != tag; w = half[i]) {
      if (++polls == kMaxPolls) __trap();
      __nanosleep(32);
    }
    s += (int)(uint32_t)w;
  }
  return warp_sum(s);
}

// One band row's W taps, each one rounded multiply and one rounded add
// per sum, in tap order: tap t reads f[t] before the row's rotation wraps
// (t < tA) and f[t - W] after it; kWrap false: no lane of the warp wraps,
// and the taps read f[t] with no select.  No branch per tap, so the loads
// of the unrolled taps are in flight together; every lane of a warp runs
// the same taps at the same t.
template <bool kWrap>
__device__ __forceinline__ void band_tap(const float2* __restrict__ f,
                                         int t, int tA, int W, float w,
                                         float& c0, float& c1) {
  const float2 v = f[kWrap && t >= tA ? t - W : t];
  c0 = __fadd_rn(c0, __fmul_rn(w, v.x));
  c1 = __fadd_rn(c1, __fmul_rn(w, v.y));
}

// The weights from the rotation vector in shared memory, w_t = wq[t].
template <bool kWrap>
__device__ __forceinline__ void band_row_shared(
    const float2* __restrict__ f, const float* __restrict__ wq, int W,
    int tA, float& c0, float& c1) {
#pragma unroll 8
  for (int t = 0; t < W; ++t) band_tap<kWrap>(f, t, tA, W, wq[t], c0, c1);
}

// The weights from the table, four taps of the row in one 16-byte load
// (w_{4q+i} = wq[q * L].i; lane x reads x's, so a warp's loads are 512
// contiguous bytes); the taps past W have weight 0 and add +0.
template <bool kWrap>
__device__ __forceinline__ void band_row_table(
    const float2* __restrict__ f, const float4* __restrict__ wq, int L,
    int W, int tA, float& c0, float& c1) {
  const int W4 = (W + 3) / 4;
#pragma unroll 4
  for (int q = 0; q < W4; ++q) {
    const float4 w = __ldg(wq + (size_t)q * L);
    band_tap<kWrap>(f, 4 * q, tA, W, w.x, c0, c1);
    band_tap<kWrap>(f, 4 * q + 1, tA, W, w.y, c0, c1);
    band_tap<kWrap>(f, 4 * q + 2, tA, W, w.z, c0, c1);
    band_tap<kWrap>(f, 4 * q + 3, tA, W, w.w, c0, c1);
  }
}

template <int K>
__global__ void __launch_bounds__(kMaxThreads)
exclusion_kernel(const Params a) {
  extern __shared__ uint64_t smem64[];
  __shared__ int red[2][32];
  const int C = a.cluster, L = a.L, h = a.halo, W = a.W;
  const int rank = C > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const int b = blockIdx.x / C;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int KL = K * L;
  const bool periodic = a.periodic != 0;
  const bool local_m = a.band_w != nullptr;
  const bool exch = a.exchange != 0;

  // the segment [s_lo, s_lo + seg) and its window of Wn sites: local site
  // z is the global site base + z (mod L on a torus)
  const int s_lo = (int)((long long)rank * L / C);
  const int seg = (int)((long long)(rank + 1) * L / C) - s_lo;
  const bool has_l = C > 1 && (periodic || rank > 0);
  const bool has_r = C > 1 && (periodic || rank < C - 1);
  const int hl = has_l ? h : 0, hr = has_r ? h : 0;
  const int Wn = hl + seg + hr;
  const int base = s_lo - hl < 0 ? s_lo - hl + L : s_lo - hl;
  const bool wrap = periodic && C == 1;   // the window is the whole torus

  // count arrays (cnt, occ as float2), continued P entries past each end:
  // the exchanged field of the whole lattice, and the window's own (padded
  // where the band reads it)
  const int P = band_pad(W);
  const int Pw = local_m && !exch ? P : 0;
  uint64_t* mbox = smem64;                      // [2][2 sides][K][h]
  uint64_t* gslot = mbox + (C > 1 ? 4 * K * h : 0);
  uint64_t* fbox = gslot + (local_m ? 0 : kSlotWords);  // [2][L] (exch)
  float2* field = reinterpret_cast<float2*>(fbox + (exch ? 2 * L : 0)) + P;
  float2* cf = field - P + (exch ? L + 2 * P : 0) + Pw;   // (Wn,)
  int* cur = reinterpret_cast<int*>(cf + Wn + Pw);        // (K, Wn) slots
  int* nxt = cur + K * Wn;
  int* inmask = nxt + K * Wn;                   // (Wn,) admitted incomers
  uint32_t* prio = reinterpret_cast<uint32_t*>(inmask + Wn);  // (K, Wn)
  float* utaps = reinterpret_cast<float*>(prio + K * Wn);     // (2W,)
  int8_t* ev = reinterpret_cast<int8_t*>(utaps + 2 * W);      // (K, Wn)
  uint8_t* queue = reinterpret_cast<uint8_t*>(ev + K * Wn) + warp * 32 * K;

  auto gsite = [&](int z) { return base + z >= L ? base + z - L : base + z; };
  auto lsite = [&](int i) {
    const int z = i - base;
    return periodic && z < 0 ? z + L : z;
  };
  auto lleft = [&](int z) { return z > 0 ? z - 1 : (wrap ? Wn - 1 : -1); };
  auto lright = [&](int z) {
    return z + 1 < Wn ? z + 1 : (wrap ? 0 : -1);
  };
  // the phases' local ranges: P2 on the segment +-2, P3 +-1, P4 the segment
  const int p2_lo = hl - (has_l ? 2 : 0), p2_hi = hl + seg + (has_r ? 2 : 0);
  const int p3_lo = hl - (has_l ? 1 : 0), p3_hi = hl + seg + (has_r ? 1 : 0);
  const int left_rank = (rank + C - 1) % C, right_rank = (rank + 1) % C;
  const float2 zero2 = make_float2(0.f, 0.f);

  for (int i = tid; i < 4 * K * h && C > 1; i += nt)
    mbox[i] = (uint64_t)kNoTag << 32;
  for (int i = tid; i < kSlotWords && !local_m; i += nt)
    gslot[i] = (uint64_t)kNoTag << 32;
  for (int i = tid; i < 2 * L && exch; i += nt)
    fbox[i] = (uint64_t)kNoTag << 32;
  // the pads where no copy lands (an array shorter than its pads) stay 0
  for (int i = tid; i < 2 * P && exch; i += nt)
    field[i < P ? i - P : L + i - P] = zero2;
  for (int i = tid; i < 2 * Pw; i += nt)
    cf[i < Pw ? i - Pw : Wn + i - Pw] = zero2;
  for (int t = tid; t < 2 * W; t += nt)
    utaps[t] = a.band_utaps[t < W ? t : t - W];
  const float neg_beta = -a.scal[3 * b];
  const float dt = a.dt;
  const float p_dif = __fmul_rn(a.scal[3 * b + 1], dt);
  const float p_act = __fmul_rn(a.scal[3 * b + 2], dt);
  const uint2 key = make_uint2((uint32_t)a.seeds[b], (uint32_t)(a.b0 + b));
  const size_t off = (size_t)b * KL;
  __syncthreads();

  // P1: the window's slots, occupancy and signed count; the field's
  auto site_counts = [&](int g, int* dst, int z) {
    int o = 0, c = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int v = a.slots_in[off + k * L + g];
      if (dst) dst[k * Wn + z] = v;
      o += v != 0;
      c += (v > 0) - (v < 0);
    }
    return make_float2((float)c, (float)o);
  };
  for (int z = tid; z < Wn; z += nt)
    put_count(cf, Wn, Pw, z, site_counts(gsite(z), cur, z));
  for (int i = tid; i < L && exch; i += nt)
    put_count(field, L, P, i, site_counts(i, nullptr, 0));
  // global m: the replica's exact sums; N is conserved through the call
  int S = 0, N = 0;
  if (!local_m) {
    int ls = 0, ln = 0;
    for (int i = tid; i < KL; i += nt) {
      const int v = a.slots_in[off + i];
      ls += (v > 0) - (v < 0);
      ln += v != 0;
    }
    ls = warp_sum(ls);
    ln = warp_sum(ln);
    if (lane == 0) {
      red[0][warp] = ls;
      red[1][warp] = ln;
    }
    __syncthreads();
    for (int w = 0; w < (nt >> 5); ++w) {
      S += red[0][w];
      N += red[1][w];
    }
  }
  // every CTA of the cluster runs, its mailboxes cleared, before any push
  cluster_sync();

  // m of row g (window site z), called by every lane of the warp (`live`
  // for a site of the P2 range).  A row of rotation rot reads its inputs
  // zc - radius + ((t + rot) mod W) (ops/exclusion_kernel.band_rotation),
  // zc its site in the count array: in the field, where they wrap at the
  // lattice's ends as the array's periodic continuation does, or in the
  // window, which holds every input of a weight != 0 (an input past a
  // wall has weight 0 and reads a pad).  Weights: the rotation vector
  // where every row of the warp rotates it, else the transposed table.  A
  // row of no rotation (-1) reads its index table.
  auto band_m = [&](int g, int z, bool live) {
    const float2* f = exch ? field : cf;
    const int n = exch ? L : Wn;
    const int zc = live ? (exch ? g : z) : 0;
    int rot = live ? a.band_krot[g] : 0;
    const bool runs = rot != -1;
    rot = rot >= 0 ? rot : (rot == -1 ? 0 : -2 - rot);
    const bool on = __all_sync(kFull, !live || !runs || a.band_on[g] != 0);
    // the row's first input in f, and the tap where its inputs step back
    // W entries; a row of all n sites reads them from its first input
    // within the array (a dense band's rows read 0..L-1: no step back)
    int s0 = zc - a.radius + rot, tA = W - rot;
    if (W == n) {
      s0 = s0 < 0 ? s0 + n : (s0 >= n ? s0 - n : s0);
      tA = n - s0;
    }
    // a lane off the band (a site past the range, a row of no rotation)
    // reads the array's first W entries and drops its sums
    if (!live) s0 = 0, tA = W;
    const bool wraps = __any_sync(kFull, tA < W);
    float c0 = 0.f, c1 = 0.f;
    const float2* fr = f + s0;
    const float* ws = utaps + rot;
    const float4* wt = reinterpret_cast<const float4*>(a.band_wt) + g;
    if (on && wraps) band_row_shared<true>(fr, ws, W, tA, c0, c1);
    else if (on) band_row_shared<false>(fr, ws, W, tA, c0, c1);
    else if (wraps) band_row_table<true>(fr, wt, L, W, tA, c0, c1);
    else band_row_table<false>(fr, wt, L, W, tA, c0, c1);
    if (!runs) c0 = c1 = 0.f;
    if (live && !runs) {
      const int* bi = a.band_idx + (size_t)g * W;
      const float* bw = a.band_w + (size_t)g * W;
      for (int t = 0; t < W; ++t) {
        const float w = bw[t];
        if (w == 0.f) continue;     // its input may lie outside the window
        const float2 v = f[exch ? bi[t] : lsite(bi[t])];
        c0 = __fadd_rn(c0, __fmul_rn(w, v.x));
        c1 = __fadd_rn(c1, __fmul_rn(w, v.y));
      }
    }
    const float m = c1 > 0.f ? __fdiv_rn(c0, c1) : 0.f;
    return fminf(fmaxf(m, -1.f), 1.f);
  };

  const float n_f = fmaxf((float)N, 1.0f);
  const float kf = (float)K;
  for (int s = 0; s < a.k_steps; ++s) {
    const bool more = s + 1 < a.k_steps;
    const uint32_t tag = (uint32_t)s + 1u;    // the tag of this step's output
    float m_glob = 0.f;
    if (!local_m) {
      if (s > 0) S = replica_poll(gslot, (uint32_t)s, C);
      m_glob = __fdiv_rn((float)S, n_f);
    }
    const int* nz =
        a.noise ? a.noise + ((size_t)b * a.k_steps + s) * 2 * KL : nullptr;

    // P2: per site m and the hop gates; then per particle (the warp's
    // occupied slots, compacted) the event and the priority
    for (int z0 = p2_lo + (tid & ~31); z0 < p2_hi; z0 += nt) {
      const int z = z0 + lane;
      const bool live = z < p2_hi;
      float m = m_glob;
      if (local_m) m = band_m(live ? gsite(z) : 0, z, live);
      int gates = 0;
      unsigned occb = 0;
      if (live) {
        const int zl = lleft(z), zr = lright(z);
        gates = (zl >= 0 && cf[zl].y < kf ? 1 : 0) |
                (zr >= 0 && cf[zr].y < kf ? 2 : 0);
#pragma unroll
        for (int k = 0; k < K; ++k) {
          if (cur[k * Wn + z] != 0) {
            occb |= 1u << k;
          } else {
            ev[k * Wn + z] = kNone;
            prio[k * Wn + z] = kSent;
          }
        }
      }
      const int n = __popc(occb);
      int inc = n;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(kFull, inc, o);
        if (lane >= o) inc += t;
      }
      const int total = __shfl_sync(kFull, inc, 31);
      int pos = inc - n;
#pragma unroll
      for (int k = 0; k < K; ++k)
        if ((occb >> k) & 1u) queue[pos++] = (uint8_t)(lane | (k << 5));
      __syncwarp();
      for (int j0 = 0; j0 < total; j0 += 32) {
        const int j = j0 + lane;
        const int e = j < total ? queue[j] : 0;
        const int src = e & 31, k = e >> 5;
        const float mm = __shfl_sync(kFull, m, src);
        const int gg = __shfl_sync(kFull, gates, src);
        if (j < total) {
          const int zz = z0 + src;
          const int g = gsite(zz);
          const int v = cur[k * Wn + zz];
          const bool plus = v > 0, lf = gg & 1, rf = gg & 2;
          const float c =
              expf(__fmul_rn(__fmul_rn(neg_beta, plus ? 1.f : -1.f), mm));
          float rl = lf ? p_dif : 0.f;
          if (a.bidirectional && !plus && lf) rl = __fadd_rn(rl, p_act);
          float rr = rf ? p_dif : 0.f;
          if (plus && rf) rr = __fadd_rn(rr, p_act);
          const float t1 = rl;
          const float t2 = __fadd_rn(t1, rr);
          const float t3 = __fadd_rn(t2, __fmul_rn(c, dt));
          uint32_t ub, pb;
          if (nz) {
            ub = (uint32_t)nz[k * L + g];
            pb = (uint32_t)nz[KL + k * L + g];
          } else {
            const uint4 r = hydrolim::philox4x32_10(
                make_uint4((uint32_t)(k * L + g), (uint32_t)(a.step0 + s), 0u,
                           0u),
                key);
            ub = r.x;
            pb = r.y;
          }
          const float u = hydrolim::bits_to_uniform(ub);
          int8_t ev_ = kNone;
          if (u < t1) ev_ = kLeft;
          else if (u < t2) ev_ = kRight;
          else if (u < t3) ev_ = kFlip;
          const uint32_t rand_hi = (pb >> 1) & 0x7FFFFFF0u;
          uint32_t pr = kSent;
          if (ev_ == kRight) pr = rand_hi | (uint32_t)k;
          else if (ev_ == kLeft) pr = rand_hi | (uint32_t)(K + k);
          ev[k * Wn + zz] = ev_;
          prio[k * Wn + zz] = pr;
        }
      }
      __syncwarp();
    }
    __syncthreads();

    // P3: admission at each destination site
    for (int x = p3_lo + tid; x < p3_hi; x += nt) {
      const int xl = lleft(x), xr = lright(x);
      const int free_ = K - (int)cf[x].y;
      int mask = 0;
      if (free_ > 0) {
        uint32_t c[2 * K];
#pragma unroll
        for (int k = 0; k < K; ++k) {
          c[k] = (xl >= 0 && ev[k * Wn + xl] == kRight) ? prio[k * Wn + xl]
                                                        : kSent;
          c[K + k] = (xr >= 0 && ev[k * Wn + xr] == kLeft) ? prio[k * Wn + xr]
                                                           : kSent;
        }
#pragma unroll
        for (int q = 0; q < 2 * K; ++q) {
          int rank_ = 0;
#pragma unroll
          for (int j = 0; j < 2 * K; ++j) rank_ += c[j] < c[q];
          if (c[q] != kSent && rank_ < free_) mask |= 1 << q;
        }
      }
      inmask[x] = mask;
    }
    __syncthreads();

    // P4: leavers out, flips, stable front-pack; the next step's occupancy
    // and count; the segment's edge sites to the neighbours' halos
    const uint32_t par = tag & 1u;
    uint64_t* to_l = has_l && more
        ? cg::this_cluster().map_shared_rank(mbox, left_rank) +
              (par * 2 + 1) * K * h
        : nullptr;                              // its right halo
    uint64_t* to_r = has_r && more
        ? cg::this_cluster().map_shared_rank(mbox, right_rank) +
              (par * 2) * K * h
        : nullptr;                              // its left halo
    int ls = 0;
    for (int x = hl + tid; x < hl + seg; x += nt) {
      const int xl = lleft(x), xr = lright(x);
      const int to_left = xl >= 0 ? inmask[xl] >> K : 0;    // bits k
      const int to_right = xr >= 0 ? inmask[xr] : 0;        // bits k
      const int in = inmask[x];
      int n = 0, o = 0, cs = 0;
      int out[K];
#pragma unroll
      for (int k = 0; k < K; ++k) out[k] = 0;
      auto push = [&](int v) {
#pragma unroll
        for (int k = 0; k < K; ++k)
          if (k == n) out[k] = v;
        n += n < K;
        o += 1;
        cs += v > 0 ? 1 : -1;
      };
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int v = cur[k * Wn + x];
        if (v == 0) continue;
        const int8_t e = ev[k * Wn + x];
        if (e == kRight && ((to_right >> k) & 1)) continue;
        if (e == kLeft && ((to_left >> k) & 1)) continue;
        push(e == kFlip ? -v : v);
      }
#pragma unroll
      for (int k = 0; k < K; ++k)
        if ((in >> k) & 1) push(cur[k * Wn + xl]);
#pragma unroll
      for (int k = 0; k < K; ++k)
        if ((in >> (K + k)) & 1) push(cur[k * Wn + xr]);
#pragma unroll
      for (int k = 0; k < K; ++k) nxt[k * Wn + x] = out[k];
      put_count(cf, Wn, Pw, x, make_float2((float)cs, (float)o));
      ls += cs;
      if (exch && more) {    // the site's counts to every CTA's field
        const uint64_t word =
            tagged(tag, (int)(((uint32_t)cs & 0xFFFFu) | ((uint32_t)o << 16)));
        const int g = gsite(x);
        for (int r = 0; r < C; ++r)
          static_cast<volatile uint64_t*>(
              cg::this_cluster().map_shared_rank(fbox, r))[par * L + g] = word;
      }
      const int so = x - hl;
      if (to_l && so < h) {
#pragma unroll
        for (int k = 0; k < K; ++k)
          static_cast<volatile uint64_t*>(to_l)[k * h + so] =
              tagged(tag, out[k]);
      }
      if (to_r && so >= seg - h) {
#pragma unroll
        for (int k = 0; k < K; ++k)
          static_cast<volatile uint64_t*>(to_r)[k * h + so - (seg - h)] =
              tagged(tag, out[k]);
      }
    }
    if (!local_m && more) replica_push(ls, gslot, tag, C, rank);

    // the halos of the next step, from the neighbours' pushes
    if (more) {
      for (int i = tid; i < hl + hr; i += nt) {
        const int side = i < hl ? 0 : 1;
        const int so = side ? i - hl : i;
        const int z = side ? hl + seg + so : so;
        const volatile uint64_t* box = mbox + (par * 2 + side) * K * h + so;
        int o = 0, c = 0;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          uint64_t w;
          unsigned polls = 0;
          for (w = box[k * h]; (uint32_t)(w >> 32) != tag; w = box[k * h]) {
            if (++polls == kMaxPolls) __trap();
            __nanosleep(32);
          }
          const int v = (int)(uint32_t)w;
          nxt[k * Wn + z] = v;
          o += v != 0;
          c += (v > 0) - (v < 0);
        }
        put_count(cf, Wn, Pw, z, make_float2((float)c, (float)o));
      }
    }
    // the next step's count field, from every CTA's pushes
    if (exch && more) {
      const volatile uint64_t* box = fbox + par * L;
      for (int i = tid; i < L; i += nt) {
        uint64_t w;
        unsigned polls = 0;
        for (w = box[i]; (uint32_t)(w >> 32) != tag; w = box[i]) {
          if (++polls == kMaxPolls) __trap();
          __nanosleep(32);
        }
        const uint32_t v = (uint32_t)w;    // cnt in the low 16 bits
        put_count(field, L, P, i, make_float2((float)(int16_t)(v & 0xFFFFu),
                                              (float)(v >> 16)));
      }
    }
    __syncthreads();
    int* t = cur;
    cur = nxt;
    nxt = t;
  }
  // no CTA leaves while a peer may still push into its shared memory
  cluster_sync();

  for (int i = tid; i < K * seg; i += nt) {
    const int k = i / seg, x = i - k * seg;
    a.slots_out[off + k * L + s_lo + x] = cur[k * Wn + hl + x];
  }
}

using KernelFn = void (*)(const Params);

KernelFn pick(int K) {
  switch (K) {
    case 1: return exclusion_kernel<1>;
    case 2: return exclusion_kernel<2>;
    case 3: return exclusion_kernel<3>;
    case 4: return exclusion_kernel<4>;
    case 5: return exclusion_kernel<5>;
    case 6: return exclusion_kernel<6>;
    case 7: return exclusion_kernel<7>;
    case 8: return exclusion_kernel<8>;
    default: return nullptr;
  }
}

// `spread`: ask for more shared memory than half an SM holds, so that the
// occupancy query counts clusters with every CTA on an SM of its own.
cudaError_t configure(KernelFn fn, int K, int L, int W, int C, int h,
                      int threads, bool global_m, bool exchange, int B,
                      bool spread, void* stream, cudaLaunchConfig_t& cfg,
                      cudaLaunchAttribute& attr) {
  if (!fn || C < 1 || C > kMaxCluster || threads < 32 ||
      threads > kMaxThreads || threads % 32 || (C > 1 && h < 1) ||
      (C > 1 && L / C < 2 * h) || (exchange && (C == 1 || global_m)))
    return cudaErrorInvalidValue;
  size_t smem = smem_bytes(K, L, W, C, h, threads, global_m, exchange);
  if (spread && smem < kHalfSm) smem = kHalfSm;
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
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

// How many clusters of this shape the card holds at once, a CTA per SM.
extern "C" int exclusion_max_active_clusters(int K, int L, int W, int C,
                                             int halo, int threads,
                                             int global_m, int exchange,
                                             int* out) {
  const KernelFn fn = pick(K);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e = configure(fn, K, L, W, C, halo, threads, global_m != 0,
                            exchange != 0, 1, true, nullptr, cfg, attr);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveClusters(out, fn, &cfg);
}

extern "C" int exclusion_multi_step_launch(
    const float* scal, const int* seeds, int step0, int b0,
    const int* slots_in, int* slots_out, const int* noise,
    const int* band_idx, const float* band_w, const float* band_wt,
    const float* band_utaps, const int* band_krot, const int* band_on,
    int W, int radius, int B, int K, int L, int k_steps, float dt,
    int periodic, int bidirectional, int C, int halo, int threads,
    int exchange, void* stream) {
  const KernelFn fn = pick(K);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e = configure(fn, K, L, W, C, halo, threads, band_w == nullptr,
                            exchange != 0, B, false, stream, cfg, attr);
  if (e != cudaSuccess) return (int)e;
  const Params p{scal,       seeds,     step0,    b0,       slots_in,
                 slots_out,  noise,     band_idx, band_w,   band_wt,
                 band_utaps, band_krot, band_on,  W,        radius,
                 L,          k_steps,   dt,       periodic, bidirectional,
                 C,          halo,      exchange};
  e = cudaLaunchKernelEx(&cfg, fn, p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

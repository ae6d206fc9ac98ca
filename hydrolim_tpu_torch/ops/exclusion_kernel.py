"""Kernel B3/B4: fused multi-step K-slot exclusion stepper.

``exclusion_multi_step`` advances k steps of the K-slot exclusion engine per
replica.  On CUDA tensors it launches the hand-written kernel
(``csrc/exclusion_multi_step.cu``), the counterpart of both TPU kernels
``hydrolim_tpu/ops/pallas_exclusion.py`` (B3, (R, Kp, Lp) layout) and
``hydrolim_tpu/ops/pallas_exclusion_rb.py`` (B4, the same law in a
replica-banked (K, R, Lp) layout); on CPU tensors it runs
``exclusion_multi_step_plain``.  The two TPU layouts existed to fill the
TPU's sublanes; ``interop`` converts their slots and injected bits to the
port's (B, K, L).

State: (B, K, L) int32 signed slot payloads — sign = spin, magnitude =
particle identity (1 for anonymous fields, id+1 for tagged runs); moves
and compaction carry payloads intact.  Per step:

1. m: the global Σσ / max(Σ|σ|, 1), or the local smoothed ratio
   conv(σ)/conv(|σ|) (0 where conv(|σ|) = 0, clipped to [−1, 1]) with the
   per-site weight band of ``build_smoothing_band``, summed in ascending
   input-site order;
2. per slot, from the pre-step neighbour occupancy (walls closed when
   non-periodic): thresholds t1 = left rate·Δt, t2 = t1 + right rate·Δt,
   t3 = t2 + exp(−βσm)·Δt against one 24-bit uniform, (bits & 0xFFFFFF)·2⁻²⁴;
3. per destination site, the ≤ 2K incoming candidates carry priorities
   ((bits >> 1) & 0x7FFFFFF0) | row (right-movers row k, left-movers K+k);
   K rounds each admit the smallest while the free capacity lasts;
4. per site, stayers (flipped where a flip fired), then admitted
   right-incomers, then left-incomers, packed front-first in that order.

Randomness is injected (``noise``: (B, k, 2, K, L) int32 bits, draw 0 =
event, 1 = priority) or native: the kernel draws Philox4x32-10 with key
(seed, ``b0`` + replica) and counter (slot·L + site, ``step0`` + step),
words 0 and 1 of one call, so a launch of rows [b0, b0 + n) of a batch
draws what the launch of the whole batch draws for them; the plain version
draws from ``generator``.

Launch plan (``exclusion_launch_plan``, a pure function tested on the CPU):
a thread-block cluster of C ≤ 8 CTAs per replica, CTA r owning the sites
``segments(L, C)[r]`` plus ``halo_width`` sites of state on each side
(``cta_window``).  Among the C whose windows fit shared memory, whose
segments are at least two halos wide and that seat all B clusters at once
with a CTA per SM (``cudaOccupancyMaxActiveClusters``), the smallest that
brings a CTA to ``SITES_PER_CTA`` sites.  ``card_plan`` asks the card;
``exclusion_multi_step_planned`` runs a given (or forced) plan.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Mapping, Optional, Tuple

import numpy as np
import torch

from hydrolim_tpu_torch.core.config import ParticleConfig
from hydrolim_tpu_torch.ops._build import check_cuda, load_kernel_library, ptr
from hydrolim_tpu_torch.ops.convolve import (
    gaussian_filter_weights,
    periodic_gaussian_kernel,
)
from hydrolim_tpu_torch.ops.stepper_kernel import _check, bits_to_uniform
from hydrolim_tpu_torch.parallel import draws

SOURCE = "hydrolim_tpu_torch/csrc/exclusion_multi_step.cu"
REPLACES = ("hydrolim_tpu/ops/pallas_exclusion.py:403 and "
            "hydrolim_tpu/ops/pallas_exclusion_rb.py:222")

MAX_K = 8                     # 2K candidate row ids fit the priorities' 4 bits
MAX_CLUSTER = 8               # the portable cluster size
MAX_THREADS = 1024
MAX_SMEM = 232_448 - 256      # an H100 block's limit less the static partials
SLOT_BYTES = 2 * MAX_CLUSTER * 32 * 8   # global m's tagged Σσ partials
# The sites per CTA at which a step stops getting faster with more CTAs:
# each phase of a step is a chain of dependent loads, so a CTA of a few
# warps takes about as long as one of eight, and each CTA more adds a halo
# handoff.  PERF.md's cluster tables (chip_smoke.py phase 9,
# profile_exclusion_kernel.py --clusters) show it at L=1000: at B=16, 1000
# sites per CTA (C=1) take 5.97 µs per step, 334 (C=3) 3.77, 250 (C=4)
# 3.44 and 125-200 (C=5-8) 3.41-3.46; at L=250 one CTA of 250 sites took
# 2.96 against 3.17 at C=4.
SITES_PER_CTA = 256
_SENT = 0x7FFFFFFF            # "no candidate": sorts after every priority
_MASK_HI = 0x7FFFFFF0         # 27 random bits; the low 4 carry the row id
_PERIODIC_TAIL = 1e-7         # periodic band: the cut tail's share of mass


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def cta_threads(L: int, C: int) -> int:
    """Threads of one CTA: the sites of its longest P2 range (its segment
    and, in a cluster, two sites past each side) in whole warps, at most
    1024."""
    return min(MAX_THREADS, 32 * _cdiv(_cdiv(L, C) + (4 if C > 1 else 0),
                                       32))


def cta_smem_bytes(K: int, L: int, W: int, C: int, halo: int,
                   global_m: bool) -> int:
    """Dynamic shared memory of one CTA (the kernel's ``smem_bytes``): the
    halo mailboxes (2 step parities × 2 sides × K × halo tagged 64-bit
    words), global m's tagged partials, two (K, window) int32 slot buffers,
    (K, window) int32 priorities and int8 events, three (window,) int32
    site arrays, the band's W taps (float32) and a K-byte draw queue per
    thread.  The window is L at C=1, else the longest segment and two
    halos."""
    window = L if C == 1 else _cdiv(L, C) + 2 * halo
    return ((0 if C == 1 else 32 * K * halo)
            + (SLOT_BYTES if global_m else 0) + (13 * K + 12) * window
            + 4 * W + K * cta_threads(L, C))


def segments(L: int, C: int) -> list:
    """CTA r of a cluster of C owns the sites [r·L//C, (r+1)·L//C)."""
    return [(r * L // C, (r + 1) * L // C) for r in range(C)]


@dataclasses.dataclass(frozen=True)
class CtaWindow:
    """The sites CTA ``rank`` keeps: ``left`` halo sites, its segment
    [lo, hi), ``right`` halo sites; local site z is the global site
    ``start`` + z (mod L on a torus)."""

    lo: int
    hi: int
    left: int
    right: int
    start: int

    def sites(self, L: int) -> np.ndarray:
        return (self.start + np.arange(self.left + self.hi - self.lo
                                       + self.right)) % L


def cta_window(L: int, C: int, rank: int, halo: int,
               periodic: bool) -> CtaWindow:
    """The window of CTA ``rank``: no halo past a wall, none at C=1 (the
    whole lattice, wrapping in itself when periodic)."""
    lo, hi = segments(L, C)[rank]
    left = halo if C > 1 and (periodic or rank > 0) else 0
    right = halo if C > 1 and (periodic or rank < C - 1) else 0
    return CtaWindow(lo, hi, left, right, (lo - left) % L)


def halo_width(band: Optional["SmoothingBand"], periodic: bool) -> int:
    """Sites of pre-step state a CTA needs on each side of its segment: the
    pack at the segment's edge reads admission one site out, admission
    reads events two out, and an event reads the occupancy three out and
    (local m) the band's inputs ``reach`` + 2 out."""
    if band is None:
        return 3
    return max(3, (band.reach_wrap if periodic else band.reach) + 2)


def cluster_fits(K: int, L: int, W: int, C: int, halo: int) -> bool:
    """A cluster of C CTAs can run the call: each segment at least two
    halos wide, and the window's shared memory within the block's."""
    return ((C == 1 or L // C >= 2 * halo)
            and cta_smem_bytes(K, L, W, C, halo, W == 0) <= MAX_SMEM)


@dataclasses.dataclass(frozen=True)
class ExclusionPlan:
    cluster: int
    halo: int
    threads: int
    smem: int
    waves: int             # ⌈B / co-resident clusters⌉, a CTA per SM


def exclusion_launch_plan(B: int, K: int, L: int, W: int, halo: int,
                          coresident: Mapping[int, int], *,
                          cluster: Optional[int] = None) -> ExclusionPlan:
    """The plan of one call (W = 0: global m).  ``coresident[C]`` is how
    many clusters of C CTAs the card holds at once with every CTA on an
    SM of its own (absent or 0: cannot launch).  Among the C ≤ 8 that fit
    (``cluster_fits``) with the fewest waves, the smallest C whose CTA
    holds at most ``SITES_PER_CTA`` sites, else the one with the fewest.
    ``cluster`` forces C."""
    sizes = [cluster] if cluster else range(1, MAX_CLUSTER + 1)
    ok = [C for C in sizes
          if cluster_fits(K, L, W, C, halo) and int(coresident.get(C, 0)) > 0]
    if not ok:
        raise ValueError(f"exclusion_multi_step: no cluster size of "
                         f"{list(sizes)} fits K={K}, L={L}, W={W}, halo "
                         f"{halo} in shared memory")
    waves = {C: _cdiv(B, int(coresident[C])) for C in ok}
    fewest = min(waves.values())
    cands = [C for C in ok if waves[C] == fewest]
    small = [C for C in cands if _cdiv(L, C) <= SITES_PER_CTA]
    C = min(small) if small else max(cands)
    h = halo if C > 1 else 0
    return ExclusionPlan(C, h, cta_threads(L, C),
                         cta_smem_bytes(K, L, W, C, h, W == 0), fewest)


# ---------------------------------------------------------------------------
# the smoothing band
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SmoothingBand:
    """Per output site x: input sites ``idx[x]`` (ascending) and float32
    weights ``w[x]`` (0 on padding entries), both (L, W).  The sites x in
    the interior [lo, hi) read the same (W,) ``taps`` at the inputs
    x − radius + t: ``idx[x, t] = x − radius + t`` and ``w[x] = taps``
    bit for bit, checked where the band is built.  The kernel serves those
    taps from shared memory and reads the other rows from ``idx``/``w``.
    ``rot`` (L,) int32: each row's rotation (``band_rotation``).
    ``reach`` and ``reach_wrap``: the farthest input (weight ≠ 0, or an
    interior tap) from its output site, along the line and around the
    torus."""

    idx: torch.Tensor
    w: torch.Tensor
    taps: torch.Tensor
    rot: torch.Tensor
    radius: int
    lo: int
    hi: int
    reach: int
    reach_wrap: int


def _periodic_radius(k: np.ndarray) -> int:
    """Smallest radius whose taps hold all but ``_PERIODIC_TAIL`` of the
    torus kernel's mass (float64)."""
    k = np.abs(np.asarray(k, np.float64))
    L, total = k.shape[0], k.sum()
    for r in range(1, (L - 1) // 2 + 1):
        d = np.arange(-r, r + 1)
        if total - k[d % L].sum() <= _PERIODIC_TAIL * total:
            return r
    return (L - 1) // 2 + 1


def band_weights(config: ParticleConfig) -> Tuple[np.ndarray, np.ndarray]:
    """(L, W) int32 input sites and float32 weights of the local-m smoothing,
    entry for entry the JAX kernel's smoothing matrix (``build_conv_matrix``,
    rows = input, columns = output): periodic, the normalised torus
    Gaussian cut where its tail holds < 1e-7 of the mass; non-periodic, the
    scipy reflect-mode weights, reflected entries summed in float32 in the
    same order.  A periodic band whose 2r+1 taps cover the torus, and a
    reflect band whose radius r reaches L, is dense: every row reads all L
    sites in ascending order.  Reflect taps fold onto the lattice by
    repeated half-sample reflection (period 2L), as ``ops.convolve.
    reflect_pad`` does, so the band is scipy's filter at any radius; below
    L each tap reflects at most once and the weights are the JAX kernel's
    matrix entry for entry.  (That matrix reflects each tap once at any
    radius, so beyond L it is not scipy's filter: ROADMAP.md, "Reference
    behaviours a parity test runs into".)"""
    L = config.L
    out = np.arange(L)
    if config.periodic:
        k = periodic_gaussian_kernel(L, config.dx, config.local_kernel_sigma)
        r = _periodic_radius(k)
        if 2 * r + 1 >= L:
            src = np.broadcast_to(np.arange(L), (L, L))
        else:
            src = np.sort((out[:, None] + np.arange(-r, r + 1)) % L, axis=1)
        w = k[(out[:, None] - src) % L]
        return np.ascontiguousarray(src, np.int32), w.astype(np.float32)
    wts = gaussian_filter_weights(config.sigma_grid, 4.0)
    r = (len(wts) - 1) // 2
    dense = r >= L
    w = np.zeros((L, L if dense else 2 * r + 1), np.float32)
    for d in range(-r, r + 1):                  # the matrix's order of sums
        src = (out - d) % (2 * L)
        src = np.where(src >= L, 2 * L - 1 - src, src)
        w[out, src if dense else src - (out - r)] += wts[d + r]
    if dense:
        return np.ascontiguousarray(np.broadcast_to(out, (L, L)),
                                    np.int32), w
    src = out[:, None] - r + np.arange(2 * r + 1)
    valid = (src >= 0) & (src < L)
    assert not w[~valid].any()
    return np.where(valid, src, 0).astype(np.int32), w


def band_interior(idx: np.ndarray, w: np.ndarray
                  ) -> Tuple[np.ndarray, int, int, int]:
    """(taps, radius, lo, hi): the longest run of sites [lo, hi) whose rows
    are one row of taps translated, ``idx[x] = x − radius + arange(W)`` and
    ``w[x] = taps`` exactly; an empty run (lo = hi = 0) where no row of the
    middle site's shape exists."""
    L, W = idx.shape
    r = (W - 1) // 2
    taps = w[L // 2]
    ok = ((idx == np.arange(L)[:, None] - r + np.arange(W)).all(1)
          & (w == taps).all(1))
    edges = np.flatnonzero(np.diff(np.concatenate([[0], ok, [0]]).astype(int)))
    starts, ends = edges[::2], edges[1::2]
    if not len(starts):
        return np.ascontiguousarray(taps), r, 0, 0
    j = int(np.argmax(ends - starts))
    return np.ascontiguousarray(taps), r, int(starts[j]), int(ends[j])


def band_rotation(idx: np.ndarray, w: np.ndarray,
                  periodic: bool = True) -> np.ndarray:
    """(L,) int32: the rotation ``rot`` of each row under which its tap t
    reads the input x − radius + ((t + rot) mod W) wherever its weight is
    not 0: rot ≥ 0 along the line (an interior or a wall's row), −2 − rot
    only around the torus (a row near the wrap, whose inputs in ascending
    site order start past it; on a torus only), −1 for a row of no such
    form."""
    L, W = idx.shape
    r = (W - 1) // 2
    x = np.arange(L)
    live = w != 0
    t = np.arange(W)[None, :]
    t0 = np.argmax(live, 1)
    rot = ((idx[x, t0].astype(np.int64) - (x - r)) % L - t0) % W
    want = x[:, None] - r + (t + rot[:, None]) % W
    lin = ((want == idx) | ~live).all(1)
    wrap = ((want % L == idx) | ~live).all(1)
    wrap = wrap & periodic
    return np.where(lin, rot, np.where(wrap, -2 - rot, -1)).astype(np.int32)


def smoothing_band(idx: np.ndarray, w: np.ndarray, device="cuda",
                   periodic: bool = True) -> SmoothingBand:
    """The band of (L, W) input sites and weights, with its interior, its
    rows' rotations and its reach."""
    taps, radius, lo, hi = band_interior(idx, w)
    L, W = idx.shape
    d = np.abs(idx.astype(np.int64) - np.arange(L)[:, None])[w != 0]
    inner = max(radius, W - 1 - radius) if lo < hi else 0
    reach = max(int(d.max(initial=0)), inner)
    reach_wrap = max(int(np.minimum(d, L - d).max(initial=0)), inner)
    return SmoothingBand(idx=torch.tensor(idx, device=device),
                         w=torch.tensor(w, device=device),
                         taps=torch.tensor(taps, device=device),
                         rot=torch.tensor(band_rotation(idx, w, periodic),
                                          device=device),
                         radius=radius, lo=lo, hi=hi, reach=reach,
                         reach_wrap=reach_wrap)


def build_smoothing_band(config: ParticleConfig,
                         device="cuda") -> Optional[SmoothingBand]:
    """The local-m smoothing band of ``config``, None for global m
    (σ ≤ 0)."""
    if config.local_kernel_sigma <= 0:
        return None
    return smoothing_band(*band_weights(config), device=device,
                          periodic=config.periodic)


def smooth_with_band(x: torch.Tensor, band: SmoothingBand) -> torch.Tensor:
    """(..., L) float32 → Σ_t w[:, t]·x[..., idx[:, t]], one rounded
    multiply and one rounded add per tap, in ascending input order (as the
    kernel): the products in one gather, then one add per tap."""
    prod = band.w * x[..., band.idx.long()]             # (..., L, W)
    acc = torch.zeros_like(x)
    for t in range(prod.shape[-1]):
        acc = acc + prod[..., t]
    return acc


def band_m(counts_s: torch.Tensor, tot: torch.Tensor,
           band: Optional[SmoothingBand]) -> torch.Tensor:
    """The exclusion step's m from per-site signed and total counts
    (..., L) float32: the global Σs / max(Σtot, 1), (..., 1), without a
    band; else the smoothed ratio (0 where the smoothed total is 0, clipped
    to [−1, 1]), (..., L).  The kernel's m, and the slot engines' (one law
    and one summation order, so they equal the kernel at the same bits)."""
    if band is None:
        return counts_s.sum(-1, keepdim=True) / tot.sum(
            -1, keepdim=True).clamp(min=1.0)
    c0, c1 = smooth_with_band(torch.stack([counts_s, tot]), band)
    pos = c1 > 0
    return torch.where(pos, c0 / torch.where(pos, c1, 1.0),
                       0.0).clamp(-1.0, 1.0)


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------

def _shift_right(x: torch.Tensor, periodic: bool, fill) -> torch.Tensor:
    """out[..., i] = x[..., i−1]; the wall site gets ``fill``."""
    if periodic:
        return torch.roll(x, 1, -1)
    return torch.cat([torch.full_like(x[..., :1], fill), x[..., :-1]], -1)


def _shift_left(x: torch.Tensor, periodic: bool, fill) -> torch.Tensor:
    """out[..., i] = x[..., i+1]; the wall site gets ``fill``."""
    if periodic:
        return torch.roll(x, -1, -1)
    return torch.cat([x[..., 1:], torch.full_like(x[..., :1], fill)], -1)


def _draw_bits(shape, generator, device) -> torch.Tensor:
    return draws.randint(0, 2 ** 32, shape, generator, device, torch.int64)


def step_thresholds(slots: torch.Tensor, scalars: torch.Tensor,
                    band: Optional[SmoothingBand], dt: float, periodic: bool,
                    bidirectional: bool, m: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, ...]:
    """One step's event thresholds (t1, t2, t3), each (B, K, L) float32,
    and the pre-step site occupancy (B, L), in the kernel's arithmetic.
    ``m`` (B, 1, 1), if given, replaces the global m of these slots (a
    window of a lattice takes its lattice's)."""
    B, K, L = slots.shape
    f32 = torch.float32
    dt32 = torch.tensor(dt, dtype=f32, device=slots.device)
    zero = torch.zeros((), dtype=f32, device=slots.device)
    occ_slot = slots != 0
    is_plus = slots > 0
    is_minus = slots < 0
    sgn_f = is_plus.to(f32) - is_minus.to(f32)
    counts_s = sgn_f.sum(1)                           # (B, L), exact
    tot = occ_slot.to(f32).sum(1)
    occ_tot = occ_slot.sum(1)
    if band is not None or m is None:
        m = band_m(counts_s, tot, band)[:, None, :]
    beta = scalars[:, 0].reshape(B, 1, 1)
    c = torch.where(occ_slot, torch.exp(-beta * sgn_f * m), zero)

    p_dif = (scalars[:, 1] * dt32).reshape(B, 1, 1)
    p_act = (scalars[:, 2] * dt32).reshape(B, 1, 1)
    right_free = (_shift_left(occ_tot, periodic, K) < K)[:, None, :]
    left_free = (_shift_right(occ_tot, periodic, K) < K)[:, None, :]
    rate_left = torch.where(occ_slot & left_free, p_dif, zero)
    if bidirectional:
        rate_left = rate_left + torch.where(is_minus & left_free, p_act, zero)
    rate_right = (torch.where(occ_slot & right_free, p_dif, zero)
                  + torch.where(is_plus & right_free, p_act, zero))
    t1 = rate_left
    t2 = t1 + rate_right
    return t1, t2, t2 + c * dt32, occ_tot


def exclusion_multi_step_plain(scalars: torch.Tensor, seeds: torch.Tensor,
                               slots: torch.Tensor,
                               band: Optional[SmoothingBand] = None, *,
                               k_steps: int, dt: float, periodic: bool,
                               bidirectional: bool, step0: int = 0,
                               b0: int = 0,
                               noise: Optional[torch.Tensor] = None,
                               generator: Optional[torch.Generator] = None,
                               tally: Optional[dict] = None
                               ) -> torch.Tensor:
    """Plain PyTorch version: the kernel's steps in the same order on
    (B, K, L) tensors.  ``seeds``, ``step0`` and ``b0`` select the kernel's
    native stream and are not used here; without ``noise`` the bits come from
    ``generator``.  Bit operations run in int64.  A ``tally`` dict, if
    given, accumulates the admission candidates and the admitted ones
    (keys 'candidates', 'admitted'), so a check can see refusals."""
    B, K, L = slots.shape
    for s in range(k_steps):
        if noise is not None:
            u_bits = noise[:, s, 0].to(torch.int64)
            p_bits = noise[:, s, 1].to(torch.int64)
        else:
            u_bits = _draw_bits((B, K, L), generator, slots.device)
            p_bits = _draw_bits((B, K, L), generator, slots.device)
        slots = exclusion_step_plain(slots, scalars, band, u_bits, p_bits,
                                     dt=dt, periodic=periodic,
                                     bidirectional=bidirectional, tally=tally)
    return slots


def exclusion_step_plain(slots: torch.Tensor, scalars: torch.Tensor,
                         band: Optional[SmoothingBand], u_bits: torch.Tensor,
                         p_bits: torch.Tensor, *, dt: float, periodic: bool,
                         bidirectional: bool,
                         m: Optional[torch.Tensor] = None,
                         tally: Optional[dict] = None) -> torch.Tensor:
    """One step of the plain version at (B, K, L) int64 event and priority
    bits; ``m`` as in ``step_thresholds``."""
    B, K, L = slots.shape
    dev = slots.device
    row = torch.arange(K, device=dev).reshape(1, K, 1)
    t1, t2, t3, occ_tot = step_thresholds(slots, scalars, band, dt,
                                          periodic, bidirectional, m)
    u = bits_to_uniform(u_bits)
    ev_left = u < t1
    ev_right = (u >= t1) & (u < t2)
    ev_flip = (u >= t2) & (u < t3)

    rand_hi = ((p_bits & 0xFFFFFFFF) >> 1) & _MASK_HI
    cand_r = _shift_right(torch.where(ev_right, rand_hi | row, _SENT),
                          periodic, _SENT)
    cand_l = _shift_left(torch.where(ev_left, rand_hi | (row + K), _SENT),
                         periodic, _SENT)
    cand = torch.cat([cand_r, cand_l], 1)             # (B, 2K, L)
    free = (K - occ_tot)[:, None, :]
    accept = torch.zeros_like(cand, dtype=torch.bool)
    for r in range(K):
        cur_min = cand.min(1, keepdim=True).values
        win = (cand == cur_min) & (cand != _SENT) & (free > r)
        accept = accept | win
        cand = torch.where(win, _SENT, cand)
    acc_right_in, acc_left_in = accept[:, :K], accept[:, K:]
    if tally is not None:
        tally["candidates"] = tally.get("candidates", 0) + int(
            ev_right.sum() + ev_left.sum())
        tally["admitted"] = tally.get("admitted", 0) + int(accept.sum())

    leaver = (_shift_left(acc_right_in, periodic, False)
              | _shift_right(acc_left_in, periodic, False))
    stay = torch.where(leaver, 0, slots)
    stay = torch.where(ev_flip & ~leaver, -stay, stay)
    in_right = torch.where(acc_right_in, _shift_right(slots, periodic, 0), 0)
    in_left = torch.where(acc_left_in, _shift_left(slots, periodic, 0), 0)
    combined = torch.cat([stay, in_right, in_left], 1)        # (B, 3K, L)

    # stable front-pack of the nonzero rows; the spare row 3K takes the zeros
    nz = combined != 0
    dest = torch.where(nz, nz.cumsum(1) - 1, 3 * K)
    packed = torch.zeros((B, 3 * K + 1, L), dtype=slots.dtype, device=dev)
    packed.scatter_(1, dest, combined)
    return packed[:, :K].contiguous()


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------

def exclusion_multi_step(scalars: torch.Tensor, seeds: torch.Tensor,
                         slots: torch.Tensor,
                         band: Optional[SmoothingBand] = None, *,
                         k_steps: int, dt: float, periodic: bool,
                         bidirectional: bool, step0: int = 0,
                         b0: int = 0, noise: Optional[torch.Tensor] = None,
                         generator: Optional[torch.Generator] = None
                         ) -> torch.Tensor:
    """Advance k exclusion steps; returns the new (B, K, L) slots.

    Args:
      scalars: (B, 3) float32 [β, rate_diffusion, rate_active] (site units).
      seeds: (B,) int32 Philox seeds (native mode).
      slots: (B, K, L) int32 signed payloads, K ≤ 8.
      band: the local-m smoothing (``build_smoothing_band``); None for the
        global m.
      step0: global step index of the first step (native-mode counter).
      b0: global index of the first replica (native-mode key).
      noise: optional (B, k_steps, 2, K, L) int32 random bits.
      generator: the plain version's source of bits (CPU, no noise).
    """
    kw = dict(k_steps=k_steps, dt=dt, periodic=periodic,
              bidirectional=bidirectional, step0=step0, b0=b0, noise=noise)
    if slots.device.type == "cpu":
        return exclusion_multi_step_plain(scalars, seeds, slots, band,
                                          generator=generator, **kw)
    if slots.device.type != "cuda":
        raise ValueError(f"exclusion_multi_step: unsupported device "
                         f"{slots.device}")
    if slots.dim() != 3:
        raise ValueError(f"slots: want (B, K, L), got {tuple(slots.shape)}")
    B, K, L = slots.shape
    dev = slots.device
    if not 1 <= K <= MAX_K or L < 2:
        raise ValueError(f"exclusion_multi_step: K={K} (1..{MAX_K}) and "
                         f"L={L} (>= 2) out of range")
    _check(scalars, "scalars", torch.float32, (B, 3), dev)
    _check(seeds, "seeds", torch.int32, (B,), dev)
    _check(slots, "slots", torch.int32, (B, K, L), dev)
    if noise is not None:
        _check(noise, "noise", torch.int32, (B, k_steps, 2, K, L), dev)
    W = 0
    if band is not None:
        W = band.idx.shape[1]
        _check(band.idx, "band.idx", torch.int32, (L, W), dev)
        _check(band.w, "band.w", torch.float32, (L, W), dev)
        _check(band.taps, "band.taps", torch.float32, (W,), dev)
        _check(band.rot, "band.rot", torch.int32, (L,), dev)
        radius, lo, hi = band.radius, band.lo, band.hi
        if not (0 <= lo <= hi <= L and (lo == hi or (
                lo >= radius and hi + W - 1 - radius <= L))):
            raise ValueError(f"band interior [{lo}, {hi}) with radius "
                             f"{radius} and W={W} reads outside 0..{L}")
    halo = halo_width(band, periodic)
    if not any(cluster_fits(K, L, W, C, halo)
               for C in range(1, MAX_CLUSTER + 1)):
        raise ValueError(
            f"exclusion_multi_step: K·L = {K}·{L} (band W={W}, halo {halo}) "
            f"needs more shared memory than a cluster of up to "
            f"{MAX_CLUSTER} CTAs holds ({MAX_SMEM} bytes each)")
    if not (0 <= step0 and step0 + k_steps < 2 ** 31):
        raise ValueError(f"step0 out of range: {step0}")
    if not 0 <= b0 < 2 ** 31 - B:
        raise ValueError(f"b0 out of range: {b0}")
    plan = card_plan(B, K, L, band, periodic, dev.index or 0)
    return exclusion_multi_step_planned(plan, scalars, seeds, slots, band,
                                        **kw)


def card_plan(B: int, K: int, L: int, band: Optional[SmoothingBand],
              periodic: bool, device_index: int = 0,
              cluster: Optional[int] = None) -> ExclusionPlan:
    """``exclusion_launch_plan`` for this call on the card: its halo and
    band, the card's co-resident clusters; ``cluster`` forces C."""
    W = 0 if band is None else band.idx.shape[1]
    halo = halo_width(band, periodic)
    return exclusion_launch_plan(
        B, K, L, W, halo,
        exclusion_max_active_clusters(device_index, K, L, W, halo),
        cluster=cluster)


def _lib():
    lib = load_kernel_library("exclusion_multi_step")
    fn = lib.exclusion_multi_step_launch
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
                   + [ctypes.c_float] + [ctypes.c_int] * 5
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    occ = lib.exclusion_max_active_clusters
    occ.argtypes = [ctypes.c_int] * 7 + [ctypes.c_void_p]
    occ.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=64)
def exclusion_max_active_clusters(device_index: int, K: int, L: int, W: int,
                                  halo: int) -> dict:
    """{C: clusters of C CTAs the card holds at once for this call's shape
    (W = 0: global m) with every CTA on an SM of its own}, from
    ``cudaOccupancyMaxActiveClusters`` asked for CTAs whose shared memory
    leaves no room for a second (the kernel itself takes what its window
    needs); 0 where the cluster does not fit (``cluster_fits``) or cannot
    launch.  The GPCs decide what this seats: on an H100 clusters of 4
    seat 32, not 33."""
    lib = _lib()
    out = {}
    with torch.cuda.device(device_index):
        for C in range(1, MAX_CLUSTER + 1):
            out[C] = 0
            if not cluster_fits(K, L, W, C, halo):
                continue
            h = halo if C > 1 else 0
            cnt = ctypes.c_int(0)
            rc = lib.exclusion_max_active_clusters(
                K, L, W, C, h, cta_threads(L, C), int(W == 0),
                ctypes.byref(cnt))
            out[C] = cnt.value if rc == 0 else 0
    return out


def exclusion_multi_step_planned(plan: ExclusionPlan, scalars, seeds, slots,
                                 band: Optional[SmoothingBand] = None, *,
                                 k_steps: int, dt: float, periodic: bool,
                                 bidirectional: bool, step0: int = 0,
                                 b0: int = 0,
                                 noise: Optional[torch.Tensor] = None
                                 ) -> torch.Tensor:
    """``exclusion_multi_step`` on CUDA tensors under a given plan (the
    wrapper's own, or one that ``exclusion_launch_plan(..., cluster=C)``
    forces, to compare cluster sizes).  The inputs are checked by the
    wrapper; here only that the plan fits them."""
    B, K, L = slots.shape
    W = 0 if band is None else band.idx.shape[1]
    C = plan.cluster
    halo = halo_width(band, periodic)
    if plan.halo != (halo if C > 1 else 0) or not cluster_fits(
            K, L, W, C, halo) or plan.threads != cta_threads(L, C):
        raise ValueError(f"exclusion_multi_step: {plan} does not fit K={K}, "
                         f"L={L}, W={W}, halo {halo}")
    out = torch.empty_like(slots)
    stream = torch.cuda.current_stream(slots.device)
    exclusion_multi_step.launches += 1
    if exclusion_multi_step.events is not None:
        exclusion_multi_step.events.append(
            [torch.cuda.Event(enable_timing=True) for _ in range(2)])
        exclusion_multi_step.events[-1][0].record(stream)
    rc = _lib().exclusion_multi_step_launch(
        ptr(scalars), ptr(seeds), step0, b0, ptr(slots), ptr(out), ptr(noise),
        *(ptr(getattr(band, f) if band is not None else None)
          for f in ("idx", "w", "taps", "rot")),
        W, *((band.radius, band.lo, band.hi) if band is not None
             else (0, 0, 0)),
        B, K, L, k_steps, dt, int(periodic), int(bidirectional), C,
        plan.halo, plan.threads, ctypes.c_void_p(stream.cuda_stream))
    check_cuda(rc, "exclusion_multi_step")
    if exclusion_multi_step.events is not None:
        exclusion_multi_step.events[-1][1].record(stream)
    return out


# launches of the kernel; and, while ``events`` is a list, a pair of CUDA
# events around each launch (``pde_kernel.kernel_ms`` sums them) — off by
# default
exclusion_multi_step.launches = 0
exclusion_multi_step.events = None

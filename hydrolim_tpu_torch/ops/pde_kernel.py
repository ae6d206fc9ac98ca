"""Kernel B2: fused multi-step IMEX PDE solver with tracers.

``pde_multi_step`` advances k IMEX steps (fields + tracers + per-step
records) for B replicas.  On CUDA tensors it launches the hand-written
kernel (``csrc/pde_multi_step.cu``, the port of the TPU kernel
``hydrolim_tpu/ops/pallas_pde.py``); on CPU tensors it runs
``pde_multi_step_plain``, a loop of the ported magnetization,
``_tracer_update`` and ``pde_step`` with the kernel's record layout.

The kernel has two routes (``pde_route_plan`` picks one): a cluster of C
CTAs per replica with the fields in shared memory (``pde_launch_plan``),
wherever a cluster holds them, and past that G co-resident CTAs per
replica with the fields in device memory (``gmem_launch_plan``), up to the
card's free memory (``gmem_max_lattice``).  Both give the same values bit
for bit, except the full smoothing: on the device-memory route it is an
FFT convolution (``fft_plan``), which agrees with the cluster route's
direct circulant to float32 roundoff, and which m_mode 'smooth' takes
from ``SMOOTH_FFT_FROM`` sites on, where a cluster would fit too.

Modes, as in the TPU kernel:
- ``m_mode``: 'global' (one m per replica), 'pointwise', 'narrow' (the
  Gaussian's 2r+1 centre taps, ``SmoothOperands``) or 'smooth' (the full
  periodic circulant);
- the boundary (``periodic`` or Neumann walls) and the active model
  (``bidirectional`` or anchored_minus);
- ``solve_mode``: 'exact' (A·x = ρ solved exactly), 'banded' (the
  truncated taps of A⁻¹) or 'none' (γ = 0).

Layout: unpadded (B, L) fields, (B, n_t) tracers, (B, window, n_t) ring,
records (B, k, 4 + 2·kmax_rec) = [m_mean, Var, v_eff, D_eff, rfft re (k
bins), rfft im (k bins)] of the total density ÷ L.  The spectra are off
the steps' chain: each step stores its density row into a (B, k, L)
scratch and a second kernel (``pde_spectra``, ``csrc/pde_spectra.cu``)
computes every step's bins across the card right after; where that
scratch would pass ``SPECTRA_SCRATCH_BYTES`` the call runs as several
launches of fewer steps (``spectra_plan``), which give the same values
bit for bit.  ``interop`` converts the TPU kernel's padded lane
layouts.  Randomness is either injected (``noise``:
(B, k, 3, n_t) uint32 bits held in int32 — tracer flip, Box–Muller u2, u3)
or native: Philox4x32-10 in the kernel, key (seed, ``b0`` + replica),
counter (tracer, ``step0`` + step), so a launch of rows [b0, b0 + n) of a
batch draws what the launch of the whole batch draws for them; the plain
version draws from ``generator``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Mapping, Optional, Tuple

import numpy as np
import torch

from hydrolim_tpu_torch.core.config import PDEConfig, PDEParams
from hydrolim_tpu_torch.fields.magnetization import MFieldOp, pde_magnetization
from hydrolim_tpu_torch.ops._build import check_cuda, load_kernel_library, ptr
from hydrolim_tpu_torch.ops.convolve import banded_circular_conv
from hydrolim_tpu_torch.ops.diffusion import (
    DENSE_MAX_L,
    SpectralSolve,
    TridiagFactors,
    build_dense_inverse,
    spectral_solve,
    tridiag_factors,
)
from hydrolim_tpu_torch.ops.stepper_kernel import bits_to_uniform
from hydrolim_tpu_torch.pde.stepper import (
    PDEOps,
    TracerState,
    _tracer_update,
    pde_step,
)

SOURCE = "hydrolim_tpu_torch/csrc/pde_multi_step.cu"
REPLACES = "hydrolim_tpu/ops/pallas_pde.py:337"
SPECTRA_SOURCE = "hydrolim_tpu_torch/csrc/pde_spectra.cu"
SPECTRA_REPLACES = "hydrolim_tpu/ops/pallas_pde.py:288 (in :337)"
# The most bytes of one launch's (B, k, L) float32 density scratch; a call
# whose scratch would be larger runs in pieces of fewer steps.
SPECTRA_SCRATCH_BYTES = 256 << 20
SPECTRA_THREADS = 512         # threads of a block of the spectra kernel
SMEM_LIMIT = 232_448          # bytes of shared memory one block may use
KERNEL_THREADS = 1024         # the threads the circulant's law is cut for
KBLOCK = 9                    # sites per work unit of the blocked circulant
CLUSTER_SIZES = (1, 2, 4, 8, 16)  # CTAs per replica (16: non-portable)
SCAN_TILES = 16               # tiles of the exact solve's scan (at most)
GMEM_MAX_CTAS = 256           # CTAs per replica on the device-memory route
GMEM_MAX_SEG = 1 << 24        # sites per CTA on the device-memory route
GMEM_TILE = 8192              # sites of its circulant's tiles (at most)
GMEM_MAX_L = 1 << 30          # sites the kernel's int indexing allows
GMEM_M_MODES = ("global", "pointwise", "narrow", "smooth")
FFT_MAX_SUB = 8192            # points of a sub-transform, and of a unit
FFT_MAX_N = FFT_MAX_SUB ** 2  # the FFT stage's longest transform (2 passes)
FFT_PAD = 16                  # a unit's buffer skips 2 values every 32 (banks)
FFT_RUN = 16                  # columns a unit of passes 1 and 3 takes where
                              # it can: 128-byte runs of the complex scratch
FFT_MARKS = 12                # clock marks a CTA of the stage keeps (kMarks)
# The full Gaussian m's route line: from this many sites m_mode 'smooth'
# takes the device-memory route's FFT stage, below it the cluster route's
# direct circulant.  The measured crossover (PERF.md §6, B2's full
# smoothing by route; ``profile_pde_kernel.py --mode route-smooth``):
# from 4096 sites the stage wins at B = 2, 5 and 64, at 1000 and 2048 the
# circulant.
SMOOTH_FFT_FROM = 4096
_M_CODES = {"global": 0, "pointwise": 1, "narrow": 2, "smooth": 2}
_FFT_M_CODE = 3               # 'smooth' on the device-memory route
_SOLVE_CODES = {"none": 0, "exact": 1, "banded": 2}


def _half_taps(w: torch.Tensor) -> torch.Tensor:
    """(R+1,) float32 w(0..R) of centred symmetric taps (2R+1,)."""
    r = (w.shape[0] - 1) // 2
    return w[r:].to(torch.float32).contiguous()


@dataclasses.dataclass
class SolveOperands:
    """The implicit solve A·x = ρ.  'exact': each consumer builds the form
    it reads, once, at its first use — the plain version the dense inverse
    (``a_inv``; past ``DENSE_MAX_L`` sites the float64 FFT solve,
    ``spectral``), the kernel the tridiagonal factors (``factors``).
    'banded': ``weights``, the (2r+1,) symmetric taps of A⁻¹, w(d) at
    r + d."""

    L: int
    dx: float
    dt: float
    gamma: float
    periodic: bool
    device: torch.device
    weights: Optional[torch.Tensor] = None

    @functools.cached_property
    def a_inv(self) -> torch.Tensor:
        bc = "periodic" if self.periodic else "neumann"
        return build_dense_inverse(self.L, self.dx, self.dt, self.gamma, bc,
                                   self.device)

    @functools.cached_property
    def spectral(self) -> SpectralSolve:
        """The plain version's exact solve past ``DENSE_MAX_L``."""
        bc = "periodic" if self.periodic else "neumann"
        return spectral_solve(self.L, self.dx, self.dt, self.gamma, bc,
                              self.device)

    @functools.cached_property
    def factors(self) -> TridiagFactors:
        bc = "periodic" if self.periodic else "neumann"
        return tridiag_factors(self.L, self.dx, self.dt, self.gamma, bc,
                               self.device)

    @functools.cached_property
    def half_taps(self) -> torch.Tensor:
        """(r+1,) w(0..r) of the banded taps, the kernel's tap table."""
        return _half_taps(self.weights)


def build_solve_operands(L: int, dx: float, dt: float, gamma: float,
                         periodic: bool, solve_mode: str, device="cuda",
                         weights=None) -> Optional[SolveOperands]:
    """The solve of ``solve_mode``: 'exact', 'banded' (``weights``: the
    (2r+1,) taps, e.g. ``fast_solve.build_banded_solve_weights``) or
    'none' (γ = 0, the identity; returns None)."""
    if solve_mode == "none":
        return None
    if solve_mode not in ("exact", "banded"):
        raise ValueError(f"unknown solve_mode {solve_mode!r}")
    if solve_mode == "banded":
        if weights is None or not periodic:
            raise ValueError("solve_mode 'banded' needs its taps and a "
                             "periodic lattice")
        weights = torch.as_tensor(weights, dtype=torch.float32,
                                  device=device)
    return SolveOperands(L, dx, dt, gamma, periodic, torch.device(device),
                         weights)


@dataclasses.dataclass
class SmoothOperands:
    """The smoothing of m_mode 'narrow' — ``weights`` (2r+1,), w(d) at
    r + d — or 'smooth' — ``weights`` (L,), the periodic kernel k(j)
    (the circulant's first row)."""

    mode: str
    weights: torch.Tensor

    @functools.cached_property
    def kernel_rfft(self) -> torch.Tensor:
        """rfft of the circulant row, complex128 (the plain 'smooth')."""
        return torch.fft.rfft(self.weights.to(torch.float64))

    @functools.cached_property
    def half_taps(self) -> torch.Tensor:
        """(R+1,) float32 w(0..R) of the kernel's tap routine.  For the
        full circulant R = L//2; with L even, site x ± L/2 is one site, so
        its tap is halved: the pair adds it once, exactly."""
        if self.mode == "narrow":
            return _half_taps(self.weights)
        L = self.weights.shape[0]
        w = self.weights[:L // 2 + 1].to(torch.float32).clone()
        if L % 2 == 0:
            w[L // 2] *= 0.5
        return w.contiguous()

    @property
    def radius(self) -> int:
        return self.half_taps.shape[0] - 1

    def fft_spectrum(self, f: "FftPlan") -> torch.Tensor:
        """(n,) float32 real spectrum of the full circulant's taps on the
        FFT stage's transform (``fft_plan``), in the order its second pass
        reads: K[k1 + n1·k2] at k1·n2 + k2, computed in float64 from the
        half taps (kept on the operand)."""
        cache = self.__dict__.setdefault("_fft_spectrum", {})
        if (f.n1, f.n2) not in cache:
            t = self.half_taps.detach().cpu().numpy().astype(np.float64)
            cache[f.n1, f.n2] = torch.tensor(
                fft_spectrum_order(taps_spectrum(t, f.n), f),
                dtype=torch.float32, device=self.weights.device)
        return cache[f.n1, f.n2]


def build_smooth_operands(m_mode: str, weights,
                          device="cuda") -> Optional[SmoothOperands]:
    """The smoothing operand of ``m_mode`` ('narrow' or 'smooth'; None for
    'global' and 'pointwise')."""
    if m_mode in ("global", "pointwise"):
        return None
    if m_mode not in ("narrow", "smooth"):
        raise ValueError(f"unknown m_mode {m_mode!r}")
    return SmoothOperands(m_mode, torch.as_tensor(
        weights, dtype=torch.float32, device=device))


@dataclasses.dataclass(frozen=True)
class FftPlan:
    """The full circulant's FFT stage on the device-memory route: one
    complex transform of length ``n`` = ``n1``·``n2`` (powers of two, 2 ≤
    n1 ≤ n2 ≤ ``FFT_MAX_SUB``) in two passes, of the row ``num + i·den``
    wrapped by ``wrap`` sites on each side and padded with zeros; ``w1``
    columns (passes 1 and 3) and ``w2`` rows (pass 2) of sub-transforms a
    unit.  A CTA holds three unit buffers in shared memory: the next unit
    lands in one while the current one's steps go back and forth between
    the other two."""

    n: int
    n1: int
    n2: int
    wrap: int
    w1: int
    w2: int

    @property
    def buf(self) -> int:
        """Complex values of a unit."""
        return max(self.n1 * self.w1, self.n2 * self.w2)

    @property
    def unit(self) -> int:
        """Values of a unit's buffer: ``buf`` padded by 2 values every 32
        (one every ``FFT_PAD``), made even (16-byte aligned buffers)."""
        u = self.buf + self.buf // FFT_PAD
        return u + (u & 1)

    @property
    def smem(self) -> int:
        """Shared memory of the stage: three unit buffers."""
        return 3 * 8 * self.unit


def fft_plan(L: int, G: int) -> FftPlan:
    """The FFT stage of a row of L sites for G CTAs a replica.  A
    power-of-two L transforms at n = L (a circular convolution); any other
    L at the power of two n ≥ L + 2h, h = L//2, the row wrapped by h sites
    on each side: the taps centred (d = −h…h, the d = ±L/2 taps halved for
    an even L, as ``SmoothOperands.half_taps``), the convolution on n is
    the circular one on L in exact arithmetic.  n1, the columns' length, is
    G where n allows both passes a unit for each CTA with ``FFT_RUN``
    columns (n ≥ ``FFT_RUN``·G²), else as short as the rows' ``FFT_MAX_SUB``
    points allow (at least 2); n2 = n / n1.  A unit takes as many columns
    (rows) as give each CTA one, within ``FFT_MAX_SUB`` points.  Raises
    ValueError past n = ``FFT_MAX_N``, naming the largest L served."""
    if L & (L - 1) == 0:
        n, wrap = L, 0
    else:
        wrap = L // 2
        n = 1 << (L + 2 * wrap - 1).bit_length()
    if n > FFT_MAX_N:
        raise ValueError(
            f"pde_multi_step kernel, device-memory route: the full smoothing "
            f"at L={L} needs a transform of {n} points, more than the FFT "
            f"stage's {FFT_MAX_N} (two passes of {FFT_MAX_SUB}); the largest "
            f"L it serves is {FFT_MAX_N} (a power of two), else "
            f"{FFT_MAX_N // 2 - 1}")
    n1 = max(2, n // FFT_MAX_SUB, min(G, n // (FFT_RUN * G)))
    n2 = n // n1
    return FftPlan(n, n1, n2, wrap,
                   w1=min(n2, FFT_MAX_SUB // n1, max(1, n2 // G)),
                   w2=min(n1, FFT_MAX_SUB // n2, max(1, n1 // G)))


def taps_spectrum(half_taps: np.ndarray, n: int) -> np.ndarray:
    """(n,) float64 real DFT of the centred symmetric taps w(|d|), d =
    −h…h (``half_taps``: w(0..h)), placed circularly on n points."""
    h = half_taps.shape[0] - 1
    row = np.zeros(n)
    row[:h + 1] += half_taps
    if h:
        row[n - h:] += half_taps[1:][::-1]
    r = np.fft.rfft(row).real
    return np.concatenate([r, r[1:n - n // 2][::-1]])


def fft_spectrum_order(K: np.ndarray, f: FftPlan) -> np.ndarray:
    """A spectrum K[k] (k = k1 + n1·k2) in the second pass's order:
    K[k1 + n1·k2] at k1·n2 + k2."""
    return K.reshape(f.n2, f.n1).T.ravel()


def fft_radices(N: int) -> Tuple[int, ...]:
    """The radices of the stage's sub-transform of length N (a power of
    two), step by step: one radix 2 or 4 where log2 N is no multiple of 3,
    then radix 8 (so the last step, which writes device memory, holds the
    fewest items a thread)."""
    q, r = divmod(N.bit_length() - 1, 3)
    return ((1 << r,) if r else ()) + (8,) * q


def stockham_angles(N: int) -> np.ndarray:
    """(N − 1,) float64 angles of a length-N sub-transform's twiddles, step
    by step (``fft_radices``, p the product of the radices before the
    step): 2π·r·k / (p·R) at r-major (r − 1)·p + k, r = 1…R−1, k < p."""
    out, p = [], 1
    for R in fft_radices(N):
        rk = np.arange(1, R)[:, None] * np.arange(p)[None, :]
        out.append((rk / (p * R)).ravel() * (2.0 * np.pi))
        p *= R
    return np.concatenate(out) if out else np.zeros(0)


@functools.lru_cache(maxsize=4)
def _fft_twiddles(n1: int, n2: int, device: str) -> torch.Tensor:
    n = n1 * n2
    ang = np.concatenate([
        np.outer(np.arange(n1, dtype=np.float64),
                 np.arange(n2, dtype=np.float64)).ravel() * (2.0 * np.pi / n),
        stockham_angles(n2), stockham_angles(n1)])
    return torch.tensor(np.stack([np.cos(ang), -np.sin(ang)], -1),
                        dtype=torch.float32, device=device)


def fft_twiddles(f: FftPlan, device="cuda") -> torch.Tensor:
    """(n + n2 + n1 − 2, 2) float32 [re, im] twiddles of the FFT stage,
    computed in float64: W_n^(n2'·k1) = exp(−2πi·n2'·k1/n) at k1·n2 + n2'
    (the passes' order), then the Stockham steps' W_(pR)^(r·k) of the rows'
    length n2 and of the columns' length n1 (``stockham_angles``)."""
    return _fft_twiddles(f.n1, f.n2, str(torch.device(device)))


def tap_plan(L: int, R: int, avail_floats: int):
    """(nb, ns, length) of kernel B2's blocked circulant over taps 1..R:
    nb units of KBLOCK consecutive sites, ns slices of the taps of
    ``length`` taps each (a multiple of KBLOCK; the table is padded with
    zero taps to 1 + ns·length).  The slices fill the block's threads, as
    many as shared memory holds partial sums for (L floats each, out of
    ``avail_floats``), and as few as give each unit its fewest taps."""
    nb = -(-L // KBLOCK)
    chunks = -(-R // KBLOCK)
    if chunks == 0:
        return nb, 1, 0
    cap = max(1, min(KERNEL_THREADS // nb, avail_floats // L, chunks))
    per = -(-chunks // cap)
    ns = -(-chunks // per)
    return nb, ns, KBLOCK * per


def tap_law(L: int, R: int) -> Tuple[int, int]:
    """(ns, length) of kernel B2's circulant law over taps 1..R: the slices
    of ``tap_plan`` with no cap from shared memory, a function of L and R
    alone, so that every cluster size sums a site's taps in one order."""
    _, ns, length = tap_plan(L, R, KERNEL_THREADS * L)
    return ns, length


def padded_taps(half_taps: torch.Tensor, ns: int, length: int
                ) -> torch.Tensor:
    """The (R+1,) half taps padded with zeros to 1 + ns·length."""
    w = torch.zeros(1 + ns * length, dtype=torch.float32,
                    device=half_taps.device)
    w[:half_taps.shape[0]] = half_taps
    return w


def _kernel_taps(ops, ns: int, length: int) -> torch.Tensor:
    """``padded_taps`` of an operand's half taps, kept on the operand."""
    cache = ops.__dict__.setdefault("_kernel_taps", {})
    if (ns, length) not in cache:
        cache[ns, length] = padded_taps(ops.half_taps, ns, length)
    return cache[ns, length]


def lattice_pow2(L: int) -> int:
    """Lp: the lattice padded to a power of two, at least 32 (the sums'
    tree and the CTAs' segments are cut from it)."""
    return max(32, 1 << (L - 1).bit_length())


def scan_law(Lp: int) -> Tuple[int, int]:
    """(run, tiles) of the exact solve's scan on the padded lattice: at
    most ``SCAN_TILES`` tiles of 32 runs of ``run`` sites, on both
    routes at every CTA count."""
    tile = max(32, Lp // SCAN_TILES)
    return tile // 32, Lp // tile


@dataclasses.dataclass(frozen=True)
class CircStage:
    """One circulant of a CTA: its law (``ns`` slices of ``length`` taps,
    ``tap_law``) and its staging (``tb`` taps a pass, ``fp`` fields a
    group).  ns = 1, length = 0 where the call has no such circulant."""

    ns: int = 1
    length: int = 0
    tb: int = KBLOCK
    fp: int = 1

    @property
    def taps(self) -> int:
        return self.ns * self.length

    @property
    def direct(self) -> bool:
        """One pass of one slice: the chains need no partial sums."""
        return self.ns == 1 and self.tb >= self.taps


@dataclasses.dataclass(frozen=True)
class PDEPlan:
    """The launch of kernel B2: ``cluster`` CTAs per replica, each owning
    ``seg`` sites of the padded lattice (a power of two) and ``tseg``
    tracers; the exact solve's scan in ``tiles`` tiles of 32 runs of
    ``run`` sites; the two circulants (``smooth``, ``solve``) with their
    staging windows (``wf`` floats a field) and partial sums (``part``
    floats); ``smem`` bytes of shared memory per CTA; ``waves`` =
    ⌈B / co-resident clusters⌉."""

    cluster: int
    seg: int
    tseg: int
    run: int
    tiles: int
    smooth: CircStage
    solve: CircStage
    wf: int
    part: int
    smem: int
    waves: int = 1
    route: str = "cluster"

    @property
    def ctas(self) -> int:
        """CTAs per replica."""
        return self.cluster

    @property
    def tile(self) -> int:
        """Sites of the circulant's tiles: the whole segment."""
        return self.seg


@dataclasses.dataclass(frozen=True)
class GmemPlan:
    """The device-memory route of kernel B2: ``ctas`` (G) co-resident CTAs
    per replica, each owning ``seg`` sites of the padded lattice (a power
    of two) and ``tseg`` tracers, the fields in device memory; the exact
    solve's scan as the cluster route's (``tiles`` tiles of 32 runs of
    ``run`` sites); the circulants staged in ``tile``-site tiles of the
    segment (``wf`` floats a field, ``part`` floats of partial sums);
    ``smem`` bytes of shared memory per CTA; ``per_launch`` replicas a
    launch holds co-resident, ``waves`` = ⌈B / per_launch⌉ launches;
    ``fft``: the full smoothing's FFT stage (m_mode 'smooth', else
    None)."""

    ctas: int
    seg: int
    tseg: int
    run: int
    tiles: int
    smooth: CircStage
    solve: CircStage
    tile: int
    wf: int
    part: int
    smem: int
    per_launch: int = 1
    waves: int = 1
    route: str = "gmem"
    fft: Optional[FftPlan] = None


def cta_smem_bytes(seg: int, tseg: int, local_m: bool, taps: bool,
                   fp: int, wf: int, part: int) -> int:
    """Shared memory of one CTA (``csrc/pde_multi_step.cu``, in its
    order): the scan's 4 × 32 tile-total slots (16 B each), 7 × 32 warp
    totals and 8 published totals, the fields P, M, Q, N, m and the smoothed
    denominator (``seg`` floats each, the last two where used), the
    tracers' displacements (``tseg``), the staging windows (``wf`` floats
    for each of ``fp`` fields) and the partial sums."""
    floats = (7 * 32 + 8 + (4 + int(local_m) + int(taps)) * seg + tseg
              + fp * wf + part)
    return 16 * 4 * 32 + 4 * floats


def _staging(used: Mapping[str, Tuple[int, int]], fp: int, cap: int,
             span: int):
    """The circulants' stages at ``fp`` fields a group and at most ``cap``
    taps a pass, and their window and partial-sum floats for a tile of
    ``span`` sites: (stages, wf, part)."""
    st = {k: CircStage(ns, ln, max(KBLOCK, min(ns * ln, cap)), fp)
          for k, (ns, ln) in used.items()}
    tb = max((c.tb for c in st.values()), default=0)
    if not st:
        wf = 0
    elif all(c.tb >= c.taps for c in st.values()):
        wf = span + KBLOCK + 2 * tb      # one window a pass
    else:
        wf = 2 * (span + KBLOCK + tb)    # a left and a right region
    part = max((0 if c.direct else fp * c.ns * span
                for c in st.values()), default=0)
    return st, wf, part


def cta_layout(L: int, n_t: int, C: int, m_mode: str,
               circulants: Mapping[str, int],
               smem_limit: int = SMEM_LIMIT) -> Optional[PDEPlan]:
    """The layout of a cluster of C CTAs for one call, or None where it
    does not fit: each CTA 32 to 16,384 sites and none empty, the scan's
    tiles a multiple of C, and shared memory within ``smem_limit``.
    ``circulants`` maps 'smooth' / 'solve' to the radius of the call's
    circulants, whose laws are ``tap_law``'s.  The staging takes both
    fields and a pass of every tap where that fits, else one field at a
    time, else passes of fewer taps (halved down to ``KBLOCK``), which
    move no result.  A pass over
    taps (E0, E1] stages [lo − E1, hi + 9 + E1) when E0 = 0, else a left
    and a right region of seg + 9 + tb sites."""
    Lp = lattice_pow2(L)
    seg = Lp // C
    run, tiles = scan_law(Lp)
    if not 32 <= seg <= 16_384 or (C - 1) * seg >= L or tiles % C:
        return None
    tseg = max(1, (1 << (max(n_t, 1) - 1).bit_length()) // C)
    local_m, taps = m_mode != "global", m_mode in ("narrow", "smooth")
    used = {k: tap_law(L, R) for k, R in circulants.items()}
    top = max((ns * ln for ns, ln in used.values()), default=0)
    for fp in (2, 1):
        cap = max(KBLOCK, top)
        while True:
            st, wf, part = _staging(used, fp, cap, seg)
            smem = cta_smem_bytes(seg, tseg, local_m, taps, fp, wf, part)
            if smem <= smem_limit:
                return PDEPlan(C, seg, tseg, run, tiles,
                               st.get("smooth", CircStage()),
                               st.get("solve", CircStage()), wf, part,
                               smem)
            if cap <= KBLOCK:
                break
            cap = max(KBLOCK, (cap // 2) // KBLOCK * KBLOCK)
    return None


def call_circulants(L: int, m_mode: str, solve_mode: str,
                    smooth: Optional["SmoothOperands"],
                    solve: Optional["SolveOperands"]) -> dict:
    """The radii of a call's circulants: 'smooth' (the narrow taps or the
    full circulant's L//2) and 'solve' (the banded taps)."""
    out = {}
    if smooth is not None and m_mode in ("narrow", "smooth"):
        out["smooth"] = smooth.radius
    if solve is not None and solve_mode == "banded":
        out["solve"] = solve.half_taps.shape[0] - 1
    return out


def preferred_cluster(Lp: int, m_mode: str) -> int:
    """The cluster size the measured table favours (``profile_pde_kernel.py
    --mode cluster``, PERF.md §6): a CTA per 1024 sites of the padded
    lattice up to 8 CTAs, 16 past 16,384 sites; the full circulant, whose
    2·L² FMAs a step outweigh the cluster's barriers, four times as many
    (at most 16)."""
    C = 16 if Lp > 16_384 else max(1, min(8, Lp // 1024))
    return min(16, 4 * C) if m_mode == "smooth" else C


def pde_launch_plan(B: int, L: int, n_t: int, m_mode: str,
                    circulants: Mapping[str, int],
                    coresident: Mapping[int, int], *,
                    cluster: Optional[int] = None,
                    launchable: Optional[Mapping[int, int]] = None,
                    smem_limit: int = SMEM_LIMIT) -> PDEPlan:
    """The plan of one call.  ``coresident[C]`` is how many clusters of C
    CTAs (at C's layout, ``cta_layout``) the card holds at once (absent or
    0: cannot launch).  Among the C of ``CLUSTER_SIZES`` that fit, with
    the fewest waves, the largest up to ``preferred_cluster``, else the
    smallest.  ``cluster`` forces C.
    Raises ValueError where no C fits, naming the largest L this
    configuration serves (``pde_max_lattice`` over the C in
    ``launchable``, by default those in ``coresident``).  ``smem_limit``:
    the shared memory a CTA may use."""
    sizes = [cluster] if cluster else CLUSTER_SIZES
    lay = {C: cta_layout(L, n_t, C, m_mode, circulants, smem_limit)
           for C in sizes}
    ok = [C for C in sizes
          if lay[C] is not None and int(coresident.get(C, 0)) > 0]
    if not ok:
        top = pde_max_lattice(n_t, m_mode, circulants,
                              launchable or coresident, smem_limit)
        raise ValueError(
            f"pde_multi_step kernel: L={L}, n_t={n_t}, m_mode {m_mode!r} "
            f"fit no cluster of {list(sizes)} CTAs: it needs more than the "
            f"{smem_limit} B of shared memory a CTA may use; the largest L "
            f"this configuration serves on this card is {top}")
    waves = {C: -(-B // int(coresident[C])) for C in ok}
    fewest = min(waves.values())
    cands = [C for C in ok if waves[C] == fewest]
    below = [C for C in cands
             if C <= preferred_cluster(lattice_pow2(L), m_mode)]
    C = max(below) if below else min(cands)
    return dataclasses.replace(lay[C], waves=fewest)


def pde_max_lattice(n_t: int, m_mode: str, circulants: Mapping[str, int],
                    launchable: Mapping[int, int],
                    smem_limit: int = SMEM_LIMIT) -> int:
    """The largest L (a power of two) that a cluster of a size in
    ``launchable`` (non-zero: the card can launch it) serves for this
    configuration: the full circulant's radius grows with L (L//2), the
    narrow smoothing's and the banded solve's do not.  Past it the call
    takes the device-memory route, the full smoothing its FFT stage."""
    best, Lp = 0, 32
    while Lp <= 1 << 24:
        radii = dict(circulants)
        if m_mode == "smooth":
            radii["smooth"] = Lp // 2
        if not any(cta_layout(Lp, n_t, C, m_mode, radii, smem_limit)
                   is not None
                   and int(launchable.get(C, 0)) > 0
                   for C in CLUSTER_SIZES):
            break
        best, Lp = Lp, 2 * Lp
    return best


def gmem_smem_bytes(tseg: int, fp: int, wf: int, part: int,
                    fft: Optional[FftPlan] = None) -> int:
    """Shared memory of one CTA of the device-memory route
    (``csrc/pde_multi_step.cu`` ``gmem_steps``, in its order): 7 × 16 warp
    totals and the tracers' displacements, then the staging windows and
    the partial sums; with the FFT stage, from the next 16-byte boundary,
    its three unit buffers (``FftPlan.smem``), which the windows and
    partial sums share."""
    if fft is None:
        return 4 * (7 * 16 + tseg + fp * wf + part)
    return (-(-4 * (7 * 16 + tseg) // 16) * 16
            + max(fft.smem, 4 * (fp * wf + part)))


def gmem_layout(L: int, n_t: int, G: int, m_mode: str,
                circulants: Mapping[str, int],
                smem_limit: int = SMEM_LIMIT) -> Optional[GmemPlan]:
    """The layout of G CTAs of the device-memory route for one call, or
    None where it does not fit: a power of two G up to ``GMEM_MAX_CTAS``,
    each CTA 32 to ``GMEM_MAX_SEG`` sites, the m modes of
    ``GMEM_M_MODES``, and shared memory within ``smem_limit``.  The scan's
    tiles and the circulants' laws are the cluster route's; a circulant
    stages tiles of at most ``GMEM_TILE`` sites, fewer (halved down to 32)
    where its windows do not fit.  The full smoothing (m_mode 'smooth') is
    no circulant here but the FFT stage (``fft_plan``), whose ValueError
    past its reach this passes on."""
    Lp = lattice_pow2(L)
    if (G < 1 or G > GMEM_MAX_CTAS or G & (G - 1) or m_mode not in
            GMEM_M_MODES or not 32 <= Lp // G <= GMEM_MAX_SEG
            or L > GMEM_MAX_L):
        return None
    fft = None
    if m_mode == "smooth":
        fft = fft_plan(L, G)
        circulants = {k: R for k, R in circulants.items() if k != "smooth"}
    seg = Lp // G
    run, tiles = scan_law(Lp)
    tseg = max(1, (1 << (max(n_t, 1) - 1).bit_length()) // G)
    used = {k: tap_law(L, R) for k, R in circulants.items()}
    top = max((ns * ln for ns, ln in used.values()), default=0)
    T = min(seg, GMEM_TILE)
    while T >= 32:
        for fp in (2, 1):
            st, wf, part = _staging(used, fp, max(KBLOCK, top), T)
            smem = gmem_smem_bytes(tseg, fp, wf, part, fft)
            if smem <= smem_limit:
                return GmemPlan(G, seg, tseg, run, tiles,
                                st.get("smooth", CircStage()),
                                st.get("solve", CircStage()), T, wf, part,
                                smem, fft=fft)
        T //= 2
    return None


def gmem_launch_plan(B: int, L: int, n_t: int, m_mode: str,
                     circulants: Mapping[str, int], coresident_ctas, *,
                     ctas: Optional[int] = None,
                     smem_limit: int = SMEM_LIMIT) -> GmemPlan:
    """The device-memory route's plan of one call.  ``coresident_ctas``:
    the CTAs of this route the card holds at once, a number or a function
    of a CTA's shared-memory bytes (``gmem_max_ctas``).  G is the largest
    power of two with all B replicas' CTAs co-resident (B·G at most the
    card's), within the layout's bounds (``gmem_layout``), at least 1;
    replicas past one launch's co-resident CTAs run as further launches
    (``waves``).  ``ctas`` forces G.  Raises ValueError where no G fits,
    the FFT stage does not reach L, or the card holds not even one
    replica's CTAs."""
    co_of = (coresident_ctas if callable(coresident_ctas)
             else (lambda smem: int(coresident_ctas)))
    Lp = lattice_pow2(L)
    if ctas is None:
        top = min(GMEM_MAX_CTAS, max(1, Lp // 32))
        floor = max(1, -(-Lp // GMEM_MAX_SEG))
        G = top
        while G > floor:
            lay = gmem_layout(L, n_t, G, m_mode, circulants, smem_limit)
            if lay is not None and B * G <= co_of(lay.smem):
                break
            G //= 2
    else:
        G = ctas
    lay = gmem_layout(L, n_t, G, m_mode, circulants, smem_limit)
    if lay is None:
        raise ValueError(
            f"pde_multi_step kernel, device-memory route: L={L}, n_t={n_t}, "
            f"m_mode {m_mode!r} fits no layout of {G} CTAs a replica (m "
            f"modes {GMEM_M_MODES}, at most {GMEM_MAX_CTAS} CTAs of 32 to "
            f"{GMEM_MAX_SEG} sites, L at most {GMEM_MAX_L}, {smem_limit} B "
            "of shared memory a CTA)")
    co = int(co_of(lay.smem))
    if co < G:
        raise ValueError(
            f"pde_multi_step kernel, device-memory route: the card holds "
            f"{co} of its CTAs at once, fewer than the {G} of one replica")
    per = min(B, co // G)
    return dataclasses.replace(lay, per_launch=per, waves=-(-B // per))


def gmem_fields(m_mode: str, fft: bool) -> int:
    """Rows of a replica's device scratch on the device-memory route: the
    fields Q and N, m (a local m) and the smoothed denominator (the narrow
    smoothing; the FFT stage forms m in its last pass and keeps none)."""
    return 2 + int(m_mode != "global") + int(m_mode == "narrow" or (
        m_mode == "smooth" and not fft))


def gmem_call_bytes(plan: GmemPlan, B: int, L: int, n_t: int, window: int,
                    m_mode: str, kmax_rec: int, k_steps: int) -> int:
    """Device memory a call on the device-memory route allocates: the
    outputs (the two fields, the tracers and their ring, the records), the
    device scratch (``gmem_fields``; the published totals, the scan's tile
    totals and the arrival counters of one launch's replicas), the FFT
    stage's complex scratch (n·8 B for each of one launch's replicas),
    spectrum and twiddles, and the spectra's density scratch
    (``spectra_plan``)."""
    nfs = gmem_fields(m_mode, plan.fft is not None)
    per = plan.per_launch
    out = 4 * B * (2 * L + 2 * n_t + window * n_t + k_steps
                   * (4 + 2 * kmax_rec))
    scratch = 4 * per * (nfs * L + 3 * plan.ctas * 4 + 32) + 16 * per * 128
    f = plan.fft
    if f is not None:
        scratch += 8 * per * f.n + 4 * f.n + 8 * (f.n + f.n2 + f.n1 - 2)
    dens = 0
    if kmax_rec:
        sp = spectra_plan(B, k_steps, L, kmax_rec)
        dens = 4 * B * sp.piece * L
        if sp.scratch:
            dens += 4 * 2 * (L // sp.n1) * min(sp.n1, kmax_rec) * (
                -(-B * sp.piece // sp.rows_per_block) * sp.rows_per_block)
    return out + scratch + dens


def gmem_max_lattice(plan_of, B: int, n_t: int, window: int, m_mode: str,
                     kmax_rec: int, k_steps: int, mem_bytes: int) -> int:
    """The largest L whose call fits ``mem_bytes`` of device memory
    (``gmem_call_bytes`` under the plan ``plan_of(L)`` gives); 0 where
    none does.  The bytes grow with L, but for the full smoothing a power
    of two L transforms at n = L and L − 1 at 2L (``fft_plan``): so the
    bisection runs over odd L, then L + 1 and the powers of two above are
    tried."""
    def fits(L):
        if L < 3 or L > GMEM_MAX_L:
            return False
        plan = plan_of(L)
        return plan is not None and gmem_call_bytes(
            plan, B, L, n_t, window, m_mode, kmax_rec, k_steps) <= mem_bytes
    lo, hi = 0, (GMEM_MAX_L - 1) // 2            # odd L = 2i + 1
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if fits(2 * mid + 1):
            lo = mid
        else:
            hi = mid - 1
    best = 2 * lo + 1 if lo else 0
    if fits(best + 1):
        best += 1
    p = 1 << best.bit_length()
    while fits(p):
        best, p = p, 2 * p
    return best


def pde_route_plan(B: int, L: int, n_t: int, m_mode: str,
                   circulants: Mapping[str, int],
                   coresident: Mapping[int, int], coresident_ctas, *,
                   route: Optional[str] = None,
                   cluster: Optional[int] = None,
                   ctas: Optional[int] = None,
                   launchable: Optional[Mapping[int, int]] = None,
                   smem_limit: int = SMEM_LIMIT):
    """The route and plan of one call: the cluster route
    (``pde_launch_plan``) wherever a cluster fits, the device-memory route
    (``gmem_launch_plan``) past it; there the full smoothing (m_mode
    'smooth') is the FFT stage, which it takes from ``SMOOTH_FFT_FROM``
    sites on.  ``route`` ('cluster' or 'gmem') forces one; ``cluster`` /
    ``ctas`` force its C / G."""
    if route not in (None, "cluster", "gmem"):
        raise ValueError(f"pde_multi_step: unknown route {route!r}")
    kw = dict(smem_limit=smem_limit)
    if route == "gmem" or (route is None and m_mode == "smooth"
                           and L >= SMOOTH_FFT_FROM):
        return gmem_launch_plan(B, L, n_t, m_mode, circulants,
                                coresident_ctas, ctas=ctas, **kw)
    try:
        return pde_launch_plan(B, L, n_t, m_mode, circulants, coresident,
                               cluster=cluster, launchable=launchable, **kw)
    except ValueError:
        if route == "cluster" or m_mode not in GMEM_M_MODES:
            raise
    return gmem_launch_plan(B, L, n_t, m_mode, circulants, coresident_ctas,
                            ctas=ctas, **kw)


def _occupancy_fn():
    fn = load_kernel_library("pde_multi_step").pde_max_active_clusters
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=256)
def max_active_clusters(device_index: int, C: int, smem: int) -> int:
    """Clusters of C CTAs with ``smem`` bytes each the card holds at once
    (``cudaOccupancyMaxActiveClusters``; 0 where it cannot launch)."""
    cnt = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        rc = _occupancy_fn()(C, smem, ctypes.byref(cnt))
    return cnt.value if rc == 0 else 0


@functools.lru_cache(maxsize=256)
def gmem_max_ctas(device_index: int, smem: int) -> int:
    """CTAs of the device-memory route with ``smem`` bytes each the card
    holds at once (``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` times
    the SMs; 0 where it cannot launch)."""
    fn = load_kernel_library("pde_multi_step").pde_gmem_max_ctas
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    cnt = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        rc = fn(smem, ctypes.byref(cnt))
    return cnt.value if rc == 0 else 0


def card_coresident(device_index: int, L: int, n_t: int, m_mode: str,
                    circulants: Mapping[str, int]) -> dict:
    """{C: ``max_active_clusters`` at C's layout} for one call's
    configuration (0 where the layout does not fit)."""
    out = {}
    for C in CLUSTER_SIZES:
        lay = cta_layout(L, n_t, C, m_mode, circulants)
        out[C] = (max_active_clusters(device_index, C, lay.smem)
                  if lay is not None else 0)
    return out


@functools.lru_cache(maxsize=8)
def _trig_table(L: int, device: str) -> torch.Tensor:
    ang = 2.0 * np.pi * np.arange(L) / L
    return torch.tensor(np.stack([np.cos(ang), np.sin(ang)]),
                        dtype=torch.float32, device=device)


def trig_table(L: int, device="cuda") -> torch.Tensor:
    """(2, L) float32 [cos, sin](2π·j/L), computed in float64."""
    return _trig_table(L, str(torch.device(device)))


def m_field_of(m_mode: str, rho_p: torch.Tensor, rho_m: torch.Tensor,
               smooth: Optional[SmoothOperands] = None) -> torch.Tensor:
    """The magnetization field of a kernel m_mode: 'narrow' sums the 2r+1
    taps, 'smooth' the full circulant."""
    if m_mode in ("global", "pointwise"):
        op = MFieldOp(None) if m_mode == "global" else None
        return pde_magnetization(rho_p, rho_m, op, kernel_sigma=math.inf)
    num, den = rho_p - rho_m, rho_p + rho_m
    if m_mode == "narrow":
        both = banded_circular_conv(torch.stack([num, den], -2),
                                    smooth.weights)
        return both[..., 0, :] / (both[..., 1, :] + 1e-12)
    return pde_magnetization(rho_p, rho_m, MFieldOp(smooth.kernel_rfft),
                             kernel_sigma=0.0)


def box_muller(u2: torch.Tensor, u3: torch.Tensor) -> torch.Tensor:
    """The kernels' Box–Muller: u2 clamped at 1e-12, cos branch only."""
    u2 = torch.clamp(u2, min=1e-12)
    two_pi = torch.tensor(2.0 * np.pi, dtype=torch.float32, device=u3.device)
    return torch.sqrt(-2.0 * torch.log(u2)) * torch.cos(two_pi * u3)


def spectra_mats(L: int, kmax: int, device="cuda") -> torch.Tensor:
    """(2, L, kmax) float32 [cos, sin](2π·k·x/L) read from ``trig_table``
    at (k·x mod L), the kernel's indexing."""
    trig = trig_table(L, device)
    k = torch.arange(kmax, device=device)[None, :]
    idx = (torch.arange(L, device=device)[:, None] * k) % L
    return torch.stack([trig[0][idx], trig[1][idx]])


def _spectra(total: torch.Tensor, mats: torch.Tensor, L: int) -> torch.Tensor:
    """(B, 2·kmax) [re, im] of the first kmax rfft bins ÷ L (im = −Σ x·sin)."""
    inv_L = torch.tensor(1.0 / L, dtype=torch.float32, device=total.device)
    return torch.cat([(total @ mats[0]) * inv_L,
                      -(total @ mats[1]) * inv_L], dim=-1)


@dataclasses.dataclass(frozen=True)
class SpectraPlan:
    """How a call's spectra are computed: the DFT's split L = n1·n2 of the
    spectra kernel, its rows (steps) per block, and the steps per launch
    of the step kernel, whose density scratch must fit
    ``SPECTRA_SCRATCH_BYTES``.  ``stage``: the (2, L) table and the rows
    sit in a block's shared memory; else the kernel reads them through the
    read-only path, and with ``scratch`` keeps the stage-1 sums in device
    memory too."""

    n1: int
    rows_per_block: int
    piece: int
    stage: bool = True
    scratch: bool = False


def spectra_split(L: int) -> int:
    """n1 of the spectra kernel's split L = n1·n2: the smallest divisor of
    L at least √L (40 at L = 1000; L itself for a prime L, the direct
    sum)."""
    return L // max(d for d in range(1, math.isqrt(L) + 1) if L % d == 0)


def spectra_smem_bytes(L: int, kmax: int, n1: int, rows: int,
                       stage: bool = True, scratch: bool = False) -> int:
    """Shared memory of a block of the spectra kernel: the (2, L) table and
    ``rows`` density rows where staged, and the rows' stage-1 sums
    (n2·min(n1, kmax) complex values a row) unless in the scratch."""
    per = (L // n1) * min(n1, kmax)
    return 4 * ((2 * L + rows * L if stage else 0)
                + (0 if scratch else 2 * rows * per))


def spectra_plan(B: int, k_steps: int, L: int, kmax: int) -> SpectraPlan:
    """The spectra kernel's split (``spectra_split``) and rows per block
    (about one stage-1 sum per thread, at most 16 rows, within shared
    memory), staged where the table and a row fit a block (else read
    through L2, the stage-1 sums in shared memory where they fit, else in
    a device scratch), and the steps per launch of the step kernel: all
    of them while the (B, k, L) float32 scratch fits
    ``SPECTRA_SCRATCH_BYTES``, else as many as fit (at least one)."""
    n1 = spectra_split(L)
    per = (L // n1) * min(n1, kmax)
    piece = max(1, min(k_steps, SPECTRA_SCRATCH_BYTES // (4 * B * L)))
    top = max(1, min(16, SPECTRA_THREADS // per))
    for stage, scratch in ((True, False), (False, False), (False, True)):
        rows = top
        while rows > 1 and spectra_smem_bytes(L, kmax, n1, rows, stage,
                                              scratch) > SMEM_LIMIT:
            rows -= 1
        if spectra_smem_bytes(L, kmax, n1, rows, stage,
                              scratch) <= SMEM_LIMIT:
            return SpectraPlan(n1, rows, piece, stage, scratch)
    raise AssertionError("unreachable: the scratch route needs no shared "
                         "memory")


def pde_spectra_plain(dens: torch.Tensor, kmax: int) -> torch.Tensor:
    """Plain version of ``pde_spectra``: (..., L) densities → (..., 2·kmax)
    [re, im] of their first kmax rfft bins ÷ L."""
    L = dens.shape[-1]
    return _spectra(dens, spectra_mats(L, kmax, dens.device), L)


def pde_spectra(dens: torch.Tensor, recs: torch.Tensor, kmax: int) -> None:
    """Write the spectra of (B, k, L) float32 densities into columns 4.. of
    the (B, k, 4 + 2·kmax) records, in place.  On CUDA tensors the kernel
    (``csrc/pde_spectra.cu``); on CPU tensors ``pde_spectra_plain``."""
    B, k, L = dens.shape
    if dens.device.type == "cpu":
        recs[..., 4:] = pde_spectra_plain(dens, kmax)
        return
    if dens.device.type != "cuda":
        raise ValueError(f"pde_spectra: unsupported device {dens.device}")
    _check(dens, "dens", torch.float32, (B, k, L), dens.device)
    _check(recs, "recs", torch.float32, (B, k, 4 + 2 * kmax), dens.device)
    if not 1 <= kmax <= L // 2 + 1:
        raise ValueError(f"pde_spectra: kmax={kmax} with L={L}")
    plan = spectra_plan(B, k, L, kmax)
    ys = None
    if plan.scratch:
        blocks = -(-B * k // plan.rows_per_block)
        per = (L // plan.n1) * min(plan.n1, kmax)
        ys = torch.empty(blocks * plan.rows_per_block * 2 * per,
                         dtype=torch.float32, device=dens.device)
    fn = load_kernel_library("pde_spectra").pde_spectra_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(dens.device)
    pde_spectra.launches += 1
    if pde_spectra.events is not None:
        pde_spectra.events.append(
            [torch.cuda.Event(enable_timing=True) for _ in range(2)])
        pde_spectra.events[-1][0].record(stream)
    rc = fn(ptr(dens), ptr(trig_table(L, dens.device)), ptr(recs), ptr(ys),
            B * k, L, kmax, 4 + 2 * kmax, plan.n1, plan.rows_per_block,
            int(plan.stage), ctypes.c_void_p(stream.cuda_stream))
    check_cuda(rc, "pde_spectra")
    if pde_spectra.events is not None:
        pde_spectra.events[-1][1].record(stream)


# launches of the spectra kernel, and its events while a list (as
# ``pde_multi_step``'s)
pde_spectra.launches = 0
pde_spectra.events = None


def pde_multi_step_plain(scal, seeds, step0: int, rho_p, rho_m, pos, spin,
                         hist, solve: Optional[SolveOperands],
                         smooth: Optional[SmoothOperands] = None, *, L: int,
                         n_t: int, window: int, k_steps: int, dt: float,
                         xlim: float, periodic: bool, m_mode: str,
                         solve_mode: str, bidirectional: bool,
                         kmax_rec: int = 0, b0: int = 0,
                         noise: Optional[torch.Tensor] = None,
                         generator: Optional[torch.Generator] = None):
    """Plain PyTorch version of ``pde_multi_step`` (same arguments and
    returns).  ``seeds`` and ``b0`` select the kernel's native stream and
    are not used here; without ``noise`` the draws come from
    ``generator``."""
    del seeds, b0
    config = PDEConfig(L=L, xlim=xlim, dt=dt,
                       bc="periodic" if periodic else "neumann",
                       active_model=("bidirectional" if bidirectional
                                     else "anchored_minus"))
    params = PDEParams(beta=scal[:, 0], lam=scal[:, 1], gamma=scal[:, 2])
    if solve_mode == "exact" and L > DENSE_MAX_L:
        ops = PDEOps("spectral", a_inv=solve.spectral)
    elif solve_mode == "exact":
        ops = PDEOps("dense", a_inv=solve.a_inv)
    elif solve_mode == "banded":
        ops = PDEOps("banded", banded_w=solve.weights)
    else:
        ops = PDEOps("identity")
    tr = TracerState(pos=torch.remainder(pos, xlim), unwrapped=pos,
                     spin=spin.to(torch.int32), hist=hist)
    inv_L = torch.tensor(1.0 / L, dtype=torch.float32, device=rho_p.device)
    mats = spectra_mats(L, kmax_rec, rho_p.device) if kmax_rec > 0 else None
    recs = []
    for s in range(k_steps):
        n = step0 + s
        m = m_field_of(m_mode, rho_p, rho_m, smooth)
        den = rho_p + rho_m
        m_mean = m[:, 0] if m_mode == "global" else m.mean(-1)
        t_mean = den.sum(-1, keepdim=True) * inv_L
        var = ((den - t_mean) ** 2).sum(-1) * inv_L
        if noise is not None:
            u = bits_to_uniform(noise[:, s])               # (B, 3, n_t)
            inject = (u[:, 0], box_muller(u[:, 1], u[:, 2]))
        else:
            inject = None
        tr, v_eff, D_eff = _tracer_update(config, params, m, tr, n,
                                          generator=generator,
                                          _inject=inject)
        row = torch.stack([m_mean, var, v_eff, D_eff], dim=-1)
        if kmax_rec > 0:
            row = torch.cat([row, _spectra(den, mats, L)], dim=-1)
        recs.append(row)
        rho_p, rho_m = pde_step(config, params, ops, rho_p, rho_m, m=m)
    return (rho_p, rho_m, tr.unwrapped, tr.spin.to(torch.float32), tr.hist,
            torch.stack(recs, dim=1))


def _check(t, name, dtype, shape, device):
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(
            f"{name}: want a contiguous {dtype} tensor of shape {shape} on "
            f"{device}, got {t.dtype} {tuple(t.shape)} on {t.device} "
            f"(contiguous={t.is_contiguous()})")


def pde_multi_step(scal, seeds, step0: int, rho_p, rho_m, pos, spin, hist,
                   solve: Optional[SolveOperands],
                   smooth: Optional[SmoothOperands] = None, *, L: int,
                   n_t: int, window: int, k_steps: int, dt: float,
                   xlim: float, periodic: bool, m_mode: str, solve_mode: str,
                   bidirectional: bool,
                   kmax_rec: int = 0, b0: int = 0,
                   noise: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None,
                   route: Optional[str] = None):
    """Advance k IMEX steps (fields + tracers).

    Args:
      scal: (B, 4) float32 [β, λ, γ, 0] per replica.
      seeds: (B,) int32 Philox seeds (native mode).
      step0: global index of the chunk's first step (ring slot, window
        validity, native-mode counter).
      rho_p / rho_m: (B, L) float32.  pos: (B, n_t) float32 unwrapped
        tracer positions.  spin: (B, n_t) float32 ±1.
      hist: (B, window, n_t) float32 circular unwrapped buffer.
      solve: ``build_solve_operands`` for ``solve_mode`` ('exact',
        'banded' or 'none').
      smooth: ``build_smooth_operands`` for ``m_mode`` 'narrow' or
        'smooth' (None otherwise).
      kmax_rec: rfft bins recorded per step (any number up to L//2 + 1).
      b0: global index of the first replica (native-mode key).
      noise: optional (B, k_steps, 3, n_t) int32 random bits.
      route: the kernel's route on the card, 'cluster' or 'gmem' (None:
        ``pde_route_plan``'s choice); the plain version has one.

    Returns (rho_p, rho_m, pos, spin, hist, recs), recs
    (B, k_steps, 4 + 2·kmax_rec) float32 with NaN v/D before the first full
    window."""
    args = (scal, seeds, step0, rho_p, rho_m, pos, spin, hist, solve, smooth)
    kw = dict(L=L, n_t=n_t, window=window, k_steps=k_steps, dt=dt,
              xlim=xlim, periodic=periodic, m_mode=m_mode,
              solve_mode=solve_mode, bidirectional=bidirectional,
              kmax_rec=kmax_rec, b0=b0, noise=noise, generator=generator)
    if rho_p.device.type == "cpu":
        return pde_multi_step_plain(*args, **kw)
    if rho_p.device.type != "cuda":
        raise ValueError(f"pde_multi_step: unsupported device {rho_p.device}")
    del kw["generator"]                    # the kernel draws natively
    return pde_multi_step_planned(None, *args, route=route, **kw)


@functools.lru_cache(maxsize=256)
def card_plan(device_index: int, B: int, L: int, n_t: int, m_mode: str,
              circulants: tuple, route: Optional[str] = None):
    """``pde_route_plan`` on the card (``circulants``: the sorted items of
    ``call_circulants``): the co-resident clusters and CTAs from the
    card's occupancy queries."""
    circ = dict(circulants)
    return pde_route_plan(
        B, L, n_t, m_mode, circ,
        card_coresident(device_index, L, n_t, m_mode, circ),
        functools.partial(gmem_max_ctas, device_index), route=route,
        launchable={C: max_active_clusters(device_index, C, SMEM_LIMIT)
                    for C in CLUSTER_SIZES})


def check_gmem_memory(plan: GmemPlan, free_bytes: int, *, B: int, L: int,
                      n_t: int, window: int, m_mode: str, circulants,
                      kmax_rec: int, k_steps: int, coresident_ctas) -> None:
    """Raise ValueError, before any launch, where a call on the
    device-memory route needs more than ``free_bytes`` of device memory,
    naming the largest L this configuration serves with them
    (``gmem_max_lattice``)."""
    need = gmem_call_bytes(plan, B, L, n_t, window, m_mode, kmax_rec,
                           k_steps)
    if need <= free_bytes:
        return

    def plan_of(L2):
        try:
            return gmem_launch_plan(B, L2, n_t, m_mode, circulants,
                                    coresident_ctas)
        except ValueError:
            return None
    top = gmem_max_lattice(plan_of, B, n_t, window, m_mode, kmax_rec,
                           k_steps, free_bytes)
    raise ValueError(
        f"pde_multi_step kernel, device-memory route: L={L} at B={B} needs "
        f"{need} B of device memory, more than the {free_bytes} B free; "
        f"the largest L this configuration serves with them is {top}")


def _check_call(scal, seeds, step0, rho_p, rho_m, pos, spin, hist, solve,
                smooth, *, L, n_t, window, k_steps, m_mode, solve_mode,
                kmax_rec, b0, noise):
    """The kernel's checks of one call's modes, operands and tensors."""
    if m_mode not in _M_CODES or solve_mode not in _SOLVE_CODES:
        raise ValueError(f"pde_multi_step: m_mode {m_mode!r}, solve_mode "
                         f"{solve_mode!r}")
    if (smooth is None) != (m_mode in ("global", "pointwise")) or (
            smooth is not None and smooth.mode != m_mode):
        raise ValueError(f"m_mode {m_mode!r} needs its SmoothOperands")
    if (solve is None) != (solve_mode == "none") or (
            solve_mode == "banded" and solve.weights is None):
        raise ValueError(f"solve_mode {solve_mode!r} needs its "
                         "SolveOperands")
    B = rho_p.shape[0]
    dev = rho_p.device
    _check(scal, "scal", torch.float32, (B, 4), dev)
    _check(seeds, "seeds", torch.int32, (B,), dev)
    for name, t in (("rho_p", rho_p), ("rho_m", rho_m)):
        _check(t, name, torch.float32, (B, L), dev)
    for name, t in (("pos", pos), ("spin", spin)):
        _check(t, name, torch.float32, (B, n_t), dev)
    _check(hist, "hist", torch.float32, (B, window, n_t), dev)
    if noise is not None:
        _check(noise, "noise", torch.int32, (B, k_steps, 3, n_t), dev)
    if L < 3 or n_t < 1 or window < 1 or not 0 <= step0 < 2 ** 31 - k_steps \
            or not 0 <= kmax_rec <= L // 2 + 1 or not 0 <= b0 < 2 ** 31 - B:
        raise ValueError(f"pde_multi_step: L={L}, n_t={n_t}, "
                         f"window={window}, step0={step0}, "
                         f"kmax_rec={kmax_rec}, b0={b0}")
    if solve_mode == "exact":
        _check(solve.factors.scan, "scan factors", torch.float64, (4, L),
               dev)
    for name, ops in (("solve", solve if solve_mode == "banded" else None),
                      ("smooth", smooth)):
        if ops is None:
            continue
        t = ops.half_taps
        _check(t, f"{name} taps", torch.float32, (t.shape[0],), dev)
        if 2 * (t.shape[0] - 1) > L:
            raise ValueError(f"{name} taps: radius {t.shape[0] - 1} > L/2")


def _launch_fn():
    fn = load_kernel_library("pde_multi_step").pde_multi_step_launch
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p] * 24 + [ctypes.c_int] * 33
                   + [ctypes.c_float] * 7 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def pde_multi_step_planned(plan, scal, seeds, step0: int, rho_p, rho_m,
                           pos, spin, hist,
                           solve: Optional[SolveOperands],
                           smooth: Optional[SmoothOperands] = None, *,
                           L: int, n_t: int, window: int, k_steps: int,
                           dt: float, xlim: float, periodic: bool,
                           m_mode: str, solve_mode: str,
                           bidirectional: bool, kmax_rec: int = 0,
                           b0: int = 0,
                           noise: Optional[torch.Tensor] = None,
                           route: Optional[str] = None):
    """``pde_multi_step`` on CUDA tensors under a given plan: the card's
    (``card_plan``, on ``route`` where given) where ``plan`` is None, or
    one that ``pde_launch_plan(..., cluster=C)`` or ``gmem_launch_plan(...,
    ctas=G)`` forces, to compare cluster sizes and routes.  A plan of the
    device-memory route runs ⌈B / per_launch⌉ launches, each over its
    replicas' rows."""
    _check_call(scal, seeds, step0, rho_p, rho_m, pos, spin, hist, solve,
                smooth, L=L, n_t=n_t, window=window, k_steps=k_steps,
                m_mode=m_mode, solve_mode=solve_mode, kmax_rec=kmax_rec,
                b0=b0, noise=noise)
    B, dev = rho_p.shape[0], rho_p.device
    circ = call_circulants(L, m_mode, solve_mode, smooth, solve)
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if plan is None:
        plan = card_plan(idx, B, L, n_t, m_mode, tuple(sorted(circ.items())),
                         route)
    gmem = plan.route == "gmem"
    if gmem:
        lay = gmem_layout(L, n_t, plan.ctas, m_mode, circ)
        fits = lay is not None and dataclasses.replace(
            plan, per_launch=1, waves=1) == lay and 1 <= plan.per_launch
        check_gmem_memory(plan, torch.cuda.mem_get_info(dev)[0], B=B, L=L,
                          n_t=n_t, window=window, m_mode=m_mode,
                          circulants=circ, kmax_rec=kmax_rec,
                          k_steps=k_steps, coresident_ctas=functools.partial(
                              gmem_max_ctas, idx))
    else:
        lay = cta_layout(L, n_t, plan.cluster, m_mode, circ)
        fits = lay is not None and dataclasses.replace(plan, waves=1) == lay
    if not fits:
        raise ValueError(f"pde_multi_step: a plan for {plan} does not fit "
                         f"L={L}, n_t={n_t}, m_mode {m_mode!r}")
    fac = solve.factors if solve_mode == "exact" else None
    fft = plan.fft if gmem else None
    taps = {"solve": (_kernel_taps(solve, plan.solve.ns, plan.solve.length)
                      if solve_mode == "banded" else None),
            "smooth": (_kernel_taps(smooth, plan.smooth.ns,
                                    plan.smooth.length)
                       if smooth is not None and fft is None else None)}
    fn = _launch_fn()
    sp = spectra_plan(B, k_steps, L, kmax_rec) if kmax_rec else None
    piece = sp.piece if sp else k_steps
    dens = (torch.empty(B * piece * L, dtype=torch.float32, device=dev)
            if sp else None)
    per = plan.per_launch if gmem else B
    g = None
    if gmem:   # one launch's device scratch, reused launch after launch
        nfs = gmem_fields(m_mode, fft is not None)
        g = dict(fld=torch.empty((per, nfs, L), dtype=torch.float32,
                                 device=dev),
                 pub=torch.empty((per, 3, plan.ctas, 4), dtype=torch.float32,
                                 device=dev),
                 tt=torch.empty((per, 128, 2), dtype=torch.float64,
                                device=dev),
                 bar=torch.zeros((per, 32), dtype=torch.int32, device=dev))
        g.update(tw=None, spec=None, fft=None, trace=None)
        if fft is not None:             # the full smoothing's FFT stage
            g.update(tw=fft_twiddles(fft, dev),
                     spec=smooth.fft_spectrum(fft),
                     fft=torch.empty((per, fft.n, 2), dtype=torch.float32,
                                     device=dev))
            if pde_multi_step.fft_trace is not None:
                g["trace"] = torch.zeros((per, plan.ctas, FFT_MARKS),
                                         dtype=torch.int64, device=dev)
    m_code = _FFT_M_CODE if fft is not None else _M_CODES[m_mode]
    stream = torch.cuda.current_stream(dev)
    if pde_multi_step.events is not None:
        pde_multi_step.events.append(
            [torch.cuda.Event(enable_timing=True) for _ in range(2)])
        pde_multi_step.events[-1][0].record(stream)
    sm, sv = plan.smooth, plan.solve
    state, parts = (rho_p, rho_m, pos, spin, hist), []
    for s0 in range(0, k_steps, piece):            # one piece unless the
        kp = min(piece, k_steps - s0)              # scratch is too large
        outs = [torch.empty_like(t) for t in state]
        recs = torch.empty((B, kp, 4 + 2 * kmax_rec), dtype=torch.float32,
                           device=dev)
        d = dens[:B * kp * L].view(B, kp, L) if sp else None
        nz = (noise if noise is None or kp == k_steps
              else noise[:, s0:s0 + kp].contiguous())
        for r0 in range(0, B, per):                # a launch's replicas
            nb = min(per, B - r0)
            rows = slice(r0, r0 + nb)
            if g is not None:
                g["bar"].zero_()
                if g["trace"] is not None:
                    g["trace"].zero_()
            pde_multi_step.launches += 1
            pde_multi_step.route_launches[plan.route] += 1
            pde_multi_step.fft_launches += fft is not None
            rc = fn(ptr(scal[rows]), ptr(seeds[rows]), step0 + s0, b0 + r0,
                    *[ptr(t[rows]) for t in state],
                    *[ptr(t[rows]) for t in outs], ptr(recs[rows]),
                    ptr(fac.scan if fac is not None else None),
                    ptr(taps["solve"]), ptr(taps["smooth"]),
                    ptr(d[rows] if d is not None else None),
                    ptr(nz[rows] if nz is not None else None),
                    *[ptr(g[k] if g else None) for k in (
                        "fld", "pub", "tt", "bar", "tw", "spec", "fft",
                        "trace")],
                    nb, L, n_t, window, kp, kmax_rec, m_code,
                    _SOLVE_CODES[solve_mode], int(gmem), plan.ctas,
                    plan.seg, plan.tseg, plan.run, plan.tiles, sm.ns,
                    sm.length, sm.tb, sm.fp, sv.ns, sv.length, sv.tb, sv.fp,
                    plan.wf, plan.tile, plan.smem,
                    *((fft.n1, fft.n2, fft.w1, fft.w2, fft.wrap, fft.buf)
                      if fft is not None else (0,) * 6), int(periodic),
                    int(bidirectional), dt, xlim / L, xlim,
                    0.0 if fac is None else fac.v_last,
                    0.0 if fac is None else fac.fac, window * dt,
                    2.0 * window * dt, ctypes.c_void_p(stream.cuda_stream))
            check_cuda(rc, "pde_multi_step")
            if pde_multi_step.m_fields is not None and g is not None \
                    and m_mode != "global":
                pde_multi_step.m_fields.append(g["fld"][:nb, 2].clone())
            if g is not None and g["trace"] is not None:
                pde_multi_step.fft_trace.append(g["trace"][:nb].clone())
        if d is not None:
            pde_spectra(d, recs, kmax_rec)
        state = outs
        parts.append(recs)
    if pde_multi_step.events is not None:      # the steps and their spectra
        pde_multi_step.events[-1][1].record(stream)
    pde_multi_step.last_plan = plan
    return (*state, parts[0] if len(parts) == 1 else torch.cat(parts, 1))


# launches of the kernel, in all and by route ('cluster', 'gmem'), and of
# the device-memory route's FFT-stage kernel (m_mode 'smooth'); the plan
# of the last call; while ``events`` is a list, a pair of CUDA events
# around each call (``kernel_ms`` sums them); and while ``m_fields`` is a
# list, a copy of each device-memory launch's m field (its replicas' rows,
# m_mode not 'global') as its last step read it; while ``fft_trace`` is a
# list, each FFT-stage launch's (replicas, G, ``FFT_MARKS``) int64 clock
# marks, summed over its steps (csrc/pde_multi_step.cu ``FftTrace``: each
# pass's first landing and work, the barriers after passes 1 and 2, the
# reduction of m, the whole step, the steps) — all off by default
pde_multi_step.launches = 0
pde_multi_step.route_launches = {"cluster": 0, "gmem": 0}
pde_multi_step.fft_launches = 0
pde_multi_step.last_plan = None
pde_multi_step.events = None
pde_multi_step.m_fields = None
pde_multi_step.fft_trace = None


def reset_launches() -> None:
    """Set kernel B2's and its spectra kernel's launch counters to 0."""
    pde_multi_step.launches = pde_spectra.launches = 0
    pde_multi_step.fft_launches = 0
    pde_multi_step.route_launches = {"cluster": 0, "gmem": 0}


def kernel_ms(events) -> float:
    """Device time in ms of the launches timed in ``events`` (waits for
    the card)."""
    torch.cuda.synchronize()
    return float(sum(a.elapsed_time(b) for a, b in events))

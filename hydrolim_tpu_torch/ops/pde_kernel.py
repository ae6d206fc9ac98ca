"""Kernel B2: fused multi-step IMEX PDE solver with tracers.

``pde_multi_step`` advances k IMEX steps (fields + tracers + per-step
records) for B replicas.  On CUDA tensors it launches the hand-written
kernel (``csrc/pde_multi_step.cu``, the port of the TPU kernel
``hydrolim_tpu/ops/pallas_pde.py``); on CPU tensors it runs
``pde_multi_step_plain``, a loop of the ported magnetization,
``_tracer_update`` and ``pde_step`` with the kernel's record layout.

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
from typing import Optional

import numpy as np
import torch

from hydrolim_tpu_torch.core.config import PDEConfig, PDEParams
from hydrolim_tpu_torch.fields.magnetization import MFieldOp, pde_magnetization
from hydrolim_tpu_torch.ops._build import check_cuda, load_kernel_library, ptr
from hydrolim_tpu_torch.ops.convolve import banded_circular_conv
from hydrolim_tpu_torch.ops.diffusion import (
    TridiagFactors,
    build_dense_inverse,
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
KERNEL_THREADS = 1024         # one block per replica
KBLOCK = 9                    # sites per work unit of the blocked circulant
_M_CODES = {"global": 0, "pointwise": 1, "narrow": 2, "smooth": 2}
_SOLVE_CODES = {"none": 0, "exact": 1, "banded": 2}


def _half_taps(w: torch.Tensor) -> torch.Tensor:
    """(R+1,) float32 w(0..R) of centred symmetric taps (2R+1,)."""
    r = (w.shape[0] - 1) // 2
    return w[r:].to(torch.float32).contiguous()


@dataclasses.dataclass
class SolveOperands:
    """The implicit solve A·x = ρ.  'exact': each consumer builds the form
    it reads, once, at its first use — the plain version the dense inverse
    (``a_inv``), the kernel the tridiagonal factors (``factors``).
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
    ``SPECTRA_SCRATCH_BYTES``."""

    n1: int
    rows_per_block: int
    piece: int


def spectra_split(L: int) -> int:
    """n1 of the spectra kernel's split L = n1·n2: the smallest divisor of
    L at least √L (40 at L = 1000; L itself for a prime L, the direct
    sum)."""
    return next(d for d in range(math.isqrt(L - 1) + 1, L + 1) if L % d == 0)


def spectra_smem_bytes(L: int, kmax: int, n1: int, rows: int) -> int:
    """Shared memory of a block of the spectra kernel: the (2, L) table,
    ``rows`` density rows and their stage-1 sums (n2·min(n1, kmax) complex
    values a row)."""
    per = (L // n1) * min(n1, kmax)
    return 4 * (2 * L + rows * (L + 2 * per))


def spectra_plan(B: int, k_steps: int, L: int, kmax: int) -> SpectraPlan:
    """The spectra kernel's split (``spectra_split``) and rows per block
    (about one stage-1 sum per thread, at most 16 rows, within shared
    memory), and the steps per launch of the step kernel: all of them
    while the (B, k, L) float32 scratch fits ``SPECTRA_SCRATCH_BYTES``,
    else as many as fit (at least one)."""
    n1 = spectra_split(L)
    per = (L // n1) * min(n1, kmax)
    rows = max(1, min(16, SPECTRA_THREADS // per))
    while rows > 1 and spectra_smem_bytes(L, kmax, n1, rows) > SMEM_LIMIT:
        rows -= 1
    piece = max(1, min(k_steps, SPECTRA_SCRATCH_BYTES // (4 * B * L)))
    return SpectraPlan(n1, rows, piece)


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
    smem = spectra_smem_bytes(L, kmax, plan.n1, plan.rows_per_block)
    if smem > SMEM_LIMIT:
        raise ValueError(f"pde_spectra: L={L}, kmax={kmax} need {smem} B of "
                         f"shared memory per block, more than {SMEM_LIMIT}")
    fn = load_kernel_library("pde_spectra").pde_spectra_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(dens.device)
    pde_spectra.launches += 1
    if pde_spectra.events is not None:
        pde_spectra.events.append(
            [torch.cuda.Event(enable_timing=True) for _ in range(2)])
        pde_spectra.events[-1][0].record(stream)
    rc = fn(ptr(dens), ptr(trig_table(L, dens.device)), ptr(recs), B * k, L,
            kmax, 4 + 2 * kmax, plan.n1, plan.rows_per_block,
            ctypes.c_void_p(stream.cuda_stream))
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
    if solve_mode == "exact":
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
                   generator: Optional[torch.Generator] = None):
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
    lib = load_kernel_library("pde_multi_step")
    lib.pde_multi_step_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.pde_multi_step_smem_bytes.restype = ctypes.c_size_t
    smem = lib.pde_multi_step_smem_bytes(L, n_t, int(m_mode != "global"), 0)
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"pde_multi_step kernel: L={L}, n_t={n_t}, m_mode {m_mode!r} "
            f"need {smem} B of shared memory per replica "
            f"({5 if m_mode != 'global' else 4}·L + n_t floats), more than "
            f"the {SMEM_LIMIT} B a block may use")
    fac = solve.factors if solve_mode == "exact" else None
    if fac is not None:
        _check(fac.scan, "scan factors", torch.float64, (4, L), dev)
    avail = (SMEM_LIMIT - smem) // 4
    plans, taps = {}, {}
    for name, ops in (("solve", solve if solve_mode == "banded" else None),
                      ("smoothing", smooth)):
        if ops is None:
            plans[name], taps[name] = (0, 1, 0), None
            continue
        t = ops.half_taps
        _check(t, f"{name} taps", torch.float32, (t.shape[0],), dev)
        if 2 * (t.shape[0] - 1) > L:
            raise ValueError(f"{name} taps: radius {t.shape[0] - 1} > L/2")
        plans[name] = tap_plan(L, t.shape[0] - 1, avail)
        taps[name] = _kernel_taps(ops, *plans[name][1:])
    part_floats = max(ns * L if ns > 1 else 0
                      for _, ns, _ in plans.values())
    sp = spectra_plan(B, k_steps, L, kmax_rec) if kmax_rec else None
    piece = sp.piece if sp else k_steps
    dens = (torch.empty(B * piece * L, dtype=torch.float32, device=dev)
            if sp else None)
    fn = lib.pde_multi_step_launch
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p] * 16 + [ctypes.c_int] * 17
                   + [ctypes.c_float] * 7 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(dev)
    if pde_multi_step.events is not None:
        pde_multi_step.events.append(
            [torch.cuda.Event(enable_timing=True) for _ in range(2)])
        pde_multi_step.events[-1][0].record(stream)
    state, parts = (rho_p, rho_m, pos, spin, hist), []
    for s0 in range(0, k_steps, piece):            # one piece unless the
        kp = min(piece, k_steps - s0)              # scratch is too large
        outs = [torch.empty_like(t) for t in state]
        recs = torch.empty((B, kp, 4 + 2 * kmax_rec), dtype=torch.float32,
                           device=dev)
        d = dens[:B * kp * L].view(B, kp, L) if sp else None
        nz = (noise if noise is None or kp == k_steps
              else noise[:, s0:s0 + kp].contiguous())
        pde_multi_step.launches += 1
        rc = fn(ptr(scal), ptr(seeds), step0 + s0, b0,
                *[ptr(t) for t in state], *[ptr(t) for t in outs],
                ptr(recs), ptr(fac.scan if fac is not None else None),
                ptr(taps["solve"]), ptr(taps["smoothing"]), ptr(d), ptr(nz),
                B, L, n_t, window, kp, kmax_rec, _M_CODES[m_mode],
                _SOLVE_CODES[solve_mode], *plans["smoothing"],
                *plans["solve"], part_floats, int(periodic),
                int(bidirectional), dt, xlim / L, xlim,
                0.0 if fac is None else fac.v_last,
                0.0 if fac is None else fac.fac, window * dt,
                2.0 * window * dt, ctypes.c_void_p(stream.cuda_stream))
        check_cuda(rc, "pde_multi_step")
        if d is not None:
            pde_spectra(d, recs, kmax_rec)
        state = outs
        parts.append(recs)
    if pde_multi_step.events is not None:      # the steps and their spectra
        pde_multi_step.events[-1][1].record(stream)
    return (*state, parts[0] if len(parts) == 1 else torch.cat(parts, 1))


# launches of the kernel; and, while ``events`` is a list, a pair of CUDA
# events around each launch (``kernel_ms`` sums them) — off by default
pde_multi_step.launches = 0
pde_multi_step.events = None


def kernel_ms(events) -> float:
    """Device time in ms of the launches timed in ``events`` (waits for
    the card)."""
    torch.cuda.synchronize()
    return float(sum(a.elapsed_time(b) for a, b in events))

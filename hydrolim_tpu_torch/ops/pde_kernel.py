"""Kernel B2: fused multi-step IMEX PDE solver with tracers.

``pde_multi_step`` advances k IMEX steps (fields + tracers + per-step
records) for B replicas.  On CUDA tensors it launches the hand-written
kernel (``csrc/pde_multi_step.cu``, the port of the TPU kernel
``hydrolim_tpu/ops/pallas_pde.py``); on CPU tensors it runs
``pde_multi_step_plain``, a loop of the ported ``magnetization``,
``_tracer_update`` and ``pde_step`` with the kernel's record layout.

Layout: unpadded (B, L) fields, (B, n_t) tracers, (B, window, n_t) ring,
records (B, k, 4 + 2·kmax_rec) = [m_mean, Var, v_eff, D_eff, rfft re (k
bins), rfft im (k bins)] of the total density ÷ L.  ``interop`` converts the
TPU kernel's padded lane layouts.  Randomness is either injected (``noise``:
(B, k, 3, n_t) uint32 bits held in int32 — tracer flip, Box–Muller u2, u3)
or native: Philox4x32-10 in the kernel, key (seed, replica), counter
(tracer, ``step0`` + step); the plain version draws from ``generator``.

The kernel covers the global magnetization, the periodic lattice, the
bidirectional model and the exact solve ('exact') or none; it raises
``NotImplementedError`` for the other modes of the TPU kernel.
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
from hydrolim_tpu_torch.fields.magnetization import pde_magnetization
from hydrolim_tpu_torch.ops._build import check_cuda, load_kernel_library, ptr
from hydrolim_tpu_torch.ops.diffusion import (
    CyclicTridiagFactors,
    build_dense_inverse,
    cyclic_tridiag_factors,
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
MAX_KMAX_REC = 62
_SMEM_LIMIT = 227 * 1024


@dataclasses.dataclass
class SolveOperands:
    """The implicit solve A·x = ρ of solve_mode 'exact'.  Each consumer
    builds the form it reads, once, at its first use: the plain version the
    dense inverse (``a_inv``), the kernel the cyclic tridiagonal factors
    (``factors``, periodic only)."""

    L: int
    dx: float
    dt: float
    gamma: float
    periodic: bool
    device: torch.device

    @functools.cached_property
    def a_inv(self) -> torch.Tensor:
        bc = "periodic" if self.periodic else "neumann"
        return build_dense_inverse(self.L, self.dx, self.dt, self.gamma, bc,
                                   self.device)

    @functools.cached_property
    def factors(self) -> CyclicTridiagFactors:
        return cyclic_tridiag_factors(self.L, self.dx, self.dt, self.gamma,
                                      self.device)


def build_solve_operands(L: int, dx: float, dt: float, gamma: float,
                         periodic: bool, solve_mode: str,
                         device="cuda") -> Optional[SolveOperands]:
    """The solve of ``solve_mode``: 'exact' (A·x = ρ solved exactly) or
    'none' (γ = 0, the identity; returns None)."""
    if solve_mode == "none":
        return None
    if solve_mode != "exact":
        raise NotImplementedError(f"solve_mode {solve_mode!r} is not ported")
    return SolveOperands(L, dx, dt, gamma, periodic, torch.device(device))


def trig_table(L: int, device="cuda") -> torch.Tensor:
    """(2, L) float32 [cos, sin](2π·j/L), computed in float64."""
    ang = 2.0 * np.pi * np.arange(L) / L
    return torch.tensor(np.stack([np.cos(ang), np.sin(ang)]),
                        dtype=torch.float32, device=device)


def m_field_of(m_mode: str, rho_p: torch.Tensor,
               rho_m: torch.Tensor) -> torch.Tensor:
    """The magnetization field of a kernel m_mode ('global' | 'pointwise')."""
    if m_mode not in ("global", "pointwise"):
        raise NotImplementedError(f"m_mode {m_mode!r} is not ported")
    return pde_magnetization(rho_p, rho_m, m_mode == "global",
                             kernel_sigma=math.inf)


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


def pde_multi_step_plain(scal, seeds, step0: int, rho_p, rho_m, pos, spin,
                         hist, solve: Optional[SolveOperands], *, L: int,
                         n_t: int, window: int, k_steps: int, dt: float,
                         xlim: float, periodic: bool, m_mode: str,
                         solve_mode: str, bidirectional: bool,
                         kmax_rec: int = 0,
                         noise: Optional[torch.Tensor] = None,
                         generator: Optional[torch.Generator] = None):
    """Plain PyTorch version of ``pde_multi_step`` (same arguments and
    returns).  ``seeds`` select the kernel's native stream and are not
    used here; without ``noise`` the draws come from ``generator``."""
    del seeds
    config = PDEConfig(L=L, xlim=xlim, dt=dt,
                       bc="periodic" if periodic else "neumann",
                       active_model=("bidirectional" if bidirectional
                                     else "anchored_minus"))
    params = PDEParams(beta=scal[:, 0], lam=scal[:, 1], gamma=scal[:, 2])
    ops = PDEOps("dense", solve.a_inv) if solve_mode == "exact" \
        else PDEOps("identity")
    tr = TracerState(pos=torch.remainder(pos, xlim), unwrapped=pos,
                     spin=spin.to(torch.int32), hist=hist)
    inv_L = torch.tensor(1.0 / L, dtype=torch.float32, device=rho_p.device)
    mats = spectra_mats(L, kmax_rec, rho_p.device) if kmax_rec > 0 else None
    recs = []
    for s in range(k_steps):
        n = step0 + s
        m = m_field_of(m_mode, rho_p, rho_m)
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
                   solve: Optional[SolveOperands], *, L: int, n_t: int,
                   window: int, k_steps: int, dt: float, xlim: float,
                   periodic: bool, m_mode: str, solve_mode: str,
                   bidirectional: bool,
                   kmax_rec: int = 0, noise: Optional[torch.Tensor] = None,
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
      solve: ``build_solve_operands`` for ``solve_mode`` ('exact' or
        'none').
      noise: optional (B, k_steps, 3, n_t) int32 random bits.

    Returns (rho_p, rho_m, pos, spin, hist, recs), recs
    (B, k_steps, 4 + 2·kmax_rec) float32 with NaN v/D before the first full
    window."""
    args = (scal, seeds, step0, rho_p, rho_m, pos, spin, hist, solve)
    kw = dict(L=L, n_t=n_t, window=window, k_steps=k_steps, dt=dt,
              xlim=xlim, periodic=periodic, m_mode=m_mode,
              solve_mode=solve_mode, bidirectional=bidirectional,
              kmax_rec=kmax_rec, noise=noise, generator=generator)
    if rho_p.device.type == "cpu":
        return pde_multi_step_plain(*args, **kw)
    if rho_p.device.type != "cuda":
        raise ValueError(f"pde_multi_step: unsupported device {rho_p.device}")
    for what, ok in (("m_mode", m_mode == "global"),
                     ("boundary", periodic),
                     ("active model", bidirectional),
                     ("solve_mode", solve_mode in ("exact", "none"))):
        if not ok:
            raise NotImplementedError(
                f"pde_multi_step kernel: {what} not ported (m_mode="
                f"{m_mode!r}, periodic={periodic}, bidirectional="
                f"{bidirectional}, solve_mode={solve_mode!r})")
    if not 0 <= kmax_rec <= MAX_KMAX_REC:
        raise NotImplementedError(f"kmax_rec {kmax_rec} > {MAX_KMAX_REC}")
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
    if L < 3 or n_t < 1 or window < 1 or not 0 <= step0 < 2 ** 31 - k_steps:
        raise ValueError(f"pde_multi_step: L={L}, n_t={n_t}, "
                         f"window={window}, step0={step0}")
    fac = None
    if solve_mode == "exact":
        if solve is None:
            raise ValueError("solve_mode 'exact' needs its SolveOperands")
        fac = solve.factors
        _check(fac.rows, "factors", torch.float32, (3, L), dev)
    lib = load_kernel_library("pde_multi_step")
    lib.pde_multi_step_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.pde_multi_step_smem_bytes.restype = ctypes.c_size_t
    smem = lib.pde_multi_step_smem_bytes(L, n_t, kmax_rec)
    if smem > _SMEM_LIMIT:
        raise NotImplementedError(
            f"pde_multi_step kernel: L={L}, n_t={n_t} need {smem} B of "
            "shared memory")
    trig = trig_table(L, dev) if kmax_rec > 0 else None
    outs = [torch.empty_like(t) for t in (rho_p, rho_m, pos, spin, hist)]
    recs = torch.empty((B, k_steps, 4 + 2 * kmax_rec), dtype=torch.float32,
                       device=dev)
    fn = lib.pde_multi_step_launch
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int]
                   + [ctypes.c_void_p] * 14 + [ctypes.c_int] * 6
                   + [ctypes.c_float] * 7 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    pde_multi_step.launches += 1
    rc = fn(ptr(scal), ptr(seeds), step0, ptr(rho_p), ptr(rho_m), ptr(pos),
            ptr(spin), ptr(hist), *[ptr(t) for t in outs], ptr(recs),
            ptr(fac.rows if fac is not None else None), ptr(trig),
            ptr(noise), B, L, n_t, window, k_steps, kmax_rec, dt, xlim / L,
            fac.c if fac else 0.0, fac.v_last if fac else 0.0,
            fac.fac if fac else 0.0, window * dt, 2.0 * window * dt,
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    check_cuda(rc, "pde_multi_step")
    return (*outs, recs)


pde_multi_step.launches = 0

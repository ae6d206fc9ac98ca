"""IMEX stepper for the hydrodynamic-limit PDE, batched over replicas.

- implicit diffusion: exact or banded solve (``ops.diffusion``),
- explicit upwind advection,
- Curie–Weiss reaction with clipped rates,
- positivity clip + total-mass renormalization,
- tracer ensemble (CW flips, Euler–Maruyama) with windowed v_eff/D_eff
  from a circular displacement buffer.

Fields are (B, L) float32; per-replica parameters are (B,) tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from hydrolim_tpu_torch.core.config import PDEConfig, PDEParams
from hydrolim_tpu_torch.parallel import draws
from hydrolim_tpu_torch.fields.magnetization import (
    MFieldOp,
    build_mfield_op,
    pde_magnetization,
)
from hydrolim_tpu_torch.ops.diffusion import (
    banded_kernel,
    build_dense_inverse,
    diffusion_solve,
)


@dataclasses.dataclass
class PDEOps:
    """Per-config operators: the solve kind ('identity' | 'dense' |
    'banded' | 'banded_dct') with its operand (the dense inverse, or the
    banded taps), and the smoothing operand of the magnetization (None
    without a Gaussian kernel)."""

    kind: str
    a_inv: Optional[torch.Tensor] = None
    banded_w: Optional[torch.Tensor] = None
    smooth: Optional[MFieldOp] = None

    @property
    def solve_operand(self):
        return self.banded_w if self.kind.startswith("banded") else self.a_inv


def build_smooth_op(config: PDEConfig, device="cuda") -> Optional[MFieldOp]:
    """The magnetization's smoothing operand: None without a kernel, an
    empty operand above the global sentinel, else the periodic kernel's
    rfft."""
    if not config.gaussian_kernel:
        return None
    if config.kernel_sigma > 1e5:
        return MFieldOp(None)
    return build_mfield_op(config.L, config.dx, config.kernel_sigma, True,
                           device)


def build_pde_ops(config: PDEConfig, gamma: float, device="cuda") -> PDEOps:
    """Every exact solver kind of the JAX package ('fft', 'dct', 'dense')
    solves the same linear system: the port applies its dense inverse.  The
    banded kinds apply the truncated taps of ``banded_kernel``."""
    kind = config.solver_kind
    smooth = build_smooth_op(config, device)
    if kind == "identity" or float(gamma) == 0.0:
        return PDEOps("identity", smooth=smooth)
    if kind in ("banded", "banded_dct"):
        w = torch.tensor(banded_kernel(config.dx, config.dt, gamma),
                         device=device)
        return PDEOps(kind, banded_w=w, smooth=smooth)
    return PDEOps("dense", build_dense_inverse(config.L, config.dx, config.dt,
                                               gamma, config.bc, device),
                  smooth=smooth)


def _col(v, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32,
                           device=like.device).reshape(-1, 1)


def cw_rate(sigma, m, beta):
    """Curie–Weiss flip rate with the reference's clipping."""
    return torch.clamp(torch.exp(-beta * sigma * m), 1e-8, 1e8)


def upwind_derivative(rho: torch.Tensor, direction: int, dx: float,
                      bc: str) -> torch.Tensor:
    """One-sided difference along the trailing axis."""
    if direction > 0:          # right-moving: backward difference
        d = (rho - torch.roll(rho, 1, dims=-1)) / dx
        if bc == "neumann":
            d[..., 0] = 0.0
    else:                      # left-moving: forward difference
        d = (torch.roll(rho, -1, dims=-1) - rho) / dx
        if bc == "neumann":
            d[..., -1] = 0.0
    return d


def magnetization(config: PDEConfig, ops: PDEOps, rho_p, rho_m):
    smooth = ops.smooth if config.gaussian_kernel else None
    return pde_magnetization(rho_p, rho_m, smooth,
                             kernel_sigma=config.kernel_sigma)


def pde_update(config: PDEConfig, params: PDEParams, ops: PDEOps,
               rho_p: torch.Tensor, rho_m: torch.Tensor, m=None):
    """The IMEX step before its mass renormalization: ``(rho_p1, rho_m1,
    rho_p2, rho_m2)``, the fields after the implicit diffusion and after
    advection, reaction and the positivity clip."""
    dt, dx, bc = config.dt, config.dx, config.bc
    if m is None:
        m = magnetization(config, ops, rho_p, rho_m)
    lam, beta = _col(params.lam, rho_p), _col(params.beta, rho_p)

    rho_p1 = diffusion_solve(ops.solve_operand, rho_p, ops.kind)
    rho_m1 = diffusion_solve(ops.solve_operand, rho_m, ops.kind)

    R_p = cw_rate(-1.0, m, beta) * rho_m1 - cw_rate(+1.0, m, beta) * rho_p1
    if config.active_model == "bidirectional":
        adv_p = -lam * upwind_derivative(rho_p1, +1, dx, bc)
        adv_m = +lam * upwind_derivative(rho_m1, -1, dx, bc)
        rho_p2 = torch.clamp(rho_p1 + dt * (adv_p + R_p), min=0.0)
        rho_m2 = torch.clamp(rho_m1 + dt * (adv_m - R_p), min=0.0)
    else:  # anchored_minus: reaction first, then advection of rho_p only
        rho_p_star = torch.clamp(rho_p1 + dt * R_p, min=0.0)
        rho_m2 = torch.clamp(rho_m1 - dt * R_p, min=0.0)
        adv_p = -lam * upwind_derivative(rho_p_star, +1, dx, bc)
        rho_p2 = torch.clamp(rho_p_star + dt * adv_p, min=0.0)
    return rho_p1, rho_m1, rho_p2, rho_m2


def pde_step(config: PDEConfig, params: PDEParams, ops: PDEOps,
             rho_p: torch.Tensor, rho_m: torch.Tensor, m=None):
    """One IMEX step.  ``m`` is the magnetization of the pre-step
    densities (computed if not given)."""
    rho_p1, rho_m1, rho_p2, rho_m2 = pde_update(config, params, ops, rho_p,
                                                rho_m, m)
    # mass renormalization against the post-diffusion mass
    M0 = (rho_p1 + rho_m1).sum(-1, keepdim=True)
    M1 = (rho_p2 + rho_m2).sum(-1, keepdim=True)
    scale = M0 / torch.clamp(M1, min=1e-30)
    return rho_p2 * scale, rho_m2 * scale


def pde_halo(config: PDEConfig, ops: PDEOps) -> int:
    """Halo columns a window of the PDE step needs on each side: the
    banded solve's radius, plus 1 for the upwind difference.  A 'space'
    split runs periodic fields with pointwise m and the banded or no
    solve, as the JAX package's large-lattice driver does (a dense solve
    couples every site to every other)."""
    if (config.bc != "periodic" or config.gaussian_kernel
            or ops.kind not in ("banded", "identity")):
        raise ValueError(
            "a 'space'-split PDE step takes periodic fields, pointwise m "
            f"and the banded or no solve (got bc={config.bc!r}, "
            f"gaussian_kernel={config.gaussian_kernel}, solve {ops.kind!r})")
    r = 0 if ops.kind == "identity" else (ops.banded_w.shape[0] - 1) // 2
    return r + 1


# ---------------------------------------------------------------------------
# tracers and records
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TracerState:
    pos: torch.Tensor          # (B, n_t) wrapped position in [0, xlim)
    unwrapped: torch.Tensor    # (B, n_t)
    spin: torch.Tensor         # (B, n_t) int32 ±1
    hist: torch.Tensor         # (B, window, n_t) circular unwrapped buffer


@dataclasses.dataclass
class PDERecord:
    """Per-step observables, leading axes (B, n_records)."""

    m_mean: torch.Tensor
    var: torch.Tensor
    fft_ri: torch.Tensor       # (..., kmax, 2) re/im of rfft(total)/L
    v_eff: torch.Tensor
    D_eff: torch.Tensor


@dataclasses.dataclass
class PDESolveResult:
    rho_p: torch.Tensor
    rho_m: torch.Tensor
    records: PDERecord
    snapshots: torch.Tensor    # (B, n_snap, L) total density
    m_snapshots: torch.Tensor  # (B, n_snap, L) rho_p - rho_m
    snap_times: torch.Tensor   # (B, n_snap)


def _tracer_update(config: PDEConfig, params: PDEParams, m_field,
                   tr: TracerState, n: int,
                   generator: Optional[torch.Generator] = None,
                   _inject=None) -> Tuple[TracerState, torch.Tensor,
                                          torch.Tensor]:
    """CW spin flips + Euler–Maruyama advance + windowed v/D at iteration
    ``n``; the window is the ring buffer's length.

    ``_inject``: optional ``(flip_u, z)`` — (B, n_t) float32 flip uniforms
    and standard normals replacing the draws from ``generator``.

    The slot about to be overwritten, ``hist[n % window]``, holds the
    position ``window`` iterations ago, so it is read before the write."""
    dt, dx, L = config.dt, config.dx, config.L
    window = tr.hist.shape[-2]
    beta, lam = _col(params.beta, m_field), _col(params.lam, m_field)
    gamma = _col(params.gamma, m_field)

    idx = (tr.pos / dx).to(torch.int64) % L
    m_loc = torch.gather(m_field, -1, idx)
    rate = cw_rate(tr.spin.to(torch.float32), m_loc, beta)
    if _inject is None:
        flip_u = draws.rand(tr.pos.shape, generator, tr.pos.device)
        z = draws.randn(tr.pos.shape, generator, tr.pos.device)
    else:
        flip_u, z = _inject
    flip = flip_u < rate * dt
    spin = torch.where(flip, -tr.spin, tr.spin)

    v_loc = lam * spin.to(torch.float32)
    noise = torch.sqrt(2.0 * gamma * dt) * z
    unwrapped = tr.unwrapped + v_loc * dt + noise
    pos = torch.remainder(unwrapped, config.xlim)

    slot = n % window
    old = tr.hist[:, slot]
    hist = tr.hist.clone()
    hist[:, slot] = unwrapped
    dr = unwrapped - old
    mean_dr = dr.mean(-1)
    var_dr = ((dr - mean_dr[:, None]) ** 2).mean(-1)
    nan = torch.full_like(mean_dr, float("nan"))
    valid = n >= window
    v_eff = mean_dr / (window * dt) if valid else nan
    D_eff = var_dr / (2.0 * window * dt) if valid else nan
    return (TracerState(pos=pos, unwrapped=unwrapped, spin=spin, hist=hist),
            v_eff, D_eff)

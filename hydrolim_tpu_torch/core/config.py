"""Config dataclasses of the PyTorch port.

``ParticleConfig`` and ``PDEConfig`` are copies of the JAX package's frozen
dataclasses (``hydrolim_tpu/core/config.py``), field for field, so a config
built for one package describes the same run in the other.  They are
copied, not imported: importing anything under ``hydrolim_tpu`` imports
``jax``.

The runtime parameter records are small dataclasses of torch tensors (the
JAX package's ``NamedTuple`` pytrees); rates are stored post
``scale_rates`` exactly as there.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch



def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# ---------------------------------------------------------------------------
# Particle engine
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ParticleConfig:
    """Static configuration of the microscopic particle engine (same fields
    and defaults as the JAX package's ``ParticleConfig``)."""

    L: int = 1000
    xlim: float = 1.0
    init: str = "fixed"                      # 'fixed' | 'poisson'
    N: int = 1000                            # particle budget (fixed buffer)
    scale_rates: bool = True
    local_kernel_sigma: float = 0.005        # <=0 -> global magnetization
    periodic: bool = False
    minus_anchor: bool = True                # API parity only (a no-op)
    immobilize_when_anchored: bool = True
    anchor_positions: Optional[Tuple[float, ...]] = None
    anchor_radius: float = 0.005
    site_capacity: Optional[int] = 1         # None -> no exclusion (K = inf)
    crowding_suppresses_rates: bool = False
    suppress_flip_when_bound: bool = True
    active_model: str = "plus_forward"       # | 'bidirectional'
    dt: Optional[float] = None               # None -> auto from rate bound
    max_event_prob: float = 0.10             # tau-leap bias knob: max R_i*dt
    n_pad: Optional[int] = None              # particle buffer size (>= N)
    exit_buffer: int = 0                     # capacity of the exit-event log
    flip_rate_fn: Optional[Callable] = None  # (sigma, m, beta) -> rate; default CW

    def __post_init__(self):
        assert self.init in ("fixed", "poisson")
        assert self.active_model in ("plus_forward", "bidirectional")
        if self.site_capacity is not None and self.init == "fixed":
            assert self.N <= self.site_capacity * self.L, (
                "N exceeds lattice capacity")

    @property
    def dx(self) -> float:
        return self.xlim / self.L

    @property
    def exclusion(self) -> bool:
        return self.site_capacity is not None

    @property
    def K(self) -> int:
        return self.site_capacity if self.site_capacity is not None else 2**30

    @property
    def n_buf(self) -> int:
        if self.n_pad is not None:
            assert self.n_pad >= self.N
            return self.n_pad
        slack = 1.25 if self.init == "poisson" else 1.0
        return _round_up(max(int(np.ceil(self.N * slack)), 8), 8)

    @property
    def n_exit_buf(self) -> int:
        return max(self.exit_buffer, 8)

    @property
    def sigma_grid(self) -> float:
        return self.local_kernel_sigma / self.dx

    def anchor_mask(self) -> np.ndarray:
        mask = np.zeros(self.L, dtype=bool)
        if self.anchor_positions is None:
            return mask
        apos = np.asarray(self.anchor_positions, dtype=float)
        idxs = np.unique(np.round((apos / self.xlim) * (self.L - 1)).astype(int))
        r_idx = int(np.ceil(self.anchor_radius / self.dx))
        for a in idxs:
            lo = max(0, a - r_idx)
            hi = min(self.L - 1, a + r_idx)
            mask[lo:hi + 1] = True
        return mask


@dataclasses.dataclass
class ParticleParams:
    """Runtime parameters of the particle engine: float32 tensors, scalar or
    with a leading batch axis."""

    beta: torch.Tensor
    rate_diffusion: torch.Tensor
    rate_active: torch.Tensor
    k_on: torch.Tensor
    k_off: torch.Tensor
    k_exit: torch.Tensor


def make_particle_params(
    config: ParticleConfig,
    *,
    beta: float,
    rate_diffusion: float,
    rate_active: float,
    k_on: float = 0.1,
    k_off: float = 0.01,
    k_exit: float = 0.0,
    device="cuda",
) -> ParticleParams:
    if config.scale_rates:
        rate_diffusion = rate_diffusion / config.dx ** 2
        rate_active = rate_active / config.dx
    as_t = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
    return ParticleParams(
        beta=as_t(beta),
        rate_diffusion=as_t(rate_diffusion),
        rate_active=as_t(rate_active),
        k_on=as_t(k_on),
        k_off=as_t(k_off),
        k_exit=as_t(k_exit),
    )


def auto_dt(config: ParticleConfig, params: ParticleParams,
            beta_max: Optional[float] = None) -> float:
    """Δt keeping the per-particle per-step event probability below
    ``config.max_event_prob``: the total-rate bound is
    ``2·r_diff + r_act + flip_max + k_on + k_off + k_exit``.  For the
    default Curie–Weiss flip rate flip_max is exp(|β|); a custom
    ``config.flip_rate_fn`` (a torch callable ``(σ, m, β) → rate``) is
    probed over σ = ±1, m ∈ linspace(−1, 1, 201) and every |β| of the
    batch (and ``beta_max``), as the JAX package does."""
    get = lambda v: float(torch.max(torch.as_tensor(v)).item())
    b = beta_max if beta_max is not None else get(params.beta)
    if config.flip_rate_fn is not None:
        betas = np.unique(np.abs(np.asarray(
            torch.as_tensor(params.beta).detach().cpu(), np.float64)).ravel())
        if beta_max is not None:
            betas = np.union1d(betas, [abs(float(beta_max))])
        m_grid = torch.linspace(-1.0, 1.0, 201, dtype=torch.float32)
        flip_max = max(
            float(torch.max(torch.as_tensor(config.flip_rate_fn(
                torch.full_like(m_grid, s), m_grid,
                torch.tensor(bb, dtype=torch.float32)))))
            for s in (-1.0, 1.0) for bb in betas)
    else:
        flip_max = float(np.exp(abs(b)))
    r_max = (2.0 * get(params.rate_diffusion)
             + get(params.rate_active)
             + flip_max
             + get(params.k_on) + get(params.k_off) + get(params.k_exit))
    return config.max_event_prob / max(r_max, 1e-12)


# ---------------------------------------------------------------------------
# PDE engine
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PDEConfig:
    """Static configuration of the IMEX PDE engine (same fields and defaults
    as the JAX package's ``PDEConfig``)."""

    L: int = 1000
    xlim: float = 1.0
    T: float = 10.0
    dt: float = 5e-4
    bc: str = "periodic"                     # 'periodic' | 'neumann'
    active_model: str = "bidirectional"      # 'bidirectional' | 'anchored_minus'
    gaussian_kernel: bool = False
    kernel_sigma: float = 0.02
    snapshot_interval: int = 50
    diffusion_solver: str = "auto"           # 'auto'|'fft'|'dct'|'dense'|'identity'|'banded'
    n_tracers: int = 1000
    tracer_window_time: float = 0.05
    fft_kmax: Optional[int] = None           # None -> L//2+1 (full rfft)
    record_every: int = 1
    legacy_double_diffusion: bool = False    # API parity only (a no-op)

    def __post_init__(self):
        assert self.bc in ("periodic", "neumann")
        assert self.active_model in ("bidirectional", "anchored_minus")
        assert self.diffusion_solver in ("auto", "fft", "dct", "dense",
                                         "identity", "banded")

    @property
    def dx(self) -> float:
        return self.xlim / self.L

    @property
    def nsteps(self) -> int:
        return int(self.T / self.dt)

    @property
    def kmax(self) -> int:
        full = self.L // 2 + 1
        return min(self.fft_kmax, full) if self.fft_kmax is not None else full

    @property
    def n_records(self) -> int:
        return self.nsteps // self.record_every + 1

    @property
    def tracer_window(self) -> int:
        return int(self.tracer_window_time / self.dt)

    @property
    def solver_kind(self) -> str:
        if self.diffusion_solver == "banded":
            return "banded" if self.bc == "periodic" else "banded_dct"
        if self.diffusion_solver != "auto":
            return self.diffusion_solver
        if self.L > 8192:
            return "banded" if self.bc == "periodic" else "banded_dct"
        return "fft" if self.bc == "periodic" else "dct"


@dataclasses.dataclass
class PDEParams:
    """Runtime PDE parameters: float32 tensors, scalar or batched."""

    gamma: torch.Tensor   # diffusion coefficient
    lam: torch.Tensor     # active speed
    beta: torch.Tensor


def make_pde_params(*, gamma: float = 2.33e-4, lam: float = 0.6,
                    beta: float = 2.0, device="cuda") -> PDEParams:
    as_t = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
    return PDEParams(gamma=as_t(gamma), lam=as_t(lam), beta=as_t(beta))

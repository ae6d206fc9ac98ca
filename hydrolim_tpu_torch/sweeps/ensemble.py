"""Batched (β-grid × replicas) parameters for the particle sweeps."""
from __future__ import annotations

import numpy as np
import torch

from hydrolim_tpu_torch.core.config import (
    ParticleConfig,
    ParticleParams,
    auto_dt,
    make_particle_params,
)


def broadcast_params(config: ParticleConfig, *, beta, rate_diffusion,
                     rate_active, k_on=0.0, k_off=0.0, k_exit=0.0,
                     n_runs: int = 1, device="cuda") -> ParticleParams:
    """Params with leading axis (n_beta·n_runs,): β varies across the grid
    (each value repeated ``n_runs`` times), the other rates broadcast."""
    beta = np.atleast_1d(np.asarray(beta, dtype=np.float32))
    flat = np.repeat(beta, n_runs)
    B = flat.shape[0]
    ref = make_particle_params(
        config, beta=0.0, rate_diffusion=rate_diffusion,
        rate_active=rate_active, k_on=k_on, k_off=k_off, k_exit=k_exit,
        device=device)
    return ParticleParams(
        beta=torch.tensor(flat, dtype=torch.float32, device=device),
        rate_diffusion=ref.rate_diffusion.expand(B).clone(),
        rate_active=ref.rate_active.expand(B).clone(),
        k_on=ref.k_on.expand(B).clone(),
        k_off=ref.k_off.expand(B).clone(),
        k_exit=ref.k_exit.expand(B).clone(),
    )


def ensemble_dt(config: ParticleConfig, *, beta_max: float, rate_diffusion,
                rate_active, k_on=0.0, k_off=0.0, k_exit=0.0) -> float:
    """Static Δt for a sweep: bound the per-particle rate at the largest β."""
    p = make_particle_params(config, beta=beta_max,
                             rate_diffusion=rate_diffusion,
                             rate_active=rate_active, k_on=k_on, k_off=k_off,
                             k_exit=k_exit, device="cpu")
    return auto_dt(config, p, beta_max=beta_max)

"""PDE initial conditions for a batch of replicas."""
from __future__ import annotations

from typing import Tuple

import torch

from hydrolim_tpu_torch.core.config import PDEConfig
from hydrolim_tpu_torch.pde.stepper import TracerState


def pde_initialize(config: PDEConfig, generator: torch.Generator, *,
                   B: int = 1, mode: str = "poisson", rho0: float = 1.0,
                   noise: float = 0.2, n_tracers: int = 1000,
                   device="cuda"
                   ) -> Tuple[torch.Tensor, torch.Tensor, TracerState]:
    """(ρ₊, ρ₋, tracers) for B replicas, all draws from ``generator`` (which
    must live on ``device``).  ``mode='poisson'`` reproduces the reference
    quirk: a centered exponential bump, not Poisson noise."""
    L = config.L
    x = torch.arange(L, dtype=torch.float32, device=device) * (config.xlim / L)
    normal = lambda: torch.randn((B, L), generator=generator, device=device)
    if mode == "homogeneous":
        base = torch.full((L,), rho0, dtype=torch.float32, device=device)
    elif mode == "poisson":
        base = torch.exp(-torch.abs(x - 0.5) / 0.05)
    else:
        raise ValueError("Unknown init mode.")
    rho_p = torch.clamp(base + noise * normal(), min=0.0)
    rho_m = torch.clamp(base + noise * normal(), min=0.0)
    tot = (rho_p + rho_m).sum(-1, keepdim=True)
    rho_p = rho_p / tot
    rho_m = rho_m / tot

    pos = torch.randint(0, L, (B, n_tracers), generator=generator,
                        device=device).to(torch.float32) * config.dx
    spin = (torch.randint(0, 2, (B, n_tracers), generator=generator,
                          device=device, dtype=torch.int32) * 2 - 1)
    tracers = TracerState(
        pos=pos, unwrapped=pos.clone(), spin=spin,
        hist=torch.zeros((B, config.tracer_window, n_tracers),
                         dtype=torch.float32, device=device))
    return rho_p, rho_m, tracers

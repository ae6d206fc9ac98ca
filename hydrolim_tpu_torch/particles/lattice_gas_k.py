"""The K-slot exclusion field: (K, L) signed slots per replica.

``slots_from_particles`` packs particles into slots by rank within their
site, and ``lgk_init`` draws the initial field through the particle
initializers, as the JAX package's ``particles/lattice_gas_k.py`` does.
The XLA slot stepper (``lgk_step``, ``run_lattice_gas_k``) is not ported
yet; the fused sweep runs on kernel B3/B4 (``ops/exclusion_kernel.py``).
"""
from __future__ import annotations

from typing import Optional

import torch

from hydrolim_tpu_torch.core.config import ParticleConfig
from hydrolim_tpu_torch.particles.init import init_particles


def slots_from_particles(config: ParticleConfig, pos: torch.Tensor,
                         sigma: torch.Tensor,
                         alive: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """(..., n) particle arrays → (..., K, L) int32 slot field: the r-th
    particle of a site (in buffer order) fills slot r."""
    K, L = config.K, config.L
    lead, n = pos.shape[:-1], pos.shape[-1]
    pos = pos.reshape(-1, n).long()
    sigma = sigma.reshape(-1, n).to(torch.int32)
    if alive is None:
        alive = torch.ones_like(pos, dtype=torch.bool)
    alive = alive.reshape(-1, n)
    pos = torch.where(alive, pos, L)                     # dead → column L
    pos_s, order = torch.sort(pos, dim=-1, stable=True)
    sig_s = torch.where(alive.gather(-1, order), sigma.gather(-1, order), 0)
    counts = torch.zeros((pos.shape[0], L + 1), dtype=torch.long,
                         device=pos.device)
    counts.scatter_add_(1, pos_s, torch.ones_like(pos_s))
    seg_start = counts.cumsum(-1) - counts
    rank = torch.arange(n, device=pos.device) - seg_start.gather(-1, pos_s)
    flat = torch.zeros((pos.shape[0], K * (L + 1)), dtype=torch.int32,
                       device=pos.device)
    flat.scatter_(1, rank.clamp(0, K - 1) * (L + 1) + pos_s, sig_s)
    return flat.reshape(*lead, K, L + 1)[..., :L].contiguous()


def lgk_init(config: ParticleConfig, generator: torch.Generator,
             rho0_plus=None, rho0_minus=None, *, B: int = 1,
             device="cuda") -> torch.Tensor:
    """(B, K, L) initial slot spins through the particle initializers (the
    same law in both init modes)."""
    st = init_particles(config, generator, rho0_plus, rho0_minus, B=B,
                        device=device)
    return slots_from_particles(config, st.pos, st.sigma, st.alive)

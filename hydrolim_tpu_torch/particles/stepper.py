"""Mean-field τ-leap step (the engine behind kernel B1's plain version)."""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from hydrolim_tpu_torch.core.config import ParticleConfig, ParticleParams


@dataclasses.dataclass
class ParticleState:
    """Mean-field particle state, (B, n) int32 each.  ``pos`` is the wrapped
    site; ``pos + wind·L`` is the unwrapped trajectory."""

    pos: torch.Tensor
    sigma: torch.Tensor
    wind: torch.Tensor


def _is_meanfield_fast_path(config: ParticleConfig) -> bool:
    """No exclusion, global magnetization, no anchors, default CW flip
    rate: the step reduces to elementwise work plus one sum."""
    return (not config.exclusion
            and config.local_kernel_sigma <= 0
            and config.anchor_positions is None
            and config.flip_rate_fn is None)


def _step_meanfield_global(config: ParticleConfig, params: ParticleParams,
                           state: ParticleState, dt: float,
                           u_override: Optional[torch.Tensor] = None,
                           generator: Optional[torch.Generator] = None
                           ) -> ParticleState:
    """One step for a (B, n) batch: m = Σσ/n per replica, one uniform per
    particle against the cumulative thresholds [left p_dif, right p_dif,
    active p_act, flip exp(∓βm)·dt].

    ``u_override``: (B, n) float32 uniforms replacing the draw from
    ``generator``.  Params are (B,) tensors (or scalars)."""
    L = config.L
    pos, sigma = state.pos, state.sigma
    B, n = pos.shape
    f32 = torch.float32
    col = lambda v: torch.as_tensor(v, dtype=f32,
                                    device=pos.device).reshape(-1, 1)
    dt32 = torch.tensor(dt, dtype=f32, device=pos.device)

    # exact integer Σσ, then one f32 division by the true particle count
    m = sigma.sum(-1, keepdim=True, dtype=torch.int64).to(f32) / \
        torch.tensor(float(n), dtype=f32, device=pos.device)
    beta = col(params.beta)
    p_dif = col(params.rate_diffusion) * dt32
    p_act = col(params.rate_active) * dt32
    e_p = torch.exp(-beta * m) * dt32       # flip prob of a + particle
    e_m = torch.exp(beta * m) * dt32        # flip prob of a − particle

    is_plus = sigma > 0
    if u_override is None:
        u = torch.rand((B, n), generator=generator, dtype=f32,
                       device=pos.device)
    else:
        u = u_override
    if not config.periodic:
        raise NotImplementedError(
            "the port's mean-field step implements the periodic lattice")

    zero = torch.zeros((), dtype=f32, device=pos.device)
    t1 = p_dif
    t2 = t1 + p_dif
    if config.active_model == "bidirectional":
        t3 = t2 + p_act
        fwd_dir = sigma
    else:  # plus_forward: only σ=+1 hop actively
        t3 = t2 + torch.where(is_plus, p_act, zero)
        fwd_dir = torch.ones_like(sigma)
    t4 = t3 + torch.where(is_plus, e_p, e_m)

    mv_left = u < t1
    mv_right = (u >= t1) & (u < t2)
    mv_fwd = (u >= t2) & (u < t3)
    flip = (u >= t3) & (u < t4)

    delta = (mv_right.to(torch.int32) - mv_left.to(torch.int32)
             + torch.where(mv_fwd, fwd_dir, torch.zeros_like(fwd_dir)))
    raw = pos + delta
    pos_new = torch.where(raw < 0, raw + L, torch.where(raw >= L, raw - L, raw))
    wind = state.wind + (raw >= L).to(torch.int32) - (raw < 0).to(torch.int32)
    sigma_new = torch.where(flip, -sigma, sigma)
    return ParticleState(pos=pos_new, sigma=sigma_new, wind=wind)

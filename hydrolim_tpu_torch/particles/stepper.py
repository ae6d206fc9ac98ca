"""Mean-field τ-leap step: the torch fast path of the particle engine for
configurations outside kernel B1's scope (walls, a dead buffer tail) and
the loop body of B1's plain version.

The general τ-leap ``step`` (exclusion, local m, anchors, a custom flip
rate) is not ported yet (ROADMAP.md §A item 1)."""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from hydrolim_tpu_torch.core.config import ParticleConfig, ParticleParams


@dataclasses.dataclass
class ParticleState:
    """Mean-field particle state, (B, n) int32 each.  ``pos`` is the wrapped
    site; ``pos + wind·L`` is the unwrapped trajectory.  ``alive`` (B, n)
    bool marks the live entries of a padded buffer (None: all live);
    ``bound`` (B, n) bool the anchored ones (None: none; the mean-field
    step has no binding and carries it through)."""

    pos: torch.Tensor
    sigma: torch.Tensor
    wind: torch.Tensor
    alive: Optional[torch.Tensor] = None
    bound: Optional[torch.Tensor] = None


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
    """One step for a (B, n) batch: m = Σ_alive σ / max(n_alive, 1) per
    replica, one uniform per particle against the cumulative thresholds
    [left p_dif, right p_dif, active p_act, flip exp(∓βm)·dt].  On a
    lattice with walls a hop that would leave it has rate 0 (its threshold
    step collapses); dead particles neither move nor flip.

    ``u_override``: (B, n) float32 uniforms replacing the draw from
    ``generator``.  Params are (B,) tensors (or scalars)."""
    L = config.L
    pos, sigma, alive = state.pos, state.sigma, state.alive
    B, n = pos.shape
    f32 = torch.float32
    col = lambda v: torch.as_tensor(v, dtype=f32,
                                    device=pos.device).reshape(-1, 1)
    dt32 = torch.tensor(dt, dtype=f32, device=pos.device)

    # exact integer Σσ, then one f32 division by the true particle count
    if alive is None:
        s_sum = sigma.sum(-1, keepdim=True, dtype=torch.int64)
        n_alive = torch.tensor(float(n), dtype=f32, device=pos.device)
    else:
        s_sum = torch.where(alive, sigma, 0).sum(-1, keepdim=True,
                                                 dtype=torch.int64)
        n_alive = alive.sum(-1, keepdim=True).clamp(min=1).to(f32)
    m = s_sum.to(f32) / n_alive
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

    zero = torch.zeros((), dtype=f32, device=pos.device)
    bidirectional = config.active_model == "bidirectional"
    if config.periodic:
        t1 = p_dif
        t2 = t1 + p_dif
        p_fwd = (p_act if bidirectional
                 else torch.where(is_plus, p_act, zero))
    else:
        left_ok, right_ok = pos > 0, pos < L - 1
        fwd_ok = (torch.where(is_plus, right_ok, left_ok) if bidirectional
                  else right_ok)
        t1 = torch.where(left_ok, p_dif, zero)
        t2 = t1 + torch.where(right_ok, p_dif, zero)
        p_fwd = torch.where(fwd_ok if bidirectional else is_plus & fwd_ok,
                            p_act, zero)
    # bidirectional: σ hops actively along σ; plus_forward: only σ=+1
    # particles hop, rightward
    t3 = t2 + p_fwd
    fwd_dir = sigma if bidirectional else torch.ones_like(sigma)
    t4 = t3 + torch.where(is_plus, e_p, e_m)

    mv_left = u < t1
    mv_right = (u >= t1) & (u < t2)
    mv_fwd = (u >= t2) & (u < t3)
    flip = (u >= t3) & (u < t4)

    delta = (mv_right.to(torch.int32) - mv_left.to(torch.int32)
             + torch.where(mv_fwd, fwd_dir, torch.zeros_like(fwd_dir)))
    if alive is not None:
        flip = flip & alive
        delta = torch.where(alive, delta, 0)
    raw = pos + delta
    if config.periodic:
        pos_new = torch.where(raw < 0, raw + L,
                              torch.where(raw >= L, raw - L, raw))
        wind = (state.wind + (raw >= L).to(torch.int32)
                - (raw < 0).to(torch.int32))
    else:
        pos_new, wind = raw, state.wind     # blocked hops are rate 0
    sigma_new = torch.where(flip, -sigma, sigma)
    return ParticleState(pos=pos_new, sigma=sigma_new, wind=wind,
                         alive=alive, bound=state.bound)

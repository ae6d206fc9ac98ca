"""Particle initializers, batched over B replicas.

The laws of the JAX package's ``particles/init.py``
(PARTICLE_solver_CLASS.py:141-189) over a padded particle buffer of
``config.n_buf`` entries with an alive mask:

- ``fixed`` with exclusion: N of the L·K capacity slots uniformly without
  replacement; without exclusion, N uniform sites;
- ``poisson``: per-site Poisson counts from ρ₀±(x), truncated to the site
  capacity K by an exact hypergeometric split of the K kept labels, then
  thinned binomially when the total overflows the buffer.

All draws come from one ``torch.Generator`` on the tensors' device.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from hydrolim_tpu_torch.core.config import ParticleConfig


class InitialParticles(NamedTuple):
    """(B, n_buf) int32 sites and spins and a bool alive mask."""

    pos: torch.Tensor
    sigma: torch.Tensor
    alive: torch.Tensor


def init_fixed(config: ParticleConfig, generator: torch.Generator, *,
               B: int = 1, device="cuda") -> InitialParticles:
    n_buf, N, L = config.n_buf, config.N, config.L
    if config.exclusion:
        K = config.K
        keys = torch.rand((B, L * K), generator=generator, device=device)
        slots = keys.argsort(dim=-1)[:, :N]
        pos_n = (slots // K).to(torch.int32)
    else:
        pos_n = torch.randint(0, L, (B, N), generator=generator,
                              device=device, dtype=torch.int32)
    pos = torch.zeros((B, n_buf), dtype=torch.int32, device=device)
    pos[:, :N] = pos_n
    sigma = torch.randint(0, 2, (B, n_buf), generator=generator,
                          device=device, dtype=torch.int32) * 2 - 1
    alive = (torch.arange(n_buf, device=device) < N).expand(B, n_buf)
    return InitialParticles(pos=pos, sigma=sigma, alive=alive.clone())


def _hypergeom_keep_plus(generator: torch.Generator, cp: torch.Tensor,
                         cm: torch.Tensor, K: int) -> torch.Tensor:
    """Exact sample of the number of '+' labels among K kept out of cp '+'
    and cm '−' labels (a uniform subset), per site: P(j) ∝
    C(cp, j)·C(cm, K−j), drawn by the Gumbel-max trick in log space."""
    j = torch.arange(K + 1, dtype=torch.float64, device=cp.device)
    cp_f = cp.to(torch.float64)[..., None]
    cm_f = cm.to(torch.float64)[..., None]

    def log_c(n, r):
        valid = (r >= 0) & (r <= n)
        safe_r = torch.minimum(torch.clamp(r, min=0.0), n.clamp(min=0.0))
        v = (torch.lgamma(n + 1.0) - torch.lgamma(safe_r + 1.0)
             - torch.lgamma(n - safe_r + 1.0))
        return torch.where(valid, v, -torch.inf)

    logits = log_c(cp_f, j) + log_c(cm_f, K - j)            # (..., K+1)
    u = torch.rand(logits.shape, generator=generator, dtype=torch.float64,
                   device=cp.device).clamp(min=1e-300)
    return (logits - torch.log(-torch.log(u))).argmax(-1).to(torch.int32)


def init_poisson(config: ParticleConfig, generator: torch.Generator,
                 rho0_plus, rho0_minus, *, B: int = 1,
                 device="cuda") -> InitialParticles:
    """``rho0_plus/minus``: per-site mean counts, (L,) or (B, L)."""
    L, n_buf = config.L, config.n_buf
    as_rate = lambda r: torch.as_tensor(
        np.asarray(r, np.float32), device=device).expand(B, L).contiguous()
    cp = torch.poisson(as_rate(rho0_plus), generator=generator).to(torch.int32)
    cm = torch.poisson(as_rate(rho0_minus), generator=generator).to(
        torch.int32)

    if config.exclusion:
        K = config.K
        over = cp + cm > K
        kp_trunc = _hypergeom_keep_plus(generator, cp, cm, K)
        kp = torch.where(over, kp_trunc, cp)
        km = torch.where(over, K - kp_trunc, cm)
    else:
        kp, km = cp, cm

    # buffer-overflow guard: thin every site binomially to an expected
    # total of n_buf, so a residual truncation drops a uniform random tail
    # rather than the high-x end of the profile
    n_draw = (kp + km).sum(-1, keepdim=True)
    over_buf = n_draw > n_buf
    if bool(over_buf.any()):
        p_keep = (n_buf / n_draw.clamp(min=1).to(torch.float32)).clamp(max=1.0)
        p_keep = p_keep.expand(B, L)
        thin = lambda c: torch.binomial(c.to(torch.float32), p_keep,
                                        generator=generator).to(torch.int32)
        kp = torch.where(over_buf, thin(kp), kp)
        km = torch.where(over_buf, thin(km), km)

    counts = kp + km
    ends = counts.cumsum(-1)                                   # (B, L)
    n_total = ends[:, -1:]
    slot = torch.arange(n_buf, dtype=ends.dtype, device=device).expand(
        B, n_buf).contiguous()
    # site of buffer entry i: the first site whose inclusive cumsum > i
    pos = torch.searchsorted(ends, slot, right=True).clamp(max=L - 1)
    start = (ends - counts).gather(-1, pos)
    rank = slot - start
    sigma = torch.where(rank < kp.gather(-1, pos), 1, -1).to(torch.int32)
    alive = slot < n_total
    return InitialParticles(pos=pos.to(torch.int32), sigma=sigma, alive=alive)


def init_particles(config: ParticleConfig, generator: torch.Generator,
                   rho0_plus=None, rho0_minus=None, *, B: int = 1,
                   device="cuda") -> InitialParticles:
    """Dispatch on ``config.init``; like the reference, ``init='fixed'``
    ignores the ρ₀ profiles."""
    if config.init == "fixed":
        return init_fixed(config, generator, B=B, device=device)
    assert rho0_plus is not None and rho0_minus is not None, (
        "poisson init requires rho0_plus/rho0_minus profiles")
    return init_poisson(config, generator, rho0_plus, rho0_minus, B=B,
                        device=device)


def eval_profile(fn, L: int) -> np.ndarray:
    """Evaluate a reference-style ρ₀ callable on the grid i/L."""
    return np.array([float(fn(i / L)) for i in range(L)], dtype=np.float32)

"""Debug / sanitizer checks (SURVEY.md §5 "race detection" row).

The analogous hazard to a data race in this framework is a
*conflict-resolution violation* — two simultaneous hops exceeding site
capacity — plus the usual NaN/bounds hazards.  These helpers are assertion
passes enabled behind a debug flag (they copy to the host, so they stay
out of production steps):

- :func:`check_particle_invariants` — capacity ≤ K, positions in range,
  spins ±1 where alive, a non-negative exit count,
- :func:`check_density_invariants` — non-negative densities, finite mass,
- :func:`nan_guard` — a NaN/Inf check that runs (and waits for the card)
  only when ``HYDROLIM_DEBUG`` is set, and otherwise returns its input
  untouched, with no host synchronisation.

The port of the JAX package's ``utils/debug.py``; the state is the port's
batched (B, n_buf) state (``particles.stepper.ParticleState`` or
``particles.init.InitialParticles``, whose ``alive`` may be None: all live).
"""
from __future__ import annotations

import os

import numpy as np
import torch

from hydrolim_tpu_torch.core.config import ParticleConfig
from hydrolim_tpu_torch.ops.segment import occupancy


def debug_enabled() -> bool:
    return os.environ.get("HYDROLIM_DEBUG", "0") not in ("0", "", "false")


def check_particle_invariants(config: ParticleConfig, state) -> None:
    """Host-side assertion pass over a (batched) particle state."""
    pos = torch.as_tensor(state.pos).cpu()
    sigma = torch.as_tensor(state.sigma).cpu()
    alive = getattr(state, "alive", None)
    alive = (torch.ones_like(pos, dtype=torch.bool) if alive is None
             else torch.as_tensor(alive).cpu())
    assert bool(((pos >= 0) & (pos < config.L)).all()), \
        "position out of range"
    if config.exclusion:
        occ, _, _ = occupancy(pos, sigma, alive, config.L)
        assert float(occ.max()) <= config.K, (
            f"exclusion violated: occupancy {float(occ.max())} > "
            f"K={config.K}")
    assert np.all(np.isin(sigma[alive].numpy(), (-1, 1))), "bad spin value"
    ec = getattr(state, "exit_count", None)
    if ec is not None:
        assert int(torch.as_tensor(ec).min()) >= 0


def check_density_invariants(rho_p, rho_m) -> None:
    rho_p = np.asarray(torch.as_tensor(rho_p).detach().cpu())
    rho_m = np.asarray(torch.as_tensor(rho_m).detach().cpu())
    assert np.all(np.isfinite(rho_p)) and np.all(np.isfinite(rho_m)), \
        "non-finite density"
    assert rho_p.min() >= 0 and rho_m.min() >= 0, "negative density"


def nan_guard(x: torch.Tensor, name: str = "array") -> torch.Tensor:
    """NaN/Inf check of ``x`` when ``HYDROLIM_DEBUG`` is set (it waits for
    the card); otherwise ``x`` is returned untouched and nothing syncs."""
    if debug_enabled() and not bool(torch.isfinite(x).all()):
        raise FloatingPointError(f"NaN/Inf detected in {name}")
    return x

"""Mean-field sweep runner on kernel B1.

Advances the (β-grid × replicas) batch one obs_dt frame per
``meanfield_multi_step`` call and records the frame observables (densities,
global m, Var, unwrapped positions) between calls.  CUDA tensors go through
the kernel, CPU tensors through its plain version.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from hydrolim_tpu_torch.core.config import ParticleConfig, ParticleParams
from hydrolim_tpu_torch.ops.segment import masked_bincount
from hydrolim_tpu_torch.ops.stepper_kernel import meanfield_multi_step
from hydrolim_tpu_torch.particles.run import substeps_for
from hydrolim_tpu_torch.particles.stepper import _is_meanfield_fast_path


@dataclasses.dataclass
class MeanfieldFrames:
    times_obs: np.ndarray      # (M,)
    m_global: np.ndarray       # (M, B)
    rho_p: np.ndarray          # (M, B, L)
    rho_m: np.ndarray          # (M, B, L)
    var: np.ndarray            # (M, B)
    pos: Optional[np.ndarray]  # (M, B, n) unwrapped site positions


def _frame_obs(pos: torch.Tensor, sigma: torch.Tensor, L: int, n: int,
               dx: float):
    """(B, n) state → densities, m, Var for one frame."""
    wp = (sigma > 0).to(torch.float32)
    wm = (sigma < 0).to(torch.float32)
    cp = masked_bincount(pos % L, wp, L)
    cm = masked_bincount(pos % L, wm, L)
    denom = float(n) * dx
    rho_p = cp / denom
    rho_m = cm / denom
    total = rho_p + rho_m
    m = sigma.sum(-1).to(torch.float32) / n
    var = total.var(-1, unbiased=False)
    return rho_p, rho_m, m, var


def resolve_meanfield_engine(device, config: ParticleConfig) -> str:
    """The engine the device selects ('kernel' on CUDA, 'plain' on CPU),
    after the kernel's scope gate: the 'fixed' (uniform-site) init and the
    periodic lattice only — outside it the law would change, so raise."""
    if config.init != "fixed":
        raise ValueError(
            "run_meanfield_sweep implements the 'fixed' (uniform-site) init "
            f"only; got init={config.init!r}")
    if not config.periodic:
        raise ValueError(
            "run_meanfield_sweep implements the periodic lattice only (the "
            "kernel hard-codes wrap+winding moves)")
    kind = torch.device(device).type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return "kernel" if kind == "cuda" else "plain"


def run_meanfield_sweep(config: ParticleConfig, params_b: ParticleParams,
                        *, T: float, obs_dt: float, dt: float, seed: int = 0,
                        device="cuda", record_pos: bool = True
                        ) -> MeanfieldFrames:
    """Sweep over the batch of ``params_b`` on ``device``.

    Requires the mean-field configuration (global m, no exclusion, no
    anchors).  All draws come from one ``torch.Generator`` seeded with
    ``seed`` on ``device``: the initial state, the kernel's Philox seeds
    and, on the CPU, the plain version's uniforms."""
    assert _is_meanfield_fast_path(config), (
        "run_meanfield_sweep requires the mean-field configuration")
    resolve_meanfield_engine(device, config)
    device = torch.device(device)
    B = params_b.beta.shape[0]
    n = config.N                    # the TRUE particle count normalizes m
    L = config.L
    times = np.arange(0.0, T, obs_dt)
    M = len(times)
    n_sub = substeps_for(obs_dt, dt)
    dt_eff = obs_dt / n_sub

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    pos = torch.randint(0, L, (B, n), generator=gen, device=device,
                        dtype=torch.int32)
    sigma = (torch.randint(0, 2, (B, n), generator=gen, device=device,
                           dtype=torch.int32) * 2 - 1)
    wind = torch.zeros((B, n), dtype=torch.int32, device=device)
    seeds = torch.randint(0, 2 ** 31 - 1, (B,), generator=gen, device=device,
                          dtype=torch.int32)
    scal = torch.stack([params_b.beta, params_b.rate_diffusion,
                        params_b.rate_active], dim=1).to(
        device=device, dtype=torch.float32).contiguous()
    bidi = config.active_model == "bidirectional"

    frames = dict(m=[], rho_p=[], rho_m=[], var=[], pos=[])

    def record(pos, sigma, wind):
        rho_p, rho_m, m, var = _frame_obs(pos, sigma, L, n, config.dx)
        frames["m"].append(m)
        frames["rho_p"].append(rho_p)
        frames["rho_m"].append(rho_m)
        frames["var"].append(var)
        if record_pos:
            frames["pos"].append(pos + wind * L)

    record(pos, sigma, wind)
    for f in range(1, M):
        pos, sigma, wind = meanfield_multi_step(
            scal, seeds, pos, sigma, wind, L=L, k_steps=n_sub, dt=dt_eff,
            bidirectional=bidi, step0=(f - 1) * n_sub, generator=gen)
        record(pos, sigma, wind)

    host = lambda xs: torch.stack(xs).cpu().numpy()
    return MeanfieldFrames(
        times_obs=times,
        m_global=host(frames["m"]),
        rho_p=host(frames["rho_p"]),
        rho_m=host(frames["rho_m"]),
        var=host(frames["var"]),
        pos=host(frames["pos"]) if record_pos else None)

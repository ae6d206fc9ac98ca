"""Mean-field sweep runner on kernel B1.

Advances the (β-grid × replicas) batch one obs_dt frame per
``meanfield_multi_step`` call and records the frame observables (densities,
global m, Var, unwrapped positions) between calls.  CUDA tensors go through
the kernel, CPU tensors through its plain version.  Configurations outside
the kernel's scope (Poisson init, walls) run ``run_particle_ensemble`` on
the torch fast path under ``engine='auto'``, as the JAX package's runner
falls back to its XLA path.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from hydrolim_tpu_torch.core.config import ParticleConfig, ParticleParams
from hydrolim_tpu_torch.ops.segment import masked_bincount
from hydrolim_tpu_torch.ops.stepper_kernel import meanfield_multi_step
from hydrolim_tpu_torch.particles.run import in_b1_scope, substeps_for
from hydrolim_tpu_torch.particles.stepper import _is_meanfield_fast_path
from hydrolim_tpu_torch.sweeps.ensemble import run_particle_ensemble
from hydrolim_tpu_torch.utils import profiling


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


def resolve_meanfield_engine(engine: str, config: ParticleConfig) -> str:
    """The JAX package's engine names: 'auto' picks the kernel ('pallas')
    where the configuration is in its scope (init='fixed' and periodic:
    the kernel hard-codes the uniform-site init and wrap+winding moves),
    else the fast path ('xla', the torch fast path here).  An explicit
    'pallas' outside that scope raises instead of changing the law."""
    if engine == "auto":
        engine = "pallas" if in_b1_scope(config) else "xla"
    if engine not in ("pallas", "xla"):
        raise ValueError(f"unknown engine {engine!r}")
    if engine == "pallas" and config.init != "fixed":
        raise ValueError(
            "engine='pallas' implements the 'fixed' (uniform-site) init "
            f"only; got init={config.init!r} — use engine='xla' or 'auto'")
    if engine == "pallas" and not config.periodic:
        raise ValueError(
            "engine='pallas' implements the periodic lattice only (the "
            "kernel hard-codes wrap+winding moves); non-periodic configs "
            "block boundary moves — use engine='xla' or 'auto'")
    return engine


def run_meanfield_sweep(config: ParticleConfig, params_b: ParticleParams,
                        *, T: float, obs_dt: float, dt: float, seed: int = 0,
                        device="cuda", record_pos: bool = True,
                        engine: str = "auto") -> MeanfieldFrames:
    """Sweep over the batch of ``params_b`` on ``device``.

    Requires the mean-field configuration (global m, no exclusion, no
    anchors).  ``engine`` (``resolve_meanfield_engine``): 'pallas' runs
    kernel B1 here, 'xla' ``run_particle_ensemble`` on the torch fast
    path (frames of the whole n_buf buffer, as the JAX package's).  All
    draws come from generators seeded with ``seed`` on ``device``: the
    initial state, the kernel's Philox seeds and, on the CPU, the plain
    version's uniforms."""
    with profiling.span("mf.sweep"):
        assert _is_meanfield_fast_path(config), (
            "run_meanfield_sweep requires the mean-field configuration")
        device = torch.device(device)
        times = np.arange(0.0, T, obs_dt)
        if resolve_meanfield_engine(engine, config) == "xla":
            f = run_particle_ensemble(config, params_b, seed, T=T,
                                      obs_dt=obs_dt, dt=dt,
                                      record_pos=record_pos,
                                      record_fft=False, engine="xla",
                                      device=device).frames
            host = lambda a: a.movedim(1, 0).cpu().numpy()
            return MeanfieldFrames(
                times_obs=times, m_global=host(f.m_global),
                rho_p=host(f.rho_p), rho_m=host(f.rho_m), var=host(f.var),
                pos=host(f.pos) if record_pos else None)
        B = params_b.beta.shape[0]
        n = config.N                    # the TRUE particle count normalizes m
        L = config.L
        M = len(times)
        n_sub = substeps_for(obs_dt, dt)
        dt_eff = obs_dt / n_sub

        with profiling.span("mf.init"):
            gen = torch.Generator(device=device)
            gen.manual_seed(seed)
            pos = torch.randint(0, L, (B, n), generator=gen, device=device,
                                dtype=torch.int32)
            sigma = (torch.randint(0, 2, (B, n), generator=gen, device=device,
                                   dtype=torch.int32) * 2 - 1)
            wind = torch.zeros((B, n), dtype=torch.int32, device=device)
            seeds = torch.randint(0, 2 ** 31 - 1, (B,), generator=gen,
                                  device=device, dtype=torch.int32)
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

        with profiling.span("mf.frames"):
            record(pos, sigma, wind)
            for f in range(1, M):
                pos, sigma, wind = meanfield_multi_step(
                    scal, seeds, pos, sigma, wind, L=L, k_steps=n_sub,
                    dt=dt_eff, bidirectional=bidi, step0=(f - 1) * n_sub,
                    generator=gen)
                record(pos, sigma, wind)

        host = lambda xs: torch.stack(xs).cpu().numpy()
        with profiling.span("mf.fetch") as sp:
            fetched = {k: host(v) for k, v in frames.items() if v}
        if sp is not None:
            sp.attrs["bytes"] = sum(a.nbytes for a in fetched.values())
        return MeanfieldFrames(
            times_obs=times, m_global=fetched["m"], rho_p=fetched["rho_p"],
            rho_m=fetched["rho_m"], var=fetched["var"], pos=fetched.get("pos"))

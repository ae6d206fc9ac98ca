"""PDE sweep drivers on the fused solve (kernel B2 on CUDA).

- :func:`run_pde_ensemble` — one batched (β × runs) solve,
- :func:`pde_beta_sweep` — the reference β sweep
  (IMEX_PDE_solver_run_sweep.py): near-global kernel (σ = 1e5−10),
  windowed v/D means against λ·tanh(βm_β) and γ + λ²/(2cosh³).
"""
from __future__ import annotations

import dataclasses
import math
from pathlib import Path
from typing import Dict

import numpy as np
import torch

from hydrolim_tpu_torch.core.config import PDEConfig, PDEParams
from hydrolim_tpu_torch.pde.fast_solve import pde_solve_fused, result_to_numpy
from hydrolim_tpu_torch.pde.init import pde_initialize
from hydrolim_tpu_torch.theory.meanfield import compute_m_of_beta


def run_pde_ensemble(config: PDEConfig, beta_values, *, gamma: float,
                     lam: float, n_runs: int, seed: int = 0,
                     mode: str = "homogeneous", rho0: float = 1.0,
                     noise: float = 0.3, n_tracers: int = 1000,
                     device="cuda", fetch_snapshots: bool = True):
    """Batched (β × runs) solve on ``device``; returns the result as numpy
    arrays and the flattened β array.  Every draw comes from one
    ``torch.Generator`` seeded with ``seed``."""
    if float(gamma) == 0.0 and config.diffusion_solver == "auto":
        config = dataclasses.replace(config, diffusion_solver="identity")
    if config.n_tracers != n_tracers:
        config = dataclasses.replace(config, n_tracers=n_tracers)
    device = torch.device(device)
    beta_values = np.atleast_1d(np.asarray(beta_values, dtype=np.float32))
    flat_beta = np.repeat(beta_values, n_runs)
    B = flat_beta.shape[0]
    full = lambda v: torch.full((B,), v, dtype=torch.float32, device=device)
    params_b = PDEParams(gamma=full(gamma), lam=full(lam),
                         beta=torch.tensor(flat_beta, device=device))
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    rho_p, rho_m, tracers = pde_initialize(
        config, gen, B=B, mode=mode, rho0=rho0, noise=noise,
        n_tracers=n_tracers, device=device)
    res = pde_solve_fused(config, params_b, rho_p, rho_m, tracers, gen,
                          keep_snapshots=fetch_snapshots)
    return result_to_numpy(res), flat_beta


def pde_beta_sweep(beta_values=None, n_runs: int = 3, T: float = 40.0,
                   t_min: float = 20.0, t_max: float = 40.0,
                   gamma: float = 0.2, lam: float = 0.6,
                   kernel_sigma: float = 1e5 - 10, L: int = 1000,
                   dt: float = 5e-4, seed: int = 0, n_tracers: int = 1000,
                   outdir: str = ".", plot_result: bool = True,
                   device="cuda") -> Dict:
    """β sweep with theory overlay.  v per run is |nanmean v_eff(t)| over
    [t_min, t_max]; D per run is nanmean D_eff(t) there."""
    if beta_values is None:
        beta_values = np.linspace(0, 3, 11)
    beta_values = np.asarray(beta_values, dtype=float)
    # one kernel call per 2000-step chunk (fewer when nsteps is not a
    # multiple of 2000: the chunks must tile the run)
    nsteps = PDEConfig(L=L, T=T, dt=dt).nsteps
    config = PDEConfig(L=L, T=T, dt=dt, bc="periodic",
                       active_model="bidirectional", gaussian_kernel=True,
                       kernel_sigma=kernel_sigma,
                       snapshot_interval=math.gcd(nsteps, 2000), fft_kmax=8)
    res, _ = run_pde_ensemble(config, beta_values, gamma=gamma, lam=lam,
                              n_runs=n_runs, seed=seed, n_tracers=n_tracers,
                              device=device, fetch_snapshots=False)
    t = np.linspace(0, T, config.nsteps + 1)
    mask = (t >= t_min) & (t <= t_max)

    v_mean, v_err, D_mean, D_err = [], [], [], []
    for b_idx in range(len(beta_values)):
        rows = slice(b_idx * n_runs, (b_idx + 1) * n_runs)
        v_runs = np.abs(np.nanmean(res.records.v_eff[rows][:, mask], axis=1))
        D_runs = np.nanmean(res.records.D_eff[rows][:, mask], axis=1)
        se = (lambda a: a.std(ddof=1) / np.sqrt(n_runs)) if n_runs > 1 \
            else (lambda a: 0.0)
        v_mean.append(v_runs.mean())
        v_err.append(se(v_runs))
        D_mean.append(D_runs.mean())
        D_err.append(se(D_runs))
    v_mean, v_err = np.array(v_mean), np.array(v_err)
    D_mean, D_err = np.array(D_mean), np.array(D_err)

    if plot_result:
        beta_dense = np.linspace(beta_values.min(),
                                 max(beta_values.max(), 1e-9), 400)
        m_dense = compute_m_of_beta(beta_dense)
        v_th = lam * np.tanh(beta_dense * m_dense)
        D_th = gamma + lam ** 2 / (2 * np.cosh(beta_dense * m_dense) ** 3)
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        out = Path(outdir)
        out.mkdir(parents=True, exist_ok=True)
        for sim, err, th, ylabel, fname in (
                (v_mean, v_err, v_th, r"$v_{\mathrm{eff}}$",
                 "pde_v_eff_vs_beta.png"),
                (D_mean, D_err, D_th, r"$D_{\mathrm{eff}}$",
                 "pde_D_eff_vs_beta.png")):
            plt.figure(figsize=(6, 4))
            plt.errorbar(beta_values, sim, yerr=err, fmt="o", capsize=4,
                         label="PDE simulation ± SE")
            plt.plot(beta_dense, th, "--", color="navy", label="theory")
            plt.xlabel(r"$\beta$")
            plt.ylabel(ylabel)
            plt.legend()
            plt.grid()
            plt.tight_layout()
            plt.savefig(out / fname, dpi=200)
            plt.close()

    return dict(beta_values=beta_values, v_mean=v_mean, v_err=v_err,
                D_mean=D_mean, D_err=D_err)

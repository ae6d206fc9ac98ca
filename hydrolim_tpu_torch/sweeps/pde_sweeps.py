"""PDE drivers on the fused solve (kernel B2 on CUDA).

- :func:`run_pde_ensemble` — one batched (β × runs) solve,
- :func:`pde_single_run` — IMEX_PDE_solver_run.py through the ``IMEXPDE``
  facade (L=1000, T=20, γ=0, λ=0.6, β=2, kernel σ=0.005, seed 58),
- :func:`pde_beta_sweep` — the reference β sweep
  (IMEX_PDE_solver_run_sweep.py): near-global kernel (σ = 1e5−10),
  windowed v/D means against λ·tanh(βm_β) and γ + λ²/(2cosh³),
- :func:`pde_kernel_sigma_sweep` — IMEX_PDE_solver_run_sweep_magn{,2}.py:
  one batched run ensemble per σ, |m|/|v|/D/Var mean ± std bands.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from hydrolim_tpu_torch.core.config import PDEConfig, PDEParams
from hydrolim_tpu_torch.fit.veff_fit import _pyplot
from hydrolim_tpu_torch.parallel.distributed import is_primary
from hydrolim_tpu_torch.parallel.mesh import resolve_sweep_mesh
from hydrolim_tpu_torch.pde.fast_solve import (
    check_pde_engine,
    pde_solve_fused,
    result_to_numpy,
)
from hydrolim_tpu_torch.pde.init import pde_initialize
from hydrolim_tpu_torch.theory.meanfield import compute_m_of_beta
from hydrolim_tpu_torch.utils.checkpoint import run_pde_ensemble_checkpointed


def run_pde_ensemble(config: PDEConfig, beta_values, *, gamma: float,
                     lam: float, n_runs: int, seed: int = 0,
                     mode: str = "homogeneous", rho0: float = 1.0,
                     noise: float = 0.3, n_tracers: int = 1000,
                     engine: str = "xla", device="cuda",
                     fetch_snapshots: bool = True, mesh=None,
                     n_devices: Optional[int] = None, ckpt_dir=None,
                     stop_after_chunks: Optional[int] = None):
    """Batched (β × runs) solve on ``device``; returns the result as numpy
    arrays and the flattened β array.  Every draw comes from one
    ``torch.Generator`` seeded with ``seed``.  ``engine`` takes the JAX
    package's names, which all run the fused solve
    (``fast_solve.PDE_ENGINES``).

    ``ckpt_dir=`` makes the in-flight batch preemption-safe: the solve
    runs through ``utils.checkpoint.run_pde_ensemble_checkpointed`` (kernel
    B2 in chunks of snapshot blocks; bit-identical stitched result).  As
    in the JAX package, ``engine='pallas'`` refuses it (AssertionError)
    and ``'xla'`` and ``'auto'`` checkpoint.  ``stop_after_chunks=k``
    halts after ``k`` new chunks and returns ``None`` if the run is
    incomplete (the simulated-preemption hook of the checkpoint drivers).

    ``mesh=``/``n_devices=`` split the flattened (β × runs) batch over a sweep mesh
    (``parallel.mesh``).  In the JAX package the fused Pallas engine runs
    on one chip and ignores the mesh; here every engine name is kernel B2,
    so the mesh splits B2's batch: each block launches B2 on its rows with
    their global index ``b0`` (its plain version on the CPU), and the
    result is the one-device run's bit for bit."""
    check_pde_engine(engine)
    mesh = resolve_sweep_mesh(mesh, n_devices, device)
    if ckpt_dir is not None:
        assert engine != "pallas", (
            "ckpt_dir requires the XLA path (the fused Pallas kernel runs "
            "uncheckpointed); use engine='xla' or 'auto'")
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
    if ckpt_dir is None:
        res = pde_solve_fused(config, params_b, rho_p, rho_m, tracers, gen,
                              keep_snapshots=fetch_snapshots, mesh=mesh)
    else:
        res = run_pde_ensemble_checkpointed(
            config, params_b, rho_p, rho_m, tracers, gen, ckpt_dir=ckpt_dir,
            keep_snapshots=fetch_snapshots,
            stop_after_chunks=stop_after_chunks, mesh=mesh)
        if res is None:
            return None
    return result_to_numpy(res), flat_beta


def pde_single_run(outdir: str = "IMEX_output", seed: int = 58,
                   ckpt_dir=None, device="cuda", **overrides):
    """Single-run driver (IMEX_PDE_solver_run.py:7-34) through the
    ``IMEXPDE`` facade; returns ``get_output()``.  ``ckpt_dir=`` routes
    the solve through the facade's ``solve_checkpointed``."""
    from hydrolim_tpu_torch.pde.system import IMEXPDE

    kw = dict(L=1000, T=20.0, dt=5e-4, gamma=0.0, lam=0.6, beta=2.0,
              bc="periodic", active_model="bidirectional",
              gaussian_kernel=True, kernel_sigma=0.005, snapshot_interval=50,
              outdir=outdir, seed=seed, device=device)
    kw.update(overrides)
    solver = IMEXPDE(**kw)
    solver.initialize(mode="homogeneous", rho0=1.0, noise=0.3)
    if ckpt_dir is not None:
        solver.solve_checkpointed(ckpt_dir=ckpt_dir)
    else:
        solver.solve()
    solver.plot_all()
    solver.plot_individual()
    return solver.get_output()


def pde_beta_sweep(beta_values=None, n_runs: int = 3, T: float = 40.0,
                   t_min: float = 20.0, t_max: float = 40.0,
                   gamma: float = 0.2, lam: float = 0.6,
                   kernel_sigma: float = 1e5 - 10, L: int = 1000,
                   dt: float = 5e-4, seed: int = 0, n_tracers: int = 1000,
                   outdir: str = ".", plot_result: bool = True,
                   engine: str = "xla", n_devices: Optional[int] = None,
                   ckpt_dir=None, device="cuda") -> Dict:
    """β sweep with theory overlay.  v per run is |nanmean v_eff(t)| over
    [t_min, t_max]; D per run is nanmean D_eff(t) there.  ``engine``,
    ``n_devices`` and ``ckpt_dir`` as in
    ``run_pde_ensemble``; the figures need matplotlib."""
    if beta_values is None:
        beta_values = np.linspace(0, 3, 11)
    beta_values = np.asarray(beta_values, dtype=float)
    config = PDEConfig(L=L, T=T, dt=dt, bc="periodic",
                       active_model="bidirectional", gaussian_kernel=True,
                       kernel_sigma=kernel_sigma, snapshot_interval=2000,
                       fft_kmax=8)
    res, _ = run_pde_ensemble(config, beta_values, gamma=gamma, lam=lam,
                              n_runs=n_runs, seed=seed, n_tracers=n_tracers,
                              engine=engine, device=device,
                              fetch_snapshots=False, ckpt_dir=ckpt_dir,
                              n_devices=n_devices)
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

    plt = _pyplot() if plot_result and is_primary() else None
    if plt is not None:
        beta_dense = np.linspace(beta_values.min(),
                                 max(beta_values.max(), 1e-9), 400)
        m_dense = compute_m_of_beta(beta_dense)
        v_th = lam * np.tanh(beta_dense * m_dense)
        D_th = gamma + lam ** 2 / (2 * np.cosh(beta_dense * m_dense) ** 3)
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


MAGN_VARIANTS = {
    # IMEX_PDE_solver_run_sweep_magn.py:25-42
    "magn": dict(T=40.0, gamma=0.0, beta=0.5),
    # IMEX_PDE_solver_run_sweep_magn2.py (diff at :27-31)
    "magn2": dict(T=10.0, gamma=0.2, beta=0.75),
}

REFERENCE_KERNEL_SIGMAS = [0.0005, 0.005, 0.05, 0.1, 1.0]


def pde_kernel_sigma_sweep(kernel_sigma_values=None, n_runs: int = 5,
                           variant: str = "magn", base_seed: int = 100,
                           L: int = 1000, dt: float = 5e-4, lam: float = 0.6,
                           n_tracers: int = 1000, outdir: str = ".",
                           plot_result: bool = True, record_every: int = 1,
                           engine: str = "xla",
                           n_devices: Optional[int] = None, ckpt_dir=None,
                           device="cuda", **overrides) -> Dict:
    """Kernel-σ sweep: per-σ time series of |m|, |v_eff|, D_eff, Var(t)
    (mean ± std bands across runs).  One batched ensemble of ``n_runs`` per
    σ, seeded ``base_seed + 1000·k_idx`` (the reference's per-σ seed
    scheme, :64).  ``ckpt_dir=`` checkpoints each σ's ensemble in its own
    subdirectory ``sigma_<σ:.4g>`` (``run_pde_ensemble``); ``n_devices``
    splits each σ's ensemble over a sweep mesh.  The
    overrides replace the variant's keys (``MAGN_VARIANTS``)."""
    if kernel_sigma_values is None:
        kernel_sigma_values = REFERENCE_KERNEL_SIGMAS
    v = dict(MAGN_VARIANTS[variant])
    v.update(overrides)
    T, gamma, beta = v["T"], v["gamma"], v["beta"]

    m_results, v_results, D_results, var_results = {}, {}, {}, {}
    for k_idx, sigma in enumerate(kernel_sigma_values):
        config = PDEConfig(L=L, T=T, dt=dt, bc="periodic",
                           active_model="bidirectional",
                           gaussian_kernel=True, kernel_sigma=float(sigma),
                           snapshot_interval=2000, fft_kmax=8,
                           record_every=record_every)
        res, _ = run_pde_ensemble(config, [beta], gamma=gamma, lam=lam,
                                  n_runs=n_runs,
                                  seed=base_seed + 1000 * k_idx,
                                  n_tracers=n_tracers, engine=engine,
                                  device=device, fetch_snapshots=False,
                                  n_devices=n_devices,
                                  ckpt_dir=None if ckpt_dir is None else
                                  str(Path(ckpt_dir) / f"sigma_{sigma:.4g}"))
        n_rec = config.n_records        # nsteps+1 thinned by record_every
        m_results[sigma] = np.abs(res.records.m_mean[:, :n_rec])
        v_results[sigma] = np.abs(res.records.v_eff[:, :n_rec])
        D_results[sigma] = res.records.D_eff[:, :n_rec]
        var_results[sigma] = res.records.var[:, :n_rec]

    if plot_result and is_primary():
        _plot_magn_bands(kernel_sigma_values, m_results, v_results,
                         D_results, var_results, T, outdir)
    return dict(m=m_results, v=v_results, D=D_results, var=var_results,
                T=T, gamma=gamma, beta=beta)


def _plot_magn_bands(sigmas, m_results, v_results, D_results, var_results,
                     T, outdir) -> None:
    """The four mean±std band figures (IMEX_PDE_solver_run_sweep_magn.py
    :100-204); skipped where matplotlib is not installed."""
    plt = _pyplot()
    if plt is None:
        return
    out = Path(outdir)
    out.mkdir(parents=True, exist_ok=True)
    colors = plt.cm.Blues(np.linspace(0.4, 0.9, len(sigmas)))
    t = np.linspace(0, T, m_results[sigmas[0]].shape[1])

    panels = (
        (m_results, r"$|m(t)|$", "magnitude_magnetization_sweep.png",
         dict(xlim=(0, min(10, T)), ylim=(0, 1))),
        (v_results, r"$|v_{\mathrm{eff}}(t)|$",
         "magnitude_velocity_sweep.png", dict(xlim=(0.05, min(10, T)))),
        (D_results, r"$D_{\mathrm{eff}}(t)$", "diffusion_sweep.png", {}),
        (var_results, r"$\mathrm{Var}(t)$", "variance_sweep.png", {}),
    )
    for results, ylabel, fname, lims in panels:
        plt.figure(figsize=(8, 5))
        for color, sigma in zip(colors, sigmas):
            data = results[sigma]
            mean = np.nanmean(data, axis=0)
            std = np.nanstd(data, axis=0)
            plt.plot(t, mean, color=color, lw=2, label=rf"$\sigma={sigma}$")
            plt.fill_between(t, mean - std, mean + std, color=color,
                             alpha=0.25)
        plt.xlabel("$t$")
        plt.ylabel(ylabel)
        plt.legend()
        plt.grid()
        if "xlim" in lims:
            plt.xlim(*lims["xlim"])
        if "ylim" in lims:
            plt.ylim(*lims["ylim"])
        plt.tight_layout()
        plt.savefig(out / fname, dpi=200)
        plt.close()

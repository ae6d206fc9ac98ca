"""Cross-engine hydrodynamic-limit figures.

- :func:`plot_particle_vs_pde`: the central scientific claim of the
  reference — particle-simulation and PDE-simulation v_eff(β)/D_eff(β)
  overlaid on the closed-form theory curves (plot_figs.py).  By default uses
  the frozen baseline series (fit.datasets); pass fresh sweep results to
  regenerate from new runs.
- :func:`plot_f_and_g`: the f(ρ̄)/g(ρ̄) meta-fit figure (plot_f_and_g.py)
  with the C0−C1·x and C2/x^{3/2} fits.

A copy of the JAX package's ``viz/cross_engine.py`` (numpy/scipy only).
The numbers come first and the figures go through ``fit.veff_fit._pyplot``:
where matplotlib is not installed ``plot_f_and_g`` still returns its
constants and ``plot_particle_vs_pde`` its series, and no figure is drawn.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict

import numpy as np
from scipy.optimize import curve_fit

from hydrolim_tpu_torch.fit import datasets as ds
from hydrolim_tpu_torch.fit.veff_fit import _pyplot
from hydrolim_tpu_torch.theory.meanfield import compute_m_of_beta


def plot_particle_vs_pde(
    beta_values=None,
    particle_v=None, particle_v_err=None,
    particle_D=None, particle_D_err=None,
    pde_v_raw=None, pde_v_err_raw=None,
    pde_D_raw=None, pde_D_err_raw=None,
    lam: float = 0.6, gamma: float = 0.2,
    outdir: str = ".",
) -> Dict[str, np.ndarray]:
    """Particle vs PDE vs theory.  The PDE series receive the reference's
    display transforms: v → 2·(v·10³ − λ/2), D → D·10⁶/2
    (plot_figs.py:15-26,37; SURVEY.md §2.4).  Returns the displayed PDE
    series and the theory curves."""
    beta_values = ds.PLOTFIGS_BETA if beta_values is None else np.asarray(beta_values)
    particle_v = ds.PARTICLE_V_EFF if particle_v is None else np.asarray(particle_v)
    particle_v_err = ds.PARTICLE_V_ERR if particle_v_err is None else np.asarray(particle_v_err)
    particle_D = ds.PARTICLE_D_EFF if particle_D is None else np.asarray(particle_D)
    particle_D_err = ds.PARTICLE_D_ERR if particle_D_err is None else np.asarray(particle_D_err)
    pde_v_raw = ds.PDE_V_EFF_RAW if pde_v_raw is None else np.asarray(pde_v_raw)
    pde_v_err_raw = ds.PDE_V_ERR_RAW if pde_v_err_raw is None else np.asarray(pde_v_err_raw)
    pde_D_raw = ds.PDE_D_EFF_RAW if pde_D_raw is None else np.asarray(pde_D_raw)
    pde_D_err_raw = ds.PDE_D_ERR_RAW if pde_D_err_raw is None else np.asarray(pde_D_err_raw)

    pde_v = 2.0 * (pde_v_raw * 1000.0 - lam / 2.0)
    pde_v_err = pde_v_err_raw * 1000.0
    pde_D = pde_D_raw * 1e6 / 2.0
    pde_D_err = pde_D_err_raw * 1e6 / 2.0

    beta_dense = np.linspace(0, 3, 400)
    m_beta = compute_m_of_beta(beta_dense)
    v_theory = lam * np.tanh(beta_dense * m_beta)
    D_theory = gamma + lam ** 2 / (2.0 * np.cosh(beta_dense * m_beta) ** 3)
    series = dict(pde_v=pde_v, pde_v_err=pde_v_err, pde_D=pde_D,
                  pde_D_err=pde_D_err, beta_dense=beta_dense,
                  v_theory=v_theory, D_theory=D_theory)

    plt = _pyplot()
    if plt is None:
        return series
    out = Path(outdir)
    out.mkdir(parents=True, exist_ok=True)

    plt.figure(figsize=(6, 4))
    plt.errorbar(beta_values, particle_v, yerr=particle_v_err, fmt="o",
                 capsize=4, label="Particle Sim")
    plt.errorbar(beta_values, pde_v, yerr=pde_v_err, fmt="o", capsize=4,
                 label="PDE Sim", color="lightblue")
    plt.plot(beta_dense, v_theory, "--", color="navy",
             label=r"$\lambda\tanh(\beta m_\beta)$")
    plt.xlabel(r"$\beta$")
    plt.ylabel(r"$v_{\mathrm{eff}}$")
    plt.legend()
    plt.grid()
    plt.tight_layout()
    plt.savefig(out / "PDE_v_eff_vs_beta.png", dpi=200)
    plt.close()

    plt.figure(figsize=(6, 4))
    plt.errorbar(beta_values, particle_D, yerr=particle_D_err, fmt="o",
                 capsize=4, label="Particle Sim")
    plt.errorbar(beta_values, pde_D, yerr=pde_D_err, fmt="o", capsize=4,
                 label="PDE Sim", color="lightblue")
    plt.plot(beta_dense, D_theory, "--", color="navy",
             label=r"$\gamma + \lambda^2/(2\cosh^3(\beta m_\beta))$")
    plt.xlabel(r"$\beta$")
    plt.ylabel(r"$D_{\mathrm{eff}}$")
    plt.legend()
    plt.grid()
    plt.tight_layout()
    plt.savefig(out / "PDE_D_eff_vs_beta.png", dpi=200)
    plt.close()
    return series


def plot_f_and_g(x_vals=None, f_vals=None, f_errs=None, g_vals=None,
                 g_errs=None, outdir: str = "."):
    """f/g meta-fit figure (plot_f_and_g.py:13-92).  Returns (C0, C1, C2),
    fitted before the figure is drawn (or skipped)."""
    x_vals = ds.FG_X if x_vals is None else np.asarray(x_vals)
    f_vals = ds.F_SERIES if f_vals is None else np.asarray(f_vals)
    f_errs = ds.F_ERR if f_errs is None else np.asarray(f_errs)
    g_vals = ds.G_SERIES if g_vals is None else np.asarray(g_vals)
    g_errs = ds.G_ERR if g_errs is None else np.asarray(g_errs)

    f_model = lambda x, C0, C1: C0 - C1 * x
    g_model = lambda x, C2: C2 / x ** 1.5

    (C0, C1), _ = curve_fit(f_model, x_vals, f_vals, sigma=f_errs,
                            absolute_sigma=True)
    (C2,), _ = curve_fit(g_model, x_vals, g_vals, sigma=g_errs,
                         absolute_sigma=True)

    plt = _pyplot()
    if plt is None:
        return float(C0), float(C1), float(C2)
    out = Path(outdir)
    out.mkdir(parents=True, exist_ok=True)
    x_dense = np.linspace(x_vals.min(), x_vals.max(), 300)
    plt.figure(figsize=(6, 4))
    plt.errorbar(x_vals, f_vals, yerr=f_errs, fmt="o", capsize=3,
                 label="f data", color="lightblue")
    plt.plot(x_dense, f_model(x_dense, C0, C1), "--",
             label=r"$C_0 - C_1 (\bar\rho/k)$", color="cadetblue")
    plt.errorbar(x_vals, g_vals, yerr=g_errs, fmt="o", capsize=3,
                 label="g data", color="blue")
    plt.plot(x_dense, g_model(x_dense, C2), "--",
             label=r"$C_2 / (\bar\rho/k)^{3/2}$", color="navy")
    plt.xlabel(r"$\bar\rho / k$")
    plt.ylabel(r"$\cdot(\bar\rho / k)$")
    plt.ylim(0, 5)
    plt.legend()
    plt.grid(True)
    plt.tight_layout()
    plt.savefig(out / "f_and_g_fit.png", dpi=200)
    plt.close()
    return float(C0), float(C1), float(C2)

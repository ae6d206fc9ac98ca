"""Sweep-level figures: D_eff(β) with the exclusion-theory family
(`..._sweep_beta.py:563-656`).

A copy of the JAX package's ``viz/sweep_plots.py``; where matplotlib is not
installed the figure is skipped."""
from __future__ import annotations

from pathlib import Path
from typing import Dict

import numpy as np

from hydrolim_tpu_torch.fit.veff_fit import _pyplot, derived_rates
from hydrolim_tpu_torch.theory.blocking import (
    D_eff_global,
    D_eff_theory,
    D_eff_theory_4,
)
from hydrolim_tpu_torch.theory.meanfield import (
    compute_m_of_beta,
    compute_m_of_beta_non,
)


def plot_D_eff_vs_beta(beta_values, D_means, D_ses, ps_kwargs: Dict,
                       plot_name_prefix: str = "D_eff", outdir: str = ".",
                       legacy_display_scale: float = 2.5):
    """D_eff(β) simulation points vs the non-exclusion / exclusion theory
    curves.  ``legacy_display_scale`` reproduces the reference's ×2.5
    plot-time scaling of the simulated values (`..._sweep_beta.py:602-603`,
    SURVEY.md §2.4); pass 1.0 for the unscaled physical values."""
    plt = _pyplot()
    if plt is None:
        return

    beta_values = np.asarray(beta_values, dtype=float)
    D_means = np.asarray(D_means, dtype=float)
    D_ses = np.asarray(D_ses, dtype=float)
    K, rho_bar, dx, lambda_eff, gamma_eff = derived_rates(ps_kwargs)

    beta_dense = np.linspace(beta_values.min(), max(beta_values.max(), 1e-9),
                             400)
    m_non = compute_m_of_beta_non(beta_dense)
    m_reg = compute_m_of_beta(beta_dense)

    D_global = D_eff_global(beta_dense, m_non, gamma_eff, lambda_eff)
    D_th = D_eff_theory(beta_dense, m_reg, gamma_eff, lambda_eff, m_non,
                        rho_bar, K)
    D_th4 = D_eff_theory_4(beta_dense, m_reg, gamma_eff, lambda_eff, m_non,
                           rho_bar, K)

    out = Path(outdir)
    out.mkdir(parents=True, exist_ok=True)
    plt.figure(figsize=(6, 4))
    plt.errorbar(beta_values, D_means * legacy_display_scale,
                 yerr=D_ses * legacy_display_scale, fmt="o", capsize=3,
                 label="simulation ± SE", color="blue")
    plt.plot(beta_dense, D_global, "--", color="royalblue",
             label="theory: non-exclusion")
    plt.plot(beta_dense, D_th, "--", color="navy", label="theory: exclusion")
    plt.plot(beta_dense, D_th4, "--", color="black",
             label="prediction: exclusion")
    plt.xlabel(r"$\beta$")
    plt.ylabel(r"$D_{\mathrm{eff}}$")
    plt.legend()
    plt.xlim(0, max(3, beta_values.max()))
    plt.grid(True)
    plt.tight_layout()
    plt.savefig(out / f"{plot_name_prefix}_beta.png", dpi=200)
    plt.close()

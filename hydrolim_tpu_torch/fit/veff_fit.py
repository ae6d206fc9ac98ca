"""Self-consistent negative-binomial v_eff fit + sweep-level figures.

Host-side re-implementation of ``fit_and_plot_v_eff``
(`..._sweep_beta.py:322-496`): a 2-parameter (θ, γ) curve fit of the
simulated v_eff(β) through a self-consistent NB-occupancy-tail model, plus
the three standard sweep figures (v_eff vs theory family, global m vs tanh
fixed point, p_block vs exclusion prediction).

A copy of the JAX package's ``fit/veff_fit.py`` (numpy/scipy only).
matplotlib is imported only to draw the figures; where it is not installed
the fit still runs and the figures are skipped.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, Tuple

import numpy as np
from scipy.optimize import curve_fit

from hydrolim_tpu_torch.theory.blocking import (
    p_block_prediction,
    phi_nb,
    phi_poisson,
    v_eff_fit,
    v_pred_from_phi,
    v_pred_new_theory,
    v_pred_TASEP,
    v_pred_without_phi,
)
from hydrolim_tpu_torch.theory.meanfield import (
    compute_m_of_beta,
    compute_m_of_beta_non,
)


def _pyplot():
    """matplotlib.pyplot on the Agg backend, or None (with a note) where
    matplotlib is not installed."""
    try:
        import matplotlib
    except ImportError:
        print("matplotlib is not installed: figures skipped", flush=True)
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def derived_rates(ps_kwargs: Dict) -> Tuple[int, float, float, float, float]:
    """(K, rho_bar, dx, lambda_eff, gamma_eff) from a reference-style
    ps_kwargs dict (`..._sweep_beta.py:349-353`)."""
    K = int(ps_kwargs["site_capacity"])
    rho_bar = float(ps_kwargs["N"]) / float(ps_kwargs["L"])
    dx = float(ps_kwargs["xlim"]) / float(ps_kwargs["L"])
    lambda_eff = float(ps_kwargs["rate_active"]) * dx
    gamma_eff = 0.5 * float(ps_kwargs["rate_diffusion"]) * dx ** 2
    return K, rho_bar, dx, lambda_eff, gamma_eff


def nb_self_consistent(beta_array, theta, gamma, rho_bar, K, lambda_eff,
                       n_iter: int = 6):
    """Iterate dispersion r and NB tail Φ to self-consistency
    (`..._sweep_beta.py:369-390`)."""
    beta_array = np.asarray(beta_array, dtype=float)
    m_beta = compute_m_of_beta(beta_array)
    p_plus = 0.5 * (1.0 + m_beta)
    rho_front = rho_bar * (1.0 + gamma * m_beta)
    Phi = np.array([phi_poisson(rho_front[i], K)
                    for i in range(len(beta_array))])
    for _ in range(n_iter):
        denom = lambda_eff * p_plus * (1.0 - Phi) + 1e-14
        r_arr = np.clip(theta * rho_front ** 2 / denom, 1e-6, 1e12)
        Phi = np.array([phi_nb(rho_front[i], K, r_arr[i])
                        for i in range(len(beta_array))])
    return r_arr, Phi, m_beta, rho_front


def fit_and_plot_v_eff(
    beta_values,
    ps_kwargs,
    means,
    stds,
    ses,
    m_means,
    m_stds,
    m_ses,
    rho_means,
    rho_ses,
    block_means,
    block_ses,
    theta_guess: float = 500.0,
    tau_guess: float = 1.0,
    bounds=([1e2, 0], [1e3, 10]),
    plot_result: bool = True,
    return_all: bool = True,
    outdir: str = ".",
):
    beta_values = np.asarray(beta_values, dtype=float)
    means = np.asarray(means, dtype=float)
    ses = np.asarray(ses, dtype=float)
    m_means = np.asarray(m_means, dtype=float)
    m_ses = np.asarray(m_ses, dtype=float)
    block_means = np.asarray(block_means, dtype=float)
    block_ses = np.asarray(block_ses, dtype=float)

    K, rho_bar, dx, lambda_eff, gamma_eff = derived_rates(ps_kwargs)
    m_beta = compute_m_of_beta(beta_values)

    def v_model(beta_array, theta, gamma):
        _, Phi, mb, _ = nb_self_consistent(beta_array, theta, gamma, rho_bar,
                                           K, lambda_eff)
        return v_pred_from_phi(Phi, lambda_eff, mb)

    sigma = np.where(ses > 0, ses, np.maximum(1e-6, np.nanmax(ses)))
    popt, pcov = curve_fit(v_model, beta_values, means,
                           p0=[float(theta_guess), float(tau_guess)],
                           sigma=sigma, absolute_sigma=True, bounds=bounds,
                           maxfev=2_000_000)
    theta_fit, tau_fit = popt

    beta_dense = np.linspace(beta_values.min(), max(beta_values.max(), 1e-9),
                             400)
    r_fit, Phi_nb_fit, m_dense, rho_front = nb_self_consistent(
        beta_dense, theta_fit, tau_fit, rho_bar, K, lambda_eff)
    v_nb_fit = v_pred_from_phi(Phi_nb_fit, lambda_eff, m_dense)
    Phi_po = phi_poisson(rho_bar, K)
    v_po = v_pred_from_phi(Phi_po, lambda_eff, m_dense)
    v_m = v_pred_without_phi(lambda_eff, m_dense)
    v_TASEP = v_pred_TASEP(lambda_eff, rho_bar, K, m_dense)
    m_non = compute_m_of_beta_non(beta_dense)
    v_block = v_eff_fit(rho_bar, K, beta_dense, lambda_eff, m_dense, m_non)
    v_theory = v_pred_new_theory(lambda_eff, rho_bar, K, beta_dense, m_dense,
                                 m_non, gamma_eff)

    plt = _pyplot() if plot_result else None
    if plt is not None:
        out = Path(outdir)
        out.mkdir(parents=True, exist_ok=True)

        plt.figure(figsize=(7, 5))
        plt.errorbar(beta_values, means, yerr=ses, fmt="o", capsize=3,
                     label="simulation ± SE", color="blue")
        plt.plot(beta_dense, v_m, "--", label="theory: non-exclusion",
                 lw=1.5, color="lightblue")
        plt.plot(beta_dense, v_TASEP, "--", label="theory: TASEP", lw=1.5,
                 color="royalblue")
        plt.plot(beta_dense, v_block, "--", label="prediction: exclusion",
                 lw=1.5, color="navy")
        plt.xlabel(r"$\beta$")
        plt.ylabel(r"$v_{\mathrm{eff}}$")
        plt.legend()
        plt.xlim(0, max(3, beta_values.max()))
        plt.grid(True)
        plt.tight_layout()
        plt.savefig(out / "v_eff_beta_plot_theory.png", dpi=200)
        plt.close()

        plt.figure(figsize=(6, 4))
        plt.errorbar(beta_values, m_means, yerr=m_ses, fmt="o", capsize=3,
                     label="simulation ± SE")
        plt.plot(beta_dense, m_dense, "--", color="navy",
                 label=r"theory: $m=\tanh(\beta m)$")
        plt.xlabel(r"$\beta$")
        plt.ylabel(r"$m$")
        plt.legend()
        plt.grid(True)
        plt.tight_layout()
        plt.savefig(out / "global_m_vs_theory.png", dpi=200)
        plt.close()

        plt.figure(figsize=(6, 4))
        plt.errorbar(beta_values, block_means, yerr=block_ses, fmt="o",
                     capsize=3, label=r"$p_{block}\pm$SE", color="blue")
        plt.plot(beta_dense, p_block_prediction(beta_dense, rho_bar, K), "--",
                 color="navy", label="prediction: exclusion", lw=1.5)
        plt.hlines(rho_bar / K, 0, beta_values[-1], linestyles="--",
                   color="royalblue", label="theory: TASEP", lw=1.5)
        plt.xlabel(r"$\beta$")
        plt.ylabel(r"$p$")
        plt.legend()
        plt.xlim(0, max(3, beta_values.max()))
        plt.grid(True)
        plt.tight_layout()
        plt.savefig(out / "rho_vs_rho.png", dpi=200)
        plt.close()

    fit_out = {
        "popt": popt,
        "pcov": pcov,
        "theta_fit": theta_fit,
        "tau_fit": tau_fit,
        "beta": beta_values,
        "m_beta": m_beta,
        "r_fitted_arr": r_fit,
        "Phi_nb_fit": Phi_nb_fit,
        "v_nb_fit": v_nb_fit,
        "Phi_poisson": Phi_po,
        "v_poisson": v_po,
        "rho_bar": rho_bar,
        "lambda_eff": lambda_eff,
    }
    if return_all:
        return popt, pcov, fit_out
    return popt, pcov

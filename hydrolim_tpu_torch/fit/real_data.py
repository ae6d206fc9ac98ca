"""Kinesin-II real-data validation fit.

Re-implementation of `fit_over_real_data.py`: fit the mean-field exclusion
model ``v_eff(ρ̄; k, β, λ)`` (with the frozen C0/C1/C2 constants) to the
kinesin-II effective-velocity measurements by a grid over integer capacity
k = 1..20 with a (β, λ) least-squares inner fit (:138-159), compare χ²
against the digitized TASEP-LK literature curve (:163-187), and draw the
comparison + residual figures (:193-251).

A copy of the JAX package's ``fit/real_data.py`` (numpy/scipy only).  The
figures go through ``fit.veff_fit._pyplot``: where matplotlib is not
installed the fit is returned all the same and the figures are skipped.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict

import numpy as np
from scipy.interpolate import interp1d
from scipy.optimize import least_squares

from hydrolim_tpu_torch.fit.datasets import (
    KINESIN_RHO_BAR,
    KINESIN_V_EFF,
    KINESIN_V_ERR,
    TASEP_LK_X,
    TASEP_LK_Y,
)
from hydrolim_tpu_torch.fit.veff_fit import _pyplot
from hydrolim_tpu_torch.theory.blocking import v_eff_fit


def fit_kinesin(k_range=range(1, 21), x0=(6.0, 0.29),
                bounds=([1.01, 0.0], [50.0, 1.0])) -> Dict:
    """Grid over k with (β, λ) trf least squares; returns the best fit and
    the χ² comparison with the TASEP-LK curve."""
    best = dict(cost=np.inf, k=None, beta=None, lam=None)
    for k_try in k_range:
        def residuals(params):
            beta, lam = params
            model = v_eff_fit(KINESIN_RHO_BAR, k_try, beta, lam)
            return (KINESIN_V_EFF - model) / KINESIN_V_ERR

        res = least_squares(residuals, list(x0), bounds=bounds, method="trf")
        if res.cost < best["cost"]:
            best = dict(cost=res.cost, k=k_try, beta=res.x[0], lam=res.x[1])

    chi2 = 2.0 * best["cost"]
    dof = len(KINESIN_V_EFF) - 2
    chi2_red = chi2 / dof

    # fixed TASEP-LK curve interpolated at the data abscissae (:172-184)
    interp_fit = interp1d(TASEP_LK_X, TASEP_LK_Y, kind="linear",
                          fill_value="extrapolate")
    y_at_data = interp_fit(KINESIN_RHO_BAR)
    chi2_lk = float(np.sum(((KINESIN_V_EFF - y_at_data) / KINESIN_V_ERR) ** 2))
    chi2_lk_red = chi2_lk / len(KINESIN_V_EFF)

    return dict(
        k=best["k"], beta=best["beta"], lam=best["lam"], cost=best["cost"],
        chi2=chi2, chi2_red=chi2_red, chi2_tasep_lk=chi2_lk,
        chi2_tasep_lk_red=chi2_lk_red, tasep_lk_at_data=y_at_data)


def plot_kinesin_fit(fit: Dict, outdir: str = ".") -> None:
    """Log-x comparison + residual figures (:193-251); nothing without
    matplotlib."""
    plt = _pyplot()
    if plt is None:
        return
    out = Path(outdir)
    out.mkdir(parents=True, exist_ok=True)
    rho_plot = np.logspace(np.log10(KINESIN_RHO_BAR.min()),
                           np.log10(KINESIN_RHO_BAR.max() * 1.4), 400)
    v_curve = v_eff_fit(rho_plot, fit["k"], fit["beta"], fit["lam"])

    plt.figure(figsize=(7, 5))
    plt.errorbar(KINESIN_RHO_BAR, KINESIN_V_EFF, yerr=KINESIN_V_ERR, fmt="o",
                 color="blue", capsize=3, label=r"$v_{\mathrm{eff}}$ data")
    plt.plot(rho_plot, v_curve, color="navy", lw=2,
             label=r"$v_{\mathrm{eff}}$ Mean-field")
    plt.plot(TASEP_LK_X, TASEP_LK_Y, color="lightblue",
             label=r"$v_{\mathrm{eff}}$ TASEP-LK")
    plt.xscale("log")
    plt.xlabel(r"$\bar{\rho}$")
    plt.ylabel(r"$v_{\mathrm{eff}}$")
    plt.ylim(0, 0.45)
    plt.legend()
    plt.grid()
    plt.tight_layout()
    plt.savefig(out / "KinII_fit.png", dpi=200)
    plt.close()

    v_at_data = v_eff_fit(KINESIN_RHO_BAR, fit["k"], fit["beta"], fit["lam"])
    res_mf = (KINESIN_V_EFF - v_at_data) / KINESIN_V_ERR
    res_lk = (KINESIN_V_EFF - fit["tasep_lk_at_data"]) / KINESIN_V_ERR

    plt.figure(figsize=(5, 4))
    plt.axhline(0, color="k", linestyle="--")
    plt.scatter(KINESIN_RHO_BAR, res_mf, color="navy",
                label="Mean-field residuals")
    plt.scatter(KINESIN_RHO_BAR, res_lk, color="lightblue",
                label="TASEP-LK residuals")
    plt.xscale("log")
    plt.xlabel(r"$\bar{\rho}$")
    plt.ylabel("Residuals / σ")
    plt.legend()
    plt.grid()
    plt.tight_layout()
    plt.savefig(out / "KinII_residual.png", dpi=200)
    plt.close()


def main(outdir: str = ".") -> Dict:
    """Fit, print, write ``kinesin_fit.json`` into ``outdir`` (before the
    figures, so a host without matplotlib keeps the numbers), then draw."""
    fit = fit_kinesin()
    print(f"k = {fit['k']:.6f}, beta = {fit['beta']:.6f}, "
          f"lambda = {fit['lam']:.6f}")
    print("Cost:", fit["cost"])
    print("Chi^2:", fit["chi2"], "Reduced Chi^2:", fit["chi2_red"])
    print("TASEP-LK Chi^2:", fit["chi2_tasep_lk"],
          "Reduced:", fit["chi2_tasep_lk_red"])
    out = Path(outdir)
    out.mkdir(parents=True, exist_ok=True)
    rec = {k: (v.tolist() if isinstance(v, np.ndarray) else float(v))
           for k, v in fit.items()}
    rec["k"] = int(fit["k"])
    (out / "kinesin_fit.json").write_text(json.dumps(rec, indent=1))
    plot_kinesin_fit(fit, outdir)
    return fit

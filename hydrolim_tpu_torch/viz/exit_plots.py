"""Exit dynamics of the anchored sweep: exits per anchor against β, with
the per-anchor amplitude fits (`..._sweep_beta.py:660-825`, ``plot_outs``).

The port of the JAX package's ``viz/exit_plots.py``.  Theory model:
exits(β) ≈ A · ρ̄ · Sₐ · (1 − m_β)/2 with A = T·k_exit·k_on/(k_exit + k_off),
the anchor capture amplitude Sₐ fitted per anchor by ``curve_fit``.  The
statistics and fits are computed with or without matplotlib; the figure is
drawn where it is installed (``fit.veff_fit._pyplot``).
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, List

import numpy as np
from scipy.optimize import curve_fit

from hydrolim_tpu_torch.fit.veff_fit import _pyplot
from hydrolim_tpu_torch.theory.meanfield import compute_m_of_beta


def anchor_groups(ps_kwargs: Dict) -> np.ndarray:
    """(L,) anchor index of each site (−1 off every anchor), the anchors
    ordered by position, as the reference groups exits."""
    L = int(ps_kwargs["L"])
    xlim = float(ps_kwargs["xlim"])
    anchor_positions = np.asarray(ps_kwargs["anchor_positions"], dtype=float)
    centers = np.unique(np.round((anchor_positions / xlim)
                                 * (L - 1)).astype(int))
    r_idx = int(np.ceil(float(ps_kwargs["anchor_radius"]) * L / xlim))
    site_to_gid = np.full(L, -1, dtype=int)
    for a, c in enumerate(centers):
        site_to_gid[max(0, c - r_idx):min(L - 1, c + r_idx) + 1] = a
    return site_to_gid


def exit_statistics(beta_values, n_runs_per_beta: int, ps_kwargs: Dict,
                    outs: List[List[Dict]]):
    """(total_mean, total_std, region_mean, region_std): the exits of each
    run, in total and per anchor, averaged over the runs of each β
    (population standard deviations, as the reference)."""
    site_to_gid = anchor_groups(ps_kwargs)
    L, nA = len(site_to_gid), int(site_to_gid.max()) + 1
    n_beta = len(beta_values)
    total_mean, total_std = np.zeros(n_beta), np.zeros(n_beta)
    region_mean = np.zeros((n_beta, nA))
    region_std = np.zeros((n_beta, nA))
    for iB in range(n_beta):
        totals, regions = [], []
        for run in range(n_runs_per_beta):
            out = outs[iB][run]
            exit_x = np.asarray(
                [x for x, t in zip(out["exit_positions"], out["exit_times"])
                 if np.isfinite(t)], dtype=int)
            gids = np.array([site_to_gid[x] if 0 <= x < L else -1
                             for x in exit_x])
            totals.append(len(exit_x))
            regions.append([(gids == a).sum() for a in range(nA)])
        totals = np.asarray(totals, dtype=float)
        regions = np.asarray(regions, dtype=float)
        total_mean[iB], total_std[iB] = totals.mean(), totals.std()
        region_mean[iB] = regions.mean(axis=0)
        region_std[iB] = regions.std(axis=0)
    return total_mean, total_std, region_mean, region_std


def fit_capture_amplitudes(beta_values, ps_kwargs: Dict, run_kwargs: Dict,
                           region_mean: np.ndarray,
                           region_std: np.ndarray):
    """(S_fits (nA,), A, ρ̄): each anchor's Sₐ in
    exits(β) = A·ρ̄·Sₐ·(1 − m_β)/2, weighted by the runs' spread."""
    beta_values = np.asarray(beta_values, dtype=float)
    K = int(ps_kwargs["site_capacity"])
    T_sim = float(run_kwargs["T"])
    k_exit = float(ps_kwargs["k_exit"])
    k_on = float(ps_kwargs["k_on"])
    k_off = float(ps_kwargs["k_off"])
    rho_bar = float(ps_kwargs["N"]) / int(ps_kwargs["L"]) / K
    A = T_sim * k_exit * (k_on / (k_exit + k_off))
    shape_beta = 0.5 * (1.0 - compute_m_of_beta(beta_values))

    S_fits = []
    for a in range(region_mean.shape[1]):
        def region_model(beta_arr, S_i):
            return A * (rho_bar * S_i) * shape_beta

        popt, _ = curve_fit(region_model, beta_values, region_mean[:, a],
                            sigma=region_std[:, a] + 1e-8,
                            absolute_sigma=True, p0=[1.0], maxfev=2_000_000)
        S_fits.append(popt[0])
    return np.asarray(S_fits), A, rho_bar


def plot_outs(beta_values, n_runs_per_beta: int, ps_kwargs: Dict,
              run_kwargs: Dict, outs: List[List[Dict]],
              do_theory_fit: bool = True, plot_theory: bool = True,
              outdir: str = "."):
    """Returns (total_mean, total_std, region_mean, region_std) like the
    reference, and saves ``exits_vs_beta.png`` where matplotlib is
    installed."""
    beta_values = np.asarray(beta_values, dtype=float)
    total_mean, total_std, region_mean, region_std = exit_statistics(
        beta_values, n_runs_per_beta, ps_kwargs, outs)
    plt = _pyplot()
    if plt is None:
        return total_mean, total_std, region_mean, region_std
    nA = region_mean.shape[1]
    plt.figure(figsize=(9, 6))
    colors = plt.get_cmap("Blues")
    for a in range(nA):
        plt.errorbar(beta_values, region_mean[:, a], yerr=region_std[:, a],
                     fmt="o", markersize=5, capsize=3,
                     color=colors(0.5 + 0.1 * a), label=f"anchor {a}")
    plt.errorbar(beta_values, total_mean, yerr=total_std, fmt="o",
                 markersize=6, capsize=3, color=colors(0.9),
                 label="total exits")
    if do_theory_fit:
        S_fits, A, rho_bar = fit_capture_amplitudes(
            beta_values, ps_kwargs, run_kwargs, region_mean, region_std)
        if plot_theory:
            beta_dense = np.linspace(beta_values.min(),
                                     max(beta_values.max(), 1e-9), 400)
            shape_dense = 0.5 * (1.0 - compute_m_of_beta(beta_dense))
            total_theory = np.zeros_like(beta_dense)
            for a in range(nA):
                curve = A * rho_bar * S_fits[a] * shape_dense
                total_theory += curve
                plt.plot(beta_dense, curve, "-", color=colors(0.55 + 0.1 * a),
                         label=f"anchor {a} (theory: S={S_fits[a]:.3g})")
            plt.plot(beta_dense, total_theory, "--", color=colors(0.9),
                     label="total (theory)", lw=2)
    plt.xlabel(r"$\beta$")
    plt.ylabel("Number of exits (final timestep)")
    plt.title("Exits per anchor vs β")
    plt.grid(True)
    plt.legend()
    plt.tight_layout()
    out_path = Path(outdir)
    out_path.mkdir(parents=True, exist_ok=True)
    plt.savefig(out_path / "exits_vs_beta.png", dpi=200)
    plt.close()
    return total_mean, total_std, region_mean, region_std

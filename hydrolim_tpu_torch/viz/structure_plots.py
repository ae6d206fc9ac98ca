"""Local-structure sweep figures.

Re-creation of the pattern-formation figure inventory
(PARTICLE_solver_BIOLOGY_local_structure.py:267-622, 13 plot functions +
the ``run_all_plots`` driver :643).  All functions take the β→observables
map produced by :func:`hydrolim_tpu_torch.sweeps.local_structure.
sweep_betas_for_structures` and write PNGs into ``outdir``.

The port of the JAX package's ``viz/structure_plots.py``: where matplotlib
is not installed (``fit.veff_fit._pyplot`` returns None) every figure is
skipped.
"""
from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np

from hydrolim_tpu_torch.fit.veff_fit import _pyplot
from hydrolim_tpu_torch.observables.structure import (
    cluster_size_distribution,
    ensemble_time_to_pattern,
    extract_growth_rate,
    lowk_variance_time,
    mode_competition_ratio,
    spectral_entropy,
    temporal_autocorrelation,
)


def _betas(results):
    return np.asarray(sorted(results.keys()))


def _errbar_vs_beta(results, value_key, se_key, ylabel, fname, outdir,
                    transform=lambda v: v):
    plt = _pyplot()
    if plt is None:
        return
    betas = _betas(results)
    vals = np.array([transform(results[b][value_key]) for b in betas])
    errs = np.array([results[b].get(se_key, 0.0) for b in betas])
    plt.figure(figsize=(6, 4))
    plt.errorbar(betas, vals, yerr=errs, fmt="o-", capsize=3, color="navy")
    plt.xlabel(r"$\beta$")
    plt.ylabel(ylabel)
    plt.grid(True)
    plt.tight_layout()
    plt.savefig(Path(outdir) / fname, dpi=300)
    plt.close()


def plot_lowk_power_vs_beta(results, outdir="."):
    _errbar_vs_beta(results, "low_k_power_mean", "low_k_power_se",
                    r"low-$k$ power $\sum_{k<25}|A_k|$",
                    "lowk_power_vs_beta.png", outdir)


def plot_variance_vs_beta(results, outdir="."):
    _errbar_vs_beta(results, "var_mean", "var_se", r"Var$(\rho)$",
                    "variance_vs_beta.png", outdir)


def plot_m_local_var_vs_beta(results, outdir="."):
    _errbar_vs_beta(results, "m_local_var_mean", "m_local_var_se",
                    r"Var$(m_{local})$", "m_local_var_vs_beta.png", outdir)


def plot_dominant_wavelength_vs_beta(results, L: int = 1000, outdir="."):
    plt = _pyplot()
    if plt is None:
        return
    betas = _betas(results)
    ks = np.array([max(1, results[b]["dominant_k_mode"]) for b in betas])
    plt.figure(figsize=(6, 4))
    # wavelength in SITES, L/k* (..._local_structure.py:288) — not 1/k*
    plt.plot(betas, float(L) / ks, "o-", color="navy")
    plt.xlabel(r"$\beta$")
    plt.ylabel(r"dominant wavelength $L/k^*$")
    plt.grid(True)
    plt.tight_layout()
    plt.savefig(Path(outdir) / "dominant_wavelength_vs_beta.png", dpi=300)
    plt.close()


def plot_fft_spectrum_heatmap(results, k_max: int = 40, outdir="."):
    plt = _pyplot()
    if plt is None:
        return
    betas = _betas(results)
    # drop the k=0 column like the reference (spectra[:, 1:201]) — |A_0| is
    # the total mass (~N), which would saturate the color scale and render
    # every pattern mode flat
    spec = np.stack([results[b]["fft_mean_mean"][1:k_max] for b in betas])
    plt.figure(figsize=(7, 5))
    plt.imshow(spec, aspect="auto", origin="lower",
               extent=[1, k_max, betas[0], betas[-1]], cmap="viridis")
    plt.colorbar(label=r"$\langle|A_k|\rangle$")
    plt.xlabel(r"$k$")
    plt.ylabel(r"$\beta$")
    plt.tight_layout()
    plt.savefig(Path(outdir) / "fft_spectrum_heatmap.png", dpi=300)
    plt.close()


def plot_lowk_modes_vs_beta(results, k_max: int = 5, outdir="."):
    plt = _pyplot()
    if plt is None:
        return
    betas = _betas(results)
    plt.figure(figsize=(6, 4))
    colors = plt.cm.Blues(np.linspace(0.4, 0.9, k_max))
    for k in range(1, k_max + 1):
        amps = [results[b]["fft_mean_mean"][k] for b in betas]
        errs = [results[b]["fft_mean_se"][k] for b in betas]
        plt.errorbar(betas, amps, yerr=errs, fmt="o-", capsize=3,
                     color=colors[k - 1], label=f"k={k}")
    plt.xlabel(r"$\beta$")
    plt.ylabel(r"$\langle|A_k|\rangle$")
    plt.legend()
    plt.grid(True)
    plt.tight_layout()
    plt.savefig(Path(outdir) / "lowk_modes_vs_beta.png", dpi=300)
    plt.close()


def plot_lowk_variance_time(results, k_cut: int = 25, outdir="."):
    plt = _pyplot()
    if plt is None:
        return
    betas = _betas(results)
    plt.figure(figsize=(7, 5))
    colors = plt.cm.Blues(np.linspace(0.35, 0.9, len(betas)))
    for b, c in zip(betas, colors):
        raws = [r for r in results[b].get("raw") or [] if r.get("out")]
        if not raws:                      # keep_outs=False leaves out=None
            continue
        series = np.stack([lowk_variance_time(r["out"], k_cut)
                           for r in raws])
        t = raws[0]["out"]["times_obs"]
        # sqrt like the reference figure (..._local_structure.py:367)
        plt.plot(t, np.sqrt(series.mean(axis=0)), color=c,
                 label=rf"$\beta={b:.2f}$")
    plt.xlabel("t")
    plt.ylabel(r"$\sqrt{\sum_{k \leq 25}|A_k|^2}$")
    plt.legend(ncol=2, fontsize=8)
    plt.grid(True)
    plt.tight_layout()
    plt.savefig(Path(outdir) / "lowk_variance_time.png", dpi=300)
    plt.close()


def plot_mode_growth_time(results, k: int = 1, outdir="."):
    plt = _pyplot()
    if plt is None:
        return
    betas = _betas(results)
    plt.figure(figsize=(7, 5))
    colors = plt.cm.Blues(np.linspace(0.35, 0.9, len(betas)))
    for b, c in zip(betas, colors):
        raws = [r for r in results[b].get("raw") or [] if r.get("out")]
        if not raws:                      # keep_outs=False leaves out=None
            continue
        amps = np.stack([np.asarray(r["out"]["fft_amp_list"])[:, k]
                         for r in raws])
        t = raws[0]["out"]["times_obs"]
        plt.semilogy(t, amps.mean(axis=0), color=c, label=rf"$\beta={b:.2f}$")
    plt.xlabel("t")
    plt.ylabel(rf"$|A_{k}(t)|$")
    plt.legend(ncol=2, fontsize=8)
    plt.grid(True)
    plt.tight_layout()
    plt.savefig(Path(outdir) / f"mode_{k}_growth_time.png", dpi=300)
    plt.close()


def plot_dominant_mode_amplitude_vs_beta(results, outdir="."):
    plt = _pyplot()
    if plt is None:
        return
    betas = _betas(results)
    amps, errs = [], []
    for b in betas:
        # the reference recomputes k* = argmax of the ensemble-MEAN
        # spectrum per beta (..._local_structure.py:414-423) — the rounded
        # mean of per-run dominant modes can name a mode dominant in no run
        spec = np.asarray(results[b]["fft_mean_mean"])
        k_star = int(np.argmax(spec[1:]) + 1)
        amps.append(spec[k_star])
        errs.append(results[b]["fft_mean_se"][k_star])
    plt.figure(figsize=(6, 4))
    plt.errorbar(betas, amps, yerr=errs, fmt="o-", capsize=3, color="navy")
    plt.xlabel(r"$\beta$")
    plt.ylabel(r"$\langle|A_{k^*}|\rangle$")
    plt.grid(True)
    plt.tight_layout()
    plt.savefig(Path(outdir) / "dominant_mode_amplitude_vs_beta.png", dpi=300)
    plt.close()


def plot_spectral_entropy_vs_beta(results, k_max: int = 25, outdir="."):
    plt = _pyplot()
    if plt is None:
        return
    betas = _betas(results)
    ent = [spectral_entropy(results[b]["fft_mean_mean"], k_max)
           for b in betas]
    plt.figure(figsize=(6, 4))
    plt.plot(betas, ent, "o-", color="navy")
    plt.xlabel(r"$\beta$")
    plt.ylabel("spectral entropy")
    plt.grid(True)
    plt.tight_layout()
    plt.savefig(Path(outdir) / "spectral_entropy_vs_beta.png", dpi=300)
    plt.close()


def plot_mode_competition_vs_beta(results, outdir="."):
    plt = _pyplot()
    if plt is None:
        return
    betas = _betas(results)
    mcr = [mode_competition_ratio(results[b]["fft_mean_mean"])
           for b in betas]
    plt.figure(figsize=(6, 4))
    plt.plot(betas, mcr, "o-", color="navy")
    plt.xlabel(r"$\beta$")
    plt.ylabel("mode-competition ratio")
    plt.grid(True)
    plt.tight_layout()
    plt.savefig(Path(outdir) / "mode_competition_vs_beta.png", dpi=300)
    plt.close()


def plot_growth_rate_vs_beta(results, k: int = 1, t_min: float = 0.0,
                             t_max: Optional[float] = None, outdir="."):
    plt = _pyplot()
    if plt is None:
        return
    betas = _betas(results)
    means, errs = [], []
    for b in betas:
        raws = results[b].get("raw") or []
        rates = [g for r in raws if r.get("out")
                 if np.isfinite(g := extract_growth_rate(
                     r["out"], k=k, t_min=t_min, t_max=t_max))]
        means.append(np.mean(rates) if rates else np.nan)
        errs.append(np.std(rates) / np.sqrt(len(rates)) if len(rates) > 1
                    else 0.0)
    plt.figure(figsize=(6, 4))
    plt.errorbar(betas, means, yerr=errs, fmt="o-", capsize=3, color="navy")
    plt.xlabel(r"$\beta$")
    plt.ylabel(rf"growth rate of $|A_{k}|$")
    plt.grid(True)
    plt.tight_layout()
    plt.savefig(Path(outdir) / "growth_rate_vs_beta.png", dpi=300)
    plt.close()


def plot_time_to_pattern_vs_beta(results, threshold: float = 0.05,
                                 k: int = 1, outdir="."):
    plt = _pyplot()
    if plt is None:
        return
    betas = _betas(results)
    means, errs = [], []
    for b in betas:
        raws = [r["out"] for r in (results[b].get("raw") or [])
                if r.get("out")]
        m, e = ensemble_time_to_pattern(raws, k=k, threshold=threshold)
        means.append(m)
        errs.append(e)
    plt.figure(figsize=(6, 4))
    plt.errorbar(betas, means, yerr=errs, fmt="o-", capsize=3, color="navy")
    plt.xlabel(r"$\beta$")
    plt.ylabel("time to pattern")
    plt.grid(True)
    plt.tight_layout()
    plt.savefig(Path(outdir) / "time_to_pattern_vs_beta.png", dpi=300)
    plt.close()


def plot_cluster_distribution(out, threshold: float, label=None, outdir="."):
    plt = _pyplot()
    if plt is None:
        return
    sizes = cluster_size_distribution(np.asarray(out["total_list"])[-1],
                                      threshold)
    plt.figure(figsize=(6, 4))
    if sizes.size:
        plt.hist(sizes, bins=min(20, max(3, sizes.max())), edgecolor="k")
    plt.xlabel("cluster size")
    plt.ylabel("count")
    if label:
        plt.title(label)
    plt.grid(True)
    plt.tight_layout()
    plt.savefig(Path(outdir) / "cluster_distribution.png", dpi=300)
    plt.close()


def plot_autocorrelation_vs_beta(results, lag: int = 1, outdir="."):
    plt = _pyplot()
    if plt is None:
        return
    betas = _betas(results)
    vals = []
    for b in betas:
        raws = results[b].get("raw") or []
        acs = [temporal_autocorrelation(r["out"], lag) for r in raws
               if r.get("out")]
        vals.append(np.mean(acs) if acs else np.nan)
    plt.figure(figsize=(6, 4))
    plt.plot(betas, vals, "o-", color="navy")
    plt.xlabel(r"$\beta$")
    plt.ylabel(rf"$\langle\rho_t\rho_{{t+{lag}}}\rangle$")
    plt.grid(True)
    plt.tight_layout()
    plt.savefig(Path(outdir) / "autocorrelation_vs_beta.png", dpi=300)
    plt.close()


def run_all_plots(results, outdir=".", L: int = 1000):
    """All sweep-level structure figures (:643); none where matplotlib is
    not installed."""
    Path(outdir).mkdir(parents=True, exist_ok=True)
    if _pyplot() is None:
        return
    plot_lowk_power_vs_beta(results, outdir)
    plot_variance_vs_beta(results, outdir)
    plot_m_local_var_vs_beta(results, outdir)
    plot_dominant_wavelength_vs_beta(results, L, outdir)
    plot_fft_spectrum_heatmap(results, outdir=outdir)
    plot_lowk_modes_vs_beta(results, outdir=outdir)
    plot_dominant_mode_amplitude_vs_beta(results, outdir)
    plot_spectral_entropy_vs_beta(results, outdir=outdir)
    plot_mode_competition_vs_beta(results, outdir)
    plot_time_to_pattern_vs_beta(results, outdir=outdir)
    # keep_outs=False leaves 'raw' entries with out=None — the time-series
    # figures need the actual out dicts, not just the raw list
    has_raw = any(r.get("out")
                  for b in results for r in results[b].get("raw") or [])
    if has_raw:
        plot_lowk_variance_time(results, outdir=outdir)
        plot_mode_growth_time(results, outdir=outdir)
        plot_growth_rate_vs_beta(results, outdir=outdir)
        plot_autocorrelation_vs_beta(results, outdir=outdir)

"""(σ, β) double sweep — interaction-range dependence.

The port of the JAX package's ``sweeps/sigma_sweep.py``
(`PARTICLE_solver_BIOLOGY_EXCLUSION_sweep_beta_2.py`):
``sweep_over_sigmas`` (:1030-1075) loops the β-sweep over kernel widths σ
(σ=0 → global magnetization), one batched (β × replicas) grid per σ,
saves the per-σ npz and the cross-σ archive, and the four cross-σ
figures (:1077-1275) are drawn where matplotlib is installed.

``engine`` goes to ``sweep_over_betas``: ``'particle'`` (the default, as
in the JAX package) runs each σ on the general τ-leap step,
``'lattice_gas'`` on the plain-torch slot engines, the fused names on
kernel B3/B4.  The JAX package's ``ckpt_dir=`` and ``n_devices=`` are not
ported yet (ROADMAP.md §A).
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np

from hydrolim_tpu_torch.core.scope import not_ported
from hydrolim_tpu_torch.fit.veff_fit import _pyplot, derived_rates
from hydrolim_tpu_torch.sweeps.beta_sweep import (
    DEFAULT_PS_KWARGS,
    sweep_over_betas,
)
from hydrolim_tpu_torch.theory.blocking import (
    v_eff_fit,
    v_pred_TASEP,
    v_pred_without_phi,
)
from hydrolim_tpu_torch.theory.meanfield import (
    compute_m_of_beta,
    compute_m_of_beta_non,
)

# The reference σ-sweep runs 10× slower diffusion than the β-sweep
# (PARTICLE_solver_BIOLOGY_EXCLUSION_sweep_beta_2.py:836-856:
# rate_diffusion = 0.002 vs 0.02; everything else matches).
SIGMA_SWEEP_PS_KWARGS: Dict = dict(DEFAULT_PS_KWARGS, rate_diffusion=0.002)

# reference __main__ grid (:1277-1285)
REFERENCE_SIGMA_VALUES = [1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2, 0.1, 0.3, 0]


def sweep_over_sigmas(sigma_values: Sequence[float], beta_values,
                      n_runs_per_beta: int = 5, run: bool = True,
                      ps_kwargs: Optional[Dict] = None,
                      run_kwargs: Optional[Dict] = None,
                      outdir: str = ".", seed: int = 0,
                      archive: str = "v_eff_all_sigmas.npz",
                      resume: bool = True, engine: str = "particle",
                      n_devices: Optional[int] = None, ckpt_dir=None,
                      device="cuda") -> Dict:
    """{σ: {beta, v_mean, v_se, D_mean, D_se, ps_kwargs}} (:1030-1075).

    ``resume=True`` reloads σ values whose per-σ npz already exists
    (restart semantics after a crash or interruption); ``run=False``
    reloads the cross-σ archive.  ``engine`` is passed to
    ``sweep_over_betas`` (``'particle'``, its fused names or
    ``'lattice_gas'``)."""
    if ckpt_dir is not None:
        raise not_ported("ckpt_dir=", "checkpointing")
    if n_devices is not None:
        raise not_ported("n_devices=", "parallelism")
    out = Path(outdir)
    out.mkdir(parents=True, exist_ok=True)
    beta_values = np.asarray(beta_values, dtype=float)
    if not run:
        data = np.load(out / archive, allow_pickle=True)
        return data["results"].item()

    results = {}
    for k_idx, sigma in enumerate(sigma_values):
        pk = dict(SIGMA_SWEEP_PS_KWARGS, **(ps_kwargs or {}))
        pk["local_kernel_sigma"] = float(sigma)
        npz_path = out / f"v_eff_vs_beta_sigma_{sigma:.4g}.npz"
        if resume and npz_path.exists():
            data = dict(np.load(npz_path, allow_pickle=True))
            save_dict = {"means": data["means"], "ses": data["ses"],
                         "D_means": data["D_means"], "D_ses": data["D_ses"]}
        else:
            save_dict = sweep_over_betas(
                beta_values, n_runs_per_beta=n_runs_per_beta, run=True,
                ps_kwargs=pk, run_kwargs=run_kwargs, npz_path=str(npz_path),
                outdir=str(out), seed=seed + 1000 * k_idx, do_fit=False,
                plot_result=False, engine=engine, device=device)
        results[float(sigma)] = {
            "beta": beta_values,
            "v_mean": save_dict["means"],
            "v_se": save_dict["ses"],
            "D_mean": save_dict["D_means"],
            "D_se": save_dict["D_ses"],
            "ps_kwargs": {k: v for k, v in pk.items() if not callable(v)},
        }
    np.savez(out / archive, results=np.asarray(results, dtype=object))
    return results


# ---------------------------------------------------------------------------
# cross-σ figures (:1077-1275), skipped where matplotlib is not installed
# ---------------------------------------------------------------------------

def _theory_curves(results):
    first = results[next(iter(results))]
    K, rho_bar, dx, lambda_eff, _ = derived_rates(first["ps_kwargs"])
    beta_dense = np.linspace(0, 3, 400)
    m_d = compute_m_of_beta(beta_dense)
    m_non = compute_m_of_beta_non(beta_dense)
    return beta_dense, dict(
        non=v_pred_without_phi(lambda_eff, m_d),
        tasep=v_pred_TASEP(lambda_eff, rho_bar, K, m_d),
        excl=v_eff_fit(rho_bar, K, beta_dense, lambda_eff, m_d, m_non))


def plot_v_eff_all_sigmas(results: Dict, outdir: str = ".") -> None:
    plt = _pyplot()
    if plt is None:
        return
    beta_dense, th = _theory_curves(results)
    plt.figure(figsize=(7, 5))
    blues = plt.cm.Blues(np.linspace(0.35, 0.9, len(results)))
    for sigma, color in zip(sorted(results.keys()), blues):
        r = results[sigma]
        plt.errorbar(r["beta"], r["v_mean"], yerr=r["v_se"], fmt="o-",
                     capsize=3, color=color, label=rf"$\sigma={sigma:.3g}$")
    plt.plot(beta_dense, th["non"], "--", color="lightblue",
             label="theory: non-exclusion")
    plt.plot(beta_dense, th["tasep"], "--", color="royalblue",
             label="theory: TASEP")
    plt.plot(beta_dense, th["excl"], "--", color="navy",
             label="prediction: exclusion")
    plt.xlabel(r"$\beta$")
    plt.ylabel(r"$v_{\mathrm{eff}}$")
    plt.legend(ncol=2, fontsize=8)
    plt.grid(True)
    plt.tight_layout()
    plt.savefig(Path(outdir) / "v_eff_vs_beta_all_sigmas.png", dpi=200)
    plt.close()


def plot_D_eff_all_sigmas(results: Dict, outdir: str = ".",
                          legacy_display_scale: float = 2.5) -> None:
    plt = _pyplot()
    if plt is None:
        return
    plt.figure(figsize=(7, 5))
    blues = plt.cm.Blues(np.linspace(0.35, 0.9, len(results)))
    for sigma, color in zip(sorted(results.keys()), blues):
        r = results[sigma]
        plt.errorbar(r["beta"], legacy_display_scale * np.asarray(r["D_mean"]),
                     yerr=legacy_display_scale * np.asarray(r["D_se"]),
                     fmt="o-", capsize=3, color=color,
                     label=rf"$\sigma={sigma:.3g}$")
    plt.xlabel(r"$\beta$")
    plt.ylabel(r"$D_{\mathrm{eff}}$")
    plt.legend(ncol=2, fontsize=8)
    plt.grid(True)
    plt.tight_layout()
    plt.savefig(Path(outdir) / "D_eff_vs_beta_all_sigmas.png", dpi=200)
    plt.close()


def _vs_sigma(results: Dict, key: str, err_key: str, fname: str,
              outdir: str, scale: float = 1.0) -> None:
    plt = _pyplot()
    if plt is None:
        return
    sigmas_pos = [s for s in sorted(results.keys()) if s > 0]
    beta_vals = results[sigmas_pos[0]]["beta"]
    plt.figure(figsize=(7, 5))
    blues = plt.cm.Blues(np.linspace(0.35, 0.9, len(beta_vals)))
    for i, (beta, color) in enumerate(zip(beta_vals, blues)):
        vals = [scale * results[s][key][i] for s in sigmas_pos]
        errs = [scale * results[s][err_key][i] for s in sigmas_pos]
        plt.errorbar(sigmas_pos, vals, yerr=errs, fmt="o", capsize=3,
                     color=color, label=rf"$\beta={beta:.2f}$")
        if 0.0 in results:  # σ=0 (global m) plotted at σ=1 (:1209-1218),
            # UNSCALED — the reference applies the 2.5 display scale to
            # the σ>0 series only (:1249-1266)
            plt.errorbar(1.0, results[0.0][key][i],
                         yerr=results[0.0][err_key][i], fmt="o",
                         markersize=6, capsize=3, color=color)
    plt.xscale("log")
    plt.xlabel(r"$\sigma$")
    plt.ylabel(key)
    plt.legend(ncol=2, fontsize=8)
    plt.grid(True)
    plt.tight_layout()
    plt.savefig(Path(outdir) / fname, dpi=200)
    plt.close()


def plot_v_eff_vs_sigma_all_beta(results: Dict, outdir: str = ".") -> None:
    _vs_sigma(results, "v_mean", "v_se", "v_eff_vs_sigma_all_beta.png", outdir)


def plot_D_eff_vs_sigma_all_beta(results: Dict, outdir: str = ".",
                                 legacy_display_scale: float = 2.5) -> None:
    _vs_sigma(results, "D_mean", "D_se", "D_eff_vs_sigma_all_beta.png",
              outdir, scale=legacy_display_scale)

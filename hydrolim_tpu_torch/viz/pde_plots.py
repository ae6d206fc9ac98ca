"""PDE figures — re-creation of ``IMEXPDE.plot_all``/``plot_individual``
(IMEX_PDE_solver_class.py:309-462).

A copy of the JAX package's ``viz/pde_plots.py``; where matplotlib is not
installed the figures are skipped."""
from __future__ import annotations

from pathlib import Path
from typing import Dict

import numpy as np

from hydrolim_tpu_torch.fit.veff_fit import _pyplot
from hydrolim_tpu_torch.theory.meanfield import m_fixed_point


def plot_all(pde, out: Dict) -> None:
    """3×2 summary panel (:309-346)."""
    plt = _pyplot()
    if plt is None:
        return
    t = np.linspace(0, pde.T, len(out["m_series"]))
    fig, axs = plt.subplots(3, 2, figsize=(12, 10))

    axs[0, 0].plot(t, out["m_series"])
    axs[0, 0].set_title("Global magnetization")

    # clamp to the recorded kmax (fft_kmax may be < 7), like plot_individual
    k_vals = range(1, min(7, out["fft_amp"].shape[1]))
    colors = plt.cm.Blues(np.linspace(0.4, 0.9, max(len(list(k_vals)), 1)))
    for k, c in zip(k_vals, colors):
        axs[0, 1].plot(t, out["fft_amp"][:, k], color=c, label=f"k={k}")
    axs[0, 1].legend()
    axs[0, 1].set_title("Fourier amplitudes")

    for k, c in zip(k_vals, colors):
        axs[1, 0].plot(t, np.unwrap(np.angle(out["fft_phase"][:, k])),
                       color=c, label=f"k={k}")
    axs[1, 0].set_title("Unwrapped phase")
    axs[1, 0].legend()

    axs[1, 1].plot(t, out["var_series"])
    axs[1, 1].set_title("Variance")

    im0 = axs[2, 0].imshow(out["snapshots"], aspect="auto", origin="lower",
                           extent=[0, pde.config.xlim, 0, out["times"][-1]])
    plt.colorbar(im0, ax=axs[2, 0])
    im1 = axs[2, 1].imshow(out["m_snapshots"], aspect="auto", origin="lower",
                           extent=[0, pde.config.xlim, 0, out["times"][-1]])
    plt.colorbar(im1, ax=axs[2, 1])

    pde.outdir.mkdir(parents=True, exist_ok=True)
    plt.savefig(pde.outdir / "summary.png", dpi=200)
    plt.close(fig)


def plot_individual(pde, out: Dict, k_max: int = 6) -> None:
    """Individual figures incl. v_eff/D_eff vs theory lines (:348-462)."""
    plt = _pyplot()
    if plt is None:
        return
    t = np.linspace(0, pde.T, len(out["m_series"]))
    pde.outdir.mkdir(parents=True, exist_ok=True)
    od = Path(pde.outdir)

    def simple(y, ylabel, fname):
        plt.figure(figsize=(6, 4))
        plt.plot(t, y)
        plt.xlabel("t")
        plt.ylabel(ylabel)
        plt.grid()
        plt.savefig(od / fname, dpi=200)
        plt.close()

    simple(out["m_series"], "m(t)", "m_global.png")
    simple(out["var_series"], "Var(t)", "variance.png")

    k_vals = list(range(1, min(k_max + 1, out["fft_amp"].shape[1])))
    colors = plt.cm.Blues(np.linspace(0.4, 0.9, len(k_vals)))

    plt.figure(figsize=(6, 4))
    for k, c in zip(k_vals, colors):
        plt.plot(t, out["fft_amp"][:, k], color=c, label=f"k={k}", alpha=0.75)
    plt.xlabel("t")
    plt.ylabel(r"$|A_k(t)|$")
    plt.legend()
    plt.grid()
    plt.savefig(od / "fft_amplitudes.png", dpi=200)
    plt.close()

    plt.figure(figsize=(6, 4))
    for k, c in zip(k_vals, colors):
        plt.plot(t, np.unwrap(np.angle(out["fft_phase"][:, k])), color=c,
                 label=f"k={k}")
    plt.xlabel("t")
    plt.ylabel(r"unwrap Arg$(A_k)$")
    plt.legend()
    plt.grid()
    plt.savefig(od / "fft_phase_unwrapped.png", dpi=200)
    plt.close()

    for arr, cmap, label, fname, kw in (
            (out["snapshots"], "viridis", r"$\rho_+ + \rho_-$",
             "spacetime_total.png", {}),
            (out["m_snapshots"], "coolwarm", r"$\rho_+ - \rho_-$",
             "spacetime_magnetization.png", dict(vmin=-1, vmax=1))):
        plt.figure(figsize=(8, 5))
        plt.imshow(arr, aspect="auto", origin="lower",
                   extent=[0, pde.config.xlim, 0, out["times"][-1]],
                   cmap=cmap, **kw)
        plt.colorbar(label=label)
        plt.xlabel("x")
        plt.ylabel("t")
        plt.tight_layout()
        plt.savefig(od / fname, dpi=200)
        plt.close()

    m_beta = m_fixed_point(pde.beta) if pde.beta > 0 else 0.0
    v_th = pde.lam * np.tanh(pde.beta * m_beta)
    plt.figure(figsize=(6, 4))
    plt.plot(t, out["v_eff_series"], label=r"$v_{\mathrm{eff}}(t)$")
    plt.axhline(v_th, ls="--", color="k", label=r"$\lambda\tanh(\beta m_\beta)$")
    plt.axhline(-v_th, ls="--", color="k")
    plt.xlabel("t")
    plt.ylabel("velocity")
    plt.xlim(0, pde.T)
    plt.ylim(-1, 1)
    plt.legend()
    plt.grid()
    plt.savefig(od / "v_eff.png", dpi=200)
    plt.close()

    D_th = pde.gamma + pde.lam ** 2 / (2 * np.cosh(pde.beta * m_beta) ** 3)
    plt.figure(figsize=(6, 4))
    plt.plot(t, out["D_eff_series"], label=r"$D_{\mathrm{eff}}(t)$")
    plt.axhline(D_th, ls="--", color="k",
                label=r"$\gamma + \lambda^2/(2\cosh^3(\beta m_\beta))$")
    plt.xlabel("t")
    plt.ylabel("diffusion")
    plt.xlim(0, pde.T)
    plt.legend()
    plt.grid()
    plt.savefig(od / "D_eff.png", dpi=200)
    plt.close()

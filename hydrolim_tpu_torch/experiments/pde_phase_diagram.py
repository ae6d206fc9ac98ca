"""Dense (β × σ) PDE phase diagram through the fused solve (kernel B2).

The counterpart of the JAX package's ``experiments/run_pde_phase_diagram.py``:
32 β × 16 σ × 2 seeds = 1024 replicas at the reference per-replica scale
(L=1000, dt=5e-4, T=10, 64 tracers).  Each σ is one batched solve of
32 β × n_seeds replicas (σ sets the smoothing operand, shared by the
batch).  ``--engine`` takes the JAX names (``auto``, ``pallas``, ``xla``),
which all run the one fused solve (``pde.fast_solve.PDE_ENGINES``); the
JSON records the name given and the route taken.

Read-outs per (β, σ):
- order parameter |⟨m⟩_t| (abs of the late-window time mean): the flocking
  transition, β_c = 1 in the mean-field (σ → ∞) limit;
- band contrast std_x(ρ)/mean_x(ρ) at final time (spatial structure).

Usage: python -m hydrolim_tpu_torch.experiments.pde_phase_diagram
       [--small] [--outdir DIR] [--device cuda|cpu]
       [--engine auto|pallas|xla] [--replot]
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from hydrolim_tpu_torch.core.config import PDEConfig
from hydrolim_tpu_torch.fit.veff_fit import _pyplot
from hydrolim_tpu_torch.pde.fast_solve import PDERun
from hydrolim_tpu_torch.sweeps.pde_sweeps import run_pde_ensemble

# σ from ~2 grid sites (narrow taps) through the full circulant to the
# reference's quasi-global sentinel (exact global mean)
FULL_SIGMAS = list(np.geomspace(0.002, 2.0, 15)) + [1e5 - 10]


def run_grid(beta_values, sigma_values, n_seeds, *, L, T, dt, gamma, lam,
             n_tracers, seed=0, device="cuda", engine="auto"):
    """One batched solve per σ; returns a dict of (n_sigma, n_beta) grids
    and each row's wall time."""
    nb, ns = len(beta_values), n_seeds
    nsteps = int(round(T / dt))
    t = np.linspace(0.0, T, nsteps + 1)
    late = t >= 0.6 * T
    m_grid = np.zeros((len(sigma_values), nb))
    band_grid = np.zeros_like(m_grid)
    v_grid = np.zeros_like(m_grid)
    walls = []
    for si, sigma in enumerate(sigma_values):
        config = PDEConfig(L=L, T=T, dt=dt, bc="periodic",
                           active_model="bidirectional",
                           gaussian_kernel=True, kernel_sigma=float(sigma),
                           snapshot_interval=nsteps, fft_kmax=8,
                           n_tracers=n_tracers)
        t0 = time.perf_counter()
        res, _ = run_pde_ensemble(config, beta_values, gamma=gamma, lam=lam,
                                  n_runs=ns, seed=seed + si,
                                  n_tracers=n_tracers, device=device,
                                  fetch_snapshots=False, engine=engine)
        walls.append(time.perf_counter() - t0)
        m_ts = res.records.m_mean[:, :nsteps + 1]
        v_ts = res.records.v_eff[:, :nsteps + 1]
        rho = res.rho_p + res.rho_m                      # (B, L) final
        m_abs = np.abs(np.nanmean(m_ts[:, late], axis=1))
        band = rho.std(axis=1) / np.maximum(rho.mean(axis=1), 1e-12)
        v_abs = np.abs(np.nanmean(v_ts[:, late], axis=1))
        m_grid[si] = m_abs.reshape(nb, ns).mean(axis=1)
        band_grid[si] = band.reshape(nb, ns).mean(axis=1)
        v_grid[si] = v_abs.reshape(nb, ns).mean(axis=1)
        print(f"# sigma={sigma:.4g}: {nb * ns} replicas x {nsteps} steps "
              f"in {walls[-1]:.2f}s", flush=True)
    return dict(beta=list(map(float, beta_values)),
                sigma=list(map(float, sigma_values)), n_seeds=n_seeds,
                L=L, T=T, dt=dt, gamma=gamma, lam=lam, device=str(device),
                engine=engine, route=PDERun.route,
                m=m_grid.tolist(), band=band_grid.tolist(),
                v=v_grid.tolist(), row_wall_s=walls,
                replicas=len(sigma_values) * nb * n_seeds,
                aggregate_replica_steps_per_s=(
                    len(sigma_values) * nb * ns * nsteps
                    / max(sum(walls), 1e-9)))


def plot_grid(data, outdir="."):
    plt = _pyplot()
    if plt is None:
        return
    beta = np.asarray(data["beta"])
    sigma = np.asarray(data["sigma"])
    fig, axes = plt.subplots(1, 2, figsize=(11, 4.2), sharey=True)
    for ax, key, title in ((axes[0], "m",
                            r"order parameter  $|\langle m\rangle_t|$"),
                           (axes[1], "band",
                            r"band contrast  std$_x\rho\,/\,$mean$_x\rho$")):
        pm = ax.pcolormesh(beta, sigma, np.asarray(data[key]),
                           shading="nearest", cmap="viridis")
        ax.set_yscale("log")
        ax.axvline(1.0, color="w", ls="--", lw=1,
                   label=r"mean-field $\beta_c{=}1$" if key == "m" else None)
        ax.set_xlabel(r"$\beta$")
        ax.set_title(title)
        fig.colorbar(pm, ax=ax)
    axes[0].set_ylabel(r"kernel width $\sigma$")
    axes[0].legend(loc="upper left", fontsize=8)
    fig.suptitle(
        f"PDE (β × σ) phase diagram — {data['replicas']} replicas, "
        f"L={data['L']}, T={data['T']} (window [{0.6 * data['T']:.0f},"
        f"{data['T']:.0f}]), fused solve", fontsize=10)
    fig.tight_layout()
    path = os.path.join(outdir, "pde_phase_diagram.png")
    fig.savefig(path, dpi=150)
    plt.close(fig)
    print(f"# wrote {path}")


def check_physics(data):
    """The diagram's own pins (printed and asserted): the widest-σ row is
    ordered at β ≥ 2.5, disordered at β ≤ 0.3, and crosses |m| = 1/2
    between β = 0.8 and 1.6 (mean-field β_c = 1)."""
    m = np.asarray(data["m"])
    beta = np.asarray(data["beta"])
    top = m[-1]
    lo = top[beta <= 0.3].mean()
    hi = top[beta >= 2.5].mean()
    print(f"# widest-sigma row: |<m>_t|(beta<=0.3)={lo:.3f}, "
          f"(beta>=2.5)={hi:.3f}")
    assert hi > 0.7, f"ordered phase missing at wide sigma ({hi:.3f})"
    assert lo < 0.25, f"disordered phase missing at wide sigma ({lo:.3f})"
    cross = beta[np.argmax(top > 0.5)]
    print(f"# widest-sigma 0.5-crossing at beta={cross:.2f} "
          f"(mean-field beta_c=1)")
    assert 0.8 <= cross <= 1.6, cross


def main(small: bool = False, outdir: str = ".", device: str = "cuda",
         engine: str = "auto"):
    os.makedirs(outdir, exist_ok=True)
    if small:
        data = run_grid(np.linspace(0, 3, 6), [0.02, 0.2, 9e4], 1,
                        L=128, T=0.5, dt=1e-3, gamma=0.2, lam=0.6,
                        n_tracers=16, device=device, engine=engine)
    else:
        data = run_grid(np.linspace(0, 3, 32), FULL_SIGMAS, 2,
                        L=1000, T=10.0, dt=5e-4, gamma=0.2, lam=0.6,
                        n_tracers=64, device=device, engine=engine)
    print(f"# aggregate throughput: "
          f"{data['aggregate_replica_steps_per_s']:.4e} replica-steps/s "
          f"over {data['replicas']} replicas")
    with open(os.path.join(outdir, "pde_phase_diagram.json"), "w") as f:
        json.dump(data, f)
    plot_grid(data, outdir)
    if not small:
        check_physics(data)
    return data


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true",
                    help="CPU smoke: 6 beta x 3 sigma x 1 seed, L=128")
    ap.add_argument("--engine", default="auto",
                    choices=["auto", "pallas", "xla"],
                    help="the JAX engine names; each runs the fused solve")
    ap.add_argument("--outdir", default=".")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--replot", action="store_true",
                    help="redraw the figure from the saved JSON")
    a = ap.parse_args()
    if a.replot:
        with open(os.path.join(a.outdir, "pde_phase_diagram.json")) as f:
            plot_grid(json.load(f), a.outdir)
    else:
        main(a.small, a.outdir, a.device, engine=a.engine)

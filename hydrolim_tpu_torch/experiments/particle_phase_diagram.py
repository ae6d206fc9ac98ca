"""Microscopic (β × σ) phase diagram on the fused exclusion kernel (B3/B4).

The counterpart of the JAX package's
``experiments/run_particle_phase_diagram.py``: the (interaction strength β ×
interaction range σ) plane of the K=3 exclusion model — 32 β × 2 seeds =
64 replicas per σ × 16 σ = 1024 replicas at the reference per-replica scale
(L=1000, N=1500, K=3, T=20, ~5000 Δt steps), periodic and bidirectional,
with the global-m row (σ=0, the Curie–Weiss limit, β_c = 1) last.  Each σ
is one ``run_exclusion_sweep`` call on ``device`` (σ sets the smoothing
band); rows whose band is wider than a cluster's halo budget run at
cluster size 1, and σ ≥ ~0.1 at L=1000 takes the dense periodic band.

Read-outs per (β, σ), as in the PDE twin (``pde_phase_diagram``):
- order parameter |⟨m_global⟩_t| over the late window t ≥ 0.6 T;
- band contrast ⟨std_x(ρ)/mean_x(ρ)⟩ over the same window.

Usage: python -m hydrolim_tpu_torch.experiments.particle_phase_diagram
       [--small] [--outdir DIR] [--device cuda|cpu] [--pde-json FILE]
       [--replot]
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from hydrolim_tpu_torch.core.config import ParticleConfig, auto_dt
from hydrolim_tpu_torch.fit.veff_fit import _pyplot
from hydrolim_tpu_torch.sweeps.ensemble import broadcast_params
from hydrolim_tpu_torch.sweeps.fast_exclusion import run_exclusion_sweep

# σ grid of the PDE twin (so the boundary overlay shares rows); σ=0 is the
# global-m mean-field row
FULL_SIGMAS = list(np.geomspace(0.002, 2.0, 15)) + [0.0]


def run_grid(beta_values, sigma_values, n_seeds, *, L, N, K, T, obs_dt,
             rate_diffusion, rate_active, seed=0, device="cuda"):
    """One fused exclusion call per frame and σ; σ ≤ 0 means global m.

    Returns (n_sigma, n_beta) grids of the late-window order parameter and
    band contrast, each row's wall time and Δt steps, and the route each
    row took (``engines_used``).  Rates are the reference sweep's unscaled
    lattice rates, periodic and bidirectional: the phase-plane model whose
    σ → ∞ row is the exactly solvable Curie–Weiss limit."""
    nb, ns = len(beta_values), n_seeds
    beta_max = float(np.max(beta_values))
    m_grid = np.zeros((len(sigma_values), nb))
    band_grid = np.zeros_like(m_grid)
    agg_steps, walls, steps = 0, [], []
    for si, sigma in enumerate(sigma_values):
        config = ParticleConfig(
            L=L, xlim=1.0, init="fixed", N=N, scale_rates=False,
            local_kernel_sigma=float(sigma), periodic=True,
            site_capacity=K, active_model="bidirectional")
        params = broadcast_params(config, beta=beta_values,
                                  rate_diffusion=rate_diffusion,
                                  rate_active=rate_active, n_runs=ns,
                                  device=device)
        dt = auto_dt(config, params, beta_max=beta_max)
        nsteps = int(round(T / dt))
        t0 = time.perf_counter()
        frames, _ = run_exclusion_sweep(
            config, params, T=T, obs_dt=obs_dt, dt=dt, seed=seed + si,
            device=device, record_fft=False, n_tracers=0)
        M = frames.m_global.shape[1]
        late = torch.as_tensor(np.arange(M) * obs_dt >= 0.6 * T,
                               device=frames.total.device)
        m_abs = frames.m_global[:, late].mean(1).abs()
        rho = frames.total[:, late]
        band = (rho.std(2, unbiased=False)
                / rho.mean(2).clamp(min=1e-12)).mean(1)
        m_grid[si] = m_abs.reshape(nb, ns).mean(1).cpu().numpy()
        band_grid[si] = band.reshape(nb, ns).mean(1).cpu().numpy()
        walls.append(time.perf_counter() - t0)
        steps.append(nsteps)
        agg_steps += nb * ns * nsteps * N
        print(f"# sigma={sigma:.4g}: {nb * ns} replicas x {nsteps} steps "
              f"(dt={dt:.2e}) in {walls[-1]:.2f}s", flush=True)
    return dict(beta=list(map(float, beta_values)),
                sigma=list(map(float, sigma_values)), n_seeds=n_seeds,
                L=L, N=N, K=K, T=T, obs_dt=obs_dt,
                rate_diffusion=rate_diffusion, rate_active=rate_active,
                device=str(device),
                engines_used=["fused"] * len(sigma_values),
                m=m_grid.tolist(), band=band_grid.tolist(),
                row_wall_s=walls, row_steps=steps,
                replicas=len(sigma_values) * nb * n_seeds,
                aggregate_particle_steps_per_s=agg_steps
                / max(sum(walls), 1e-9))


def crossing_curve(beta, m_rows, level=0.5):
    """β at which each σ row first crosses ``level`` (linear interp);
    NaN where the row never orders."""
    beta = np.asarray(beta)
    out = []
    for row in np.asarray(m_rows):
        above = row > level
        if not above.any() or above[0]:
            out.append(np.nan)
            continue
        j = int(np.argmax(above))
        b0, b1, m0, m1 = beta[j - 1], beta[j], row[j - 1], row[j]
        out.append(b0 + (b1 - b0) * (level - m0) / max(m1 - m0, 1e-12))
    return np.asarray(out)


def plot_grid(data, outdir=".", pde_json=None):
    """The two (β × σ) maps and, with the PDE twin's JSON, the micro and
    macro phase boundaries; skipped where matplotlib is not installed."""
    plt = _pyplot()
    if plt is None:
        return
    beta = np.asarray(data["beta"])
    sigma = np.asarray(data["sigma"])
    pde = None
    if pde_json:
        with open(pde_json) as f:
            pde = json.load(f)

    # the global-m row (σ <= 0) is the σ → ∞ mean-field limit: plot it one
    # log-decade above the widest finite σ of either dataset
    def _finite(vals):
        v = np.asarray(vals, float)
        return v[(v > 0) & (v < 100)]

    finite = _finite(sigma)
    if pde is not None:
        finite = np.concatenate([finite, _finite(pde["sigma"])])
    top = (finite.max() * 10.0) if finite.size else 1.0
    sig_plot = sigma.copy()
    sig_plot[sig_plot <= 0] = top

    n_panels = 3 if pde is not None else 2
    fig, axes = plt.subplots(1, n_panels, figsize=(5.5 * n_panels, 4.2))
    for ax, key, title in (
            (axes[0], "m", r"order parameter  $|\langle m\rangle_t|$"),
            (axes[1], "band",
             r"band contrast  std$_x\rho\,/\,$mean$_x\rho$")):
        pm = ax.pcolormesh(beta, sig_plot, np.asarray(data[key]),
                           shading="nearest", cmap="viridis")
        ax.set_yscale("log")
        ax.axvline(1.0, color="w", ls="--", lw=1)
        ax.set_xlabel(r"$\beta$")
        ax.set_ylabel(r"kernel width $\sigma$" if ax is axes[0] else "")
        ax.set_title(title)
        fig.colorbar(pm, ax=ax)
    if pde is not None:
        ax = axes[2]
        ax.plot(crossing_curve(data["beta"], data["m"]), sig_plot, "o-",
                label=f"particles (N={data['N']}, K={data['K']})")
        psig = np.asarray(pde["sigma"], float)
        psig[psig > 100] = top     # PDE quasi-global sentinel row
        ax.plot(crossing_curve(pde["beta"], pde["m"]), psig, "s--",
                label="PDE (hydrodynamic limit)")
        ax.axvline(1.0, color="k", ls=":", lw=1,
                   label=r"mean-field $\beta_c{=}1$")
        ax.set_yscale("log")
        ax.set_xlabel(r"$\beta$")
        ax.set_title(r"phase boundary $\beta_c(\sigma)$: micro vs macro")
        ax.legend(fontsize=8)
        ax.set_xlim(beta.min(), beta.max())
    fig.suptitle(
        f"Particle (β × σ) phase diagram — {data['replicas']} replicas, "
        f"L={data['L']}, N={data['N']}, K={data['K']}, T={data['T']} "
        f"(window [{0.6 * data['T']:.0f},{data['T']:.0f}]), fused exclusion "
        f"kernel", fontsize=10)
    fig.tight_layout()
    path = os.path.join(outdir, "particle_phase_diagram.png")
    fig.savefig(path, dpi=150)
    plt.close(fig)
    print(f"# wrote {path}")


def check_physics(data):
    """The diagram's own sanity pins (printed and asserted): the global-m
    row (last) is ordered at β ≥ 2.5, disordered at β ≤ 0.3 (|m| ~ 1/√N)
    and crosses |m| = 1/2 between β = 0.8 and 1.8 (mean-field β_c = 1)."""
    m = np.asarray(data["m"])
    beta = np.asarray(data["beta"])
    N_eff = data["N"] * data["n_seeds"]
    top = m[-1]
    lo = top[beta <= 0.3].mean()
    hi = top[beta >= 2.5].mean()
    print(f"# global-m row: |<m>_t|(beta<=0.3)={lo:.3f}, (beta>=2.5)={hi:.3f} "
          f"(shot floor ~{1.0 / np.sqrt(N_eff):.3f})")
    assert hi > 0.7, f"ordered phase missing in the mean-field row ({hi:.3f})"
    assert lo < max(0.25, 4.0 / np.sqrt(N_eff)), \
        f"disordered phase missing in the mean-field row ({lo:.3f})"
    cross = crossing_curve(beta, m[None, -1])[0]
    print(f"# global-m row 0.5-crossing at beta={cross:.2f} "
          f"(mean-field beta_c=1)")
    assert 0.8 <= cross <= 1.8, cross


def main(small: bool = False, outdir: str = ".", device: str = "cuda",
         pde_json=None):
    os.makedirs(outdir, exist_ok=True)
    if small:
        data = run_grid(np.linspace(0, 3, 6), [0.02, 0.1, 0.0], 1,
                        L=128, N=96, K=3, T=6.0, obs_dt=0.5,
                        rate_diffusion=0.02, rate_active=5.0, device=device)
    else:
        data = run_grid(np.linspace(0, 3, 32), FULL_SIGMAS, 2,
                        L=1000, N=1500, K=3, T=20.0, obs_dt=0.25,
                        rate_diffusion=0.02, rate_active=5.0, device=device)
    print(f"# aggregate exclusion throughput: "
          f"{data['aggregate_particle_steps_per_s']:.3e} particle-steps/s "
          f"over {data['replicas']} replicas")
    with open(os.path.join(outdir, "particle_phase_diagram.json"), "w") as f:
        json.dump(data, f)
    plot_grid(data, outdir, pde_json=pde_json)
    check_physics(data)
    return data


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true",
                    help="CPU smoke: 6 beta x 3 sigma x 1 seed, L=128")
    ap.add_argument("--outdir", default=".")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--pde-json", default=None,
                    help="pde_phase_diagram.json for the boundary overlay")
    ap.add_argument("--replot", action="store_true",
                    help="redraw the figure from the saved JSON")
    a = ap.parse_args()
    if a.replot:
        with open(os.path.join(a.outdir, "particle_phase_diagram.json")) as f:
            plot_grid(json.load(f), a.outdir, pde_json=a.pde_json)
    else:
        main(a.small, a.outdir, a.device, a.pde_json)

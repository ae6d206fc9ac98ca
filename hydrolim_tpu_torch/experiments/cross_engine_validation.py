"""Micro ↔ macro hydrodynamic-limit validation on the port.

Runs both engines at matched parameters (bidirectional mean-field, λ=0.6,
γ=0.2, global magnetization) across the β grid — the particle side through
``run_meanfield_sweep`` (kernel B1 on CUDA), the PDE side through
``pde_beta_sweep`` (kernel B2 on CUDA) — and overlays v_eff/D_eff on the
closed-form theory curves.

Usage: python -m hydrolim_tpu_torch.experiments.cross_engine_validation
       [--small] [--outdir DIR] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from hydrolim_tpu_torch.core.config import ParticleConfig
from hydrolim_tpu_torch.sweeps.ensemble import broadcast_params, ensemble_dt
from hydrolim_tpu_torch.sweeps.fast_meanfield import run_meanfield_sweep
from hydrolim_tpu_torch.sweeps.pde_sweeps import pde_beta_sweep
from hydrolim_tpu_torch.theory.meanfield import m_fixed_point
from hydrolim_tpu_torch.utils import profiling

LAM, GAMMA = 0.6, 0.2


def configs(small: bool):
    """(β grid, particle kwargs, n_runs, PDE kwargs) of the two sizes."""
    if small:
        beta_values = np.linspace(0, 3, 5)
        part = dict(L=128, N=2000, T=10.0, obs_dt=0.5)
        n_runs = 2
        pde_kw = dict(T=8.0, t_min=5.0, t_max=8.0, L=128, dt=1e-3,
                      n_tracers=300)
    else:
        # particle lattice at L=256: the diffusion hop rate γ·L² sets
        # dt ∝ 1/L², and the lattice shot-noise correction λ/(2L) ≈ 1% of D
        beta_values = np.linspace(0, 3, 11)
        part = dict(L=256, N=5000, T=30.0, obs_dt=0.5)
        n_runs = 3
        pde_kw = dict(T=40.0, t_min=20.0, t_max=40.0, L=1000, dt=5e-4,
                      n_tracers=1000)
    return beta_values, part, n_runs, pde_kw


def particle_side(beta_values, n_runs, *, L, N, T, obs_dt, seed=0,
                  device="cuda"):
    """Mean-field bidirectional particle ensemble in lattice units chosen so
    that λ = rate_active·dx and γ = rate_diffusion·dx² match the PDE: with
    dx = 1/L, rate_active = λ·L and rate_diffusion = γ·L²."""
    ra = LAM * L
    rd = GAMMA * L * L
    config = ParticleConfig(L=L, N=N, n_pad=N, init="fixed",
                            scale_rates=False, local_kernel_sigma=0.0,
                            periodic=True, site_capacity=None,
                            active_model="bidirectional")
    params = broadcast_params(config, beta=beta_values, rate_diffusion=rd,
                              rate_active=ra, n_runs=n_runs, device=device)
    dt = ensemble_dt(config, beta_max=float(np.max(beta_values)),
                     rate_diffusion=rd, rate_active=ra)
    frames = run_meanfield_sweep(config, params, T=T, obs_dt=obs_dt, dt=dt,
                                 seed=seed, device=device)
    with profiling.span("mf.fits"):
        times = frames.times_obs
        s = len(times) // 2
        dx = 1.0 / L
        span = times[s:] - times[s]

        v_mean, v_err, D_mean, D_err = [], [], [], []
        for b in range(len(beta_values)):
            vs, Ds = [], []
            for r in range(n_runs):
                pos = frames.pos[:, b * n_runs + r].astype(float) * dx
                disp = pos[s:] - pos[s]
                vs.append(abs(np.polyfit(span, disp.mean(axis=1), 1)[0]))
                var = ((disp - disp.mean(axis=1, keepdims=True)) ** 2
                       ).mean(axis=1)
                Ds.append(np.polyfit(span, var, 1)[0] / 2.0)
            v_mean.append(np.mean(vs))
            v_err.append(np.std(vs) / np.sqrt(n_runs))
            D_mean.append(np.mean(Ds))
            D_err.append(np.std(Ds) / np.sqrt(n_runs))
        return tuple(map(np.asarray, (v_mean, v_err, D_mean, D_err)))


def _plot(out: Path, beta_values, particle, pde) -> None:
    """The two cross-engine figures: particle and PDE series over theory.
    ``particle`` is (v, v_err, D − lattice shot noise, D_err)."""
    import matplotlib.pyplot as plt

    beta_dense = np.linspace(0, 3, 400)
    m_d = np.array([m_fixed_point(b) for b in beta_dense])
    v_th = LAM * np.tanh(beta_dense * m_d)
    D_th = GAMMA + LAM ** 2 / (2 * np.cosh(beta_dense * m_d) ** 3)
    v_p, ve_p, D_p, De_p = particle
    for p_series, p_err, s_series, s_err, th, ylabel, fname in (
            (v_p, ve_p, pde["v_mean"], pde["v_err"], v_th,
             r"$v_{\mathrm{eff}}$", "cross_v_eff_vs_beta.png"),
            (D_p, De_p, pde["D_mean"], pde["D_err"], D_th,
             r"$D_{\mathrm{eff}}$", "cross_D_eff_vs_beta.png")):
        plt.figure(figsize=(6, 4))
        plt.errorbar(beta_values, p_series, yerr=p_err, fmt="o", capsize=4,
                     label="Particle Sim")
        plt.errorbar(beta_values, s_series, yerr=s_err, fmt="o", capsize=4,
                     label="PDE Sim", color="lightblue")
        plt.plot(beta_dense, th, "--", color="navy", label="theory")
        plt.xlabel(r"$\beta$")
        plt.ylabel(ylabel)
        plt.legend()
        plt.grid()
        plt.tight_layout()
        plt.savefig(out / fname, dpi=200)
        plt.close()


def main(small: bool = False, outdir: str = "cross_engine_out",
         device: str = "cuda") -> dict:
    """Run both sides, write the two figures (when matplotlib is installed)
    and ``cross_engine.json`` into ``outdir``, and return the
    per-β series."""
    beta_values, part, n_runs, pde_kw = configs(small)

    print("particle side ...", flush=True)
    v_p, ve_p, D_p, De_p = particle_side(beta_values, n_runs, device=device,
                                         **part)
    print("pde side ...", flush=True)
    pde = pde_beta_sweep(beta_values, n_runs=n_runs, gamma=GAMMA, lam=LAM,
                         outdir=outdir, plot_result=False, device=device,
                         **pde_kw)

    out = Path(outdir)
    out.mkdir(parents=True, exist_ok=True)
    D_lattice = LAM / part["L"] / 2.0
    try:
        import matplotlib
    except ImportError:   # a GPU host without plotting: numbers only
        print("matplotlib is not installed: figures skipped", flush=True)
    else:
        matplotlib.use("Agg")
        _plot(out, beta_values, (v_p, ve_p, D_p - D_lattice, De_p), pde)

    m_b = np.array([m_fixed_point(b) for b in beta_values])
    v_theory_pts = LAM * np.tanh(beta_values * m_b)
    D_theory_pts = GAMMA + LAM ** 2 / (2 * np.cosh(beta_values * m_b) ** 3)
    err = np.abs(v_p - v_theory_pts)
    print("beta:", beta_values)
    print("particle v:", np.round(v_p, 4))
    print("pde v     :", np.round(pde["v_mean"], 4))
    print("theory v  :", np.round(v_theory_pts, 4))
    print("pde D     :", np.round(pde["D_mean"], 4))
    print("theory D  :", np.round(D_theory_pts, 4))
    print(f"max |particle - theory| deviation: {err.max():.4f}")
    res = dict(beta=beta_values, v_particle=v_p, D_particle=D_p,
               v_pde=pde["v_mean"], D_pde=pde["D_mean"],
               v_theory=v_theory_pts, D_theory=D_theory_pts)
    (out / "cross_engine.json").write_text(json.dumps(
        {k: np.asarray(v, float).tolist() for k, v in res.items()}))
    return res


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--small", action="store_true")
    p.add_argument("--outdir", default="cross_engine_out")
    p.add_argument("--device", default="cuda")
    a = p.parse_args()
    main(a.small, a.outdir, a.device)

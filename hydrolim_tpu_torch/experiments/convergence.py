"""Quantitative hydrodynamic-limit convergence: error(N) ~ N^(-1/2).

The JAX package's ``experiments/run_convergence.py``.  At matched
parameters (lambda = rate_active*dx, gamma = rate_diffusion*dx^2, same
lattice) and a matched inhomogeneous initial profile, the trajectory-wise
deviation of the particle system's empirical observables from the
deterministic PDE solution is the CLT fluctuation of N nearly-independent
particles, so

    err(N) := ||observable_N - observable_PDE||  ~  C * N^(-1/2)

until it saturates at the micro/macro modeling bias floor (tau-leap dt,
upwind dx).  Two observables: the global magnetization trajectory m(t)
(RMS over the frame grid, per run) and the final total-density profile
(L2 over x, per run).  The driver fits the log-log slope over the
fluctuation-dominated range and asserts it is compatible with -1/2.

The particle side is ``run_particle_ensemble`` with the Poisson init (the
torch fast path: outside kernel B1's scope, as the JAX driver runs its XLA
step); the PDE side steps ``pde.stepper.pde_step`` (plain torch, as the JAX
driver steps its XLA ``pde_step``).  ``convergence.json`` is written before
the figure, which is skipped where matplotlib is not installed.

Usage: python -m hydrolim_tpu_torch.experiments.convergence [--small]
       [--outdir DIR] [--seed S] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from hydrolim_tpu_torch.core.config import (
    ParticleConfig,
    PDEConfig,
    make_pde_params,
)
from hydrolim_tpu_torch.fit.veff_fit import _pyplot
from hydrolim_tpu_torch.pde.stepper import build_pde_ops, pde_step
from hydrolim_tpu_torch.sweeps.beta_sweep import make_exp_gradient
from hydrolim_tpu_torch.sweeps.ensemble import (
    broadcast_params,
    ensemble_dt,
    run_particle_ensemble,
)

LAM, GAMMA, BETA = 0.6, 0.02, 1.5
FRAC_PLUS, DECAY = 0.7, 0.1


def particle_errors(Ns, n_runs, *, L, T, obs_dt, m_pde, rho_pde_final,
                    seed=0, device="cuda"):
    """For each ladder point N: run an n_runs ensemble and return per-run
    RMS m(t) errors and final-profile L2 errors vs the PDE solution, the
    mean m(t) curves and each point's wall time in s."""
    dx = 1.0 / L
    errs_m, errs_rho, m_curves, walls = {}, {}, {}, {}
    for N in Ns:
        t0 = time.perf_counter()
        # Poisson totals fluctuate ~sqrt(N): pad generously so the
        # capacity-respecting fill never truncates the draw
        n_pad = int(N + 6 * np.sqrt(N) + 64)
        config = ParticleConfig(L=L, N=N, n_pad=n_pad, init="poisson",
                                scale_rates=False, local_kernel_sigma=0.0,
                                periodic=True, site_capacity=None,
                                active_model="bidirectional")
        params = broadcast_params(config, beta=[BETA],
                                  rate_diffusion=GAMMA * L * L,
                                  rate_active=LAM * L, n_runs=n_runs,
                                  device=device)
        dt = ensemble_dt(config, beta_max=BETA,
                         rate_diffusion=GAMMA * L * L, rate_active=LAM * L)
        _, _, rho_plus, rho_minus = make_exp_gradient(
            L, N, FRAC_PLUS, DECAY, anchor_positions=None)
        res = run_particle_ensemble(
            config, params, seed + N, T=T, obs_dt=obs_dt, dt=dt,
            rho0_plus=rho_plus, rho0_minus=rho_minus, record_pos=False,
            record_fft=False, device=device)
        m_traj = res.frames.m_global.cpu().numpy()          # (R, M)
        rho_fin = res.frames.total[:, -1].cpu().numpy()     # (R, L)
        walls[N] = time.perf_counter() - t0
        errs_m[N] = np.sqrt(np.mean((m_traj - m_pde[None, :]) ** 2, axis=1))
        errs_rho[N] = np.sqrt(
            dx * np.sum((rho_fin - rho_pde_final[None, :]) ** 2, axis=1))
        m_curves[N] = m_traj.mean(axis=0)
        print(f"# N={N}: dt={dt:.2e}, {walls[N]:.1f} s ({res.engine}), "
              f"err_m={errs_m[N].mean():.4f}, err_rho={errs_rho[N].mean():.4f}",
              flush=True)
    return errs_m, errs_rho, m_curves, walls


def pde_solution(*, L, T, obs_dt, device="cuda"):
    """Deterministic PDE at the matched lattice/profile: m(t) on the frame
    grid and the final total-density profile (numpy)."""
    dx = 1.0 / L
    # dt divides obs_dt exactly so PDE records land on the particle frames;
    # well inside the upwind CFL bound dx/lam
    sub = max(int(np.ceil(obs_dt / min(2.5e-4, 0.2 * dx / LAM))), 1)
    dt = obs_dt / sub
    n_frames = len(np.arange(0.0, T, obs_dt))
    # gaussian_kernel + the sigma > 1e5 sentinel selects GLOBAL m — matching
    # the particle side's local_kernel_sigma=0.0 (gaussian_kernel=False
    # would be POINTWISE m(x), a different model: on a gradient profile its
    # global relaxation runs ~4x slower than the CW law)
    pcfg = PDEConfig(L=L, T=T, dt=dt, bc="periodic", gaussian_kernel=True,
                     kernel_sigma=2e5, diffusion_solver="auto",
                     snapshot_interval=10 ** 9)
    pparams = make_pde_params(gamma=GAMMA, lam=LAM, beta=BETA, device=device)
    ops = build_pde_ops(pcfg, GAMMA, device)
    # the exp-gradient mean-count profiles, normalized to densities
    # (counts/(N*dx)) exactly as the particle recorder normalizes
    _, _, rho_plus, rho_minus = make_exp_gradient(
        L, 1.0, FRAC_PLUS, DECAY, anchor_positions=None)
    rp = torch.tensor(rho_plus / dx, dtype=torch.float32, device=device)[None]
    rm = torch.tensor(rho_minus / dx, dtype=torch.float32,
                      device=device)[None]

    def m_of(rp, rm):
        sp, sm = rp.sum(), rm.sum()
        return (sp - sm) / torch.clamp(sp + sm, min=1e-12)

    ms, rho = [m_of(rp, rm)], rp + rm
    for _ in range(n_frames - 1):
        for _ in range(sub):
            rp, rm = pde_step(pcfg, pparams, ops, rp, rm)
        ms.append(m_of(rp, rm))
        rho = rp + rm
    m_pde = torch.stack(ms).cpu().numpy()
    return m_pde, rho[0].cpu().numpy()


def fit_slope(Ns, err_mean, err_se):
    """Weighted log-log slope over the fluctuation-dominated range (all
    ladder points whose mean error is > 2x the smallest mean error — the
    saturated tail, if any, is excluded from the rate fit)."""
    Ns = np.asarray(Ns, float)
    e = np.asarray(err_mean, float)
    keep = e > 2.0 * e.min()
    keep[np.argmin(e)] = True            # always keep the smallest point
    if keep.sum() < 2:
        keep[:] = True
    k = np.polyfit(np.log(Ns[keep]), np.log(e[keep]), 1)
    return float(k[0]), keep


def main(argv=None) -> dict:
    """Run the driver (``argv`` as on the command line; None: sys.argv);
    returns the record written to ``convergence.json``."""
    p = argparse.ArgumentParser()
    p.add_argument("--small", action="store_true", help="quick CPU smoke")
    p.add_argument("--outdir", default="convergence_out")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)

    if a.small:
        L, T, obs_dt, n_runs = 32, 0.5, 0.1, 4
        Ns = [200, 800, 3200]
    else:
        L, T, obs_dt, n_runs = 128, 1.0, 0.05, 8
        Ns = [500, 1000, 2000, 4000, 8000, 16000]

    print("# PDE reference solution ...", flush=True)
    t0 = time.perf_counter()
    m_pde, rho_pde_final = pde_solution(L=L, T=T, obs_dt=obs_dt,
                                        device=a.device)
    wall_pde = time.perf_counter() - t0
    print(f"# m_pde: {m_pde[0]:.3f} -> {m_pde[-1]:.3f} ({wall_pde:.1f} s)",
          flush=True)
    errs_m, errs_rho, m_curves, walls = particle_errors(
        Ns, n_runs, L=L, T=T, obs_dt=obs_dt, m_pde=m_pde,
        rho_pde_final=rho_pde_final, seed=a.seed, device=a.device)

    em = np.array([errs_m[N].mean() for N in Ns])
    em_se = np.array([errs_m[N].std(ddof=1) / np.sqrt(len(errs_m[N]))
                      for N in Ns])
    er = np.array([errs_rho[N].mean() for N in Ns])
    er_se = np.array([errs_rho[N].std(ddof=1) / np.sqrt(len(errs_rho[N]))
                      for N in Ns])
    slope_m, keep_m = fit_slope(Ns, em, em_se)
    slope_r, keep_r = fit_slope(Ns, er, er_se)
    print(f"# slope m(t): {slope_m:.3f}   slope rho(x,T): {slope_r:.3f} "
          f"(CLT: -0.5)", flush=True)

    # the scientific assertion: both observables converge at the CLT rate
    assert -0.75 < slope_m < -0.25, ("m(t) convergence rate off N^-1/2",
                                     slope_m)
    assert -0.75 < slope_r < -0.25, ("rho(x,T) convergence rate off N^-1/2",
                                     slope_r)

    os.makedirs(a.outdir, exist_ok=True)
    rec = {"L": L, "T": T, "obs_dt": obs_dt, "n_runs": n_runs, "Ns": Ns,
           "err_m": em.tolist(), "err_m_se": em_se.tolist(),
           "err_rho": er.tolist(), "err_rho_se": er_se.tolist(),
           "slope_m": slope_m, "slope_rho": slope_r,
           "beta": BETA, "lam": LAM, "gamma": GAMMA, "device": a.device,
           "wall_pde_s": wall_pde, "wall_s": [walls[N] for N in Ns]}
    with open(os.path.join(a.outdir, "convergence.json"), "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps({"slope_m": round(slope_m, 3),
                      "slope_rho": round(slope_r, 3)}), flush=True)

    plt = _pyplot()
    if plt is None:
        return rec
    fig, axes = plt.subplots(1, 3, figsize=(15, 4.2))
    for ax, e, se, slope, keep, label in (
            (axes[0], em, em_se, slope_m, keep_m,
             r"RMS$_t$ $|m_N(t) - m_{PDE}(t)|$"),
            (axes[1], er, er_se, slope_r, keep_r,
             r"$L^2_x$ $|\rho_N(x,T) - \rho_{PDE}(x,T)|$")):
        ax.errorbar(Ns, e, yerr=se, fmt="o", capsize=4, color="navy")
        guide = e[0] * (np.asarray(Ns, float) / Ns[0]) ** -0.5
        ax.loglog(Ns, guide, "--", color="gray", label=r"$N^{-1/2}$")
        ax.set_xlabel("N")
        ax.set_ylabel(label)
        ax.set_title(f"fit slope {slope:.2f}")
        ax.grid(True, which="both", alpha=0.4)
        ax.legend()
    times = np.arange(0.0, T, obs_dt)
    axes[2].plot(times, m_pde, "k-", lw=2, label="PDE")
    for N in (Ns[0], Ns[-1]):
        axes[2].plot(times, m_curves[N], "o--", ms=3,
                     label=f"particle N={N}")
    axes[2].set_xlabel("t")
    axes[2].set_ylabel("m(t)")
    axes[2].grid(True, alpha=0.4)
    axes[2].legend()
    fig.suptitle(rf"Hydrodynamic-limit convergence ($\beta$={BETA}, "
                 rf"$\lambda$={LAM}, $\gamma$={GAMMA}, L={L})")
    fig.tight_layout()
    fig.savefig(os.path.join(a.outdir, "convergence.png"), dpi=200)
    plt.close(fig)
    return rec


if __name__ == "__main__":
    main()

"""Critical fluctuation scaling: RMS m ~ N^(-1/4) at beta = 1.

The JAX package's ``experiments/run_critical_scaling.py``.  For the
Curie-Weiss spin dynamics the framework simulates (flip rate
exp(-beta*sigma*m)), the stationary magnetization fluctuation obeys two
different laws —

  subcritical (beta < 1):  linear restoring drift  -> RMS m ~ N^(-1/2)
  critical    (beta = 1):  the linear term vanishes and the drift is
                           -(2/3) m^3                -> RMS m ~ N^(-1/4)

The driver runs pure spin dynamics (rate_diffusion = rate_active = 0 —
motion does not couple back to global m, so this isolates the reaction
channel) on an N ladder at beta in {0.5, 1.0}, measures the
stationary-window RMS per run, fits both log-log slopes, and asserts
each against its law.  Catching the N^(-1/4) anomalous exponent is a
sharp test: any bias in the tau-leap flip channel, the m normalization,
or the RNG independence across replicas would bend it toward -1/2 or 0.

The configuration (mean-field, periodic, ``init='fixed'``) is inside
kernel B1's scope, so ``run_particle_ensemble`` runs it on B1 (its plain
version on CPU tensors).  ``critical_scaling.json`` is written before the
figure, which is skipped where matplotlib is not installed.

Usage: python -m hydrolim_tpu_torch.experiments.critical_scaling [--small]
       [--outdir DIR] [--seed S] [--device cuda|cpu] [--replot]
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from hydrolim_tpu_torch.core.config import ParticleConfig
from hydrolim_tpu_torch.fit.veff_fit import _pyplot
from hydrolim_tpu_torch.sweeps.ensemble import (
    broadcast_params,
    ensemble_dt,
    run_particle_ensemble,
)

BETAS = (0.5, 1.0)          # subcritical control, critical point


def measure(Ns, n_runs, tau_mult, seed=0, device="cuda"):
    """Per ladder point: stationary-window RMS m per run and beta, and the
    point's wall time in s (``{N: {beta: rms}}``, ``{N: s}``)."""
    out, walls = {}, {}
    for N in Ns:
        t0 = time.perf_counter()
        config = ParticleConfig(L=8, N=N, n_pad=N, init="fixed",
                                scale_rates=False, local_kernel_sigma=0.0,
                                periodic=True, site_capacity=None,
                                active_model="bidirectional")
        params = broadcast_params(config, beta=list(BETAS),
                                  rate_diffusion=0.0, rate_active=0.0,
                                  n_runs=n_runs, device=device)
        dt = ensemble_dt(config, beta_max=max(BETAS), rate_diffusion=0.0,
                         rate_active=0.0)
        # the critical relaxation time grows as sqrt(N); simulate tau_mult
        # of them and measure over the second half (the stationary window)
        T = tau_mult * float(np.sqrt(N))
        obs_dt = max(T / 200.0, dt)
        res = run_particle_ensemble(
            config, params, seed + N, T=T, obs_dt=obs_dt, dt=dt,
            record_pos=False, record_fft=False, device=device)
        m = res.frames.m_global.cpu().numpy()               # (2*R, M)
        walls[N] = time.perf_counter() - t0
        tail = m[:, m.shape[1] // 2:]
        rms = np.sqrt((tail ** 2).mean(axis=1))
        out[N] = {b: rms[i * n_runs:(i + 1) * n_runs]
                  for i, b in enumerate(BETAS)}
        print(f"# N={N}: T={T:.0f}, {walls[N]:.1f} s ({res.engine}), "
              + ", ".join(f"rms(beta={b})={out[N][b].mean():.4f}"
                          for b in BETAS), flush=True)
    return out, walls


def main(argv=None) -> dict:
    """Run the driver (``argv`` as on the command line; None: sys.argv);
    returns the record written to ``critical_scaling.json``."""
    p = argparse.ArgumentParser()
    p.add_argument("--small", action="store_true", help="quick CPU smoke")
    p.add_argument("--outdir", default="critical_scaling_out")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--replot", action="store_true",
                   help="redraw the figure from an existing "
                        "critical_scaling.json (the reference's run=False "
                        "pattern) — no simulation")
    a = p.parse_args(argv)

    if a.small:
        Ns, n_runs, tau_mult = [256, 1024, 4096], 16, 6.0
    else:
        Ns, n_runs, tau_mult = [1024, 4096, 16384], 32, 8.0

    stats = {b: {"mean": [], "se": []} for b in BETAS}
    slopes = {}
    if a.replot:
        with open(os.path.join(a.outdir, "critical_scaling.json")) as f:
            old = json.load(f)
        Ns, n_runs, tau_mult = old["Ns"], old["n_runs"], old["tau_mult"]
        walls = old.get("wall_s")
        for b in BETAS:
            stats[b]["mean"] = old["rms_mean"][str(b)]
            stats[b]["se"] = old["rms_se"][str(b)]
    else:
        res, walls = measure(Ns, n_runs, tau_mult, seed=a.seed,
                             device=a.device)
        walls = [walls[N] for N in Ns]
        for b in BETAS:
            for N in Ns:
                r = res[N][b]
                stats[b]["mean"].append(r.mean())
                stats[b]["se"].append(r.std(ddof=1) / np.sqrt(len(r)))
    for b in BETAS:
        slopes[b] = float(np.polyfit(np.log(Ns),
                                     np.log(stats[b]["mean"]), 1)[0])
    amps = {b: [m * N ** -slopes[b] for m, N in zip(stats[b]["mean"], Ns)]
            for b in BETAS}
    print(f"# slope beta=0.5: {slopes[0.5]:.3f} (law: -1/2)   "
          f"slope beta=1.0: {slopes[1.0]:.3f} (law: -1/4)", flush=True)

    assert -0.62 < slopes[0.5] < -0.38, (
        "subcritical RMS m must scale as N^-1/2", slopes[0.5])
    assert -0.35 < slopes[1.0] < -0.15, (
        "critical RMS m must scale as N^-1/4", slopes[1.0])
    # the two regimes must actually separate
    assert slopes[0.5] < slopes[1.0] - 0.1, (slopes[0.5], slopes[1.0])

    os.makedirs(a.outdir, exist_ok=True)
    rec = {"Ns": Ns, "n_runs": n_runs, "tau_mult": tau_mult,
           "betas": list(BETAS),
           "rms_mean": {str(b): list(map(float, stats[b]["mean"]))
                        for b in BETAS},
           "rms_se": {str(b): list(map(float, stats[b]["se"]))
                      for b in BETAS},
           "slope_subcritical": slopes[0.5], "slope_critical": slopes[1.0],
           "amplitude_check": {str(b): list(map(float, amps[b]))
                               for b in BETAS},
           "wall_s": walls}
    with open(os.path.join(a.outdir, "critical_scaling.json"), "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps({"slope_subcritical": round(slopes[0.5], 3),
                      "slope_critical": round(slopes[1.0], 3)}), flush=True)

    plt = _pyplot()
    if plt is None:
        return rec
    plt.figure(figsize=(6.5, 4.5))
    plt.xscale("log")
    plt.yscale("log")
    for b, color, law, lab in ((0.5, "royalblue", -0.5, r"$N^{-1/2}$"),
                               (1.0, "crimson", -0.25, r"$N^{-1/4}$")):
        mean = np.asarray(stats[b]["mean"])
        se = np.asarray(stats[b]["se"])
        plt.errorbar(Ns, mean, yerr=se, fmt="o", capsize=4, color=color,
                     label=rf"$\beta$={b} (fit {slopes[b]:.2f})")
        guide = mean[0] * (np.asarray(Ns, float) / Ns[0]) ** law
        plt.plot(Ns, guide, "--", color=color, alpha=0.5, label=lab)
    plt.xlim(Ns[0] * 0.7, Ns[-1] * 1.45)
    plt.xlabel("N")
    plt.ylabel(r"stationary RMS $m$")
    plt.title("Critical vs subcritical magnetization fluctuations")
    plt.grid(True, which="both", alpha=0.4)
    plt.legend()
    plt.tight_layout()
    plt.savefig(os.path.join(a.outdir, "critical_scaling.png"), dpi=200)
    plt.close()
    return rec


if __name__ == "__main__":
    main()

"""PDE experiment drivers: single run, β sweep, kernel-σ sweeps.

Reference drivers: IMEX_PDE_solver_run.py, IMEX_PDE_solver_run_sweep.py,
IMEX_PDE_solver_run_sweep_magn{,2}.py; the counterpart of the JAX
package's ``experiments/run_pde_experiments.py``.  Each command writes
``<which>.json`` with its results into ``--outdir`` (the figures too,
where matplotlib is installed).

Usage: python -m hydrolim_tpu_torch.experiments.pde_experiments
       {single,beta,magn,magn2} [--small] [--outdir DIR] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json
import warnings
from pathlib import Path

import numpy as np

from hydrolim_tpu_torch.sweeps.pde_sweeps import (
    pde_beta_sweep,
    pde_kernel_sigma_sweep,
    pde_single_run,
)


def _summary(which: str, r: dict) -> dict:
    """The JSON-able record of a command's results."""
    if which == "single":
        return dict(m_series=r["m_series"], var_series=r["var_series"],
                    fft_amp_k1=r["fft_amp"][:, 1], rho_p=r["rho_p"],
                    rho_m=r["rho_m"], times=r["times"],
                    v_eff_series=r["v_eff_series"],
                    D_eff_series=r["D_eff_series"])
    if which == "beta":
        return r
    with warnings.catch_warnings():    # D is NaN before its first window
        warnings.simplefilter("ignore", RuntimeWarning)
        mean_D = [np.nanmean(v, axis=0) for v in r["D"].values()]
    return dict(T=r["T"], gamma=r["gamma"], beta=r["beta"],
                sigmas=list(r["m"]),
                final_abs_m=[float(np.mean(v[:, -1]))
                             for v in r["m"].values()],
                mean_abs_m=[np.mean(v, axis=0) for v in r["m"].values()],
                mean_D=mean_D)


def _jsonable(x):
    if isinstance(x, dict):
        return {str(k): _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if isinstance(x, np.ndarray):
        return np.where(np.isfinite(x), x, None).tolist() \
            if x.dtype.kind == "f" else x.tolist()
    if isinstance(x, np.generic):
        return x.item()
    return x


def main(which: str, small: bool = False, outdir: str = "pde_out",
         device: str = "cuda"):
    if which == "single":
        kw = dict(L=128, T=2.0, dt=1e-3) if small else {}
        r = pde_single_run(outdir=outdir, device=device, **kw)
        print("final m:", r["m_series"][-1])
    elif which == "beta":
        if small:
            r = pde_beta_sweep(np.linspace(0, 3, 4), n_runs=2, T=6.0,
                               t_min=4.0, t_max=6.0, L=128, dt=1e-3,
                               n_tracers=200, outdir=outdir, device=device)
        else:
            r = pde_beta_sweep(outdir=outdir, device=device)
        print("v(beta):", np.round(r["v_mean"], 4))
        print("D(beta):", np.round(r["D_mean"], 4))
    elif which in ("magn", "magn2"):
        kw = dict(L=128, dt=1e-3, n_tracers=100, T=2.0,
                  kernel_sigma_values=[0.005, 0.05, 1.0], n_runs=2) \
            if small else {}
        r = pde_kernel_sigma_sweep(variant=which, outdir=outdir,
                                   device=device, **kw)
        print("final |m| per sigma:",
              {s: float(np.mean(v[:, -1])) for s, v in r["m"].items()})
    else:
        raise SystemExit(f"unknown experiment {which!r}")
    out = Path(outdir)
    out.mkdir(parents=True, exist_ok=True)
    (out / f"{which}.json").write_text(json.dumps(_jsonable(_summary(which,
                                                                      r))))
    return r


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("which", choices=["single", "beta", "magn", "magn2"])
    p.add_argument("--small", action="store_true")
    p.add_argument("--outdir", default="pde_out")
    p.add_argument("--device", default="cuda")
    a = p.parse_args()
    main(a.which, a.small, a.outdir, a.device)

"""Tiny sizes of the cells for the tests: the same configurations and
traffic, cut so that a run on the port's plain versions takes seconds;
and the faults a test plants under the program's entry."""
from __future__ import annotations

import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

SHRINK = {
    "xeng.particle": dict(L=32, N=100, T=2.0, n_runs=2,
                          betas={"start": 0.0, "stop": 3.0, "num": 3}),
    "xeng.pde": dict(n_runs=2, betas={"start": 0.0, "stop": 3.0, "num": 3},
                     pde=dict(L=64, T=0.1, t_min=0.05, t_max=0.1,
                              n_tracers=20)),
}
FAULTS = ("unchanged", "half", "altered")


def tiny_run(name: str, seed: int = 123456789012, trace: bool = False,
             device="cpu") -> dict:
    """One run of ``name`` at its tiny size."""
    from portbench import harness

    return harness.run_cell(name, seed, 0.01, trace,
                            t_start=time.perf_counter(), device=device,
                            shrink=SHRINK[name])


def _b1(kind):
    from hydrolim_tpu_torch.sweeps import fast_meanfield

    orig = fast_meanfield.meanfield_multi_step

    def broken(scal, seeds, pos, sigma, wind, **kw):
        out = orig(scal, seeds, pos, sigma, wind, **kw)
        if kind == "unchanged":
            return pos.clone(), sigma.clone(), wind.clone()
        if kind == "half":          # the second half of the batch stays
            h = pos.shape[0] // 2
            return tuple(torch.cat([o[:h], i[h:]]) for o, i in
                         zip(out, (pos, sigma, wind)))
        p = out[0].clone()          # one particle moved one site more
        p[0, 0] = (p[0, 0] + 1) % int(kw["L"])
        return (p,) + tuple(out[1:])
    return fast_meanfield, "meanfield_multi_step", broken


def _b2(kind):
    from hydrolim_tpu_torch.pde import fast_solve

    orig = fast_solve.pde_multi_step

    def broken(scal, seeds, step0, rho_p, rho_m, pos, spin, hist, *a, **kw):
        out = orig(scal, seeds, step0, rho_p, rho_m, pos, spin, hist, *a,
                   **kw)
        if kind == "unchanged":
            return (rho_p.clone(), rho_m.clone(), pos.clone(), spin.clone(),
                    hist.clone(), out[5])
        if kind == "half":
            h = rho_p.shape[0] // 2
            return tuple(torch.cat([o[:h], i[h:]]) for o, i in
                         zip(out[:5], (rho_p, rho_m, pos, spin, hist))) + (
                out[5],)
        rec = out[5].clone()        # one m record off where it is made
        rec[0, -1, 0] += 0.02
        return tuple(out[:5]) + (rec,)
    return fast_solve, "pde_multi_step", broken


def plant(monkeypatch, name: str, kind: str) -> None:
    """Break the kernel call under cell ``name``'s entry: a step that
    returns its state unchanged, the second half of the batch left as it
    was, or one answer altered where it is produced."""
    module, attr, broken = (_b1 if name == "xeng.particle" else _b2)(kind)
    monkeypatch.setattr(module, attr, broken)

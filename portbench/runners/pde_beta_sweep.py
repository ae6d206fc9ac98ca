"""The cross-engine check's PDE half, ``sweeps.pde_sweeps.pde_beta_sweep``:
``run_pde_ensemble`` → ``pde.fast_solve.pde_solve_fused`` (kernel B2 and
its spectra kernel), then the windowed v_eff and D_eff means."""
from __future__ import annotations

import tempfile

import numpy as np
import torch

from portbench.reference import pde as ref_pde
from portbench.runners.base import (BaseRunner, as_result, b2_calls,
                                    betas_of, pde_gaps, tap)


class Runner(BaseRunner):
    def __init__(self, config, traffic, device, spans, sync, shrink=None):
        # the configuration's PDE half, its shared keys (λ, γ, the β grid)
        # beside it
        shrink = dict(shrink or {})
        pde = dict(config["pde"], **shrink.pop("pde", {}))
        super().__init__({k: v for k, v in config.items() if k != "pde"},
                         traffic, device, spans, sync, shrink)
        self.cfg.update(pde)
        from hydrolim_tpu_torch.sweeps import pde_sweeps
        self.pde_sweeps = pde_sweeps
        self.betas = betas_of(self.cfg["betas"])
        self.B = len(self.betas) * self.cfg["n_runs"]
        self.tmp = tempfile.TemporaryDirectory()
        self.last = None

    def close(self):
        self.tmp.cleanup()

    def _wrap(self, orig):
        def pde_solve_fused(config, params_b, rho_p0, rho_m0, tracers0,
                            generator, **kw):
            with self.spans.span("solve"):
                res = orig(config, params_b, rho_p0, rho_m0, tracers0,
                           generator, **kw)
                self._sync()
            self.last = dict(config=config, gamma=float(params_b.gamma[0]),
                             lam=float(params_b.lam[0]),
                             start=(rho_p0, rho_m0, tracers0.unwrapped,
                                    tracers0.spin),
                             keep_snapshots=kw.get("keep_snapshots", True))
            return res
        return pde_solve_fused

    def _sweep(self, seed):
        c = self.cfg
        res = {}
        orig_run = self.pde_sweeps.run_pde_ensemble

        def run_pde_ensemble(*a, **kw):
            out = orig_run(*a, **kw)
            res["np"] = out[0]
            return out
        with tap(self.pde_sweeps, "pde_solve_fused", self._wrap), \
                tap(self.pde_sweeps, "run_pde_ensemble",
                    lambda _: run_pde_ensemble):
            out = self.pde_sweeps.pde_beta_sweep(
                self.betas, n_runs=c["n_runs"], T=c["T"], t_min=c["t_min"],
                t_max=c["t_max"], gamma=c["gamma"], lam=c["lam"],
                kernel_sigma=c["kernel_sigma"], L=c["L"], dt=c["dt"],
                seed=seed, n_tracers=c["n_tracers"], outdir=self.tmp.name,
                plot_result=False, device=self.device)
        return out, res["np"]

    def warm(self):
        self._sweep(0)

    def unit(self, seed, keep):
        out, res = self._sweep(seed)
        config = self.last["config"]
        if keep:
            self.kept = dict(self.last, unit_seed=seed, out=out, res=res)
        return float(self.B * config.L * config.nsteps)

    def calls(self):
        return b2_calls(self.last["config"], self.B)

    def _reference(self, dtype):
        """The reference's sweep from the kept unit's seed, in ``dtype``,
        with the estimators from its own records; and its initial state."""
        k, c = self.kept, self.cfg
        config = k["config"]
        dev = torch.device(self.device)
        law = ref_pde.PDELaw(
            L=config.L, dt=config.dt, nsteps=config.nsteps,
            window=config.tracer_window, kmax=config.kmax,
            interval=config.snapshot_interval, gamma=k["gamma"],
            lam=k["lam"], beta=torch.tensor(np.repeat(self.betas,
                                                      c["n_runs"]),
                                            dtype=torch.float32),
            device=dev, dtype=dtype)
        p, q, pos, spin, hist, seeds, gen = ref_pde.homogeneous_inputs(
            k["unit_seed"], self.B, config.L, config.n_tracers,
            config.tracer_window, dev)
        ref = ref_pde.run(law, p, q, pos, spin, hist, gen, seeds,
                          "generator" if dev.type == "cpu" else "philox",
                          k["keep_snapshots"])
        t = np.linspace(0, c["T"], config.nsteps + 1)
        host = lambda x: x.double().cpu().numpy()
        est = ref_pde.window_means(t, host(ref.v_eff), host(ref.D_eff),
                                   len(self.betas), c["n_runs"],
                                   c["t_min"], c["t_max"])
        return ref, est, (p, q, pos, spin)

    @staticmethod
    def _estimator_gap(got: dict, ref: dict) -> float:
        """The largest gap of the per-β v_eff and D_eff means, relative to
        the largest of each."""
        return max(float(np.max(np.abs(np.asarray(got[key], float) - r))
                         / max(np.max(np.abs(r)), 1e-30))
                   for key, r in ref.items() if key in ("v_mean", "D_mean"))

    def check(self):
        """The whole sweep from its seed: the initial state, every record
        row, the final fields, and the estimators from the reference's own
        records."""
        k = self.kept
        ref, est, start = self._reference(torch.float32)
        out = {"start": max(float((a.to(b) - b).abs().max())
                            for a, b in zip(k["start"], start))}
        pde_gaps(out, k["res"], ref, k["keep_snapshots"],
                 k["config"].snapshot_interval)
        out["estimators"] = self._estimator_gap(k["out"], est)
        return out

    def control(self, dtype):
        """The reference in ``dtype`` put in the program's place."""
        ref, est, _ = self._reference(torch.float32)
        low, low_est, _ = self._reference(dtype)
        out = pde_gaps({}, as_result(low), ref, self.kept["keep_snapshots"],
                       self.kept["config"].snapshot_interval)
        out["estimators"] = self._estimator_gap(low_est, est)
        return out

"""The cross-engine check's particle half,
``experiments.cross_engine_validation.particle_side``: kernel B1 through
``sweeps.fast_meanfield.run_meanfield_sweep``, then v_eff and D_eff on the
host."""
from __future__ import annotations

import itertools

import numpy as np
import torch

from portbench.reference import meanfield as ref_mf
from portbench.runners.base import BaseRunner, Calls, betas_of, tap


class Runner(BaseRunner):
    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        from hydrolim_tpu_torch.experiments import cross_engine_validation
        self.xev = cross_engine_validation
        c = self.cfg
        self.betas = betas_of(c["betas"])
        self.B = len(self.betas) * c["n_runs"]
        self.last = None

    def _wrap(self, orig):
        def run_meanfield_sweep(config, params_b, **kw):
            with self.spans.span("solve"):
                frames = orig(config, params_b, **kw)
                self._sync()
            self.last = dict(kw, frames=frames)
            return frames
        return run_meanfield_sweep

    def _side(self, seed: int, T: float):
        c = self.cfg
        with tap(self.xev, "run_meanfield_sweep", self._wrap):
            return self.xev.particle_side(
                self.betas, c["n_runs"], L=c["L"], N=c["N"], T=T,
                obs_dt=c["obs_dt"], seed=seed, device=self.device)

    def warm(self):
        self._side(0, 4 * self.cfg["obs_dt"])

    def unit(self, seed, keep):
        out = self._side(seed, self.cfg["T"])
        last = self.last
        n_sub = ref_mf.n_substeps(last["obs_dt"], last["dt"])
        frames = len(last["frames"].times_obs)
        if keep:
            self.kept = dict(last, unit_seed=seed, out=out)
        return float(self.B * self.cfg["N"] * (frames - 1) * n_sub)

    def calls(self):
        c, last = self.cfg, self.last
        n_sub = ref_mf.n_substeps(last["obs_dt"], last["dt"])
        frames = len(last["frames"].times_obs)
        return Calls(b1=[dict(B=self.B, N=c["N"], k=n_sub)] * (frames - 1))

    def _law(self, dtype):
        """B1's law of the kept sweep, in ``dtype``; the reference's own
        Δt beside it."""
        c = self.cfg
        L, n = c["L"], c["N"]
        rd, ra = c["gamma"] * L * L, c["lam"] * L
        dt = ref_mf.b1_dt(rd, ra, float(np.max(self.betas)))
        n_sub = ref_mf.n_substeps(c["obs_dt"], dt)
        dev = torch.device(self.device)
        law = ref_mf.MeanfieldLaw(
            L=L, n=n, beta=torch.tensor(np.repeat(self.betas, c["n_runs"]),
                                        dtype=torch.float32, device=dev),
            rate_diffusion=float(np.float32(rd)),
            rate_active=float(np.float32(ra)),
            dt=c["obs_dt"] / n_sub, n_sub=n_sub,
            frames=len(self.kept["frames"].times_obs), device=dev,
            dtype=dtype)
        return law, dt

    def _follow(self, law):
        """(rows, initial positions, iterator of (unwrapped, σ) per frame
        after the first) of the reference from the kept sweep's seed: on
        the plain version's draws (CPU), every replica through every
        frame; on the kernel's stream, every replica through its first
        ``check_frames`` frames and the ``check_replicas`` drawn from the
        seed through all of them."""
        c, k = self.cfg, self.kept
        dev = torch.device(self.device)
        pos0, sig0, seeds, gen = ref_mf.sweep_inputs(
            k["unit_seed"], self.B, c["N"], c["L"], dev)
        if dev.type == "cpu":
            yield list(range(self.B)), pos0, ref_mf.follow_dense(
                law, gen, pos0, sig0)
            return
        rng = np.random.default_rng([k["unit_seed"], 7])
        whole = set(rng.choice(self.B, size=min(c["check_replicas"], self.B),
                               replace=False).tolist())
        for b in range(self.B):
            it = ref_mf.follow_replica(law, b, int(seeds[b]), pos0[b],
                                       sig0[b])
            yield [b], pos0, (it if b in whole
                              else itertools.islice(it, c["check_frames"]))

    def _frames_gap(self, got, law, out):
        """Elements of ``got(f, rows)`` (positions, m, ρ₊, ρ₋) that differ
        from the reference's frames, and the largest relative gap of Var."""
        L, n = law.L, law.n
        differ, var_gap = 0, 0.0
        for rows, pos0, it in self._follow(law):
            differ += int((torch.as_tensor(got(0, rows)[0]).to(pos0)
                           != pos0[rows]).sum())
            for f, (up, sg) in enumerate(it, start=1):
                up, sg = up.reshape(len(rows), n), sg.reshape(len(rows), n)
                m, rp, rm, var = ref_mf.frame_records(up, sg, L, 1.0 / L)
                gp, gm, grp, grm, gv = got(f, rows)
                for a, r in ((gp, up), (gm, m), (grp, rp), (grm, rm)):
                    differ += int((torch.as_tensor(a).to(r) != r).sum())
                rv = var.cpu().numpy()
                var_gap = max(var_gap, float(np.max(
                    np.abs(np.asarray(gv) - rv) / np.maximum(rv, 1e-30))))
        out["b1_elements_differing"] = float(differ)
        out["var_record"] = var_gap
        return out

    def check(self):
        """B1's law followed exactly from the sweep's seed (the initial
        state, then the frames' positions and records as ``_follow``
        says), every frame's total density against its positions, and
        the estimators."""
        c, k = self.cfg, self.kept
        L, n = c["L"], c["N"]
        fr = k["frames"]
        law, dt = self._law(torch.float32)
        out = {"dt": float(abs(dt - k["dt"]) / dt)}
        self._frames_gap(lambda f, rows: (
            fr.pos[f][rows], fr.m_global[f][rows], fr.rho_p[f][rows],
            fr.rho_m[f][rows], fr.var[f][rows]), law, out)
        tot = fr.rho_p + fr.rho_m
        counts = np.zeros(tot.shape)
        np.add.at(counts, (np.arange(tot.shape[0])[:, None, None],
                           np.arange(self.B)[None, :, None],
                           np.mod(fr.pos, L)), 1.0)
        out["density_record"] = float(np.max(np.abs(np.rint(tot * n / L)
                                                   - counts)))
        (v, ve, D, De), _ = ref_mf.particle_estimators(
            fr.pos, fr.times_obs, len(self.betas), c["n_runs"], L)
        out["estimators"] = max(
            float(np.max(np.abs(np.asarray(g) - r))
                  / max(np.max(np.abs(r)), 1e-30))
            for g, r in zip(k["out"], (v, ve, D, De)))
        return out

    def control(self, dtype):
        """The reference in ``dtype`` put in the program's place."""
        law, _ = self._law(torch.float32)
        low, _ = self._law(dtype)
        frames = {}
        for rows, pos0, it in self._follow(low):
            frames[tuple(rows)] = [(pos0[rows],) + (None,) * 4]
            for up, sg in it:
                up = up.reshape(len(rows), law.n)
                sg = sg.reshape(len(rows), law.n)
                m, rp, rm, var = ref_mf.frame_records(up, sg, law.L,
                                                      1.0 / law.L)
                frames[tuple(rows)].append((up, m, rp, rm,
                                            var.cpu().numpy()))
        return self._frames_gap(lambda f, rows: frames[tuple(rows)][f],
                                law, {})

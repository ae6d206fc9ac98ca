"""Plain reference of the mean-field particle sweep (kernel B1's law).

The law of one τ-leap step of a replica of n particles on a periodic
lattice of L sites (bidirectional model, global m): m = Σσ / n in float32;
one uniform u per particle against the cumulative thresholds

    t1 = r_d·dt, t2 = t1 + r_d·dt, t3 = t2 + r_a·dt, t4 = t3 + e(σ, m),
    e(+1, m) = exp(−βm)·dt, e(−1, m) = exp(βm)·dt,

each product and sum rounded to float32 one at a time: u < t1 hops left,
u < t2 right, u < t3 along σ, u < t4 flips σ, else nothing.  The frames
record the unwrapped positions, m, the ± densities and their variance.

Two ways to draw the uniforms, as the program draws them:

- ``philox``: the kernel's native stream, word q of Philox4x32-10 at
  counter (group g, global step) and key (seed[b], b); particle 4g + q.
  ``follow_replica`` follows one replica through every frame of a sweep
  without stepping the lattice one step at a time: between σ flips the
  moves of a particle do not depend on m, so a frame's hops are summed in
  bulk, and only the rare draws that can be flips (t3 ≤ u < t3 + max e)
  are walked in order on the host, with m as it stands at their step.
- ``generator``: the plain version's draws on the CPU, one
  ``torch.rand((B, n))`` per step from the sweep's generator
  (``follow_dense``, every replica, a step at a time; small sizes only).

The thresholds' exponentials are taken with ``torch.exp`` on the device
the program ran on, so that they round as the program's do.  Nothing here
imports the program.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from portbench.reference.philox import bits_to_uniform, philox4x32_10

F32 = torch.float32


def b1_dt(rate_diffusion: float, rate_active: float, beta_max: float,
          max_event_prob: float = 0.10) -> float:
    """The sweep's static Δt: the largest per-particle event probability
    at the largest β, 2·r_d + r_a + e^|β|, held at ``max_event_prob``
    (rates as float32, as the program holds them)."""
    rd, ra = (float(np.float32(v)) for v in (rate_diffusion, rate_active))
    return max_event_prob / max(2.0 * rd + ra + math.exp(abs(beta_max)),
                                1e-12)


def n_substeps(obs_dt: float, dt: float) -> int:
    return max(1, int(math.ceil(obs_dt / dt - 1e-9)))


def sweep_inputs(seed: int, B: int, n: int, L: int, device):
    """The sweep's initial positions and σ and the kernel's Philox seeds,
    drawn from a generator seeded with ``seed`` on ``device`` in the
    sweep's order; returns them with the generator."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    pos = torch.randint(0, L, (B, n), generator=gen, device=device,
                        dtype=torch.int32)
    sigma = torch.randint(0, 2, (B, n), generator=gen, device=device,
                          dtype=torch.int32) * 2 - 1
    seeds = torch.randint(0, 2 ** 31 - 1, (B,), generator=gen,
                          device=device, dtype=torch.int32)
    return pos, sigma, seeds, gen


@dataclasses.dataclass
class MeanfieldLaw:
    """One sweep's fixed numbers: L, n, the per-replica β and rates as
    float32, the step Δt (float32 as the kernel takes it), the steps per
    frame and the frames' count."""

    L: int
    n: int
    beta: torch.Tensor        # (B,) float32
    rate_diffusion: float
    rate_active: float
    dt: float                 # the step, obs_dt / n_sub
    n_sub: int
    frames: int
    device: torch.device
    dtype: torch.dtype = F32  # the thresholds' precision (the control's lower)

    def thresholds(self):
        """(t1, t2, t3) as (B,) tensors."""
        dev, dt = self.device, torch.tensor(self.dt, dtype=F32,
                                            device=self.device)
        B = self.beta.shape[0]
        rd = torch.full((B,), self.rate_diffusion, dtype=F32, device=dev)
        ra = torch.full((B,), self.rate_active, dtype=F32, device=dev)
        p_dif = self._r(rd * dt)
        t2 = self._r(p_dif + p_dif)
        return p_dif, t2, self._r(t2 + self._r(ra * dt))

    def flip_probs(self, S: torch.Tensor, beta: torch.Tensor):
        """(e_p, e_m) at integer Σσ ``S`` (broadcast against ``beta``)."""
        dt = torch.tensor(self.dt, dtype=F32, device=self.device)
        m = S.to(F32) / torch.tensor(float(self.n), dtype=F32,
                                     device=self.device)
        return (self._r(self._r(torch.exp(self._r(-beta * m))) * dt),
                self._r(self._r(torch.exp(self._r(beta * m))) * dt))

    def _r(self, x):
        """Round to the law's precision (float32, or the control's)."""
        return x if self.dtype == F32 else x.to(self.dtype).to(F32)


def frame_records(unwrapped: torch.Tensor, sigma: torch.Tensor, L: int,
                  dx: float):
    """(m, ρ₊, ρ₋, Var) of a (R, n) frame, as the sweep records them."""
    R, n = sigma.shape
    site = (unwrapped % L).long()
    cp = torch.zeros((R, L), dtype=F32, device=sigma.device)
    cm = torch.zeros((R, L), dtype=F32, device=sigma.device)
    cp.scatter_add_(1, site, (sigma > 0).to(F32))
    cm.scatter_add_(1, site, (sigma < 0).to(F32))
    denom = float(n) * dx
    rho_p, rho_m = cp / denom, cm / denom
    var = (rho_p + rho_m).var(-1, unbiased=False)
    return sigma.sum(-1).to(F32) / n, rho_p, rho_m, var


def follow_dense(law: MeanfieldLaw, gen: torch.Generator, pos, sigma):
    """Every replica through every frame a step at a time, on the plain
    version's uniforms from ``gen``; yields (unwrapped, σ) at each frame
    after the first."""
    t1, t2, t3 = (t[:, None] for t in law.thresholds())
    beta = law.beta[:, None]
    L = law.L
    unwrapped = pos.clone()
    for _ in range(1, law.frames):
        for _ in range(law.n_sub):
            e_p, e_m = law.flip_probs(sigma.sum(-1, keepdim=True,
                                                dtype=torch.int64), beta)
            u = torch.rand(pos.shape, generator=gen, device=pos.device,
                           dtype=F32)
            t4 = law._r(t3 + torch.where(sigma > 0, e_p, e_m))
            flip = (u >= t3) & (u < t4)
            delta = torch.where(u < t1, -1, torch.where(
                u < t2, 1, torch.where(u < t3, sigma, 0)))
            unwrapped = unwrapped + delta
            sigma = torch.where(flip, -sigma, sigma)
        yield unwrapped.clone(), sigma.clone()


def _uniforms(seed_b: int, key_b: int, G: int, n: int, s_lo: int,
              s_hi: int, device) -> torch.Tensor:
    """(s_hi − s_lo, n) uniforms of one replica at global steps
    [s_lo, s_hi)."""
    g = torch.arange(G, dtype=torch.int64, device=device)[None, :]
    s = torch.arange(s_lo, s_hi, dtype=torch.int64, device=device)[:, None]
    zero = torch.zeros((), dtype=torch.int64, device=device)
    words = philox4x32_10(g.expand(s.shape[0], G), s.expand(-1, G), zero,
                          zero, seed_b & 0xFFFFFFFF, key_b & 0xFFFFFFFF)
    bits = torch.stack(words, dim=-1).reshape(s.shape[0], 4 * G)[:, :n]
    return bits_to_uniform(bits)


def follow_replica(law: MeanfieldLaw, b: int, seed_b: int, pos0, sigma0,
                   chunk: int = 8192):
    """Replica ``b`` of the sweep through every frame on the kernel's
    native stream (key (seed_b, b)); yields (unwrapped (n,), σ (n,)) at
    each frame after the first.  ``pos0``, ``sigma0``: its (n,) initial
    state."""
    dev = law.device
    n, L = law.n, law.L
    G = -(-n // 4)
    t1, t2, t3 = (float(t[b]) for t in law.thresholds())
    S_all = torch.arange(-n, n + 1, dtype=torch.int64, device=dev)
    e_p, e_m = law.flip_probs(S_all, law.beta[b])
    t3_t = torch.tensor(t3, dtype=F32, device=dev)
    t4_p = law._r(t3_t + e_p).tolist()      # t4 of a + particle at Σσ = S
    t4_m = law._r(t3_t + e_m).tolist()
    t4_hi = max(max(t4_p), max(t4_m))
    unwrapped = pos0.to(torch.int64).clone()
    sigma = sigma0.to(torch.int64).clone()
    S = int(sigma.sum())
    for f in range(1, law.frames):
        step0 = (f - 1) * law.n_sub
        hops = torch.zeros(n, dtype=torch.int64, device=dev)
        active, cands = [], []
        for lo in range(0, law.n_sub, chunk):
            hi = min(law.n_sub, lo + chunk)
            u = _uniforms(seed_b, b, G, n, step0 + lo, step0 + hi, dev)
            hops += ((u >= t1) & (u < t2)).sum(0) - (u < t1).sum(0)
            active.append((u >= t2) & (u < t3))
            c = ((u >= t3) & (u < t4_hi)).nonzero()
            cands.append((c[:, 0] + lo, c[:, 1], u[c[:, 0], c[:, 1]]))
        # the draws that may flip, in step order, each against t4 at Σσ
        # as it stood when its step began
        steps = torch.cat([c[0] for c in cands]).tolist()
        parts = torch.cat([c[1] for c in cands]).tolist()
        us = torch.cat([c[2] for c in cands]).double().tolist()
        sg = sigma.tolist()
        flips_s, flips_i = [], []
        cur, dS = -1, 0
        for s, i, u in zip(steps, parts, us):
            if s != cur:
                S, dS, cur = S + dS, 0, s
            x = sg[i]
            if u < (t4_p if x > 0 else t4_m)[S + n]:
                flips_s.append(s)
                flips_i.append(i)
                sg[i] = -x
                dS -= 2 * x
        S += dS
        # the moves along σ, each with σ as it stood at its step
        fs = torch.tensor(flips_s, dtype=torch.int64, device=dev)
        fi = torch.tensor(flips_i, dtype=torch.int64, device=dev)
        parity = torch.zeros(n, dtype=torch.int64, device=dev)
        along = torch.zeros(n, dtype=torch.int64, device=dev)
        for k, lo in enumerate(range(0, law.n_sub, chunk)):
            act = active[k]
            mark = torch.zeros(act.shape, dtype=torch.int32, device=dev)
            sel = (fs >= lo) & (fs < lo + act.shape[0])
            mark[fs[sel] - lo, fi[sel]] = 1
            odd = (parity[None, :] + mark.cumsum(0)) & 1
            along += (act * (sigma[None, :] * (1 - 2 * odd))).sum(0)
            parity += mark.sum(0)
        sigma = torch.tensor(sg, dtype=torch.int64, device=dev)
        unwrapped = unwrapped + hops + along
        yield unwrapped.clone(), sigma.clone()


def particle_estimators(pos_frames: np.ndarray, times: np.ndarray,
                        n_beta: int, n_runs: int, L: int):
    """v_eff and D_eff of the cross-engine check from (M, B, n) unwrapped
    site positions: per run, over the second half of the frames, the slope
    of the mean displacement (|v|) and half the slope of its variance (D);
    the mean over runs and its standard error.  Returns (v, v_err, D,
    D_err) per β and the per-run (v, D)."""
    s = len(times) // 2
    dx = 1.0 / L
    span = times[s:] - times[s]
    per_run = np.zeros((n_beta * n_runs, 2))
    for j in range(n_beta * n_runs):
        pos = pos_frames[:, j].astype(float) * dx
        disp = pos[s:] - pos[s]
        per_run[j, 0] = abs(np.polyfit(span, disp.mean(axis=1), 1)[0])
        var = ((disp - disp.mean(axis=1, keepdims=True)) ** 2).mean(axis=1)
        per_run[j, 1] = np.polyfit(span, var, 1)[0] / 2.0
    runs = per_run.reshape(n_beta, n_runs, 2)
    mean = runs.mean(axis=1)
    err = runs.std(axis=1) / np.sqrt(n_runs)
    return (mean[:, 0], err[:, 0], mean[:, 1], err[:, 1]), per_run

"""Plain reference of the batched IMEX PDE solve with tracers (kernel B2's
law, its spectra and the run loop's records).

One step n of a replica (fields ρ₊, ρ₋ on a periodic lattice of L sites,
tracers with positions x, spins s and a ring of their last W positions):

1. m: the global magnetization Σ(ρ₊−ρ₋) / (Σ(ρ₊+ρ₋) + 1e-12);
2. the record row: mean m, Var of ρ₊+ρ₋, v_eff = mean Δx / (W·dt) and
   D_eff = var Δx / (2W·dt) over the ring's window (NaN before W steps),
   and the first kmax rfft bins of ρ₊+ρ₋ divided by L;
3. tracers: s flips where u < clip(exp(−β s m(x)), 1e-8, 1e8)·dt, then
   x += λ s·dt + sqrt(2γ·dt)·z;
4. fields: the implicit diffusion A ρ₁ = ρ (A = I − γ dt D/dx², solved
   exactly), upwind advection and the Curie–Weiss reaction with clipped rates, the
   clip at 0, and the mass renormalised to its post-diffusion total.

Snapshots of ρ₊+ρ₋ and ρ₊−ρ₋ are kept at the start of each block of
``interval`` steps; the final iteration n = nsteps records and moves the
tracers but steps no field.

Fields and tracers are float32, each product and sum rounded in turn; the
solve runs in float64 (a dense inverse, or by the FFT past 8192 sites).  The control rounds every field and
tracer result to the lower precision it is given.

Draws: ``philox`` is the kernel's native stream, words (flip, u2, u3) of
Philox4x32-10 at counter (tracer, step) and key (seed[b], b), with
z = sqrt(−2 log max(u2, 1e-12))·cos(2π u3); ``generator`` is the plain
version's, ``torch.rand`` then ``torch.randn`` of (B, n_t) per step from
the run's generator.  The final iteration draws from the generator in both.
Nothing here imports the program.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from portbench.reference.philox import bits_to_uniform, philox4x32_10

F32, F64 = torch.float32, torch.float64
TWO_PI_F32 = 6.2831854820251465


@dataclasses.dataclass
class PDELaw:
    L: int
    dt: float
    nsteps: int
    window: int
    kmax: int
    interval: int
    gamma: float
    lam: float
    beta: torch.Tensor            # (B,) float32
    xlim: float = 1.0
    device: torch.device = torch.device("cpu")
    dtype: torch.dtype = F32      # the control's lower precision

    def __post_init__(self):
        dev, L = self.device, self.L
        self.dx = self.xlim / L
        f = lambda v: torch.tensor(v, dtype=F32, device=dev)
        self.dt32, self.dx32, self.lam32 = f(self.dt), f(self.dx), f(self.lam)
        self.b = self.beta.to(device=dev, dtype=F32)[:, None]
        self.amp = torch.sqrt(f(2.0 * np.float32(self.gamma)) * self.dt32)
        self.noisy = float(self.amp) > 0.0
        self.w_dt = f(float(self.window) * float(self.dt32))
        self.w_2dt = f(2.0 * float(self.window) * float(self.dt32))
        c = self.gamma * self.dt / self.dx ** 2
        sym = 1.0 / (1.0 + 2.0 * c - 2.0 * c * np.cos(
            2.0 * np.pi * np.arange(L // 2 + 1) / L))
        self.solve_sym = torch.tensor(sym, dtype=F64, device=dev)

    def r(self, x):
        """Round to the law's precision (float32, or the control's)."""
        return x if self.dtype == F32 else x.to(self.dtype).to(F32)

    def prepare(self):
        """The step's operands: A⁻¹ (as a dense float64 matrix up to 8192
        sites, else by its symbol) and the DFT columns of the recorded
        bins."""
        dev, L = self.device, self.L
        if L <= 8192:
            c = self.gamma * self.dt / self.dx ** 2
            A = (1.0 + 2.0 * c) * np.eye(L)
            i = np.arange(L)
            A[i, (i + 1) % L] -= c
            A[i, (i - 1) % L] -= c
            self.solve_mat = torch.tensor(np.linalg.inv(A).T, dtype=F64,
                                          device=dev)
        else:
            self.solve_mat = None
        k = np.arange(self.kmax)
        ang = 2.0 * np.pi * np.outer(np.arange(L), k) / L
        self.dft = torch.tensor(np.concatenate([np.cos(ang), -np.sin(ang)],
                                               axis=1) / L,
                                dtype=F64, device=dev)

    def solve_fields(self, F):
        """A⁻¹ applied to each (·, L) row of F, in float64."""
        x = F.reshape(-1, self.L).to(F64)
        if self.solve_mat is not None:
            y = x @ self.solve_mat
        else:
            y = torch.fft.irfft(torch.fft.rfft(x, dim=-1) * self.solve_sym,
                                n=self.L, dim=-1)
        return self.r(y.to(F32)).reshape(F.shape)

    def cw(self, s, m):
        return torch.clamp(self.r(torch.exp(self.r(self.r(-self.b * s)
                                                    * m))), 1e-8, 1e8)

    def step(self, st: "State", fields: bool = True):
        """Step n = ``st.n`` in place: records row n into ``st.recs``,
        moves the tracers on the draws at row n − ``st.lo`` of ``st.U0``,
        ``st.Z``, and (``fields``) steps the fields."""
        L, r = self.L, self.r
        p, q = st.F[0], st.F[1]
        num, den = r(p - q), r(p + q)
        sd = den.sum(-1, keepdim=True)
        mx = r(num.sum(-1, keepdim=True) / r(sd + 1e-12))
        t_mean = r(sd / L)
        var = r(r(r(den - t_mean) ** 2).sum(-1) / L)
        spec = r((den.to(F64) @ self.dft).to(F32))
        # tracers
        j = st.n - st.lo
        u0 = st.U0.index_select(0, j.reshape(1))[0]
        z = st.Z.index_select(0, j.reshape(1))[0]
        pos, spin = st.pos, st.spin
        flip = u0 < r(self.cw(spin, mx) * self.dt32)
        spin = torch.where(flip, -spin, spin)
        pos = r(pos + r(r(self.lam32 * spin) * self.dt32))
        if self.noisy:
            pos = r(pos + r(self.amp * z))
        slot = torch.remainder(st.n, self.window).reshape(1)
        dr = r(pos - st.hist.index_select(0, slot)[0])
        st.hist.index_copy_(0, slot, pos[None])
        st.pos.copy_(pos)
        st.spin.copy_(spin)
        mean_dr = dr.mean(-1)
        var_dr = ((dr - mean_dr[:, None]) ** 2).mean(-1)
        valid = st.n >= self.window
        nan = torch.full_like(mean_dr, float("nan"))
        v = torch.where(valid, r(mean_dr / self.w_dt), nan)
        D = torch.where(valid, r(var_dr / self.w_2dt), nan)
        row = torch.cat([torch.stack([mx[:, 0], var, v, D], -1), spec], -1)
        st.recs.index_copy_(0, st.n.reshape(1), row[None])
        st.n += 1
        if not fields:
            return
        F1 = self.solve_fields(st.F)
        p1, q1 = F1[0], F1[1]
        R = r(r(self.cw(-1.0, mx) * q1) - r(self.cw(1.0, mx) * p1))
        dp = r(r(p1 - torch.roll(p1, 1, -1)) / self.dx32)
        dq = r(r(torch.roll(q1, -1, -1) - q1) / self.dx32)
        p2 = torch.clamp(r(p1 + r(self.dt32 * r(r(-self.lam32 * dp) + R))),
                         min=0.0)
        q2 = torch.clamp(r(q1 + r(self.dt32 * r(r(self.lam32 * dq) - R))),
                         min=0.0)
        M0 = r(p1 + q1).sum(-1, keepdim=True)
        M1 = r(p2 + q2).sum(-1, keepdim=True)
        sc = r(M0 / torch.clamp(M1, min=1e-30))
        st.F.copy_(torch.stack([r(p2 * sc), r(q2 * sc)]))


@dataclasses.dataclass
class State:
    """The solve's static tensors: fields (2, B, L), tracers (B, n_t),
    their ring (W, B, n_t), the step n and the first step ``lo`` of the
    draws in U0, Z (K, B, n_t), and the records (nsteps + 1, B, ·)."""

    F: torch.Tensor
    pos: torch.Tensor
    spin: torch.Tensor
    hist: torch.Tensor
    n: torch.Tensor
    lo: torch.Tensor
    U0: torch.Tensor
    Z: torch.Tensor
    recs: torch.Tensor

    def copy(self) -> "State":
        return State(**{f.name: getattr(self, f.name).clone()
                        for f in dataclasses.fields(self)})

    def load(self, other: "State") -> None:
        for f in dataclasses.fields(self):
            getattr(self, f.name).copy_(getattr(other, f.name))


def tracer_draws(seeds: torch.Tensor, n_t: int, s_lo: int, s_hi: int):
    """(flip u, z) of every replica's tracers at steps [s_lo, s_hi) from
    the kernel's native stream: (steps, B, n_t) float32 each."""
    dev = seeds.device
    B = seeds.shape[0]
    j = torch.arange(n_t, dtype=torch.int64, device=dev)[None, None, :]
    s = torch.arange(s_lo, s_hi, dtype=torch.int64, device=dev)[:, None,
                                                                 None]
    k0 = (seeds.to(torch.int64) & 0xFFFFFFFF)[None, :, None]
    k1 = torch.arange(B, dtype=torch.int64, device=dev)[None, :, None]
    shape = (s_hi - s_lo, B, n_t)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    w0, w1, w2, _ = philox4x32_10(j.expand(shape), s.expand(shape), zero,
                                  zero, k0, k1)
    u2 = torch.clamp(bits_to_uniform(w1), min=1e-12)
    u3 = bits_to_uniform(w2)
    z = torch.sqrt(-2.0 * torch.log(u2)) * torch.cos(
        torch.tensor(TWO_PI_F32, dtype=F32, device=dev) * u3)
    return bits_to_uniform(w0), z


@dataclasses.dataclass
class PDERun:
    """The reference's result in the program's layout: final fields, the
    (B, nsteps + 1) records, the snapshots."""

    rho_p: torch.Tensor
    rho_m: torch.Tensor
    m_mean: torch.Tensor
    var: torch.Tensor
    v_eff: torch.Tensor
    D_eff: torch.Tensor
    fft_re: torch.Tensor
    fft_im: torch.Tensor
    snapshots: Optional[torch.Tensor]
    m_snapshots: Optional[torch.Tensor]


class _Replay:
    """One step captured as a CUDA graph and replayed (the step's shapes
    never change); eager where the device is not a card."""

    def __init__(self, law: PDELaw, st: State):
        self.law, self.st, self.graph = law, st, None
        if st.F.device.type != "cuda":
            return
        saved = st.copy()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(2):
                law.step(st)
        torch.cuda.current_stream().wait_stream(side)
        st.load(saved)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            law.step(st)
        st.load(saved)

    def __call__(self):
        if self.graph is None:
            self.law.step(self.st)
        else:
            self.graph.replay()


def run(law: PDELaw, p, q, pos, spin, hist, gen: torch.Generator,
        seeds: Optional[torch.Tensor], draws: str,
        keep_snapshots: bool, chunk: int = 500) -> PDERun:
    """The whole solve from the initial state; ``seeds`` and ``draws``
    ('philox' or 'generator') as in the module's docstring.  ``gen`` is
    the run's generator where the program left it before its first step."""
    dev = p.device
    B, n_t = pos.shape
    law.prepare()
    K = 1 if draws == "generator" else max(1, min(chunk, law.interval))
    st = State(F=torch.stack([p, q]).to(F32).contiguous(),
               pos=pos.to(F32).clone(), spin=spin.to(F32).clone(),
               hist=hist.to(F32).permute(1, 0, 2).contiguous(),
               n=torch.zeros((), dtype=torch.int64, device=dev),
               lo=torch.zeros((), dtype=torch.int64, device=dev),
               U0=torch.zeros((K, B, n_t), dtype=F32, device=dev),
               Z=torch.zeros((K, B, n_t), dtype=F32, device=dev),
               recs=torch.zeros((law.nsteps + 1, B, 4 + 2 * law.kmax),
                                dtype=F32, device=dev))
    replay = _Replay(law, st) if draws == "philox" else None
    snaps, msnaps = [], []
    n = 0
    while n < law.nsteps:
        if keep_snapshots and n % law.interval == 0:
            snaps.append(law.r(st.F[0] + st.F[1]))
            msnaps.append(law.r(st.F[0] - st.F[1]))
        if draws == "generator":
            st.U0[0] = torch.rand((B, n_t), generator=gen, device=dev)
            st.Z[0] = torch.randn((B, n_t), generator=gen, device=dev)
            st.lo.fill_(n)
            law.step(st)
            n += 1
            continue
        hi = min(law.nsteps, (n // law.interval + 1) * law.interval, n + K)
        u0, z = tracer_draws(seeds, n_t, n, hi)
        st.U0[:hi - n].copy_(u0)
        st.Z[:hi - n].copy_(z)
        st.lo.fill_(n)
        for _ in range(n, hi):
            replay()
        n = hi
    if keep_snapshots and n % law.interval == 0:
        snaps.append(law.r(st.F[0] + st.F[1]))
        msnaps.append(law.r(st.F[0] - st.F[1]))
    # the final iteration: its draws from the generator, no field step
    st.U0[0] = torch.rand((B, n_t), generator=gen, device=dev)
    st.Z[0] = torch.randn((B, n_t), generator=gen, device=dev)
    st.lo.fill_(n)
    law.step(st, fields=False)
    rec = st.recs.permute(1, 0, 2)
    kmax = law.kmax
    return PDERun(st.F[0], st.F[1], rec[..., 0], rec[..., 1], rec[..., 2],
                  rec[..., 3], rec[..., 4:4 + kmax], rec[..., 4 + kmax:],
                  torch.stack(snaps, 1) if keep_snapshots else None,
                  torch.stack(msnaps, 1) if keep_snapshots else None)


def homogeneous_inputs(seed: int, B: int, L: int, n_t: int, window: int,
                       device, rho0: float = 1.0, noise: float = 0.3):
    """The β sweep's initial state: ρ± = max(ρ0 + noise·N(0,1), 0) over
    the total mass, tracers on uniform sites with uniform spins, then B2's
    Philox seeds, all from one generator seeded with ``seed`` in the
    sweep's order.  Returns (ρ₊, ρ₋, x, s, ring, seeds, generator)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    base = torch.full((L,), rho0, dtype=F32, device=device)
    p = torch.clamp(base + noise * torch.randn((B, L), generator=gen,
                                               device=device), min=0.0)
    q = torch.clamp(base + noise * torch.randn((B, L), generator=gen,
                                               device=device), min=0.0)
    tot = (p + q).sum(-1, keepdim=True)
    p, q = p / tot, q / tot
    pos = torch.randint(0, L, (B, n_t), generator=gen, device=device).to(
        F32) * (1.0 / L)
    spin = torch.randint(0, 2, (B, n_t), generator=gen, device=device,
                         dtype=torch.int32) * 2 - 1
    hist = torch.zeros((B, window, n_t), dtype=F32, device=device)
    seeds = torch.randint(0, 2 ** 31 - 1, (B,), generator=gen,
                          device=device, dtype=torch.int32)
    return p, q, pos, spin.to(F32), hist, seeds, gen


def window_means(t_grid, v_eff, D_eff, n_beta: int, n_runs: int,
                 t_min: float, t_max: float):
    """The β sweep's estimators: per run |nanmean v_eff| and nanmean D_eff
    over t_min ≤ t ≤ t_max; per β their mean and standard error."""
    mask = (t_grid >= t_min) & (t_grid <= t_max)
    out = {k: [] for k in ("v_mean", "v_err", "D_mean", "D_err")}
    for bi in range(n_beta):
        rows = slice(bi * n_runs, (bi + 1) * n_runs)
        v = np.abs(np.nanmean(v_eff[rows][:, mask], axis=1))
        D = np.nanmean(D_eff[rows][:, mask], axis=1)
        se = (lambda a: a.std(ddof=1) / np.sqrt(n_runs)) if n_runs > 1 \
            else (lambda a: 0.0)
        out["v_mean"].append(v.mean())
        out["v_err"].append(se(v))
        out["D_mean"].append(D.mean())
        out["D_err"].append(se(D))
    return {k: np.asarray(v) for k, v in out.items()}


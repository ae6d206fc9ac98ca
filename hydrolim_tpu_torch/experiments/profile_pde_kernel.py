"""Kernel B2's time per step at the main path's PDE shape, on the card.

Default (``--mode main``): the shape of ``chip_smoke.py`` phase 6's B2 row,
33 replicas (β over [0, 3] × 3), L=1000, 1000 tracers, window 100,
dt=5e-4, γ=0.2, global m, periodic, bidirectional, the exact solve, 8
spectral bins, 2000-step calls, native Philox.  ``--mode smooth``: the
phase diagram's full-circulant rows, 64 replicas (β over [0, 3]), 64
tracers, σ=0.05 (the smoothing circulant), the rest as above.  ``--mode
spectra``: the ``IMEXPDE`` single run's step, one replica (β=2), 1000
tracers, σ=0.005 (narrow taps), no solve (γ=0), the full 501 rfft bins,
50-step calls (a frame).  ``--mode spectra-kernel``: the spectra kernel
alone on that run's (1, 50, 1000) density rows, 501 bins: its device
time a call (the kernels' time under ``torch.profiler``, 20 calls) and
the events' time a call, beside ``torch.fft.rfft`` of the same rows;
``--mode spectra-large`` the same at the route rows' calls past a million
sites (``SPECTRA_LARGE``: B = 2, 8 bins, 200 steps at L = 1,048,576 and
50 at 4,194,304).  ``--mode rows``: the per-mode rows of PERF.md
§6 (``ROWS``: global, pointwise, narrow and smooth m at B=5 with 1000
tracers and B=64 with 64, L=1000, the exact solve; the L=8192 banded row;
the single run's step), one JSON row each.  ``--mode cluster``: the same
rows and the large lattices (``LARGE``: L=8192 and 16,384 at B=4, 65,536
at B=2, the large-lattice driver's recipe, pointwise m, the banded solve,
64 tracers, 8 bins) under every cluster size the plan allows
(``pde_launch_plan(cluster=C)``), one row per shape with the µs per step
at each C and the plan's C.  ``--mode drift``: the kernel against its
plain version over 1500 steps of that recipe from the large-lattice
driver's initial fields, at each ``--lattice`` L (default 1024 and
8192): the density's difference and each route's mass every 375 steps;
with ``--reference FILE`` (``tests/pde_drift_reference.py --out FILE``,
the JAX XLA path's snapshots on the CPU) also each route's distance from
the JAX package's fields.  ``--mode route``: kernel B2's two routes
(``ROUTE_ROWS``: L = 65,536 and 131,072, where both serve, each forced;
L = 262,144, 1,048,576 and 4,194,304, the device-memory route the card's
plan takes), B = 2, the large-lattice recipe, with the plain ``pde_step``
loop on the same fields beside them: µs per step, the route, its CTAs a
replica and launches.  ``--mode route-smooth``: the same for the full
Gaussian m (σ = 0.05, the banded solve; ``SMOOTH_ROUTE_ROWS``: L = 65,536
on both routes, the cluster's direct circulant against the device-memory
route's FFT stage; 131,072, 262,144, 1,048,576 and 4,194,304 on the
card's plan, its FFT stage), each row also with the stage's library
yardstick: ``torch.fft.rfft`` of the replicas' (num, den) rows times the
taps' spectrum and ``irfft``, in float32 and in float64 (the port never
calls it).  ``--batch`` sets the replicas of 'main' and
'smooth' (β over [0, 3]; e.g. 5 and 64, the PDE slice's σ-sweep and
phase-diagram batches).  Several modes and batches run in one process,
one row each.  Every mode but 'cluster' calls only what the kernel's
wrapper has taken since the PDE slice was ported, so the same script
times an older checkout of the package: put that checkout first on
``PYTHONPATH`` and run this file by its path.  Prints one JSON row per
shape (CUDA events, after a warm-up call), with the step kernel's
launches a call where the checkout counts them.

Usage: PYTHONPATH=<checkout> python <this file> [--calls 5] [--tag NAME]
       [--mode main|smooth|spectra|spectra-kernel|rows|cluster|drift|route
       |route-smooth|spectra-large ...] [--batch B ...] [--lattice L ...]
       [--reference FILE]
"""
from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

from hydrolim_tpu_torch.core.config import PDEConfig
from hydrolim_tpu_torch.ops.pde_kernel import (
    build_solve_operands,
    pde_multi_step,
)
from hydrolim_tpu_torch.pde.init import pde_initialize


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def _device_and_events_us(fn, reps: int) -> tuple:
    """(device µs a call: the card's kernels under ``torch.profiler``, None
    where it records none; µs a call by CUDA events), ``reps`` calls each
    after a warm-up call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    dev_us = sum(e.device_time_total for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA) / reps
    return dev_us or None, start.elapsed_time(end) * 1e3 / reps


# --mode spectra-large: the spectra kernel at phase 22's route rows' calls
# (B = 2, 8 bins): 200 steps at L = 1,048,576, 50 at 4,194,304
SPECTRA_LARGE = [(2, 200, 1_048_576, 8), (2, 50, 4_194_304, 8)]


def spectra_kernel(tag: str = "", shapes=((1, 50, 1000, 501),)) -> list:
    """The spectra kernel alone, by default at the single run's shape: its
    device time a call and its events' time a call (20 calls); and
    ``torch.fft.rfft`` of the same (B, k, L) density rows, the library
    call computing its function (the port never calls it)."""
    from hydrolim_tpu_torch.ops.pde_kernel import pde_spectra

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    out = []
    for B, k, L, kmax in shapes:
        reps = 20 if L <= 65_536 else 5
        dens = 0.5 + torch.rand((B, k, L), generator=gen, device=dev)
        recs = torch.zeros((B, k, 4 + 2 * kmax), device=dev)
        dev_us, ev_us = _device_and_events_us(
            lambda: pde_spectra(dens, recs, kmax), reps)
        lib_dev, lib_ev = _device_and_events_us(
            lambda: torch.fft.rfft(dens, dim=-1), reps)
        row = dict(tag=tag, shape=dict(B=B, k_steps=k, L=L, kmax_rec=kmax,
                                       m_mode="spectra kernel"),
                   device_us_per_call=dev_us, events_us_per_call=ev_us,
                   rfft_device_us_per_call=lib_dev,
                   rfft_events_us_per_call=lib_ev, card=_card())
        print(json.dumps(row), flush=True)
        out.append(row)
    return out


# PERF.md §6's per-mode rows: (label, PDEConfig fields beyond L=1000,
# dt=5e-4, shape, steps per call, γ).  The large-lattice recipe
# (dt = 0.5·dx/λ, γ = 2.5·dx²/dt) at L=8192, 16,384 and 65,536.
def _recipe(L: int) -> dict:
    dt = 0.5 / L / 0.6
    return dict(L=L, dt=dt, gamma=2.5 / L / L / dt)


ROWS = [(f"{m}, exact, B={B}, n_t={n_t}", over, dict(B=B, n_t=n_t), 2000)
        for B, n_t in ((5, 1000), (64, 64))
        for m, over in (("global", dict(gaussian_kernel=True,
                                        kernel_sigma=2e5)),
                        ("pointwise", {}),
                        ("narrow sigma=0.005", dict(gaussian_kernel=True,
                                                    kernel_sigma=0.005)),
                        ("smooth sigma=0.05", dict(gaussian_kernel=True,
                                                   kernel_sigma=0.05)))] + [
    ("pointwise, banded, L=8192, B=4, n_t=64",
     dict(diffusion_solver="banded"),
     dict(L=8192, B=4, n_t=64, W=20, dt=2e-7), 2000),
    ("the single run: narrow sigma=0.005, none, kmax 501, B=1",
     dict(gaussian_kernel=True, kernel_sigma=0.005),
     dict(B=1, gamma=0.0, kmax=501), 50)]
LARGE = [(f"pointwise, banded, L={L}, B={B}, n_t=64, the recipe",
          dict(diffusion_solver="banded"),
          dict(B=B, n_t=64, W=20, **_recipe(L)), k)
         for L, B, k in ((8192, 4, 2000), (16_384, 4, 1000),
                         (65_536, 2, 500))]


def b2_inputs(dev, over: dict, shape: dict, gen=None):
    """(config, γ, operands, scal, state) of a B2 shape: PDEConfig fields
    ``over`` beyond L=1000, dt=5e-4, γ=0.2, 1000 tracers, window 100, 8
    bins, B=4 (``shape`` overrides those), β over [0.5, 3], homogeneous
    fields with 30% noise drawn from ``gen`` (seed 0 where None)."""
    from hydrolim_tpu_torch.pde.fast_solve import kernel_operands

    sh = dict(L=1000, B=4, n_t=1000, W=100, dt=5e-4, gamma=0.2, kmax=8)
    sh.update(shape)
    config = PDEConfig(L=sh["L"], dt=sh["dt"], n_tracers=sh["n_t"],
                       tracer_window_time=sh["W"] * sh["dt"] * (1 + 1e-9),
                       fft_kmax=sh["kmax"], **over)
    assert config.tracer_window == sh["W"]
    ops = kernel_operands(config, sh["gamma"], dev)
    if gen is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
    rp, rm, tr = pde_initialize(config, gen, B=sh["B"], mode="homogeneous",
                                noise=0.3, n_tracers=sh["n_t"], device=dev)
    scal = torch.tensor([[b, 0.6, sh["gamma"], 0.0]
                         for b in np.linspace(0.5, 3.0, sh["B"])],
                        dtype=torch.float32, device=dev)
    return config, sh["gamma"], ops, scal, [rp, rm, tr.unwrapped,
                                            tr.spin.float(), tr.hist]


def _time(fn, k: int, calls: int) -> list:
    fn()                                            # build + warm-up
    ms = []
    for _ in range(calls):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
    return [m * 1e3 / k for m in ms]


def rows(calls: int, tag: str, cluster: bool) -> list:
    """The rows (``ROWS``; with ``cluster``, also ``LARGE``, at every C
    the plan allows): µs per step, one JSON row each."""
    dev = torch.device("cuda", 0)
    out = []
    for label, over, shape, k in ROWS + (LARGE if cluster else []):
        config, _, ops, scal, state = b2_inputs(dev, over, shape)
        B = scal.shape[0]
        seeds = torch.arange(B, dtype=torch.int32, device=dev)
        kw = dict(L=config.L, n_t=config.n_tracers,
                  window=config.tracer_window, k_steps=k, dt=config.dt,
                  xlim=config.xlim, periodic=config.bc == "periodic",
                  m_mode=ops[0], solve_mode=ops[1],
                  bidirectional=config.active_model == "bidirectional",
                  kmax_rec=config.kmax)
        args = (scal, seeds, 0, *state, ops[3], ops[2])
        row = dict(tag=tag, label=label, B=B, L=config.L, k_steps=k,
                   m_mode=ops[0], solve_mode=ops[1], card=_card())
        if not cluster:
            row["us_per_step"] = _time(lambda: pde_multi_step(*args, **kw),
                                       k, calls)
        else:
            from hydrolim_tpu_torch.ops import pde_kernel as pk

            circ = pk.call_circulants(config.L, ops[0], ops[1], ops[2],
                                      ops[3])
            co = pk.card_coresident(0, config.L, config.n_tracers, ops[0],
                                    circ)
            row["plan_cluster"] = pk.card_plan(
                0, B, config.L, config.n_tracers, ops[0],
                tuple(sorted(circ.items()))).cluster
            row["coresident"] = co
            row["us_per_step_at_C"] = {}
            for C in pk.CLUSTER_SIZES:
                if not co.get(C):
                    continue
                plan = pk.pde_launch_plan(B, config.L, config.n_tracers,
                                          ops[0], circ, co, cluster=C)
                row["us_per_step_at_C"][C] = _time(
                    lambda: pk.pde_multi_step_planned(plan, *args, **kw),
                    k, calls)
        print(json.dumps(row), flush=True)
        out.append(row)
    return out


def drift(tag: str, lattices, reference: str = "") -> list:
    """Kernel B2 against its plain version over the large-lattice recipe
    (dt = 0.5·dx/λ, γ = 2.5·dx²/dt, pointwise m, the banded solve, 64
    tracers, 8 bins) from the large-lattice driver's initial fields (β =
    0.5, 2.5): at every 375 steps up to 1500, the total density's largest
    difference relative to the plain version's largest value, and each
    route's mass relative to step 0's; with ``reference``, each route's
    largest distance from the JAX XLA path's total density (relative to
    its largest value).  One JSON row a lattice and step."""
    from hydrolim_tpu_torch.experiments.large_lattice import pde_rho0
    from hydrolim_tpu_torch.ops.pde_kernel import pde_multi_step_plain
    from hydrolim_tpu_torch.pde.fast_solve import kernel_operands

    dev = torch.device("cuda", 0)
    ref = np.load(reference) if reference else None
    out = []
    for L in lattices:
        dt = 0.5 / L / 0.6
        gamma = 2.5 / L / L / dt
        config = PDEConfig(L=L, dt=dt, n_tracers=64, fft_kmax=8,
                           diffusion_solver="banded",
                           tracer_window_time=20 * dt * (1 + 1e-9))
        ops = kernel_operands(config, gamma, dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        _, _, tr = pde_initialize(config, gen, B=2, mode="homogeneous",
                                  noise=0.3, n_tracers=64, device=dev)
        rho0 = [pde_rho0(L, 0, bi) for bi in range(2)]
        field = lambda c, i: torch.tensor(np.stack([c * r[i] for r in rho0]),
                                          dtype=torch.float32, device=dev)
        scal = torch.tensor([[0.5, 0.6, gamma, 0.0], [2.5, 0.6, gamma, 0.0]],
                            dtype=torch.float32, device=dev)
        seeds = torch.arange(2, dtype=torch.int32, device=dev)
        kw = dict(L=L, n_t=64, window=config.tracer_window, k_steps=375,
                  dt=dt, xlim=config.xlim, periodic=True, m_mode=ops[0],
                  solve_mode=ops[1], bidirectional=True, kmax_rec=8)
        sk = [field(1.2, 0), field(0.8, 1), tr.unwrapped, tr.spin.float(),
              tr.hist]
        sp = list(sk)
        mass0 = (sk[0] + sk[1]).double().sum(-1)
        for c in range(4):
            *sk, _ = pde_multi_step(scal, seeds, 375 * c, *sk, ops[3],
                                    ops[2], **kw)
            *sp, _ = pde_multi_step_plain(scal, seeds, 375 * c, *sp, ops[3],
                                          ops[2], generator=gen, **kw)
            a, b = (sk[0] + sk[1]).double(), (sp[0] + sp[1]).double()
            row = dict(tag=tag, L=L, modes=list(ops[:2]), step=375 * (c + 1),
                       diff=((a - b).abs().amax(-1)
                             / b.abs().amax(-1)).tolist(),
                       mass_kernel=(a.sum(-1) / mass0 - 1).tolist(),
                       mass_plain=(b.sum(-1) / mass0 - 1).tolist(),
                       card=_card())
            if ref is not None:
                jax_at = np.stack([ref[f"rho_{L}_{beta}"][c]
                                   for beta in (0.5, 2.5)])
                j = torch.tensor(jax_at, dtype=torch.float64, device=dev)
                scale = j.abs().amax(-1)
                row["from_jax_kernel"] = ((a - j).abs().amax(-1)
                                          / scale).tolist()
                row["from_jax_plain"] = ((b - j).abs().amax(-1)
                                         / scale).tolist()
            print(json.dumps(row), flush=True)
            out.append(row)
    return out


# --mode route: (L, PDEConfig fields, steps a call, forced routes): where
# both routes serve, each forced; past a cluster, the card's plan
ROUTE_ROWS = [
    (65_536, dict(diffusion_solver="banded"), 400, ("cluster", "gmem")),
    (131_072, dict(gaussian_kernel=True, kernel_sigma=2e5,
                   diffusion_solver="banded"), 400, ("cluster", "gmem")),
    (262_144, dict(diffusion_solver="banded"), 400, (None,)),
    (1_048_576, dict(diffusion_solver="banded"), 200, (None,)),
    (4_194_304, dict(diffusion_solver="banded"), 50, (None,)),
]


# --mode route-smooth: the full Gaussian m (σ = 0.05, 13,107 sites at
# L = 262,144) on the same recipe; at 65,536 the cluster's direct circulant
# (2·L² FMAs a field a step) takes a few ms a step, so its calls are short
SMOOTH = dict(gaussian_kernel=True, kernel_sigma=0.05,
              diffusion_solver="banded")
SMOOTH_ROUTE_ROWS = [
    (65_536, SMOOTH, 20, ("cluster", "gmem")),
    (131_072, SMOOTH, 400, (None,)),
    (262_144, SMOOTH, 400, (None,)),
    (1_048_576, SMOOTH, 200, (None,)),
    (4_194_304, SMOOTH, 50, (None,)),
]


def smooth_stage_library(rho_p, rho_m, smooth, calls: int) -> dict:
    """µs of one ``torch.fft.rfft`` of the (B, 2, L) (num, den) rows, times
    the taps' spectrum, and ``irfft``: the FFT stage's function by
    library calls, in float32 and in float64."""
    both = torch.stack([rho_p - rho_m, rho_p + rho_m], 1)
    out = {}
    for dtype in (torch.float32, torch.float64):
        x = both.to(dtype)
        kr = torch.fft.rfft(smooth.weights.to(dtype))
        fn = lambda: torch.fft.irfft(torch.fft.rfft(x) * kr, n=x.shape[-1])
        out[str(dtype).split(".")[-1]] = _time(fn, 1, calls)
    return out


def route_rows(calls: int, tag: str, plain_steps: int = 20,
               table=None) -> list:
    """``ROUTE_ROWS`` (or ``table``): µs per step of kernel B2 on each
    route (B = 2, the large-lattice recipe, 64 tracers, 8 bins, native
    Philox) and of the plain ``pde_step`` loop (the large-lattice driver's
    step, torch on the card) on the same fields; one JSON row per L.  Each
    route is also timed without the spectral bins (the step kernel alone,
    in one launch a call); a row of the full smoothing also gives its FFT
    stage's plan and the stage's library yardstick
    (``smooth_stage_library``)."""
    from hydrolim_tpu_torch.core.config import PDEParams
    from hydrolim_tpu_torch.ops import pde_kernel as pk
    from hydrolim_tpu_torch.pde.stepper import build_pde_ops, pde_step

    dev = torch.device("cuda", 0)
    out = []
    for L, over, k, routes in table or ROUTE_ROWS:
        config, gamma, ops, scal, state = b2_inputs(
            dev, over, dict(B=2, n_t=64, W=20, **_recipe(L)))
        seeds = torch.arange(2, dtype=torch.int32, device=dev)
        kw = dict(L=L, n_t=64, window=config.tracer_window, k_steps=k,
                  dt=config.dt, xlim=config.xlim, periodic=True,
                  m_mode=ops[0], solve_mode=ops[1], bidirectional=True,
                  kmax_rec=8)
        row = dict(tag=tag, L=L, B=2, k_steps=k, m_mode=ops[0],
                   solve_mode=ops[1], card=_card(), routes={})
        for route in routes:
            n0 = pk.pde_multi_step.launches
            fn = lambda: pk.pde_multi_step(scal, seeds, 0, *state, ops[3],
                                           ops[2], route=route, **kw)
            us = _time(fn, k, calls)
            plan = pk.pde_multi_step.last_plan
            launches = (pk.pde_multi_step.launches - n0) // (calls + 1)
            bare = _time(lambda: pk.pde_multi_step(
                scal, seeds, 0, *state, ops[3], ops[2], route=route,
                **dict(kw, kmax_rec=0)), k, calls)
            row["routes"][plan.route] = dict(
                us_per_step=us, us_per_step_without_bins=bare,
                ctas=plan.ctas, waves=plan.waves,
                launches_per_call=launches)
            if getattr(plan, "fft", None) is not None:
                f = plan.fft
                row["routes"][plan.route]["fft"] = dict(
                    n=f.n, n1=f.n1, n2=f.n2, wrap=f.wrap, w1=f.w1, w2=f.w2)
        if ops[0] == "smooth":
            row["library_stage_us"] = smooth_stage_library(
                state[0], state[1], ops[2], calls)
        params = PDEParams(beta=scal[:, 0], lam=scal[:, 1], gamma=scal[:, 2])
        pops = build_pde_ops(config, gamma, dev)
        rp, rm = state[0].clone(), state[1].clone()

        def plain():
            nonlocal rp, rm
            for _ in range(plain_steps):
                rp, rm = pde_step(config, params, pops, rp, rm)
        row["plain_pde_step_us_per_step"] = _time(plain, plain_steps, calls)
        print(json.dumps(row), flush=True)
        out.append(row)
    return out


def main(calls: int = 5, tag: str = "", mode: str = "main",
         batch=None, lattices=(1024, 8192), reference: str = "") -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("profile_pde_kernel: needs a CUDA device")
    if mode == "spectra-kernel":
        return spectra_kernel(tag)
    if mode == "spectra-large":
        return spectra_kernel(tag, SPECTRA_LARGE)
    if mode in ("rows", "cluster"):
        return rows(calls, tag, mode == "cluster")
    if mode == "drift":
        return drift(tag, lattices, reference)
    if mode == "route":
        return route_rows(calls, tag)
    if mode == "route-smooth":
        return route_rows(calls, tag, table=SMOOTH_ROUTE_ROWS)
    dev = torch.device("cuda", 0)
    L, k, dt, gamma, kmax = 1000, 2000, 5e-4, 0.2, 8
    if mode == "spectra":
        from hydrolim_tpu_torch.pde.fast_solve import kernel_operands

        B, n_t, betas, k, gamma, kmax = 1, 1000, [2.0], 50, 0.0, 501
        config = PDEConfig(L=L, dt=dt, n_tracers=n_t, gaussian_kernel=True,
                           kernel_sigma=0.005, fft_kmax=kmax)
        m_mode, solve_mode, smooth, solve = kernel_operands(config, gamma,
                                                            dev)
        assert (m_mode, solve_mode) == ("narrow", "none")
    elif mode == "main":
        B, n_t, betas = 33, 1000, np.repeat(np.linspace(0, 3, 11), 3)
        if batch:
            B, betas = batch, np.linspace(0, 3, batch)
        config = PDEConfig(L=L, dt=dt, n_tracers=n_t)
        solve = build_solve_operands(L, config.dx, dt, gamma, True, "exact",
                                     dev)
        smooth, m_mode, solve_mode = None, "global", "exact"
    else:
        from hydrolim_tpu_torch.pde.fast_solve import kernel_operands

        B = batch or 64
        n_t, betas = 64, np.linspace(0, 3, B)
        config = PDEConfig(L=L, dt=dt, n_tracers=n_t, gaussian_kernel=True,
                           kernel_sigma=0.05)
        m_mode, solve_mode, smooth, solve = kernel_operands(config, gamma,
                                                            dev)
        assert (m_mode, solve_mode) == ("smooth", "exact")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rp, rm, tr = pde_initialize(config, gen, B=B, mode="homogeneous",
                                noise=0.3, n_tracers=n_t, device=dev)
    scal = torch.tensor([[b, 0.6, gamma, 0.0] for b in betas],
                        dtype=torch.float32, device=dev)
    seeds = torch.arange(B, dtype=torch.int32, device=dev)
    args = (scal, seeds, 0, rp, rm, tr.unwrapped, tr.spin.float(), tr.hist,
            solve) + ((smooth,) if smooth is not None else ())
    kw = dict(L=L, n_t=n_t, window=config.tracer_window, k_steps=k, dt=dt,
              xlim=config.xlim, periodic=True, m_mode=m_mode,
              solve_mode=solve_mode, bidirectional=True, kmax_rec=kmax)
    n0 = pde_multi_step.launches
    pde_multi_step(*args, **kw)                     # build + warm-up
    launches = pde_multi_step.launches - n0
    ms = []
    for _ in range(calls):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        pde_multi_step(*args, **kw)
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
    card = _card()
    row = dict(tag=tag, shape=dict(B=B, L=L, n_t=n_t, k_steps=k,
                                   m_mode=m_mode, solve_mode=solve_mode,
                                   kmax_rec=kmax),
               launches_per_call=launches,
               ms_per_call=ms, us_per_step=float(np.mean(ms)) * 1e3 / k,
               card=card)
    print(json.dumps(row), flush=True)
    return row


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--calls", type=int, default=5)
    p.add_argument("--tag", default="")
    p.add_argument("--mode", default=["main"], nargs="+",
                   choices=["main", "smooth", "spectra", "spectra-kernel",
                            "rows", "cluster", "drift", "route",
                            "route-smooth", "spectra-large"])
    p.add_argument("--batch", type=int, default=[0], nargs="+")
    p.add_argument("--lattice", type=int, default=[1024, 8192], nargs="+")
    p.add_argument("--reference", default="")
    a = p.parse_args()
    for mode in a.mode:
        for batch in (a.batch if mode in ("main", "smooth") else [0]):
            main(a.calls, a.tag, mode, batch or None, a.lattice, a.reference)

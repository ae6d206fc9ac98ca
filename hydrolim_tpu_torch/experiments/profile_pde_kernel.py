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
the events' time a call.  ``--batch`` sets the replicas of 'main' and
'smooth' (β over [0, 3]; e.g. 5 and 64, the PDE slice's σ-sweep and
phase-diagram batches).  Several modes and batches run in one process,
one row each.  It calls only what the kernel's wrapper has taken since
the PDE slice was ported, so the same script times an older checkout of
the package: put that checkout first on ``PYTHONPATH`` and run this file
by its path.  Prints one JSON row per shape (CUDA events, after a warm-up
call), with the step kernel's launches a call where the checkout counts
them.

Usage: PYTHONPATH=<checkout> python <this file> [--calls 5] [--tag NAME]
       [--mode main|smooth|spectra|spectra-kernel ...] [--batch B ...]
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


def spectra_kernel(tag: str = "") -> dict:
    """The spectra kernel alone at the single run's shape."""
    from torch.profiler import ProfilerActivity, profile

    from hydrolim_tpu_torch.ops.pde_kernel import pde_spectra

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    B, k, L, kmax, reps = 1, 50, 1000, 501, 20
    dens = 0.5 + torch.rand((B, k, L), generator=gen, device=dev)
    recs = torch.zeros((B, k, 4 + 2 * kmax), device=dev)
    pde_spectra(dens, recs, kmax)                   # build + warm-up
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        pde_spectra(dens, recs, kmax)
    end.record()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            pde_spectra(dens, recs, kmax)
        torch.cuda.synchronize()
    dev_us = sum(e.device_time_total for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA) / reps
    row = dict(tag=tag, shape=dict(B=B, k_steps=k, L=L, kmax_rec=kmax,
                                   m_mode="spectra kernel"),
               device_us_per_call=dev_us or None,
               events_us_per_call=start.elapsed_time(end) * 1e3 / reps,
               card=_card())
    print(json.dumps(row), flush=True)
    return row


def main(calls: int = 5, tag: str = "", mode: str = "main",
         batch=None) -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("profile_pde_kernel: needs a CUDA device")
    if mode == "spectra-kernel":
        return spectra_kernel(tag)
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
                   choices=["main", "smooth", "spectra", "spectra-kernel"])
    p.add_argument("--batch", type=int, default=[0], nargs="+")
    a = p.parse_args()
    for mode in a.mode:
        for batch in (a.batch if mode in ("main", "smooth") else [0]):
            main(a.calls, a.tag, mode, batch or None)

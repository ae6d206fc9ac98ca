"""Kernel B2's time per step at the main path's PDE shape, on the card.

Default (``--mode main``): the shape of ``chip_smoke.py`` phase 6's B2 row,
33 replicas (β over [0, 3] × 3), L=1000, 1000 tracers, window 100,
dt=5e-4, γ=0.2, global m, periodic, bidirectional, the exact solve, 8
spectral bins, 2000-step calls, native Philox.  ``--mode smooth``: the
phase diagram's full-circulant rows, 64 replicas (β over [0, 3]), 64
tracers, σ=0.05 (the smoothing circulant), the rest as above.  It calls
only what the kernel's wrapper has taken since the PDE slice was ported,
so the same script times an older checkout of the package: put that
checkout first on ``PYTHONPATH`` and run this file by its path.  Prints one
JSON row (CUDA events, after a warm-up call).

Usage: PYTHONPATH=<checkout> python <this file> [--calls 5] [--tag NAME]
       [--mode main|smooth]
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


def main(calls: int = 5, tag: str = "", mode: str = "main") -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("profile_pde_kernel: needs a CUDA device")
    dev = torch.device("cuda", 0)
    L, k, dt, gamma = 1000, 2000, 5e-4, 0.2
    if mode == "main":
        B, n_t, betas = 33, 1000, np.repeat(np.linspace(0, 3, 11), 3)
        config = PDEConfig(L=L, dt=dt, n_tracers=n_t)
        solve = build_solve_operands(L, config.dx, dt, gamma, True, "exact",
                                     dev)
        smooth, m_mode = None, "global"
    else:
        from hydrolim_tpu_torch.pde.fast_solve import kernel_operands

        B, n_t, betas = 64, 64, np.linspace(0, 3, 64)
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
              solve_mode="exact", bidirectional=True, kmax_rec=8)
    pde_multi_step(*args, **kw)                     # build + warm-up
    ms = []
    for _ in range(calls):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        pde_multi_step(*args, **kw)
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    row = dict(tag=tag, shape=dict(B=B, L=L, n_t=n_t, k_steps=k,
                                   m_mode=m_mode, solve_mode="exact"),
               ms_per_call=ms, us_per_step=float(np.mean(ms)) * 1e3 / k,
               card=card)
    print(json.dumps(row), flush=True)
    return row


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--calls", type=int, default=5)
    p.add_argument("--tag", default="")
    p.add_argument("--mode", default="main", choices=["main", "smooth"])
    a = p.parse_args()
    main(a.calls, a.tag, a.mode)

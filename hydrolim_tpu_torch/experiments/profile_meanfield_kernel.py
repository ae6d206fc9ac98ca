"""Kernel B1's time per step at the main path's and the headline's shapes.

- main: the cross-engine driver's particle side, 33 replicas (β over
  [0, 3] × 3), N=5000, L=256, rd = γL², ra = λL, dt from ``ensemble_dt`` at
  β_max = 3, bidirectional, 20,000-step calls;
- headline: ``bench.py``'s B=64 (β over [0, 3]), N=1e5, L=1000, dt=0.002,
  rd=0.5, ra=2, 1000-step calls.

Native Philox, CUDA events per call after a warm-up call, ``step0``
advanced by k per call.  Each row carries the card (``nvidia-smi``) and a
SHA-1 of the final pos/σ/wind, which depends only on the function, so two
checkouts that compute it alike print the same hash.  It calls only what
the kernel's wrapper has taken since it was first ported, so the same
script times an older checkout of the package: put that checkout first on
``PYTHONPATH`` and run this file by its path.  ``--clusters 1,2,4`` times
each forced cluster size instead, ``--modes registers,shared`` each forced
state mode, at the wrapper's cluster size or at each forced one (this
checkout only).

Usage: PYTHONPATH=<checkout> python <this file> [--calls 3] [--tag NAME]
       [--shapes main,headline] [--clusters 1,2,4] [--modes registers,shared]
"""
from __future__ import annotations

import argparse
import hashlib
import json
import subprocess

import numpy as np
import torch

from hydrolim_tpu_torch.core.config import ParticleConfig
from hydrolim_tpu_torch.experiments.cross_engine_validation import GAMMA, LAM
from hydrolim_tpu_torch.ops.stepper_kernel import meanfield_multi_step
from hydrolim_tpu_torch.sweeps.ensemble import ensemble_dt


def shape(name: str) -> dict:
    if name == "main":
        B, N, L = 33, 5000, 256
        rd, ra = GAMMA * L ** 2, LAM * L
        dt = ensemble_dt(
            ParticleConfig(L=L, N=N, n_pad=N, init="fixed", scale_rates=False,
                           local_kernel_sigma=0.0, periodic=True,
                           site_capacity=None, active_model="bidirectional"),
            beta_max=3.0, rate_diffusion=rd, rate_active=ra)
        return dict(B=B, N=N, L=L, rd=rd, ra=ra, dt=float(dt), k=20_000,
                    betas=np.repeat(np.linspace(0.0, 3.0, 11), 3))
    B = 64
    return dict(B=B, N=100_000, L=1000, rd=0.5, ra=2.0, dt=0.002, k=1000,
                betas=np.linspace(0.0, 3.0, B))


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def run(name: str, calls: int, tag: str, cluster=None, mode=None) -> dict:
    dev = torch.device("cuda", 0)
    sh = shape(name)
    B, N, L, k = sh["B"], sh["N"], sh["L"], sh["k"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    st = [torch.randint(0, L, (B, N), generator=gen, device=dev,
                        dtype=torch.int32),
          torch.randint(0, 2, (B, N), generator=gen, device=dev,
                        dtype=torch.int32) * 2 - 1,
          torch.zeros((B, N), dtype=torch.int32, device=dev)]
    seeds = torch.randint(0, 2 ** 30, (B,), generator=gen, device=dev,
                          dtype=torch.int32)
    scal = torch.tensor([[b, sh["rd"], sh["ra"]] for b in sh["betas"]],
                        dtype=torch.float32, device=dev)
    kw = dict(L=L, k_steps=k, dt=sh["dt"], bidirectional=True)
    step = meanfield_multi_step
    plan_info = None
    if cluster is not None or mode is not None:
        from hydrolim_tpu_torch.ops.stepper_kernel import (
            coresident_clusters,
            launch_plan,
            meanfield_multi_step_planned,
        )
        plan = launch_plan(B, N, L, k, coresident_clusters(0, N, L, mode),
                           cluster=cluster, mode=mode)
        plan_info = dict(cluster=plan.shape.cluster, mode=plan.shape.mode,
                         threads=plan.shape.threads, waves=plan.waves,
                         groups_per_thread=plan.shape.groups_per_thread)
        step = lambda *a, **kw_: meanfield_multi_step_planned(plan, *a,
                                                              **kw_)
    frame = [0]

    def call():
        st[:] = step(scal, seeds, *st, step0=frame[0] * k, **kw)
        frame[0] += 1

    call()                                            # build + warm-up
    ms = []
    for _ in range(calls):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        call()
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
    h = hashlib.sha1()
    for t in st:
        h.update(t.cpu().numpy().tobytes())
    row = dict(tag=tag, shape=name, B=B, N=N, L=L, k_steps=k, dt=sh["dt"],
               plan=plan_info, ms_per_call=ms,
               us_per_step=float(np.mean(ms)) * 1e3 / k,
               sha1=h.hexdigest(), card=card())
    print(json.dumps(row), flush=True)
    return row


def main(calls: int = 3, tag: str = "", shapes=("main", "headline"),
         clusters=None, modes=None) -> list:
    if not torch.cuda.is_available():
        raise SystemExit("profile_meanfield_kernel: needs a CUDA device")
    rows = []
    for name in shapes:
        for C in clusters or [None]:
            for mode in modes or [None]:
                rows.append(run(name, calls, tag, C, mode))
    return rows


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--calls", type=int, default=3)
    p.add_argument("--tag", default="")
    p.add_argument("--shapes", default="main,headline")
    p.add_argument("--clusters", default="",
                   help="comma-separated forced cluster sizes")
    p.add_argument("--modes", default="",
                   help="comma-separated forced state modes")
    a = p.parse_args()
    main(a.calls, a.tag, a.shapes.split(","),
         [int(c) for c in a.clusters.split(",")] if a.clusters else None,
         a.modes.split(",") if a.modes else None)

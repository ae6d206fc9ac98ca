"""Step time of kernel B3/B4 on the card, per shape and per cluster size.

µs per step of ``exclusion_multi_step`` (CUDA events per call after one
warm-up call, native Philox unless the row injects bits, ``step0``
advanced by k per call) at:
- bench: the JAX bench's B3 shape (``bench.py:295-320``): B=16, K=3,
  L=1000, N=750, σ=0.002 walls, plus_forward, β=0.7, rd=0, ra=5, dt=2e-3,
  10,000-step calls;
- flagship: the exclusion sweep (b)'s 33 replicas (β over [0, 3] × 3),
  K=3, L=1000, N=750, σ=0.002 walls, rd=0.02, ra=5, the sweep's Δt,
  10,000-step calls;
- the flagship shape with one knob changed: global m, injected bits, K=1
  (N=500, σ=0.005: the reference sweep's shape), B = 1, 132, 264, L = 250,
  4000 (N = 3L/4; 65 taps at L=4000) and 8192 (past one block's shared
  memory), in 1000-step calls.
Each row carries the card (``nvidia-smi``'s name and power limit) and a
SHA-1 of the slots after the warm-up call (k steps from the same initial
slots), which depends only on the function, so two checkouts that compute
it alike print the same hash.  Without ``--clusters`` it calls only what
the kernel's wrapper has taken since it was first ported, so the same
script times an older checkout of the package: put that checkout first on
``PYTHONPATH`` and run this file by its path (a shape the older wrapper
refuses prints its message).  ``--clusters 1,2,4`` times each forced
cluster size instead (this checkout only).  ``--quick`` is a short run of
the same shapes: one timed call of at most 200 steps each.

Usage: PYTHONPATH=<checkout> python <this file> [--calls 3] [--tag NAME]
       [--shapes bench,flagship,...] [--clusters 1,2,4] [--quick]
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import subprocess

import numpy as np
import torch

from hydrolim_tpu_torch.core.config import ParticleConfig
from hydrolim_tpu_torch.ops import exclusion_kernel
from hydrolim_tpu_torch.sweeps import fast_exclusion

DT = 3.98e-3          # the sweep's Δt at β_max = 3, rd = 0.02, ra = 5
FLAGSHIP = dict(B=33, K=3, L=1000, N=750, sigma=0.002, k=10_000)
SHAPES = {
    "bench": dict(FLAGSHIP, B=16, betas=(0.7,), rd=0.0, dt=2e-3),
    "flagship": FLAGSHIP,
    "global m": dict(FLAGSHIP, sigma=0.0, k=1000),
    "injected bits": dict(FLAGSHIP, inject=True, k=200),
    "K=1": dict(FLAGSHIP, K=1, N=500, sigma=0.005, k=1000),
    **{f"B={B}": dict(FLAGSHIP, B=B, k=1000) for B in (1, 132, 264)},
    **{f"L={L}": dict(FLAGSHIP, L=L, N=3 * L // 4, k=1000)
       for L in (250, 4000, 8192)},
}


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[0]


QUICK_STEPS = 200


def run(name: str, calls: int, tag: str, cluster=None,
        max_steps=None) -> dict:
    sh = {**dict(betas=np.linspace(0.0, 3.0, 11), rd=0.02, dt=DT,
                 inject=False), **SHAPES[name]}
    B, K, L = sh["B"], sh["K"], sh["L"]
    k = sh["k"] if max_steps is None else min(sh["k"], max_steps)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    cfg = ParticleConfig(L=L, N=sh["N"], init="fixed", scale_rates=False,
                         local_kernel_sigma=sh["sigma"], periodic=False,
                         site_capacity=K)
    band = (exclusion_kernel.build_smoothing_band(cfg, dev)
            if sh["sigma"] > 0 else None)
    slots = fast_exclusion.init_payload_slots(cfg, gen, B=B, device=dev)
    betas = np.resize(np.repeat(sh["betas"], 3), B)
    scal = torch.tensor([[b, sh["rd"], 5.0] for b in betas],
                        dtype=torch.float32, device=dev)
    seeds = torch.arange(B, dtype=torch.int32, device=dev)
    noise = (torch.randint(0, 2 ** 32, (B, k, 2, K, L), generator=gen,
                           device=dev, dtype=torch.int64).to(torch.int32)
             if sh["inject"] else None)
    row = dict(tag=tag, row=name, B=B, K=K, L=L, N=sh["N"],
               sigma=sh["sigma"], k_steps=k, injected=sh["inject"],
               card=card())
    kw = dict(k_steps=k, dt=sh["dt"], periodic=False, bidirectional=False,
              noise=noise)
    step = exclusion_kernel.exclusion_multi_step
    if cluster is not None:
        try:
            plan = exclusion_kernel.card_plan(B, K, L, band, False,
                                              cluster=cluster)
        except ValueError as e:
            print(json.dumps(dict(row, cluster=cluster, refused=str(e))),
                  flush=True)
            return row
        row["plan"] = dataclasses.asdict(plan)
        step = lambda *a, **kw_: exclusion_kernel.exclusion_multi_step_planned(
            plan, *a, **kw_)
    elif hasattr(exclusion_kernel, "card_plan"):     # the wrapper's own
        row["plan"] = dataclasses.asdict(exclusion_kernel.card_plan(
            B, K, L, band, False))
    state = [slots, 0]

    def call():
        state[0] = step(scal, seeds, state[0], band, step0=state[1] * k, **kw)
        state[1] += 1

    try:
        call()                                            # build + warm-up
    except ValueError as e:
        print(json.dumps(dict(row, refused=str(e))), flush=True)
        return row
    h = hashlib.sha1(state[0].cpu().numpy().tobytes()).hexdigest()
    ms = []
    for _ in range(calls):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        call()
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
    row.update(ms_per_call=ms, us_per_step=float(np.mean(ms)) * 1e3 / k,
               sha1=h)
    print(json.dumps(row), flush=True)
    return row


def main(calls: int = 3, tag: str = "", shapes=tuple(SHAPES),
         clusters=None, quick: bool = False) -> list:
    if not torch.cuda.is_available():
        raise SystemExit("profile_exclusion_kernel: needs a CUDA device")
    if quick:
        calls = 1
    return [run(name, calls, tag, C, QUICK_STEPS if quick else None)
            for name in shapes for C in clusters or [None]]


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--calls", type=int, default=3)
    p.add_argument("--tag", default="")
    p.add_argument("--shapes", default=",".join(SHAPES))
    p.add_argument("--clusters", default="",
                   help="comma-separated forced cluster sizes")
    p.add_argument("--quick", action="store_true",
                   help=f"one timed call of at most {QUICK_STEPS} steps "
                        "per shape")
    a = p.parse_args()
    main(a.calls, a.tag, a.shapes.split(","),
         [int(c) for c in a.clusters.split(",")] if a.clusters else None,
         quick=a.quick)

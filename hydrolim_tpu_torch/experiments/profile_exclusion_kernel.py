"""Step-time ablation of kernel B3/B4 on the card.

µs per step of ``exclusion_multi_step`` (CUDA events, one warm-up call,
mean of 3 calls) at the sweep's flagship shape (B=33, K=3, L=1000, N=750,
σ=0.002 non-periodic plus_forward, rd=0.02, ra=5, the sweep's Δt, native
Philox), and with one knob changed at a time: global m, injected bits, K=1
(N=500) at σ=0.005 (the reference sweep's shape), the replica count B and
the lattice size L.  Prints the card's name and power limit as nvidia-smi
gives them, then one JSON row per shape.  Where the exclusion sweep's wall
time goes is measured by ``chip_smoke.py`` (phase 8).

Usage: python -m hydrolim_tpu_torch.experiments.profile_exclusion_kernel
"""
from __future__ import annotations

import json
import subprocess

import numpy as np
import torch

from hydrolim_tpu_torch.core.config import ParticleConfig
from hydrolim_tpu_torch.ops import exclusion_kernel
from hydrolim_tpu_torch.sweeps import fast_exclusion

DT = 3.98e-3          # the sweep's Δt at β_max = 3, rd = 0.02, ra = 5


def _state(dev, gen, *, B, K, L, N, sigma):
    cfg = ParticleConfig(L=L, N=N, init="fixed", scale_rates=False,
                         local_kernel_sigma=sigma, periodic=False,
                         site_capacity=K)
    band = (exclusion_kernel.build_smoothing_band(cfg, dev) if sigma > 0
            else None)
    return fast_exclusion.init_payload_slots(cfg, gen, B=B, device=dev), band


def step_us(dev, *, B=33, K=3, L=1000, N=750, sigma=0.002, inject=False,
            k=1000) -> float:
    """µs per step, mean of 3 k-step calls after one warm-up call."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    slots, band = _state(dev, gen, B=B, K=K, L=L, N=N, sigma=sigma)
    betas = np.resize(np.repeat(np.linspace(0.0, 3.0, 11), 3), B)
    scal = torch.tensor([[b, 0.02, 5.0] for b in betas], dtype=torch.float32,
                        device=dev)
    seeds = torch.arange(B, dtype=torch.int32, device=dev)
    noise = (torch.randint(0, 2 ** 32, (B, k, 2, K, L), generator=gen,
                           device=dev, dtype=torch.int64).to(torch.int32)
             if inject else None)
    state = [slots, 0]

    def call():
        state[0] = exclusion_kernel.exclusion_multi_step(
            scal, seeds, state[0], band, k_steps=k, dt=DT, periodic=False,
            bidirectional=False, step0=state[1] * k, noise=noise)
        state[1] += 1

    call()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        call()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 3 * 1e3 / k


def main():
    if not torch.cuda.is_available():
        raise SystemExit("profile_exclusion_kernel: needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    rows = [("flagship B=33", {}),
            ("global m", dict(sigma=0.0)),
            ("injected bits", dict(inject=True, k=200)),
            ("K=1 N=500 sigma=0.005", dict(K=1, N=500, sigma=0.005))]
    rows += [(f"B={B}", dict(B=B)) for B in (1, 132, 264)]
    rows += [(f"L={L}", dict(L=L, N=3 * L // 4)) for L in (250, 4000)]
    for name, kw in rows:
        print(json.dumps(dict(row=name, us_per_step=step_us(dev, **kw),
                              **kw)), flush=True)


if __name__ == "__main__":
    main()

"""The general τ-leap step's cost per step at the shapes of its two
full-width paths.

- ``local structure``: the local-structure sweep's default (L=1000,
  N=900, K=1, walls, local m σ=0.005, rd=0.05, ra=5, the fixed init;
  B=33: 11 β in [0, 3] × 3 runs; the sweep's Δt);
- ``flagship sweep``: the β-sweep at the flagship capacity (L=1000, N=750,
  K=3, walls, σ=0.002, rd=0.02, ra=5, the exp-gradient Poisson init;
  B=33; the sweep's Δt).

On the CPU (``--device cpu``) it counts the operators one step dispatches
(``TorchDispatchMode``; views and the wrapping of Python scalars as CPU
tensors excluded, which launch nothing on the card): an estimate of the
kernels the step launches there, where a few operators (sort, scatter,
cumulative sums) may launch more than one.  On the card it times the step: µs
per step by CUDA events over 200 steps after 5 warm-up steps, and from
``torch.profiler`` over 20 steps the kernels and launch calls per step and
the device's busy time per step.  One JSON row per shape, with the card's
name and power limit.

Usage: python -m hydrolim_tpu_torch.experiments.profile_tau_leap_step
       [--device cuda|cpu] [--shapes "local structure,flagship sweep"]
"""
from __future__ import annotations

import argparse
import json
import subprocess
from collections import Counter

import numpy as np
import torch

from hydrolim_tpu_torch.particles.init import init_particles
from hydrolim_tpu_torch.particles.stepper import (
    ParticleState,
    build_static_arrays,
    step,
    with_exit_log,
)
from hydrolim_tpu_torch.sweeps import beta_sweep, local_structure
from hydrolim_tpu_torch.sweeps.ensemble import broadcast_params, ensemble_dt

FLAGSHIP = dict(site_capacity=3, N=750, local_kernel_sigma=0.002)
SHAPES = {
    "local structure": dict(local_structure.DEFAULT_STRUCTURE_PS_KWARGS),
    "flagship sweep": dict(beta_sweep.DEFAULT_PS_KWARGS, **FLAGSHIP),
}
BETAS = np.linspace(0.0, 3.0, 11)


def step_inputs(shape: str, device, n_runs: int = 3, seed: int = 4):
    """(config, params, statics, state, Δt, generator) of one shape's
    (β × runs) batch on ``device``."""
    ps = SHAPES[shape]
    cfg = beta_sweep.config_from_kwargs(ps)
    rates = dict(rate_diffusion=float(ps["rate_diffusion"]),
                 rate_active=float(ps["rate_active"]))
    params = broadcast_params(cfg, beta=BETAS, n_runs=n_runs, device=device,
                              **rates)
    dt = ensemble_dt(cfg, beta_max=float(BETAS.max()), **rates)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    prof = (None, None)
    if cfg.init == "poisson":
        g = beta_sweep.make_exp_gradient(L=cfg.L, N=cfg.N, frac_plus=0.75,
                                         decay_length=0.35,
                                         anchor_positions=None)
        prof = (g[2], g[3])
    st = init_particles(cfg, gen, *prof, B=len(BETAS) * n_runs,
                        device=device)
    state = with_exit_log(cfg, ParticleState(
        pos=st.pos, sigma=st.sigma, wind=torch.zeros_like(st.pos),
        alive=st.alive))
    return cfg, params, build_static_arrays(cfg, device), state, dt, gen


def count_ops(shape: str) -> dict:
    """Operators one step dispatches on the CPU, by name (views out)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    cfg, params, statics, state, dt, gen = step_inputs(shape, "cpu")
    counts: Counter = Counter()

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            view = not func._schema.is_mutable and any(
                r.alias_info is not None for r in func._schema.returns)
            if not view and func.__name__ != "scalar_tensor.default":
                counts[func.__name__] += 1
            return out

    state = step(cfg, params, statics, state, dt, 0.0, generator=gen)
    with Count():
        step(cfg, params, statics, state, dt, dt, generator=gen)
    return dict(shape=shape, ops_per_step=sum(counts.values()),
                by_op=dict(counts.most_common()))


def time_step(shape: str, device) -> dict:
    """µs per step (CUDA events), kernels, launch calls and device busy
    time per step (torch.profiler) on the card."""
    from torch.profiler import ProfilerActivity, profile

    cfg, params, statics, state, dt, gen = step_inputs(shape, device)
    box = [state]

    def one():
        box[0] = step(cfg, params, statics, box[0], dt, 0.0, generator=gen)

    for _ in range(5):
        one()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(200):
        one()
    end.record()
    torch.cuda.synchronize()
    us = start.elapsed_time(end) * 1e3 / 200
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            one()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    launches = [e for e in prof.events()
                if e.name in ("cudaLaunchKernel", "cuLaunchKernel",
                              "cudaLaunchKernelExC")]
    busy = (sum(e.device_time_total for e in kernels) / 20 if kernels
            else float("nan"))
    return dict(shape=shape, B=int(state.pos.shape[0]),
                n_buf=int(state.pos.shape[1]), dt=dt, us_per_step=us,
                kernels_per_step=len(kernels) / 20,
                launch_calls_per_step=len(launches) / 20,
                device_busy_us_per_step=busy,
                device_busy_share=busy / us if kernels else float("nan"))


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main(device: str = "cuda", shapes=tuple(SHAPES)) -> list:
    rows = []
    for shape in shapes:
        if device == "cpu":
            row = count_ops(shape)
        else:
            row = dict(time_step(shape, torch.device(device)), card=card())
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    p.add_argument("--shapes", default=",".join(SHAPES))
    a = p.parse_args()
    main(a.device, tuple(s.strip() for s in a.shapes.split(",")))

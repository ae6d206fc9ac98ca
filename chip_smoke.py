#!/usr/bin/env python3
"""GPU smoke of the PyTorch port (``hydrolim_tpu_torch``) on one card.

Phases (each prints one line with its wall time; a failed phase raises):

1. device: a CUDA card, its name and power limit (nvidia-smi), versions;
2. build: the four CUDA kernels from ``hydrolim_tpu_torch/csrc`` (B1, B2's
   step and its spectra, B3), one nvcc process each, all started together;
3. kernel B1 against its plain PyTorch version on the card, injected bits,
   under its own plan and under every cluster size and state mode its
   launch plan can reach (``B1_PLANS``: registers, shared memory, device
   memory), and at the critical-scaling driver's shape (L=8, zero motion
   rates, B=64, N=1024 and 16,384, β ∈ {0.5, 1.0}: σ moves, pos and wind
   stay);
4. kernel B2 against its plain PyTorch version on the card, injected bits,
   in every mode (``B2_CASES``: global / pointwise / narrow / smooth m,
   periodic / Neumann, bidirectional / anchored_minus, exact / banded /
   no solve, L=8192, the facade's 501 spectral bins, an odd n_t and an
   odd L), every call's bins on the spectra kernel; the same calls with
   their density scratch cut into pieces equal to them; the spectra
   kernel alone against its plain version at 501 bins;
5. the micro↔macro main path at full size (the cross-engine driver on
   ``device='cuda'``, native Philox streams) with its physics pins, and the
   proof that it ran through B1 and B2 (launch counters);
6. throughput of B1 at the main path's and the headline shapes (with the
   plan's cluster size and state mode) and of B2 at the main path's shape,
   kernel and plain version, B2's µs per step in each mode at the PDE
   slice's shapes with its bound (every row's bins on the spectra kernel;
   ``torch.fft.rfft`` of the density rows as the library yardstick), and
   the spectra kernel at the single run's shape;
7. kernel B3/B4 against its plain version on the card, injected bits, in
   four configurations at 4 and 33 replicas and L = 1000 and 999, under
   the launch plan and under every cluster size it allows, at L=8192
   (K=3, past one block's shared memory) and on the three wide bands (the
   dense reflect and periodic bands, every row reading all L sites, and
   σ=0.1's 801 taps; the plan's C > 1 on the exchanged count field):
   slots equal, state moved, admission refused somewhere, ids conserved,
   occupancy ≤ K; native Philox at the wide bands' driver shapes, the
   plan's C equal to C=1;
8. the exclusion β-sweep at full size (``sweep_over_betas`` on
   ``device='cuda'``, native Philox) in the reference configuration and at
   the flagship capacity, with its checks, where its wall time went, the
   physics pins, and the proof that it ran through B3/B4 (launch counter,
   per configuration);
9. throughput of B3/B4 at the JAX bench's flagship shape and at the
   sweep's 33 replicas: the plan it takes, the kernel (and per forced
   cluster size, C = 1…8), the plain version and the bound; and the three
   wide bands at their drivers' shapes under the plan and at C=1, with
   ``torch.matmul`` of the (cnt, occ) fields by the dense band as the
   yardstick for m;
10. the PDE slice at full size on ``device='cuda'``: the magn2 kernel-σ
    sweep, the single run through the ``IMEXPDE`` facade and the (β × σ)
    phase diagram, with their pins, B2's and the spectra kernel's
    launches on each and the kernels' device time against each driver's
    wall time;
11. ``ParticleSystem``: the reference's flagship single run on
    ``engine='pallas'`` (B3/B4; its out-dict keys, ids conserved,
    occupancy ≤ K), a mean-field run on B1 and one with walls on the torch
    fast path (no B1 launch), each with the m_β pin;
12. the particle (β × σ) phase diagram at full size (1024 replicas) with
    its ``check_physics`` pins and each row's wall, cluster size and µs per
    step;
13. the (N, β) double sweep at full size (836 replicas), refitting the
    exclusion constants C0/C1/C2 within the JAX package's golden bounds;
14. the σ sweep at full size (``REFERENCE_SIGMA_VALUES`` × 11 β × 5 runs),
    every estimate finite, each σ's launches, and the wide bands' plan and
    µs per step (σ=0.1: 801 taps; σ=0.3: the dense reflect band);
15. the slot engines (plain torch, no kernel of their own): ``lgk_step``
    on the card equal to kernel B3 at injected bits (K=3 and K=1, global
    and local m, B=33, L=1000); ``sweep_over_betas(engine='lattice_gas')``
    in phase 8's two configurations at full size, within error bars of
    phase 8's fused numbers, with no B3 launch; the anchored-exits driver
    at full size (exits on anchors, N_final + exits = N_initial, Sₐ
    finite) and the anchored golden; each driver's wall, and the slot
    engine's µs, kernels and launch calls per step (``torch.profiler``)
    beside B3's;
16. the general τ-leap engine (plain torch, no kernel of its own): its step
    on the card against the step on the CPU at the same injected draws
    (B=33, L=1000, 200 steps, five configurations: K=1 global m, K=3 local
    m, walls, anchors with bind/unbind/exit, K=12 on the sort path; equal
    wherever the events agree, every differing event within 1e-6 of a
    threshold); the port's copy of the exact CTMC oracle and the τ-leap
    engine on the card against the exact two-particle law; path (ii),
    ``sweep_over_betas(engine='particle')`` in phase 8's configuration
    (b), within the golden rule of phase 8's fused numbers with no B3
    launch; path (i), the local-structure sweep at its full default size
    on ``'particle'`` and on ``'pallas'`` (B3) within the golden rule of
    each other; the step's µs, kernels and device-busy share at both
    paths' shapes, and each path's wall;
17. chunked checkpoint/resume on every route: each run once in one piece
    (or phase 10's, 11's and 13's run at the same seed), once checkpointed
    and stopped after one chunk (``stop_after_chunks=1``) and resumed by a
    fresh call on the same directory; the elements of the stitched result
    that differ from the run in one piece are counted, and must be 0.  B3:
    ``sweep_over_betas(engine='fused', ckpt_dir=)`` in phase 8's two
    configurations; B1: ``ParticleSystem.run_checkpointed`` in phase 11's
    mean-field configuration; B2: ``IMEXPDE.solve_checkpointed`` at the
    single run's size, split off the tracer window, and
    ``run_pde_ensemble(ckpt_dir=)`` at magn2's shape; the plain-torch
    engines (path (ii) on ``'particle'``, ``run_lattice_gas_k_checkpointed``)
    at full width, 20 frames deep; the double sweep's chunk ledger (C0, C1,
    C2 equal); and a real SIGKILL of the fused sweep (a) in a child
    process, resumed here.  Each route prints both walls, the bytes
    written and the seconds spent in writes (wall and process CPU);
18. the single-card drivers at full size on ``device='cuda'``: the
    critical-scaling driver on B1 (its slope asserts; B1 launched, no step
    of the torch fast path or the τ-leap step; per N the wall and B1's
    device time), the convergence driver (the torch fast path and
    ``pde_step``; its slope asserts; the walls of the PDE solution and of
    each ladder point), the flagship single run's driver on ``'particle'``
    and ``'lattice_gas'`` (the JAX facade's keys, ids conserved, occupancy
    ≤ 3, the drift velocity, the walls), the kinesin fit, and the launcher
    (``python -m hydrolim_tpu_torch critical-scaling --small`` in a
    subprocess, and every command's ``--help``);
19. replica-axis parallelism and the large lattice: with
    ``devices=["cuda:0", "cuda:0"]`` (two blocks of a sweep mesh on the
    one card), ``sweep_over_betas`` on B1's route at the main path's
    width, ``run_exclusion_sweep`` at sweep (b)'s shape on B3 and
    ``run_pde_ensemble`` on B2, each equal to its one-device run bit for
    bit, with its kernel's launches; a world of one process over NCCL
    (``initialize_multihost``), equal to the run without it; the
    large-lattice driver at full size (L=65,536) with its asserts, both
    walls, the site updates per second and ``lg_step``'s µs per step.  A
    single card shows no scaling number, and the phase says so;
20. lattice-axis halo sharding on the one card (``parallel.spatial``, no
    kernel of its own): ``run_lattice_gas`` and ``run_lattice_gas_k`` at
    the exclusion sweep's (a) and (b) shapes on four segments
    (``space_mesh(devices=["cuda:0"] * 4)``) and on a (2, 2) ('sweep',
    'space') grid, 0 elements differing from the one-device run; a
    checkpointed ``lgk`` run stopped on the mesh and resumed unsharded;
    the large lattice at full width on 1, 2 and 4 segments with its
    asserts, the particle half bit for bit and the PDE half within its
    stated tolerance; the walls, ``lg_step``'s µs per step and the halo
    layer's counters.

21. B2 on a cluster of CTAs per replica: (a) the L=8192 banded row
    (pointwise, B=4) under every cluster size the card launches, 0
    elements differing from C=1 (native Philox and injected bits), each
    against the plain version; (b) ``run_pde_ensemble`` at L=65,536 with
    the large-lattice recipe (β ∈ {0.5, 2.5}, 64 tracers, 8 bins, 1500
    steps, the banded solve), counters reset just before it and read just
    after, with the large-lattice driver's asserts (mass, dm/dt against
    the CW law) and its density at every snapshot against the plain
    ``pde_step`` from the same initial fields; (c) ``pde_beta_sweep`` at
    L=16,384, 65,536 and 131,072 and ``IMEXPDE.solve`` at 16,384 and
    65,536, and a Neumann ``IMEXPDE`` at L=16,384 (narrow m, the exact
    solve across the cluster) against the plain version; (d) the full
    smoothing circulant at L=16,384, and the banded and the exact solve at
    L=131,072, against the plain version; (e) ``profile_pde_kernel.py --mode cluster``: µs per step at
    every cluster size the plan allows, and the plan's choice;
22. B2's device-memory route (the fields in device memory, G co-resident
    CTAs a replica), past a cluster's shared memory: (a) at L = 65,536
    (pointwise and narrow m, banded) and 131,072 (global m, banded;
    pointwise m, the Neumann exact solve), the route forced at the card's
    G and at G = 8 against the cluster route, 0 elements differing; (b)
    the card's plan at L = 262,144, 1,048,576 and 4,194,304 (the recipe,
    100 steps) against the plain version at phase 4's tolerances; (c)
    ``run_pde_ensemble`` at L = 262,144 and 1,048,576 with phase 21(b)'s
    asserts, its bound and the masses' (C8); (d) ``pde_beta_sweep`` and a
    Neumann ``IMEXPDE`` at 262,144, their modes and launches by route; (e)
    ``profile_pde_kernel.py --mode route``: µs per step on each route and
    without the bins, G and waves, the bound and the plain ``pde_step``
    loop.
23. B2's full smoothing in device memory (the FFT stage: the full
    Gaussian m past a cluster's 65,536 sites): (a) the card's plan at L =
    131,072, 200,000, 131,071 (prime) and 262,144, σ = 0.0005 and 0.05
    (the recipe, B = 2, 40 steps), against the plain version (float64
    ``torch.fft``) at phase 4's tolerances, at injected and at native bits;
    (b) ``run_pde_ensemble`` with σ = 0.05 at L = 262,144 and 1,048,576
    with phase 21(b)'s asserts, every call on the device-memory route; (c)
    ``pde_kernel_sigma_sweep`` at L = 131,072 over the reference σ (5 runs,
    1000 tracers, 200 steps), each σ's route; (d) the memory refusal at a
    reported 1 MB free; (e) ``profile_pde_kernel.py --mode route-smooth
    spectra-large``: µs per step with and without the bins, the bound,
    the plain loop, and ``torch.fft``'s stage in float32 and float64 as
    the yardstick; at 65,536 the cluster's direct circulant against the
    FFT stage; the spectra kernel at phase 22's calls past a million sites
    beside ``torch.fft.rfft`` of the same rows.

Phases 3, 4 and 7 also launch each kernel on rows [b0, b0 + n) of a batch
(``b0`` > 0, the blocks of a sweep mesh): native Philox output equal to
the whole batch's launch's rows bit for bit, and the kernel at b0 > 0
against its plain version at injected bits.

Phases 11-14 record B3's device time (CUDA events around each launch) and
its share of each driver's wall time.

The line before the last is ``{"kernels": [...]}`` (each kernel's
launches on its path, errors, times and bound) and the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
package beside it, the script exits non-zero and prints no result.

Usage: python3 chip_smoke.py
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import json
import math
import subprocess
import sys
import tempfile
import time

import numpy as np


@contextlib.contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    yield
    print(f"[phase] {name}: ok in {time.perf_counter() - t0:.2f} s",
          flush=True)


def cuda_ms(fn, reps: int = 1) -> float:
    """Mean device time of ``fn()`` in ms (CUDA events around ``reps``
    back-to-back calls)."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_device_ms(fn, reps: int = 20):
    """Mean device time per call of ``fn()`` in ms, the summed time of the
    card's kernels under ``torch.profiler`` over ``reps`` calls: without
    the host's gaps between short calls, which events around the calls
    count.  None where the profiler records no device event."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        return None
    return sum(e.device_time_total for e in kernels) / reps / 1e3


def randbits(shape, gen, dev):
    """Uniform uint32 bits held in int32."""
    import torch

    return torch.randint(0, 2 ** 32, shape, generator=gen, device=dev,
                         dtype=torch.int64).to(torch.int32)


# The least time the card could take for a kernel's work: the larger of its
# bytes over the H100's memory rate and its float32 operations over the
# float32 peak outside the tensor cores (NVIDIA's H100 SXM data sheet, at
# 700 W).  Bytes count each input read once and each
# output written once; operations are counted from the shapes and, where
# the work depends on the data, from this run's inputs.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def spectra_ops(rows: int, L: int, kmax: int) -> float:
    """The fewest operations for the first kmax rfft bins of ``rows`` real
    rows of L: the direct sum (2·L·2·kmax, an FMA being two) or a real
    FFT's 5/2·L·log2 L (half the radix-2 count of a complex FFT),
    whichever is smaller."""
    return rows * min(4.0 * L * kmax, 2.5 * L * math.log2(L))


def circulant_ops(L: int, r: int) -> float:
    """The fewest operations for one symmetric circular convolution of a
    real field of L sites by 2r+1 taps (r < L/2; the full circulant is r =
    L//2): the direct sum with each pair of taps folded (r adds, r FMAs
    and one multiply a site: 3r + 1) or a real FFT there and back
    (2 · 5/2·L·log2 L) with the real spectrum of the symmetric taps
    between (L), whichever is smaller."""
    return min((3.0 * r + 1.0) * L, 5.0 * L * math.log2(L) + L)


def fft_scratch_us(n: int, B: int) -> float:
    """Not a bound: µs a step that B2's FFT stage (the full smoothing on
    the device-memory route, one complex transform of n points) spends on
    its complex scratch if each of its three passes reads and writes it in
    device memory (B replicas of n values of 8 B), at the memory rate.
    The scratch is neither an input nor an output of the step, so
    ``b2_step_bound`` leaves it out; past the L2 (50 MB) it is this
    design's own floor."""
    return 3.0 * 2.0 * 8.0 * n * B / HBM_BYTES_PER_S * 1e6


def bound(n_bytes: float, n_ops: float) -> dict:
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S
    return dict(bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                library_ms=None)


# ---------------------------------------------------------------------------
# phase 3: B1 against its plain version
# ---------------------------------------------------------------------------

def check_b1(dev) -> float:
    """B=3, N=5000, both active models, 500 steps at two event rates: L=1000,
    dt=0.02, rd=0.5, ra=2 (p_dif = 0.01), and the main path's L=256,
    rd=γL², ra=λL at its dt (p_dif ≈ 0.05, so the wrap and winding branch
    runs often).  pos, σ and wind must be EQUAL (same bits, same f32
    threshold arithmetic, expf on both sides).  Returns the max abs
    difference (0)."""
    import torch
    from hydrolim_tpu_torch.core.config import ParticleConfig
    from hydrolim_tpu_torch.experiments.cross_engine_validation import (
        GAMMA,
        LAM,
    )
    from hydrolim_tpu_torch.ops.stepper_kernel import (
        meanfield_multi_step,
        meanfield_multi_step_plain,
    )
    from hydrolim_tpu_torch.sweeps.ensemble import ensemble_dt

    B, N, k = 3, 5000, 500
    L_main = 256
    rd_main, ra_main = GAMMA * L_main ** 2, LAM * L_main
    dt_main = ensemble_dt(
        ParticleConfig(L=L_main, N=N, n_pad=N, init="fixed",
                       scale_rates=False, local_kernel_sigma=0.0,
                       periodic=True, site_capacity=None,
                       active_model="bidirectional"),
        beta_max=3.0, rate_diffusion=rd_main, rate_active=ra_main)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    err = 0
    for L, dt, rd, ra in ((1000, 0.02, 0.5, 2.0),
                          (L_main, dt_main, rd_main, ra_main)):
        pos = torch.randint(0, L, (B, N), generator=gen, device=dev,
                            dtype=torch.int32)
        sig = torch.randint(0, 2, (B, N), generator=gen, device=dev,
                            dtype=torch.int32) * 2 - 1
        wind = torch.zeros_like(pos)
        scal = torch.tensor([[b, rd, ra] for b in (0.5, 1.5, 2.5)],
                            dtype=torch.float32, device=dev)
        seeds = torch.zeros(B, dtype=torch.int32, device=dev)
        noise = randbits((B, k, N), gen, dev)
        for bidi in (True, False):
            kw = dict(L=L, k_steps=k, dt=dt, bidirectional=bidi, noise=noise)
            got = meanfield_multi_step(scal, seeds, pos, sig, wind, **kw)
            want = meanfield_multi_step_plain(scal, seeds, pos, sig, wind,
                                              **kw)
            torch.cuda.synchronize()
            what = f"B1 L={L} dt={dt:.3e} bidirectional={bidi}"
            for name, a, b in zip(("pos", "sigma", "wind"), got, want):
                bad = int((a != b).sum())
                if bad:
                    raise AssertionError(
                        f"{what}: {name} differs at {bad} of {a.numel()} "
                        f"particles ({bad / a.numel():.2e})")
                err = max(err, int((a - b).abs().max()))
            if not (got[0] != pos).any() or not (got[1] != sig).any():
                raise AssertionError(f"{what}: the state did not move")
            if not (got[2] != 0).any():
                raise AssertionError(f"{what}: no particle wrapped")
    return max(float(err), check_b1_plans(dev, gen),
               check_b1_critical(dev, gen))


def check_b1_critical(dev, gen) -> float:
    """B1 at the critical-scaling driver's shape: L=8, zero motion rates,
    B=64 (β ∈ {0.5, 1.0} × 32 runs), the driver's dt (``ensemble_dt`` at
    β=1), N=1024 and 16,384, 100 steps of injected bits under the wrapper's
    own plan.  pos, σ and wind must be EQUAL to the plain version's.  With
    no motion only σ moves: σ must change and pos and wind must stay as
    they were (phase 3's "moved" / "wrapped" expectations do not apply).
    Returns the max abs difference (0)."""
    import torch
    from hydrolim_tpu_torch.core.config import ParticleConfig
    from hydrolim_tpu_torch.ops.stepper_kernel import (
        coresident_clusters,
        launch_plan,
        meanfield_multi_step,
        meanfield_multi_step_plain,
    )
    from hydrolim_tpu_torch.sweeps.ensemble import ensemble_dt

    B, L, k = 64, 8, 100
    scal = torch.tensor([[b, 0.0, 0.0] for b in (0.5, 1.0) for _ in range(32)],
                        dtype=torch.float32, device=dev)
    seeds = torch.zeros(B, dtype=torch.int32, device=dev)
    for N in (1024, 16_384):
        dt = ensemble_dt(ParticleConfig(
            L=L, N=N, n_pad=N, init="fixed", scale_rates=False,
            local_kernel_sigma=0.0, periodic=True, site_capacity=None,
            active_model="bidirectional"), beta_max=1.0, rate_diffusion=0.0,
            rate_active=0.0)
        plan = launch_plan(B, N, L, k, coresident_clusters(0, N, L))
        pos = torch.randint(0, L, (B, N), generator=gen, device=dev,
                            dtype=torch.int32)
        sig = torch.randint(0, 2, (B, N), generator=gen, device=dev,
                            dtype=torch.int32) * 2 - 1
        wind = torch.randint(-2, 3, (B, N), generator=gen, device=dev,
                             dtype=torch.int32)
        kw = dict(L=L, k_steps=k, dt=dt, bidirectional=True,
                  noise=randbits((B, k, N), gen, dev))
        got = meanfield_multi_step(scal, seeds, pos, sig, wind, **kw)
        want = meanfield_multi_step_plain(scal, seeds, pos, sig, wind, **kw)
        torch.cuda.synchronize()
        what = (f"B1 critical-scaling shape B={B} N={N} L={L} dt={dt:.5f} "
                f"(plan C={plan.shape.cluster} {plan.shape.mode}, "
                f"{plan.shape.threads} threads, "
                f"{plan.shape.groups_per_cta} groups per CTA, "
                f"{plan.waves} wave(s))")
        for name, a, b in zip(("pos", "sigma", "wind"), got, want):
            bad = int((a != b).sum())
            if bad:
                raise AssertionError(f"{what}: {name} differs at {bad} of "
                                     f"{a.numel()} particles")
        if not (torch.equal(got[0], pos) and torch.equal(got[2], wind)):
            raise AssertionError(f"{what}: a particle moved at zero rates")
        flipped = float((got[1] != sig).float().mean())
        if flipped == 0.0:
            raise AssertionError(f"{what}: no spin flipped")
        print(f"{what}: equal over {k} steps; pos and wind unchanged, "
              f"{flipped:.3%} of spins differ from the start", flush=True)
    return 0.0


# B1's plans: (N, L, forced cluster size, the state mode it must take)
B1_PLANS = (
    (5000, 256, 1, "registers"), (5000, 256, 2, "registers"),
    (5001, 256, 3, "registers"), (5000, 256, 4, "registers"),
    (4999, 256, 8, "registers"), (30_000, 64, 1, "shared"),
    (100_000, 1000, 2, "shared"), (100_003, 1000, 4, "shared"),
    (100_000, 1000, 1, "global"), (3000, 70_000, 2, "global"),
)


def check_b1_plans(dev, gen) -> float:
    """B=3, 200 steps (dt=0.02, rd=0.5, ra=2: p_dif = 0.01), injected
    bits, both active models, under each of ``B1_PLANS``: pos, σ and wind
    EQUAL to the plain version's.  Returns the max abs difference (0)."""
    import torch
    from hydrolim_tpu_torch.ops.stepper_kernel import (
        coresident_clusters,
        launch_plan,
        meanfield_multi_step_planned,
        meanfield_multi_step_plain,
    )

    B, k = 3, 200
    scal = torch.tensor([[b, 0.5, 2.0] for b in (0.5, 1.5, 2.5)],
                        dtype=torch.float32, device=dev)
    seeds = torch.zeros(B, dtype=torch.int32, device=dev)
    for N, L, C, mode in B1_PLANS:
        plan = launch_plan(B, N, L, k, coresident_clusters(0, N, L),
                           cluster=C)
        what = (f"B1 plan C={C} {plan.shape.mode} ({plan.shape.threads} "
                f"threads) N={N} L={L}")
        if plan.shape.mode != mode:
            raise AssertionError(f"{what}: want the {mode} state")
        pos = torch.randint(0, L, (B, N), generator=gen, device=dev,
                            dtype=torch.int32)
        sig = torch.randint(0, 2, (B, N), generator=gen, device=dev,
                            dtype=torch.int32) * 2 - 1
        wind = torch.randint(-2, 3, (B, N), generator=gen, device=dev,
                             dtype=torch.int32)
        for bidi in (True, False):
            kw = dict(L=L, k_steps=k, dt=0.02, bidirectional=bidi,
                      noise=randbits((B, k, N), gen, dev))
            got = meanfield_multi_step_planned(plan, scal, seeds, pos, sig,
                                               wind, **kw)
            want = meanfield_multi_step_plain(scal, seeds, pos, sig, wind,
                                              **kw)
            torch.cuda.synchronize()
            for name, a, b in zip(("pos", "sigma", "wind"), got, want):
                bad = int((a != b).sum())
                if bad:
                    raise AssertionError(f"{what} bidirectional={bidi}: "
                                         f"{name} differs at {bad} of "
                                         f"{a.numel()} particles")
            if torch.equal(got[0], pos) or torch.equal(got[1], sig):
                raise AssertionError(f"{what}: the state did not move")
        print(f"{what}: equal over {k} steps, both active models",
              flush=True)
    return 0.0


# ---------------------------------------------------------------------------
# phase 4: B2 against its plain version
# ---------------------------------------------------------------------------

def held(what: str, got, want, rtol: float, atol: float) -> tuple:
    """(max |got − want|, its largest share of the tolerance atol +
    rtol·|want|); NaN must sit where the plain version has NaN.  Raises
    past the tolerance."""
    import torch

    nan = torch.isnan(want)
    if not torch.equal(nan, torch.isnan(got)):
        raise AssertionError(f"{what}: NaN where the plain version has none "
                             "(or the reverse)")
    d = (got - want).abs()[~nan]
    tol = (atol + rtol * want.abs())[~nan]
    if d.numel() == 0:
        return 0.0, 0.0
    err, share = float(d.max()), float((d / tol).max())
    if not share <= 1.0:
        raise AssertionError(
            f"{what}: max |kernel - plain| {err:.3e} is {share:.2f} x its "
            f"tolerance (rtol {rtol}, atol {atol})")
    return err, share


# The Var record's atol, as a share of the run's largest Var (each check
# prints it): Var scales with the lattice and the fields' noise, from
# ~1e-8 at L=1000 to ~1e-10 and below past 16,384 sites, and the kernel's
# Var differs from the plain version's by a few 1e-6 of the largest at
# most, so a constant atol would pass any Var at the large lattices.
VAR_ATOL = 1e-5


def b2_against_plain(what: str, kernel_out, plain_out, W: int,
                     field_atol: float = 1e-7) -> dict:
    """Phase 4's tolerances: fields rtol 2e-4 / atol ``field_atol`` (1e-7
    unless a caller tightens it), tracers and ring
    rtol 1e-4 / atol 1e-5, spins equal, v and D rtol 5e-4 / atol 1e-6
    with the NaN prefix of a run from step 0 (``W`` steps), m atol 1e-5,
    Var rtol 1e-3 / atol ``VAR_ATOL`` of the run's largest Var, spectra
    rtol 1e-4 / atol 1e-8.  Prints and returns each check's (max error,
    share of the tolerance)."""
    import torch

    sk, rk = kernel_out[:5], kernel_out[5]
    sp, rp = plain_out[:5], plain_out[5]
    res = {}
    for name, i, rtol, atol in (("rho_p", 0, 2e-4, field_atol),
                                ("rho_m", 1, 2e-4, field_atol),
                                ("tracer pos", 2, 1e-4, 1e-5),
                                ("ring", 4, 1e-4, 1e-5)):
        res[name] = held(f"{what} {name}", sk[i], sp[i], rtol, atol)
    if not torch.equal(sk[3], sp[3]):
        raise AssertionError(f"{what}: tracer spins differ")
    for col, name in ((2, "v_eff"), (3, "D_eff")):
        if not rk[:, :W, col].isnan().all():
            raise AssertionError(f"{what}: {name} NaN prefix")
        res[name] = held(f"{what} {name}", rk[..., col], rp[..., col], 5e-4,
                         1e-6)
    res["m"] = held(f"{what} m", rk[..., 0], rp[..., 0], 0.0, 1e-5)
    res["Var"] = held(f"{what} Var", rk[..., 1], rp[..., 1], 1e-3,
                      VAR_ATOL * float(rp[..., 1].abs().max()))
    if rk.shape[-1] > 4:
        res["spectra"] = held(f"{what} spectra", rk[..., 4:], rp[..., 4:],
                              1e-4, 1e-8)
    print(f"{what}: spins equal; max |kernel - plain| (share of the "
          "tolerance): " + ", ".join(f"{n} {e:.2e} ({s:.3f})"
                                     for n, (e, s) in res.items())
          + f"; largest Var {float(rp[..., 1].abs().max()):.2e}",
          flush=True)
    return res


# Kernel B2's covering set: (label, expected (m_mode, solve_mode), PDEConfig
# fields beyond the defaults, shape).  Defaults: L=1000, B=4, n_t=1000,
# window 100, dt=5e-4, γ=0.2, periodic, bidirectional, kmax 8, two chained
# 150-step calls.
B2_CASES = (
    ("global, periodic, bidirectional, exact", ("global", "exact"),
     dict(gaussian_kernel=True, kernel_sigma=2e5), {}),
    ("global, periodic, bidirectional, none", ("global", "none"),
     dict(gaussian_kernel=True, kernel_sigma=2e5), dict(gamma=0.0)),
    ("pointwise, periodic, bidirectional, exact", ("pointwise", "exact"),
     {}, {}),
    ("pointwise, neumann, bidirectional, exact", ("pointwise", "exact"),
     dict(bc="neumann"), {}),
    ("global, periodic, bidirectional, exact, n_t=1001 (odd)",
     ("global", "exact"), dict(gaussian_kernel=True, kernel_sigma=2e5),
     dict(n_t=1001)),
    ("pointwise, periodic, bidirectional, exact, L=999 (odd L + n_t)",
     ("pointwise", "exact"), {}, dict(L=999)),
    ("narrow sigma=0.005, periodic, bidirectional, none", ("narrow", "none"),
     dict(gaussian_kernel=True, kernel_sigma=0.005), dict(gamma=0.0)),
    ("smooth sigma=0.05, neumann, anchored_minus, exact",
     ("smooth", "exact"), dict(gaussian_kernel=True, kernel_sigma=0.05,
                               bc="neumann", active_model="anchored_minus"),
     {}),
    ("global, periodic, bidirectional, banded (dt=1e-5)",
     ("global", "banded"), dict(gaussian_kernel=True, kernel_sigma=2e5,
                                diffusion_solver="banded"), dict(dt=1e-5)),
    ("pointwise, L=8192, banded (dt=2e-7, B=4, 64 tracers, window 20)",
     ("pointwise", "banded"), dict(diffusion_solver="banded"),
     dict(L=8192, n_t=64, W=20, dt=2e-7)),
    ("the facade's spectra: narrow sigma=0.005, none, kmax 501, B=1",
     ("narrow", "none"), dict(gaussian_kernel=True, kernel_sigma=0.005),
     dict(B=1, gamma=0.0, kmax=501)),
)


def b2_kwargs(config, ops) -> dict:
    m_mode, solve_mode, _, _ = ops
    return dict(L=config.L, n_t=config.n_tracers, window=config.tracer_window,
                dt=config.dt, xlim=config.xlim,
                periodic=config.bc == "periodic", m_mode=m_mode,
                solve_mode=solve_mode,
                bidirectional=config.active_model == "bidirectional",
                kmax_rec=config.kmax)


def check_b2(dev) -> tuple:
    """Every mode of B2 (``B2_CASES``) against its plain version on the
    card: injected bits, β spread over the replicas, two chained 150-step
    calls.  Tolerances of the JAX package's kernel-logic test: fields rtol
    2e-4 / atol 1e-7, tracers and ring rtol 1e-4 / atol 1e-5, spins equal,
    v and D rtol 5e-4 / atol 1e-6 with the NaN prefix; records: m atol
    1e-5, Var rtol 1e-3 / atol ``VAR_ATOL`` of the largest, spectra rtol
    1e-4 / atol 1e-8.  Each check prints
    its max error and its share of the tolerance.  Every call's spectra
    take the spectra kernel (one launch per call), and the same calls with
    the density scratch cut into pieces of 40 steps (4 launches of each
    kernel a call) must EQUAL them, state and records.  For the 501-bin
    case, the spectra kernel alone against ``pde_spectra_plain`` on (1,
    150, L) rows of its initial density with 1% uniform noise: rtol 1e-4,
    atol 1e-6 (the noise's bins are sums of L terms of size ~1, rounded in
    another order than cuBLAS's; √L·2⁻²⁴·1.5/L·L ≈ 3e-6 is float32's
    typical error of such a sum).  Returns the max abs field difference
    and the spectra kernel's max abs difference."""
    import torch
    from hydrolim_tpu_torch.experiments.profile_pde_kernel import b2_inputs
    from hydrolim_tpu_torch.ops import pde_kernel
    from hydrolim_tpu_torch.ops.pde_kernel import (
        pde_multi_step,
        pde_multi_step_plain,
        pde_spectra,
        pde_spectra_plain,
    )

    k, piece = 150, 40
    err = spectra_err = 0.0
    budget = pde_kernel.SPECTRA_SCRATCH_BYTES
    for what, modes, over, shape in B2_CASES:
        gen = torch.Generator(device=dev)
        gen.manual_seed(2)
        config, gamma, ops, scal, sk = b2_inputs(dev, over, shape, gen)
        if ops[:2] != modes:
            raise AssertionError(f"B2 {what}: routed to {ops[:2]}")
        B, n_t, W = scal.shape[0], config.n_tracers, config.tracer_window
        seeds = torch.zeros(B, dtype=torch.int32, device=dev)
        noise = randbits((B, 2 * k, 3, n_t), gen, dev)
        start, sp, ss = list(sk), list(sk), list(sk)
        rk, rpl, rst = [], [], []
        n0, m0 = pde_spectra.launches, pde_multi_step.launches
        for c in range(2):
            kw = dict(b2_kwargs(config, ops), k_steps=k,
                      noise=noise[:, c * k:(c + 1) * k].contiguous())
            *sk, r1 = pde_multi_step(scal, seeds, c * k, *sk, ops[3],
                                     ops[2], **kw)
            *sp, r2 = pde_multi_step_plain(scal, seeds, c * k, *sp, ops[3],
                                           ops[2], **kw)
            pde_kernel.SPECTRA_SCRATCH_BYTES = 4 * B * piece * config.L
            try:
                *ss, r3 = pde_multi_step(scal, seeds, c * k, *ss, ops[3],
                                         ops[2], **kw)
            finally:
                pde_kernel.SPECTRA_SCRATCH_BYTES = budget
            rk.append(r1)
            rpl.append(r2)
            rst.append(r3)
        torch.cuda.synchronize()
        cuts = -(-k // piece)
        if (pde_spectra.launches - n0, pde_multi_step.launches - m0) != (
                2 + 2 * cuts, 2 + 2 * cuts):
            raise AssertionError(
                f"B2 {what}: {pde_multi_step.launches - m0} step and "
                f"{pde_spectra.launches - n0} spectra launches, want "
                f"{2 + 2 * cuts} of each")
        rk, rpl = torch.cat(rk, 1), torch.cat(rpl, 1)
        torch.testing.assert_close(torch.cat(rst, 1), rk, rtol=0, atol=0,
                                   equal_nan=True)
        for a_, b_ in zip(ss, sk):
            if not torch.equal(a_, b_):
                raise AssertionError(f"B2 {what}: the state differs when "
                                     "the scratch is cut into pieces")
        print(f"B2 {what}: the calls cut into pieces of {piece} steps "
              f"({cuts} launches of each kernel a call) EQUAL the calls in "
              "one launch", flush=True)
        if config.kmax > 100:
            dens = (start[0] + start[1])[:, None, :] * (1.0 + 0.01 * (
                torch.rand((B, k, config.L), generator=gen, device=dev)
                - 0.5))
            recs = torch.zeros((B, k, 4 + 2 * config.kmax), device=dev)
            pde_spectra(dens, recs, config.kmax)
            spectra_err, share = held(
                f"B2 {what}: spectra kernel", recs[..., 4:],
                pde_spectra_plain(dens, config.kmax), 1e-4, 1e-6)
            print(f"B2 spectra kernel (rows {B * k}, L {config.L}, "
                  f"{config.kmax} bins) vs pde_spectra_plain: max abs "
                  f"{spectra_err:.2e} ({share:.3f} of the tolerance)",
                  flush=True)
        res = b2_against_plain(f"B2 {what}", (*sk, rk), (*sp, rpl), W)
        if torch.equal(sk[0], start[0]) or torch.equal(sk[2], start[2]):
            raise AssertionError(f"B2 {what}: the fields or tracers did not "
                                 "move")
        err = max(err, res["rho_p"][0], res["rho_m"][0])
    return err, spectra_err


# ---------------------------------------------------------------------------
# phase 5: the main path
# ---------------------------------------------------------------------------

def main_path(outdir: str) -> dict:
    from hydrolim_tpu_torch.experiments import cross_engine_validation as cev
    from hydrolim_tpu_torch.ops.pde_kernel import pde_multi_step, pde_spectra
    from hydrolim_tpu_torch.ops.stepper_kernel import meanfield_multi_step

    meanfield_multi_step.launches = 0
    pde_multi_step.launches = pde_spectra.launches = 0
    res = cev.main(small=False, outdir=outdir, device="cuda")
    launches = {"meanfield_multi_step": meanfield_multi_step.launches,
                "pde_multi_step": pde_multi_step.launches,
                "pde_spectra": pde_spectra.launches}
    print("main-path launches:", launches, flush=True)
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"the main path never launched {name}")

    beta, lam = res["beta"], cev.LAM
    sel = (beta <= 0.6) | (beta >= 1.8)
    for name, arr in res.items():
        if not np.all(np.isfinite(arr)):
            raise AssertionError(f"main path: non-finite {name}: {arr}")
    np.testing.assert_allclose(res["v_particle"][sel], res["v_theory"][sel],
                               atol=0.15 * lam, rtol=0.12,
                               err_msg="particle |v| vs λ·tanh(βm_β)")
    dv = np.abs(res["v_pde"][sel] - res["v_theory"][sel])
    if not (dv < 0.1 * lam).all():
        raise AssertionError(f"PDE |v| off theory by {dv} (limit 0.1λ)")
    dD = np.abs(res["D_pde"][sel] - res["D_theory"][sel])
    if not (dD < 0.5 * res["D_theory"][sel]).all():
        raise AssertionError(f"PDE D off theory by {dD} (limit 50%)")
    return launches


# ---------------------------------------------------------------------------
# phase 6: throughput
# ---------------------------------------------------------------------------

def b1_rate(dev, gen, label, B, N, L, k, dt, rd, ra, betas) -> dict:
    """B1's ms per ``k``-step call at one shape (native Philox, CUDA events
    over 3 calls after a warm-up, step0 advanced per call), the plan the
    wrapper chose, its bound and the plain version's ms per 1000 steps."""
    import torch
    from hydrolim_tpu_torch.ops.stepper_kernel import (
        coresident_clusters,
        launch_plan,
        meanfield_multi_step,
        meanfield_multi_step_plain,
    )

    st = [torch.randint(0, L, (B, N), generator=gen, device=dev,
                        dtype=torch.int32),
          torch.randint(0, 2, (B, N), generator=gen, device=dev,
                        dtype=torch.int32) * 2 - 1,
          torch.zeros((B, N), dtype=torch.int32, device=dev)]
    scal = torch.tensor([[b, rd, ra] for b in betas], dtype=torch.float32,
                        device=dev)
    seeds = torch.randint(0, 2 ** 30, (B,), generator=gen, device=dev,
                          dtype=torch.int32)
    kw = dict(L=L, k_steps=k, dt=dt, bidirectional=True)
    frame = [0]

    def kernel_call():
        st[:] = meanfield_multi_step(scal, seeds, *st, step0=frame[0] * k,
                                     **kw)
        frame[0] += 1

    kernel_call()                                   # warm-up
    ms = [cuda_ms(kernel_call) for _ in range(3)]   # 3 frames
    plain_ms = cuda_ms(lambda: meanfield_multi_step_plain(
        scal, seeds, *st, generator=gen, **dict(kw, k_steps=1000)))
    plan = launch_plan(B, N, L, k, coresident_clusters(0, N, L))
    # per particle-step: the uniform's scale and four threshold compares;
    # per replica-step: two expf and their scaling
    b = bound(6 * 4 * B * N + 16 * B, k * (5 * B * N + 4 * B))
    row = dict(shape=label, B=B, N=N, L=L, k_steps=k,
               cluster=plan.shape.cluster, state=plan.shape.mode,
               threads=plan.shape.threads, ms=float(np.mean(ms)),
               us_per_step=float(np.mean(ms)) * 1e3 / k,
               plain_ms_per_1000_steps=plain_ms, **b)
    print(f"B1 {label} (B={B}, N={N}, L={L}): cluster C={plan.shape.cluster}"
          f", state in {plan.shape.mode}, {plan.shape.threads} threads; "
          f"{row['us_per_step']:.3f} us/step "
          f"({B * N * k / (row['ms'] / 1e3):.4e} particle-steps/s; "
          f"{k}-step calls {', '.join(f'{m:.2f}' for m in ms)} ms); bound "
          f"{b['bound_ms']:.4f} ms per call ({b['bound_by']}); plain "
          f"{plain_ms:.1f} ms per 1000 steps", flush=True)
    return row


def throughput(dev) -> dict:
    """B1 at the main path's particle shape (33 replicas, N=5000, L=256,
    its rates and dt, 20,000-step calls) and at the headline shape (B=64,
    N=1e5, L=1000, dt=0.002, rd=0.5, ra=2, β=linspace(0,3,64), 1000-step
    calls), and B2 at the main path's PDE shape (33 replicas, L=1000, 1000
    tracers, one 2000-step chunk), each beside its plain version on the
    same card."""
    import torch
    from hydrolim_tpu_torch.core.config import ParticleConfig, PDEConfig
    from hydrolim_tpu_torch.experiments.cross_engine_validation import (
        GAMMA,
        LAM,
    )
    from hydrolim_tpu_torch.ops.pde_kernel import (
        build_solve_operands,
        pde_multi_step,
        pde_multi_step_plain,
    )
    from hydrolim_tpu_torch.pde.init import pde_initialize
    from hydrolim_tpu_torch.sweeps.ensemble import ensemble_dt

    out = {}
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    L = 256
    rd, ra = GAMMA * L ** 2, LAM * L
    dt = ensemble_dt(ParticleConfig(
        L=L, N=5000, n_pad=5000, init="fixed", scale_rates=False,
        local_kernel_sigma=0.0, periodic=True, site_capacity=None,
        active_model="bidirectional"), beta_max=3.0, rate_diffusion=rd,
        rate_active=ra)
    main_row = b1_rate(dev, gen, "main path", 33, 5000, L, 20_000, dt, rd,
                       ra, np.repeat(np.linspace(0.0, 3.0, 11), 3))
    head = b1_rate(dev, gen, "headline", 64, 100_000, 1000, 1000, 0.002,
                   0.5, 2.0, np.linspace(0.0, 3.0, 64))
    out["meanfield_multi_step"] = dict(
        ms=head["ms"], plain_ms=head["plain_ms_per_1000_steps"],
        **{key: head[key] for key in ("bound_ms", "bound_by", "library_ms")},
        per_shape=[main_row, head])

    B, L, n_t, k, dt, gamma = 33, 1000, 1000, 2000, 5e-4, 0.2
    config = PDEConfig(L=L, dt=dt, n_tracers=n_t)
    rp, rm, tr = pde_initialize(config, gen, B=B, mode="homogeneous",
                                noise=0.3, n_tracers=n_t, device=dev)
    solve = build_solve_operands(L, config.dx, dt, gamma, True, "exact", dev)
    scal = torch.tensor([[b, 0.6, gamma, 0.0]
                         for b in np.repeat(np.linspace(0, 3, 11), 3)],
                        dtype=torch.float32, device=dev)
    seeds = torch.randint(0, 2 ** 30, (B,), generator=gen, device=dev,
                          dtype=torch.int32)
    args = (scal, seeds, 0, rp, rm, tr.unwrapped, tr.spin.float(), tr.hist,
            solve)
    kw = dict(L=L, n_t=n_t, window=config.tracer_window, k_steps=k, dt=dt,
              xlim=config.xlim, periodic=True, m_mode="global",
              solve_mode="exact", bidirectional=True, kmax_rec=8)
    pde_multi_step(*args, **kw)                     # warm-up
    ms = cuda_ms(lambda: pde_multi_step(*args, **kw), reps=3)
    solve.a_inv                  # the plain version's inverse, built untimed
    plain_ms = cuda_ms(lambda: pde_multi_step_plain(*args, generator=gen,
                                                    **kw))
    # bytes: fields, tracer position/spin/unwrapped and the ring in and
    # out, the records out; operations per replica-step, counted from the
    # step's arithmetic: ~30 per site (m, upwind advection, CW reaction,
    # tridiagonal solve, clip, renormalisation), ~24 per tracer (flip,
    # Box–Muller, gather, update, window statistics) and 4 per site and
    # spectral bin
    W, kmax = config.tracer_window, 8
    out["pde_multi_step"] = dict(
        ms=ms, plain_ms=plain_ms,
        **bound(4 * (2 * 2 * B * L + 2 * 3 * B * n_t + 2 * B * W * n_t
                     + B * k * (4 + 2 * kmax)),
                k * B * (30 * L + 24 * n_t + 4 * kmax * L)))
    print(f"B2 kernel {B * k / (ms / 1e3):.4e} replica-steps/s "
          f"({ms:.1f} ms per {k}-step chunk); plain "
          f"{B * k / (plain_ms / 1e3):.4e} replica-steps/s "
          f"({plain_ms:.1f} ms)", flush=True)
    out["pde_multi_step"]["per_mode"] = throughput_b2_modes(dev, gen)
    out["pde_spectra"] = throughput_spectra(dev, gen)
    return out


def throughput_spectra(dev, gen) -> dict:
    """The spectra kernel at the ``IMEXPDE`` single run's shape: one
    call's (1, 50, L=1000) density rows, 501 bins (CUDA events over 20
    calls after a warm-up), its plain version, the library yardstick
    ``torch.fft.rfft`` over the same rows (the port never calls it), and
    its bound: the rows, the trig table and the bins moved once, and the
    fewest operations for the bins (``spectra_ops``: at 501 bins a real
    FFT's).  The events around such short calls count the host's gaps
    between them, so ``ms`` and ``library_ms`` are the kernels' own
    device time (``kernel_device_ms``), where the profiler records it, and
    ``call_ms``, ``library_call_ms`` the events' time per call."""
    import torch
    from hydrolim_tpu_torch.ops.pde_kernel import (
        pde_spectra,
        pde_spectra_plain,
    )

    B, k, L, kmax = 1, 50, 1000, 501
    dens = 0.5 + torch.rand((B, k, L), generator=gen, device=dev)
    recs = torch.zeros((B, k, 4 + 2 * kmax), device=dev)
    pde_spectra(dens, recs, kmax)
    call_ms = cuda_ms(lambda: pde_spectra(dens, recs, kmax), reps=20)
    dev_ms = kernel_device_ms(lambda: pde_spectra(dens, recs, kmax))
    pde_spectra_plain(dens, kmax)
    plain_ms = cuda_ms(lambda: pde_spectra_plain(dens, kmax), reps=20)
    torch.fft.rfft(dens, dim=-1)
    lib_call_ms = cuda_ms(lambda: torch.fft.rfft(dens, dim=-1), reps=20)
    lib_dev_ms = kernel_device_ms(lambda: torch.fft.rfft(dens, dim=-1))
    b = bound(4 * (B * k * L + 2 * L + B * k * 2 * kmax),
              spectra_ops(B * k, L, kmax))
    ms = call_ms if dev_ms is None else dev_ms
    b["library_ms"] = lib_call_ms if lib_dev_ms is None else lib_dev_ms

    def us(t):
        return "not measured" if t is None else f"{t * 1e3:.2f} us"

    print(f"B2 spectra kernel ({B * k} rows, L={L}, {kmax} bins): "
          f"{us(dev_ms)} of device time a call (torch.profiler), "
          f"{call_ms * 1e3:.2f} us a call (events around 20 calls); bound "
          f"{b['bound_ms'] * 1e3:.3f} us ({b['bound_by']}); plain "
          f"{plain_ms * 1e3:.1f} us; torch.fft.rfft {us(lib_dev_ms)} of "
          f"device time, {lib_call_ms * 1e3:.2f} us a call", flush=True)
    return dict(ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                library_call_ms=lib_call_ms,
                shape=dict(B=B, k=k, L=L, kmax=kmax), **b)


def b2_step_bound(config, ops, B: int, k: int) -> dict:
    """Bytes: the fields, tracers and ring in and out, the records out.
    Operations per replica-step (an FMA is two): ~30 per site (m, upwind
    advection, CW reaction, tridiagonal solve, clip, renormalisation), ~24
    per tracer, the spectra's fewest (``spectra_ops``), and the
    circulants' fewest (``circulant_ops``): the smoothing of ρ₊ − ρ₋ and
    ρ₊ + ρ₋ (the narrow taps or the full circulant) and the banded solve
    of ρ₊ and ρ₋, two fields each — on either route, whatever the
    kernel's algorithm (the FFT stage's scratch is no input or output:
    ``fft_scratch_us``)."""
    m_mode, solve_mode, smooth, solve = ops
    L, n_t, W, kmax = (config.L, config.n_tracers, config.tracer_window,
                       config.kmax)
    per_step = 30.0 * L + 24.0 * n_t
    if smooth is not None:
        per_step += 2 * circulant_ops(L, smooth.radius)
    if solve_mode == "banded":
        per_step += 2 * circulant_ops(L, (solve.weights.shape[0] - 1) // 2)
    return bound(4 * (2 * 2 * B * L + 2 * 3 * B * n_t + 2 * B * W * n_t
                      + B * k * (4 + 2 * kmax)),
                 k * B * per_step + spectra_ops(k * B, L, kmax))


def throughput_b2_modes(dev, gen) -> list:
    """B2's µs per step in each mode at the slice's shapes (native
    Philox, CUDA events over 3 calls after a warm-up), its bound, the
    plain version's µs per step (one 20-step call), and with spectral
    bins the library yardstick per step: ``torch.fft.rfft`` over the
    call's (B, k, L) density rows (the port never calls it).  The step
    kernel's launches a call (more than one where the density scratch is
    cut into pieces) are counted."""
    import torch
    from hydrolim_tpu_torch.experiments.profile_pde_kernel import (
        ROWS,
        b2_inputs,
    )
    from hydrolim_tpu_torch.ops.pde_kernel import (
        pde_multi_step,
        pde_multi_step_plain,
    )

    rows = []
    for label, over, shape, k in ROWS:
        config, _, ops, scal, state = b2_inputs(dev, over, shape, gen)
        B = scal.shape[0]
        seeds = torch.arange(B, dtype=torch.int32, device=dev)
        kw = dict(b2_kwargs(config, ops), k_steps=k)
        args = (scal, seeds, 0, *state, ops[3], ops[2])
        n0 = pde_multi_step.launches
        pde_multi_step(*args, **kw)                     # warm-up
        pieces = pde_multi_step.launches - n0
        ms = cuda_ms(lambda: pde_multi_step(*args, **kw), reps=3)
        pk = 20
        pde_multi_step_plain(*args, generator=gen, **dict(kw, k_steps=2))
        plain_ms = cuda_ms(lambda: pde_multi_step_plain(
            *args, generator=gen, **dict(kw, k_steps=pk)))
        lib_us = None
        if config.kmax:
            dens = torch.rand((B, k, config.L), generator=gen, device=dev)
            torch.fft.rfft(dens, dim=-1)
            lib_us = cuda_ms(lambda: torch.fft.rfft(dens, dim=-1),
                             reps=20) * 1e3 / k
        b = b2_step_bound(config, ops, B, k)
        row = dict(label=label, m_mode=ops[0], solve_mode=ops[1], B=B,
                   L=config.L, n_t=config.n_tracers, steps_per_call=k,
                   launches_per_call=pieces, us_per_step=ms * 1e3 / k,
                   plain_us_per_step=plain_ms * 1e3 / pk,
                   bound_us_per_step=b["bound_ms"] * 1e3 / k,
                   bound_by=b["bound_by"], library_us_per_step=lib_us)
        rows.append(row)
        print(f"B2 {label}: {row['us_per_step']:.2f} us/step "
              f"({B * k / (ms / 1e3):.4e} replica-steps/s; {pieces} "
              f"launches a call); bound {row['bound_us_per_step']:.4f} "
              "us/step "
              f"({b['bound_by']}); plain {row['plain_us_per_step']:.1f} "
              f"us/step" + (f"; torch.fft.rfft of the densities "
                            f"{lib_us:.3f} us/step" if lib_us else ""),
              flush=True)
    return rows


# ---------------------------------------------------------------------------
# phase 7: B3/B4 against its plain version
# ---------------------------------------------------------------------------

B3_CHECKS = (
    ("global m, periodic, bidirectional", 3, 0.0, True, True),
    ("local m sigma=0.002, non-periodic, plus_forward", 3, 0.002, False,
     False),
    ("local m sigma=0.02, periodic", 3, 0.02, True, False),
    ("K=1, local m sigma=0.005, non-periodic", 1, 0.005, False, False),
)


def exclusion_state(dev, gen, *, B, K, L, sigma, periodic, N=None,
                    init="fixed", profiles=(None, None)):
    """(slots with payload ids, smoothing band or None) of B replicas."""
    from hydrolim_tpu_torch.core.config import ParticleConfig
    from hydrolim_tpu_torch.ops.exclusion_kernel import build_smoothing_band
    from hydrolim_tpu_torch.sweeps.fast_exclusion import init_payload_slots

    cfg = ParticleConfig(L=L, N=N or (K * L) // 2, init=init,
                         scale_rates=False, local_kernel_sigma=sigma,
                         periodic=periodic, site_capacity=K)
    slots = init_payload_slots(cfg, gen, *profiles, B=B, device=dev)
    return slots, (build_smoothing_band(cfg, dev) if sigma > 0 else None)


def check_b3(dev) -> float:
    """L=1000 and L=999, rd=1, ra=3, dt=0.02 (events on ~10% of slot-steps,
    so the admission rounds refuse candidates), β across [0, 3], half the
    K·L slots filled; two chained 100-step calls per configuration at 4 and
    33 replicas, under the wrapper's plan and under every cluster size the
    plan allows.  Slots must be EQUAL (the same bits, the same float32
    arithmetic and summation order, expf on both sides); the state must
    move, some admission round must refuse a candidate (the plain
    version's tally), particle ids must be conserved and occupancy ≤ K.
    Then L=8192 at K=3 (more than one block's shared memory) under every
    cluster size that holds it, and the three wide bands at L=1000 (the
    dense reflect and periodic bands and σ=0.1's 801 taps), whose plan
    takes C > 1 on the exchanged count field.  Last, native Philox at the
    wide bands' driver shapes (B=64 and 55): the plan's C EQUAL to C=1.
    Returns the max abs difference (0)."""
    import torch
    from hydrolim_tpu_torch.ops.exclusion_kernel import (
        card_plan,
        exclusion_multi_step,
        exclusion_multi_step_plain,
        exclusion_multi_step_planned,
    )

    k, dt = 100, 0.02
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    err = 0
    cases = [(B, L) + c for B in (4, 33) for L in (1000, 999)
             for c in B3_CHECKS]
    cases.append((4, 8192, "local m sigma=0.002, non-periodic, K=3", 3,
                  0.002, False, False))
    # the wide bands (the plan: C > 1 on the exchanged count field): the
    # sigma sweep's sigma=0.3 (reflect radius 1200 >= L, every row reads
    # all L sites) and sigma=0.1 (801 taps), the particle phase diagram's
    # sigma=2.0 (2r+1 >= L on the torus)
    cases.append((4, 1000, "dense reflect band sigma=0.3, non-periodic, "
                  "K=1", 1, 0.3, False, False))
    cases.append((4, 1000, "reflect band sigma=0.1 (801 taps), "
                  "non-periodic, K=1", 1, 0.1, False, False))
    cases.append((4, 1000, "dense periodic band sigma=2.0, bidirectional",
                  3, 2.0, True, True))
    for B, L, what, K, sigma, periodic, bidi in cases:
        what = f"B3/B4 B={B} L={L} {what}"
        slots0, band = exclusion_state(dev, gen, B=B, K=K, L=L,
                                       sigma=sigma, periodic=periodic)
        scal = torch.stack([torch.linspace(0.0, 3.0, B, device=dev),
                            torch.full((B,), 1.0, device=dev),
                            torch.full((B,), 3.0, device=dev)],
                           1).contiguous()
        seeds = torch.zeros(B, dtype=torch.int32, device=dev)
        kws = [dict(k_steps=k if L < 8192 else 20, dt=dt, periodic=periodic,
                    bidirectional=bidi,
                    noise=randbits((B, k if L < 8192 else 20, 2, K, L), gen,
                                   dev)) for _ in range(2)]
        sk = sp = slots0
        tally = {}
        want = []
        for c, kw in enumerate(kws):
            sk = exclusion_multi_step(scal, seeds, sk, band, **kw)
            sp = exclusion_multi_step_plain(scal, seeds, sp, band,
                                            tally=tally, **kw)
            torch.cuda.synchronize()
            bad = int((sk != sp).sum())
            if bad:
                raise AssertionError(
                    f"{what}: call {c}: slots differ at {bad} of "
                    f"{sk.numel()}")
            err = max(err, int((sk - sp).abs().max()))
            want.append(sp)
        if torch.equal(sk, slots0):
            raise AssertionError(f"{what}: the state did not move")
        refused = tally["candidates"] - tally["admitted"]
        if refused <= 0:
            raise AssertionError(f"{what}: no admission refusal ({tally})")
        for r in range(B):
            if not torch.equal(sk[r].abs()[sk[r] != 0].sort().values,
                               slots0[r].abs()[slots0[r] != 0]
                               .sort().values):
                raise AssertionError(f"{what}: replica {r} lost or gained "
                                     "particles")
        if int((sk != 0).sum(1).max()) > K:
            raise AssertionError(f"{what}: occupancy above K={K}")
        sizes = []
        for C in range(1, 9):
            try:
                plan = card_plan(B, K, L, band, periodic, cluster=C)
            except ValueError:
                continue
            got = slots0
            for c, kw in enumerate(kws):
                got = exclusion_multi_step_planned(plan, scal, seeds, got,
                                                   band, **kw)
                torch.cuda.synchronize()
                if not torch.equal(got, want[c]):
                    raise AssertionError(f"{what}: C={C}: call {c}: slots "
                                         f"differ at "
                                         f"{int((got != want[c]).sum())}")
            sizes.append(C)
        if not sizes:
            raise AssertionError(f"{what}: no cluster size fits")
        plan = card_plan(B, K, L, band, periodic)
        if sigma >= 0.1 and not (plan.cluster > 1 and plan.exchange
                                 and sizes == list(range(1, 9))):
            raise AssertionError(f"{what}: plan {plan}, sizes {sizes}")
        print(f"{what}: equal over {2 * kws[0]['k_steps']} steps under the "
              f"plan (C={plan.cluster}"
              f"{', exchanged counts' if plan.exchange else ''}) and "
              f"C={sizes}; admission {tally['admitted']} of "
              f"{tally['candidates']} candidates", flush=True)
    for what, B, K, sigma, periodic in WIDE_BANDS:
        slots0, band = exclusion_state(dev, gen, B=B, K=K, L=1000,
                                       sigma=sigma, periodic=periodic,
                                       N=500 * K)
        plan = card_plan(B, K, 1000, band, periodic)
        scal = torch.stack([torch.linspace(0.0, 3.0, B, device=dev),
                            torch.full((B,), 0.02, device=dev),
                            torch.full((B,), 5.0, device=dev)],
                           1).contiguous()
        seeds = torch.arange(B, dtype=torch.int32, device=dev)
        kw = dict(k_steps=500, dt=4e-3, periodic=periodic,
                  bidirectional=periodic, step0=7)
        ref = exclusion_multi_step_planned(
            card_plan(B, K, 1000, band, periodic, cluster=1), scal, seeds,
            slots0, band, **kw)
        got = exclusion_multi_step(scal, seeds, slots0, band, **kw)
        torch.cuda.synchronize()
        bad = int((got != ref).sum())
        if bad or torch.equal(got, slots0) or not plan.exchange:
            raise AssertionError(f"B3/B4 {what}: {bad} slots differ from "
                                 f"C=1 under the plan {plan}")
        print(f"B3/B4 {what}: native Philox, 500 steps under the plan "
              f"(C={plan.cluster}, exchanged counts) EQUAL to C=1 "
              f"(0 of {got.numel()} differ)", flush=True)
    return float(err)


# the drivers' wide bands at L=1000: (label, B, K, σ, periodic)
WIDE_BANDS = (
    ("particle phase diagram, dense periodic sigma=2.0, B=64", 64, 3, 2.0,
     True),
    ("sigma sweep, dense reflect sigma=0.3, B=55", 55, 1, 0.3, False),
    ("sigma sweep, reflect sigma=0.1 (801 taps), B=55", 55, 1, 0.1, False),
)


# ---------------------------------------------------------------------------
# phase 8: the exclusion β-sweep at full size
# ---------------------------------------------------------------------------

SLICE_BETAS = np.linspace(0.0, 3.0, 11)
# phase 8's fused-route statistics per configuration, for phase 15
PHASE8_SWEEPS: dict = {}


def host_s(fn, reps: int = 3) -> tuple:
    """(min, max) over ``reps`` calls of ``fn()``'s wall time in s, the
    card synchronised at the end of each call."""
    import torch

    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t0)
    return min(ts), max(ts)


def sweep_breakdown(save: dict, over: dict, outdir: str, n_calls: int,
                    wall: float) -> None:
    """Where one sweep's wall time went.  The same sweep is run again,
    warm (the difference from ``wall`` is one-time set-up); then each part
    is timed alone through the calls the sweep makes: the grid run
    (``run_sweep_grid_lattice_gas``: initial state, kernel calls, frame
    records; the frames stay on the card), the estimators on its frames,
    the frames' copy to the host that ``keep_outs`` makes, and the NB fit
    (``fit_and_plot_v_eff`` on the sweep's arrays).  Host times spread on
    a shared machine, so each is the min–max of 3 runs, and the parts'
    minima are set against the warm minimum; what they leave is the per-β
    statistics and the npz save.  Last, the kernel's device time for the
    sweep's ``n_calls`` calls, replayed back to back under CUDA events on
    the sweep's final slots (the same particles)."""
    import torch
    from hydrolim_tpu_torch.fit.veff_fit import fit_and_plot_v_eff
    from hydrolim_tpu_torch.observables.batched import batched_estimates
    from hydrolim_tpu_torch.particles.lattice_gas import tracer_valid_mask
    from hydrolim_tpu_torch.ops.exclusion_kernel import (
        build_smoothing_band,
        exclusion_multi_step,
    )
    from hydrolim_tpu_torch.particles.run import substeps_for
    from hydrolim_tpu_torch.sweeps.beta_sweep import (
        DEFAULT_PS_KWARGS,
        DEFAULT_RUN_KWARGS,
        make_exp_gradient,
        run_sweep_grid_lattice_gas,
        sweep_over_betas,
    )

    warm = host_s(lambda: sweep_over_betas(
        SLICE_BETAS, n_runs_per_beta=3, ps_kwargs=over or None,
        npz_path=f"{outdir}/warm.npz", outdir=outdir, seed=0,
        keep_outs=True, plot_result=False, engine="fused", device="cuda"))
    ps = dict(DEFAULT_PS_KWARGS, **over)
    grad = make_exp_gradient(L=ps["L"], N=ps["N"], frac_plus=0.75,
                             decay_length=0.35, anchor_positions=None)
    grid_out = []

    def grid_run():
        grid_out[:] = run_sweep_grid_lattice_gas(
            SLICE_BETAS, 3, ps, dict(rho0_plus=grad[0], rho0_minus=grad[1]),
            DEFAULT_RUN_KWARGS, seed=0, device="cuda")

    grid = host_s(grid_run)
    cfg, _, _, f, _, _ = grid_out
    obs_dt = float(DEFAULT_RUN_KWARGS["obs_dt"])
    est = host_s(lambda: batched_estimates(
        f.total, f.m_global, f.rho_p,
        np.arange(0.0, float(DEFAULT_RUN_KWARGS["T"]), obs_dt),
        f.tracer_pos, tracer_valid_mask(f.tracer_pos), dx=cfg.dx,
        xlim=float(cfg.xlim)))
    copies = host_s(lambda: [a.cpu().numpy() for a in f])
    del f, grid_out
    fit = host_s(lambda: fit_and_plot_v_eff(
        save["beta_values"], save["ps_kwargs"],
        *(save[k] for k in ("means", "stds", "ses", "m_means", "m_stds",
                            "m_ses", "rho_means", "rho_ses", "block_means",
                            "block_ses")),
        plot_result=False, outdir=outdir))
    parts = grid[0] + est[0] + copies[0] + fit[0]

    dev = torch.device("cuda", 0)
    k = substeps_for(obs_dt, float(save["dt"]))
    slots = torch.as_tensor(save["spins_final"], device=dev)
    scal = torch.tensor([[b, ps["rate_diffusion"], ps["rate_active"]]
                         for b in np.repeat(SLICE_BETAS, 3)],
                        dtype=torch.float32, device=dev)
    seeds = torch.arange(len(scal), dtype=torch.int32, device=dev)
    band = (build_smoothing_band(cfg, dev) if cfg.local_kernel_sigma > 0
            else None)
    kernel = n_calls * cuda_ms(lambda: exclusion_multi_step(
        scal, seeds, slots, band, k_steps=k, dt=obs_dt / k,
        periodic=cfg.periodic,
        bidirectional=cfg.active_model == "bidirectional"),
        reps=n_calls) / 1e3
    span = lambda t: f"{t[0]:.4f}–{t[1]:.4f} s"
    print(f"  breakdown (host clock, min–max of 3): wall {wall:.4f} s, warm "
          f"{span(warm)} (set-up {wall - warm[0]:.4f} s); grid run "
          f"{span(grid)}, estimators {span(est)}, frames to the host "
          f"{span(copies)}, NB fit {span(fit)}; the parts' minima sum to "
          f"{parts:.4f} s of the warm minimum {warm[0]:.4f} s; kernel "
          f"{kernel:.4f} s on the device ({n_calls} calls of {k} steps), "
          f"{kernel / warm[0]:.2%} of the warm minimum", flush=True)


def slice_path(outdir: str) -> dict:
    """``sweep_over_betas(engine='fused')`` on the card at the reference
    sweep's own size (11 β × 3 runs, L=1000, T=20, obs_dt=0.1, every
    particle tagged): (a) DEFAULT_PS_KWARGS (K=1, N=500, σ=0.005) and (b)
    the flagship capacity (K=3, N=750, σ=0.002).  Then the physics pins of
    the CPU tests, through the kernel."""
    import torch
    from hydrolim_tpu_torch.experiments.particle_beta_sweep import FLAGSHIP
    from hydrolim_tpu_torch.ops.exclusion_kernel import exclusion_multi_step
    from hydrolim_tpu_torch.sweeps.beta_sweep import (
        make_exp_gradient,
        sweep_over_betas,
    )
    from hydrolim_tpu_torch.theory.meanfield import m_fixed_point

    launches = {}
    for name, over in (("(a) K=1, N=500, sigma=0.005", {}),
                       ("(b) K=3, N=750, sigma=0.002", FLAGSHIP)):
        exclusion_multi_step.launches = 0
        t0 = time.perf_counter()
        save = sweep_over_betas(
            SLICE_BETAS, n_runs_per_beta=3, ps_kwargs=over or None,
            npz_path=f"{outdir}/sweep.npz", outdir=outdir, seed=0,
            keep_outs=True, plot_result=False, engine="fused", device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = exclusion_multi_step.launches
        launches[f"sweep {name}"] = n
        print(f"sweep {name}: {wall:.2f} s wall, {n} launches of "
              f"exclusion_multi_step, dt {float(save['dt']):.4e}", flush=True)
        if n <= 0:
            raise AssertionError(f"sweep {name} never launched the kernel")
        for key in ("means", "D_means", "m_means", "rho_means",
                    "block_means", "popt"):
            print(f"  {key}: {np.round(save[key], 5).tolist()}", flush=True)
            if not np.all(np.isfinite(save[key])):
                raise AssertionError(f"sweep {name}: non-finite {key}")
        K = int(save["ps_kwargs"]["site_capacity"])
        spins = save["spins_final"]
        n0 = np.array([o["alive_frames"][0].sum() for outs in save["outs"]
                       for o in outs])
        if not np.array_equal((spins != 0).sum((1, 2)), n0):
            raise AssertionError(f"sweep {name}: particle counts changed")
        if (spins != 0).sum(1).max() > K:
            raise AssertionError(f"sweep {name}: occupancy above K={K}")
        PHASE8_SWEEPS[name] = {k: np.asarray(save[k], float) for k in (
            "means", "ses", "D_means", "D_ses", "m_means", "m_ses")}
        PHASE8_SWEEPS[name]["wall_s"] = wall
        sweep_breakdown(save, over, outdir, n, wall)

    exclusion_multi_step.launches = 0
    L, N = 128, 96
    grad = make_exp_gradient(L=L, N=N, frac_plus=0.75, decay_length=0.35,
                             anchor_positions=None)
    save = sweep_over_betas(
        [0.7], n_runs_per_beta=64, ps_kwargs=dict(
            L=L, N=N, init="poisson", local_kernel_sigma=0.0, periodic=False,
            site_capacity=3, rate_diffusion=0.02, rate_active=2.0),
        init_kwargs=dict(rho0_plus=grad[0], rho0_minus=grad[1]),
        run_kwargs=dict(T=6.0, obs_dt=0.25), npz_path=f"{outdir}/pin.npz",
        seed=21, do_fit=False, plot_result=False, engine="fused",
        device="cuda")
    mean, se = float(save["block_means"][0]), float(save["block_ses"][0])
    print(f"pin K=3 p_block {mean:.4f} ± {se:.4f} (golden 0.5964)",
          flush=True)
    if not abs(mean - 0.5964) < max(4.0 * se, 0.028):
        raise AssertionError(f"K=3 p_block {mean} ± {se} off the golden")
    save = sweep_over_betas(
        [0.8, 1.5, 2.5], n_runs_per_beta=4, ps_kwargs=dict(
            L=128, N=48, init="fixed", local_kernel_sigma=0.0, periodic=True,
            site_capacity=1, active_model="bidirectional",
            rate_diffusion=0.5, rate_active=2.0),
        run_kwargs=dict(T=8.0, obs_dt=0.5), npz_path=f"{outdir}/pin.npz",
        seed=12, keep_outs=True, do_fit=False, plot_result=False,
        engine="fused", device="cuda")
    m_abs = np.mean([np.abs(o["m_global"][len(o["m_global"]) // 2:]).mean()
                     for o in save["outs"][2]])
    print(f"pin K=1 |m|(beta=2.5) {m_abs:.4f} (theory "
          f"{m_fixed_point(2.5):.4f}); pins launched the kernel "
          f"{exclusion_multi_step.launches} times", flush=True)
    if not abs(m_abs - m_fixed_point(2.5)) < 0.06:
        raise AssertionError(f"K=1 |m|(2.5) = {m_abs} off the fixed point")
    if exclusion_multi_step.launches <= 0:
        raise AssertionError("the pins never launched the kernel")
    return dict(launches=sum(launches.values()),
                launches_per_config=launches)


# ---------------------------------------------------------------------------
# phase 9: B3/B4 throughput
# ---------------------------------------------------------------------------

def b3_bound(slots, band, k: int) -> dict:
    """Bytes: the slots in and out, the scalars and seeds, the band once.
    Operations per replica-step: 2 sums of 2 operations per band tap and
    site (local m), and ~10 per occupied slot (the expf argument, expf,
    three threshold adds, the flip rate's scale, three compares), counted
    on these slots."""
    B, K, L = slots.shape
    W = 0 if band is None else band.idx.shape[1]
    return b3_bound_counts(B, K, L, W, int((slots != 0).sum()), k)


def b3_bound_counts(B: int, K: int, L: int, W: int, n_occ: int,
                    k: int) -> dict:
    """``b3_bound`` from the call's shape and its occupied slots."""
    return bound(2 * 4 * B * K * L + 12 * B + 8 * L * W,
                 k * (4 * W * L * B + 10 * n_occ))


def throughput_b3(dev) -> dict:
    """Native Philox, CUDA events, one warm-up call first:
    - the JAX bench's flagship shape (bench.py:295-320): B=16, K=3, L=1000,
      N=750 fixed init, σ=0.002 non-periodic plus_forward, dt=2e-3, β=0.7,
      ra=5, rd=0, 10,000- and 1,000-step calls, and the plain version's
      1,000-step call at that shape;
    - the sweep's 33 replicas at configuration (b) (exp-gradient Poisson
      init, β over [0, 3], rd=0.02, ra=5, its Δt), 10,000- and 1,000-step
      calls, and the plain version's 1,000-step call at that shape;
    each with the launch plan it takes and the µs per step under every
    cluster size C = 1…8 that fits (1000-step calls)."""
    import torch
    from hydrolim_tpu_torch.experiments.particle_beta_sweep import FLAGSHIP
    from hydrolim_tpu_torch.ops.exclusion_kernel import (
        card_plan,
        exclusion_multi_step,
        exclusion_multi_step_plain,
        exclusion_multi_step_planned,
    )
    from hydrolim_tpu_torch.sweeps.beta_sweep import (
        DEFAULT_PS_KWARGS,
        config_from_kwargs,
        make_exp_gradient,
    )
    from hydrolim_tpu_torch.sweeps.ensemble import ensemble_dt

    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    L, K = 1000, 3
    out = {}

    def rate(tag, slots, scal, seeds, band, k, dt, calls=3):
        state = [slots, 0]

        def call():
            state[0] = exclusion_multi_step(
                scal, seeds, state[0], band, k_steps=k, dt=dt,
                periodic=False, bidirectional=False, step0=state[1] * k)
            state[1] += 1

        call()                                           # warm-up
        ms = [cuda_ms(call) for _ in range(calls)]
        n = int((slots != 0).sum())
        print(f"B3 {tag}: {k}-step calls {', '.join(f'{m:.2f}' for m in ms)}"
              f" ms; {np.mean(ms) * 1e3 / k:.3f} us/step; "
              f"{n * k / (np.mean(ms) / 1e3):.4e} particle-steps/s", flush=True)
        return float(np.mean(ms))

    def plain(tag, slots, scal, seeds, band, dt):
        kw = dict(k_steps=1000, dt=dt, periodic=False, bidirectional=False)
        exclusion_multi_step_plain(scal, seeds, slots, band, generator=gen,
                                   **dict(kw, k_steps=10))   # warm-up
        ms = cuda_ms(lambda: exclusion_multi_step_plain(
            scal, seeds, slots, band, generator=gen, **kw))
        n = int((slots != 0).sum())
        print(f"B3 plain, {tag}: {ms:.1f} ms per 1000 steps; "
              f"{n * 1000 / (ms / 1e3):.4e} particle-steps/s", flush=True)
        return ms

    def clusters(tag, slots, scal, seeds, band, dt, k=1000):
        """µs per step under each forced cluster size (one warm-up call,
        then 2 calls of k steps)."""
        row = {}
        for C in range(1, 9):
            try:
                plan = card_plan(slots.shape[0], K, L, band, False,
                                 cluster=C)
            except ValueError:
                continue
            state = [slots, 0]

            def call():
                state[0] = exclusion_multi_step_planned(
                    plan, scal, seeds, state[0], band, k_steps=k, dt=dt,
                    periodic=False, bidirectional=False, step0=state[1] * k)
                state[1] += 1

            call()
            row[C] = round(np.mean([cuda_ms(call) for _ in range(2)])
                           * 1e3 / k, 4)
        print(f"B3 {tag}: us/step per cluster size {row}", flush=True)
        return row

    def shape(tag, slots, band):
        plan = card_plan(slots.shape[0], K, L, band, False)
        print(f"B3 {tag}: plan {plan}", flush=True)
        return plan

    B = 16
    slots, band = exclusion_state(dev, gen, B=B, K=K, L=L, sigma=0.002,
                                  periodic=False, N=750)
    scal = torch.tensor([[0.7, 0.0, 5.0]] * B, device=dev)
    seeds = torch.arange(B, dtype=torch.int32, device=dev)
    shape("flagship B=16 N=750", slots, band)
    rate("flagship B=16 N=750", slots, scal, seeds, band, 10_000, 2e-3)
    rate("flagship B=16 N=750", slots, scal, seeds, band, 1000, 2e-3)
    clusters("flagship B=16 N=750", slots, scal, seeds, band, 2e-3)
    plain("flagship B=16 N=750", slots, scal, seeds, band, 2e-3)
    bench = b3_bound(slots, band, 1000)
    print(f"B3 flagship B=16 N=750: bound {bench['bound_ms']:.4f} ms per "
          f"1000 steps ({bench['bound_by']})", flush=True)

    ps = dict(DEFAULT_PS_KWARGS, **FLAGSHIP)
    cfg = config_from_kwargs(ps)
    grad = make_exp_gradient(L=L, N=750, frac_plus=0.75, decay_length=0.35,
                             anchor_positions=None)
    dt = ensemble_dt(cfg, beta_max=3.0, rate_diffusion=0.02, rate_active=5.0)
    B = 33
    slots, band = exclusion_state(dev, gen, B=B, K=K, L=L, sigma=0.002,
                                  periodic=False, N=750, init="poisson",
                                  profiles=(grad[2], grad[3]))
    scal = torch.tensor([[b, 0.02, 5.0] for b in np.repeat(SLICE_BETAS, 3)],
                        dtype=torch.float32, device=dev)
    seeds = torch.arange(B, dtype=torch.int32, device=dev)
    plan = shape("sweep (b) B=33", slots, band)
    rate("sweep (b) B=33", slots, scal, seeds, band, 10_000, dt)
    ms = rate("sweep (b) B=33", slots, scal, seeds, band, 1000, dt)
    table = clusters("sweep (b) B=33", slots, scal, seeds, band, dt)
    plain_ms = plain("sweep (b) B=33", slots, scal, seeds, band, dt)
    out["exclusion_multi_step"] = dict(
        bench_bound=bench,
        ms=ms, plain_ms=plain_ms, plan=dict(cluster=plan.cluster,
                                            halo=plan.halo,
                                            threads=plan.threads),
        us_per_step_by_cluster=table, **b3_bound(slots, band, 1000),
        wide_bands=[wide_band_rate(dev, gen, *row) for row in WIDE_BANDS])
    return out


def wide_band_rate(dev, gen, what, B, K, sigma, periodic) -> dict:
    """One of the drivers' wide bands at its shape (L=1000, N=500·K, β
    over [0, 3], rd=0.02, ra=5, dt=4e-3, native Philox): µs per step
    under the plan (C > 1, exchanged counts) and at C=1 (two 1000-step
    calls each after a warm-up), the plain version's (5 steps), the
    bound, and the library yardstick for m alone: one ``torch.matmul`` of
    the stacked (cnt, occ) fields (2B, L) by the dense (L, L) band (the
    port never calls it)."""
    import torch
    from hydrolim_tpu_torch.ops.exclusion_kernel import (
        card_plan,
        exclusion_multi_step_plain,
        exclusion_multi_step_planned,
    )

    L = 1000
    slots, band = exclusion_state(dev, gen, B=B, K=K, L=L, sigma=sigma,
                                  periodic=periodic, N=500 * K)
    scal = torch.stack([torch.linspace(0.0, 3.0, B, device=dev),
                        torch.full((B,), 0.02, device=dev),
                        torch.full((B,), 5.0, device=dev)], 1).contiguous()
    seeds = torch.arange(B, dtype=torch.int32, device=dev)
    kw = dict(dt=4e-3, periodic=periodic, bidirectional=periodic)
    us = {}
    for C in (None, 1):
        plan = card_plan(B, K, L, band, periodic, cluster=C)
        state = [slots, 0]

        def call(k=1000):
            state[0] = exclusion_multi_step_planned(
                plan, scal, seeds, state[0], band, k_steps=k,
                step0=state[1] * k, **kw)
            state[1] += 1

        call()
        us[plan.cluster] = float(np.mean([cuda_ms(call) for _ in range(2)]))
        if C is None:
            main = plan
    exclusion_multi_step_plain(scal, seeds, slots, band, k_steps=1,
                               generator=gen, **kw)
    plain_us = cuda_ms(lambda: exclusion_multi_step_plain(
        scal, seeds, slots, band, k_steps=5, generator=gen, **kw)) * 1e3 / 5
    dense = torch.zeros((L, L), device=dev)
    dense.index_put_((torch.arange(L, device=dev)[:, None].expand(
        -1, band.idx.shape[1]), band.idx.long()), band.w, accumulate=True)
    counts = torch.rand((2 * B, L), generator=gen, device=dev)
    torch.matmul(counts, dense.T)
    lib_us = cuda_ms(lambda: torch.matmul(counts, dense.T), reps=20) * 1e3
    W = band.idx.shape[1]
    b = b3_bound_counts(B, K, L, W, int((slots != 0).sum()), 1)
    row = dict(shape=what, B=B, K=K, taps=W, cluster=main.cluster,
               exchange=main.exchange, us_per_step=us[main.cluster],
               us_per_step_c1=us[1], plain_us_per_step=plain_us,
               bound_us_per_step=b["bound_ms"] * 1e3,
               bound_by=b["bound_by"], library_m_us_per_step=lib_us)
    print(f"B3 {what}: {W} taps, plan C={main.cluster} (exchanged counts: "
          f"{main.exchange}) {row['us_per_step']:.3f} us/step, C=1 "
          f"{row['us_per_step_c1']:.3f}; bound "
          f"{row['bound_us_per_step']:.3f} us/step ({b['bound_by']}); "
          f"plain {plain_us:.1f} us/step; torch.matmul of (cnt, occ) by "
          f"the dense band {lib_us:.2f} us", flush=True)
    return row


# ---------------------------------------------------------------------------
# phase 10: the PDE slice at full size
# ---------------------------------------------------------------------------

def pde_slice(outdir: str) -> dict:
    """The three finite-σ PDE drivers at the JAX package's full sizes on
    ``device='cuda'``, each with its pins, its B2 launches and those of
    the spectra kernel (counts set to 0 just before it; one spectra launch
    per step launch, and a chunk whose density scratch passes its budget
    launches both kernels several times) and the kernels' device time
    (CUDA events around each call) against its wall time:
    - ``pde_kernel_sigma_sweep(variant='magn2')``: 5 σ × 5 runs, L=1000,
      T=10, 1000 tracers; mean over runs of |m(T)| < 1e-2 at every σ;
    - ``pde_single_run()``: L=1000, T=20 (40,000 steps), σ=0.005, 1000
      tracers, per-step spectra at the full rfft; ||m(T)| − m_β(2)| < 0.01
      and all 40,001 ``fft_amp`` rows finite;
    - the (β × σ) phase diagram (32 β × 2 seeds × 16 σ, L=1000, T=10, 64
      tracers) with its ``check_physics`` pins."""
    import torch
    from hydrolim_tpu_torch.experiments import pde_phase_diagram
    from hydrolim_tpu_torch.ops.pde_kernel import (
        kernel_ms,
        pde_multi_step,
        pde_spectra,
    )
    from hydrolim_tpu_torch.sweeps.pde_sweeps import (
        pde_kernel_sigma_sweep,
        pde_single_run,
    )
    from hydrolim_tpu_torch.theory.meanfield import m_fixed_point

    launches = {"pde_multi_step": {}, "pde_spectra": {}}

    def driven(name, fn):
        pde_multi_step.launches = pde_spectra.launches = 0
        pde_multi_step.events, pde_spectra.events = [], []
        t0 = time.perf_counter()
        try:
            out = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            device_s = kernel_ms(pde_multi_step.events) / 1e3
            spectra_s = kernel_ms(pde_spectra.events) / 1e3
        finally:
            events, pde_multi_step.events = pde_multi_step.events, None
            pde_spectra.events = None
        n = launches["pde_multi_step"][name] = pde_multi_step.launches
        n_sp = pde_spectra.launches
        print(f"{name}: {wall:.2f} s wall, {n} launches of pde_multi_step "
              f"and {n_sp} of pde_spectra, kernels {device_s:.3f} s on the "
              f"device ({device_s / wall:.1%} of the wall; the spectra "
              f"kernel {spectra_s:.3f} s of it)", flush=True)
        if n <= 0 or not 0 < len(events) <= n:
            raise AssertionError(f"{name} never launched pde_multi_step")
        if n_sp != n:
            raise AssertionError(f"{name}: {n_sp} launches of pde_spectra "
                                 f"for {n} of pde_multi_step")
        launches["pde_spectra"][name] = n_sp
        return out

    sweep = driven("sigma sweep magn2", lambda: pde_kernel_sigma_sweep(
        variant="magn2", outdir=outdir, plot_result=False, device="cuda"))
    for sigma, m in sweep["m"].items():
        final = float(np.mean(m[:, -1]))
        print(f"  sigma={sigma}: mean over {m.shape[0]} runs of |m(T)| "
              f"{final:.3e} (pin < 1e-2)", flush=True)
        if not final < 1e-2:
            raise AssertionError(f"magn2 sigma={sigma}: |m(T)| {final}")

    out = driven("single run", lambda: pde_single_run(
        outdir=f"{outdir}/single", device="cuda"))
    RUNS_IN_ONE_PIECE["single run"] = out
    m_T, m_b = abs(float(out["m_series"][-1])), m_fixed_point(2.0)
    amp = out["fft_amp"]
    print(f"  |m(T)| {m_T:.5f}, m_beta(2) {m_b:.5f} (pin 0.01); fft_amp "
          f"{amp.shape}, finite rows {int(np.isfinite(amp).all(1).sum())}",
          flush=True)
    if not abs(m_b - 0.9575) < 1e-3 or not abs(m_T - m_b) < 0.01:
        raise AssertionError(f"single run |m(T)| {m_T} off m_beta(2)")
    if amp.shape != (40001, 501) or not np.isfinite(amp).all():
        raise AssertionError(f"single run spectra {amp.shape} not finite")

    data = driven("phase diagram", lambda: pde_phase_diagram.main(
        outdir=f"{outdir}/phase_diagram", device="cuda"))
    print("  sigma rows: " + ", ".join(
        f"{s:.4g} {w:.2f} s" for s, w in zip(data["sigma"],
                                             data["row_wall_s"])),
          flush=True)
    return dict(launches_per_path=launches)


# ---------------------------------------------------------------------------
# phases 11-14: the particle facade and the drivers on the fused route
# ---------------------------------------------------------------------------

# The JAX package's ``ParticleSystem.run`` out-dict keys
# (hydrolim_tpu/particles/system.py:265-287 and :352-372): the GPU host has
# no jax to ask.
REF_OUT_KEYS = sorted([
    "times_obs", "pos_list", "rho_p_list", "rho_m_list", "total_list",
    "particle_count_list", "bound_list", "m_local_list", "m_global",
    "rho_hat_complex", "fft_amp_list", "var_list", "exit_times",
    "exit_positions", "exit_init_bin", "pos_frames", "alive_frames",
    "bound_frames", "dt_eff"])


@contextlib.contextmanager
def b3_timed(rows: list, module=None, name: str = ""):
    """B3's launches and device time (CUDA events around each launch) while
    the block runs; with ``module``/``name``, also per call of that
    function, appended to ``rows`` as {launches, kernel_ms, args, kwargs,
    result}.  The block's totals are appended last as {launches,
    kernel_ms}."""
    from hydrolim_tpu_torch.ops.exclusion_kernel import exclusion_multi_step
    from hydrolim_tpu_torch.ops.pde_kernel import kernel_ms

    exclusion_multi_step.launches = 0
    exclusion_multi_step.events = []
    orig = getattr(module, name) if module is not None else None

    def per_call(*args, **kwargs):
        n0 = exclusion_multi_step.launches
        e0 = len(exclusion_multi_step.events)
        out = orig(*args, **kwargs)
        rows.append(dict(launches=exclusion_multi_step.launches - n0,
                         kernel_ms=kernel_ms(exclusion_multi_step.events[e0:]),
                         args=args, kwargs=kwargs, result=out))
        return out

    if orig is not None:
        setattr(module, name, per_call)
    try:
        yield
        rows.append(dict(launches=exclusion_multi_step.launches,
                         kernel_ms=kernel_ms(exclusion_multi_step.events)))
    finally:
        exclusion_multi_step.events = None
        if orig is not None:
            setattr(module, name, orig)


def report_wall(name: str, wall: float, tot: dict) -> dict:
    dev_s = tot["kernel_ms"] / 1e3
    print(f"{name}: {wall:.3f} s wall, {tot['launches']} launches of "
          f"exclusion_multi_step, kernel {dev_s:.4f} s on the device "
          f"({dev_s / wall:.2%} of the wall)", flush=True)
    if tot["launches"] <= 0:
        raise AssertionError(f"{name} never launched exclusion_multi_step")
    return dict(wall_s=wall, launches=tot["launches"], kernel_s=dev_s)


def particle_system_runs() -> dict:
    """``ParticleSystem`` on the card:
    (a) the flagship single run (experiments/run_particle_single.py:22-32):
        L=1000, N=750, K=3, σ=0.002, non-periodic, β=0.7, rd=0, ra=5, T=20,
        obs_dt=0.5, rng=0, ``run(engine='pallas', record_fft=True,
        record_var=True)``: the JAX package's out keys, every particle a
        tracer in every frame, occupancy ≤ K, B3 launched;
    (b) a mean-field run on B1: periodic, the fixed init, global m, L=256,
        N=5000, β=2, T=30, the main path's rates (rd=γL², ra=λL,
        bidirectional): late-window mean of ||m| − m_β(2)| < 0.03, B1
        launched;
    (c) the same with walls, on the torch fast path: positions within
        [0, L), the same pin, no B1 launch.  Its rates are cut to rd=2,
        ra=5 (4,900 steps): the torch path launches ~25 kernels per step,
        and the main path's rates take 7.9 million; m's law (the flips
        under the global m) does not depend on the hop rates."""
    import torch
    from hydrolim_tpu_torch import ParticleSystem
    from hydrolim_tpu_torch.experiments.cross_engine_validation import (
        GAMMA,
        LAM,
    )
    from hydrolim_tpu_torch.ops.stepper_kernel import meanfield_multi_step
    from hydrolim_tpu_torch.sweeps.beta_sweep import make_exp_gradient
    from hydrolim_tpu_torch.theory.meanfield import m_fixed_point

    out = {}
    L, N = 1000, 750
    grad = make_exp_gradient(L=L, N=N, frac_plus=0.85, decay_length=0.2,
                             anchor_positions=None)
    rows = []
    t0 = time.perf_counter()
    with b3_timed(rows):
        ps = ParticleSystem(
            L=L, xlim=1, rate_diffusion=0, rate_active=5, beta=0.7,
            init="fixed", rho0_plus=grad[0], rho0_minus=grad[1], N=N,
            scale_rates=False, local_kernel_sigma=0.002, minus_anchor=True,
            periodic=False, immobilize_when_anchored=True,
            anchor_radius=0.003, anchor_positions=None, site_capacity=3,
            crowding_suppresses_rates=False, k_on=0, k_off=0, k_exit=0,
            rng=0, device="cuda")
        res = ps.run(T=20.0, obs_dt=0.5, record_fft=True, record_var=True,
                     engine="pallas")
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out["single run"] = report_wall("ParticleSystem flagship single run "
                                    "(engine='pallas')", wall, rows[-1])
    if sorted(res) != REF_OUT_KEYS:
        raise AssertionError(f"out keys {sorted(res)} != {REF_OUT_KEYS}")
    pos = res["pos_frames"]
    if pos.shape != (40, N) or not res["alive_frames"].all():
        raise AssertionError(f"tracers lost: {pos.shape}")
    occ = max(int(np.bincount(p, minlength=L).max()) for p in res["pos_list"])
    if occ > 3 or any(len(p) != N for p in res["pos_list"]):
        raise AssertionError(f"occupancy {occ} > K or a particle lost")
    if not np.isfinite(res["fft_amp_list"]).all() or \
            not np.isfinite(res["var_list"]).all():
        raise AssertionError("non-finite spectra or variance")
    print(f"  keys equal the JAX package's; {N} ids in all 40 frames; max "
          f"occupancy {occ}; COM drift "
          f"{(pos[-1] - pos[0]).mean() / L / 19.5:.4f} per unit time",
          flush=True)

    m_b = m_fixed_point(2.0)
    for name, periodic, (rd, ra) in (
            ("mean-field, periodic (B1)", True,
             (GAMMA * 256 ** 2, LAM * 256)),
            ("mean-field, walls (torch fast path)", False, (2.0, 5.0))):
        meanfield_multi_step.launches = 0
        t0 = time.perf_counter()
        ps = ParticleSystem(L=256, xlim=1, rate_diffusion=rd,
                            rate_active=ra, beta=2.0, init="fixed", N=5000,
                            scale_rates=False, local_kernel_sigma=0.0,
                            periodic=periodic, site_capacity=None,
                            active_model="bidirectional", rng=1,
                            device="cuda")
        res = ps.run(T=30.0, obs_dt=0.5)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if periodic:
            RUNS_IN_ONE_PIECE["mean-field"] = res
        n = meanfield_multi_step.launches
        m = res["m_global"]
        dev_m = float(np.abs(np.abs(m[len(m) // 2:]) - m_b).mean())
        steps = round(30.0 / res["dt_eff"])
        print(f"ParticleSystem {name}: {wall:.3f} s wall, route "
              f"{ps.last_run_info['engine']}, {n} launches of "
              f"meanfield_multi_step, {steps} steps (dt_eff "
              f"{res['dt_eff']:.4e}); late-window mean ||m| - m_beta(2)| "
              f"{dev_m:.4f} (pin 0.03)", flush=True)
        if not dev_m < 0.03:
            raise AssertionError(f"{name}: |m| off m_beta(2) by {dev_m}")
        if (n > 0) != periodic:
            raise AssertionError(f"{name}: {n} B1 launches on the "
                                 f"{ps.last_run_info['engine']} route")
        if not periodic and not (0 <= res["pos_frames"].min()
                                 and res["pos_frames"].max() < 256):
            raise AssertionError(f"{name}: a particle left the lattice")
        out[name] = dict(wall_s=wall, launches=n, steps=steps,
                         route=ps.last_run_info["engine"])
    return out


def phase_diagram_full(outdir: str) -> dict:
    """The particle (β × σ) phase diagram's ``main()`` at full size: 32 β ×
    2 seeds × 16 σ (``geomspace(0.002, 2, 15)`` and global m), L=1000,
    N=1500, K=3, T=20; ``check_physics`` runs inside.  Per row: its wall,
    its launch plan (cluster size, band taps) and B3's µs per step."""
    import torch
    from hydrolim_tpu_torch.core.config import ParticleConfig
    from hydrolim_tpu_torch.experiments import particle_phase_diagram as ppd
    from hydrolim_tpu_torch.ops.exclusion_kernel import (
        build_smoothing_band,
        card_plan,
    )
    from hydrolim_tpu_torch.particles.run import substeps_for

    rows = []
    t0 = time.perf_counter()
    with b3_timed(rows, ppd, "run_exclusion_sweep"):
        data = ppd.main(outdir=outdir, device="cuda")
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = report_wall("particle phase diagram", wall, rows[-1])
    per_row = []
    for sigma, row, row_wall in zip(data["sigma"], rows[:-1],
                                    data["row_wall_s"]):
        cfg = row["args"][0]
        band = (build_smoothing_band(cfg, "cuda") if sigma > 0 else None)
        B = row["args"][1].beta.shape[0]
        plan = card_plan(B, cfg.K, cfg.L, band, True)
        k = substeps_for(row["kwargs"]["obs_dt"], row["kwargs"]["dt"])
        steps = row["launches"] * k
        us = row["kernel_ms"] * 1e3 / steps
        W = 0 if band is None else band.idx.shape[1]
        slots = row["result"][1]
        b = b3_bound_counts(B, cfg.K, cfg.L, W, int((slots != 0).sum()), k)
        per_row.append(dict(sigma=sigma, wall_s=row_wall, cluster=plan.cluster,
                            taps=W, launches=row["launches"], steps=steps,
                            kernel_s=row["kernel_ms"] / 1e3,
                            us_per_step=us,
                            bound_us_per_step=b["bound_ms"] * 1e3 / k))
        print(f"  sigma={sigma:.4g}: {row_wall:.3f} s wall, C={plan.cluster}, "
              f"W={W} taps, {row['launches']} launches, {steps} steps, "
              f"kernel {row['kernel_ms'] / 1e3:.4f} s = {us:.2f} us/step; "
              f"bound {b['bound_ms'] * 1e3 / k:.3f} us/step "
              f"({b['bound_by']})", flush=True)
    out["rows"] = per_row
    return out


def double_sweep_full(outdir: str) -> dict:
    """``particle_double_sweep.main()`` at full size: 19 N × 11 β × 4 runs,
    T=10, obs_dt=0.1, ``DOUBLE_SWEEP_PS_KWARGS`` (K=1, σ=0.02 reflect,
    rd=0.005, ra=10), in chunks of 44 replicas.  The golden pins of the JAX
    package (tests/test_golden.py:298-319): |ΔC0|/C0 < 0.03, |ΔC1|/C1 <
    0.08, |ΔC2|/C2 < 0.08 against the frozen constants, 0 < C0_err < 0.05
    and 0 < C2_err < 0.01."""
    import torch
    from hydrolim_tpu_torch.experiments import particle_double_sweep
    from hydrolim_tpu_torch.theory import blocking as bl

    rows = []
    t0 = time.perf_counter()
    with b3_timed(rows):
        res = particle_double_sweep.main(outdir=outdir, device="cuda",
                                         engine="pallas")
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    RUNS_IN_ONE_PIECE["double sweep"] = {k: res[k] for k in DOUBLE_KEYS}
    out = report_wall("double sweep", wall, rows[-1])
    d = {k: abs(res[k] - getattr(bl, k)) / getattr(bl, k)
         for k in ("C0", "C1", "C2")}
    print(f"  C0 {res['C0']:.5f} ± {res['C0_err']:.5f} (|d|/C0 "
          f"{d['C0']:.4f}, pin 0.03), C1 {res['C1']:.5f} ± "
          f"{res['C1_err']:.5f} ({d['C1']:.4f}, pin 0.08), C2 "
          f"{res['C2']:.5f} ± {res['C2_err']:.5f} ({d['C2']:.4f}, pin 0.08)",
          flush=True)
    if not (d["C0"] < 0.03 and d["C1"] < 0.08 and d["C2"] < 0.08):
        raise AssertionError(f"C0/C1/C2 off the frozen constants: {d}")
    if not (0 < res["C0_err"] < 0.05 and 0 < res["C2_err"] < 0.01):
        raise AssertionError(f"fit errors {res['C0_err']}, {res['C2_err']}")
    out.update({k: res[k] for k in ("C0", "C1", "C2", "C0_err", "C1_err",
                                    "C2_err")})
    return out


def sigma_sweep_full(outdir: str) -> dict:
    """``particle_sigma_sweep.main()`` at full size:
    ``REFERENCE_SIGMA_VALUES`` (σ = 1e-4 … 0.3 and global m) × 11 β × 5
    runs, L=1000, K=1, non-periodic, T=20, obs_dt=0.1, every particle
    tagged.  Every estimate finite; each σ's launches, wall and B3 time;
    the wide bands' plan and µs per step (σ=0.1: 801 taps; σ=0.3: the
    dense reflect band).  The JAX package pins no physics here."""
    import torch
    from hydrolim_tpu_torch.experiments import particle_sigma_sweep
    from hydrolim_tpu_torch.ops.exclusion_kernel import (
        build_smoothing_band,
        card_plan,
    )
    from hydrolim_tpu_torch.particles.run import substeps_for
    from hydrolim_tpu_torch.sweeps import sigma_sweep
    from hydrolim_tpu_torch.sweeps.beta_sweep import config_from_kwargs

    rows = []
    t0 = time.perf_counter()
    with b3_timed(rows, sigma_sweep, "sweep_over_betas"):
        res = particle_sigma_sweep.main(outdir=outdir, device="cuda",
                                        engine="fused")
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = report_wall("sigma sweep", wall, rows[-1])
    per_sigma = []
    for sigma, row in zip(sigma_sweep.REFERENCE_SIGMA_VALUES, rows[:-1]):
        r = res[float(sigma)]
        for k in ("v_mean", "v_se", "D_mean", "D_se"):
            if not np.all(np.isfinite(r[k])):
                raise AssertionError(f"sigma={sigma}: non-finite {k}")
        if row["launches"] <= 0:
            raise AssertionError(f"sigma={sigma} never launched the kernel")
        save = row["result"]
        cfg = config_from_kwargs(save["ps_kwargs"])
        band = build_smoothing_band(cfg, "cuda") if sigma > 0 else None
        spins = save["spins_final"]
        B = spins.shape[0]
        plan = card_plan(B, cfg.K, cfg.L, band, False)
        k = substeps_for(0.1, float(save["dt"]))
        steps = row["launches"] * k
        us = row["kernel_ms"] * 1e3 / steps
        W = 0 if band is None else band.idx.shape[1]
        b = b3_bound_counts(B, cfg.K, cfg.L, W, int((spins != 0).sum()), k)
        per_sigma.append(dict(sigma=sigma, launches=row["launches"],
                              cluster=plan.cluster, taps=W, steps=steps,
                              kernel_s=row["kernel_ms"] / 1e3,
                              us_per_step=us,
                              bound_us_per_step=b["bound_ms"] * 1e3 / k))
        print(f"  sigma={sigma:g}: {row['launches']} launches, C="
              f"{plan.cluster}, W={W} taps, kernel "
              f"{row['kernel_ms'] / 1e3:.4f} s = {us:.2f} us/step; bound "
              f"{b['bound_ms'] * 1e3 / k:.3f} us/step ({b['bound_by']}); "
              f"v(beta) {np.round(r['v_mean'], 4).tolist()}", flush=True)
    out["per_sigma"] = per_sigma
    return out


# ---------------------------------------------------------------------------
# phase 15: the slot engines (plain torch)
# ---------------------------------------------------------------------------

SLOT_CHECKS = (
    ("K=3, local m sigma=0.002, non-periodic, plus_forward", 3, 0.002,
     False, False),
    ("K=3, global m, periodic, bidirectional", 3, 0.0, True, True),
    ("K=1, local m sigma=0.005, non-periodic, plus_forward", 1, 0.005,
     False, False),
    ("K=1, global m, periodic, bidirectional", 1, 0.0, True, True),
)


def check_slot_engine(dev) -> None:
    """(a) ``lgk_step`` on the card against kernel B3 at injected bits:
    B=33, L=1000, β over [0, 3], rd=1, ra=3, dt=0.02, 40 steps in each of
    ``SLOT_CHECKS``.  Each step's bits are drawn in B3's (Kp, Lp) layout
    and converted by ``interop.exclusion_noise``: event bits, and a
    distinct random rank per slot as B3's priority bits (``rank << 6``),
    the slot engine's priority being ``rank << 17 | slot id`` (no ties,
    the same admission).  The slot engine rounds t2 = t1 + (rd + ra)·Δt,
    B3 t1 + rd·Δt + ra·Δt: the check asserts that these rates round alike.
    Spins EQUAL after every step; the state moved."""
    import torch
    from hydrolim_tpu_torch import interop
    from hydrolim_tpu_torch.core.config import ParticleConfig, ParticleParams
    from hydrolim_tpu_torch.ops.exclusion_kernel import exclusion_multi_step
    from hydrolim_tpu_torch.ops.stepper_kernel import bits_to_uniform
    from hydrolim_tpu_torch.particles.lattice_gas_k import lgk_step

    B, L, dt, rd, ra, steps = 33, 1000, 0.02, 1.0, 3.0, 40
    f = np.float32
    if (f(rd) + f(ra)) * f(dt) != f(rd) * f(dt) + f(ra) * f(dt):
        raise AssertionError("the check's rates round differently in the "
                             "two threshold orders")
    rng = np.random.default_rng(15)
    gen = torch.Generator(device=dev)
    gen.manual_seed(15)
    betas = torch.linspace(0.0, 3.0, B, device=dev)
    scal = torch.stack([betas, torch.full((B,), rd, device=dev),
                        torch.full((B,), ra, device=dev)], 1).contiguous()
    zero = torch.zeros(B, device=dev)
    params = ParticleParams(beta=betas, rate_diffusion=scal[:, 1],
                            rate_active=scal[:, 2], k_on=zero, k_off=zero,
                            k_exit=zero)
    seeds = torch.zeros(B, dtype=torch.int32, device=dev)
    for what, K, sigma, periodic, bidi in SLOT_CHECKS:
        cfg = ParticleConfig(L=L, N=(K * L) // 2, init="fixed",
                             scale_rates=False, local_kernel_sigma=sigma,
                             periodic=periodic, site_capacity=K,
                             active_model="bidirectional" if bidi
                             else "plus_forward")
        slots0, band = exclusion_state(dev, gen, B=B, K=K, L=L, sigma=sigma,
                                       periodic=periodic)
        slots, spins = slots0, torch.sign(slots0)
        Kp, Lp = -(-K // 4) * 4, -(-L // 128) * 128
        ids = np.arange(K * L, dtype=np.int64).reshape(K, L)
        for s in range(steps):
            bits = np.zeros((B, 1, 2, 1, Kp, Lp), np.uint32)
            bits[:, 0, 0, 0] = rng.integers(0, 2 ** 32, (B, Kp, Lp),
                                            dtype=np.uint32)
            rank = np.stack([rng.permutation(K * L).reshape(K, L)
                             for _ in range(B)]).astype(np.int64)
            bits[:, 0, 1, 0, :K, :L] = rank << 6
            noise = interop.exclusion_noise(bits, K, L, device=dev)
            u = bits_to_uniform(noise[:, 0, 0].to(torch.int64))
            prio = torch.as_tensor((rank << 17) | ids, device=dev)
            slots = exclusion_multi_step(scal, seeds, slots, band, k_steps=1,
                                         dt=dt, periodic=periodic,
                                         bidirectional=bidi, noise=noise)
            spins, _, _ = lgk_step(cfg, params, band, spins, dt,
                                   _inject=(u, prio))
            bad = int((torch.sign(slots) != spins).sum())
            if bad:
                raise AssertionError(f"slot engine vs B3, {what}: step {s}: "
                                     f"spins differ at {bad} slots")
        if torch.equal(spins, torch.sign(slots0)):
            raise AssertionError(f"slot engine vs B3, {what}: no move")
        print(f"slot engine vs B3 B={B} L={L} {what}: equal over {steps} "
              f"steps", flush=True)


def slot_sweeps(outdir: str) -> dict:
    """(b) ``sweep_over_betas(engine='lattice_gas')`` in phase 8's two
    configurations at full size (11 β × 3 runs, L=1000, T=20, obs_dt=0.1,
    every particle tagged): (a) K=1 on ``lg_step``, (b) K=3 on
    ``lgk_step``.  No B3 launch; particle counts kept, occupancy ≤ K; per
    β, m, v_eff and D_eff within 3·(SE_a + SE_b) + 0.02·max(1, |mean b|)
    of phase 8's fused-route numbers (the rule of
    tests/test_golden.py:146-149)."""
    import torch
    from hydrolim_tpu_torch.experiments.particle_beta_sweep import FLAGSHIP
    from hydrolim_tpu_torch.ops.exclusion_kernel import exclusion_multi_step
    from hydrolim_tpu_torch.sweeps.beta_sweep import sweep_over_betas

    walls = {}
    for name, over, route in (
            ("(a) K=1, N=500, sigma=0.005", {}, "lg_step"),
            ("(b) K=3, N=750, sigma=0.002", FLAGSHIP, "lgk_step")):
        exclusion_multi_step.launches = 0
        t0 = time.perf_counter()
        save = sweep_over_betas(
            SLICE_BETAS, n_runs_per_beta=3, ps_kwargs=over or None,
            npz_path=f"{outdir}/slot_sweep.npz", outdir=outdir, seed=0,
            keep_outs=True, plot_result=False, engine="lattice_gas",
            device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        walls[name] = wall
        fused = PHASE8_SWEEPS[name]
        print(f"slot-engine sweep {name}: {wall:.2f} s wall on "
              f"{save['route']} (fused route {fused['wall_s']:.2f} s), "
              f"{exclusion_multi_step.launches} launches of "
              f"exclusion_multi_step", flush=True)
        if str(save["route"]) != route:
            raise AssertionError(f"slot sweep {name} ran {save['route']}")
        if exclusion_multi_step.launches != 0:
            raise AssertionError(f"slot sweep {name} launched B3")
        K = int(save["ps_kwargs"]["site_capacity"])
        spins = save["spins_final"]
        n0 = np.array([o["alive_frames"][0].sum() for outs in save["outs"]
                       for o in outs])
        if not np.array_equal((spins != 0).sum((1, 2)), n0):
            raise AssertionError(f"slot sweep {name}: particle counts "
                                 "changed")
        if (spins != 0).sum(1).max() > K:
            raise AssertionError(f"slot sweep {name}: occupancy above K")
        for q, mean, se in (("m", "m_means", "m_ses"),
                            ("v_eff", "means", "ses"),
                            ("D_eff", "D_means", "D_ses")):
            a, b = np.asarray(save[mean], float), fused[mean]
            tol = (3.0 * (np.asarray(save[se], float) + fused[se])
                   + 0.02 * max(1.0, abs(float(b.mean()))))
            gap = np.abs(a - b)
            print(f"  {q}: slot {np.round(a, 5).tolist()}, fused "
                  f"{np.round(b, 5).tolist()}; max |gap|/tol "
                  f"{float((gap / tol).max()):.3f}", flush=True)
            if not np.all(np.isfinite(a)) or not np.all(gap < tol):
                raise AssertionError(f"slot sweep {name}: {q} off the fused "
                                     f"route: {a} vs {b}, tol {tol}")
    return walls


def anchored_checks(outdir: str) -> dict:
    """(c) The anchored-exits driver at its full default size (K=3,
    L=1000, N=500, 11 β × 3 runs, T=20, obs_dt=0.1, k_on=10, k_off=5,
    k_exit=5) on ``device='cuda'``: every β has exits and fewer than its
    particles; N_final + exits = N_initial per replica (the initial field
    drawn again from the run's seed); every exit on an anchor site; the
    Sₐ fit finite; no B3 launch.  (d) The anchored golden at its own size
    (tests/test_golden.py:213-245): 96 runs, L=128, N=64, T=6, the mean
    exit total within max(4·SE, 1.12) of 8.667."""
    import torch
    from hydrolim_tpu_torch.core.config import ParticleConfig
    from hydrolim_tpu_torch.experiments import anchored_exits
    from hydrolim_tpu_torch.ops.exclusion_kernel import exclusion_multi_step
    from hydrolim_tpu_torch.particles.lattice_gas_k import (
        lgk_init,
        run_lattice_gas_anchored,
    )
    from hydrolim_tpu_torch.sweeps import beta_sweep
    from hydrolim_tpu_torch.sweeps.ensemble import (
        broadcast_params,
        ensemble_dt,
    )

    out = {}
    exclusion_multi_step.launches = 0
    t0 = time.perf_counter()
    res = anchored_exits.main(outdir=outdir, device="cuda")
    torch.cuda.synchronize()
    out["anchored-exits driver"] = wall = time.perf_counter() - t0
    ps = anchored_exits.anchored_ps_kwargs(res["L"], res["N"], res["K"])
    cfg = beta_sweep.config_from_kwargs(ps)
    grad = beta_sweep.make_exp_gradient(
        L=res["L"], N=res["N"], frac_plus=0.75, decay_length=0.35,
        anchor_positions=anchored_exits.ANCHORS)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(res["seed"])
    prof = beta_sweep._profiles(cfg, dict(rho0_plus=grad[0],
                                          rho0_minus=grad[1]))
    n0 = (lgk_init(cfg, gen, *prof, B=len(res["n_final"]),
                   device="cuda") != 0).sum((1, 2)).cpu().numpy()
    exits = np.asarray(res["exit_counts"])
    n_beta = len(res["beta_values"])
    per_beta = exits.reshape(n_beta, res["n_runs"]).sum(1)
    on_anchor = cfg.anchor_mask()
    print(f"anchored-exits driver: {wall:.2f} s wall on {res['route']}, "
          f"{exclusion_multi_step.launches} launches of "
          f"exclusion_multi_step; exits per beta {per_beta.tolist()}; "
          f"total mean {np.round(res['total_mean'], 2).tolist()}; S_a "
          f"{np.round(res['S_fits'], 5).tolist()}", flush=True)
    if res["route"] != "lgk_step anchored" or \
            exclusion_multi_step.launches != 0:
        raise AssertionError("the anchored driver left the anchored engine")
    if not np.all(per_beta > 0) or not np.all(exits < n0):
        raise AssertionError(f"exits per beta {per_beta}, per replica "
                             f"{exits} of {n0}")
    if not np.array_equal(np.asarray(res["n_final"]) + exits, n0):
        raise AssertionError("N_final + exits != N_initial: "
                             f"{res['n_final']} + {exits} vs {n0}")
    if not all(on_anchor[np.asarray(e, int)].all()
               for e in res["exit_sites"]):
        raise AssertionError("an exit off the anchor sites")
    if not np.all(np.isfinite(res["S_fits"])):
        raise AssertionError(f"S_a fit not finite: {res['S_fits']}")

    L, N, n_runs, T = 128, 64, 96, 6.0
    anchors = (0.25, 0.60, 0.80)
    gcfg = ParticleConfig(L=L, xlim=1, N=N, init="poisson",
                          scale_rates=False, local_kernel_sigma=0.02,
                          periodic=False, site_capacity=3,
                          active_model="plus_forward", minus_anchor=True,
                          immobilize_when_anchored=True,
                          anchor_positions=anchors, anchor_radius=0.01,
                          exit_buffer=N)
    g = beta_sweep.make_exp_gradient(L=L, N=N, frac_plus=0.75,
                                     decay_length=0.35,
                                     anchor_positions=anchors)
    rates = dict(rate_diffusion=0.02, rate_active=2.0, k_on=10.0,
                 k_off=5.0, k_exit=5.0)
    t0 = time.perf_counter()
    _, _, (ec, _, _) = run_lattice_gas_anchored(
        gcfg, broadcast_params(gcfg, beta=[0.7], n_runs=n_runs,
                               device="cuda", **rates),
        T=T, obs_dt=0.5, dt=ensemble_dt(gcfg, beta_max=0.7, **rates),
        seed=33, device="cuda", rho0_plus=g[2], rho0_minus=g[3])
    counts = ec.cpu().numpy().astype(float)
    out["anchored golden"] = time.perf_counter() - t0
    mean, se = counts.mean(), counts.std(ddof=1) / np.sqrt(n_runs)
    print(f"anchored golden: {out['anchored golden']:.2f} s wall; exits "
          f"{mean:.3f} ± {se:.3f} (golden 8.667, tolerance "
          f"{max(4 * se, 1.12):.3f})", flush=True)
    if not (abs(mean - 8.667) < max(4.0 * se, 1.12) and 0 < mean < N):
        raise AssertionError(f"anchored golden {mean} ± {se} off 8.667")
    return out


def slot_step_rates(dev, b3_us: float) -> dict:
    """The slot engine's step at the sweep's shape, configuration (b):
    B=33, K=3, L=1000, σ=0.002 (17 taps), the exp-gradient Poisson
    init, β over [0, 3], rd=0.02, ra=5, the sweep's Δt; and the K=1
    step at (a)'s (σ=0.005, 41 taps).  Wall per step by CUDA events over
    200 steps after 5 warm-up steps; launches per step and the device's
    busy time from ``torch.profiler`` over 20 steps (the kernels it
    records on the card)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from hydrolim_tpu_torch.experiments.particle_beta_sweep import FLAGSHIP
    from hydrolim_tpu_torch.ops.exclusion_kernel import build_smoothing_band
    from hydrolim_tpu_torch.particles.lattice_gas import lg_init, lg_step
    from hydrolim_tpu_torch.particles.lattice_gas_k import lgk_init, lgk_step
    from hydrolim_tpu_torch.sweeps import beta_sweep
    from hydrolim_tpu_torch.sweeps.ensemble import (
        broadcast_params,
        ensemble_dt,
    )

    out = {}
    for tag, over, init, step in (
            ("lgk_step (b) B=33 K=3", FLAGSHIP, lgk_init, lgk_step),
            ("lg_step (a) B=33 K=1", {}, lg_init, lg_step)):
        ps = dict(beta_sweep.DEFAULT_PS_KWARGS, **over)
        cfg = beta_sweep.config_from_kwargs(ps)
        grad = beta_sweep.make_exp_gradient(
            L=cfg.L, N=cfg.N, frac_plus=0.75, decay_length=0.35,
            anchor_positions=None)
        rates = dict(rate_diffusion=0.02, rate_active=5.0)
        params = broadcast_params(cfg, beta=SLICE_BETAS, n_runs=3,
                                  device=dev, **rates)
        dt = ensemble_dt(cfg, beta_max=3.0, **rates)
        gen = torch.Generator(device=dev)
        gen.manual_seed(4)
        state = [init(cfg, gen, grad[2], grad[3], B=33, device=dev)]
        band = build_smoothing_band(cfg, dev)

        def one():
            state[0] = step(cfg, params, band, state[0], dt,
                            generator=gen)[0]

        for _ in range(5):
            one()
        us = cuda_ms(one, reps=200) * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                one()
            torch.cuda.synchronize()
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        launches = [e for e in prof.events()
                    if e.name in ("cudaLaunchKernel", "cuLaunchKernel")]
        busy_us = sum(e.device_time_total for e in kernels) / 20 if kernels \
            else float("nan")
        row = dict(us_per_step=us, kernels_per_step=len(kernels) / 20,
                   launch_calls_per_step=len(launches) / 20,
                   device_busy_us_per_step=busy_us)
        out[tag] = row
        print(f"{tag}: {us:.1f} us/step (CUDA events, 200 steps), "
              f"{row['kernels_per_step']:.1f} kernels and "
              f"{row['launch_calls_per_step']:.1f} launch calls per step, "
              f"{busy_us:.1f} us/step of device time (torch.profiler, 20 "
              f"steps: "
              + (f"{1 - busy_us / us:.1%} idle" if kernels else
                 "no device events, not measured")
              + f"); B3 at B=33 K=3: {b3_us:.3f} us/step (phase 9)",
              flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 16: the general τ-leap engine (plain torch)
# ---------------------------------------------------------------------------

# (a)'s configurations: ParticleConfig fields beyond L=1000, the fixed
# init, K=3, and the anchor rates where there are anchors
TAU_LEAP_CHECKS = (
    ("K=1, global m, periodic, bidirectional",
     dict(site_capacity=1, N=500, local_kernel_sigma=0.0, periodic=True,
          active_model="bidirectional")),
    ("K=3, local m sigma=0.002, periodic, bidirectional",
     dict(N=1500, local_kernel_sigma=0.002, periodic=True,
          active_model="bidirectional")),
    ("K=3, local m sigma=0.005, walls, plus_forward",
     dict(N=1500, local_kernel_sigma=0.005, periodic=False)),
    ("K=3, anchors bind/unbind/exit, walls, local m sigma=0.002",
     dict(N=600, local_kernel_sigma=0.002, periodic=False,
          anchor_positions=(0.25, 0.6, 0.8), anchor_radius=0.01,
          exit_buffer=600)),
    ("K=12, global m, periodic (the sort path)",
     dict(site_capacity=12, N=6000, local_kernel_sigma=0.0,
          periodic=True)),
)


def check_tau_leap_step(dev) -> None:
    """(a) The τ-leap step on the card against the step on the CPU from the
    same state at the same injected (u, bits): B=33, L=1000, β over [0, 3],
    rd=1, ra=3 (anchors: k_on=20, k_off=2, k_exit=10), Δt=0.005, 200
    steps in each of ``TAU_LEAP_CHECKS``.  Per step the events of both
    (``draw_events``) are compared: where they agree the whole state and
    exit log must be EQUAL; an event that differs must have its u within
    1e-6 of one of its thresholds (an ulp of m or of a flip rate apart),
    and is counted.  The card's state goes on.  Where m is local the
    largest |m_card − m_cpu| (every 10th step) is printed."""
    import torch
    from hydrolim_tpu_torch.core.config import ParticleConfig
    from hydrolim_tpu_torch.ops.segment import occupancy
    from hydrolim_tpu_torch.particles.init import init_particles
    from hydrolim_tpu_torch.particles.stepper import (
        ParticleState,
        build_static_arrays,
        compute_m_field,
        draw_events,
        step,
        with_exit_log,
    )
    from hydrolim_tpu_torch.sweeps.ensemble import broadcast_params

    B, dt, steps = 33, 0.005, 200
    cpu = torch.device("cpu")
    rng = np.random.default_rng(16)
    rates = dict(rate_diffusion=1.0, rate_active=3.0, k_on=20.0, k_off=2.0,
                 k_exit=10.0)
    fields = ("pos", "wind", "sigma", "bound", "alive", "init_bin",
              "exit_count", "exit_times", "exit_pos", "exit_init_bin")
    for what, over in TAU_LEAP_CHECKS:
        cfg = ParticleConfig(**dict(
            dict(L=1000, init="fixed", scale_rates=False, site_capacity=3,
                 active_model="plus_forward"), **over))
        params = {d: broadcast_params(cfg, beta=np.linspace(0, 3, B),
                                      device=d, **rates) for d in (cpu, dev)}
        statics = {d: build_static_arrays(cfg, d) for d in (cpu, dev)}
        gen = torch.Generator().manual_seed(16)
        st = init_particles(cfg, gen, B=B, device="cpu")
        st = with_exit_log(cfg, ParticleState(
            pos=st.pos, sigma=st.sigma, wind=torch.zeros_like(st.pos),
            alive=st.alive))
        state = {d: ParticleState(**{k: v.to(d) for k, v in
                                     st.__dict__.items()})
                 for d in (cpu, dev)}
        n = st.pos.shape[1]
        differ, explained, m_gap, moved = 0, 0, 0.0, 0
        for i in range(steps):
            u = torch.tensor(rng.random((B, n), dtype=np.float32))
            bits = torch.tensor(rng.integers(0, 2 ** 32, (B, n)))
            ev = {d: draw_events(cfg, params[d], statics[d], state[d], dt,
                                 u.to(d))[:2] for d in (cpu, dev)}
            new = {d: step(cfg, params[d], statics[d], state[d], dt,
                           i * dt, _inject=(u.to(d), bits.to(d)))
                   for d in (cpu, dev)}
            diff = ev[cpu][0] != ev[dev][0].cpu()
            if diff.any():
                gap = (u[..., None] - ev[cpu][1]).abs().min(-1).values
                differ += int(diff.sum())
                explained += int((gap[diff] < 1e-6).sum())
            else:
                for k in fields:
                    a, b = getattr(new[cpu], k), getattr(new[dev], k).cpu()
                    same = (torch.equal(a.nan_to_num(-1.0),
                                        b.nan_to_num(-1.0))
                            if a.is_floating_point() else torch.equal(a, b))
                    if not same:
                        raise AssertionError(f"tau-leap card vs CPU, {what}:"
                                             f" step {i}: {k} differs with "
                                             "every event equal")
            if cfg.local_kernel_sigma > 0 and i % 10 == 0:
                m = [compute_m_field(cfg, statics[d], *occupancy(
                    state[d].pos, state[d].sigma, state[d].alive,
                    cfg.L)[1:]).cpu() for d in (cpu, dev)]
                m_gap = max(m_gap, float((m[0] - m[1]).abs().max()))
            moved += int((new[dev].pos != state[dev].pos).sum())
            state = {dev: new[dev], cpu: ParticleState(**{
                k: v.cpu() for k, v in new[dev].__dict__.items()})}
        exits = int(state[dev].exit_count.sum())
        print(f"tau-leap step card vs CPU B={B} L=1000 {what}: {steps} steps"
              f" equal where the events agree; events that differ "
              f"{differ}, with u within 1e-6 of a threshold {explained}"
              + (f"; max |m_card - m_cpu| {m_gap:.3e}"
                 if cfg.local_kernel_sigma > 0 else "")
              + f"; {moved} moves, {exits} exits", flush=True)
        if differ != explained:
            raise AssertionError(f"tau-leap card vs CPU, {what}: "
                                 f"{differ - explained} events differ away "
                                 "from their thresholds")
        if moved == 0 or (cfg.anchor_positions is not None and exits == 0):
            raise AssertionError(f"tau-leap card vs CPU, {what}: no moves "
                                 "or no exits")


# 2-particle exact-π cases (tests/test_native_gillespie.py:246-336):
# (L, K, active model, crowding)
PI_CASES = {"K=1 bidirectional": (4, 1, "bidirectional", False),
            "K=2 crowding": (4, 2, "bidirectional", True)}


def oracle_checks() -> dict:
    """(b) The port's copy of the exact CTMC oracle (g++, built at first
    use) and the τ-leap engine on the card against the exact stationary
    law π of two particles (``runtime.exact``): the oracle over
    T=48,000 (frames every 2, the first tenth burnt) within TV 0.02, the
    τ-leap engine over 1024 replicas (Δt=0.02, T=40, frames every 2, the
    first fifth burnt) within TV 0.035, rd=0.3, ra=0.7, β=1.2."""
    import torch
    from hydrolim_tpu_torch.core.config import (
        ParticleConfig,
        make_particle_params,
    )
    from hydrolim_tpu_torch.runtime.exact import (
        total_variation,
        two_particle_stationary_law,
    )
    from hydrolim_tpu_torch.runtime.native import run_exact_gillespie
    from hydrolim_tpu_torch.sweeps.ensemble import (
        broadcast_params,
        run_particle_ensemble,
    )

    rd, ra, beta = 0.3, 0.7, 1.2
    walls = {}
    for what, (L, K, am, crowding) in PI_CASES.items():
        law = two_particle_stationary_law(L, K, am, rd, ra, beta, crowding)

        def counts_of(cp, cm, burn):
            c = {}
            for b in range(cp.shape[0]):
                for k in range(burn, cp.shape[1]):
                    key = tuple(cp[b, k]) + tuple(cm[b, k])
                    c[key] = c.get(key, 0) + 1
            return c

        cfg = ParticleConfig(L=L, N=2, n_pad=2, init="fixed",
                             scale_rates=False, local_kernel_sigma=0.0,
                             periodic=True, site_capacity=K,
                             active_model=am,
                             crowding_suppresses_rates=crowding)
        t0 = time.perf_counter()
        out = run_exact_gillespie(
            cfg, make_particle_params(cfg, beta=beta, rate_diffusion=rd,
                                      rate_active=ra, k_on=0, k_off=0,
                                      k_exit=0, device="cpu"),
            np.array([0, 2]), np.array([1, -1]), T=48000.0, obs_dt=2.0,
            seed=42)
        t_oracle = time.perf_counter() - t0
        tv_o, unseen_o = total_variation(law, counts_of(
            out["counts_p"][None], out["counts_m"][None],
            out["counts_p"].shape[0] // 10))
        cfg = ParticleConfig(L=L, N=2, n_pad=8, init="fixed",
                             scale_rates=False, local_kernel_sigma=0.0,
                             periodic=True, site_capacity=K,
                             active_model=am,
                             crowding_suppresses_rates=crowding)
        t0 = time.perf_counter()
        f = run_particle_ensemble(
            cfg, broadcast_params(cfg, beta=[beta], rate_diffusion=rd,
                                  rate_active=ra, n_runs=1024,
                                  device="cuda"),
            seed=3, T=40.0, obs_dt=2.0, dt=0.02, record_pos=False,
            device="cuda").frames
        torch.cuda.synchronize()
        walls[f"tau-leap exact-pi {what}"] = t_tau = time.perf_counter() - t0
        cp = np.rint(f.rho_p.cpu().numpy() * 2 / L).astype(int)
        cm = np.rint(f.rho_m.cpu().numpy() * 2 / L).astype(int)
        tv_t, unseen_t = total_variation(law, counts_of(cp, cm, 4))
        print(f"exact pi, {what}: oracle TV {tv_o:.4f} (bound 0.02, "
              f"{out['n_events']} events, {t_oracle:.2f} s); tau-leap on "
              f"the card TV {tv_t:.4f} (bound 0.035, 1024 replicas x 2000 "
              f"steps, {t_tau:.2f} s)", flush=True)
        if not (tv_o < 0.02 and unseen_o == 0 and tv_t < 0.035
                and unseen_t == 0):
            raise AssertionError(f"exact pi, {what}: TV {tv_o}, {tv_t}")
    return walls


def golden_rule(name: str, a, b, se_a, se_b) -> float:
    """max gap/tolerance of a against b per β, the rule of
    tests/test_golden.py:146: gap < 3·(se_a + se_b) + 0.02·max(1, |mean b|);
    raises past it."""
    a, b = np.asarray(a, float), np.asarray(b, float)
    tol = (3.0 * (np.asarray(se_a, float) + np.asarray(se_b, float))
           + 0.02 * max(1.0, abs(float(b.mean()))))
    ratio = np.abs(a - b) / tol
    print(f"  {name}: {np.round(a, 5).tolist()} vs "
          f"{np.round(b, 5).tolist()}; gap/tol "
          f"{np.round(ratio, 3).tolist()}", flush=True)
    if not (np.all(np.isfinite(a)) and np.all(ratio < 1.0)):
        raise AssertionError(f"{name} off the golden rule: {a} vs {b}")
    return float(ratio.max())


def tau_leap_sweep(outdir: str) -> dict:
    """(c) Path (ii): ``sweep_over_betas(engine='particle')`` in phase 8's
    configuration (b) at full size (11 β × 3 runs, K=3, N=750, σ=0.002,
    L=1000, T=20, obs_dt=0.1, 5,174 steps): the τ-leap route, no B3
    launch; m, v_eff and D_eff per β within the golden rule of phase 8's
    fused numbers."""
    import torch
    from hydrolim_tpu_torch.experiments.particle_beta_sweep import FLAGSHIP
    from hydrolim_tpu_torch.ops.exclusion_kernel import exclusion_multi_step
    from hydrolim_tpu_torch.sweeps.beta_sweep import sweep_over_betas

    name = "(b) K=3, N=750, sigma=0.002"
    exclusion_multi_step.launches = 0
    t0 = time.perf_counter()
    save = sweep_over_betas(
        SLICE_BETAS, n_runs_per_beta=3, ps_kwargs=FLAGSHIP,
        npz_path=f"{outdir}/tau_leap_sweep.npz", outdir=outdir, seed=0,
        plot_result=False, engine="particle", device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fused = PHASE8_SWEEPS[name]
    print(f"tau-leap sweep (ii) {name}: {wall:.2f} s wall on "
          f"{save['route']} (fused route {fused['wall_s']:.2f} s), "
          f"{exclusion_multi_step.launches} launches of "
          f"exclusion_multi_step; golden rule against the fused route:",
          flush=True)
    if str(save["route"]) != "tau_leap" or exclusion_multi_step.launches:
        raise AssertionError("path (ii) left the tau-leap step")
    for q, mean, se in (("m", "m_means", "m_ses"),
                        ("v_eff", "means", "ses"),
                        ("D_eff", "D_means", "D_ses")):
        golden_rule(q, save[mean], fused[mean], save[se], fused[se])
    return {"path (ii) sweep": wall}


def tau_leap_structure(outdir: str) -> tuple:
    """(d) Path (i): the local-structure CLI at its full default size
    (11 β × 3 runs, L=1000, N=900, K=1, walls, σ=0.005, T=40, obs_dt=1,
    9,828 steps) on ``engine='particle'`` (the τ-leap step, no B3 launch)
    and on ``'pallas'`` (B3): the npz written (figures skipped without
    matplotlib); per β m_local_var_mean, low_k_power_mean and var_mean of
    the two within the golden rule; m_local_var_mean at β=3 above 3× its
    value at β=0 on both."""
    import os

    import torch
    from hydrolim_tpu_torch.experiments import particle_local_structure
    from hydrolim_tpu_torch.ops.exclusion_kernel import exclusion_multi_step

    res, walls, launches = {}, {}, {}
    for engine in ("particle", "pallas"):
        sub = f"{outdir}/structure_{engine}"
        exclusion_multi_step.launches = 0
        t0 = time.perf_counter()
        res[engine] = particle_local_structure.main(outdir=sub,
                                                    engine=engine,
                                                    device="cuda")
        torch.cuda.synchronize()
        walls[f"path (i) structure {engine}"] = time.perf_counter() - t0
        launches[engine] = exclusion_multi_step.launches
        if not os.path.exists(f"{sub}/{particle_local_structure.NPZ}"):
            raise AssertionError(f"structure sweep {engine}: no npz")
    print(f"tau-leap structure (i): 'particle' "
          f"{walls['path (i) structure particle']:.2f} s wall, "
          f"{launches['particle']} B3 launches; 'pallas' "
          f"{walls['path (i) structure pallas']:.2f} s, {launches['pallas']}"
          f" B3 launches; golden rule per beta:", flush=True)
    if launches["particle"] or not launches["pallas"]:
        raise AssertionError(f"structure routes launched B3 {launches}")
    betas = sorted(res["particle"])
    col = lambda e, k: np.array([res[e][b][k] for b in betas])
    for q in ("m_local_var", "low_k_power", "var"):
        golden_rule(q, col("particle", f"{q}_mean"), col("pallas",
                                                         f"{q}_mean"),
                    col("particle", f"{q}_se"), col("pallas", f"{q}_se"))
    for e in res:
        mv = col(e, "m_local_var_mean")
        print(f"  {e}: m_local_var beta=0 {mv[0]:.4f}, beta=3 {mv[-1]:.4f}",
              flush=True)
        if not mv[-1] > 3.0 * mv[0]:
            raise AssertionError(f"{e}: m_local_var does not grow: {mv}")
    return walls, launches["pallas"]


def tau_leap_step_rates() -> dict:
    """(e) The τ-leap step at both paths' shapes
    (``experiments/profile_tau_leap_step.py``): µs per step by CUDA events
    over 200 steps, kernels and launch calls per step and the device's busy
    share from ``torch.profiler`` over 20 steps."""
    from hydrolim_tpu_torch.experiments import profile_tau_leap_step

    rows = {}
    for shape in profile_tau_leap_step.SHAPES:
        r = profile_tau_leap_step.time_step(shape, "cuda")
        rows[shape] = r
        print(f"tau-leap step, {shape} (B={r['B']}, n_buf={r['n_buf']}): "
              f"{r['us_per_step']:.1f} us/step (CUDA events, 200 steps), "
              f"{r['kernels_per_step']:.1f} kernels and "
              f"{r['launch_calls_per_step']:.1f} launch calls per step, "
              f"{r['device_busy_us_per_step']:.1f} us/step of device time "
              f"(busy {r['device_busy_share']:.1%}; torch.profiler, 20 "
              f"steps)", flush=True)
    return rows


# ---------------------------------------------------------------------------
# phase 17: chunked checkpoint/resume on every route
# ---------------------------------------------------------------------------

# the runs in one piece of earlier phases, reused where phase 17 repeats
# them at the same seed: phase 10's single run, phase 11's mean-field run
# on B1, phase 13's double sweep
RUNS_IN_ONE_PIECE: dict = {}

# ``pde_single_run``'s facade (sweeps/pde_sweeps.py): IMEX_PDE_solver_run.py
SINGLE_RUN = dict(L=1000, T=20.0, dt=5e-4, gamma=0.0, lam=0.6, beta=2.0,
                  bc="periodic", active_model="bidirectional",
                  gaussian_kernel=True, kernel_sigma=0.005,
                  snapshot_interval=50, seed=58, device="cuda")

# A child process that runs the fused sweep (a) with a checkpoint
# directory; it imports the port only.  argv: repo root, outdir, ckpt_dir.
KILL_CHILD = """
import sys
sys.path.insert(0, sys.argv[1])
import numpy as np
from hydrolim_tpu_torch.sweeps.beta_sweep import sweep_over_betas
print("READY", flush=True)
sweep_over_betas(np.linspace(0.0, 3.0, 11), n_runs_per_beta=3,
                 npz_path=sys.argv[2] + "/child.npz", outdir=sys.argv[2],
                 seed=0, do_fit=False, plot_result=False, engine="fused",
                 device="cuda", ckpt_dir=sys.argv[3])
print("DONE", flush=True)
"""


def count_diff(want, got, what: str) -> tuple:
    """(elements that differ, elements compared) between two results,
    field by field and element by element (NaN equals NaN); raises where
    the two differ in structure, shape or dtype."""
    if isinstance(want, dict):
        if sorted(want) != sorted(got):
            raise AssertionError(f"{what}: keys {sorted(want)} != "
                                 f"{sorted(got)}")
        parts = [count_diff(want[k], got[k], f"{what}.{k}") for k in want]
    elif isinstance(want, (list, tuple)):
        if len(want) != len(got):
            raise AssertionError(f"{what}: length {len(want)} != "
                                 f"{len(got)}")
        parts = [count_diff(a, b, f"{what}[{i}]")
                 for i, (a, b) in enumerate(zip(want, got))]
    elif want is None or got is None:
        if not (want is None and got is None):
            raise AssertionError(f"{what}: {want!r} against {got!r}")
        parts = []
    else:
        a, b = np.asarray(want), np.asarray(got)
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"{what}: {a.dtype}{a.shape} against "
                                 f"{b.dtype}{b.shape}")
        if a.dtype.kind in "fc":
            same = (a == b) | (np.isnan(a) & np.isnan(b))
        else:
            same = a == b
        return int(np.size(same) - np.count_nonzero(same)), int(a.size)
    return (sum(p[0] for p in parts), sum(p[1] for p in parts))


def _as_numpy(x):
    """A result's tensors and dataclasses as numpy arrays and dicts."""
    import dataclasses

    import torch

    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if hasattr(x, "_asdict"):
        return {k: _as_numpy(v) for k, v in x._asdict().items()}
    if dataclasses.is_dataclass(x):
        return {f.name: _as_numpy(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, (list, tuple)):
        return [_as_numpy(v) for v in x]
    return x


def ckpt_route(name: str, one_piece, stop, resume, kernels: dict) -> dict:
    """One route of phase 17: ``one_piece()`` gives the run in one piece
    and its wall (None where an earlier phase's run is reused);
    ``stop()`` runs the checkpointed call with ``stop_after_chunks=1``,
    which must return None; ``resume()`` is a fresh call on the same
    directory.  Prints both walls, the bytes written and the seconds spent
    in writes (wall and process CPU), and the count of elements of the
    stitched result that differ from the run in one piece, which must be
    0.  Returns the kernels' launches in the checkpointed calls (counts
    set to 0 just before them)."""
    import torch
    from hydrolim_tpu_torch.utils.checkpoint import (
        WRITE_STATS,
        reset_write_stats,
    )

    want, wall_one = one_piece()
    for k in kernels.values():
        k.launches = 0
    reset_write_stats()
    t0 = time.perf_counter()
    halted = stop()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    if halted is not None:
        raise AssertionError(f"{name}: stop_after_chunks=1 returned a "
                             "result")
    got = resume()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = {n: k.launches for n, k in kernels.items()}
    w = dict(WRITE_STATS)
    n_diff, n_all = count_diff(_as_numpy(want), _as_numpy(got), name)
    one = ("reused from its phase" if wall_one is None
           else f"{wall_one:.3f} s")
    print(f"checkpoint {name}: in one piece {one}; checkpointed "
          f"{t2 - t0:.3f} s (stopped after 1 chunk {t1 - t0:.3f} s + "
          f"resumed {t2 - t1:.3f} s); {w['bytes']} bytes in {w['files']} "
          f"files; writes: savez_compressed {w['save_s']:.3f} s wall, "
          f"{w['save_cpu_s']:.3f} s CPU, waiting for each chunk's device "
          f"work and copy {w['fetch_s']:.3f} s, renames "
          f"{w['rename_s']:.4f} s; "
          f"{n_diff} of {n_all} elements differ; launches {launches}",
          flush=True)
    if n_diff:
        raise AssertionError(f"{name}: {n_diff} elements differ from the "
                             "run in one piece")
    if not w["files"]:
        raise AssertionError(f"{name}: nothing was written")
    return dict(launches=launches, wall_one_s=wall_one,
                wall_ckpt_s=t2 - t0, bytes=w["bytes"],
                save_s=w["save_s"], save_cpu_s=w["save_cpu_s"],
                got=got)


def _wall(fn):
    import torch

    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


DOUBLE_KEYS = ("C0", "C1", "C2", "C0_err", "C1_err", "C2_err", "f_fit",
               "g_fit", "per_N")
SWEEP_KEYS = ("outs", "means", "stds", "ses", "D_means", "D_ses",
              "m_means", "m_stds", "m_ses", "rho_means", "rho_ses",
              "block_means", "block_ses", "dt", "route", "spins_final")


def kill_and_resume(outdir: str, want: dict) -> dict:
    """The fused sweep (a) in a child process, killed by SIGKILL once two
    of its four chunks are on disk, then resumed in this process: equal to
    the sweep in one piece."""
    import os
    import signal

    import torch
    from hydrolim_tpu_torch.ops.exclusion_kernel import exclusion_multi_step
    from hydrolim_tpu_torch.sweeps.beta_sweep import sweep_over_betas

    ck = f"{outdir}/kill_ck"
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    child = subprocess.Popen([sys.executable, "-c", KILL_CHILD, root,
                              outdir, ck], stdout=subprocess.PIPE, text=True)
    try:
        if child.stdout.readline().strip() != "READY":
            raise AssertionError("the child did not start")
        deadline = time.perf_counter() + 300
        while not os.path.exists(f"{ck}/chunk_00001.npz"):
            if child.poll() is not None or time.perf_counter() > deadline:
                raise AssertionError("the child ended or stalled before "
                                     "its second chunk")
            time.sleep(0.005)
        child.send_signal(signal.SIGKILL)
        child.wait(timeout=60)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    t_kill = time.perf_counter() - t0
    on_disk = sorted(os.listdir(ck))
    exclusion_multi_step.launches = 0
    t0 = time.perf_counter()
    got = sweep_over_betas(
        SLICE_BETAS, n_runs_per_beta=3, npz_path=f"{outdir}/kill.npz",
        outdir=outdir, seed=0, keep_outs=True, do_fit=False,
        plot_result=False, engine="fused", device="cuda", ckpt_dir=ck)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_diff, n_all = count_diff(_as_numpy({k: want[k] for k in SWEEP_KEYS}),
                               _as_numpy({k: got[k] for k in SWEEP_KEYS}),
                               "killed sweep (a)")
    print(f"checkpoint SIGKILL, sweep (a): the child killed after "
          f"{t_kill:.2f} s with {on_disk} on disk (exit code "
          f"{child.returncode}); resumed here in {wall:.3f} s with "
          f"{exclusion_multi_step.launches} launches of "
          f"exclusion_multi_step; {n_diff} of {n_all} elements differ",
          flush=True)
    if child.returncode != -signal.SIGKILL or n_diff:
        raise AssertionError("the killed sweep did not resume equal")
    return {"checkpoint SIGKILL resume (a)": exclusion_multi_step.launches}


def checkpoint_routes(outdir: str) -> dict:
    """Phase 17: on each route, the run in one piece, the checkpointed run
    stopped after one chunk (``stop_after_chunks=1``, the call returns
    None), a fresh call resuming on the same directory, and the count of
    elements of the stitched result that differ (0 on every route):
    - B3: ``sweep_over_betas(engine='fused', ckpt_dir=)`` in phase 8's
      configurations (a) and (b) (B=33, L=1000, 199 frames, chunks of
      64); the per-β m, v_eff and D_eff and every replica's frames;
    - B1: ``ParticleSystem.run_checkpointed`` in phase 11's mean-field
      configuration (N=5000, L=256, 60 frames, chunks of 16) against
      phase 11's run;
    - B2: ``IMEXPDE.solve_checkpointed`` through ``pde_single_run`` at the
      single run's size (40,000 steps, 501 bins; chunks of 125 blocks of
      50 steps, so the split at step 6,250 is not a multiple of the
      100-step tracer window) against phase 10's run, and
      ``run_pde_ensemble(ckpt_dir=)`` at magn2's shape (B=5, σ=0.05,
      20,000 steps, chunks of 8 blocks of 2,000);
    - the plain-torch engines at full width, 20 frames deep (chunks of
      8): ``sweep_over_betas(engine='particle', ckpt_dir=)`` on path (ii)
      (configuration (b)) and ``run_lattice_gas_k_checkpointed`` at phase
      15's shape (K=3, B=33, L=1000); no B3 launch;
    - ``double_sweep_fused(engine='pallas', ckpt_dir=)`` at full size: the
      chunk ledger, C0, C1 and C2 equal phase 13's;
    - one real SIGKILL of the fused sweep (a) in a child process.
    Returns each kernel's launches per path."""
    import shutil

    from hydrolim_tpu_torch import IMEXPDE, ParticleSystem
    from hydrolim_tpu_torch.core.config import PDEConfig
    from hydrolim_tpu_torch.experiments.cross_engine_validation import (
        GAMMA,
        LAM,
    )
    from hydrolim_tpu_torch.experiments.particle_beta_sweep import FLAGSHIP
    from hydrolim_tpu_torch.ops.exclusion_kernel import exclusion_multi_step
    from hydrolim_tpu_torch.ops.pde_kernel import pde_multi_step, pde_spectra
    from hydrolim_tpu_torch.ops.stepper_kernel import meanfield_multi_step
    from hydrolim_tpu_torch.particles.lattice_gas_k import run_lattice_gas_k
    from hydrolim_tpu_torch.sweeps.beta_sweep import (
        DEFAULT_PS_KWARGS,
        config_from_kwargs,
        make_exp_gradient,
        sweep_over_betas,
    )
    from hydrolim_tpu_torch.sweeps.double_sweep import double_sweep_fused
    from hydrolim_tpu_torch.sweeps.ensemble import (
        broadcast_params,
        ensemble_dt,
    )
    from hydrolim_tpu_torch.sweeps.pde_sweeps import (
        pde_single_run,
        run_pde_ensemble,
    )
    from hydrolim_tpu_torch.utils.checkpoint import (
        pde_solve_checkpointed,
        run_lattice_gas_k_checkpointed,
        run_particles_checkpointed,
    )

    kernels = {"meanfield_multi_step": meanfield_multi_step,
               "pde_multi_step": pde_multi_step,
               "pde_spectra": pde_spectra,
               "exclusion_multi_step": exclusion_multi_step}
    per_path = {name: {} for name in kernels}
    t_phase = time.perf_counter()

    n_routes = []

    def route(name, one_piece, stop, resume, *, expect, none=()):
        n_routes.append(name)
        d = f"{outdir}/ck{len(n_routes)}"
        row = ckpt_route(name, one_piece, lambda: stop(d),
                         lambda: resume(d), kernels)
        shutil.rmtree(d, ignore_errors=True)
        for k in expect:
            if row["launches"][k] <= 0:
                raise AssertionError(f"{name}: {k} never launched")
            per_path[k][f"checkpoint {name}"] = row["launches"][k]
        for k in none:
            if row["launches"][k]:
                raise AssertionError(f"{name}: {k} launched")
        return row

    # -- B3: the fused sweep in phase 8's two configurations --------------
    def sweep(over, engine="fused", **kw):
        save = sweep_over_betas(
            SLICE_BETAS, n_runs_per_beta=3, ps_kwargs=over or None,
            npz_path=f"{outdir}/sweep.npz", outdir=outdir, seed=0,
            keep_outs=True, do_fit=False, plot_result=False, engine=engine,
            device="cuda", **kw)
        return None if save is None else {k: save[k] for k in SWEEP_KEYS
                                          if k in save}

    sweep_a = None
    for label, over in (("sweep (a) fused", {}),
                        ("sweep (b) fused", FLAGSHIP)):
        row = route(label, lambda: _wall(lambda: sweep(over)),
                    lambda d: sweep(over, ckpt_dir=d, stop_after_chunks=1),
                    lambda d: sweep(over, ckpt_dir=d),
                    expect=("exclusion_multi_step",))
        sweep_a = sweep_a or row["got"]
    per_path["exclusion_multi_step"].update(kill_and_resume(outdir, sweep_a))

    # -- B1: ParticleSystem in phase 11's mean-field configuration --------
    def b1_system():
        return ParticleSystem(
            L=256, xlim=1, rate_diffusion=GAMMA * 256 ** 2,
            rate_active=LAM * 256, beta=2.0, init="fixed", N=5000,
            scale_rates=False, local_kernel_sigma=0.0, periodic=True,
            site_capacity=None, active_model="bidirectional", rng=1,
            device="cuda")

    def b1_stop(d):
        ps = b1_system()
        state0 = ps.init_particles()          # the draws of run()
        return run_particles_checkpointed(
            ps.config, ps.params, state0, T=30.0, obs_dt=0.5, dt=ps.dt,
            ckpt_dir=d, chunk_frames=16, record_pos=ps.record_pos,
            record_fft=False, seed=ps._next_seed(), stop_after_chunks=1)

    mf = RUNS_IN_ONE_PIECE.get("mean-field")
    route("ParticleSystem mean-field (B1)",
          (lambda: (mf, None)) if mf is not None else
          (lambda: _wall(lambda: b1_system().run(T=30.0, obs_dt=0.5))),
          b1_stop,
          lambda d: b1_system().run_checkpointed(T=30.0, obs_dt=0.5,
                                                 ckpt_dir=d,
                                                 chunk_frames=16),
          expect=("meanfield_multi_step",))

    # -- B2: the single run through the facade, the magn2 ensemble -------
    def facade():
        s = IMEXPDE(outdir=f"{outdir}/single", **SINGLE_RUN)
        s.initialize(mode="homogeneous", rho0=1.0, noise=0.3)
        return s

    def single_stop(d):
        s = facade()
        assert 125 * 50 % s.config.tracer_window   # a split off the window
        return pde_solve_checkpointed(
            s._solve_config(), s.params, s.rho_p, s.rho_m, s.tracers,
            s.generator, ckpt_dir=d, chunk_blocks=125, stop_after_chunks=1)

    single = RUNS_IN_ONE_PIECE.get("single run")
    route("IMEXPDE single run (B2)",
          (lambda: (single, None)) if single is not None else
          (lambda: _wall(lambda: pde_single_run(
              outdir=f"{outdir}/single", device="cuda"))),
          single_stop,
          lambda d: pde_single_run(outdir=f"{outdir}/single", ckpt_dir=d,
                                   device="cuda"),
          expect=("pde_multi_step", "pde_spectra"))

    magn2 = PDEConfig(L=1000, T=10.0, dt=5e-4, bc="periodic",
                      active_model="bidirectional", gaussian_kernel=True,
                      kernel_sigma=0.05, snapshot_interval=2000, fft_kmax=8)
    ens = dict(gamma=0.2, lam=0.6, n_runs=5, seed=100, n_tracers=1000,
               device="cuda", fetch_snapshots=False)
    route("PDE ensemble magn2 (B2)",
          lambda: _wall(lambda: run_pde_ensemble(magn2, [0.75], **ens)[0]),
          lambda d: run_pde_ensemble(magn2, [0.75], ckpt_dir=d,
                                     stop_after_chunks=1, **ens),
          lambda d: run_pde_ensemble(magn2, [0.75], ckpt_dir=d, **ens)[0],
          expect=("pde_multi_step", "pde_spectra"))

    # -- the plain-torch engines, 20 frames deep --------------------------
    short = dict(T=2.0, obs_dt=0.1)
    route("sweep (b) particle, path (ii)",
          lambda: _wall(lambda: sweep(FLAGSHIP, "particle",
                                      run_kwargs=short)),
          lambda d: sweep(FLAGSHIP, "particle", run_kwargs=short,
                          ckpt_dir=d, chunk_frames=8, stop_after_chunks=1),
          lambda d: sweep(FLAGSHIP, "particle", run_kwargs=short,
                          ckpt_dir=d, chunk_frames=8),
          expect=(), none=("exclusion_multi_step",))
    ps = dict(DEFAULT_PS_KWARGS, **FLAGSHIP)
    config = config_from_kwargs(ps)
    rates = dict(rate_diffusion=float(ps["rate_diffusion"]),
                 rate_active=float(ps["rate_active"]))
    grad = make_exp_gradient(L=config.L, N=config.N, frac_plus=0.75,
                             decay_length=0.35, anchor_positions=None)
    params = broadcast_params(config, beta=SLICE_BETAS, n_runs=3,
                              device="cuda", **rates)
    lgk = dict(short, dt=ensemble_dt(config, beta_max=3.0, **rates), seed=0,
               device="cuda", rho0_plus=grad[2], rho0_minus=grad[3],
               n_tracers=config.n_buf)
    route("lgk_step, phase 15's shape",
          lambda: _wall(lambda: run_lattice_gas_k(config, params, **lgk)),
          lambda d: run_lattice_gas_k_checkpointed(
              config, params, ckpt_dir=d, chunk_frames=8,
              stop_after_chunks=1, **lgk),
          lambda d: run_lattice_gas_k_checkpointed(
              config, params, ckpt_dir=d, chunk_frames=8, **lgk),
          expect=(), none=("exclusion_multi_step",))

    # -- the double sweep's chunk ledger ----------------------------------
    def double(**kw):
        res = double_sweep_fused(
            np.linspace(0, 3, 11), np.linspace(50, 950, 19),
            n_runs_per_beta=4, run_kwargs=dict(T=10, obs_dt=0.1),
            outdir=f"{outdir}/double", seed=0, plot_result=False,
            engine="pallas", device="cuda", **kw)
        return None if res is None else {k: res[k] for k in DOUBLE_KEYS}

    ds = RUNS_IN_ONE_PIECE.get("double sweep")
    row = route("double sweep ledger (B3)",
                (lambda: (ds, None)) if ds is not None else
                (lambda: _wall(double)),
                lambda d: double(ckpt_dir=d, stop_after_chunks=1),
                lambda d: double(ckpt_dir=d),
                expect=("exclusion_multi_step",))
    print(f"  double sweep resumed: C0 {row['got']['C0']:.6f}, C1 "
          f"{row['got']['C1']:.6f}, C2 {row['got']['C2']:.6f}", flush=True)
    print(f"phase 17 took {time.perf_counter() - t_phase:.2f} s",
          flush=True)
    return per_path


# ---------------------------------------------------------------------------
# phase 18: the single-card drivers
# ---------------------------------------------------------------------------

def critical_scaling_full(outdir: str) -> dict:
    """The critical-scaling driver's ``main()`` at full size on the card:
    N ∈ {1024, 4096, 16384} × β ∈ {0.5, 1.0} × 32 runs (B=64), L=8, zero
    motion rates, T = 8√N, 200 frames.  Its own asserts hold the slopes.
    It must run on B1 (launches > 0) and take no step of the torch fast
    path or the τ-leap step.  Per N: the wall, B1's launches and device
    time (CUDA events around each launch) and its share of the wall."""
    import torch
    from hydrolim_tpu_torch.experiments import critical_scaling as cs
    from hydrolim_tpu_torch.ops.pde_kernel import kernel_ms
    from hydrolim_tpu_torch.ops.stepper_kernel import meanfield_multi_step
    from hydrolim_tpu_torch.particles import run as prun

    steps = {"torch": 0, "tau_leap": 0}
    orig = dict(torch=prun._step_meanfield_global, tau_leap=prun.step,
                ens=cs.run_particle_ensemble)

    def counted(name):
        def f(*a, **kw):
            steps[name] += 1
            return orig[name](*a, **kw)
        return f

    per_n = []

    def ensemble(config, *a, **kw):
        n0, e0 = meanfield_multi_step.launches, \
            len(meanfield_multi_step.events)
        t0 = time.perf_counter()
        res = orig["ens"](config, *a, **kw)
        torch.cuda.synchronize()
        per_n.append(dict(
            N=config.N, wall_s=time.perf_counter() - t0,
            launches=meanfield_multi_step.launches - n0,
            kernel_ms=kernel_ms(meanfield_multi_step.events[e0:]),
            route=res.engine))
        return res

    prun._step_meanfield_global = counted("torch")
    prun.step = counted("tau_leap")
    cs.run_particle_ensemble = ensemble
    meanfield_multi_step.launches = 0
    meanfield_multi_step.events = []
    try:
        t0 = time.perf_counter()
        rec = cs.main(["--outdir", outdir, "--device", "cuda"])
        wall = time.perf_counter() - t0
        launches = meanfield_multi_step.launches
        dev_s = kernel_ms(meanfield_multi_step.events) / 1e3
    finally:
        prun._step_meanfield_global = orig["torch"]
        prun.step = orig["tau_leap"]
        cs.run_particle_ensemble = orig["ens"]
        meanfield_multi_step.events = None
    for row in per_n:
        share = row["kernel_ms"] / 1e3 / row["wall_s"]
        print(f"  critical scaling N={row['N']}: {row['wall_s']:.3f} s wall "
              f"({row['route']}), {row['launches']} launches of "
              f"meanfield_multi_step, kernel {row['kernel_ms'] / 1e3:.4f} s "
              f"on the device ({share:.2%} of the wall)", flush=True)
    print(f"critical scaling: slopes {rec['slope_subcritical']:.4f} "
          f"(beta=0.5, bounds (-0.62, -0.38)) and "
          f"{rec['slope_critical']:.4f} (beta=1, bounds (-0.35, -0.15)); "
          f"{wall:.3f} s wall, {launches} launches of meanfield_multi_step, "
          f"kernel {dev_s:.4f} s on the device ({dev_s / wall:.2%} of the "
          f"wall); fast-path steps {steps['torch']}, tau-leap steps "
          f"{steps['tau_leap']}", flush=True)
    if launches <= 0 or any(r["route"] != prun.B1_ROUTE for r in per_n):
        raise AssertionError("critical scaling did not run on B1")
    if steps["torch"] or steps["tau_leap"]:
        raise AssertionError(f"critical scaling stepped off B1: {steps}")
    return dict(wall_s=wall, launches=launches, kernel_s=dev_s,
                slopes=(rec["slope_subcritical"], rec["slope_critical"]))


def convergence_full(outdir: str) -> dict:
    """The convergence driver's ``main()`` at full size on the card: L=128,
    β=1.5, the PDE solution (``pde_step``, plain torch) and six N from 500
    to 16,000 × 8 runs on the torch fast path (Poisson init, outside B1's
    scope).  Its own asserts hold both slopes in (−0.75, −0.25)."""
    from hydrolim_tpu_torch.experiments import convergence
    from hydrolim_tpu_torch.ops.pde_kernel import pde_multi_step
    from hydrolim_tpu_torch.ops.stepper_kernel import meanfield_multi_step

    meanfield_multi_step.launches = pde_multi_step.launches = 0
    t0 = time.perf_counter()
    rec = convergence.main(["--outdir", outdir, "--device", "cuda"])
    wall = time.perf_counter() - t0
    print(f"convergence: slopes m(t) {rec['slope_m']:.4f}, rho(x,T) "
          f"{rec['slope_rho']:.4f} (bounds (-0.75, -0.25)); {wall:.3f} s "
          f"wall: PDE solution {rec['wall_pde_s']:.3f} s, ladder "
          + ", ".join(f"N={n} {w:.3f} s" for n, w in zip(rec["Ns"],
                                                          rec["wall_s"]))
          + f"; B1 launches {meanfield_multi_step.launches}, B2 launches "
          f"{pde_multi_step.launches}", flush=True)
    return dict(wall_s=wall, slopes=(rec["slope_m"], rec["slope_rho"]))


def particle_single_full(outdir: str) -> dict:
    """The flagship single run's driver (``particle_single.main()``, L=1000,
    N=750, K=3, σ=0.002, walls, T=20) on ``engine='particle'`` (the τ-leap
    step) and ``'lattice_gas'`` (the slot engine): the JAX facade's out
    keys, all N ids alive in all 40 frames, occupancy ≤ 3; the drift
    velocity ``plot_individuals`` returns without matplotlib, the wall and
    the step count of each."""
    import torch
    from hydrolim_tpu_torch.experiments import particle_single

    walls = {}
    for engine in ("particle", "lattice_gas"):
        t0 = time.perf_counter()
        out, v = particle_single.main(f"{outdir}/{engine}", engine=engine,
                                      device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        what = f"particle single run (engine={engine!r})"
        if sorted(out) != REF_OUT_KEYS:
            raise AssertionError(f"{what}: out keys {sorted(out)} != "
                                 f"{REF_OUT_KEYS}")
        if len(out["pos_list"]) != 40 or \
                any(len(p) != 750 for p in out["pos_list"]) or \
                (out["alive_frames"].sum(-1) != 750).any():
            raise AssertionError(f"{what}: a particle id was lost")
        occ = max(int(np.bincount(p, minlength=1000).max())
                  for p in out["pos_list"])
        if occ > 3:
            raise AssertionError(f"{what}: occupancy {occ} > K=3")
        if not np.isfinite(v):
            raise AssertionError(f"{what}: drift velocity {v}")
        n_steps = round(20.0 / out["dt_eff"])
        print(f"{what}: {wall:.3f} s wall, {n_steps} steps (dt_eff "
              f"{out['dt_eff']:.4e}, {wall / n_steps * 1e3:.3f} ms per "
              f"step); keys equal the JAX facade's, 750 ids in all 40 "
              f"frames, max occupancy {occ}; COM drift velocity {v:.6f}",
              flush=True)
        walls[engine] = wall
    return walls


def launcher_checks(outdir: str) -> None:
    """``python -m hydrolim_tpu_torch``: ``critical-scaling --small`` in a
    subprocess (rc 0, its JSON read back, its slopes within the bounds),
    then every command's ``--help`` through the launcher's ``main`` in this
    process (rc 0 for all sixteen; sixteen subprocesses would spend
    28–35 s starting up)."""
    from pathlib import Path

    from hydrolim_tpu_torch.__main__ import _COMMANDS

    root = Path(__file__).resolve().parent
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", "hydrolim_tpu_torch", "critical-scaling",
         "--small", "--outdir", outdir], cwd=root, capture_output=True,
        text=True, timeout=300)
    if run.returncode != 0:
        raise AssertionError(f"critical-scaling --small: rc "
                             f"{run.returncode}\n{run.stderr[-2000:]}")
    rec = json.loads((Path(outdir) / "critical_scaling.json").read_text())
    if not (-0.62 < rec["slope_subcritical"] < -0.38
            and -0.35 < rec["slope_critical"] < -0.15):
        raise AssertionError(f"critical-scaling --small slopes {rec}")
    print(f"python -m hydrolim_tpu_torch critical-scaling --small: rc 0 in "
          f"{time.perf_counter() - t0:.2f} s, slopes "
          f"{rec['slope_subcritical']:.4f} / {rec['slope_critical']:.4f}",
          flush=True)

    import io

    from hydrolim_tpu_torch import __main__ as launcher

    def help_rc(cmd):
        """``python -m hydrolim_tpu_torch <cmd> --help`` in this process:
        the launcher's return value, or the driver's exit code."""
        out, argv = io.StringIO(), list(sys.argv)
        try:
            with contextlib.redirect_stdout(out), \
                    contextlib.redirect_stderr(out):
                rc = launcher.main([cmd, "--help"])
        except SystemExit as e:
            rc = e.code or 0
        finally:
            sys.argv = argv
        return cmd, rc, out.getvalue()

    t0 = time.perf_counter()
    results = [help_rc(cmd) for cmd in _COMMANDS]
    for cmd, rc, text in results:
        if rc != 0:
            raise AssertionError(f"{cmd} --help: rc {rc}\n{text[-1000:]}")
    print(f"--help of {len(results)} commands: rc 0 for all; "
          f"{time.perf_counter() - t0:.2f} s", flush=True)


# ---------------------------------------------------------------------------
# phases 3, 4, 7: a launch of rows [b0, b0 + n) (the blocks of a sweep mesh)
# ---------------------------------------------------------------------------

def _rows_equal(what: str, got, whole, rows) -> None:
    for i, (a, b) in enumerate(zip(got, whole)):
        bad = int((a != b[rows]).sum())
        if bad:
            raise AssertionError(f"{what}: output {i} differs from the whole "
                                 f"launch's rows at {bad} of {a.numel()}")


def check_b1_b0(dev) -> None:
    """B1 at the main path's shape (B=33, N=5000, L=256, its rates and dt,
    500 steps, native Philox): the launches of rows [0, 11), [11, 22) and
    [22, 33) with b0 = 0, 11, 22 equal the whole launch's rows bit for
    bit; at injected bits the kernel at b0=11 equals its plain version."""
    import torch
    from hydrolim_tpu_torch.core.config import ParticleConfig
    from hydrolim_tpu_torch.experiments.cross_engine_validation import (
        GAMMA,
        LAM,
    )
    from hydrolim_tpu_torch.ops.stepper_kernel import (
        meanfield_multi_step,
        meanfield_multi_step_plain,
    )
    from hydrolim_tpu_torch.sweeps.ensemble import ensemble_dt

    B, N, L, k = 33, 5000, 256, 500
    rd, ra = GAMMA * L ** 2, LAM * L
    dt = ensemble_dt(ParticleConfig(L=L, N=N, n_pad=N, init="fixed",
                                    scale_rates=False, local_kernel_sigma=0.0,
                                    periodic=True, site_capacity=None,
                                    active_model="bidirectional"),
                     beta_max=3.0, rate_diffusion=rd, rate_active=ra)
    gen = torch.Generator(device=dev)
    gen.manual_seed(19)
    pos = torch.randint(0, L, (B, N), generator=gen, device=dev,
                        dtype=torch.int32)
    sig = torch.randint(0, 2, (B, N), generator=gen, device=dev,
                        dtype=torch.int32) * 2 - 1
    wind = torch.zeros_like(pos)
    scal = torch.tensor([[b, rd, ra] for b in np.linspace(0.0, 3.0, B)],
                        dtype=torch.float32, device=dev)
    seeds = torch.randint(0, 2 ** 31 - 1, (B,), generator=gen, device=dev,
                          dtype=torch.int32)
    kw = dict(L=L, k_steps=k, dt=dt, bidirectional=True, step0=4000)
    whole = meanfield_multi_step(scal, seeds, pos, sig, wind, **kw)
    rows_of = lambda r: [t[r].contiguous() for t in (scal, seeds, pos, sig,
                                                     wind)]
    for b0 in (0, 11, 22):
        rows = slice(b0, b0 + 11)
        _rows_equal(f"B1 rows [{b0}, {b0 + 11})",
                    meanfield_multi_step(*rows_of(rows), b0=b0, **kw),
                    whole, rows)
    rows = slice(11, 22)
    noise = randbits((11, 100, N), gen, dev)
    kw = dict(L=L, k_steps=100, dt=dt, bidirectional=True, noise=noise,
              b0=11)
    got = meanfield_multi_step(*rows_of(rows), **kw)
    want = meanfield_multi_step_plain(*rows_of(rows), **kw)
    _rows_equal("B1 b0=11 kernel vs plain", got, want, slice(None))
    print("B1 b0: rows [0, 11), [11, 22), [22, 33) launched at b0 = 0, 11, "
          "22 equal the whole launch's (500 native steps, B=33, N=5000, "
          "L=256); kernel = plain at b0=11 (100 injected steps)", flush=True)


def check_b2_b0(dev) -> None:
    """B2 at the PDE slice's shape (global m, exact solve, L=1000, 1000
    tracers, B=8, 300 native steps): rows [4, 8) launched at b0=4 equal the
    whole launch's rows bit for bit; at injected bits the kernel at b0=4
    holds its plain version to phase 4's tolerances."""
    import torch
    from hydrolim_tpu_torch.experiments.profile_pde_kernel import b2_inputs
    from hydrolim_tpu_torch.ops.pde_kernel import (
        pde_multi_step,
        pde_multi_step_plain,
    )

    gen = torch.Generator(device=dev)
    gen.manual_seed(19)
    config, _, ops, scal, state = b2_inputs(
        dev, dict(gaussian_kernel=True, kernel_sigma=2e5), dict(B=8), gen)
    seeds = torch.randint(0, 2 ** 31 - 1, (8,), generator=gen, device=dev,
                          dtype=torch.int32)
    kw = dict(b2_kwargs(config, ops), k_steps=300)
    whole = pde_multi_step(scal, seeds, 600, *state, ops[3], ops[2], **kw)
    rows = slice(4, 8)
    part = [t[rows].contiguous() for t in [scal, seeds] + state]
    got = pde_multi_step(part[0], part[1], 600, *part[2:], ops[3], ops[2],
                         b0=4, **kw)
    _rows_equal("B2 rows [4, 8)", got, whole, rows)
    kw = dict(kw, k_steps=100, b0=4,
              noise=randbits((4, 100, 3, config.n_tracers), gen, dev))
    got = pde_multi_step(part[0], part[1], 0, *part[2:], ops[3], ops[2],
                         **kw)
    want = pde_multi_step_plain(part[0], part[1], 0, *part[2:], ops[3],
                                ops[2], **kw)
    errs = [held(f"B2 b0=4 {name}", got[i], want[i], rtol, atol)
            for name, i, rtol, atol in (("rho_p", 0, 2e-4, 1e-7),
                                        ("rho_m", 1, 2e-4, 1e-7),
                                        ("tracer pos", 2, 1e-4, 1e-5))]
    if not torch.equal(got[3], want[3]):
        raise AssertionError("B2 b0=4: tracer spins differ")
    print("B2 b0: rows [4, 8) launched at b0=4 equal the whole launch's "
          "(300 native steps, B=8, L=1000, 1000 tracers); kernel vs plain "
          "at b0=4 (100 injected steps), max |diff| (share of tolerance): "
          + ", ".join(f"{e:.2e} ({s:.3f})" for e, s in errs), flush=True)


def check_b3_b0(dev) -> None:
    """B3 at sweep (b)'s shape (B=33, K=3, L=1000, σ=0.002, walls, 300
    native steps): rows [0, 17) and [17, 33) launched at b0 = 0 and 17
    equal the whole launch's rows bit for bit; at injected bits the kernel
    at b0=17 equals its plain version."""
    import torch
    from hydrolim_tpu_torch.ops.exclusion_kernel import (
        exclusion_multi_step,
        exclusion_multi_step_plain,
    )

    B, K, L = 33, 3, 1000
    gen = torch.Generator(device=dev)
    gen.manual_seed(19)
    slots, band = exclusion_state(dev, gen, B=B, K=K, L=L, sigma=0.002,
                                  periodic=False, N=750)
    scal = torch.stack([torch.linspace(0.0, 3.0, B, device=dev),
                        torch.full((B,), 0.02, device=dev),
                        torch.full((B,), 5.0, device=dev)], 1).contiguous()
    seeds = torch.randint(0, 2 ** 31 - 1, (B,), generator=gen, device=dev,
                          dtype=torch.int32)
    kw = dict(k_steps=300, dt=3.98e-3, periodic=False, bidirectional=False,
              step0=900)
    whole = exclusion_multi_step(scal, seeds, slots, band, **kw)
    for lo, hi in ((0, 17), (17, 33)):
        rows = slice(lo, hi)
        got = exclusion_multi_step(scal[rows].contiguous(), seeds[rows],
                                   slots[rows].contiguous(), band, b0=lo,
                                   **kw)
        _rows_equal(f"B3 rows [{lo}, {hi})", [got], [whole], rows)
    rows = slice(17, 33)
    kw = dict(k_steps=100, dt=3.98e-3, periodic=False, bidirectional=False,
              b0=17, noise=randbits((16, 100, 2, K, L), gen, dev))
    args = (scal[rows].contiguous(), seeds[rows], slots[rows].contiguous(),
            band)
    _rows_equal("B3 b0=17 kernel vs plain",
                [exclusion_multi_step(*args, **kw)],
                [exclusion_multi_step_plain(*args, **kw)], slice(None))
    print("B3 b0: rows [0, 17), [17, 33) launched at b0 = 0, 17 equal the "
          "whole launch's (300 native steps, B=33, K=3, L=1000, sigma=0.002);"
          " kernel = plain at b0=17 (100 injected steps)", flush=True)


# ---------------------------------------------------------------------------
# phase 19: replica-axis parallelism and the large lattice
# ---------------------------------------------------------------------------

TWO_BLOCKS = ["cuda:0", "cuda:0"]


def _same(what: str, a, b) -> None:
    """Every array leaf of ``a`` and ``b`` equal (NaN equals NaN)."""
    from hydrolim_tpu_torch.parallel.mesh import tree_map

    leaves = []
    tree_map(lambda x, y: leaves.append((x, y)), a, b)
    bad = 0
    for x, y in leaves:
        x, y = _as_numpy(x), _as_numpy(y)
        if isinstance(x, np.ndarray) and x.dtype != object:
            if x.shape != y.shape or not np.array_equal(
                    x, y, equal_nan=x.dtype.kind == "f"):
                bad += 1
    if bad:
        raise AssertionError(f"{what}: {bad} of {len(leaves)} leaves differ "
                             "from the one-device run")


def sharded_sweeps(outdir: str) -> dict:
    """With ``devices=["cuda:0", "cuda:0"]`` (a mesh of two blocks on the
    one card), each sweep equals its one-device run bit for bit and runs
    through its kernel: ``sweep_over_betas`` on B1's route at the main
    path's width (11 β × 3 runs, L=256, N=5000, depth cut to T=3),
    ``run_exclusion_sweep`` at sweep (b)'s shape on B3 (33 replicas, K=3,
    L=1000, σ=0.002, every particle tagged, T=2) and ``run_pde_ensemble``
    on B2 (magn2's 5 runs, L=1000, 1000 tracers, T=1).  Then a world of
    one process over NCCL (``initialize_multihost``, ``global_sweep_mesh``)
    runs the first sweep again, equal to the run without it.  Returns each
    kernel's launches in the sharded runs."""
    import socket

    import torch
    import torch.distributed as dist
    from hydrolim_tpu_torch.core.config import ParticleConfig, PDEConfig
    from hydrolim_tpu_torch.experiments.cross_engine_validation import (
        GAMMA,
        LAM,
    )
    from hydrolim_tpu_torch.ops.exclusion_kernel import exclusion_multi_step
    from hydrolim_tpu_torch.ops.pde_kernel import pde_multi_step
    from hydrolim_tpu_torch.ops.stepper_kernel import meanfield_multi_step
    from hydrolim_tpu_torch.parallel.distributed import (
        global_sweep_mesh,
        initialize_multihost,
    )
    from hydrolim_tpu_torch.parallel.mesh import sweep_mesh
    from hydrolim_tpu_torch.sweeps.beta_sweep import sweep_over_betas
    from hydrolim_tpu_torch.sweeps.ensemble import (
        broadcast_params,
        ensemble_dt,
    )
    from hydrolim_tpu_torch.sweeps.fast_exclusion import (
        run_exclusion_sweep,
    )
    from hydrolim_tpu_torch.sweeps.pde_sweeps import run_pde_ensemble

    counters = {"meanfield_multi_step": meanfield_multi_step,
                "exclusion_multi_step": exclusion_multi_step,
                "pde_multi_step": pde_multi_step}
    launches = {}

    def twice(name: str, kernel: str, run):
        """The one-device run, then the sharded one (counted)."""
        t0 = time.perf_counter()
        want = run(None)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        counters[kernel].launches = 0
        got = run(sweep_mesh(devices=TWO_BLOCKS))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        n = counters[kernel].launches
        launches[kernel] = launches.get(kernel, 0) + n
        if n <= 0:
            raise AssertionError(f"{name}: the sharded run never launched "
                                 f"{kernel}")
        _same(name, want, got)
        print(f"{name}: 2 blocks on {TWO_BLOCKS} equal the one-device run; "
              f"{n} launches of {kernel} in the sharded run; walls "
              f"{t1 - t0:.2f} s (one device), {t2 - t1:.2f} s (2 blocks)",
              flush=True)
        return want

    L, N = 256, 5000
    ps = dict(L=L, xlim=1, N=N, init="fixed", scale_rates=False,
              local_kernel_sigma=0.0, periodic=True, site_capacity=None,
              active_model="bidirectional", rate_diffusion=GAMMA * L * L,
              rate_active=LAM * L, minus_anchor=False)
    sweep_kw = dict(n_runs_per_beta=3, ps_kwargs=ps,
                    run_kwargs=dict(T=3.0, obs_dt=0.5), seed=5,
                    do_fit=False, plot_result=False, engine="particle",
                    device="cuda", npz_path=f"{outdir}/mf.npz")
    keys = ("means", "D_means", "m_means", "rho_means", "block_means")
    mf = twice("sweep_over_betas, B1 route (11 beta x 3 runs, L=256, "
               "N=5000, T=3)", "meanfield_multi_step",
               lambda mesh: {k: v for k, v in sweep_over_betas(
                   SLICE_BETAS, mesh=mesh, **sweep_kw).items() if k in keys
                   or k == "route"})
    if str(mf["route"]) != "meanfield_multi_step":
        raise AssertionError(f"the mean-field sweep took {mf['route']}")

    cfg = ParticleConfig(L=1000, N=750, init="fixed", scale_rates=False,
                         local_kernel_sigma=0.002, periodic=False,
                         site_capacity=3)
    params = broadcast_params(cfg, beta=SLICE_BETAS, rate_diffusion=0.02,
                              rate_active=5.0, n_runs=3, device="cuda")
    dt = ensemble_dt(cfg, beta_max=3.0, rate_diffusion=0.02,
                     rate_active=5.0)
    twice("run_exclusion_sweep, B3 (33 replicas, K=3, L=1000, "
          "sigma=0.002, 750 tracers, T=2)", "exclusion_multi_step",
          lambda mesh: run_exclusion_sweep(
              cfg, params, mesh=mesh, T=2.0, obs_dt=0.1, dt=dt, seed=7,
              device="cuda", n_tracers=750))

    pcfg = PDEConfig(L=1000, T=1.0, dt=5e-4, bc="periodic",
                     active_model="bidirectional", gaussian_kernel=True,
                     kernel_sigma=0.05, snapshot_interval=2000, fft_kmax=8)
    twice("run_pde_ensemble, B2 (5 runs, L=1000, 1000 tracers, sigma=0.05, "
          "T=1)", "pde_multi_step",
          lambda mesh: run_pde_ensemble(
              pcfg, [0.75], gamma=0.2, lam=0.6, n_runs=5, seed=100,
              n_tracers=1000, device="cuda", fetch_snapshots=False,
              mesh=mesh)[0])

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    initialize_multihost(f"localhost:{port}", 1, 0)
    try:
        backend = dist.get_backend()
        mesh = global_sweep_mesh(devices=TWO_BLOCKS)
        got = sweep_over_betas(SLICE_BETAS, mesh=mesh, **sweep_kw)
    finally:
        dist.destroy_process_group()
    _same("world of one", {k: mf[k] for k in keys},
          {k: got[k] for k in keys})
    print(f"world of one process over {backend} (initialize_multihost, "
          f"global_sweep_mesh of {len(mesh.record())} blocks): the B1 sweep "
          "equals the run without it", flush=True)
    return launches


def large_lattice_full(outdir: str) -> None:
    """The large-lattice driver at full size on the card (L=65,536, N=L/2,
    two β, T=4: 532 ``lg_step``s; the banded PDE, 1500 steps per β) with
    its asserts; both walls, the site updates per second, and
    ``lg_step``'s µs per step at L=65,536 timed alone (CUDA events around
    200 steps after 20 warm-up steps)."""
    import torch
    from hydrolim_tpu_torch.core.config import ParticleConfig
    from hydrolim_tpu_torch.experiments import large_lattice as ll
    from hydrolim_tpu_torch.ops.exclusion_kernel import build_smoothing_band
    from hydrolim_tpu_torch.particles.lattice_gas import lg_init, lg_step
    from hydrolim_tpu_torch.sweeps.ensemble import (
        broadcast_params,
        ensemble_dt,
    )

    rec = ll.main(outdir=outdir, device="cuda")
    part, pde = rec["particle"], rec["pde"]
    print(f"large lattice (L={rec['L']}, N={rec['N']}): lattice gas "
          f"{part['wall_s']:.3f} s for {part['steps']} steps x 2 replicas "
          f"({part['site_updates_per_s']:.4e} site updates/s, "
          f"{part['us_per_step']:.1f} us per step with its records); PDE "
          f"(banded) {pde['wall_s']:.3f} s for {pde['steps']} steps "
          f"({pde['site_updates_per_s']:.4e} site updates/s); m_super "
          f"{part['m_super']:.4f} vs m_beta {part['m_theory']:.4f}",
          flush=True)
    L = rec["L"]
    cfg = ParticleConfig(L=L, xlim=1, N=L // 2, init="fixed",
                         scale_rates=False, local_kernel_sigma=0.0,
                         periodic=True, site_capacity=1,
                         active_model="bidirectional")
    params = broadcast_params(cfg, beta=ll.BETAS, rate_diffusion=ll.RD,
                              rate_active=ll.RA, device="cuda")
    dt = ensemble_dt(cfg, beta_max=2.5, rate_diffusion=ll.RD,
                     rate_active=ll.RA)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    occ = lg_init(cfg, gen, B=2, device="cuda")
    band = build_smoothing_band(cfg, "cuda")
    state = [occ]

    def steps(n):
        for _ in range(n):
            state[0] = lg_step(cfg, params, band, state[0], dt,
                               generator=gen)[0]

    steps(20)
    us = cuda_ms(lambda: steps(200)) * 1e3 / 200
    print(f"lg_step at L={L}, B=2: {us:.1f} us per step (CUDA events around "
          "200 steps; L=1000's 2192-3071 us in PERF.md, phase 15)",
          flush=True)


# ---------------------------------------------------------------------------
# phase 20: lattice sharding on the one card
# ---------------------------------------------------------------------------

FOUR_SEGMENTS = ["cuda:0"] * 4


def _counters_line(c: dict, S: int, periodic: bool) -> str:
    """The halo layer's counters, with the halo bytes per boundary and
    step: a row of S segments has S boundaries on a torus, S − 1 between
    walls."""
    per = c["halo_bytes"] / max(c["steps"], 1) / (S if periodic else S - 1)
    return (f"{c['steps']} steps, {c['halo_copies']} halo copies "
            f"({c['halo_bytes']} B, {per:.0f} B per "
            f"boundary and step), {c['allreduces']} all-reduces "
            f"({c['allreduce_bytes']} B), {c['step_gathers']} full-field "
            f"gathers inside a step, {c['frame_gathers']} at frame ends "
            f"({c['gather_bytes']} B), {c['draw_bytes']} B of full-width "
            "draws")


def lattice_sharding(outdir: str) -> dict:
    """(a) ``run_lattice_gas`` at sweep (a)'s shape (33 replicas, K=1,
    N=500, L=1000, σ=0.005, walls, the exp-gradient Poisson init, every
    particle tagged, 4 frames of 26 steps) and ``run_lattice_gas_k`` at
    sweep (b)'s (K=3, N=750, σ=0.002) on ``space_mesh(devices=["cuda:0"]
    * 4)``; (b) both on a (2, 2) ``grid_mesh`` of the same devices; each
    against its one-device run (timed after a warm-up call), every frame
    field and the final field, element by element.  (c) The large lattice at full width (L=65,536,
    N=L/2, B=2, 532 steps; the PDE half 1500 steps a β) on 1, 2 and 4
    segments: the driver's asserts (inside its halves), the particle half
    bit for bit, the PDE half within ``SHARDED_PDE_RTOL``.  (d)
    ``run_lattice_gas_k_checkpointed`` at (a)'s lgk run, stopped after one
    chunk on the 4-segment mesh and resumed unsharded.  The walls, the
    halo counters and ``lg_step``'s µs per step (with the frame records)
    at L=65,536 on 1, 2 and 4 segments."""
    import torch
    from hydrolim_tpu_torch.experiments import large_lattice as ll
    from hydrolim_tpu_torch.experiments.particle_beta_sweep import FLAGSHIP
    from hydrolim_tpu_torch.parallel.halo import counters
    from hydrolim_tpu_torch.parallel.spatial import (
        grid_mesh,
        grid_sharding,
        space_mesh,
        space_sharding,
    )
    from hydrolim_tpu_torch.particles.lattice_gas import run_lattice_gas
    from hydrolim_tpu_torch.particles.lattice_gas_k import run_lattice_gas_k
    from hydrolim_tpu_torch.sweeps import beta_sweep
    from hydrolim_tpu_torch.sweeps.ensemble import (
        broadcast_params,
        ensemble_dt,
    )
    from hydrolim_tpu_torch.utils.checkpoint import (
        run_lattice_gas_k_checkpointed,
    )

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def held(name, want, got, S, periodic, wall_one, wall_sh):
        bad, n = count_diff(_as_numpy(want), _as_numpy(got), name)
        print(f"{name}: {bad} of {n} elements differ from the one-device "
              f"run; walls {wall_one:.3f} s (one device), {wall_sh:.3f} s "
              f"({S} segments); "
              f"{_counters_line(counters.as_dict(), S, periodic)}",
              flush=True)
        if bad:
            raise AssertionError(f"{name}: {bad} elements differ")

    walls = {}
    runs = {}
    four = space_mesh(devices=FOUR_SEGMENTS)
    grid = grid_mesh(2, 2, devices=FOUR_SEGMENTS)
    for tag, over, run in (("lg (a)", {}, run_lattice_gas),
                           ("lgk (b)", FLAGSHIP, run_lattice_gas_k)):
        ps = dict(beta_sweep.DEFAULT_PS_KWARGS, **over)
        cfg = beta_sweep.config_from_kwargs(ps)
        grad = beta_sweep.make_exp_gradient(
            L=cfg.L, N=cfg.N, frac_plus=0.75, decay_length=0.35,
            anchor_positions=None)
        rates = dict(rate_diffusion=0.02, rate_active=5.0)
        params = broadcast_params(cfg, beta=SLICE_BETAS, n_runs=3,
                                  device="cuda", **rates)
        kw = dict(T=0.4, obs_dt=0.1, dt=ensemble_dt(cfg, beta_max=3.0,
                                                    **rates),
                  seed=9, device="cuda", rho0_plus=grad[2],
                  rho0_minus=grad[3], n_tracers=cfg.N)
        slots = cfg.K > 1
        run(cfg, params, **kw)             # warm-up: the first call's set-up
        want, w1 = timed(lambda: run(cfg, params, **kw))
        runs[tag] = (cfg, params, kw, want)
        for where, sh, S in (
                ("4 segments", space_sharding(four, slots=slots), 4),
                ("(2, 2) grid", grid_sharding(grid, slots=slots), 2)):
            counters.reset()
            got, w2 = timed(lambda: run(cfg, params, occ_sharding=sh, **kw))
            held(f"{tag} on a {where} of one card", want, got, S,
                 cfg.periodic, w1, w2)
            walls[f"{tag}, {where}"] = w2
        walls[f"{tag}, one device"] = w1

    cfg, params, kw, want = runs["lgk (b)"]
    ck = f"{outdir}/ck"
    counters.reset()
    if run_lattice_gas_k_checkpointed(
            cfg, params, ckpt_dir=ck, chunk_frames=2, stop_after_chunks=1,
            occ_sharding=space_sharding(four, slots=True), **kw) is not None:
        raise AssertionError("the checkpointed run did not stop")
    got, w = timed(lambda: run_lattice_gas_k_checkpointed(
        cfg, params, ckpt_dir=ck, chunk_frames=2, **kw))
    held("lgk (b) checkpointed: a chunk on 4 segments, resumed unsharded",
         want, got, 4, cfg.periodic, walls["lgk (b), one device"], w)

    L = 65536
    part, pde = {}, {}
    for S in (1, 2, 4):
        mesh = None if S == 1 else space_mesh(devices=["cuda:0"] * S)
        counters.reset()
        part[S] = ll.particle_half(L, 0, "cuda", mesh)
        c_part = counters.as_dict()
        counters.reset()
        pde[S] = ll.pde_half(L, False, 0, "cuda", mesh)
        c_pde = counters.as_dict()
        r = part[S]["record"]
        walls[f"large lattice particle half, {S} segment(s)"] = r["wall_s"]
        walls[f"large lattice PDE half, {S} segment(s)"] = \
            pde[S]["record"]["wall_s"]
        line = (f"large lattice on {S} segment(s) of one card: particle half "
                f"{r['wall_s']:.3f} s for {r['steps']} steps x 2 replicas, "
                f"lg_step {r['us_per_step']:.1f} us per step with its "
                f"records; PDE half {pde[S]['record']['wall_s']:.3f} s for "
                f"{pde[S]['record']['steps']} steps")
        if S > 1:
            bad, n = count_diff(
                {k: part[1][k] for k in ("occ", "m_traj", "total")},
                {k: part[S][k] for k in ("occ", "m_traj", "total")},
                f"particle half on {S} segments")
            rel = ll.pde_max_rel(pde[1], pde[S])
            line += (f"; particle half: {bad} of {n} elements differ from "
                     f"one segment; PDE half: largest relative difference "
                     f"{rel:.3e} (bound {ll.SHARDED_PDE_RTOL:g}); particle "
                     f"counters: {_counters_line(c_part, S, True)}; PDE "
                     f"counters: {_counters_line(c_pde, S, True)}")
            print(line, flush=True)
            if bad:
                raise AssertionError(f"the particle half on {S} segments "
                                     f"differs in {bad} elements")
            if not rel < ll.SHARDED_PDE_RTOL:
                raise AssertionError(f"the PDE half on {S} segments is "
                                     f"{rel:.3e} from one segment")
        else:
            print(line, flush=True)
    return walls


# ---------------------------------------------------------------------------
# phase 21: B2 on a cluster of CTAs per replica
# ---------------------------------------------------------------------------

def _differ(a, b) -> int:
    """Elements of two tensors that differ (NaN equals NaN)."""
    import torch

    same = (a == b) | (torch.isnan(a) & torch.isnan(b)) \
        if a.is_floating_point() else a == b
    return int(same.numel() - int(same.sum()))


def b2_every_cluster(dev) -> None:
    """(a) The L=8192 banded bench row (pointwise, B=4, 64 tracers, window
    20, dt=2e-7) under every cluster size the plan allows: native Philox
    and injected bits, each 0 elements differing from C=1 in the fields,
    tracers, ring and records, and each held against the plain version."""
    import torch
    from hydrolim_tpu_torch.experiments.profile_pde_kernel import b2_inputs
    from hydrolim_tpu_torch.ops import pde_kernel as pk

    gen = torch.Generator(device=dev)
    gen.manual_seed(21)
    over, shape = dict(diffusion_solver="banded"), dict(
        L=8192, n_t=64, W=20, dt=2e-7)
    config, _, ops, scal, state = b2_inputs(dev, over, shape, gen)
    B, n_t, k = scal.shape[0], config.n_tracers, 150
    seeds = torch.arange(B, dtype=torch.int32, device=dev) + 7
    kw = dict(b2_kwargs(config, ops), k_steps=k)
    noise = randbits((B, k, 3, n_t), gen, dev)
    circ = pk.call_circulants(config.L, ops[0], ops[1], ops[2], ops[3])
    co = pk.card_coresident(dev.index or 0, config.L, n_t, ops[0], circ)
    sizes = [C for C in pk.CLUSTER_SIZES if co[C] > 0]
    if sizes[0] != 1 or len(sizes) < 3:
        raise AssertionError(f"B2 L=8192: cluster sizes {sizes}")
    runs = {}
    for C in sizes:
        plan = pk.pde_launch_plan(B, config.L, n_t, ops[0], circ, co,
                                  cluster=C)
        runs[C] = [pk.pde_multi_step_planned(
            plan, scal, seeds, 0, *state, ops[3], ops[2], noise=nz, **kw)
            for nz in (None, noise)]
    torch.cuda.synchronize()
    plain = pk.pde_multi_step_plain(scal, seeds, 0, *state, ops[3], ops[2],
                                    noise=noise, **kw)
    plan_c = pk.pde_launch_plan(B, config.L, n_t, ops[0], circ, co).cluster
    for C in sizes:
        n_diff = [sum(_differ(a, b) for a, b in zip(runs[C][i], runs[1][i]))
                  for i in (0, 1)]
        n_all = sum(t.numel() for t in runs[C][0])
        if n_diff != [0, 0]:
            raise AssertionError(f"B2 L=8192 at C={C}: {n_diff} of {n_all} "
                                 "elements differ from C=1 (native, "
                                 "injected)")
        print(f"B2 L=8192 banded at C={C} (plan C {plan_c}, seg "
              f"{8192 // C}): 0 of {n_all} elements differ from C=1, "
              "native and injected", flush=True)
        b2_against_plain(f"B2 L=8192 banded at C={C}", runs[C][1], plain,
                          config.tracer_window)


def _recipe_config(L: int, **over):
    """The large-lattice driver's PDE recipe at L: dt = 0.5·dx/λ, γ =
    2.5·dx²/dt, 1500 steps, periodic, the auto solver (banded past 8192),
    pointwise m, 64 tracers, 8 bins."""
    from hydrolim_tpu_torch.core.config import PDEConfig
    from hydrolim_tpu_torch.experiments import large_lattice as ll

    dt = 0.5 / L / ll.LAM
    gamma = 2.5 / L / L / dt
    kw = dict(L=L, T=1500 * dt, dt=dt, bc="periodic", n_tracers=64,
              fft_kmax=8, snapshot_interval=375, tracer_window_time=20 * dt)
    kw.update(over)
    return PDEConfig(**kw), gamma


def _plain_snapshots(L: int, beta: float, rho0, steps: list, dev,
                     over: dict = None) -> list:
    """The large-lattice driver's plain ``pde_step`` loop
    (``large_lattice.pde_run``: its config with the PDEConfig fields
    ``over``, operators and initial fields 1.2·ρ₀[0], 0.8·ρ₀[1]), the
    total density at each of ``steps``."""
    import dataclasses

    import torch
    from hydrolim_tpu_torch.core.config import make_pde_params
    from hydrolim_tpu_torch.experiments import large_lattice as ll
    from hydrolim_tpu_torch.parallel.spatial import PDEFields
    from hydrolim_tpu_torch.pde.stepper import build_pde_ops

    grid, gamma, _ = ll.pde_grid(L, small=False)
    grid = dataclasses.replace(grid, **(over or {}))
    as_t = lambda a: torch.as_tensor(a, dtype=torch.float32).to(dev)
    rho = PDEFields(grid, make_pde_params(gamma=gamma, lam=ll.LAM,
                                          beta=beta, device=dev),
                    build_pde_ops(grid, gamma, dev), as_t(1.2 * rho0[0]),
                    as_t(0.8 * rho0[1]))
    out, n = [], 0
    for target in steps:
        for _ in range(target - n):
            rho.step()
        n = target
        rp, rm = rho.fields()
        out.append((rp + rm).cpu().numpy())
    return out


# Phase 21(b)'s and 22(c)'s bound on the total density's distance from the
# plain pde_step, in units of its largest value, per step: half a float32
# ulp a step.  The readings it was set from (PERF.md, C8): at most 0.164 ×
# 2⁻²³ a step at L = 65,536 to 1,048,576 after the repair of the
# circulant's law; 0.74 × 2⁻²³ a step before it, under the bound 2⁻²³
# then.
ENSEMBLE_ULPS = 2.0 ** -24


def b2_large_ensemble(dev, L: int = 65_536, label: str = "phase 21",
                      over: dict = None) -> dict:
    """(b) ``run_pde_ensemble`` at full width, L=65,536, β ∈ {0.5, 2.5},
    64 tracers, 8 bins, the large-lattice recipe (1500 steps, the banded
    solve) from the driver's initial fields (its seeded draw, ρ₊ = 1.2·ρ₀,
    ρ₋ = 0.8·ρ₀: ``large_lattice.pde_rho0``), with the driver's asserts:
    mass to 1e-4, dm/dt within 15% of the Curie–Weiss law 2(sinh βm − m
    cosh βm) from the driver's first m record (step nsteps/100: the
    pointwise m's mean moves ~2e-4 in the first steps as the fields'
    noise diffuses, in lattice units at every L, while the reaction moves
    it ~rate·1250/L), m decaying below β=1 and growing above from that
    record on.  The counters are
    set to 0 just before the run and read just after.  Its total density
    at every snapshot (steps 375, 750, 1125, 1500) is held against the
    driver's plain ``pde_step`` loop from the same fields, to n·2⁻²⁴ of
    scale after n steps (``ENSEMBLE_ULPS``; n·2⁻²³ before C8's repair):
    the kernel sums its taps and reductions in another order than torch,
    and on fields this close to stationary the differences accumulate
    instead of decaying (``profile_pde_kernel.py --mode drift`` measures
    the same at smaller L).  Printed beside it: the difference per step,
    its split into the masses' ratio and the rest (the kernel's density
    rescaled to the plain mass), and each route's mass against step
    0's; after 1500 steps the two masses' changes agree within
    ``B2_MASS_BOUND`` (C8).  ``over``: PDEConfig fields beyond the recipe
    (both runs; phase 23's full Gaussian m).  Returns the launches of each
    kernel, and of the step kernel by route."""
    import torch
    from hydrolim_tpu_torch.experiments import large_lattice as ll
    from hydrolim_tpu_torch.ops.pde_kernel import (
        pde_multi_step,
        pde_spectra,
        reset_launches,
    )
    from hydrolim_tpu_torch.sweeps import pde_sweeps

    seed = 0
    config, gamma = _recipe_config(L, **(over or {}))
    betas = np.asarray(ll.BETAS, np.float32)
    rho0 = [ll.pde_rho0(L, seed, bi) for bi in range(len(betas))]
    draw = pde_sweeps.pde_initialize

    def driver_fields(*args, **kw):
        _, _, tracers = draw(*args, **kw)
        f = lambda c, i: torch.tensor(np.stack([c * r[i] for r in rho0]),
                                      dtype=torch.float32, device=dev)
        return f(1.2, 0), f(0.8, 1), tracers

    pde_sweeps.pde_initialize = driver_fields
    try:
        reset_launches()
        t0 = time.perf_counter()
        res, _ = pde_sweeps.run_pde_ensemble(
            config, betas, gamma=gamma, lam=ll.LAM, n_runs=1, seed=seed,
            n_tracers=64, device=dev)
        wall = time.perf_counter() - t0
        launches = {"pde_multi_step": pde_multi_step.launches,
                    "pde_spectra": pde_spectra.launches,
                    "fft": pde_multi_step.fft_launches,
                    **pde_multi_step.route_launches}
    finally:
        pde_sweeps.pde_initialize = draw
    if min(launches["pde_multi_step"], launches["pde_spectra"]) < 1:
        raise AssertionError(f"{label} ensemble: launches {launches}")
    nsteps, dt = config.nsteps, config.dt
    mass0 = res.snapshots[:, 0].astype(np.float64).sum(-1)
    mass1 = (res.rho_p + res.rho_m).astype(np.float64).sum(-1)
    if not (np.abs(mass1 - mass0) / mass0 < 1e-4).all():
        raise AssertionError(f"{label} ensemble: mass {mass0} -> {mass1}")
    m = res.records.m_mean
    rates = []
    rec = max(nsteps // 100, 1)      # the JAX driver's first m record
    for i, beta in enumerate(betas):
        rate = float((m[i, -1] - m[i, rec]) / ((nsteps - rec) * dt))
        mid = 0.5 * float(m[i, rec] + m[i, -1])
        th = 2.0 * (np.sinh(beta * mid) - mid * np.cosh(beta * mid))
        if not abs(rate - th) < 0.15 * abs(th) + 1e-3:
            raise AssertionError(f"{label} ensemble beta={beta}: dm/dt "
                                 f"{rate} against the CW law {th}")
        rates.append((round(rate, 6), round(float(th), 6)))
    if not (m[0, -1] < m[0, rec] and m[1, -1] > m[1, rec]):
        raise AssertionError(f"{label} ensemble: m {m[:, [rec, -1]]}")
    if not np.isfinite(res.records.fft_ri).all():
        raise AssertionError(f"{label} ensemble: spectra not finite")
    steps = [config.snapshot_interval * j
             for j in range(1, res.snapshots.shape[1])]
    if steps[-1] != nsteps:
        raise AssertionError(f"{label} ensemble: snapshots at {steps}")
    t0 = time.perf_counter()
    rows = []
    for i, beta in enumerate(betas):
        plain = _plain_snapshots(L, float(beta), rho0[i], steps, dev, over)
        for j, (n, want) in enumerate(zip(steps, plain)):
            got = res.snapshots[i, j + 1].astype(np.float64)
            want = want.astype(np.float64)
            scale = np.abs(want).max()
            ratio = got.sum() / want.sum()
            rows.append(dict(
                beta=float(beta), n=n,
                diff=float(np.abs(got - want).max() / scale),
                mass=float(abs(ratio - 1.0)),
                rest=float(np.abs(got / ratio - want).max() / scale),
                drift=(float(got.sum() / mass0[i] - 1.0),
                       float(want.sum() / mass0[i] - 1.0))))
    plain_wall = time.perf_counter() - t0
    for r in rows:
        print(f"{label} ensemble beta={r['beta']} step {r['n']}: total "
              f"density {r['diff']:.3e} of scale from the plain pde_step "
              f"({r['diff'] / r['n'] / 2.0 ** -23:.3f} x 2^-23 a step); "
              f"the masses' ratio {r['mass']:.3e}, the rest "
              f"{r['rest']:.3e}; mass from step 0: kernel "
              f"{r['drift'][0]:+.3e}, plain {r['drift'][1]:+.3e}",
              flush=True)
        if not r["diff"] < r["n"] * ENSEMBLE_ULPS:
            raise AssertionError(
                f"{label} ensemble beta={r['beta']}: {r['diff']:.3e} of "
                f"scale from the plain pde_step at step {r['n']} (bound "
                f"{r['n'] * ENSEMBLE_ULPS:.3e})")
    for r in rows:
        gap = abs(r["drift"][0] - r["drift"][1])
        if r["n"] == nsteps and not gap < B2_MASS_BOUND:
            raise AssertionError(
                f"{label} ensemble beta={r['beta']}: the kernel's mass moved "
                f"{r['drift'][0]:+.3e}, the plain pde_step's "
                f"{r['drift'][1]:+.3e} (bound {B2_MASS_BOUND:.1e} apart)")
    worst = max(r["diff"] for r in rows if r["n"] == nsteps)
    print(f"run_pde_ensemble L={L}"
          + (f" {over}" if over else "") + f", 2 x {nsteps} steps, 64 "
          "tracers, 8 bins: "
          f"{wall:.3f} s, launches {launches}; dm/dt (measured, CW law) "
          f"{rates}; final density {worst:.3e} of scale from the driver's "
          f"plain pde_step (bound {nsteps * ENSEMBLE_ULPS:.3e}; "
          f"{plain_wall:.3f} s for the same steps)", flush=True)
    return launches


def b2_large_entry_points(dev, outdir: str) -> None:
    """``pde_beta_sweep`` at L = 16,384, 65,536 and 131,072 and
    ``IMEXPDE.solve`` at L = 16,384 and 65,536 on the card, each through
    both kernels (no ValueError, no plain route), and (c) a Neumann ``IMEXPDE`` at L = 16,384 with a narrow
    Gaussian m (the exact solve across the cluster; 100 steps of the
    recipe) held against the plain version on the card from the same
    initial fields: the fields (the tracers' draws differ, and the fields
    do not read them) and the m and Var records at phase 4's tolerances."""
    import torch
    from hydrolim_tpu_torch.core.config import PDEConfig
    from hydrolim_tpu_torch.ops.pde_kernel import (
        pde_multi_step,
        pde_multi_step_plain,
        pde_spectra,
    )
    from hydrolim_tpu_torch.pde.fast_solve import kernel_operands
    from hydrolim_tpu_torch.pde.system import IMEXPDE
    from hydrolim_tpu_torch.sweeps.pde_sweeps import pde_beta_sweep

    for L in (16_384, 65_536, 131_072):
        config, gamma = _recipe_config(L)
        pde_multi_step.launches = pde_spectra.launches = 0
        t0 = time.perf_counter()
        out = pde_beta_sweep([0.5, 2.5], n_runs=1, T=0.08, t_min=0.06,
                             t_max=0.08, gamma=gamma, L=L, dt=config.dt,
                             n_tracers=64, outdir=outdir, plot_result=False,
                             device=dev)
        wall = time.perf_counter() - t0
        n = (pde_multi_step.launches, pde_spectra.launches)
        if min(n) < 1 or not np.isfinite(out["v_mean"]).all():
            raise AssertionError(f"pde_beta_sweep L={L}: launches {n}, "
                                 f"v {out['v_mean']}")
        # the sweep's own configuration (sweeps/pde_sweeps.pde_beta_sweep)
        sweep = PDEConfig(L=L, T=0.08, dt=config.dt, bc="periodic",
                          gaussian_kernel=True, kernel_sigma=1e5 - 10,
                          fft_kmax=8)
        m_mode, solve_mode, _, _ = kernel_operands(sweep, gamma, dev)
        print(f"pde_beta_sweep L={L} (T=0.08, {sweep.nsteps} steps, "
              f"{m_mode} m, {solve_mode} solve): v {out['v_mean']}, D "
              f"{out['D_mean']}, launches {n}, {wall:.3f} s", flush=True)
    for L, bc, steps in ((16_384, "neumann", 100), (65_536, "periodic", 40)):
        config, gamma = _recipe_config(L)
        pde_multi_step.launches = pde_spectra.launches = 0
        s = IMEXPDE(L=L, T=steps * config.dt, dt=config.dt, gamma=gamma,
                    lam=0.6, beta=2.5, bc=bc, gaussian_kernel=True,
                    kernel_sigma=5e-4 * 16_384 / L, snapshot_interval=50,
                    fft_kmax=8, outdir=outdir, seed=9, device=dev)
        s.initialize(mode="homogeneous", rho0=1.0, noise=0.3, n_tracers=64)
        rp0, rm0, tr0 = s.rho_p.clone(), s.rho_m.clone(), s.tracers
        s.solve()
        out = s.get_output()
        n = (pde_multi_step.launches, pde_spectra.launches)
        if min(n) < 1:
            raise AssertionError(f"IMEXPDE L={L}: launches {n}")
        m_mode, solve_mode, smooth, solve = kernel_operands(
            s.config, gamma, dev)
        print(f"IMEXPDE L={L} {bc}: {m_mode} m, {solve_mode} solve, "
              f"launches {n}", flush=True)
        if bc != "neumann":
            continue
        scal = torch.tensor([[2.5, 0.6, gamma, 0.0]], device=dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        *sp, rp_ = pde_multi_step_plain(
            scal, None, 0, rp0, rm0, tr0.unwrapped, tr0.spin.float(),
            tr0.hist, solve, smooth, L=L, n_t=64,
            window=s.config.tracer_window, k_steps=steps, dt=config.dt,
            xlim=s.config.xlim, periodic=False, m_mode=m_mode,
            solve_mode=solve_mode, bidirectional=True, kmax_rec=8,
            generator=gen)
        res = {}
        for name, got, want in (("rho_p", out["rho_p"], sp[0]),
                                ("rho_m", out["rho_m"], sp[1])):
            res[name] = held(f"IMEXPDE L={L} {name}",
                             torch.as_tensor(got, device=dev).reshape(
                                 want.shape), want, 2e-4, 1e-7)
        res["m"] = held(f"IMEXPDE L={L} m", torch.as_tensor(
            out["m_series"][:steps], device=dev), rp_[0, :, 0], 0.0, 1e-5)
        res["Var"] = held(f"IMEXPDE L={L} Var", torch.as_tensor(
            out["var_series"][:steps], device=dev), rp_[0, :, 1], 1e-3,
            VAR_ATOL * float(rp_[0, :, 1].abs().max()))
        print(f"IMEXPDE L={L} neumann ({m_mode} m, {solve_mode} solve) "
              "against the plain version, max |kernel - plain| (share of "
              "the tolerance): " + ", ".join(
                  f"{k} {e:.2e} ({sh:.3f})" for k, (e, sh) in res.items())
              + f"; largest Var {float(rp_[0, :, 1].abs().max()):.2e}",
              flush=True)


# (d)'s shapes: (label, PDEConfig fields, shape, steps, the modes)
B2_LARGE_PLAIN = (
    ("L=16384 smooth (full circulant)",
     dict(gaussian_kernel=True, kernel_sigma=0.05),
     dict(L=16_384, B=1, n_t=64, W=2, dt=2e-7), 6, ("smooth", "exact")),
    ("L=131072 global, banded (the recipe)",
     dict(gaussian_kernel=True, kernel_sigma=2e5),
     dict(L=131_072, B=1, n_t=64, W=2), 8, ("global", "banded")),
    ("L=131072 pointwise, neumann, exact (the recipe)", dict(bc="neumann"),
     dict(L=131_072, B=1, n_t=64, W=2), 8, ("pointwise", "exact")),
)


def b2_large_against_plain(dev) -> None:
    """(d) The full smoothing circulant at L = 16,384 (σ=0.05, the exact
    solve, B=1, 64 tracers, 6 steps), and at L = 131,072, the largest
    lattice a cluster serves with a global or pointwise m, the banded
    solve (global m) and the exact one (pointwise m, Neumann; 8 steps of
    the large-lattice recipe each): the card's plan against the plain
    version on the card at injected bits."""
    import torch
    from hydrolim_tpu_torch.experiments.profile_pde_kernel import (
        _recipe,
        b2_inputs,
    )
    from hydrolim_tpu_torch.ops import pde_kernel as pk

    for label, over, shape, k, modes in B2_LARGE_PLAIN:
        gen = torch.Generator(device=dev)
        gen.manual_seed(22)
        if "dt" not in shape:
            shape = dict(shape, **_recipe(shape["L"]))
        config, _, ops, scal, state = b2_inputs(dev, over, shape, gen)
        if ops[:2] != modes:
            raise AssertionError(f"B2 {label}: routed to {ops[:2]}")
        kw = dict(b2_kwargs(config, ops), k_steps=k,
                  noise=randbits((1, k, 3, 64), gen, dev))
        seeds = torch.zeros(1, dtype=torch.int32, device=dev)
        got = pk.pde_multi_step(scal, seeds, 0, *state, ops[3], ops[2],
                                **kw)
        want = pk.pde_multi_step_plain(scal, seeds, 0, *state, ops[3],
                                       ops[2], **kw)
        circ = pk.call_circulants(config.L, ops[0], ops[1], ops[2], ops[3])
        plan = pk.card_plan(dev.index or 0, 1, config.L, 64, ops[0],
                            tuple(sorted(circ.items())))
        print(f"B2 {label}: plan C={plan.cluster}, segment {plan.seg}, "
              f"{plan.smem} B of shared memory a CTA", flush=True)
        b2_against_plain(f"B2 {label}", got, want, config.tracer_window)


def b2_cluster_times(dev) -> None:
    """(e) ``profile_pde_kernel.py --mode cluster`` in a child process
    (its JSON rows: µs per step at every cluster size the plan allows),
    each row with its bound (``b2_step_bound`` at the row's shape)."""
    import os

    from hydrolim_tpu_torch.experiments import profile_pde_kernel as pp

    bounds = {}
    for label, over, shape, k in pp.ROWS + pp.LARGE:
        config, _, ops, scal, _ = pp.b2_inputs(dev, over, shape)
        b = b2_step_bound(config, ops, scal.shape[0], k)
        bounds[label] = (b["bound_ms"] * 1e3 / k, b["bound_by"])

    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.dirname(os.path.abspath(__file__))
    res = subprocess.run(
        [sys.executable, "-m",
         "hydrolim_tpu_torch.experiments.profile_pde_kernel", "--mode",
         "cluster", "--calls", "2", "--tag", "phase 21"],
        capture_output=True, text=True, env=env, timeout=600)
    if res.returncode != 0:
        raise AssertionError(f"profile_pde_kernel --mode cluster: "
                             f"{res.stderr[-2000:]}")
    for line in res.stdout.splitlines():
        row = json.loads(line)
        at = ", ".join(f"C={C} {np.mean(us):.2f}"
                       for C, us in row["us_per_step_at_C"].items())
        bd, by = bounds[row["label"]]
        print(f"B2 {row['label']}: us/step {at}; plan C="
              f"{row['plan_cluster']}; bound {bd:.4f} us/step ({by})",
              flush=True)


# ---------------------------------------------------------------------------
# phase 22: B2's device-memory route, past a cluster's shared memory
# ---------------------------------------------------------------------------

# |B2's mass change − its plain version's| over 1500 steps of the
# large-lattice recipe (C8, PERF.md; tests/test_torch_gpu.py
# B2_MASS_BOUND), set from the readings: 1.19e-5 and 1.58e-5 at L = 8192,
# 1.26e-5 and 2.26e-5 at 65,536, at most 1.53e-5 at 262,144 and
# 1,048,576; the kernel's law before its repair read 1.93e-5 and 5.90e-5
# at L = 8192
B2_MASS_BOUND = 2.5e-5
# (a)'s cases: (label, L, PDEConfig fields, the modes)
B2_ROUTE_CASES = (
    ("L=65536 pointwise, banded", 65_536, dict(diffusion_solver="banded"),
     ("pointwise", "banded")),
    ("L=65536 narrow, banded", 65_536,
     dict(gaussian_kernel=True, kernel_sigma=5e-4 / 4,
          diffusion_solver="banded"), ("narrow", "banded")),
    ("L=131072 global, banded", 131_072,
     dict(gaussian_kernel=True, kernel_sigma=2e5, diffusion_solver="banded"),
     ("global", "banded")),
    ("L=131072 pointwise, neumann, exact", 131_072, dict(bc="neumann"),
     ("pointwise", "exact")),
)
LARGE_L = (262_144, 1_048_576, 4_194_304)


def _recipe_inputs(dev, L: int, over: dict, gen, B: int = 2, k: int = 40):
    """``profile_pde_kernel.b2_inputs`` at the large-lattice recipe (B
    replicas, 64 tracers, window 20, 8 bins) and its kernel arguments."""
    from hydrolim_tpu_torch.experiments.profile_pde_kernel import (
        _recipe,
        b2_inputs,
    )

    config, _, ops, scal, state = b2_inputs(
        dev, over, dict(B=B, n_t=64, W=20, **_recipe(L)), gen)
    return config, ops, scal, state, dict(b2_kwargs(config, ops), k_steps=k)


def b2_routes_bitwise(dev) -> None:
    """(a) Where both routes serve, the device-memory route forced at the
    card's G and at G = 8 against the cluster route: native Philox and
    injected bits, 40 steps, 0 elements differing in the fields, tracers,
    ring and records."""
    import functools

    import torch
    from hydrolim_tpu_torch.ops import pde_kernel as pk

    for label, L, over, modes in B2_ROUTE_CASES:
        gen = torch.Generator(device=dev)
        gen.manual_seed(L + 22)
        config, ops, scal, state, kw = _recipe_inputs(dev, L, over, gen)
        if ops[:2] != modes:
            raise AssertionError(f"B2 {label}: routed to {ops[:2]}")
        noise = randbits((2, 40, 3, 64), gen, dev)
        seeds = torch.arange(2, dtype=torch.int32, device=dev) + 3
        circ = pk.call_circulants(L, ops[0], ops[1], ops[2], ops[3])
        co = pk.card_coresident(dev.index or 0, L, 64, ops[0], circ)
        ctas = functools.partial(pk.gmem_max_ctas, dev.index or 0)
        plans = [pk.pde_route_plan(2, L, 64, ops[0], circ, co, ctas)] + [
            pk.pde_route_plan(2, L, 64, ops[0], circ, co, ctas,
                              route="gmem", ctas=G) for G in (None, 8)]
        if [p.route for p in plans] != ["cluster", "gmem", "gmem"]:
            raise AssertionError(f"B2 {label}: routes {plans}")
        runs = [[pk.pde_multi_step_planned(p, scal, seeds, 0, *state,
                                           ops[3], ops[2], noise=nz, **kw)
                 for nz in (None, noise)] for p in plans]
        torch.cuda.synchronize()
        n_all = sum(t.numel() for t in runs[0][0])
        for p, run in zip(plans[1:], runs[1:]):
            n_diff = [sum(_differ(a, b) for a, b in zip(run[i], runs[0][i]))
                      for i in (0, 1)]
            if n_diff != [0, 0]:
                raise AssertionError(
                    f"B2 {label}: the device-memory route at G={p.ctas} "
                    f"differs from the cluster (C={plans[0].cluster}) in "
                    f"{n_diff} of {n_all} elements (native, injected)")
            print(f"B2 {label}: device-memory route at G={p.ctas} (segment "
                  f"{p.seg}, tile {p.tile}) against the cluster route "
                  f"(C={plans[0].cluster}): 0 of {n_all} elements differ, "
                  "native and injected", flush=True)


def b2_gmem_against_plain(dev) -> float:
    """(b) The card's plan at L = 262,144, 1,048,576 and 4,194,304 (the
    recipe: pointwise m, the banded solve; B = 2, 100 steps, injected
    bits) against the plain version at phase 4's tolerances; the route
    must be the device-memory route.  Returns the largest field error."""
    import torch
    from hydrolim_tpu_torch.ops import pde_kernel as pk

    err = 0.0
    for L in LARGE_L:
        gen = torch.Generator(device=dev)
        gen.manual_seed(L)
        config, ops, scal, state, kw = _recipe_inputs(
            dev, L, dict(diffusion_solver="banded"), gen, k=100)
        kw["noise"] = randbits((2, 100, 3, 64), gen, dev)
        seeds = torch.zeros(2, dtype=torch.int32, device=dev)
        got = pk.pde_multi_step(scal, seeds, 0, *state, ops[3], ops[2],
                                **kw)
        plan = pk.pde_multi_step.last_plan
        if plan.route != "gmem":
            raise AssertionError(f"B2 L={L}: the plan is {plan}")
        want = pk.pde_multi_step_plain(scal, seeds, 0, *state, ops[3],
                                       ops[2], **kw)
        res = b2_against_plain(
            f"B2 L={L} {ops[0]}, {ops[1]} (device-memory route, G="
            f"{plan.ctas}, {plan.waves} wave(s))", got, want,
            config.tracer_window)
        err = max(err, res["rho_p"][0], res["rho_m"][0])
    return err


def b2_gmem_entry_points(dev, outdir: str) -> dict:
    """(d) ``pde_beta_sweep`` (global m, the banded solve) and a Neumann
    ``IMEXPDE`` (pointwise m, the exact solve) at L = 262,144: no
    ValueError, the device-memory route's launches, the modes from
    ``kernel_operands``.  Returns the launches of each path."""
    from hydrolim_tpu_torch.core.config import PDEConfig
    from hydrolim_tpu_torch.ops import pde_kernel as pk
    from hydrolim_tpu_torch.pde.fast_solve import kernel_operands
    from hydrolim_tpu_torch.pde.system import IMEXPDE
    from hydrolim_tpu_torch.sweeps.pde_sweeps import pde_beta_sweep

    L = 262_144
    out = {}
    config, gamma = _recipe_config(L)
    pk.reset_launches()
    t0 = time.perf_counter()
    res = pde_beta_sweep([0.5, 2.5], n_runs=1, T=0.08, t_min=0.06,
                         t_max=0.08, gamma=gamma, L=L, dt=config.dt,
                         n_tracers=64, outdir=outdir, plot_result=False,
                         device=dev)
    wall = time.perf_counter() - t0
    n = dict(pk.pde_multi_step.route_launches, spectra=pk.pde_spectra.launches)
    sweep = PDEConfig(L=L, T=0.08, dt=config.dt, bc="periodic",
                      gaussian_kernel=True, kernel_sigma=1e5 - 10,
                      fft_kmax=8)
    m_mode, solve_mode, _, _ = kernel_operands(sweep, gamma, dev)
    if n["gmem"] < 1 or n["cluster"] or not np.isfinite(res["v_mean"]).all():
        raise AssertionError(f"pde_beta_sweep L={L}: launches {n}, v "
                             f"{res['v_mean']}")
    print(f"pde_beta_sweep L={L} (T=0.08, {sweep.nsteps} steps, {m_mode} "
          f"m, {solve_mode} solve): route {pk.pde_multi_step.last_plan.route}"
          f", G={pk.pde_multi_step.last_plan.ctas}; v {res['v_mean']}, D "
          f"{res['D_mean']}, launches {n}, {wall:.3f} s", flush=True)
    out[f"pde_beta_sweep L={L} (phase 22)"] = n
    pk.reset_launches()
    steps = 40
    s = IMEXPDE(L=L, T=steps * config.dt, dt=config.dt, gamma=gamma,
                lam=0.6, beta=2.5, bc="neumann", snapshot_interval=20,
                fft_kmax=8, outdir=outdir, seed=9, device=dev)
    s.initialize(mode="homogeneous", rho0=1.0, noise=0.3, n_tracers=64)
    t0 = time.perf_counter()
    s.solve()
    wall = time.perf_counter() - t0
    o = s.get_output()
    n = dict(pk.pde_multi_step.route_launches, spectra=pk.pde_spectra.launches)
    m_mode, solve_mode, _, _ = kernel_operands(s.config, gamma, dev)
    if n["gmem"] < 1 or n["cluster"] or not np.isfinite(o["rho_p"]).all():
        raise AssertionError(f"IMEXPDE L={L} neumann: launches {n}")
    print(f"IMEXPDE L={L} neumann ({steps} steps, {m_mode} m, {solve_mode} "
          f"solve): route {pk.pde_multi_step.last_plan.route}, G="
          f"{pk.pde_multi_step.last_plan.ctas}; launches {n}, {wall:.3f} s",
          flush=True)
    out[f"IMEXPDE neumann L={L} (phase 22)"] = n
    return out


def b2_route_times(dev) -> dict:
    """(e) ``profile_pde_kernel.py --mode route`` in a child process: µs
    per step on each route at L = 65,536 and 131,072 and on the card's
    plan (the device-memory route) at the three large L, G and waves, the
    plain ``pde_step`` loop's µs per step, each row with its bound
    (``b2_step_bound``).  Returns the L = 1,048,576 row's times for the
    ``kernels`` line."""
    import os

    from hydrolim_tpu_torch.experiments import profile_pde_kernel as pp

    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.dirname(os.path.abspath(__file__))
    res = subprocess.run(
        [sys.executable, "-m",
         "hydrolim_tpu_torch.experiments.profile_pde_kernel", "--mode",
         "route", "--calls", "3", "--tag", "phase 22"],
        capture_output=True, text=True, env=env, timeout=600)
    if res.returncode != 0:
        raise AssertionError(f"profile_pde_kernel --mode route: "
                             f"{res.stderr[-2000:]}")
    out = {}
    for line in res.stdout.splitlines():
        row = json.loads(line)
        L, k = row["L"], row["k_steps"]
        over = next(o for L2, o, _, _ in pp.ROUTE_ROWS if L2 == L)
        config, _, ops, scal, _ = pp.b2_inputs(
            dev, over, dict(B=2, n_t=64, W=20, **pp._recipe(L)))
        b = b2_step_bound(config, ops, 2, k)
        bd = b["bound_ms"] * 1e3 / k
        plain = float(np.mean(row["plain_pde_step_us_per_step"]))
        for route, r in row["routes"].items():
            us, bare = r["us_per_step"], r["us_per_step_without_bins"]
            print(f"B2 L={L} {ops[0]}, {ops[1]}, B=2 on the {route} route "
                  f"({r['ctas']} CTAs a replica, {r['waves']} wave(s), "
                  f"{r['launches_per_call']} launches a {k}-step call): "
                  f"{np.mean(us):.2f} us/step ({min(us):.2f}-{max(us):.2f}), "
                  f"without the bins {np.mean(bare):.2f} "
                  f"({min(bare):.2f}-{max(bare):.2f}); bound {bd:.4f} "
                  f"us/step ({b['bound_by']}); the plain pde_step loop "
                  f"{plain:.1f} us/step", flush=True)
            if L == 1_048_576:
                out = dict(ms=float(np.mean(us)) * k / 1e3,
                           plain_ms=plain * k / 1e3, **b,
                           shape=dict(B=2, L=L, k=k, ctas=r["ctas"]))
    return out


# ---------------------------------------------------------------------------
# phase 23: B2's full smoothing in device memory (the FFT stage)
# ---------------------------------------------------------------------------

# (a)'s lattices: powers of two, a prime and a composite (the row wrapped
# and padded), and its σ (xlim 1; all take m_mode 'smooth'); then a few
# steps at the stage's largest transforms: 4,194,304 (2048 x 2048) and
# 2^26 (8192 x 8192, the plan's reach, one column and one row a unit)
FFT_L = (131_072, 200_000, 131_071, 262_144)
FFT_SIGMAS = (0.0005, 0.05)
FFT_L_LARGE = ((4_194_304, 4), (1 << 26, 2))
SMOOTH = dict(gaussian_kernel=True, kernel_sigma=0.05)


def fft_field_atol(want) -> float:
    """The fields' atol of phase 23: phase 4's 1e-7, or 1e-5 of the
    largest density where that is less (a site holds ~1/L of the mass)."""
    return min(1e-7, 1e-5 * max(float(want[0].abs().max()),
                                float(want[1].abs().max())))


def b2_fft_m_field(what: str, state, scal, seeds, ops, kw) -> tuple:
    """The smoothed m field the FFT stage leaves for the step's reaction
    and tracers, site by site: one step from ``state`` with the launch's
    m field kept (``pde_multi_step.m_fields``) against ``m_field_of`` on
    the same densities, atol 1e-5.  Returns (max error, share)."""
    import torch
    from hydrolim_tpu_torch.ops import pde_kernel as pk

    pk.pde_multi_step.m_fields = []
    try:
        pk.pde_multi_step(scal, seeds, 0, *state, ops[3], ops[2],
                          **dict(kw, k_steps=1))
        got = torch.cat(pk.pde_multi_step.m_fields)
    finally:
        pk.pde_multi_step.m_fields = None
    want = pk.m_field_of("smooth", state[0], state[1], ops[2])
    return held(f"{what} m field", got, want.to(got.dtype), 0.0, 1e-5)


def b2_fft_against_plain(dev) -> float:
    """(a) The card's plan (the device-memory route, its FFT stage) against
    the plain version on the card, which smooths by ``m_field_of``'s
    float64 ``torch.fft``: B = 2, the large-lattice recipe (the banded
    solve), 64 tracers, 8 bins, 40 steps, at L = 131,072, 200,000, 131,071
    and 262,144 and σ = 0.0005, 0.05; and at σ = 0.05 a few steps at L =
    4,194,304 and 2^26 (``FFT_L_LARGE``).  At injected bits phase 4's
    tolerances on every output, the fields' atol tightened to the density
    (``fft_field_atol``); at native bits (the plain version draws from a
    generator, the kernel from Philox) the fields, m, Var and the spectra,
    which read no draw, for the first four L.  After each call, the
    stage's m field site by site on the call's output
    (``b2_fft_m_field``).  Returns the largest field error."""
    import torch
    from hydrolim_tpu_torch.ops import pde_kernel as pk

    err = 0.0
    cases = ([(L, sigma, 40) for L in FFT_L for sigma in FFT_SIGMAS]
             + [(L, 0.05, k) for L, k in FFT_L_LARGE])
    for L, sigma, k in cases:
        gen = torch.Generator(device=dev)
        gen.manual_seed(L + 23)
        config, ops, scal, state, kw = _recipe_inputs(
            dev, L, dict(gaussian_kernel=True, kernel_sigma=sigma,
                         diffusion_solver="banded"), gen, k=k)
        if ops[:2] != ("smooth", "banded"):
            raise AssertionError(f"B2 L={L} sigma={sigma}: {ops[:2]}")
        seeds = torch.arange(2, dtype=torch.int32, device=dev) + 5
        noise = randbits((2, k, 3, 64), gen, dev)
        got = pk.pde_multi_step(scal, seeds, 0, *state, ops[3], ops[2],
                                noise=noise, **kw)
        plan = pk.pde_multi_step.last_plan
        if plan.route != "gmem" or plan.fft is None:
            raise AssertionError(f"B2 L={L} smooth: the plan is {plan}")
        want = pk.pde_multi_step_plain(scal, seeds, 0, *state, ops[3],
                                       ops[2], noise=noise, **kw)
        f = plan.fft
        what = (f"B2 L={L} smooth sigma={sigma}, {k} steps (FFT stage n="
                f"{f.n} = {f.n1} x {f.n2}, {f.w1} columns / {f.w2} rows a "
                f"unit, wrap {f.wrap}; G={plan.ctas})")
        fa = fft_field_atol(want)
        res = b2_against_plain(f"{what}, injected (fields atol {fa:.2e})",
                               got, want, config.tracer_window, fa)
        err = max(err, res["rho_p"][0], res["rho_m"][0])
        del want                  # the plain version's float64 scratch
        torch.cuda.empty_cache()  # goes back to the card at 2^26
        e, sh = b2_fft_m_field(what, got[:5], scal, seeds, ops, kw)
        print(f"{what}: the stage's m field on the call's output, max "
              f"|kernel - m_field_of| {e:.2e} ({sh:.3f} of atol 1e-5)",
              flush=True)
        del got
        if k != 40:
            continue
        got = pk.pde_multi_step(scal, seeds, 0, *state, ops[3], ops[2],
                                **kw)
        want = pk.pde_multi_step_plain(scal, seeds, 0, *state, ops[3],
                                       ops[2], generator=gen, **kw)
        fa = fft_field_atol(want)
        res = {}
        for name, i in (("rho_p", 0), ("rho_m", 1)):
            res[name] = held(f"{what} {name}", got[i], want[i], 2e-4, fa)
        rk, rp = got[5], want[5]
        res["m"] = held(f"{what} m", rk[..., 0], rp[..., 0], 0.0, 1e-5)
        res["Var"] = held(f"{what} Var", rk[..., 1], rp[..., 1], 1e-3,
                          VAR_ATOL * float(rp[..., 1].abs().max()))
        res["spectra"] = held(f"{what} spectra", rk[..., 4:],
                              rp[..., 4:], 1e-4, 1e-8)
        err = max(err, res["rho_p"][0], res["rho_m"][0])
        print(f"{what}, native (fields atol {fa:.2e}): max |kernel - "
              "plain| (share of the tolerance): " + ", ".join(
                  f"{n} {e:.2e} ({sh:.3f})" for n, (e, sh) in res.items()),
              flush=True)
    return err


def b2_fft_sigma_sweep(dev, outdir: str) -> dict:
    """(c) ``pde_kernel_sigma_sweep`` at L = 131,072 over the reference σ
    (``REFERENCE_KERNEL_SIGMAS``, every one the full smoothing there), 5
    runs a σ, 1000 tracers, dt = 0.5·dx/λ, T cut to 200 steps: no
    ValueError, every launch on the device-memory route, each σ's route
    and the wall.  Returns the launches."""
    from hydrolim_tpu_torch.core.config import PDEConfig
    from hydrolim_tpu_torch.ops import pde_kernel as pk
    from hydrolim_tpu_torch.pde.fast_solve import kernel_operands
    from hydrolim_tpu_torch.sweeps.pde_sweeps import (
        REFERENCE_KERNEL_SIGMAS,
        pde_kernel_sigma_sweep,
    )

    L, runs, n_t = 131_072, 5, 1000
    dt = 0.5 / L / 0.6
    T = 200 * dt
    pk.reset_launches()
    t0 = time.perf_counter()
    out = pde_kernel_sigma_sweep(n_runs=runs, L=L, dt=dt, T=T,
                                 n_tracers=n_t, outdir=outdir,
                                 plot_result=False, device=dev)
    wall = time.perf_counter() - t0
    n = dict(pk.pde_multi_step.route_launches,
             spectra=pk.pde_spectra.launches,
             fft=pk.pde_multi_step.fft_launches)
    if n["cluster"] or n["gmem"] != pk.pde_multi_step.launches \
            or n["gmem"] < len(REFERENCE_KERNEL_SIGMAS):
        raise AssertionError(f"sigma sweep L={L}: launches {n}")
    routes = []
    for sigma in REFERENCE_KERNEL_SIGMAS:
        cfg = PDEConfig(L=L, T=T, dt=dt, gaussian_kernel=True,
                        kernel_sigma=sigma, fft_kmax=8)
        ops = kernel_operands(cfg, out["gamma"], dev)
        circ = pk.call_circulants(L, ops[0], ops[1], ops[2], ops[3])
        plan = pk.card_plan(dev.index or 0, runs, L, n_t, ops[0],
                            tuple(sorted(circ.items())))
        if ops[0] != "smooth" or plan.route != "gmem":
            raise AssertionError(f"sigma sweep sigma={sigma}: {ops[:2]} "
                                 f"on {plan.route}")
        if not np.isfinite(out["m"][sigma]).all():
            raise AssertionError(f"sigma sweep sigma={sigma}: m not finite")
        routes.append(f"{sigma}: {ops[0]} on {plan.route} (G={plan.ctas}, "
                      f"n={plan.fft.n})")
    print(f"pde_kernel_sigma_sweep L={L} ({runs} runs x "
          f"{len(REFERENCE_KERNEL_SIGMAS)} sigma, {n_t} tracers, "
          f"{round(T / dt)} steps): {wall:.3f} s, launches {n}; "
          + "; ".join(routes), flush=True)
    return n


def b2_fft_refusal(dev) -> None:
    """(d) With the card's free memory reported as 1 MB, a full-smoothing
    call at L = 262,144 is refused before any launch, naming the largest
    L the FFT stage's bytes leave room for."""
    import torch
    from hydrolim_tpu_torch.ops import pde_kernel as pk

    gen = torch.Generator(device=dev)
    gen.manual_seed(23)
    config, ops, scal, state, kw = _recipe_inputs(
        dev, 262_144, dict(SMOOTH, diffusion_solver="banded"), gen, k=2)
    seeds = torch.zeros(2, dtype=torch.int32, device=dev)
    real = torch.cuda.mem_get_info
    total = real(dev)[1]
    n0 = dict(pk.pde_multi_step.route_launches)
    torch.cuda.mem_get_info = lambda *a: (1 << 20, total)
    try:
        pk.pde_multi_step(scal, seeds, 0, *state, ops[3], ops[2], **kw)
    except ValueError as e:
        msg = str(e)
    else:
        raise AssertionError("B2 smooth L=262144 at 1 MB free: not refused")
    finally:
        torch.cuda.mem_get_info = real
    if pk.pde_multi_step.route_launches != n0 or \
            "the largest L this configuration serves" not in msg:
        raise AssertionError(f"B2 smooth refusal: {msg}")
    print(f"B2 smooth L=262144 at 1 MB free: refused before any launch: "
          f"{msg}", flush=True)


def b2_fft_times(dev) -> dict:
    """(e) ``profile_pde_kernel.py --mode route-smooth spectra-large`` in a
    child process: µs per step of the full smoothing on the card's plan
    (the FFT stage) at L = 131,072, 262,144, 1,048,576 and 4,194,304
    (50-step calls), with and without the bins; at 65,536 the cluster's
    direct circulant against the FFT stage forced with ``route='gmem'`` (a
    reading: the route line does not move); the plain ``pde_step`` loop;
    each row's bound (``b2_step_bound``); the stage's
    library yardstick, ``torch.fft.rfft``·spectrum·``irfft`` of the (num,
    den) rows in float32 and float64; and the stage's scratch traffic
    (``fft_scratch_us``, a reading).  And the spectra kernel at phase
    22's calls past a million sites (B = 2, 8 bins, 200 steps at
    1,048,576, 50 at 4,194,304) beside ``torch.fft.rfft`` of the same rows,
    with its bound.  Returns the L = 262,144 row's times and the spectra
    rows for the ``kernels`` line."""
    import os

    from hydrolim_tpu_torch.experiments import profile_pde_kernel as pp

    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.dirname(os.path.abspath(__file__))
    res = subprocess.run(
        [sys.executable, "-m",
         "hydrolim_tpu_torch.experiments.profile_pde_kernel", "--mode",
         "route-smooth", "spectra-large", "--calls", "3", "--tag",
         "phase 23"],
        capture_output=True, text=True, env=env, timeout=600)
    if res.returncode != 0:
        raise AssertionError(f"profile_pde_kernel --mode route-smooth: "
                             f"{res.stderr[-2000:]}")
    out = {"spectra": []}
    for line in res.stdout.splitlines():
        row = json.loads(line)
        if "routes" not in row:              # the spectra kernel
            sh = row["shape"]
            B, k, L, kmax = sh["B"], sh["k_steps"], sh["L"], sh["kmax_rec"]
            b = bound(4 * B * k * (L + 2 * kmax),
                      spectra_ops(B * k, L, kmax))
            us = lambda v: "not measured" if v is None else f"{v:.2f} us"
            print(f"B2 spectra kernel (B={B}, {k} steps, L={L}, {kmax} "
                  f"bins): device {us(row['device_us_per_call'])} a call "
                  f"(events {us(row['events_us_per_call'])}); "
                  "torch.fft.rfft of the rows device "
                  f"{us(row['rfft_device_us_per_call'])} (events "
                  f"{us(row['rfft_events_us_per_call'])}); bound "
                  f"{b['bound_ms'] * 1e3:.2f} us ({b['bound_by']})",
                  flush=True)
            out["spectra"].append(dict(row, bound_ms=b["bound_ms"],
                                       bound_by=b["bound_by"]))
            continue
        L, k = row["L"], row["k_steps"]
        config, _, ops, scal, _ = pp.b2_inputs(
            dev, pp.SMOOTH, dict(B=2, n_t=64, W=20, **pp._recipe(L)))
        plain = float(np.mean(row["plain_pde_step_us_per_step"]))
        lib = {t: float(np.mean(v)) for t, v in
               row["library_stage_us"].items()}
        for route, r in row["routes"].items():
            fft = r.get("fft")
            b = b2_step_bound(config, ops, 2, k)
            bd = b["bound_ms"] * 1e3 / k
            us, bare = r["us_per_step"], r["us_per_step_without_bins"]
            smooth_bd = 2 * 2 * circulant_ops(L, L // 2) / F32_OPS_PER_S
            stage = (f"FFT stage n={fft['n']} = {fft['n1']} x {fft['n2']}, "
                     f"its scratch's three round trips in device memory "
                     f"{fft_scratch_us(fft['n'], 2):.2f} us/step (not in "
                     "the bound)" if fft else "the direct circulant")
            stage += (f"; the full smoothing's share of the bound "
                      f"{smooth_bd * 1e6:.4f} us/step")
            print(f"B2 L={L} smooth sigma=0.05, banded, B=2 on the {route} "
                  f"route ({stage}; {r['ctas']} CTAs a replica, "
                  f"{r['waves']} wave(s)): {np.mean(us):.2f} us/step "
                  f"({min(us):.2f}-{max(us):.2f}), without the bins "
                  f"{np.mean(bare):.2f} ({min(bare):.2f}-{max(bare):.2f}); "
                  f"bound {bd:.4f} us/step ({b['bound_by']}); the plain "
                  f"pde_step loop {plain:.1f} us/step; torch.fft "
                  f"rfft*spectrum*irfft of the (num, den) rows "
                  f"{lib['float32']:.2f} us (float32), {lib['float64']:.2f} "
                  "(float64)", flush=True)
            if L == 262_144:
                out.update(ms=float(np.mean(us)) * k / 1e3,
                           plain_ms=plain * k / 1e3, **b,
                           shape=dict(B=2, L=L, k=k, ctas=r["ctas"],
                                      m_mode="smooth"))
    return out


def b2_fft_phase(dev, rows: dict) -> None:
    """Phase 23, (a)–(e); the ``pde_multi_step_gmem_fft`` row (the
    device-memory route's FFT-stage kernel) gets its paths' launches, its
    largest error and its times at L = 262,144, and the ``pde_spectra``
    row its paths' launches and its times past a million sites.  Every
    launch of the phase is the FFT-stage kernel's."""
    fft = rows["pde_multi_step_gmem_fft"]
    t_phase = time.perf_counter()
    fft["max_abs_err"] = b2_fft_against_plain(dev)
    paths = {}
    for L in (262_144, 1_048_576):
        n = b2_large_ensemble(dev, L, "phase 23", SMOOTH)
        paths[f"large-L ensemble, smooth m, L={L} (phase 23)"] = n
    with tempfile.TemporaryDirectory() as outdir:
        paths["kernel-sigma sweep L=131072 (phase 23)"] = \
            b2_fft_sigma_sweep(dev, outdir)
    for path, n in paths.items():
        if n["cluster"] or not n["gmem"] == n["fft"] == n.get(
                "pde_multi_step", n["gmem"]):
            raise AssertionError(f"phase 23 {path}: launches {n}")
        fft["launches_per_path"][path] = n["fft"]
        rows["pde_spectra"]["launches_per_path"][path] = n.get(
            "spectra", n.get("pde_spectra"))
    b2_fft_refusal(dev)
    times = b2_fft_times(dev)
    rows["pde_spectra"]["large_shapes"] = times.pop("spectra")
    fft.update(times)
    print(f"phase 23 took {time.perf_counter() - t_phase:.2f} s",
          flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import hydrolim_tpu_torch  # noqa: F401  (sets TF32 off)
    from hydrolim_tpu_torch.ops import (
        exclusion_kernel,
        pde_kernel,
        stepper_kernel,
    )
    from hydrolim_tpu_torch.ops._build import BUILD_DIR, build_kernel_library

    dev = torch.device("cuda", 0)
    kinds = {"meanfield_multi_step": (stepper_kernel.SOURCE,
                                      stepper_kernel.REPLACES),
             "pde_multi_step": (pde_kernel.SOURCE, pde_kernel.REPLACES),
             "pde_spectra": (pde_kernel.SPECTRA_SOURCE,
                             pde_kernel.SPECTRA_REPLACES),
             "exclusion_multi_step": (exclusion_kernel.SOURCE,
                                      exclusion_kernel.REPLACES)}
    rows = {name: dict(name=name, route="cuda", source=src, replaces=rep)
            for name, (src, rep) in kinds.items()}
    # kernel B2's device-memory route, and its instantiation with the full
    # smoothing's FFT stage: kernels of their own in B2's source
    for name in ("pde_multi_step_gmem", "pde_multi_step_gmem_fft"):
        rows[name] = dict(name=name, route="cuda", source=pde_kernel.SOURCE,
                          replaces=pde_kernel.REPLACES)

    with phase("1 device"):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
        print(smi, flush=True)
        print(f"torch {torch.__version__} cuda {torch.version.cuda} "
              f"python {sys.version.split()[0]} devices "
              f"{torch.cuda.device_count()}", flush=True)
    with phase("2 build"):
        with concurrent.futures.ThreadPoolExecutor(len(kinds)) as pool:
            built = list(pool.map(build_kernel_library, kinds))
        for name, so in zip(kinds, built):
            print(f"built {so.name}", flush=True)
            print((BUILD_DIR / f"{name}.ptxas.txt").read_text().strip(),
                  flush=True)
    with phase("3 B1 vs plain"):
        rows["meanfield_multi_step"]["max_abs_err"] = check_b1(dev)
        check_b1_b0(dev)
    with phase("4 B2 vs plain"):
        (rows["pde_multi_step"]["max_abs_err"],
         rows["pde_spectra"]["max_abs_err"]) = check_b2(dev)
        check_b2_b0(dev)
    with phase("5 main path"):
        with tempfile.TemporaryDirectory() as outdir:
            for name, n in main_path(outdir).items():
                rows[name]["launches"] = n
    with phase("6 throughput"):
        for name, t in throughput(dev).items():
            rows[name].update(t)
    with phase("7 B3/B4 vs plain"):
        rows["exclusion_multi_step"]["max_abs_err"] = check_b3(dev)
        check_b3_b0(dev)
    with phase("8 exclusion sweep"):
        with tempfile.TemporaryDirectory() as outdir:
            rows["exclusion_multi_step"].update(slice_path(outdir))
    with phase("9 B3/B4 throughput"):
        for name, t in throughput_b3(dev).items():
            rows[name].update(t)
    with phase("10 PDE slice"):
        with tempfile.TemporaryDirectory() as outdir:
            per_path = pde_slice(outdir)["launches_per_path"]
        row = rows["pde_multi_step"]
        row["launches_per_path"] = dict(main_path=row["launches"],
                                        **per_path["pde_multi_step"])
        row["launches"] = sum(row["launches_per_path"].values())
        row = rows["pde_spectra"]
        row["launches_per_path"] = dict(main_path=row["launches"],
                                        **per_path["pde_spectra"])
    b3 = rows["exclusion_multi_step"]
    b3["launches_per_path"] = {"exclusion beta-sweep": b3["launches"]}
    b1 = rows["meanfield_multi_step"]
    b1["launches_per_path"] = {"main_path": b1["launches"]}
    with phase("11 ParticleSystem"):
        runs = particle_system_runs()
        b3["launches_per_path"]["ParticleSystem single run"] = \
            runs["single run"]["launches"]
        b1["launches_per_path"]["ParticleSystem mean-field run"] = \
            runs["mean-field, periodic (B1)"]["launches"]
    with phase("12 particle phase diagram"):
        with tempfile.TemporaryDirectory() as outdir:
            b3["launches_per_path"]["particle phase diagram"] = \
                phase_diagram_full(outdir)["launches"]
    with phase("13 double sweep"):
        with tempfile.TemporaryDirectory() as outdir:
            b3["launches_per_path"]["double sweep"] = \
                double_sweep_full(outdir)["launches"]
    with phase("14 sigma sweep"):
        with tempfile.TemporaryDirectory() as outdir:
            b3["launches_per_path"]["sigma sweep"] = \
                sigma_sweep_full(outdir)["launches"]
    with phase("15 slot engines"):
        check_slot_engine(dev)
        with tempfile.TemporaryDirectory() as outdir:
            walls = slot_sweeps(outdir)
            walls.update(anchored_checks(outdir))
        # phase 9: B3 ms per 1000-step call at the sweep shape = µs per step
        slot_step_rates(dev, b3["ms"])
        print("slot-engine driver walls (s): "
              + ", ".join(f"{k} {v:.2f}" for k, v in walls.items()),
              flush=True)
    with phase("16 tau-leap engine"):
        check_tau_leap_step(dev)
        walls = oracle_checks()
        with tempfile.TemporaryDirectory() as outdir:
            walls.update(tau_leap_sweep(outdir))
            w, n = tau_leap_structure(outdir)
            walls.update(w)
        b3["launches_per_path"]["local-structure sweep (pallas)"] = n
        tau_leap_step_rates()
        print("tau-leap driver walls (s): "
              + ", ".join(f"{k} {v:.2f}" for k, v in walls.items()),
              flush=True)
    with phase("17 checkpoint"):
        with tempfile.TemporaryDirectory() as outdir:
            per_path = checkpoint_routes(outdir)
        for name, paths in per_path.items():
            rows[name]["launches_per_path"].update(paths)
    with phase("18 single-card drivers"):
        t_phase = time.perf_counter()
        with tempfile.TemporaryDirectory() as outdir:
            b1["launches_per_path"]["critical scaling"] = \
                critical_scaling_full(f"{outdir}/cs")["launches"]
            convergence_full(f"{outdir}/conv")
            particle_single_full(f"{outdir}/single")
            from hydrolim_tpu_torch.fit.real_data import main as fit_main
            fit = fit_main(f"{outdir}/fit")
            print(f"kinesin fit: k={fit['k']}, beta={fit['beta']:.6f}, "
                  f"lambda={fit['lam']:.6f}, chi2={fit['chi2']:.6f} "
                  f"(TASEP-LK {fit['chi2_tasep_lk']:.6f})", flush=True)
            launcher_checks(f"{outdir}/launcher")
        print(f"phase 18 took {time.perf_counter() - t_phase:.2f} s",
              flush=True)
    with phase("19 parallelism and the large lattice"):
        with tempfile.TemporaryDirectory() as outdir:
            for name, n in sharded_sweeps(outdir).items():
                rows[name]["launches_per_path"][
                    "sharded sweep, 2 blocks on one card"] = n
            large_lattice_full(f"{outdir}/ll")
        print(f"scaling: this host has {torch.cuda.device_count()} card(s); "
              "the blocks above share one card, so no scaling number "
              "(speed-up over cards) can be measured here", flush=True)
    with phase("20 lattice sharding"):
        with tempfile.TemporaryDirectory() as outdir:
            walls = lattice_sharding(outdir)
        print("lattice-sharding walls (s): "
              + ", ".join(f"{k} {v:.3f}" for k, v in walls.items()),
              flush=True)
        print("the segments share one card: their halo copies are "
              "same-device copies (no NVLink), so no cross-card number is "
              "measured here", flush=True)
    with phase("21 B2 on a cluster"):
        b2_every_cluster(dev)
        with tempfile.TemporaryDirectory() as outdir:
            n = b2_large_ensemble(dev)
            for name in ("pde_multi_step", "pde_spectra"):
                rows[name]["launches_per_path"][
                    "large-L ensemble, L=65536 (phase 21)"] = n[name]
            b2_large_entry_points(dev, outdir)
        b2_large_against_plain(dev)
        b2_cluster_times(dev)
    gmem = rows["pde_multi_step_gmem"]
    gmem["launches_per_path"] = {}
    with phase("22 B2 in device memory"):
        t_phase = time.perf_counter()
        b2_routes_bitwise(dev)
        gmem["max_abs_err"] = b2_gmem_against_plain(dev)
        paths = {}
        for L in LARGE_L[:2]:
            n = b2_large_ensemble(dev, L, "phase 22")
            if n["cluster"] or n["gmem"] != n["pde_multi_step"]:
                raise AssertionError(f"phase 22 ensemble L={L}: {n}")
            paths[f"large-L ensemble, L={L} (phase 22)"] = n
        with tempfile.TemporaryDirectory() as outdir:
            paths.update(b2_gmem_entry_points(dev, outdir))
        for path, n in paths.items():
            gmem["launches_per_path"][path] = n["gmem"]
            rows["pde_spectra"]["launches_per_path"][path] = n.get(
                "spectra", n.get("pde_spectra"))
        gmem.update(b2_route_times(dev))
        print(f"phase 22 took {time.perf_counter() - t_phase:.2f} s; "
              f"card: {smi}", flush=True)
    rows["pde_multi_step_gmem_fft"]["launches_per_path"] = {}
    with phase("23 B2's smoothing in device memory"):
        b2_fft_phase(dev, rows)
        print(f"card: {smi}", flush=True)
    for row in rows.values():
        row["launches"] = sum(row["launches_per_path"].values())

    print(json.dumps({"kernels": list(rows.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

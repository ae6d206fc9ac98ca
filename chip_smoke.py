#!/usr/bin/env python3
"""GPU smoke of the PyTorch port (``hydrolim_tpu_torch``) on one card.

Phases (each prints one line with its wall time; a failed phase raises):

1. device: a CUDA card, its name and power limit (nvidia-smi), versions;
2. build: the three CUDA kernels from ``hydrolim_tpu_torch/csrc``, one
   nvcc process each, all started together;
3. kernel B1 against its plain PyTorch version on the card, injected bits,
   under its own plan and under every cluster size and state mode its
   launch plan can reach (``B1_PLANS``: registers, shared memory, device
   memory);
4. kernel B2 against its plain PyTorch version on the card, injected bits,
   in every mode (``B2_CASES``: global / pointwise / narrow / smooth m,
   periodic / Neumann, bidirectional / anchored_minus, exact / banded /
   no solve, L=8192, the facade's 501 spectral bins, an odd n_t and an
   odd L);
5. the micro↔macro main path at full size (the cross-engine driver on
   ``device='cuda'``, native Philox streams) with its physics pins, and the
   proof that it ran through B1 and B2 (launch counters);
6. throughput of B1 at the main path's and the headline shapes (with the
   plan's cluster size and state mode) and of B2 at the main path's shape,
   kernel and plain version, and B2's µs per step in each mode at the PDE
   slice's shapes with its bound;
7. kernel B3/B4 against its plain version on the card, injected bits, in
   four configurations at 4 and 33 replicas and L = 1000 and 999, under
   the launch plan and under every cluster size it allows, at L=8192
   (K=3, past one block's shared memory) and on the dense reflect and
   periodic bands (every row reads all L sites): slots equal, state moved,
   admission refused somewhere, ids conserved, occupancy ≤ K;
8. the exclusion β-sweep at full size (``sweep_over_betas`` on
   ``device='cuda'``, native Philox) in the reference configuration and at
   the flagship capacity, with its checks, where its wall time went, the
   physics pins, and the proof that it ran through B3/B4 (launch counter,
   per configuration);
9. throughput of B3/B4 at the JAX bench's flagship shape and at the
   sweep's 33 replicas: the plan it takes, the kernel (and per forced
   cluster size, C = 1…8), the plain version and the bound;
10. the PDE slice at full size on ``device='cuda'``: the magn2 kernel-σ
    sweep, the single run through the ``IMEXPDE`` facade and the (β × σ)
    phase diagram, with their pins, B2's launches on each and the kernel's
    device time against each driver's wall time;
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
    paths' shapes, and each path's wall.

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
    return max(float(err), check_b1_plans(dev, gen))


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


def b2_inputs(dev, gen, over: dict, shape: dict):
    """(config, γ, operands, scal, state) of one B2 shape."""
    import torch
    from hydrolim_tpu_torch.core.config import PDEConfig
    from hydrolim_tpu_torch.pde.fast_solve import kernel_operands
    from hydrolim_tpu_torch.pde.init import pde_initialize

    sh = dict(L=1000, B=4, n_t=1000, W=100, dt=5e-4, gamma=0.2, kmax=8)
    sh.update(shape)
    config = PDEConfig(L=sh["L"], dt=sh["dt"], n_tracers=sh["n_t"],
                       tracer_window_time=sh["W"] * sh["dt"] * (1 + 1e-9),
                       fft_kmax=sh["kmax"], **over)
    assert config.tracer_window == sh["W"]
    ops = kernel_operands(config, sh["gamma"], dev)
    rp, rm, tr = pde_initialize(config, gen, B=sh["B"], mode="homogeneous",
                                noise=0.3, n_tracers=sh["n_t"], device=dev)
    scal = torch.tensor([[b, 0.6, sh["gamma"], 0.0]
                         for b in np.linspace(0.5, 3.0, sh["B"])],
                        dtype=torch.float32, device=dev)
    state = [rp, rm, tr.unwrapped, tr.spin.float(), tr.hist]
    return config, sh["gamma"], ops, scal, state


def b2_kwargs(config, ops) -> dict:
    m_mode, solve_mode, _, _ = ops
    return dict(L=config.L, n_t=config.n_tracers, window=config.tracer_window,
                dt=config.dt, xlim=config.xlim,
                periodic=config.bc == "periodic", m_mode=m_mode,
                solve_mode=solve_mode,
                bidirectional=config.active_model == "bidirectional",
                kmax_rec=config.kmax)


def check_b2(dev) -> float:
    """Every mode of B2 (``B2_CASES``) against its plain version on the
    card: injected bits, β spread over the replicas, two chained 150-step
    calls.  Tolerances of the JAX package's kernel-logic test: fields rtol
    2e-4 / atol 1e-7, tracers and ring rtol 1e-4 / atol 1e-5, spins equal,
    v and D rtol 5e-4 / atol 1e-6 with the NaN prefix; records: m atol
    1e-5, Var rtol 1e-3, spectra rtol 1e-4 / atol 1e-8.  Each check prints
    its max error and its share of the tolerance.  Returns the max abs
    field difference."""
    import torch
    from hydrolim_tpu_torch.ops.pde_kernel import (
        pde_multi_step,
        pde_multi_step_plain,
    )

    k = 150
    err = 0.0
    for what, modes, over, shape in B2_CASES:
        gen = torch.Generator(device=dev)
        gen.manual_seed(2)
        config, gamma, ops, scal, sk = b2_inputs(dev, gen, over, shape)
        if ops[:2] != modes:
            raise AssertionError(f"B2 {what}: routed to {ops[:2]}")
        B, n_t, W = scal.shape[0], config.n_tracers, config.tracer_window
        seeds = torch.zeros(B, dtype=torch.int32, device=dev)
        noise = randbits((B, 2 * k, 3, n_t), gen, dev)
        start, sp = list(sk), list(sk)
        rk, rpl = [], []
        for c in range(2):
            kw = dict(b2_kwargs(config, ops), k_steps=k,
                      noise=noise[:, c * k:(c + 1) * k].contiguous())
            *sk, r1 = pde_multi_step(scal, seeds, c * k, *sk, ops[3],
                                     ops[2], **kw)
            *sp, r2 = pde_multi_step_plain(scal, seeds, c * k, *sp, ops[3],
                                           ops[2], **kw)
            rk.append(r1)
            rpl.append(r2)
        torch.cuda.synchronize()
        rk, rpl = torch.cat(rk, 1), torch.cat(rpl, 1)
        what = f"B2 {what}"
        res = {}
        for name, i, rtol, atol in (("rho_p", 0, 2e-4, 1e-7),
                                    ("rho_m", 1, 2e-4, 1e-7),
                                    ("tracer pos", 2, 1e-4, 1e-5),
                                    ("ring", 4, 1e-4, 1e-5)):
            res[name] = held(f"{what} {name}", sk[i], sp[i], rtol, atol)
        if not torch.equal(sk[3], sp[3]):
            raise AssertionError(f"{what}: tracer spins differ")
        for col, name in ((2, "v_eff"), (3, "D_eff")):
            if not rk[:, :W, col].isnan().all():
                raise AssertionError(f"{what}: {name} NaN prefix")
            res[name] = held(f"{what} {name}", rk[..., col], rpl[..., col],
                             5e-4, 1e-6)
        res["m"] = held(f"{what} m", rk[..., 0], rpl[..., 0], 0.0, 1e-5)
        res["Var"] = held(f"{what} Var", rk[..., 1], rpl[..., 1], 1e-3,
                          1e-11)
        res["spectra"] = held(f"{what} spectra", rk[..., 4:], rpl[..., 4:],
                              1e-4, 1e-8)
        if torch.equal(sk[0], start[0]) or torch.equal(sk[2], start[2]):
            raise AssertionError(f"{what}: the fields or tracers did not "
                                 "move")
        print(f"{what}: spins equal; max |kernel - plain| (share of the "
              "tolerance): " + ", ".join(
                  f"{n} {e:.2e} ({s:.3f})" for n, (e, s) in res.items()),
              flush=True)
        err = max(err, res["rho_p"][0], res["rho_m"][0])
    return err


# ---------------------------------------------------------------------------
# phase 5: the main path
# ---------------------------------------------------------------------------

def main_path(outdir: str) -> dict:
    from hydrolim_tpu_torch.experiments import cross_engine_validation as cev
    from hydrolim_tpu_torch.ops.pde_kernel import pde_multi_step
    from hydrolim_tpu_torch.ops.stepper_kernel import meanfield_multi_step

    meanfield_multi_step.launches = 0
    pde_multi_step.launches = 0
    res = cev.main(small=False, outdir=outdir, device="cuda")
    launches = {"meanfield_multi_step": meanfield_multi_step.launches,
                "pde_multi_step": pde_multi_step.launches}
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
    return out


# B2's step time per mode at the PDE slice's shapes: (label, PDEConfig
# fields beyond the defaults, shape (as in B2_CASES), steps per kernel
# call).  B=5 is the σ sweep's (1000 tracers), B=64 the phase diagram's
# (64 tracers); both L=1000, dt=5e-4, γ=0.2 (the exact solve), kmax 8.
def _b2_rate_rows():
    rows = []
    for B, n_t in ((5, 1000), (64, 64)):
        for m, over in (("global", dict(gaussian_kernel=True,
                                        kernel_sigma=2e5)),
                        ("pointwise", {}),
                        ("narrow sigma=0.005", dict(gaussian_kernel=True,
                                                    kernel_sigma=0.005)),
                        ("smooth sigma=0.05", dict(gaussian_kernel=True,
                                                   kernel_sigma=0.05))):
            rows.append((f"{m}, exact, B={B}, n_t={n_t}", over,
                         dict(B=B, n_t=n_t), 2000))
    rows.append(("pointwise, banded, L=8192, B=4, n_t=64",
                 dict(diffusion_solver="banded"),
                 dict(L=8192, B=4, n_t=64, W=20, dt=2e-7), 2000))
    rows.append(("the single run: narrow sigma=0.005, none, kmax 501, B=1",
                 dict(gaussian_kernel=True, kernel_sigma=0.005),
                 dict(B=1, gamma=0.0, kmax=501), 50))
    return rows


def b2_step_bound(config, ops, B: int, k: int) -> dict:
    """Bytes: the fields, tracers and ring in and out, the records out.
    Operations per replica-step (an FMA is two): ~30 per site (m, upwind
    advection, CW reaction, tridiagonal solve, clip, renormalisation), ~24
    per tracer, 4 per site and spectral bin, and the taps: 4·(2r+1) per
    site for the narrow smoothing and the banded solve, 4·L per site
    (2·L² FMAs) for the full circulant."""
    m_mode, solve_mode, smooth, solve = ops
    L, n_t, W, kmax = (config.L, config.n_tracers, config.tracer_window,
                       config.kmax)
    per_site = 30 + 4 * kmax
    if smooth is not None:
        per_site += 4 * (2 * smooth.radius + 1) if m_mode == "narrow" \
            else 4 * L
    if solve_mode == "banded":
        per_site += 4 * (solve.weights.shape[0])
    return bound(4 * (2 * 2 * B * L + 2 * 3 * B * n_t + 2 * B * W * n_t
                      + B * k * (4 + 2 * kmax)),
                 k * B * (per_site * L + 24 * n_t))


def throughput_b2_modes(dev, gen) -> list:
    """B2's µs per step in each mode at the slice's shapes (native
    Philox, CUDA events over 3 calls after a warm-up), its bound, and the
    plain version's µs per step (one 20-step call)."""
    import torch
    from hydrolim_tpu_torch.ops.pde_kernel import (
        pde_multi_step,
        pde_multi_step_plain,
    )

    rows = []
    for label, over, shape, k in _b2_rate_rows():
        config, _, ops, scal, state = b2_inputs(dev, gen, over, shape)
        B = scal.shape[0]
        seeds = torch.arange(B, dtype=torch.int32, device=dev)
        kw = dict(b2_kwargs(config, ops), k_steps=k)
        args = (scal, seeds, 0, *state, ops[3], ops[2])
        pde_multi_step(*args, **kw)                     # warm-up
        ms = cuda_ms(lambda: pde_multi_step(*args, **kw), reps=3)
        pk = 20
        pde_multi_step_plain(*args, generator=gen, **dict(kw, k_steps=2))
        plain_ms = cuda_ms(lambda: pde_multi_step_plain(
            *args, generator=gen, **dict(kw, k_steps=pk)))
        b = b2_step_bound(config, ops, B, k)
        row = dict(label=label, m_mode=ops[0], solve_mode=ops[1], B=B,
                   L=config.L, n_t=config.n_tracers, steps_per_call=k,
                   us_per_step=ms * 1e3 / k,
                   plain_us_per_step=plain_ms * 1e3 / pk,
                   bound_us_per_step=b["bound_ms"] * 1e3 / k,
                   bound_by=b["bound_by"])
        rows.append(row)
        print(f"B2 {label}: {row['us_per_step']:.2f} us/step "
              f"({B * k / (ms / 1e3):.4e} replica-steps/s); bound "
              f"{row['bound_us_per_step']:.4f} us/step ({b['bound_by']}); "
              f"plain {row['plain_us_per_step']:.1f} us/step", flush=True)
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
    cluster size that holds it, and the two dense bands at L=1000 (C=1).
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
    # the dense bands (every row reads all L sites; C=1): the sigma
    # sweep's sigma=0.3 (reflect radius 1200 >= L) and the particle phase
    # diagram's sigma=2.0 (2r+1 >= L on the torus)
    cases.append((4, 1000, "dense reflect band sigma=0.3, non-periodic, "
                  "K=1", 1, 0.3, False, False))
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
        print(f"{what}: equal over {2 * kws[0]['k_steps']} steps under the "
              f"plan (C={card_plan(B, K, L, band, periodic).cluster}) and "
              f"C={sizes}; admission {tally['admitted']} of "
              f"{tally['candidates']} candidates", flush=True)
    return float(err)


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
        ms=ms, plain_ms=plain_ms, plan=dict(cluster=plan.cluster,
                                            halo=plan.halo,
                                            threads=plan.threads),
        us_per_step_by_cluster=table, **b3_bound(slots, band, 1000))
    return out


# ---------------------------------------------------------------------------
# phase 10: the PDE slice at full size
# ---------------------------------------------------------------------------

def pde_slice(outdir: str) -> dict:
    """The three finite-σ PDE drivers at the JAX package's full sizes on
    ``device='cuda'``, each with its pins, its B2 launches (counts set to
    0 just before it) and the kernel's device time (CUDA events around each
    launch) against its wall time:
    - ``pde_kernel_sigma_sweep(variant='magn2')``: 5 σ × 5 runs, L=1000,
      T=10, 1000 tracers; mean over runs of |m(T)| < 1e-2 at every σ;
    - ``pde_single_run()``: L=1000, T=20 (40,000 steps), σ=0.005, 1000
      tracers, per-step spectra at the full rfft; ||m(T)| − m_β(2)| < 0.01
      and all 40,001 ``fft_amp`` rows finite;
    - the (β × σ) phase diagram (32 β × 2 seeds × 16 σ, L=1000, T=10, 64
      tracers) with its ``check_physics`` pins."""
    import torch
    from hydrolim_tpu_torch.experiments import pde_phase_diagram
    from hydrolim_tpu_torch.ops.pde_kernel import kernel_ms, pde_multi_step
    from hydrolim_tpu_torch.sweeps.pde_sweeps import (
        pde_kernel_sigma_sweep,
        pde_single_run,
    )
    from hydrolim_tpu_torch.theory.meanfield import m_fixed_point

    launches = {}

    def driven(name, fn):
        pde_multi_step.launches = 0
        pde_multi_step.events = []
        t0 = time.perf_counter()
        try:
            out = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            device_s = kernel_ms(pde_multi_step.events) / 1e3
        finally:
            events, pde_multi_step.events = pde_multi_step.events, None
        n = launches[name] = pde_multi_step.launches
        print(f"{name}: {wall:.2f} s wall, {n} launches of pde_multi_step, "
              f"kernel {device_s:.3f} s on the device "
              f"({device_s / wall:.1%} of the wall)", flush=True)
        if n <= 0 or len(events) != n:
            raise AssertionError(f"{name} never launched pde_multi_step")
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
    kinds = {"meanfield_multi_step": stepper_kernel,
             "pde_multi_step": pde_kernel,
             "exclusion_multi_step": exclusion_kernel}
    rows = {name: dict(name=name, route="cuda", source=mod.SOURCE,
                       replaces=mod.REPLACES) for name, mod in kinds.items()}

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
    with phase("4 B2 vs plain"):
        rows["pde_multi_step"]["max_abs_err"] = check_b2(dev)
    with phase("5 main path"):
        with tempfile.TemporaryDirectory() as outdir:
            for name, n in main_path(outdir).items():
                rows[name]["launches"] = n
    with phase("6 throughput"):
        for name, t in throughput(dev).items():
            rows[name].update(t)
    with phase("7 B3/B4 vs plain"):
        rows["exclusion_multi_step"]["max_abs_err"] = check_b3(dev)
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
                                        **per_path)
        row["launches"] = sum(row["launches_per_path"].values())
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
    for row in (b1, b3):
        row["launches"] = sum(row["launches_per_path"].values())

    print(json.dumps({"kernels": list(rows.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

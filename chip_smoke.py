#!/usr/bin/env python3
"""GPU smoke of the PyTorch port (``hydrolim_tpu_torch``) on one card.

Phases (each prints one line with its wall time; a failed phase raises):

1. device: a CUDA card, its name and power limit (nvidia-smi), versions;
2. build: both CUDA kernels from ``hydrolim_tpu_torch/csrc`` with nvcc;
3. kernel B1 against its plain PyTorch version on the card, injected bits;
4. kernel B2 against its plain PyTorch version on the card, injected bits;
5. the micro↔macro main path at full size (the cross-engine driver on
   ``device='cuda'``, native Philox streams) with its physics pins, and the
   proof that it ran through both kernels (launch counters);
6. throughput at the headline shapes, kernel and plain version.

The line before the last is ``{"kernels": [...]}`` and the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
package beside it, the script exits non-zero and prints no result.

Usage: python3 chip_smoke.py
"""
from __future__ import annotations

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
    return float(err)


# ---------------------------------------------------------------------------
# phase 4: B2 against its plain version
# ---------------------------------------------------------------------------

def check_b2(dev) -> float:
    """B=4 with β spread, L=1000, n_t=1000, window 100, kmax 8, γ ∈ {0.2,
    0}, two chained 150-step chunks.  Tolerances of the JAX package's
    kernel-logic test: fields rtol 2e-4 / atol 1e-7, tracers rtol 1e-4 /
    atol 1e-5, spins equal, v and D rtol 5e-4 / atol 1e-6 with the NaN
    prefix.  Returns the max abs field difference."""
    import torch
    from hydrolim_tpu_torch.core.config import PDEConfig
    from hydrolim_tpu_torch.ops.pde_kernel import (
        build_solve_operands,
        pde_multi_step,
        pde_multi_step_plain,
    )
    from hydrolim_tpu_torch.pde.init import pde_initialize

    B, L, n_t, W, kmax, dt, lam, k = 4, 1000, 1000, 100, 8, 5e-4, 0.6, 150
    betas = [0.5, 1.2, 2.0, 3.0]
    config = PDEConfig(L=L, dt=dt, n_tracers=n_t, tracer_window_time=0.05)
    assert config.tracer_window == W
    close = lambda a, b, rtol, atol, what: torch.testing.assert_close(
        a, b, rtol=rtol, atol=atol, equal_nan=True, msg=lambda m: f"{what}: {m}")
    err = 0.0
    for gamma in (0.2, 0.0):
        gen = torch.Generator(device=dev)
        gen.manual_seed(2)
        rp, rm, tr = pde_initialize(config, gen, B=B, mode="homogeneous",
                                    noise=0.3, n_tracers=n_t, device=dev)
        mode = "exact" if gamma > 0 else "none"
        solve = build_solve_operands(L, config.dx, dt, gamma, True, mode,
                                     dev)
        scal = torch.tensor([[b, lam, gamma, 0.0] for b in betas],
                            device=dev)
        seeds = torch.zeros(B, dtype=torch.int32, device=dev)
        noise = randbits((B, 2 * k, 3, n_t), gen, dev)
        sk = [rp, rm, tr.unwrapped, tr.spin.float(), tr.hist]
        sp = list(sk)
        rk, rpl = [], []
        for c in range(2):
            kw = dict(L=L, n_t=n_t, window=W, k_steps=k, dt=dt,
                      xlim=config.xlim, periodic=True, m_mode="global",
                      solve_mode=mode, bidirectional=True, kmax_rec=kmax,
                      noise=noise[:, c * k:(c + 1) * k].contiguous())
            *sk, r1 = pde_multi_step(scal, seeds, c * k, *sk, solve, **kw)
            *sp, r2 = pde_multi_step_plain(scal, seeds, c * k, *sp, solve,
                                           **kw)
            rk.append(r1)
            rpl.append(r2)
        torch.cuda.synchronize()
        rk, rpl = torch.cat(rk, 1), torch.cat(rpl, 1)
        what = f"B2 gamma={gamma}"
        close(sk[0], sp[0], 2e-4, 1e-7, f"{what} rho_p")
        close(sk[1], sp[1], 2e-4, 1e-7, f"{what} rho_m")
        close(sk[2], sp[2], 1e-4, 1e-5, f"{what} tracer pos")
        close(sk[4], sp[4], 1e-4, 1e-5, f"{what} ring")
        if not torch.equal(sk[3], sp[3]):
            raise AssertionError(f"{what}: tracer spins differ")
        for col, name in ((2, "v_eff"), (3, "D_eff")):
            if not (rk[:, :W, col].isnan().all()
                    and rpl[:, :W, col].isnan().all()):
                raise AssertionError(f"{what}: {name} NaN prefix")
            close(rk[:, W:, col], rpl[:, W:, col], 5e-4, 1e-6,
                  f"{what} {name}")
        # records are sums over the fields, held at the fields' error: m
        # (|m| ≤ 1) to 1e-5, Var and the spectra relative to their scale
        print(f"{what} record max |kernel - plain|: m "
              f"{float((rk[..., 0] - rpl[..., 0]).abs().max()):.3e}, Var "
              f"{float((rk[..., 1] - rpl[..., 1]).abs().max()):.3e} (of "
              f"{float(rpl[..., 1].abs().max()):.3e}), spectra "
              f"{float((rk[..., 4:] - rpl[..., 4:]).abs().max()):.3e} (of "
              f"{float(rpl[..., 4:].abs().max()):.3e})", flush=True)
        close(rk[..., 0], rpl[..., 0], 0.0, 1e-5, f"{what} m")
        close(rk[..., 1], rpl[..., 1], 1e-3, 1e-11, f"{what} Var")
        close(rk[..., 4:], rpl[..., 4:], 1e-4, 1e-8, f"{what} spectra")
        err = max(err, float((sk[0] - sp[0]).abs().max()),
                  float((sk[1] - sp[1]).abs().max()))
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

def throughput(dev) -> dict:
    """B1 at the headline shape (B=64, N=1e5, L=1000, dt=0.002, rd=0.5,
    ra=2, β=linspace(0,3,64), 1000-step calls) and B2 at the main path's PDE
    shape (33 replicas, L=1000, 1000 tracers, one 2000-step chunk), each
    beside its plain version on the same card."""
    import torch
    from hydrolim_tpu_torch.core.config import PDEConfig
    from hydrolim_tpu_torch.ops.pde_kernel import (
        build_solve_operands,
        pde_multi_step,
        pde_multi_step_plain,
    )
    from hydrolim_tpu_torch.ops.stepper_kernel import (
        meanfield_multi_step,
        meanfield_multi_step_plain,
    )
    from hydrolim_tpu_torch.pde.init import pde_initialize

    out = {}
    B, N, L, k = 64, 100_000, 1000, 1000
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    st = [torch.randint(0, L, (B, N), generator=gen, device=dev,
                        dtype=torch.int32),
          torch.randint(0, 2, (B, N), generator=gen, device=dev,
                        dtype=torch.int32) * 2 - 1,
          torch.zeros((B, N), dtype=torch.int32, device=dev)]
    scal = torch.stack([torch.linspace(0.0, 3.0, B, device=dev),
                        torch.full((B,), 0.5, device=dev),
                        torch.full((B,), 2.0, device=dev)], 1).contiguous()
    seeds = torch.randint(0, 2 ** 30, (B,), generator=gen, device=dev,
                          dtype=torch.int32)
    kw = dict(L=L, k_steps=k, dt=0.002, bidirectional=True)
    frame = [0]

    def kernel_call():
        st[:] = meanfield_multi_step(scal, seeds, *st, step0=frame[0] * k,
                                     **kw)
        frame[0] += 1

    kernel_call()                                   # warm-up
    ms = [cuda_ms(kernel_call) for _ in range(3)]   # 3 frames
    plain_ms = cuda_ms(lambda: meanfield_multi_step_plain(
        scal, seeds, *st, generator=gen, **kw))
    out["meanfield_multi_step"] = dict(ms=float(np.mean(ms)),
                                       plain_ms=plain_ms)
    print(f"B1 kernel {B * N * k / (np.mean(ms) / 1e3):.4e} particle-steps/s "
          f"(frames {', '.join(f'{m:.2f}' for m in ms)} ms); plain "
          f"{B * N * k / (plain_ms / 1e3):.4e} particle-steps/s "
          f"({plain_ms:.1f} ms per {k} steps)", flush=True)
    del st

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
    out["pde_multi_step"] = dict(ms=ms, plain_ms=plain_ms)
    print(f"B2 kernel {B * k / (ms / 1e3):.4e} replica-steps/s "
          f"({ms:.1f} ms per {k}-step chunk); plain "
          f"{B * k / (plain_ms / 1e3):.4e} replica-steps/s "
          f"({plain_ms:.1f} ms)", flush=True)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import hydrolim_tpu_torch  # noqa: F401  (sets TF32 off)
    from hydrolim_tpu_torch.ops import pde_kernel, stepper_kernel
    from hydrolim_tpu_torch.ops._build import BUILD_DIR, build_kernel_library

    dev = torch.device("cuda", 0)
    kinds = {"meanfield_multi_step": stepper_kernel,
             "pde_multi_step": pde_kernel}
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
        for name in kinds:
            t0 = time.perf_counter()
            so = build_kernel_library(name)
            print(f"built {so.name} in {time.perf_counter() - t0:.1f} s",
                  flush=True)
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

    print(json.dumps({"kernels": list(rows.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

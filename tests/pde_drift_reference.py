"""The large-lattice recipe's float32 drift on the CPU, by route.

The JAX package's large-lattice driver (``experiments/run_large_lattice.py``)
steps ``pde_step`` 1500 times at dt = 0.5·dx/λ, γ = 2.5·dx²/dt (c = 2.5:
the banded inverse's 97 taps equal the exact inverse to float32), from
(1.2·ρ₀[0], 0.8·ρ₀[1]).  This script runs, from those fields:

- ``jax banded``: the JAX XLA path itself (``diffusion_solver='banded'``);
- ``jax fft``: the JAX package's exact periodic solve (``'fft'``, native
  FFT) at the same recipe, another route of the reference;
- ``port plain``: the port's plain ``pde_step`` (torch, CPU), the plain
  version of kernel B2's fields;

and prints, every 375 steps, each route's mass against step 0's and its
total density's largest distance from ``jax banded``'s, relative to the
latter's largest value; and, once, the mass a banded solve adds to the
initial fields (its taps' float32 sum, and the solve alone in float32).
With ``--out FILE`` it also writes ``jax banded``'s snapshots
(``rho_<L>_<beta>``: (4, L) total densities at steps 375..1500), which
``hydrolim_tpu_torch/experiments/profile_pde_kernel.py --mode drift
--reference FILE`` holds kernel B2 against on the card.

Imports both packages (a test-side script); CPU only.

Usage: JAX_PLATFORMS=cpu PYTHONPATH=. python tests/pde_drift_reference.py
       [--lattice 8192 65536] [--beta 0.5 2.5] [--out FILE]
"""
from __future__ import annotations

import argparse
import json

import numpy as np

SNAPSHOTS = (375, 750, 1125, 1500)
LAM = 0.6


def recipe(L: int):
    dt = 0.5 / L / LAM
    return dt, 2.5 / L / L / dt


def jax_route(L: int, beta: float, rho0: np.ndarray, solver: str) -> list:
    """The JAX package's ``pde_step`` at the recipe with ``solver``
    ('banded' or 'fft'): total densities at ``SNAPSHOTS``."""
    import jax
    import jax.numpy as jnp

    from hydrolim_tpu.core.config import PDEConfig, make_pde_params
    from hydrolim_tpu.ops import dft
    from hydrolim_tpu.pde.stepper import build_pde_ops, pde_step

    dft.set_fft_mode("native")
    dt, gamma = recipe(L)
    cfg = PDEConfig(L=L, T=SNAPSHOTS[-1] * dt, dt=dt, bc="periodic",
                    gaussian_kernel=False, diffusion_solver=solver,
                    n_tracers=1)
    params = make_pde_params(gamma=gamma, lam=LAM, beta=beta)
    ops = build_pde_ops(cfg, params)

    @jax.jit
    def advance(rp, rm):
        def body(c, _):
            return pde_step(cfg, params, ops, c[0], c[1]), ()

        (rp, rm), _ = jax.lax.scan(body, (rp, rm), None, length=375)
        return rp, rm

    rp = jnp.asarray(1.2 * rho0[0], jnp.float32)
    rm = jnp.asarray(0.8 * rho0[1], jnp.float32)
    out = []
    for _ in SNAPSHOTS:
        rp, rm = advance(rp, rm)
        out.append(np.asarray(rp + rm, np.float64))
    return out


def port_plain(L: int, beta: float, rho0: np.ndarray) -> list:
    """The port's plain ``pde_step`` (the large-lattice driver's PDE half,
    ``large_lattice.pde_grid``) on the CPU: total densities at
    ``SNAPSHOTS``."""
    import torch

    from hydrolim_tpu_torch.core.config import make_pde_params
    from hydrolim_tpu_torch.experiments.large_lattice import pde_grid
    from hydrolim_tpu_torch.pde.stepper import build_pde_ops, pde_step

    cfg, gamma, _ = pde_grid(L, small=False)
    params = make_pde_params(gamma=gamma, lam=LAM, beta=beta, device="cpu")
    ops = build_pde_ops(cfg, gamma, "cpu")
    rp = torch.tensor(1.2 * rho0[0], dtype=torch.float32)
    rm = torch.tensor(0.8 * rho0[1], dtype=torch.float32)
    out, n = [], 0
    for target in SNAPSHOTS:
        for _ in range(target - n):
            rp, rm = pde_step(cfg, params, ops, rp, rm)
        n = target
        out.append((rp + rm).double().numpy())
    return out


def solve_mass(L: int, rho0: np.ndarray) -> dict:
    """What one banded solve does to the mass of the initial fields: the
    taps' sum − 1 (float64 and float32) and Σ(A⁻¹ρ)/Σρ − 1 of the port's
    float32 solve."""
    import torch

    from hydrolim_tpu_torch.experiments.large_lattice import pde_grid
    from hydrolim_tpu_torch.ops.convolve import banded_circular_conv
    from hydrolim_tpu_torch.ops.diffusion import banded_kernel

    cfg, gamma, _ = pde_grid(L, small=False)
    w = np.asarray(banded_kernel(cfg.dx, cfg.dt, gamma), np.float32)
    x = torch.tensor(np.stack([1.2 * rho0[0], 0.8 * rho0[1]]),
                     dtype=torch.float32)
    y = banded_circular_conv(x, w)
    return dict(taps=len(w), taps_sum_f64=float(w.astype(np.float64).sum()
                                                - 1.0),
                taps_sum_f32=float(np.float32(w.sum(dtype=np.float32)) - 1),
                solve_mass=float(y.double().sum() / x.double().sum() - 1.0))


def readings(L: int, beta: float, seed: int = 0, bi: int = 0) -> dict:
    """Every route's snapshots and their readings at one (L, β)."""
    from hydrolim_tpu_torch.experiments.large_lattice import pde_rho0

    rho0 = pde_rho0(L, seed, bi)
    mass0 = sum(float(np.float32(c * rho0[i]).astype(np.float64).sum())
                for i, c in ((0, 1.2), (1, 0.8)))
    routes = {"jax banded": jax_route(L, beta, rho0, "banded"),
              "jax fft": jax_route(L, beta, rho0, "fft"),
              "port plain": port_plain(L, beta, rho0)}
    ref = routes["jax banded"]
    rows = []
    for j, n in enumerate(SNAPSHOTS):
        scale = np.abs(ref[j]).max()
        rows.append(dict(step=n, **{
            name: dict(mass=float(s[j].sum() / mass0 - 1.0),
                       from_jax=float(np.abs(s[j] - ref[j]).max() / scale))
            for name, s in routes.items()}))
    return dict(L=L, beta=beta, solve=solve_mass(L, rho0), rows=rows,
                snapshots=np.stack(ref))


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--lattice", type=int, nargs="+", default=[8192, 65536])
    p.add_argument("--beta", type=float, nargs="+", default=[0.5, 2.5])
    p.add_argument("--out", default="")
    a = p.parse_args()
    snaps = {}
    for L in a.lattice:
        for bi, beta in enumerate(a.beta):
            r = readings(L, beta, bi=bi)
            snaps[f"rho_{L}_{beta}"] = r.pop("snapshots").astype(np.float32)
            print(json.dumps(r), flush=True)
    if a.out:
        np.savez_compressed(a.out, **snaps)


if __name__ == "__main__":
    main()

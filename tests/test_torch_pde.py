"""Kernel B2 of the PyTorch port against the JAX package, on the CPU.

The JAX fused PDE kernel runs as ``test_kernel_logic_cpu.py`` runs it
(``interpret=True`` with injected bits); the port's ``pde_multi_step`` gets
the same state and bits through ``interop`` and, on CPU tensors, runs its
plain version.  Tolerances are those of ``test_kernel_logic_cpu.py``:
different matmul shapes and summation orders, same arithmetic.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hydrolim_tpu.core.config import PDEConfig as JPDEConfig
from hydrolim_tpu_torch import interop
from hydrolim_tpu_torch.ops.diffusion import (
    build_dense_inverse,
    diffusion_solve,
    tridiag_factors,
    tridiag_solve,
)
from hydrolim_tpu_torch.ops.pde_kernel import (
    build_solve_operands,
    pde_multi_step,
)


@pytest.mark.parametrize("gamma", [0.2, 0.0])
def test_b2_plain_matches_jax_kernel(gamma):
    """Global m, periodic, bidirectional; L=128, n_t=48, window 6, two
    chained 14-step chunks (ring-buffer continuity across calls), two
    replicas with distinct β, kmax_rec=8 spectra."""
    from hydrolim_tpu.ops.pallas_pde import _pad
    from hydrolim_tpu.ops.pallas_pde import pde_multi_step as j_pde
    from hydrolim_tpu.pde.fast_solve import (
        build_fft_record_slab,
        build_kernel_mats,
    )
    from hydrolim_tpu.pde.init import pde_initialize

    L, n_t, dt, lam = 128, 48, 5e-5, 0.6
    k_steps, window, kmax, B = 14, 6, 8, 2
    betas = np.array([1.4, 0.6], np.float32)
    config = JPDEConfig(L=L, T=2 * k_steps * dt, dt=dt, bc="periodic",
                        active_model="bidirectional", gaussian_kernel=True,
                        kernel_sigma=2e5, snapshot_interval=k_steps,
                        n_tracers=n_t, tracer_window_time=window * dt,
                        diffusion_solver="dense", fft_kmax=kmax)
    assert config.tracer_window == window
    Lp, Ntp, Wp = _pad(L), _pad(n_t), _pad(window, 8)
    solve_mat, smooth_mat, solve_mode, solve_r, solve_wts = \
        build_kernel_mats(config, gamma, Lp)
    assert solve_mode == ("dense" if gamma > 0 else "none")
    slab = build_fft_record_slab(config, Lp)

    inits = [pde_initialize(config, jax.random.PRNGKey(1 + r),
                            mode="homogeneous", noise=0.3, n_tracers=n_t)
             for r in range(B)]
    rp0 = np.stack([np.asarray(i[0]) for i in inits])
    rm0 = np.stack([np.asarray(i[1]) for i in inits])
    pos0 = np.stack([np.asarray(i[2].unwrapped) for i in inits])
    spin0 = np.stack([np.asarray(i[2].spin, np.float32) for i in inits])
    rng = np.random.default_rng(13)
    bits = rng.integers(0, 2 ** 32, (B, 2 * k_steps, 3, 1, Ntp),
                        dtype=np.uint32)

    # ---- JAX fused kernel, interpret mode, padded lanes ----
    jscal = np.zeros((B, 4), np.float32)
    jscal[:, 0], jscal[:, 1] = betas, lam
    jscal[:, 2] = np.float32(np.sqrt(2.0 * gamma * dt))
    st = [jnp.asarray(interop.pad(a, Lp)) for a in (rp0, rm0)] + \
        [jnp.asarray(interop.pad(a, Ntp)) for a in (pos0, spin0)] + \
        [jnp.zeros((B, Wp, Ntp), jnp.float32)]
    jrecs = []
    for c in range(2):
        sl = slice(c * k_steps, (c + 1) * k_steps)
        *st, rec = j_pde(
            jnp.asarray(jscal), jnp.zeros((B,), jnp.int32),
            jnp.full((B,), c * k_steps, jnp.int32), *st,
            jnp.asarray(solve_mat), jnp.asarray(smooth_mat),
            solve_wts=jnp.asarray(solve_wts), fft_slab=jnp.asarray(slab),
            L=L, n_t=n_t, window=window, k_steps=k_steps, dt=dt,
            dx=config.dx, xlim=config.xlim, periodic=True, m_mode="global",
            solve_mode=solve_mode, solve_r=solve_r, bidirectional=True,
            has_noise=gamma > 0, kmax_rec=kmax, interpret=True,
            noise=jnp.asarray(bits[:, sl]))
        jrecs.append(interop.pde_records(np.asarray(rec), kmax,
                                         device="cpu").numpy())
    jrecs = np.concatenate(jrecs, axis=1)

    # ---- port, unpadded, plain version on CPU tensors ----
    port_mode = "exact" if gamma > 0 else "none"
    solve = build_solve_operands(L, config.dx, dt, gamma, True, port_mode,
                                 device="cpu")
    pst = [interop.to_torch(a, torch.float32, device="cpu")
           for a in (rp0, rm0, pos0, spin0)]
    pst.append(torch.zeros((B, window, n_t)))
    precs = []
    for c in range(2):
        sl = slice(c * k_steps, (c + 1) * k_steps)
        *pst, rec = pde_multi_step(
            interop.pde_scalars(betas, lam, gamma, device="cpu"),
            torch.zeros(B, dtype=torch.int32), c * k_steps, *pst, solve,
            L=L, n_t=n_t, window=window, k_steps=k_steps, dt=dt,
            xlim=config.xlim, periodic=True, m_mode="global",
            solve_mode=port_mode, bidirectional=True, kmax_rec=kmax,
            noise=interop.pde_noise(bits[:, sl], n_t, device="cpu"))
        precs.append(rec.numpy())
    precs = np.concatenate(precs, axis=1)
    assert pde_multi_step.launches == 0

    unpad = lambda a, *s: interop.unpad(np.asarray(a), *s,
                                        device="cpu").numpy()
    jst = [unpad(a, L) for a in st[:2]] + [unpad(a, n_t) for a in st[2:4]] + \
        [unpad(st[4], window, n_t)]
    pst = [t.numpy() for t in pst]
    # fields to f32 roundoff
    for got, want in zip(pst[:2], jst[:2]):
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-7)
    # tracers: same flips, same noise → trajectories track; ring too
    np.testing.assert_allclose(pst[2], jst[2], rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(pst[3], jst[3])
    np.testing.assert_allclose(pst[4], jst[4], rtol=1e-4, atol=1e-5)
    # windowed v/D records, incl. the NaN warmup prefix
    for col in (2, 3):
        assert np.isnan(precs[:, :window, col]).all()
        assert np.isnan(jrecs[:, :window, col]).all()
        np.testing.assert_allclose(precs[:, window:, col],
                                   jrecs[:, window:, col],
                                   rtol=5e-4, atol=1e-6)
    np.testing.assert_allclose(precs[..., 0], jrecs[..., 0],
                               rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(precs[..., 1], jrecs[..., 1],
                               rtol=1e-3, atol=1e-12)
    # per-step spectra, bins 0..7 re then im
    np.testing.assert_allclose(precs[..., 4:], jrecs[..., 4:],
                               rtol=1e-4, atol=1e-9)
    # the dynamics actually moved
    assert np.abs(pst[2] - pos0).max() > 0
    assert np.abs(pst[0] - rp0).max() > 1e-6


@pytest.mark.parametrize("bc,active_model,global_m", [
    ("periodic", "bidirectional", True),
    ("neumann", "anchored_minus", False),
    ("periodic", "anchored_minus", True),
])
def test_pde_step_and_magnetization_match_jax(bc, active_model, global_m):
    """The plain B2's building blocks, batched, against the JAX stepper:
    magnetization (global sentinel or pointwise) and 20 IMEX steps of both
    branches and both boundary conditions with the dense solve."""
    from hydrolim_tpu.core.config import make_pde_params
    from hydrolim_tpu.pde.stepper import build_pde_ops
    from hydrolim_tpu.pde.stepper import magnetization as j_mag
    from hydrolim_tpu.pde.stepper import pde_step as j_step

    from hydrolim_tpu_torch.core.config import PDEConfig, PDEParams
    from hydrolim_tpu_torch.pde.stepper import build_pde_ops as p_ops
    from hydrolim_tpu_torch.pde.stepper import magnetization, pde_step

    kw = dict(L=64, dt=2e-4, bc=bc, active_model=active_model,
              gaussian_kernel=global_m, kernel_sigma=2e5,
              diffusion_solver="dense")
    jcfg, cfg = JPDEConfig(**kw), PDEConfig(**kw)
    rng = np.random.default_rng(4)
    rp = rng.uniform(0.5, 1.5, (2, 64)).astype(np.float32) / 128
    rm = rng.uniform(0.5, 1.5, (2, 64)).astype(np.float32) / 128
    betas = np.array([0.7, 2.2], np.float32)
    params = PDEParams(gamma=torch.full((2,), 0.2), lam=torch.full((2,), 0.6),
                       beta=torch.tensor(betas))
    ops = p_ops(cfg, 0.2, device="cpu")
    jops = build_pde_ops(jcfg, make_pde_params(gamma=0.2, lam=0.6, beta=0.0))
    trp, trm = torch.tensor(rp), torch.tensor(rm)
    for _ in range(20):
        m = magnetization(cfg, ops, trp, trm)
        jm = [j_mag(jcfg, jops, jnp.asarray(rp[b]), jnp.asarray(rm[b]))
              for b in range(2)]
        # |m| ≤ 1 is a ratio of fields held to f32 roundoff: absolute
        np.testing.assert_allclose(m.numpy(), np.stack(jm), rtol=0,
                                   atol=1e-5)
        trp, trm = pde_step(cfg, params, ops, trp, trm, m=m)
        out = [j_step(jcfg, make_pde_params(gamma=0.2, lam=0.6,
                                            beta=float(betas[b])), jops,
                      jnp.asarray(rp[b]), jnp.asarray(rm[b]), m=jm[b])
               for b in range(2)]
        rp = np.stack([np.asarray(o[0]) for o in out])
        rm = np.stack([np.asarray(o[1]) for o in out])
    np.testing.assert_allclose(trp.numpy(), rp, rtol=2e-4, atol=1e-7)
    np.testing.assert_allclose(trm.numpy(), rm, rtol=2e-4, atol=1e-7)


@pytest.mark.parametrize("L,gamma,dt", [(16, 0.2, 5e-4), (128, 0.2, 5e-5),
                                        (1000, 0.2, 5e-4)])
def test_cyclic_tridiag_factors_match_dense_inverse(L, gamma, dt):
    """Kernel B2's solve (Thomas + Sherman–Morrison, factored in float64,
    applied in f32) against the JAX package's float64 dense inverse, up to
    c = γ·dt/dx² = 100 (the β sweep's L=1000, dt=5e-4)."""
    from hydrolim_tpu.ops.diffusion import build_diffusion_op

    dx = 1.0 / L
    rng = np.random.default_rng(L)
    x = rng.uniform(0.0, 2.0 / L, (3, L)).astype(np.float32)
    a_inv = np.asarray(build_diffusion_op(L, dx, dt, gamma, "periodic",
                                          "dense").a_inv, np.float64)
    want = x.astype(np.float64) @ a_inv.T
    f = tridiag_factors(L, dx, dt, gamma, "periodic", device="cpu")
    got = tridiag_solve(f, torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-9)
    dense = diffusion_solve(build_dense_inverse(L, dx, dt, gamma, "periodic",
                                                device="cpu"),
                            torch.tensor(x), "dense").numpy()
    np.testing.assert_allclose(dense, want, rtol=1e-5, atol=1e-9)


def test_interop_pde_layouts_round_trip():
    """(B, Lp) fields, (B, Ntp) tracers and the (B, Wp, Ntp) ring go to the
    port's unpadded layout and back unchanged (zero padding lanes), and a
    vmapped JAX TracerState survives the trip."""
    from hydrolim_tpu.pde.stepper import TracerState as JTracerState

    rng = np.random.default_rng(0)
    B, L, Lp, n_t, Ntp, W, Wp = 3, 100, 128, 50, 128, 6, 8
    fields = np.zeros((B, Lp), np.float32)
    fields[:, :L] = rng.random((B, L))
    tr = np.zeros((B, Ntp), np.float32)
    tr[:, :n_t] = rng.random((B, n_t))
    ring = np.zeros((B, Wp, Ntp), np.float32)
    ring[:, :W, :n_t] = rng.random((B, W, n_t))
    np.testing.assert_array_equal(
        interop.pad(interop.unpad(fields, L, device="cpu"), Lp), fields)
    np.testing.assert_array_equal(
        interop.pad(interop.unpad(tr, n_t, device="cpu"), Ntp), tr)
    np.testing.assert_array_equal(
        interop.pad(interop.unpad(ring, W, n_t, device="cpu"), Wp, Ntp), ring)

    jtr = JTracerState(pos=jnp.asarray(tr[:, :n_t]),
                       unwrapped=jnp.asarray(tr[:, :n_t] + 3.0),
                       spin=jnp.asarray(rng.choice([-1, 1], (B, n_t)),
                                        jnp.int32),
                       hist=jnp.asarray(ring[:, :W, :n_t]))
    back = JTracerState(**interop.tracer_state_arrays(
        interop.tracer_state(jtr, device="cpu")))
    for a, b in zip(back, jtr):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert np.asarray(a).dtype == np.asarray(b).dtype

    # the kernel noise layout: (G, k, 3, R, Ntp) → (G·R, k, 3, n_t)
    bits = rng.integers(0, 2 ** 32, (2, 4, 3, 2, Ntp), dtype=np.uint32)
    got = interop.pde_noise(bits, n_t, device="cpu").numpy().view(np.uint32)
    np.testing.assert_array_equal(got[3], bits[1, :, :, 1, :n_t])


def test_interop_particle_lanes_round_trip():
    """(B, R, 128) particle lanes with σ=0 padding → (B, n) → lanes,
    unchanged."""
    from hydrolim_tpu.ops.pallas_stepper import pack_particles

    rng = np.random.default_rng(5)
    B, n, L = 2, 300, 64
    lanes = [np.asarray(a) for a in pack_particles(
        rng.integers(0, L, (B, n)), rng.choice([-1, 1], (B, n)),
        rng.integers(-3, 3, (B, n)))]
    assert (lanes[1].reshape(B, -1)[:, n:] == 0).all()     # σ = 0 padding
    for a in lanes:
        rows = interop.lanes_to_rows(a, n, device="cpu")
        assert rows.shape == (B, n) and rows.dtype == torch.int32
        np.testing.assert_array_equal(interop.rows_to_lanes(rows), a)

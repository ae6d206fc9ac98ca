"""Every mode of kernel B2 in the PyTorch port against the JAX package, on
the CPU.

(a) The plain B2 (``pde_multi_step`` on CPU tensors) against the JAX fused
    PDE kernel in interpret mode at injected bits, over the covering set of
    magnetization modes (pointwise, narrow, smooth, global), boundaries,
    active models and solves (exact, banded, none), one case with the full
    rfft of the fields recorded per step.  L=128, n_t=48, window 6, two
    chained 14-step chunks (the sizes of ``test_kernel_logic_cpu.py``).
(b) The operands against their JAX builders: narrow and banded taps, the
    routing, the Neumann tridiagonal factors, the banded solves and the
    smoothed PDE magnetization.
(c) The slice: the ``IMEXPDE`` facade and ``pde_kernel_sigma_sweep`` on
    ``device="cpu"`` against the JAX XLA engine from the same JAX-made
    initial state.  At γ = 0 the fields are deterministic, so the fields
    and the m, Var and spectra records agree over every step.

Tolerances are those of ``test_kernel_logic_cpu.py``: fields rtol 2e-4 /
atol 1e-7, tracers rtol 1e-4 / atol 1e-5, spins equal, v and D rtol 5e-4 /
atol 1e-6 (different summation orders, the same float32 arithmetic).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hydrolim_tpu.core.config import PDEConfig as JPDEConfig
from hydrolim_tpu_torch import interop
from hydrolim_tpu_torch.core.config import PDEConfig
from hydrolim_tpu_torch.ops.pde_kernel import pde_multi_step
from hydrolim_tpu_torch.pde import fast_solve as pfs

L, N_T, DT, LAM, K_STEPS, WINDOW, B = 128, 48, 5e-5, 0.6, 14, 6, 2
BETAS = np.array([1.4, 0.6], np.float32)

# (gaussian_kernel, kernel_sigma, bc, active_model, gamma, solver, kmax)
COVERING = {
    "pointwise-periodic-bidirectional-exact":
        (False, 0.02, "periodic", "bidirectional", 0.2, "dense", 8),
    "narrow-periodic-bidirectional-none":
        (True, 0.005, "periodic", "bidirectional", 0.0, "auto", 8),
    "smooth-neumann-anchored-exact":
        (True, 0.15, "neumann", "anchored_minus", 0.2, "dense", 8),
    "global-periodic-bidirectional-banded":
        (True, 2e5, "periodic", "bidirectional", 0.2, "banded", 8),
    "pointwise-periodic-anchored-banded":
        (False, 0.02, "periodic", "anchored_minus", 0.2, "banded", 8),
    "global-neumann-bidirectional-exact-full-rfft":
        (True, 2e5, "neumann", "bidirectional", 0.2, "dense", L // 2 + 1),
}


def _configs(gk, sigma, bc, model, gamma, solver, kmax):
    kw = dict(L=L, T=2 * K_STEPS * DT, dt=DT, bc=bc, active_model=model,
              gaussian_kernel=gk, kernel_sigma=sigma,
              snapshot_interval=K_STEPS, n_tracers=N_T,
              tracer_window_time=WINDOW * DT,
              diffusion_solver="identity" if gamma == 0 else solver,
              fft_kmax=kmax)
    return JPDEConfig(**kw), PDEConfig(**kw)


def _jax_initial_state(jcfg, n_rep, seed=1):
    from hydrolim_tpu.pde.init import pde_initialize

    inits = [pde_initialize(jcfg, jax.random.PRNGKey(seed + r),
                            mode="homogeneous", noise=0.3, n_tracers=N_T)
             for r in range(n_rep)]
    return [np.stack([np.asarray(f(i)) for i in inits]) for f in (
        lambda i: i[0], lambda i: i[1], lambda i: i[2].unwrapped,
        lambda i: np.asarray(i[2].spin, np.float32))]


@pytest.mark.parametrize("case", list(COVERING))
def test_b2_plain_matches_jax_kernel_in_every_mode(case):
    from hydrolim_tpu.ops.pallas_pde import _pad
    from hydrolim_tpu.ops.pallas_pde import pde_multi_step as j_pde
    from hydrolim_tpu.pde import fast_solve as jfs

    gk, sigma, bc, model, gamma, solver, kmax = COVERING[case]
    jcfg, cfg = _configs(*COVERING[case])
    assert jcfg.tracer_window == WINDOW
    Lp, Ntp, Wp = _pad(L), _pad(N_T), _pad(WINDOW, 8)
    periodic, bidi = bc == "periodic", model == "bidirectional"

    # ---- the JAX kernel's operands and modes, and the port's ----
    j_m_mode = jfs._m_mode(jcfg)
    solve_mat, smooth_mat, j_solve, solve_r, solve_wts = \
        jfs.build_kernel_mats(jcfg, gamma, Lp)
    narrow_r = jfs._narrow_radius(jcfg) if j_m_mode == "narrow" else 0
    wts = jfs.build_narrow_weights(jcfg) if j_m_mode == "narrow" else None
    m_mode, solve_mode, smooth, solve = pfs.kernel_operands(cfg, gamma,
                                                            "cpu")
    assert m_mode == j_m_mode == case.split("-")[0]
    assert solve_mode == {"dense": "exact"}.get(j_solve, j_solve)
    assert case.split("-")[3] == solve_mode
    per_step = kmax <= 62          # else the JAX side takes rfft per step
    slab = jfs.build_fft_record_slab(jcfg, Lp) if per_step else None

    rp0, rm0, pos0, spin0 = _jax_initial_state(jcfg, B)
    rng = np.random.default_rng(13)
    bits = rng.integers(0, 2 ** 32, (B, 2 * K_STEPS, 3, 1, Ntp),
                        dtype=np.uint32)
    bits[:, ::4, 0, :, ::5] = 0     # u = 0: 7 flips (rate·dt is ~1e-4)

    # ---- JAX fused kernel, interpret mode, padded lanes ----
    jscal = np.zeros((B, 4), np.float32)
    jscal[:, 0], jscal[:, 1] = BETAS, LAM
    jscal[:, 2] = np.float32(np.sqrt(2.0 * gamma * DT))
    st = [jnp.asarray(interop.pad(a, Lp)) for a in (rp0, rm0)] + \
        [jnp.asarray(interop.pad(a, Ntp)) for a in (pos0, spin0)] + \
        [jnp.zeros((B, Wp, Ntp), jnp.float32)]
    call = dict(wts=None if wts is None else jnp.asarray(wts),
                solve_wts=jnp.asarray(solve_wts),
                fft_slab=None if slab is None else jnp.asarray(slab),
                L=L, n_t=N_T, window=WINDOW, dt=DT, dx=jcfg.dx,
                xlim=jcfg.xlim, periodic=periodic, m_mode=j_m_mode,
                narrow_r=narrow_r, solve_mode=j_solve, solve_r=solve_r,
                bidirectional=bidi, has_noise=gamma > 0,
                kmax_rec=kmax if per_step else 0, interpret=True)
    chunks = [(c * K_STEPS, K_STEPS) for c in range(2)] if per_step \
        else [(n, 1) for n in range(2 * K_STEPS)]
    jrecs = []
    for n0, k in chunks:
        if not per_step:
            tot = np.asarray(st[0] + st[1], np.float64)[:, :L]
            X = np.fft.rfft(tot, axis=-1)[:, :kmax] / L
            spec = np.concatenate([X.real, X.imag], -1)[:, None]
        *st, rec = j_pde(
            jnp.asarray(jscal), jnp.zeros((B,), jnp.int32),
            jnp.full((B,), n0, jnp.int32), *st,
            jnp.asarray(solve_mat), jnp.asarray(smooth_mat),
            k_steps=k, noise=jnp.asarray(bits[:, n0:n0 + k]), **call)
        rec = interop.pde_records(np.asarray(rec), kmax if per_step else 0,
                                  device="cpu").numpy()
        jrecs.append(rec if per_step else np.concatenate([rec, spec], -1))
    jrecs = np.concatenate(jrecs, axis=1)

    # ---- port, unpadded, plain version on CPU tensors ----
    pst = [interop.to_torch(a, torch.float32, device="cpu")
           for a in (rp0, rm0, pos0, spin0)]
    pst.append(torch.zeros((B, WINDOW, N_T)))
    precs = []
    for c in range(2):
        sl = slice(c * K_STEPS, (c + 1) * K_STEPS)
        *pst, rec = pde_multi_step(
            interop.pde_scalars(BETAS, LAM, gamma, device="cpu"),
            torch.zeros(B, dtype=torch.int32), c * K_STEPS, *pst, solve,
            smooth, L=L, n_t=N_T, window=WINDOW, k_steps=K_STEPS, dt=DT,
            xlim=cfg.xlim, periodic=periodic, m_mode=m_mode,
            solve_mode=solve_mode, bidirectional=bidi, kmax_rec=kmax,
            noise=interop.pde_noise(bits[:, sl], N_T, device="cpu"))
        precs.append(rec.numpy())
    precs = np.concatenate(precs, axis=1)
    assert pde_multi_step.launches == 0

    unpad = lambda a, *s: interop.unpad(np.asarray(a), *s,
                                        device="cpu").numpy()
    jst = [unpad(a, L) for a in st[:2]] + [unpad(a, N_T) for a in st[2:4]] \
        + [unpad(st[4], WINDOW, N_T)]
    pst = [t.numpy() for t in pst]
    for got, want in zip(pst[:2], jst[:2]):
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-7)
    np.testing.assert_allclose(pst[2], jst[2], rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(pst[3], jst[3])
    np.testing.assert_allclose(pst[4], jst[4], rtol=1e-4, atol=1e-5)
    for col in (2, 3):
        assert np.isnan(precs[:, :WINDOW, col]).all()
        assert np.isnan(jrecs[:, :WINDOW, col]).all()
        np.testing.assert_allclose(precs[:, WINDOW:, col],
                                   jrecs[:, WINDOW:, col],
                                   rtol=5e-4, atol=1e-6)
    np.testing.assert_allclose(precs[..., 0], jrecs[..., 0], rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(precs[..., 1], jrecs[..., 1], rtol=1e-3,
                               atol=1e-12)
    assert precs.shape[-1] == 4 + 2 * kmax
    np.testing.assert_allclose(precs[..., 4:], jrecs[..., 4:], rtol=1e-4,
                               atol=1e-9)
    # the dynamics moved
    assert np.abs(pst[2] - pos0).max() > 0
    assert np.abs(pst[0] - rp0).max() > 1e-6
    assert (pst[3] != spin0).any()


# ---------------------------------------------------------------------------
# (b) operands and routing against the JAX builders
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("L_,sigma", [(128, 0.005), (128, 0.05),
                                      (128, 0.15), (1000, 0.0005),
                                      (1000, 0.005), (1000, 0.05),
                                      (1000, 1.0), (1000, 1e5 - 10),
                                      (8192, 0.002)])
def test_m_mode_routing_and_narrow_weights_match_jax(L_, sigma):
    from hydrolim_tpu.pde import fast_solve as jfs

    kw = dict(L=L_, gaussian_kernel=True, kernel_sigma=sigma)
    jcfg, cfg = JPDEConfig(**kw), PDEConfig(**kw)
    assert pfs._m_mode(cfg) == jfs._m_mode(jcfg)
    if pfs._m_mode(cfg) == "narrow":
        r = pfs._narrow_radius(cfg)
        assert r == jfs._narrow_radius(jcfg) and r % 16 == 0 or r == 63
        want = interop.taps(jfs.build_narrow_weights(jcfg), r, device="cpu")
        np.testing.assert_array_equal(pfs.build_narrow_weights(cfg),
                                      want.numpy())
    pointwise = dataclasses.replace(cfg, gaussian_kernel=False)
    assert pfs._m_mode(pointwise) == "pointwise"


@pytest.mark.parametrize("L_,dt,solver,want", [
    (8192, 2e-7, "banded", "banded"),      # the JAX bench's large-L shape
    (512, 1e-6, "banded", "banded"),       # an explicit banded stays banded
    (512, 1e-6, "auto", "exact"),
    (1000, 5e-4, "auto", "exact"),         # c = 100: exact, as JAX's dense
])
def test_solve_routing_and_banded_weights_match_jax(L_, dt, solver, want):
    from hydrolim_tpu.pde import fast_solve as jfs

    gamma = 0.2
    kw = dict(L=L_, dt=dt, T=dt * 10, bc="periodic", snapshot_interval=10,
              diffusion_solver=solver)
    jcfg, cfg = JPDEConfig(**kw), PDEConfig(**kw)
    mode, r = pfs._solve_mode_of(cfg, gamma)
    assert mode == want
    jmode, jr = jfs._solve_mode_of(jcfg, gamma)
    if want == "banded":
        assert (jmode, jr) == (mode, r)
        got = pfs.build_banded_solve_weights(cfg, gamma, r)
        np.testing.assert_array_equal(
            got, interop.taps(jfs.build_banded_solve_weights(jcfg, gamma, r),
                              r, device="cpu").numpy())
    assert pfs._solve_mode_of(dataclasses.replace(cfg, dt=dt), 0.0) == \
        ("none", 0)


@pytest.mark.parametrize("L_,dt", [(16, 5e-4), (128, 5e-5), (1000, 5e-4)])
def test_neumann_tridiag_factors_match_dense_inverse(L_, dt):
    """Kernel B2's Neumann solve (plain Thomas, the mirrored rows' 2c in
    the per-row sub-diagonal and c'_0) against the JAX float64 dense
    inverse, up to c = 100."""
    from hydrolim_tpu.ops.diffusion import build_diffusion_op

    from hydrolim_tpu_torch.ops.diffusion import tridiag_factors, tridiag_solve

    gamma, dx = 0.2, 1.0 / L_
    x = np.random.default_rng(L_).uniform(0.0, 2.0 / L_, (3, L_)).astype(
        np.float32)
    a_inv = np.asarray(build_diffusion_op(L_, dx, dt, gamma, "neumann",
                                          "dense").a_inv, np.float64)
    f = tridiag_factors(L_, dx, dt, gamma, "neumann", device="cpu")
    assert f.rows.shape == (4, L_) and float(f.rows[3, -1]) == pytest.approx(
        2 * float(f.rows[3, 1]))
    got = tridiag_solve(f, torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, x.astype(np.float64) @ a_inv.T,
                               rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize("bc", ["periodic", "neumann"])
def test_banded_diffusion_solve_matches_jax(bc):
    from hydrolim_tpu.ops.diffusion import build_diffusion_op
    from hydrolim_tpu.ops.diffusion import diffusion_solve as j_solve

    from hydrolim_tpu_torch.ops.diffusion import banded_kernel, diffusion_solve

    L_, dt, gamma = 256, 2e-6, 0.2
    kind = "banded" if bc == "periodic" else "banded_dct"
    op = build_diffusion_op(L_, 1.0 / L_, dt, gamma, bc, kind)
    w = banded_kernel(1.0 / L_, dt, gamma)
    np.testing.assert_array_equal(w, np.asarray(op.denom))
    x = np.random.default_rng(2).random((2, L_)).astype(np.float32)
    got = diffusion_solve(torch.tensor(w), torch.tensor(x), kind).numpy()
    np.testing.assert_allclose(got, np.asarray(j_solve(op, jnp.asarray(x),
                                                       kind)),
                               rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("sigma", [0.005, 0.15, 1.0, 2e5])
def test_smoothed_pde_magnetization_matches_jax(sigma):
    """The full periodic circulant (no clip) below the sentinel, the
    global mean above it, against the JAX builder's operator."""
    from hydrolim_tpu.core.config import make_pde_params
    from hydrolim_tpu.pde.stepper import build_pde_ops as j_ops
    from hydrolim_tpu.pde.stepper import magnetization as j_mag

    from hydrolim_tpu_torch.pde.stepper import build_pde_ops, magnetization

    kw = dict(L=L, gaussian_kernel=True, kernel_sigma=sigma)
    jcfg, cfg = JPDEConfig(**kw), PDEConfig(**kw)
    rng = np.random.default_rng(5)
    rp = rng.uniform(0.2, 1.8, (3, L)).astype(np.float32) / L
    rm = rng.uniform(0.2, 1.8, (3, L)).astype(np.float32) / L
    ops = build_pde_ops(cfg, 0.2, device="cpu")
    got = magnetization(cfg, ops, torch.tensor(rp), torch.tensor(rm))
    jops = j_ops(jcfg, make_pde_params(gamma=0.2, lam=0.6, beta=1.0))
    want = np.stack([np.asarray(j_mag(jcfg, jops, jnp.asarray(rp[b]),
                                      jnp.asarray(rm[b]))) for b in range(3)])
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    spread = np.ptp(want, axis=-1).max()
    assert spread == 0 if sigma > 1e5 else spread > 1e-3


# ---------------------------------------------------------------------------
# (c) the slice: facade and σ sweep against the JAX XLA engine
# ---------------------------------------------------------------------------

FACADE_KW = dict(L=L, T=0.25, dt=1e-3, gamma=0.0, lam=0.6, beta=2.0,
                 bc="periodic", active_model="bidirectional",
                 gaussian_kernel=True, kernel_sigma=0.005,
                 snapshot_interval=50, seed=58)


def test_imexpde_solve_matches_jax_facade(tmp_path):
    """The port's facade (``solve()``: pde_solve_fused, the plain B2 on
    the CPU, narrow m) from the JAX facade's initial state against the JAX
    facade's default XLA solve: the same output keys and shapes, per-step
    spectra at the full rfft (no NaN rows), the fields, the m / Var /
    spectra series and the snapshots to the fields' tolerance."""
    from hydrolim_tpu.pde.system import IMEXPDE as JIMEXPDE

    from hydrolim_tpu_torch.pde.system import IMEXPDE

    js = JIMEXPDE(outdir=str(tmp_path / "j"), **FACADE_KW)
    js.initialize(mode="homogeneous", rho0=1.0, noise=0.3, n_tracers=200)
    js.solve()
    jout = js.get_output()

    ps = IMEXPDE(outdir=str(tmp_path / "p"), device="cpu", **FACADE_KW)
    ps.initialize(mode="homogeneous", rho0=1.0, noise=0.3, n_tracers=200)
    ps.rho_p, ps.rho_m, ps.tracers = interop.imexpde_state(js, device="cpu")
    ps.solve()
    pout = ps.get_output()
    assert pde_multi_step.launches == 0

    assert set(pout) == set(jout)
    for k in jout:
        assert pout[k].shape == jout[k].shape, k
        assert pout[k].dtype == jout[k].dtype, k
    assert pout["fft_amp"].shape == (251, L // 2 + 1)
    assert np.isfinite(pout["fft_amp"]).all()
    for k in ("rho_p", "rho_m", "snapshots", "m_snapshots", "fft_amp"):
        np.testing.assert_allclose(pout[k], jout[k], rtol=2e-4, atol=1e-7,
                                   err_msg=k)
    np.testing.assert_allclose(pout["m_series"], jout["m_series"],
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(pout["var_series"], jout["var_series"],
                               rtol=1e-3, atol=1e-12)
    np.testing.assert_allclose(pout["fft_phase"], jout["fft_phase"],
                               rtol=2e-4, atol=1e-7)
    np.testing.assert_allclose(pout["times"], jout["times"])
    W = ps.config.tracer_window
    for k in ("v_eff_series", "D_eff_series"):
        assert np.isnan(pout[k][:W]).all() and np.isfinite(pout[k][W:]).all()
    # β = 2 orders the field: |m| grew from the initial noise
    assert abs(pout["m_series"][-1]) > abs(pout["m_series"][0])


def test_kernel_sigma_sweep_matches_jax(monkeypatch):
    """``pde_kernel_sigma_sweep(variant='magn')`` (γ = 0) at a narrow and a
    smooth σ, each from the JAX sweep's own initial states (seed
    base + 1000·k, one key per run): |m| and Var over every step agree with
    the JAX XLA sweep; v and D share the NaN warm-up and are finite after
    it."""
    from hydrolim_tpu.pde.init import pde_initialize as j_init
    from hydrolim_tpu.sweeps.pde_sweeps import pde_kernel_sigma_sweep as j_sw

    from hydrolim_tpu_torch.sweeps import pde_sweeps as psw

    kw = dict(kernel_sigma_values=[0.005, 0.15], n_runs=2, variant="magn",
              base_seed=100, L=L, dt=1e-3, n_tracers=50, T=0.2,
              plot_result=False)
    jres = j_sw(engine="xla", **kw)

    states = []
    for k_idx, sigma in enumerate(kw["kernel_sigma_values"]):
        jcfg = JPDEConfig(L=L, T=0.2, dt=1e-3, gaussian_kernel=True,
                          kernel_sigma=sigma)
        keys = jax.random.split(jax.random.PRNGKey(100 + 1000 * k_idx), 2)
        rp, rm, tr = jax.vmap(lambda k: j_init(
            jcfg, k, mode="homogeneous", rho0=1.0, noise=0.3,
            n_tracers=50))(keys)
        states.append((interop.to_torch(np.asarray(rp), torch.float32, "cpu"),
                       interop.to_torch(np.asarray(rm), torch.float32, "cpu"),
                       interop.tracer_state(jax.device_get(tr), "cpu")))

    def from_jax(config, generator, *, B, mode, rho0, noise, n_tracers,
                 device):
        assert (B, mode, rho0, noise, n_tracers) == (2, "homogeneous", 1.0,
                                                     0.3, 50)
        return states.pop(0)

    monkeypatch.setattr(psw, "pde_initialize", from_jax)
    pres = psw.pde_kernel_sigma_sweep(device="cpu", **kw)
    assert not states and pde_multi_step.launches == 0
    assert (pres["T"], pres["gamma"], pres["beta"]) == (0.2, 0.0, 0.5)
    for sigma in kw["kernel_sigma_values"]:
        assert pres["m"][sigma].shape == (2, 201)
        np.testing.assert_allclose(pres["m"][sigma], jres["m"][sigma],
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(pres["var"][sigma], jres["var"][sigma],
                                   rtol=1e-3, atol=1e-12)
        W = PDEConfig(dt=1e-3).tracer_window
        for f in ("v", "D"):
            assert np.isnan(pres[f][sigma][:, :W]).all()
            assert np.isfinite(pres[f][sigma][:, W:]).all()


@pytest.mark.parametrize("engine", ["xla", "pallas", "auto"])
def test_facade_and_ensemble_take_the_jax_engine_names(engine):
    """The JAX package's ``engine=`` names on ``IMEXPDE.solve``,
    ``run_pde_ensemble``, ``pde_beta_sweep`` and ``pde_kernel_sigma_sweep``
    all run the port's one fused solve: the same output as the default at
    the same seed.  An unknown name raises."""
    from hydrolim_tpu_torch import IMEXPDE
    from hydrolim_tpu_torch.sweeps.pde_sweeps import (
        pde_beta_sweep,
        run_pde_ensemble,
    )

    kw = dict(FACADE_KW, T=0.02)
    outs = []
    for e in (None, engine):
        ps = IMEXPDE(device="cpu", **kw)
        ps.initialize(mode="homogeneous", noise=0.3, n_tracers=20)
        ps.solve() if e is None else ps.solve(engine=e)
        outs.append(ps.get_output())
    for k in outs[0]:
        np.testing.assert_array_equal(outs[1][k], outs[0][k], err_msg=k)
    cfg = PDEConfig(L=L, T=0.02, dt=1e-3, n_tracers=20)
    a, b = (run_pde_ensemble(cfg, [1.0], gamma=0.2, lam=0.6, n_runs=2,
                             n_tracers=20, device="cpu", **e)[0]
            for e in ({}, dict(engine=engine)))
    np.testing.assert_array_equal(a.rho_p, b.rho_p)
    r = pde_beta_sweep([1.0], n_runs=1, T=0.08, t_min=0.06, t_max=0.08, L=L,
                       dt=1e-3, n_tracers=10, plot_result=False,
                       engine=engine, device="cpu")
    assert np.isfinite(r["v_mean"]).all()
    with pytest.raises(ValueError, match="unknown PDE engine"):
        ps.solve(engine="fused")
    assert pde_multi_step.launches == 0

"""The PyTorch port's micro↔macro slice against the JAX package, on the CPU.

- PDE side: the port's ``pde_solve_fused`` (plain kernel B2 on CPU tensors)
  from the JAX initial fields against the JAX XLA ``pde_solve`` path: the
  fields are deterministic, so m, Var and the spectra agree over all steps;
  the tracer statistics (different random streams) agree statistically.
- Particle side: the port's ``run_meanfield_sweep`` (plain kernel B1)
  against the theory pins of ``test_meanfield_physics.py``.
- Exclusion side: the flagship β-sweep (``sweep_over_betas``,
  engine 'fused', plain kernel B3/B4 on CPU tensors) against the golden
  pins of ``test_golden.py``: the K=3 blocking probability and the K=1 |m|
  at β = 2.5.
- The package never imports jax, and CPU tensors never reach a kernel.
"""
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hydrolim_tpu_torch import interop
from hydrolim_tpu_torch.core.config import ParticleConfig, PDEConfig
from hydrolim_tpu_torch.ops._build import load_kernel_library
from hydrolim_tpu_torch.ops.exclusion_kernel import exclusion_multi_step
from hydrolim_tpu_torch.ops.pde_kernel import pde_multi_step
from hydrolim_tpu_torch.ops.stepper_kernel import meanfield_multi_step
from hydrolim_tpu_torch.pde.fast_solve import pde_solve_fused
from hydrolim_tpu_torch.sweeps.beta_sweep import (
    make_exp_gradient,
    sweep_over_betas,
)
from hydrolim_tpu_torch.sweeps.ensemble import broadcast_params, ensemble_dt
from hydrolim_tpu_torch.sweeps.fast_meanfield import run_meanfield_sweep
from hydrolim_tpu_torch.theory.meanfield import m_fixed_point

PDE_KW = dict(L=128, T=0.3, dt=1e-3, bc="periodic",
              active_model="bidirectional", gaussian_kernel=True,
              kernel_sigma=1e5 - 10, snapshot_interval=100, n_tracers=4000,
              tracer_window_time=0.02, fft_kmax=8)
GAMMA, LAM = 0.2, 0.6


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for these small tensors: the suite runs several
    test processes on the host's cores, and torch's thread pool in each
    would only contend (a test of thousands of tiny ops then runs tens of
    times slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pde_pair():
    """(JAX result, port result) of the same 4-replica batch: β ∈ {0.5, 2}
    × 2 runs, ρ₊ biased ×1.5 so the symmetry is broken from the start."""
    from hydrolim_tpu.core.config import PDEConfig as JPDEConfig
    from hydrolim_tpu.core.config import PDEParams as JPDEParams
    from hydrolim_tpu.core.config import make_pde_params
    from hydrolim_tpu.pde.fast_solve import pde_solve_fused as j_fused
    from hydrolim_tpu.pde.init import pde_initialize
    from hydrolim_tpu.pde.stepper import build_pde_ops

    jcfg, cfg = JPDEConfig(**PDE_KW), PDEConfig(**PDE_KW)
    betas = np.repeat(np.array([0.5, 2.0], np.float32), 2)
    B = len(betas)
    jparams = JPDEParams(gamma=jnp.full((B,), GAMMA), lam=jnp.full((B,), LAM),
                         beta=jnp.asarray(betas))
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    rp, rm, tr = jax.vmap(lambda k: pde_initialize(
        jcfg, k, mode="homogeneous", noise=0.3,
        n_tracers=jcfg.n_tracers))(keys)
    rp = rp * 1.5
    ops = build_pde_ops(jcfg, make_pde_params(gamma=GAMMA, lam=LAM, beta=0.))
    jres = jax.device_get(j_fused(jcfg, jparams, ops, rp, rm, tr,
                                  jax.random.PRNGKey(1), engine="xla"))

    gen = torch.Generator()
    gen.manual_seed(1)
    pres = pde_solve_fused(
        cfg, interop.pde_params(jparams, device="cpu"),
        interop.to_torch(np.asarray(rp), torch.float32, device="cpu"),
        interop.to_torch(np.asarray(rm), torch.float32, device="cpu"),
        interop.tracer_state(jax.device_get(tr), device="cpu"), gen)
    return jres, pres


def test_slice_pde_fields_and_records_match_jax(pde_pair):
    """m, Var and fft_ri over all nsteps+1 records, the final fields and
    the chunk snapshots, to f32 roundoff accumulated over 300 steps (the
    JAX path solves spectrally and smooths with a near-uniform kernel; the
    port solves with the float64-built dense inverse and takes the exact
    global mean)."""
    jres, pres = pde_pair
    n = PDE_KW["T"] / PDE_KW["dt"]
    assert pres.records.m_mean.shape == (4, int(round(n)) + 1)
    rec = lambda r, f: np.asarray(getattr(r.records, f))
    np.testing.assert_allclose(rec(pres, "m_mean"), rec(jres, "m_mean"),
                               rtol=1e-4, atol=1e-6)
    var_j = rec(jres, "var")
    np.testing.assert_allclose(rec(pres, "var"), var_j, rtol=1e-3,
                               atol=1e-4 * var_j.max())
    np.testing.assert_allclose(rec(pres, "fft_ri"), rec(jres, "fft_ri"),
                               rtol=1e-4, atol=1e-7)
    for f in ("rho_p", "rho_m", "snapshots", "m_snapshots"):
        np.testing.assert_allclose(np.asarray(getattr(pres, f)),
                                   np.asarray(getattr(jres, f)),
                                   rtol=2e-4, atol=1e-7, err_msg=f)
    np.testing.assert_allclose(pres.snap_times, jres.snap_times)
    # the magnetization really moved at β = 2 (deterministic fields)
    m = rec(pres, "m_mean")
    assert abs(m[2, -1]) > 1.5 * abs(m[2, 0])


def test_slice_pde_tracer_statistics_match_jax(pde_pair):
    """v_eff and D_eff from independent tracer streams: the same NaN warmup
    prefix, and per-β time means within their sampling error.  With 4000
    tracers and a 20-step window the two-replica mean of v has a sampling
    spread of about 0.02 between the engines (0.1λ is 3σ); D's is < 1%."""
    jres, pres = pde_pair
    W = PDEConfig(**PDE_KW).tracer_window
    for f in ("v_eff", "D_eff"):
        p = np.asarray(getattr(pres.records, f))
        j = np.asarray(getattr(jres.records, f))
        assert np.isnan(p[:, :W]).all() and np.isnan(j[:, :W]).all()
        assert np.isfinite(p[:, W:]).all() and np.isfinite(j[:, W:]).all()
    for rows in (slice(0, 2), slice(2, 4)):
        pv = np.mean(pres.records.v_eff[rows, W:].numpy())
        jv = np.mean(np.asarray(jres.records.v_eff)[rows, W:])
        assert abs(pv - jv) < 0.1 * LAM, (pv, jv)
        pd = np.mean(pres.records.D_eff[rows, W:].numpy())
        jd = np.mean(np.asarray(jres.records.D_eff)[rows, W:])
        assert abs(pd - jd) < 0.1 * jd, (pd, jd)


RD, RA = 0.5, 2.0
PART_KW = dict(L=128, N=400, init="fixed", scale_rates=False,
               local_kernel_sigma=0.0, periodic=True, site_capacity=None,
               active_model="bidirectional", max_event_prob=0.05)
T, OBS = 12.0, 0.5


def _sweep(betas, n_runs, seed):
    config = ParticleConfig(**PART_KW)
    params = broadcast_params(config, beta=betas, rate_diffusion=RD,
                              rate_active=RA, n_runs=n_runs, device="cpu")
    dt = ensemble_dt(config, beta_max=float(np.max(betas)),
                     rate_diffusion=RD, rate_active=RA)
    return run_meanfield_sweep(config, params, T=T, obs_dt=OBS, dt=dt,
                               seed=seed, device="cpu")


def _v_and_D(frames, rep):
    pos = frames.pos[:, rep].astype(float)
    s = len(frames.times_obs) // 2
    disp = pos[s:] - pos[s]
    span = frames.times_obs[s:] - frames.times_obs[s]
    v = np.polyfit(span, disp.mean(axis=1), 1)[0]
    var = ((disp - disp.mean(axis=1, keepdims=True)) ** 2).mean(axis=1)
    return v, np.polyfit(span, var, 1)[0] / 2.0


def test_slice_particle_v_eff_matches_tanh_law():
    """|v| = RA·m_β within the JAX physics test's tolerance (atol 0.15·RA,
    rtol 0.12), β ∈ {0, 1.5, 2.5} × 3 runs."""
    betas, n_runs = np.array([0.0, 1.5, 2.5]), 3
    frames = _sweep(betas, n_runs, seed=0)
    assert frames.pos.shape == (len(frames.times_obs), 9, PART_KW["N"])
    v_sim = [np.mean([abs(_v_and_D(frames, b * n_runs + r)[0])
                      for r in range(n_runs)]) for b in range(len(betas))]
    m_b = np.array([m_fixed_point(b) for b in betas])
    np.testing.assert_allclose(v_sim, RA * m_b, atol=0.15 * RA, rtol=0.12)
    # the recorded global m agrees with the positions' spins at β = 2.5
    assert np.abs(frames.m_global[-1, 6:]).min() > 0.5


def test_slice_particle_D_eff_matches_cosh_law():
    """D = RD + RA/2 + RA²/(2cosh³(βm_β)) (the lattice law of the JAX
    physics test) to 15%, β ∈ {0, 2.5} × 3 runs."""
    betas, n_runs = np.array([0.0, 2.5]), 3
    frames = _sweep(betas, n_runs, seed=1)
    D_sim = [np.mean([_v_and_D(frames, b * n_runs + r)[1]
                      for r in range(n_runs)]) for b in range(len(betas))]
    m_b = np.array([m_fixed_point(b) for b in betas])
    D_th = RD + RA / 2.0 + RA ** 2 / (2.0 * np.cosh(betas * m_b) ** 3)
    np.testing.assert_allclose(D_sim, D_th, rtol=0.15)


def test_slice_exclusion_p_block_k3_golden(tmp_path):
    """The K=3 blocking probability at test_golden.py's shrunk flagship
    (plus_forward, non-periodic, exp-gradient Poisson init, global m,
    L=128, N=96, 64 runs, T=6, β=0.7) through the port's sweep: within
    max(4·SE, 0.028) of the frozen golden 0.5964 of the JAX slot engine."""
    L, N = 128, 96
    grad = make_exp_gradient(L=L, N=N, frac_plus=0.75, decay_length=0.35,
                             anchor_positions=None)
    ps = dict(L=L, xlim=1, N=N, init="poisson", scale_rates=False,
              local_kernel_sigma=0.0, periodic=False, site_capacity=3,
              active_model="plus_forward", rate_diffusion=0.02,
              rate_active=2.0)
    save = sweep_over_betas(
        [0.7], n_runs_per_beta=64, ps_kwargs=ps,
        init_kwargs=dict(rho0_plus=grad[0], rho0_minus=grad[1]),
        run_kwargs=dict(T=6.0, obs_dt=0.25), npz_path=str(tmp_path / "s.npz"),
        seed=21, do_fit=False, plot_result=False, engine="fused",
        device="cpu")
    mean, se = float(save["block_means"][0]), float(save["block_ses"][0])
    assert abs(mean - 0.5964) < max(4.0 * se, 0.028), (mean, se)
    # the npz reload path returns the same table
    again = sweep_over_betas([0.7], run=False, npz_path=str(tmp_path / "s.npz"),
                             do_fit=False, plot_result=False, device="cpu")
    assert again["block_means"][0] == save["block_means"][0]


def test_slice_exclusion_k1_magnetization_pin(tmp_path):
    """K=1 exclusion with global m at test_golden.py's _exclusion_cfg
    (L=128, N=48, periodic, bidirectional, rd=0.5, ra=2, T=8, 4 runs):
    the second-half mean of |m| at β=2.5 within 0.06 of the tanh fixed
    point, and |m| rises through the transition."""
    ps = dict(L=128, xlim=1, N=48, init="fixed", scale_rates=False,
              local_kernel_sigma=0.0, periodic=True, site_capacity=1,
              active_model="bidirectional", rate_diffusion=0.5,
              rate_active=2.0)
    betas, n_runs = np.array([0.8, 1.5, 2.5]), 4
    save = sweep_over_betas(
        betas, n_runs_per_beta=n_runs, ps_kwargs=ps,
        run_kwargs=dict(T=8.0, obs_dt=0.5), npz_path=str(tmp_path / "s.npz"),
        seed=12, keep_outs=True, do_fit=False, plot_result=False,
        engine="fused", device="cpu")
    m_abs = np.array([[np.abs(o["m_global"][len(o["m_global"]) // 2:]).mean()
                       for o in outs] for outs in save["outs"]])
    assert abs(m_abs[2].mean() - m_fixed_point(2.5)) < 0.06, m_abs[2]
    assert m_abs[2].mean() > m_abs[0].mean() + 0.2
    # every particle is tagged and stays a valid tracer
    assert all(o["alive_frames"].all() and o["pos_frames"].shape[-1] == 48
               for outs in save["outs"] for o in outs)


def test_package_never_imports_jax():
    """Importing every module of the port leaves jax out of sys.modules;
    the walk reaches the τ-leap engine's and the local-structure sweep's
    modules."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import hydrolim_tpu_torch as p\n"
        "names = set()\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "    names.add(m.name)\n"
        "new = {'core.device', 'runtime.native', 'runtime.exact',\n"
        "       'observables.structure', 'sweeps.local_structure',\n"
        "       'viz.structure_plots', 'experiments.particle_local_structure',\n"
        "       'particles.stepper', 'ops.segment'}\n"
        "missing = {n for n in new if p.__name__ + '.' + n not in names}\n"
        "assert not missing, missing\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k == 'jax' or k.startswith(('jax.', 'hydrolim_tpu.')))\n"
        "assert not bad, bad\n"
        "import torch\n"
        "assert not torch.backends.cuda.matmul.allow_tf32\n"
        "assert not torch.backends.cudnn.allow_tf32\n")
    subprocess.run([sys.executable, "-c", code], check=True)


def test_cpu_tensors_never_reach_a_kernel(pde_pair):
    """The slice above ran on CPU tensors: no launch was counted and no
    kernel library was even built or loaded."""
    _sweep(np.array([1.0]), 1, seed=2)
    assert meanfield_multi_step.launches == 0
    assert pde_multi_step.launches == 0
    assert exclusion_multi_step.launches == 0
    assert load_kernel_library.cache_info().currsize == 0

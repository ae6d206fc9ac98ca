"""The port's slot engines with native torch draws, held statistically on
the CPU: the JAX package's golden pins and its exact-CTMC oracle.

- The anchored-exit golden (``tests/test_golden.py:213-245``): total exits
  at the shrunk ``run_anchored_exits`` configuration, 8.667 ± max(4·SE,
  1.12).
- The exact C++ CTMC oracle (``hydrolim_tpu.runtime.native``, called by
  the test only): ⟨|m|(t)⟩ and the site-occupancy histogram at K=3, and
  the exit totals of the anchored channels
  (``tests/test_lattice_gas_k.py:99-147, 221-257``).
- The anchored engine's invariants (``test_lattice_gas_k.py:189``): slot
  values in {0, ±1, ±2}, capacity, N_final + exits = N_initial, exits
  only on anchor sites.
- The K=1 engine against the JAX package's particle-centric τ-leap run
  (``tests/test_golden.py:136-155``): |m|, tracer speed and D_eff within
  3·(SE_a + SE_b) + 0.02·max(1, |b|), and |m| at β = 2.5 at the tanh
  fixed point.
- ``anchored_exits --small --device cpu`` writes its JSON without
  matplotlib.
"""
import json
import shutil
import sys

import numpy as np
import pytest
import torch

from hydrolim_tpu_torch.core.config import ParticleConfig
from hydrolim_tpu_torch.particles.init import init_particles
from hydrolim_tpu_torch.particles.lattice_gas import run_lattice_gas
from hydrolim_tpu_torch.particles.lattice_gas_k import (
    lgk_init,
    run_lattice_gas_anchored,
    run_lattice_gas_k,
)
from hydrolim_tpu_torch.sweeps.beta_sweep import make_exp_gradient
from hydrolim_tpu_torch.sweeps.ensemble import broadcast_params, ensemble_dt
from hydrolim_tpu_torch.theory.meanfield import m_fixed_point

CPU = "cpu"
needs_gpp = pytest.mark.skipif(shutil.which("g++") is None,
                               reason="no C++ toolchain for the oracle")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(**over):
    kw = dict(L=64, N=80, init="fixed", scale_rates=False,
              local_kernel_sigma=0.0, periodic=True, site_capacity=3,
              active_model="plus_forward")
    kw.update(over)
    return ParticleConfig(**kw)


def test_anchored_golden_exit_totals():
    """96 runs of the shrunk anchored configuration (K=3, three anchors,
    k_on=10, k_off=5, k_exit=5, β=0.7, T=6): the mean total exit count
    holds the JAX package's frozen golden within max(4·SE, 1.12), and
    some but not all particles exit."""
    L, N, n_runs, T = 128, 64, 96, 6.0
    anchors = (0.25, 0.60, 0.80)
    config = ParticleConfig(L=L, xlim=1, N=N, init="poisson",
                            scale_rates=False, local_kernel_sigma=0.02,
                            periodic=False, site_capacity=3,
                            active_model="plus_forward", minus_anchor=True,
                            immobilize_when_anchored=True,
                            anchor_positions=anchors, anchor_radius=0.01,
                            exit_buffer=N)
    grad = make_exp_gradient(L=L, N=N, frac_plus=0.75, decay_length=0.35,
                             anchor_positions=anchors)
    rates = dict(rate_diffusion=0.02, rate_active=2.0, k_on=10.0,
                 k_off=5.0, k_exit=5.0)
    params = broadcast_params(config, beta=[0.7], n_runs=n_runs,
                              device=CPU, **rates)
    dt = ensemble_dt(config, beta_max=0.7, **rates)
    _, _, (ec, _, _) = run_lattice_gas_anchored(
        config, params, T=T, obs_dt=0.5, dt=dt, seed=33, device=CPU,
        rho0_plus=grad[2], rho0_minus=grad[3])
    counts = ec.numpy().astype(float)
    mean, se = counts.mean(), counts.std(ddof=1) / np.sqrt(n_runs)
    assert abs(mean - 8.667) < max(4.0 * se, 1.12), (mean, se)
    assert 0 < mean < N


def _oracle_states(config, n_runs, seed):
    """Initial particles for the oracle runs, from the port's
    initializer."""
    gen = torch.Generator()
    gen.manual_seed(seed)
    st = init_particles(config, gen, B=n_runs, device=CPU)
    return [(st.pos[r][st.alive[r]].numpy(), st.sigma[r][st.alive[r]].numpy())
            for r in range(n_runs)]


@needs_gpp
def test_lgk_matches_exact_ctmc_k3():
    """K=3, plus_forward, ρ = 1.5 (exclusion pressure), β = 1.5: the
    ensemble ⟨|m|(t)⟩ of 24 slot-engine runs agrees with 24 exact CTMC runs
    within 4 SE + 0.06, and the final site-occupancy histograms within
    0.05."""
    from hydrolim_tpu.core.config import ParticleConfig as JConfig
    from hydrolim_tpu.core.config import make_particle_params as j_params
    from hydrolim_tpu.runtime.native import run_exact_gillespie

    L, N, T, obs_dt, beta, n_runs = 64, 96, 3.0, 0.5, 1.5, 24
    kw = dict(L=L, N=N, init="fixed", scale_rates=False,
              local_kernel_sigma=0.0, periodic=True, site_capacity=3,
              active_model="plus_forward")
    jcfg = JConfig(**kw)
    jp = j_params(jcfg, beta=beta, rate_diffusion=1.0, rate_active=3.0,
                  k_on=0, k_off=0, k_exit=0)
    m_exact, occ_exact = [], []
    for r, (pos, sig) in enumerate(_oracle_states(ParticleConfig(
            **dict(kw, n_pad=N)), n_runs, 300)):
        out = run_exact_gillespie(jcfg, jp, pos, sig, T=T, obs_dt=obs_dt,
                                  seed=900 + r)
        m_exact.append(out["m_global"])
        occ_exact.append(out["counts_p"][-1] + out["counts_m"][-1])
    m_exact = np.abs(np.asarray(m_exact))
    occ_exact = np.asarray(occ_exact, float)

    config = ParticleConfig(**kw)
    params = broadcast_params(config, beta=[beta], rate_diffusion=1.0,
                              rate_active=3.0, n_runs=n_runs, device=CPU)
    frames, slots = run_lattice_gas_k(config, params, T=T, obs_dt=obs_dt,
                                      dt=1.5e-3, seed=4, device=CPU)
    m_tau = np.abs(frames.m_global.numpy())
    occ_tau = slots.abs().sum(-2).numpy().astype(float)
    me, mt = m_exact.mean(0), m_tau.mean(0)
    se = (m_exact.std(0, ddof=1) + m_tau.std(0, ddof=1)) / np.sqrt(n_runs)
    assert np.all(np.abs(me - mt) < 4 * se + 0.06), (me, mt, se)
    h_e = np.array([(occ_exact == v).mean() for v in range(4)])
    h_t = np.array([(occ_tau == v).mean() for v in range(4)])
    assert np.all(np.abs(h_e - h_t) < 0.05), (h_e, h_t)


ANCHORED_KW = dict(L=96, N=60, periodic=False, anchor_positions=(0.3, 0.7),
                   anchor_radius=0.02, minus_anchor=True,
                   immobilize_when_anchored=True)
ANCHORED_RATES = dict(rate_diffusion=0.5, rate_active=3.0, k_on=20.0,
                      k_off=2.0, k_exit=10.0)


@pytest.fixture(scope="module")
def anchored_run():
    """24 anchored runs (K=3, two anchors, β=0.5, T=4, dt=1e-3) and their
    initial slots."""
    config = _cfg(**ANCHORED_KW)
    params = broadcast_params(config, beta=[0.5], n_runs=24, device=CPU,
                              **ANCHORED_RATES)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    gen = torch.Generator()
    gen.manual_seed(5)
    slots0 = lgk_init(config, gen, B=24, device=CPU)
    out = run_lattice_gas_anchored(config, params, T=4.0, obs_dt=0.5,
                                   dt=1e-3, seed=6, device=CPU,
                                   _slots0=slots0)
    torch.set_num_threads(n)
    return config, slots0, out


def test_anchored_engine_invariants_and_exits(anchored_run):
    """Slot values in {0, ±1, ±2}, occupancy ≤ 3 counting bound particles,
    N_final + exits = N_initial per replica, some exits, and every logged
    exit a finite time on an anchor site."""
    config, slots0, (frames, slots, (ec, et, ep)) = anchored_run
    s = slots.numpy()
    assert set(np.unique(s)) <= {-2, -1, 0, 1, 2}
    assert (s != 0).sum(-2).max() <= 3
    n0 = (slots0.numpy() != 0).sum((-2, -1))
    np.testing.assert_array_equal((s != 0).sum((-2, -1)) + ec.numpy(), n0)
    assert int(ec.sum()) > 0, "exit channel never fired"
    sites = np.flatnonzero(config.anchor_mask())
    et, ep = et.numpy(), ep.numpy()
    for b in range(len(s)):
        k = min(int(ec[b]), et.shape[1])
        assert np.all(np.isfinite(et[b, :k])) and np.isnan(et[b, k:]).all()
        assert np.all(np.diff(et[b, :k]) >= 0)
        assert np.all(np.isin(ep[b, :k], sites))
    assert np.isfinite(frames.m_local.numpy()).all()


@needs_gpp
def test_anchored_engine_matches_exact_ctmc(anchored_run):
    """The anchored channels against the exact CTMC: the mean exit total
    of 24 slot-engine runs within 4 SE + 1 of 24 oracle runs."""
    from hydrolim_tpu.core.config import ParticleConfig as JConfig
    from hydrolim_tpu.core.config import make_particle_params as j_params
    from hydrolim_tpu.runtime.native import run_exact_gillespie

    config, _, (_, _, (ec, _, _)) = anchored_run
    kw = dict(L=96, N=60, init="fixed", scale_rates=False,
              local_kernel_sigma=0.0, periodic=False, site_capacity=3,
              active_model="plus_forward", anchor_positions=(0.3, 0.7),
              anchor_radius=0.02, minus_anchor=True,
              immobilize_when_anchored=True)
    jcfg = JConfig(**kw)
    jp = j_params(jcfg, beta=0.5, **ANCHORED_RATES)
    exits_exact = []
    for r, (pos, sig) in enumerate(_oracle_states(config, 24, 700)):
        out = run_exact_gillespie(jcfg, jp, pos, sig, T=4.0, obs_dt=1.0,
                                  seed=50 + r)
        exits_exact.append(len(pos) - int(out["n_alive"][-1]))
    exits_exact = np.asarray(exits_exact, float)
    exits_tau = ec.numpy().astype(float)
    se = (exits_exact.std(ddof=1) + exits_tau.std(ddof=1)) / np.sqrt(24)
    assert abs(exits_exact.mean() - exits_tau.mean()) < 4 * se + 1.0, (
        exits_exact.mean(), exits_tau.mean(), se)


def _v(tr, times):
    """Mean tracer speed over the second half of the frames."""
    s = len(times) // 2
    ok = (tr[s] != np.iinfo(np.int32).min) & (tr[-1] != np.iinfo(
        np.int32).min)
    disp = np.where(ok, tr[-1].astype(float) - tr[s].astype(float), np.nan)
    return np.nanmean(disp) / (times[-1] - times[s])


def _D(tr, times):
    """Displacement-variance slope over the second half, halved."""
    s = len(times) // 2
    ok = tr[s] != np.iinfo(np.int32).min
    disp = np.where(ok, tr[s:].astype(float) - tr[s].astype(float), np.nan)
    return np.polyfit(times[s:] - times[s], np.nanvar(disp, axis=1), 1)[0] / 2


def test_k1_cross_engine_m_v_D_against_jax_particle_engine():
    """K=1 exclusion at β ∈ {0.8, 1.5, 2.5}, 4 runs each, every particle
    tagged: the port's K=1 engine against the JAX package's particle-
    centric τ-leap run (two samplers of one CTMC) — |m|, |v| and D_eff per
    β within 3·(SE_a + SE_b) + 0.02·max(1, |b|); |m| rises through the
    transition, and at β = 2.5 sits within 0.06 of the tanh fixed point."""
    import jax

    from hydrolim_tpu.core.config import ParticleConfig as JConfig
    from hydrolim_tpu.sweeps.ensemble import broadcast_params as j_bp
    from hydrolim_tpu.sweeps.ensemble import run_particle_ensemble

    betas, n_runs, T, obs_dt = np.array([0.8, 1.5, 2.5]), 4, 8.0, 0.5
    kw = dict(L=128, xlim=1, N=48, init="fixed", scale_rates=False,
              local_kernel_sigma=0.0, periodic=True, site_capacity=1,
              active_model="bidirectional")
    rates = dict(rate_diffusion=0.5, rate_active=2.0)
    config, jcfg = ParticleConfig(**kw), JConfig(**kw)
    dt = ensemble_dt(config, beta_max=float(betas.max()), **rates)
    times = np.arange(0.0, T, obs_dt)
    M = len(times)
    res = jax.device_get(run_particle_ensemble(
        jcfg, j_bp(jcfg, beta=betas, n_runs=n_runs, **rates),
        jax.random.PRNGKey(12), T=T, obs_dt=obs_dt, dt=dt))
    frames, _ = run_lattice_gas(
        config, broadcast_params(config, beta=betas, n_runs=n_runs,
                                 device=CPU, **rates),
        T=T, obs_dt=obs_dt, dt=dt, seed=13, device=CPU, n_tracers=48)
    B = len(betas) * n_runs
    pos_j = np.asarray(res.frames.pos)
    tr_p = frames.tracer_pos.numpy()
    sh = (len(betas), n_runs)
    m_j = np.abs(np.asarray(res.frames.m_global))[:, M // 2:].mean(1)
    m_p = np.abs(frames.m_global.numpy())[:, M // 2:].mean(1)
    pairs = {
        "m": (m_j, m_p),
        "v": (np.array([abs(_v(pos_j[i], times)) for i in range(B)]),
              np.array([abs(_v(tr_p[i], times)) for i in range(B)])),
        "D": (np.array([_D(pos_j[i], times) for i in range(B)]),
              np.array([_D(tr_p[i], times) for i in range(B)])),
    }
    se = lambda a: a.std(1, ddof=1) / np.sqrt(n_runs)
    for name, (a, b) in pairs.items():
        a, b = a.reshape(sh), b.reshape(sh)
        tol = 3.0 * (se(a) + se(b)) + 0.02 * max(1.0, abs(b.mean()))
        assert np.all(np.abs(a.mean(1) - b.mean(1)) < tol), (
            name, a.mean(1), b.mean(1), tol)
    m_p = m_p.reshape(sh).mean(1)
    assert m_p[2] > m_p[0] + 0.2
    assert abs(m_p[2] - m_fixed_point(2.5)) < 0.06, m_p


def test_anchored_exits_cli_writes_its_json_without_matplotlib(tmp_path,
                                                               monkeypatch):
    """``anchored_exits --small --device cpu`` on a host without
    matplotlib: the JSON holds per-β totals, per-anchor exits and fitted
    Sₐ for the three anchors, exits on anchor sites only, and N_final +
    exits within the realised count; no figure."""
    from hydrolim_tpu_torch.experiments import anchored_exits
    from hydrolim_tpu_torch.viz.exit_plots import anchor_groups

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "matplotlib.pyplot", None)
    anchored_exits.main(str(tmp_path), small=True, device="cpu")
    res = json.loads((tmp_path / "anchored_exits.json").read_text())
    assert res["route"] == "lgk_step anchored"
    assert len(res["total_mean"]) == 3
    assert np.shape(res["region_mean"]) == (3, 3)
    assert np.all(np.isfinite(res["S_fits"]))
    assert sum(res["exit_counts"]) > 0
    groups = anchor_groups(anchored_exits.anchored_ps_kwargs(200, 100, 3))
    assert all((groups[np.asarray(s, int)] >= 0).all()
               for s in res["exit_sites"])
    assert not list(tmp_path.glob("*.png"))

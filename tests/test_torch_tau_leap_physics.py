"""The port's τ-leap engine with native torch draws, held statistically on
the CPU, and the port's copy of the exact CTMC oracle.

- Against the exact stationary law π of a two-particle system
  (``runtime.exact``, the πQ = 0 solve of ``tests/test_native_gillespie.py:
  141-300``): K=1 bidirectional exclusion, K=2 with crowding suppression,
  and plus_forward without exclusion (run on the τ-leap step through a
  custom flip rate equal to the Curie–Weiss one), total-variation distance
  below 0.035 (``test_native_gillespie.py:270-336``); the crowding law
  differs from the plain K=2 law by more than 0.05.
- The copied oracle (``hydrolim_tpu_torch.runtime.native``, built into the
  port's ``_build``) returns the JAX package's oracle's counts at the same
  seed, and its own frames hold π.
- Capacity is never exceeded and particles are conserved without exits
  (``tests/test_particles.py:22-46``); the CW flip rate
  (``test_particles.py:53``).
- The K=1 cross-engine golden (``tests/test_golden.py:136-155``): the
  port's τ-leap engine against the port's ``run_lattice_gas``.
"""
import shutil

import numpy as np
import pytest
import torch

from hydrolim_tpu_torch import ParticleSystem
from hydrolim_tpu_torch.core.config import ParticleConfig, make_particle_params
from hydrolim_tpu_torch.particles.lattice_gas import run_lattice_gas
from hydrolim_tpu_torch.particles.run import TAU_LEAP_ROUTE, particle_route
from hydrolim_tpu_torch.particles.stepper import (
    build_static_arrays,
    step,
    with_exit_log,
)
from hydrolim_tpu_torch.particles.init import init_particles
from hydrolim_tpu_torch.particles.stepper import ParticleState
from hydrolim_tpu_torch.runtime.exact import (
    counts_key,
    total_variation,
    two_particle_stationary_law,
)
from hydrolim_tpu_torch.sweeps.ensemble import (
    broadcast_params,
    ensemble_dt,
    run_particle_ensemble,
)
from hydrolim_tpu_torch.theory.meanfield import m_fixed_point

CPU = "cpu"
needs_gpp = pytest.mark.skipif(shutil.which("g++") is None,
                               reason="no C++ toolchain for the oracle")
RD, RA, BETA = 0.3, 0.7, 1.2

# case -> (L, K, active model, crowding, initial sites, initial spins)
PI_CASES = {
    "exclusion_bidir": (4, 1, "bidirectional", False, [0, 2], [1, -1]),
    "crowding_k2": (4, 2, "bidirectional", True, [0, 2], [1, -1]),
    "open_plusforward": (3, None, "plus_forward", False, [0, 1], [1, -1]),
}


def _cw(s, m, b):
    return torch.exp(-b * s * m)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pi_config(L, K, am, crowding, n_pad=8, **kw):
    # without exclusion a custom flip rate (the CW rate itself) keeps the
    # configuration off the mean-field routes, on the τ-leap step
    return ParticleConfig(L=L, N=2, n_pad=n_pad, init="fixed",
                          scale_rates=False, local_kernel_sigma=0.0,
                          periodic=True, site_capacity=K, active_model=am,
                          crowding_suppresses_rates=crowding,
                          flip_rate_fn=None if K is not None else _cw, **kw)


def _frame_counts(rho_p, rho_m, L, burn):
    """{(counts₊…, counts₋…): n} over the frames past ``burn`` (two
    particles: counts = ρ·2/L)."""
    cp = np.rint(np.asarray(rho_p) * 2 / L).astype(int)
    cm = np.rint(np.asarray(rho_m) * 2 / L).astype(int)
    counts = {}
    for b in range(cp.shape[0]):
        for k in range(burn, cp.shape[1]):
            key = tuple(cp[b, k]) + tuple(cm[b, k])
            counts[key] = counts.get(key, 0) + 1
    return counts


@pytest.mark.parametrize("case", list(PI_CASES))
def test_tau_leap_matches_exact_stationary_distribution(case):
    """1024 replicas from the two-particle state, Δt = 0.02, frames every
    2 time units to T = 40, the first fifth burnt: the empirical law of
    (counts₊, counts₋) within TV 0.035 of π, no state outside π's."""
    L, K, am, crowding, pos0, sig0 = PI_CASES[case]
    law = two_particle_stationary_law(L, K, am, RD, RA, BETA, crowding)
    if crowding:
        plain = two_particle_stationary_law(L, K, am, RD, RA, BETA)
        gap = 0.5 * sum(abs(law.get(k, 0.0) - plain.get(k, 0.0))
                        for k in set(law) | set(plain))
        assert gap > 0.05, gap            # the pin has discriminating power
    config = _pi_config(L, K, am, crowding)
    assert particle_route(config) == TAU_LEAP_ROUTE
    B = 1024
    params = broadcast_params(config, beta=[BETA], rate_diffusion=RD,
                              rate_active=RA, n_runs=B, device=CPU)
    f = run_particle_ensemble(config, params, seed=3, T=40.0, obs_dt=2.0,
                              dt=0.02, record_pos=False, device=CPU).frames
    counts = _frame_counts(f.rho_p, f.rho_m, L, burn=4)
    tv, unseen = total_variation(law, counts)
    assert unseen == 0.0, (case, unseen)
    assert tv < 0.035, (case, tv)


@needs_gpp
def test_copied_oracle_equals_the_jax_oracle_and_holds_pi():
    """The port's copy of the C++ oracle, built into ``_build``, gives the
    JAX package's oracle's counts, m and event count at the same seed
    (K=3, local m, walls, anchors with exits), and its frame-sampled law
    of the K=1 two-particle system lies within TV 0.02 of π
    (``test_native_gillespie.py:246-270``)."""
    from hydrolim_tpu.core.config import ParticleConfig as JConfig
    from hydrolim_tpu.core.config import make_particle_params as j_params
    from hydrolim_tpu.runtime.native import run_exact_gillespie as j_oracle

    from hydrolim_tpu_torch.runtime.native import (
        library_path,
        run_exact_gillespie,
    )

    kw = dict(L=64, N=60, init="fixed", scale_rates=False,
              local_kernel_sigma=0.02, periodic=False, site_capacity=3,
              anchor_positions=(0.3, 0.7), anchor_radius=0.05)
    rates = dict(beta=1.5, rate_diffusion=1.0, rate_active=3.0, k_on=5.0,
                 k_off=1.0, k_exit=2.0)
    rng = np.random.default_rng(4)
    pos0 = np.sort(rng.choice(64 * 3, 60, replace=False)) // 3
    sig0 = rng.choice([-1, 1], 60)
    run = dict(T=6.0, obs_dt=0.5, seed=99)
    want = j_oracle(JConfig(**kw), j_params(JConfig(**kw), **rates), pos0,
                    sig0, **run)
    cfg = ParticleConfig(**kw)
    got = run_exact_gillespie(cfg, make_particle_params(cfg, device=CPU,
                                                        **rates),
                              pos0, sig0, **run)
    assert library_path().exists() and "_build" in str(library_path())
    for k in ("counts_p", "counts_m", "n_alive", "m_global"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["n_events"] == want["n_events"] > 0
    assert got["n_alive"][-1] < 60                       # exits happened

    L, K, am, crowding, pos0, sig0 = PI_CASES["exclusion_bidir"]
    cfg = _pi_config(L, K, am, crowding, n_pad=2)
    out = run_exact_gillespie(
        cfg, make_particle_params(cfg, beta=BETA, rate_diffusion=RD,
                                  rate_active=RA, k_on=0, k_off=0,
                                  k_exit=0, device=CPU),
        np.asarray(pos0), np.asarray(sig0), T=48000.0, obs_dt=2.0, seed=42)
    cp, cm = out["counts_p"], out["counts_m"]
    counts = {}
    for k in range(cp.shape[0] // 10, cp.shape[0]):
        key = tuple(int(c) for c in cp[k]) + tuple(int(c) for c in cm[k])
        counts[key] = counts.get(key, 0) + 1
    tv, unseen = total_variation(
        two_particle_stationary_law(L, K, am, RD, RA, BETA), counts)
    assert unseen == 0.0 and tv < 0.02, (tv, unseen)


@needs_gpp
def test_exact_law_equals_the_jax_tests_solve():
    """``runtime.exact``'s π equals the πQ = 0 solve of the JAX package's
    oracle test for each two-particle case (to 1e-12)."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).parent / "test_native_gillespie.py"
    spec = importlib.util.spec_from_file_location("_jax_gillespie", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for L, K, am, crowding, pos0, sig0 in PI_CASES.values():
        want, _ = mod._exact_pi_and_empirical(L, K, am, RD, RA, BETA, 4.0,
                                              2.0, pos0, sig0, 1,
                                              crowding=crowding)
        got = two_particle_stationary_law(L, K, am, RD, RA, BETA, crowding)
        assert set(got) == set(want)
        for k in want:
            assert abs(got[k] - want[k]) < 1e-12, k
    assert counts_key([(0, 1), (2, -1)], 4) == (1, 0, 0, 0, 0, 0, 1, 0)


def _mini(**over):
    kw = dict(L=64, xlim=1.0, rate_diffusion=0.5, rate_active=2.0, beta=1.0,
              init="fixed", N=40, scale_rates=False, local_kernel_sigma=0.0,
              periodic=True, site_capacity=1, k_on=0, k_off=0, k_exit=0,
              rng=7, device=CPU)
    kw.update(over)
    return ParticleSystem(**kw)


def test_run_conserves_particles_without_exits():
    """``tests/test_particles.py:22``: K=1, T=1, four frames of 40
    particles each on the τ-leap route, densities of unit mass."""
    ps = _mini()
    out = ps.run(T=1.0, obs_dt=0.25, record_fft=True, record_var=True)
    assert ps.last_run_info["engine"] == TAU_LEAP_ROUTE
    assert out["particle_count_list"] == [40] * 4
    mass = out["total_list"].sum(axis=1) * ps.dx
    np.testing.assert_allclose(mass, 1.0, rtol=1e-5)
    assert out["exit_times"] == [] and out["exit_init_bin"] == []


@pytest.mark.parametrize("L,N,K,ra,T", [(64, 50, 1, 20.0, 1.0),
                                        (32, 80, 3, 10.0, 0.5),
                                        (32, 300, 12, 10.0, 0.5)])
def test_exclusion_capacity_never_violated(L, N, K, ra, T):
    """``tests/test_particles.py:31-46`` (and K=12 on the sort path):
    stressed conflicts (max_event_prob 0.5) never put more than K
    particles on a site, in any frame."""
    ps = _mini(L=L, N=N, site_capacity=K, rate_diffusion=5.0,
               rate_active=ra, max_event_prob=0.5)
    out = ps.run(T=T, obs_dt=0.1)
    assert len(out["pos_list"]) == round(T / 0.1)
    for pos in out["pos_list"]:
        assert len(pos) == N
        assert np.bincount(pos, minlength=L).max() <= K
    assert (out["pos_frames"][-1] != out["pos_frames"][0]).any()


def test_flip_rate_statistics_matches_cw():
    """``tests/test_particles.py:53``: all 256 particles +1 (m = +1, no
    hops, a custom flip rate equal to CW keeps the τ-leap step): 400 steps
    of Δt = 0.01 flip exp(−β)·Δt·256·400 times within 5σ."""
    beta, dt, n_steps = 1.0, 0.01, 400
    config = ParticleConfig(L=16, N=256, init="fixed", scale_rates=False,
                            local_kernel_sigma=0.0, periodic=True,
                            site_capacity=None, n_pad=256, flip_rate_fn=_cw)
    params = make_particle_params(config, beta=beta, rate_diffusion=0.0,
                                  rate_active=0.0, k_on=0, k_off=0, k_exit=0,
                                  device=CPU)
    gen = torch.Generator().manual_seed(0)
    st = init_particles(config, gen, device=CPU)
    state = with_exit_log(config, ParticleState(
        pos=st.pos, sigma=torch.ones_like(st.sigma),
        wind=torch.zeros_like(st.pos), alive=st.alive))
    statics = build_static_arrays(config, CPU)
    flips = 0
    for k in range(n_steps):
        new = step(config, params, statics, state, dt, k * dt,
                   generator=gen)
        flips += int((new.sigma != state.sigma).sum())
        state = new
        state.sigma = state.sigma.abs()                 # reset to all-plus
    expect = np.exp(-beta) * dt * 256 * n_steps
    assert abs(flips - expect) < 5 * np.sqrt(expect), (flips, expect)


def _v(tr, times):
    s = len(times) // 2
    return np.polyfit(times[s:], tr[s:].astype(float).mean(1), 1)[0]


def _D(tr, times):
    s = len(times) // 2
    disp = tr[s:].astype(float) - tr[s].astype(float)
    return np.polyfit(times[s:] - times[s], disp.var(1), 1)[0] / 2


def test_k1_cross_engine_golden_tau_leap_against_lattice_gas():
    """``tests/test_golden.py:136-155`` inside the port: K=1 exclusion
    (L=128, N=48, torus, bidirectional, rd=0.5, ra=2, T=8) at β ∈ {0.8,
    1.5, 2.5} × 4 runs, every particle followed, on the τ-leap step and on
    ``run_lattice_gas``: |m|, |v| and D_eff per β within 3·(SE_a + SE_b) +
    0.02·max(1, |b|); |m| rises through the transition and sits at β = 2.5
    within 0.06 of the tanh fixed point."""
    betas, n_runs, T, obs_dt = np.array([0.8, 1.5, 2.5]), 4, 8.0, 0.5
    config = ParticleConfig(L=128, xlim=1, N=48, init="fixed",
                            scale_rates=False, local_kernel_sigma=0.0,
                            periodic=True, site_capacity=1,
                            active_model="bidirectional")
    rates = dict(rate_diffusion=0.5, rate_active=2.0)
    dt = ensemble_dt(config, beta_max=float(betas.max()), **rates)
    params = broadcast_params(config, beta=betas, n_runs=n_runs, device=CPU,
                              **rates)
    times = np.arange(0.0, T, obs_dt)
    M = len(times)
    res = run_particle_ensemble(config, params, seed=12, T=T, obs_dt=obs_dt,
                                dt=dt, device=CPU)
    assert res.engine == TAU_LEAP_ROUTE
    frames, _ = run_lattice_gas(config, params, T=T, obs_dt=obs_dt, dt=dt,
                                seed=13, device=CPU, n_tracers=48)
    B = len(betas) * n_runs
    pos_t = res.frames.pos.numpy()
    tr_l = frames.tracer_pos.numpy()
    m_t = np.abs(res.frames.m_global.numpy())[:, M // 2:].mean(1)
    m_l = np.abs(frames.m_global.numpy())[:, M // 2:].mean(1)
    pairs = {
        "m": (m_t, m_l),
        "v": (np.array([abs(_v(pos_t[i], times)) for i in range(B)]),
              np.array([abs(_v(tr_l[i], times)) for i in range(B)])),
        "D": (np.array([_D(pos_t[i], times) for i in range(B)]),
              np.array([_D(tr_l[i], times) for i in range(B)])),
    }
    sh = (len(betas), n_runs)
    se = lambda a: a.std(1, ddof=1) / np.sqrt(n_runs)
    for name, (a, b) in pairs.items():
        a, b = a.reshape(sh), b.reshape(sh)
        tol = 3.0 * (se(a) + se(b)) + 0.02 * max(1.0, abs(b.mean()))
        assert np.all(np.abs(a.mean(1) - b.mean(1)) < tol), (
            name, a.mean(1), b.mean(1), tol)
    m_t = m_t.reshape(sh).mean(1)
    assert m_t[2] > m_t[0] + 0.2
    assert abs(m_t[2] - m_fixed_point(2.5)) < 0.06, m_t

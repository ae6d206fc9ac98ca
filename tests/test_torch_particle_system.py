"""The port's particle engine and its facade against the JAX package, on
the CPU: the mean-field step with walls and a dead buffer tail at matched
uniforms, one frame's record from one state, the ``out`` dicts of
``frames_to_out`` and ``ParticleSystem.run`` (keys, shapes and value types
for the mean-field engine and for the fused exclusion route), a physics pin
of m(β), the routes ``run_particles`` takes, and every path outside the
port's scope raising with its ROADMAP.md item.  Inputs are made by numpy
from a seed at test_kernel_logic_cpu.py's sizes (L=64, N=96, 48 steps).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hydrolim_tpu.core.config import ParticleConfig as JParticleConfig
from hydrolim_tpu.core.config import make_particle_params as j_make_params
from hydrolim_tpu_torch import ParticleSystem, interop
from hydrolim_tpu_torch.core.config import ParticleConfig
from hydrolim_tpu_torch.fields.magnetization import build_mfield_op
from hydrolim_tpu_torch.ops.stepper_kernel import (
    bits_to_uniform,
    meanfield_multi_step,
)
from hydrolim_tpu_torch.particles.run import (
    B1_ROUTE,
    TORCH_ROUTE,
    _record_frame,
    run_particles,
)
from hydrolim_tpu_torch.particles.stepper import _step_meanfield_global
from hydrolim_tpu_torch.sweeps.ensemble import (
    broadcast_params,
    frames_to_out,
    run_particle_ensemble,
)
from hydrolim_tpu_torch.theory.meanfield import m_fixed_point

L, N, STEPS = 64, 96, 48
MF = dict(L=L, N=N, init="fixed", scale_rates=False, local_kernel_sigma=0.0,
          site_capacity=None)


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


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("model", ["bidirectional", "plus_forward"])
def test_step_meanfield_walls_and_dead_tail_match_jax(model, periodic):
    """A buffer of 104 entries, the last 8 dead, walls closed where
    non-periodic: 48 steps of ``_step_meanfield_global`` from the JAX
    initial state (through ``interop.particle_state``) at the JAX step's
    uniforms give EQUAL pos, σ and wind; dead entries never move or flip,
    and with walls no position leaves [0, L)."""
    from hydrolim_tpu.particles.init import init_particles
    from hydrolim_tpu.particles.stepper import (
        _step_meanfield_global as j_step,
    )

    kw = dict(MF, periodic=periodic, active_model=model, n_pad=N + 8)
    jcfg, cfg = JParticleConfig(**kw), ParticleConfig(**kw)
    # strong drive so particles reach the walls within 48 steps
    jp = j_make_params(jcfg, beta=1.7, rate_diffusion=4.0, rate_active=12.0)
    tp = interop.particle_params(jp, device="cpu")
    st = init_particles(jcfg, jax.random.PRNGKey(4))
    # start a third of the particles on the walls
    pos0 = np.asarray(st.pos).copy()
    pos0[:N // 3:2], pos0[1:N // 3:2] = 0, L - 1
    st = st._replace(pos=jnp.asarray(pos0))
    ts = interop.particle_state(jax.device_get(st), device="cpu")
    rng = np.random.default_rng(1)
    for _ in range(STEPS):
        bits = rng.integers(0, 2 ** 32, (1, N + 8), dtype=np.uint32)
        u = bits_to_uniform(interop.to_torch(bits, torch.int32, device="cpu"))
        st = j_step(jcfg, jp, st, 0.02, u_override=jnp.asarray(u[0].numpy()))
        ts = _step_meanfield_global(cfg, tp, ts, 0.02, u_override=u)
        if not periodic:
            assert int(ts.pos.min()) >= 0 and int(ts.pos.max()) < L
    for name in ("pos", "sigma", "wind"):
        np.testing.assert_array_equal(getattr(ts, name)[0].numpy(),
                                      np.asarray(getattr(st, name)))
    assert (ts.pos[0, :N].numpy() != pos0[:N]).any()
    np.testing.assert_array_equal(ts.pos[0, N:].numpy(), pos0[N:])
    np.testing.assert_array_equal(ts.sigma[0, N:].numpy(),
                                  np.asarray(st.sigma)[N:])


@pytest.mark.parametrize("sigma,periodic", [(0.0, True), (0.05, False),
                                            (0.05, True)])
def test_record_frame_matches_jax(sigma, periodic):
    """One state (a Poisson init of the JAX package, so the buffer has a
    dead tail) recorded by both packages: densities, m_global, var and
    particle_count within rtol 1e-6, m_local within 1e-5, the amplitude
    spectrum within 1e-4 of its max, positions and masks equal."""
    from hydrolim_tpu.particles.init import init_particles
    from hydrolim_tpu.particles.run import _record_frame as j_record
    from hydrolim_tpu.particles.stepper import build_static_arrays

    kw = dict(MF, init="poisson", local_kernel_sigma=sigma,
              periodic=periodic, site_capacity=3)
    jcfg, cfg = JParticleConfig(**kw), ParticleConfig(**kw)
    rng = np.random.default_rng(5)
    rp = rng.uniform(0.2, 1.4, L).astype(np.float32)
    rm = rng.uniform(0.1, 0.6, L).astype(np.float32)
    st = init_particles(jcfg, jax.random.PRNGKey(2), rp, rm)
    st = st._replace(wind=jnp.asarray(rng.integers(-2, 3, cfg.n_buf),
                                      jnp.int32))
    want = jax.device_get(j_record(jcfg, build_static_arrays(jcfg), st,
                                   True, True))
    state = interop.particle_state(jax.device_get(st), device="cpu")
    got = _record_frame(cfg, build_mfield_op(L, cfg.dx, sigma, periodic,
                                             "cpu"), state, True, True)
    g = lambda name: getattr(got, name)[0].numpy()
    assert not np.asarray(st.alive).all()
    for name in ("rho_p", "rho_m", "total", "m_global", "var",
                 "particle_count"):
        np.testing.assert_allclose(g(name), np.asarray(getattr(want, name)),
                                   rtol=1e-6, atol=1e-7, err_msg=name)
    np.testing.assert_allclose(g("m_local"), np.asarray(want.m_local),
                               atol=1e-5)
    amp = np.asarray(want.fft_amp)
    np.testing.assert_allclose(g("fft_amp"), amp, atol=1e-4 * amp.max())
    np.testing.assert_allclose(g("rho_hat_ri"), np.asarray(want.rho_hat_ri),
                               atol=1e-4 * amp.max())
    for name in ("pos", "alive", "bound"):
        np.testing.assert_array_equal(g(name),
                                      np.asarray(getattr(want, name)))


def _schema(out):
    """{key: (type, shape or length, dtype kind)} of an out dict."""
    desc = {}
    for k, v in out.items():
        if isinstance(v, np.ndarray):
            desc[k] = ("ndarray", v.shape, v.dtype.kind)
        elif isinstance(v, list):
            first = v[0] if v else None
            desc[k] = ("list", len(v), type(first).__name__ if not
                       isinstance(first, np.ndarray) else
                       ("ndarray", first.dtype.kind))
        else:
            desc[k] = (type(v).__name__,)
    return desc


@pytest.mark.parametrize("init", ["fixed", "poisson"])
def test_frames_to_out_matches_jax_schema(init):
    """``run_particle_ensemble`` + ``frames_to_out`` give the JAX package's
    keys, shapes and value types, with and without the final state; the
    Poisson case passes per-replica ρ₀ rows (B, L)."""
    from hydrolim_tpu.sweeps.ensemble import broadcast_params as j_bcast
    from hydrolim_tpu.sweeps.ensemble import frames_to_out as j_to_out
    from hydrolim_tpu.sweeps.ensemble import run_particle_ensemble as j_run

    kw = dict(MF, init=init, periodic=True, active_model="bidirectional")
    jcfg, cfg = JParticleConfig(**kw), ParticleConfig(**kw)
    rows = np.stack([np.full(L, 0.8, np.float32), np.full(L, 0.6,
                                                          np.float32)])
    prof = dict(rho0_plus=rows, rho0_minus=rows[::-1].copy()) \
        if init == "poisson" else {}
    rates = dict(beta=[0.5, 2.0], rate_diffusion=0.5, rate_active=2.0)
    run_kw = dict(T=2.0, obs_dt=0.5, dt=0.01, **prof)
    jres = jax.device_get(j_run(jcfg, j_bcast(jcfg, **rates),
                                jax.random.PRNGKey(0), **run_kw))
    res = run_particle_ensemble(cfg, broadcast_params(cfg, device="cpu",
                                                      **rates), 0,
                                device="cpu", **run_kw)
    assert res.engine == (B1_ROUTE if init == "fixed" else TORCH_ROUTE)
    for fs in (None, "final"):
        want = j_to_out(jres.frames, 1, jcfg, 2.0, 0.5,
                        final_state=jres.final_state if fs else None)
        got = frames_to_out(res.frames, 1, cfg, 2.0, 0.5,
                            final_state=res.final_state if fs else None)
        assert _schema(got) == _schema(want)
    assert got["particle_count_list"][0] == int(
        res.frames.alive[1, 0].sum())


def _ps_kwargs(**over):
    kw = dict(L=L, xlim=1, rate_diffusion=0.5, rate_active=2.0, beta=2.0,
              N=N, init="fixed", scale_rates=False, local_kernel_sigma=0.0,
              periodic=True, site_capacity=None,
              active_model="bidirectional", rng=3)
    kw.update(over)
    return kw


@pytest.mark.parametrize("periodic", [True, False])
def test_particle_system_meanfield_out_matches_jax(periodic):
    """``ParticleSystem.run(engine='particle')`` on a mean-field config:
    the JAX facade's keys, shapes and value types with record_fft and
    record_var, the route by the config (B1's plain version on these CPU
    tensors where periodic, else the torch fast path), and a drift
    measured in ``dt_eff`` like the JAX run's."""
    from hydrolim_tpu import ParticleSystem as JParticleSystem

    run_kw = dict(T=2.0, obs_dt=0.25, record_fft=True, record_var=True)
    want = JParticleSystem(**_ps_kwargs(periodic=periodic)).run(**run_kw)
    ps = ParticleSystem(**_ps_kwargs(periodic=periodic), device="cpu")
    got = ps.run(**run_kw)
    assert _schema(got) == _schema(want)
    assert got["dt_eff"] == want["dt_eff"]
    assert ps.last_run_info["engine"] == (B1_ROUTE if periodic
                                          else TORCH_ROUTE)
    assert meanfield_multi_step.launches == 0
    if not periodic:
        pos = got["pos_frames"]
        assert pos.min() >= 0 and pos.max() < L


def test_particle_system_fused_out_matches_jax():
    """``ParticleSystem.run(engine='pallas')`` on the flagship class (K=3,
    σ=0.002, non-periodic, the fixed init; L=200, N=150, T=2): the JAX
    facade's keys, shapes and value types (off the TPU the JAX package
    serves 'pallas' with its XLA slot engine, the same law and schema),
    every particle a tracer, ids conserved, occupancy ≤ K."""
    from hydrolim_tpu import ParticleSystem as JParticleSystem

    kw = dict(L=200, xlim=1, rate_diffusion=0, rate_active=5, beta=0.7,
              init="fixed", N=150, scale_rates=False,
              local_kernel_sigma=0.002, periodic=False, site_capacity=3,
              k_on=0, k_off=0, k_exit=0, rng=0)
    run_kw = dict(T=2.0, obs_dt=0.5, record_fft=True, record_var=True,
                  engine="pallas")
    want = JParticleSystem(**kw).run(**run_kw)
    ps = ParticleSystem(**kw, device="cpu")
    got = ps.run(**run_kw)
    assert _schema(got) == _schema(want)
    assert ps.last_run_info["engine"] == "exclusion_multi_step"
    assert got["particle_count_list"] == [150] * 4
    assert got["alive_frames"].all()
    for sites in got["pos_list"]:
        assert len(sites) == 150 and np.bincount(sites).max() <= 3
    assert (got["pos_frames"][-1] != got["pos_frames"][0]).any()


@pytest.mark.parametrize("periodic", [True, False])
def test_particle_system_magnetization_pin(periodic):
    """β = 2, N = 500, T = 16: the late-window mean of |m| within 0.05 of
    the tanh fixed point m_β(2) = 0.9575, on either route."""
    ps = ParticleSystem(**_ps_kwargs(N=500, periodic=periodic), device="cpu")
    out = ps.run(T=16.0, obs_dt=0.5)
    m = np.abs(out["m_global"][len(out["m_global"]) // 2:]).mean()
    assert abs(m - m_fixed_point(2.0)) < 0.05, m


def test_run_particles_routes_and_empty_run():
    """The route follows the config: 'xla' forces the torch fast path; T ≤ 0
    gives an empty frame stack and the initial state back; B1's route
    refuses a state whose alive entries are not the first N."""
    cfg = ParticleConfig(**MF, periodic=True)
    ps = ParticleSystem(**_ps_kwargs(), device="cpu")
    st = ps.init_particles()
    res = run_particles(cfg, ps.params, st, T=0.0, obs_dt=0.5, dt=0.01)
    assert res.frames.rho_p.shape == (1, 0, L) and res.final_state is st
    assert res.frames.pos.shape == (1, 0, N)
    res = run_particles(cfg, ps.params, st, T=1.0, obs_dt=0.5, dt=0.01,
                        engine="xla")
    assert res.engine == TORCH_ROUTE and res.frames.m_global.shape == (1, 2)
    st.alive[0, 0] = False
    with pytest.raises(ValueError, match="first N"):
        run_particles(cfg, ps.params, st, T=1.0, obs_dt=0.5, dt=0.01)


def test_meanfield_sweep_engines():
    """``run_meanfield_sweep(engine=...)`` in B1's scope: 'auto' (B1's plain
    version here) and 'xla' (the torch fast path) give one frame schema;
    an explicit 'pallas' outside the scope (the Poisson init) raises."""
    from hydrolim_tpu_torch.sweeps.fast_meanfield import run_meanfield_sweep

    rates = dict(beta=[0.5, 2.0], rate_diffusion=0.5, rate_active=2.0)
    cfg = ParticleConfig(**MF, periodic=True)
    params = broadcast_params(cfg, device="cpu", **rates)
    a, x = (run_meanfield_sweep(cfg, params, T=1.0, obs_dt=0.5, dt=0.01,
                                device="cpu", engine=e)
            for e in ("auto", "xla"))
    assert a.m_global.shape == x.m_global.shape == (2, 2)
    assert a.rho_p.shape == x.rho_p.shape == (2, 2, L)
    assert a.pos.shape == x.pos.shape == (2, 2, N)
    cfg = ParticleConfig(**dict(MF, init="poisson", periodic=True))
    with pytest.raises(ValueError, match="'fixed'"):
        run_meanfield_sweep(cfg, broadcast_params(cfg, device="cpu",
                                                  **rates),
                            T=1.0, obs_dt=0.5, dt=0.01, device="cpu",
                            engine="pallas")


def test_meanfield_sweep_auto_outside_b1_scope():
    """'auto' on walls: the ensemble on the torch fast path (frames of the
    whole buffer, positions within [0, L)), as the JAX runner falls back to
    its XLA path there."""
    from hydrolim_tpu_torch.sweeps.fast_meanfield import run_meanfield_sweep

    rates = dict(beta=[0.5, 2.0], rate_diffusion=0.5, rate_active=2.0)
    cfg = ParticleConfig(**dict(MF, n_pad=N + 8, periodic=False))
    f = run_meanfield_sweep(cfg, broadcast_params(cfg, device="cpu",
                                                  **rates),
                            T=1.0, obs_dt=0.5, dt=0.01, device="cpu")
    assert f.pos.shape == (2, 2, N + 8)
    assert f.pos.min() >= 0 and f.pos.max() < L
    assert np.all(np.abs(f.m_global) <= 1.0)


@pytest.mark.parametrize("call", ["lattice_gas", "exclusion", "checkpoint",
                                  "figures", "flip_rate"])
def test_out_of_scope_raises_with_its_roadmap_item(call, tmp_path):
    """The calls that raised before their ports now run (the sweeps'
    ``n_devices=`` too: past the host's devices it raises ``ValueError``,
    as the port fakes no devices): ``engine='lattice_gas'`` on the slot engine, ``engine='particle'``
    with exclusion and local m or with a custom flip rate on the τ-leap
    step, ``run_checkpointed``, which returns ``run``'s out dict, and the
    figure methods (``plot_individuals`` returns the drift velocity)."""
    ps = ParticleSystem(**_ps_kwargs(), device="cpu")
    if call == "checkpoint":
        want = ParticleSystem(**_ps_kwargs(), device="cpu").run(
            T=1.0, obs_dt=0.5)
        got = ps.run_checkpointed(T=1.0, obs_dt=0.5, ckpt_dir=tmp_path)
        assert sorted(got) == sorted(want)
        for k in ("m_global", "pos_frames", "total_list"):
            np.testing.assert_array_equal(got[k], want[k])
        assert (tmp_path / "manifest.json").exists()
        return
    if call in ("lattice_gas", "exclusion", "flip_rate"):
        over = (dict(flip_rate_fn=lambda s, m: 1.0 + 0 * s)
                if call == "flip_rate" else
                dict(site_capacity=3, local_kernel_sigma=0.01))
        ps = ParticleSystem(**_ps_kwargs(**over), device="cpu")
        out = ps.run(T=1.0, obs_dt=0.5, **(
            dict(engine="lattice_gas") if call == "lattice_gas" else {}))
        assert ps.last_run_info["engine"] == (
            "lgk_step" if call == "lattice_gas" else "tau_leap")
        assert len(out["pos_list"]) == 2 and np.isfinite(
            out["m_global"]).all()
        return
    out = ps.run(T=1.0, obs_dt=0.25)
    assert np.isfinite(ps.plot_individuals(out, outdir=str(tmp_path)))
    assert (tmp_path / "Effective_drift_velocity.png").exists()
    from hydrolim_tpu_torch.sweeps.beta_sweep import sweep_over_betas

    with pytest.raises(ValueError, match="this host has 1 cpu device"):
        sweep_over_betas([1.0], n_devices=2, device="cpu")


def test_facades_are_exported():
    import hydrolim_tpu_torch as port
    from hydrolim_tpu_torch import IMEXPDE

    assert port.ParticleSystem is ParticleSystem
    assert IMEXPDE.__module__ == "hydrolim_tpu_torch.pde.system"
    assert ParticleSystem.empirical_densities_from_particles(
        np.array([0, 1, 1]), np.array([1, -1, 1]), 4, 0.25)[0][1] == 4 / 3

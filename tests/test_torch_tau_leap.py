"""The port's general τ-leap step against the JAX step, on the CPU, at the
same draws.

Each case starts from a JAX-made batched state (``interop.particle_state``)
and feeds the port the draws rebuilt from the JAX key chain (``JaxDraws``):
per replica ``key, k_ev, k_prio = split(state.key, 3)`` each step, then
``uniform(k_ev, (n,))`` and ``bits(k_prio, (n,), uint32)``.  Per step the
m field and the seven channel rates agree to 1e-6, and the integer state
(pos, wind, σ, bound, alive, birth sites) and the exit log (count, sites,
birth sites and float32 times) are equal.  A 4-frame ``run_particles``
equals the JAX run, and ``auto_dt`` probes a custom flip rate as the JAX
one does.  Sizes of ``tests/test_kernel_logic_cpu.py``: L=64, N=96 (40 at
K=1, 60 with anchors), 48 steps, two replicas (β = 0.8, 2.0).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hydrolim_tpu_torch import interop
from hydrolim_tpu_torch.core.config import ParticleConfig
from hydrolim_tpu_torch.core.config import auto_dt as port_auto_dt
from hydrolim_tpu_torch.ops.segment import occupancy
from hydrolim_tpu_torch.particles.run import (
    TAU_LEAP_ROUTE,
    particle_route,
    run_particles,
)
from hydrolim_tpu_torch.particles.stepper import (
    assemble_rates,
    build_static_arrays,
    compute_m_field,
    step,
)

CPU = "cpu"
RATES = dict(rate_diffusion=1.0, rate_active=3.0)
ANCHOR_RATES = dict(k_on=20.0, k_off=2.0, k_exit=40.0)
DT, STEPS = 0.02, 48


def _jax_flip(s, m, b):
    return 0.5 + jnp.exp(-b * s * m) * (1.0 + 0.5 * m * m)


def _torch_flip(s, m, b):
    return 0.5 + torch.exp(-b * s * m) * (1.0 + 0.5 * m * m)


# name -> (ParticleConfig fields beyond the base, extra rates)
CASES = {
    "K1-torus-global": (dict(site_capacity=1, N=40), {}),
    "K1-torus-local": (dict(site_capacity=1, N=40,
                            local_kernel_sigma=0.02), {}),
    "K3-torus-global": (dict(), {}),
    "K3-torus-local-bidirectional": (dict(local_kernel_sigma=0.02,
                                          active_model="bidirectional"), {}),
    "walls-plus_forward-local": (dict(periodic=False,
                                      local_kernel_sigma=0.02), {}),
    "walls-bidirectional": (dict(periodic=False,
                                 active_model="bidirectional"), {}),
    "anchors-exits": (dict(periodic=False, N=60, local_kernel_sigma=0.02,
                           anchor_positions=(0.3, 0.7), anchor_radius=0.05),
                      ANCHOR_RATES),
    "crowding": (dict(crowding_suppresses_rates=True,
                      local_kernel_sigma=0.02), {}),
    "K12-sort": (dict(site_capacity=12, N=300), {}),
    "custom-flip-no-exclusion": (dict(site_capacity=None, flip=True), {}),
    "custom-flip-K3-walls": (dict(periodic=False, flip=True), {}),
}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _kw(over):
    kw = dict(L=64, N=96, init="fixed", scale_rates=False,
              local_kernel_sigma=0.0, periodic=True, site_capacity=3,
              active_model="plus_forward")
    kw.update(over)
    return kw


def _configs(over):
    from hydrolim_tpu.core.config import ParticleConfig as JConfig

    over = dict(over)
    flip = over.pop("flip", False)
    kw = _kw(over)
    return (JConfig(**kw, flip_rate_fn=_jax_flip if flip else None),
            ParticleConfig(**kw, flip_rate_fn=_torch_flip if flip else None))


def _params(jcfg, betas, rates):
    from hydrolim_tpu.sweeps.ensemble import broadcast_params

    jp = broadcast_params(jcfg, beta=betas, **RATES, **rates)
    return jp, interop.particle_params(jp, device=CPU)


def _jax_states(jcfg, seed, B):
    from hydrolim_tpu.particles.init import init_particles

    keys = jax.random.split(jax.random.PRNGKey(seed), B)
    return jax.vmap(lambda k: init_particles(jcfg, k))(keys)


class JaxDraws:
    """The τ-leap draws of a batched JAX run from its states' keys: per
    replica and step ``key, k_ev, k_prio = split(key, 3)``, the event
    uniforms from ``k_ev`` and the priority bits from ``k_prio``."""

    def __init__(self, keys, n, n_steps):
        def one(k):
            def body(kk, _):
                kk, k_ev, k_prio = jax.random.split(kk, 3)
                return kk, (jax.random.uniform(k_ev, (n,), jnp.float32),
                            jax.random.bits(k_prio, (n,), jnp.uint32))

            return jax.lax.scan(body, k, None, length=n_steps)[1]

        u, bits = jax.jit(jax.vmap(one))(keys)
        self.u, self.bits = np.asarray(u), np.asarray(bits)

    def step(self, i):
        return (torch.tensor(self.u[:, i]),
                torch.tensor(self.bits[:, i].astype(np.int64)))


def _jax_trajectory(jcfg, jp, st0, times):
    """The JAX step over ``times`` (vmapped over replicas): per step the
    m field and rates before it, and the state after it."""
    from hydrolim_tpu.ops.segment import occupancy as j_occupancy
    from hydrolim_tpu.particles.stepper import (
        _is_meanfield_fast_path,
        assemble_rates as j_rates,
        build_static_arrays as j_statics,
        compute_m_field as j_m_field,
        step as j_step,
    )

    statics = j_statics(jcfg)
    L = jcfg.L
    assert not _is_meanfield_fast_path(jcfg)

    def one(p, st):
        def body(s, t):
            occ, cp, cm = j_occupancy(s.pos, s.sigma, s.alive, L)
            if jcfg.exclusion or jcfg.local_kernel_sigma > 0:
                m = j_m_field(jcfg, statics, cp, cm)
            else:
                ssum = jnp.sum(jnp.where(s.alive, s.sigma, 0))
                m = jnp.full((L,), ssum.astype(jnp.float32) / jnp.maximum(
                    jnp.sum(s.alive), 1).astype(jnp.float32))
            rates, _ = j_rates(jcfg, p, s, m, occ if jcfg.exclusion
                               else None, statics.is_anchor_site)
            s2 = j_step(jcfg, p, statics, s, DT, t)
            return s2, (m, rates, s2)

        return jax.lax.scan(body, st, times)[1]

    return jax.device_get(jax.jit(jax.vmap(one))(jp, st0))


INT_FIELDS = ("pos", "wind", "sigma", "bound", "alive", "init_bin",
              "exit_count", "exit_pos", "exit_init_bin")


def _assert_state_equal(got, want, i, what):
    for name in INT_FIELDS:
        np.testing.assert_array_equal(
            getattr(got, name).numpy(), np.asarray(getattr(want, name)),
            err_msg=f"{what}: step {i}: {name}")
    np.testing.assert_array_equal(
        got.exit_times.numpy(), np.asarray(want.exit_times, np.float32),
        err_msg=f"{what}: step {i}: exit_times")


def _take(tree, i):
    return jax.tree.map(lambda a: a[:, i], tree)


@pytest.mark.parametrize("case", list(CASES))
def test_step_equals_jax_at_the_same_draws(case):
    """48 steps from a JAX-made state at the JAX run's draws: m and the
    rates to 1e-6 before each step, the integer state and the exit log
    equal after it (exit times equal in float32)."""
    over, rates = CASES[case]
    jcfg, cfg = _configs(over)
    jp, pp = _params(jcfg, [0.8, 2.0], rates)
    st0 = _jax_states(jcfg, 11, 2)
    n = jcfg.n_buf
    times = (np.arange(STEPS, dtype=np.float32) * np.float32(DT))
    m_j, rates_j, states_j = _jax_trajectory(jcfg, jp, st0,
                                             jnp.asarray(times))
    draws = JaxDraws(st0.key, n, STEPS)
    state = interop.particle_state(jax.device_get(st0), device=CPU)
    statics = build_static_arrays(cfg, CPU)
    moved = flipped = 0
    for i in range(STEPS):
        occ, cp, cm = occupancy(state.pos, state.sigma, state.alive, cfg.L)
        if cfg.exclusion or cfg.local_kernel_sigma > 0:
            m = compute_m_field(cfg, statics, cp, cm)
        else:
            ssum = torch.where(state.alive, state.sigma, 0).sum(-1)
            m = (ssum.float() / state.alive.sum(-1).clamp(min=1).float()
                 )[:, None].expand(-1, cfg.L)
        np.testing.assert_allclose(m.numpy(), m_j[:, i], rtol=0, atol=1e-6,
                                   err_msg=f"{case}: m at step {i}")
        r, _ = assemble_rates(cfg, pp, state, m,
                              occ if cfg.exclusion else None,
                              statics.is_anchor_site)
        np.testing.assert_allclose(r.numpy(), rates_j[:, i], rtol=1e-6,
                                   atol=1e-6,
                                   err_msg=f"{case}: rates at step {i}")
        new = step(cfg, pp, statics, state, DT, float(times[i]),
                   _inject=draws.step(i))
        _assert_state_equal(new, _take(states_j, i), i, case)
        moved += int((new.pos != state.pos).sum())
        flipped += int((new.sigma != state.sigma).sum())
        state = new
    assert moved > 0 and flipped > 0, (moved, flipped)
    if case == "anchors-exits":
        ec = state.exit_count.numpy()
        assert (ec > 0).all() and (ec > cfg.n_exit_buf).any(), ec  # overflow
        assert state.bound.any()
    if case == "K12-sort":
        assert particle_route(cfg) == TAU_LEAP_ROUTE and cfg.K > 8


@pytest.mark.parametrize("case", ["K3-torus-local-bidirectional",
                                  "anchors-exits"])
def test_run_particles_equals_jax(case):
    """A 4-frame ``run_particles`` (3 × 16 steps) from the JAX run's states
    and draws: every frame field equal (integers) or to 1e-6 (floats, the
    spectrum to 1e-6 of its DC bin), the final state and its exit log
    equal; the route is the τ-leap step."""
    from hydrolim_tpu.particles.run import run_particles as j_run

    over, rates = CASES[case]
    jcfg, cfg = _configs(over)
    jp, pp = _params(jcfg, [0.8, 2.0], rates)
    st0 = _jax_states(jcfg, 5, 2)
    run = dict(T=0.4, obs_dt=0.1, dt=0.1 / 16)
    want = jax.device_get(jax.jit(jax.vmap(
        lambda p, s: j_run(jcfg, p, s, **run)))(jp, st0))
    got = run_particles(cfg, pp, interop.particle_state(
        jax.device_get(st0), device=CPU), _draws=JaxDraws(
            st0.key, jcfg.n_buf, 48), **run)
    assert got.engine == TAU_LEAP_ROUTE
    for name in got.frames._fields:
        p = getattr(got.frames, name).numpy()
        j = np.asarray(getattr(want.frames, name))
        if p.dtype.kind in "iub":
            np.testing.assert_array_equal(p, j, err_msg=name)
        else:
            scale = np.abs(j).max() if name in ("fft_amp",
                                                "rho_hat_ri") else 1.0
            np.testing.assert_allclose(p, j, rtol=1e-6, atol=1e-6 * scale,
                                       err_msg=name)
    _assert_state_equal(got.final_state, want.final_state, 47, case)
    if case == "anchors-exits":
        assert (got.final_state.exit_count > 0).all()


def test_auto_dt_probes_a_custom_flip_rate_as_jax():
    """``auto_dt`` with a custom flip rate (``tests/test_particles.py:
    198-240``): a constant rate of 1000, a rate decreasing in β probed at
    the batch's smallest β, and the default Curie-Weiss bound, each equal
    to the JAX package's Δt."""
    from hydrolim_tpu.core.config import ParticleConfig as JConfig
    from hydrolim_tpu.core.config import ParticleParams as JParams
    from hydrolim_tpu.core.config import auto_dt as j_auto_dt

    kw = dict(L=32, N=8, init="fixed", scale_rates=False,
              local_kernel_sigma=0.0, periodic=True, site_capacity=None)
    fns = (
        (lambda s, m, b: 1000.0 + 0.0 * s, lambda s, m, b: 1000.0 + 0.0 * s),
        (lambda s, m, b: jnp.exp(3.0 - b) + 0.0 * s * m,
         lambda s, m, b: torch.exp(3.0 - b) + 0.0 * s * m),
        (None, None))
    for betas in ([0.5, 3.0], [3.0], [1.2]):
        rd = np.full(len(betas), 0.7, np.float32)
        jpar = JParams(beta=jnp.asarray(betas, jnp.float32),
                       rate_diffusion=jnp.asarray(rd),
                       rate_active=jnp.asarray(rd * 2),
                       k_on=jnp.zeros(len(betas)),
                       k_off=jnp.zeros(len(betas)),
                       k_exit=jnp.zeros(len(betas)))
        ppar = interop.particle_params(jpar, device=CPU)
        for jfn, tfn in fns:
            want = j_auto_dt(JConfig(**kw, flip_rate_fn=jfn), jpar)
            got = port_auto_dt(ParticleConfig(**kw, flip_rate_fn=tfn), ppar)
            assert got == pytest.approx(want, rel=1e-12), (betas, got, want)
    decreasing = ParticleConfig(**kw, flip_rate_fn=fns[1][1])
    lo = port_auto_dt(decreasing, ppar)
    assert lo <= decreasing.max_event_prob / float(np.exp(1.8)) * 1.001


def test_state_fields_carry_across_interop():
    """``interop.particle_state`` carries the birth sites and the exit log
    of a JAX state (single replica and batched)."""
    from hydrolim_tpu.core.config import ParticleConfig as JConfig
    from hydrolim_tpu.particles.init import init_particles

    jcfg = JConfig(**_kw({}))
    one = jax.device_get(init_particles(jcfg, jax.random.PRNGKey(3)))
    st = interop.particle_state(one, device=CPU)
    assert st.pos.shape == st.init_bin.shape == (1, jcfg.n_buf)
    assert st.exit_count.shape == (1,) and st.exit_times.shape == (
        1, jcfg.n_exit_buf)
    assert torch.isnan(st.exit_times).all()
    np.testing.assert_array_equal(st.init_bin[0].numpy(), one.init_bin)
    batched = interop.particle_state(jax.device_get(_jax_states(jcfg, 1, 3)),
                                     device=CPU)
    assert batched.exit_pos.shape == (3, jcfg.n_exit_buf)
    assert dataclasses.replace(batched, pos=batched.pos).alive.all()

"""The port's XLA slot engines against the JAX package, on the CPU.

- Step level: ``lgk_step`` and ``lg_step`` against the JAX functions at
  the same draws, step after step, slots and every returned flag EQUAL:
  global and local m, periodic and walls, both active models, crowding,
  K=1 and K > 8 slot fields, and anchors with bind, unbind, immobilisation
  and exit all firing.  ``lg_step``'s draws are computed from the JAX
  step's own key (``split``, ``uniform``, ``bernoulli``).
- ``lgk_step`` against the port's kernel B3/B4 plain version at matched
  draws (the JAX package's ``tests/test_kernel_logic_cpu.py:136-192``, its
  priority encoding).
- The routes: ``sweep_over_betas(engine='lattice_gas')``,
  ``run_sweep_grid_lattice_gas(kernel='auto')`` on crowding and anchored
  configurations, ``double_sweep_fused`` and ``ParticleSystem.run`` on the
  slot engine, against the JAX package's out-dict keys.

Where parity can break, by design: the JAX step rounds t2 = t1 +
(r_dif + r_act)·Δt and kernel B3 t1 + r_dif·Δt + r_act·Δt, so the two are
compared at rates where both round alike (asserted); local m is summed in
B3's order (``band_m``), which these configurations round alike to the JAX
engine's ``local_m_field``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hydrolim_tpu_torch import interop
from hydrolim_tpu_torch.core.config import ParticleConfig
from hydrolim_tpu_torch.ops.exclusion_kernel import (
    bits_to_uniform,
    build_smoothing_band,
    exclusion_multi_step,
)
from hydrolim_tpu_torch.particles.lattice_gas import lg_step
from hydrolim_tpu_torch.particles.lattice_gas_k import (
    EMPTY_PRIO,
    lgk_step,
    slot_priorities,
)

CPU = "cpu"


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for these small tensors: the suite runs several
    test processes on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _kw(**over):
    kw = dict(L=64, N=96, init="fixed", scale_rates=False,
              local_kernel_sigma=0.0, periodic=True, site_capacity=3,
              active_model="plus_forward")
    kw.update(over)
    return kw


def _configs(kw):
    from hydrolim_tpu.core.config import ParticleConfig as JConfig

    return JConfig(**kw), ParticleConfig(**kw)


def _params(jcfg, betas, **rates):
    """JAX (B,) params and the port's copy."""
    from hydrolim_tpu.sweeps.ensemble import broadcast_params

    jp = broadcast_params(jcfg, beta=betas, **rates)
    return jp, interop.particle_params(jp, device=CPU)


ANCHORS = dict(periodic=False, N=60, anchor_positions=(0.3, 0.7),
               anchor_radius=0.05)
ANCHOR_RATES = dict(k_on=20.0, k_off=2.0, k_exit=10.0)
BASE_RATES = dict(rate_diffusion=1.0, rate_active=3.0)

LGK_CASES = {
    "global-periodic-plus_forward": (_kw(), {}),
    "local-periodic": (_kw(local_kernel_sigma=0.02), {}),
    "local-walls": (_kw(L=48, N=60, local_kernel_sigma=0.015,
                        periodic=False), {}),
    "global-periodic-bidirectional": (_kw(active_model="bidirectional"), {}),
    "crowding-bidirectional": (_kw(crowding_suppresses_rates=True,
                                   active_model="bidirectional"), {}),
    "K1": (_kw(site_capacity=1, N=40, active_model="bidirectional"), {}),
    "K10-walls": (_kw(site_capacity=10, N=300, periodic=False), {}),
    "anchors-local": (_kw(local_kernel_sigma=0.02, **ANCHORS), ANCHOR_RATES),
    "anchors-free-flip-mobile": (_kw(suppress_flip_when_bound=False,
                                     immobilize_when_anchored=False,
                                     **ANCHORS), ANCHOR_RATES),
}


@pytest.mark.parametrize("case", list(LGK_CASES))
def test_lgk_step_equals_jax(case):
    """48 steps of 2 replicas (β 0.8 and 2.0) at dt = 0.02 with the same
    uniforms and priorities: slots, the move and flip flags, the tracer
    map ``new_k`` and the exit mask EQUAL every step.  With anchors, bind,
    unbind and (immobilised) exit all fire."""
    from hydrolim_tpu.fields.magnetization import build_mfield_op
    from hydrolim_tpu.particles.lattice_gas_k import lgk_init as j_init
    from hydrolim_tpu.particles.lattice_gas_k import lgk_step as j_step

    kw, rates = LGK_CASES[case]
    jcfg, cfg = _configs(kw)
    K, L, B, dt = cfg.K, cfg.L, 2, 0.02
    jp, pp = _params(jcfg, [0.8, 2.0], **BASE_RATES, **rates)
    op = build_mfield_op(L, jcfg.dx, jcfg.local_kernel_sigma, jcfg.periodic)
    anchored = jcfg.anchor_positions is not None
    j_anc = jnp.asarray(jcfg.anchor_mask()) if anchored else None
    p_anc = torch.tensor(jcfg.anchor_mask()) if anchored else None
    step = jax.jit(jax.vmap(lambda p, s, u, pr: j_step(
        jcfg, p, op, s, jax.random.PRNGKey(0), dt, is_anchor=j_anc,
        _inject=(u, pr))))
    jsl = jax.vmap(lambda k: j_init(jcfg, k))(
        jax.random.split(jax.random.PRNGKey(1), B))
    psl = torch.tensor(np.asarray(jsl))
    band = build_smoothing_band(cfg, CPU)
    rng = np.random.default_rng(2)
    binds, unbinds, exits = 0, 0, 0
    for s in range(48):
        u = (rng.integers(0, 2 ** 24, (B, K, L)) * 2.0 ** -24).astype(
            np.float32)
        prio = slot_priorities(torch.tensor(
            rng.integers(0, 2 ** 32, (B, K, L), dtype=np.int64)))
        jsl2, jaux, jex = step(jp, jsl, jnp.asarray(u),
                               jnp.asarray(prio.numpy().astype(np.uint32)))
        psl2, paux, pex = lgk_step(cfg, pp, band, psl, dt, is_anchor=p_anc,
                                   _inject=(torch.tensor(u), prio))
        np.testing.assert_array_equal(psl2.numpy(), np.asarray(jsl2),
                                      err_msg=f"slots at step {s}")
        for name, j, p in zip(("right", "left", "flip", "new_k"), jaux, paux):
            np.testing.assert_array_equal(p.numpy(), np.asarray(j),
                                          err_msg=f"{name} at step {s}")
        np.testing.assert_array_equal(pex.numpy(), np.asarray(jex))
        nb = int((np.abs(np.asarray(jsl2)) == 2).sum())
        before = int((np.abs(np.asarray(jsl)) == 2).sum())
        binds += nb > before
        unbinds += nb < before - int(np.asarray(jex).sum())
        exits += int(np.asarray(jex).sum())
        jsl, psl = jsl2, psl2
    final = psl.numpy()
    assert (final != 0).sum(1).max() <= K                # capacity
    if not anchored:
        assert (final != 0).sum() == 2 * cfg.N           # mass conserved
        return
    assert binds and unbinds, (binds, unbinds)
    if cfg.immobilize_when_anchored:
        assert exits > 0
    else:
        assert exits == 0                                # exit needs it


LG_CASES = {
    "global-periodic-plus_forward": _kw(site_capacity=1, N=40),
    "local-periodic-bidirectional": _kw(site_capacity=1, N=40,
                                        local_kernel_sigma=0.02,
                                        active_model="bidirectional"),
    "local-walls-bidirectional": _kw(site_capacity=1, N=30, L=48,
                                     local_kernel_sigma=0.015,
                                     periodic=False,
                                     active_model="bidirectional"),
    "global-walls-plus_forward": _kw(site_capacity=1, N=30, L=48,
                                     periodic=False),
}


def _lg_draws(key, shape):
    """The draws of JAX ``lg_step`` from its key: the event uniforms and
    the tie bits (``lattice_gas.py:52, 93, 107``)."""
    k_ev, k_tie = jax.random.split(key)
    return (jax.random.uniform(k_ev, shape, jnp.float32),
            jax.random.bernoulli(k_tie, 0.5, shape))


@pytest.mark.parametrize("case", list(LG_CASES))
def test_lg_step_equals_jax(case):
    """48 steps of 2 replicas: the JAX step on its keys, the port's on the
    uniforms and tie bits drawn from the same keys; occupancy and the
    move / flip flags EQUAL every step, and ties were broken."""
    from hydrolim_tpu.fields.magnetization import build_mfield_op
    from hydrolim_tpu.particles.lattice_gas import lg_init as j_init
    from hydrolim_tpu.particles.lattice_gas import lg_step as j_step

    jcfg, cfg = _configs(LG_CASES[case])
    L, B, dt = cfg.L, 2, 0.05
    jp, pp = _params(jcfg, [0.8, 2.0], **BASE_RATES)
    op = build_mfield_op(L, jcfg.dx, jcfg.local_kernel_sigma, jcfg.periodic)
    step = jax.jit(jax.vmap(lambda p, o, k: (j_step(jcfg, p, op, o, k, dt),
                                             _lg_draws(k, (L,)))))
    jocc = jax.vmap(lambda k: j_init(jcfg, k))(
        jax.random.split(jax.random.PRNGKey(3), B))
    pocc = torch.tensor(np.asarray(jocc))
    band = build_smoothing_band(cfg, CPU)
    ties = 0
    for s in range(48):
        keys = jax.random.split(jax.random.PRNGKey(100 + s), B)
        (jocc2, jflags), (u, tie) = step(jp, jocc, keys)
        u, tie = torch.tensor(np.asarray(u)), torch.tensor(np.asarray(tie))
        pocc2, pflags = lg_step(cfg, pp, band, pocc, dt, _inject=(u, tie))
        np.testing.assert_array_equal(pocc2.numpy(), np.asarray(jocc2),
                                      err_msg=f"occupancy at step {s}")
        for j, p in zip(jflags, pflags):
            np.testing.assert_array_equal(p.numpy(), np.asarray(j))
        # a double proposal into an empty site: the other tie bit admits
        # the other candidate
        ties += not torch.equal(lg_step(cfg, pp, band, pocc, dt,
                                        _inject=(u, ~tie))[0], pocc2)
        jocc, pocc = jocc2, pocc2
    assert (pocc.numpy() != 0).sum() == 2 * cfg.N
    assert ties > 0


# ---------------------------------------------------------------------------
# lgk_step against kernel B3/B4's plain version
# ---------------------------------------------------------------------------

def _same_rounding(rd, ra, dt):
    """The JAX step's t2 increment (r_dif + r_act)·Δt and kernel B3's
    r_dif·Δt + r_act·Δt round to the same float32."""
    f = np.float32
    return (f(rd) + f(ra)) * f(dt) == f(rd) * f(dt) + f(ra) * f(dt)


B3_CASES = {
    "global-plus_forward": _kw(N=80),
    "local-plus_forward": _kw(N=80, local_kernel_sigma=0.02),
    "global-bidirectional": _kw(N=80, active_model="bidirectional"),
    "local-walls": _kw(L=48, N=40, site_capacity=2,
                       local_kernel_sigma=0.015, periodic=False),
    "K1": _kw(N=40, site_capacity=1, active_model="bidirectional"),
}


@pytest.mark.parametrize("case", list(B3_CASES))
def test_lgk_step_equals_b3_plain(case):
    """25 steps at matched draws with the JAX package's encoding: a
    distinct random rank per slot, ``rank << 17 | slot_id`` for the slot
    engine and ``rank << 6`` as B3's priority bits (no ties, so the same
    admission), the event bits through ``interop.exclusion_noise``.
    Slots EQUAL every step (B3 carries ±1 payloads here)."""
    from hydrolim_tpu_torch.particles.lattice_gas_k import lgk_init
    from hydrolim_tpu_torch.sweeps.ensemble import broadcast_params

    kw = B3_CASES[case]
    cfg = ParticleConfig(**kw)
    K, L, dt = cfg.K, cfg.L, 2e-3
    rd, ra, betas = 1.0, 3.0, [1.5, 0.4]
    assert _same_rounding(rd, ra, dt)
    params = broadcast_params(cfg, beta=betas, rate_diffusion=rd,
                              rate_active=ra, device=CPU)
    scal = torch.tensor([[b, rd, ra] for b in betas], dtype=torch.float32)
    gen = torch.Generator()
    gen.manual_seed(11)
    slots0 = lgk_init(cfg, gen, B=2, device=CPU)
    slots, sk = slots0, slots0
    band = build_smoothing_band(cfg, CPU)
    rng = np.random.default_rng(5)
    Kp, Lp = -(-K // 4) * 4, -(-L // 128) * 128
    for s in range(25):
        bits = np.zeros((2, 1, 2, 1, Kp, Lp), np.uint32)
        prio = np.zeros((2, K, L), np.int64)
        for b in range(2):
            rank = rng.permutation(K * L).reshape(K, L).astype(np.int64)
            bits[b, 0, 0, 0] = rng.integers(0, 2 ** 32, (Kp, Lp),
                                            dtype=np.uint32)
            bits[b, 0, 1, 0, :K, :L] = rank << 6
            prio[b] = (rank << 17) | np.arange(K * L).reshape(K, L)
        noise = interop.exclusion_noise(bits, K, L, device=CPU)
        u = bits_to_uniform(noise[:, 0, 0].to(torch.int64))
        slots, _, _ = lgk_step(cfg, params, band, slots, dt,
                               _inject=(u, torch.tensor(prio)))
        sk = exclusion_multi_step(scal, torch.zeros(2, dtype=torch.int32),
                                  sk, band, k_steps=1, dt=dt,
                                  periodic=cfg.periodic,
                                  bidirectional=cfg.active_model ==
                                  "bidirectional", noise=noise)
        np.testing.assert_array_equal(slots.numpy(), sk.numpy(),
                                      err_msg=f"step {s}")
    assert not torch.equal(slots, slots0)
    assert (slots != 0).sum(1).max() <= K


def test_priority_encoding_has_no_unsigned_arithmetic():
    """Priorities live in int64: the high 15 random bits over the 17-bit
    slot id, ordered as the JAX uint32 values, all below the empty
    sentinel 0xFFFFFFFF."""
    bits = torch.tensor([[[0xFFFFFFFF, 0x00020000, 0x0001FFFF]]],
                        dtype=torch.int64)
    prio = slot_priorities(bits)
    want = (np.array([0xFFFFFFFF, 0x00020000, 0x0001FFFF], np.uint32)
            & np.uint32(0xFFFE0000)) | np.arange(3, dtype=np.uint32)
    np.testing.assert_array_equal(prio.numpy()[0, 0], want.astype(np.int64))
    assert int(prio.max()) < EMPTY_PRIO and prio.dtype == torch.int64


# ---------------------------------------------------------------------------
# the routes
# ---------------------------------------------------------------------------

SMALL = dict(n_runs_per_beta=2, run_kwargs=dict(T=2.0, obs_dt=0.2),
             do_fit=False, plot_result=False, device=CPU)


@pytest.mark.parametrize("K,route", [(1, "lg_step"), (3, "lgk_step")])
def test_sweep_over_betas_runs_the_slot_engines(tmp_path, K, route):
    """``engine='lattice_gas'`` runs the K=1 engine at K=1 and the slot
    engine above (the route in the result), every
    estimate finite, occupancy ≤ K, no kernel launch."""
    from hydrolim_tpu_torch.sweeps import beta_sweep

    n0 = exclusion_multi_step.launches
    save = beta_sweep.sweep_over_betas(
        [0.5, 2.0], ps_kwargs=dict(L=64, N=40, site_capacity=K),
        npz_path=str(tmp_path / "s.npz"), engine="lattice_gas", seed=1,
        **SMALL)
    assert str(save["route"]) == route
    for k in ("means", "D_means", "m_means", "block_means"):
        assert np.all(np.isfinite(save[k])), k
    assert save["spins_final"].shape == (4, K, 64)
    assert (save["spins_final"] != 0).sum(1).max() <= K
    assert exclusion_multi_step.launches == n0


@pytest.mark.parametrize("case,route", [
    ("crowding", "lgk_step"), ("K10", "lgk_step"),
    ("anchors", "lgk_step anchored"), ("fused", "exclusion_multi_step")])
def test_auto_kernel_routes_by_the_configuration(tmp_path, case, route):
    """``kernel='auto'`` (the sweep's ``'pallas'``/``'auto'``/``'fused'``)
    takes B3/B4 for the fused class and the slot engines for crowding,
    K > 8 and anchors; the anchored route's out dicts carry the exit log
    at anchor sites.  ``kernel='pallas'`` refuses crowding."""
    from hydrolim_tpu_torch.sweeps import beta_sweep

    over = {"crowding": dict(crowding_suppresses_rates=True,
                             site_capacity=3),
            "K10": dict(site_capacity=10, N=200),
            "anchors": dict(site_capacity=3, anchor_positions=[0.3, 0.7],
                            anchor_radius=0.03, k_on=20, k_off=2,
                            k_exit=10),
            "fused": dict(site_capacity=3)}[case]
    ps = dict(beta_sweep.DEFAULT_PS_KWARGS, **dict(dict(L=64, N=60), **over))
    profiles = dict(rho0_plus=lambda x: 0.6, rho0_minus=lambda x: 0.4)
    cfg, out_for, _, frames, spins, took = \
        beta_sweep.run_sweep_grid_lattice_gas(
            [0.5, 2.0], 2, ps, profiles, dict(T=1.0, obs_dt=0.25), seed=2,
            kernel="auto", device=CPU)
    assert took == route
    assert np.isfinite(frames.m_global.numpy()).all()
    if case == "anchors":
        sites = np.flatnonzero(cfg.anchor_mask())
        outs = [out_for(i) for i in range(4)]
        assert sum(len(o["exit_times"]) for o in outs) > 0
        assert all(np.isin(o["exit_positions"], sites).all() for o in outs)
        assert set(np.unique(spins.numpy())) <= {-1, 0, 1}
    if case == "crowding":
        with pytest.raises(ValueError, match="fused-kernel"):
            beta_sweep.run_sweep_grid_lattice_gas(
                [0.5], 1, ps, profiles, dict(T=1.0, obs_dt=0.25),
                kernel="pallas", device=CPU)


def test_system_lattice_gas_out_keys_equal_jax():
    """``ParticleSystem.run(engine='lattice_gas')`` returns the JAX
    package's keys for the same run, every particle tagged and kept; the
    facade refuses anchors, as the JAX package does."""
    from hydrolim_tpu import ParticleSystem as JSystem
    from hydrolim_tpu_torch import ParticleSystem

    kw = dict(L=64, xlim=1, rate_diffusion=0.2, rate_active=3, beta=1.0,
              init="fixed", N=48, scale_rates=False, local_kernel_sigma=0.0,
              periodic=True, site_capacity=3, k_on=0, k_off=0, k_exit=0,
              rng=0)
    run = dict(T=1.0, obs_dt=0.25, record_fft=True, record_var=True,
               engine="lattice_gas")
    want = JSystem(**kw).run(**run)
    ps = ParticleSystem(**kw, device=CPU)
    got = ps.run(**run)
    assert set(got) == set(want)
    assert ps.last_run_info["engine"] == "lgk_step"
    assert [len(p) for p in got["pos_list"]] == [48] * 4
    assert got["pos_frames"].shape == want["pos_frames"].shape == (4, 48)
    np.testing.assert_allclose(got["total_list"].sum(-1) / 64, 1.0,
                               rtol=1e-5)
    with pytest.raises(ValueError, match="anchors"):
        ParticleSystem(**dict(kw, anchor_positions=[0.5]),
                       device=CPU).run(**run)

"""The port's slot-engine runs against the JAX runs, on the CPU.

``run_lattice_gas``, ``run_lattice_gas_k`` and ``run_lattice_gas_anchored``
start from the JAX run's initial field and take its draws, the key stream
rebuilt here (``JaxDraws``): ``split(key, B)``; per replica the scan /
tracer split; one ``split`` per step; the event / priority (or tie) split.
Frames, tracer positions (winding on a torus, phantom tags masked) and
exit logs must agree: integers exactly, floats to 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hydrolim_tpu_torch.particles.lattice_gas import (
    TRACER_INVALID,
    run_lattice_gas,
)
from hydrolim_tpu_torch.particles.lattice_gas_k import (
    run_lattice_gas_anchored,
    run_lattice_gas_k,
    slot_priorities,
)
from hydrolim_tpu_torch import interop
from hydrolim_tpu_torch.core.config import ParticleConfig

CPU = "cpu"
BASE_RATES = dict(rate_diffusion=1.0, rate_active=3.0)
ANCHORS = dict(periodic=False, N=60, anchor_positions=(0.3, 0.7),
               anchor_radius=0.05)
ANCHOR_RATES = dict(k_on=20.0, k_off=2.0, k_exit=10.0)


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
    from hydrolim_tpu.sweeps.ensemble import broadcast_params

    jp = broadcast_params(jcfg, beta=betas, **rates)
    return jp, interop.particle_params(jp, device=CPU)


def _lg_draws(key, shape):
    """JAX ``lg_step``'s draws from its key: event uniforms, tie bits."""
    k_ev, k_tie = jax.random.split(key)
    return (jax.random.uniform(k_ev, shape, jnp.float32),
            jax.random.bernoulli(k_tie, 0.5, shape))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------

class JaxDraws:
    """The draws of a batched JAX slot-engine run (``run_lattice_gas``,
    ``run_lattice_gas_k`` or ``run_lattice_gas_anchored``) from its key:
    ``split(key, B)``; per replica the scan / tracer split (none for the
    anchored scan); per step ``split`` of the scan key, then the event /
    priority (or tie) split of the sub-key."""

    def __init__(self, key, B, K, L, n_steps, *, k1=False, tracers=True):
        shape = (L,) if k1 else (K, L)
        self.K, self.L = K, L

        def one(k):
            if tracers:
                k, k_tr = jax.random.split(k)
                tb = jax.random.bits(k_tr, shape, jnp.uint32) >> 1
            else:
                tb = jnp.zeros(shape, jnp.uint32)

            def body(kk, _):
                kk, sub = jax.random.split(kk)
                if k1:
                    return kk, _lg_draws(sub, shape)
                k_ev, k_prio = jax.random.split(sub)
                return kk, (jax.random.uniform(k_ev, shape, jnp.float32),
                            jax.random.bits(k_prio, shape, jnp.uint32))

            _, draws = jax.lax.scan(body, k, None, length=n_steps)
            return tb, draws

        tb, (a, b) = jax.jit(jax.vmap(one))(jax.random.split(key, B))
        self.tb = np.asarray(tb).astype(np.int64)
        self.a, self.b = np.asarray(a), np.asarray(b)
        self.k1 = k1

    def tracer_bits(self, shape):
        return torch.tensor(self.tb.reshape(shape))

    def step(self, i):
        u = torch.tensor(self.a[:, i])
        if self.k1:
            return u, torch.tensor(self.b[:, i])
        return u, slot_priorities(torch.tensor(
            self.b[:, i].astype(np.int64)))


def _assert_frames_equal(pf, jf):
    """Tracer positions equal; every float field to 1e-6, the spectrum to
    1e-6 of its DC bin (the JAX spectrum is a float32 matmul DFT, each bin
    carrying the roundoff of sums of the DC bin's size)."""
    for name in pf._fields:
        p = getattr(pf, name).numpy()
        j = np.asarray(getattr(jf, name))
        if name == "tracer_pos":
            np.testing.assert_array_equal(p, j, err_msg=name)
        else:
            scale = np.abs(j).max() if name == "fft_amp" else 1.0
            np.testing.assert_allclose(p, j, rtol=1e-6, atol=1e-6 * scale,
                                       err_msg=name)


RUN = dict(T=0.5, obs_dt=0.1, dt=0.0084)       # 5 frames × 12 steps


@pytest.mark.parametrize("periodic", [True, False])
def test_run_lattice_gas_equals_jax(periodic):
    """The K=1 run from the JAX run's occupancy and draws: frames, tracer
    positions (every particle tagged, winding on the torus) and the final
    occupancy; floats to 1e-6."""
    from hydrolim_tpu.particles.lattice_gas import lg_init as j_init
    from hydrolim_tpu.particles.lattice_gas import run_lattice_gas as j_run

    kw = _kw(site_capacity=1, N=40, local_kernel_sigma=0.02,
             periodic=periodic, active_model="bidirectional")
    jcfg, cfg = _configs(kw)
    B, L = 2, cfg.L
    jp, pp = _params(jcfg, [0.8, 2.0], rate_diffusion=4.0, rate_active=6.0)
    key = jax.random.PRNGKey(7)
    jframes, jocc = j_run(jcfg, jp, key, n_tracers=40, **RUN)
    keys = jax.random.split(key, B)
    occ0 = jax.vmap(lambda k: j_init(jcfg, jax.random.fold_in(k, 0)))(keys)
    draws = JaxDraws(key, B, 1, L, 48, k1=True)
    pframes, pocc = run_lattice_gas(
        cfg, pp, device=CPU, n_tracers=40,
        _occ0=torch.tensor(np.asarray(occ0)), _draws=draws, **RUN)
    _assert_frames_equal(pframes, jframes)
    np.testing.assert_array_equal(pocc.numpy(), np.asarray(jocc))
    tr = pframes.tracer_pos.numpy()
    assert (tr != TRACER_INVALID).all()
    if periodic:
        assert (tr.min() < 0) or (tr.max() >= L)         # a tracer wound


@pytest.mark.parametrize("case", ["periodic-global", "walls-local-poisson"])
def test_run_lattice_gas_k_equals_jax(case):
    """The K-slot run from the JAX run's slots and draws, tracers tagged
    over the whole buffer (phantom tags past the realised count): frames,
    tracer positions and final slots equal; floats to 1e-6."""
    from hydrolim_tpu.particles.lattice_gas_k import lgk_init as j_init
    from hydrolim_tpu.particles.lattice_gas_k import (
        run_lattice_gas_k as j_run,
    )
    from hydrolim_tpu.sweeps.beta_sweep import make_exp_gradient

    if case == "periodic-global":
        kw, prof, n_t = _kw(), (None, None), 96
    else:
        kw = _kw(init="poisson", local_kernel_sigma=0.02, periodic=False)
        g = make_exp_gradient(64, 96, 0.75, 0.35, anchor_positions=None)
        prof, n_t = (g[2], g[3]), ParticleConfig(**kw).n_buf
    jcfg, cfg = _configs(kw)
    B, K, L = 2, cfg.K, cfg.L
    jp, pp = _params(jcfg, [0.8, 2.0], **BASE_RATES)
    key = jax.random.PRNGKey(9)
    jframes, jsl = j_run(jcfg, jp, key, n_tracers=n_t, rho0_plus=prof[0],
                         rho0_minus=prof[1], **RUN)
    keys = jax.random.split(key, B)
    sl0 = jax.vmap(lambda k: j_init(jcfg, jax.random.fold_in(k, 0), *prof))(
        keys)
    draws = JaxDraws(key, B, K, L, 48)
    pframes, psl = run_lattice_gas_k(
        cfg, pp, device=CPU, n_tracers=n_t,
        _slots0=torch.tensor(np.asarray(sl0)), _draws=draws, **RUN)
    _assert_frames_equal(pframes, jframes)
    np.testing.assert_array_equal(psl.numpy(), np.asarray(jsl))
    valid = pframes.tracer_pos.numpy()[:, 0] != TRACER_INVALID
    assert valid.any(1).all()
    if case != "periodic-global":
        assert (~valid).any(1).all()       # phantom tags last, masked


def test_run_lattice_gas_anchored_equals_jax():
    """The anchored run (local m, walls, bind / unbind / exit live) from
    the JAX run's slots and draws, with an 8-entry exit log that
    overflows: frames, final slots, exit counts and sites equal, exit
    times to 1e-6 (float32 t + Δt at the start of each step)."""
    from hydrolim_tpu.particles.lattice_gas_k import lgk_init as j_init
    from hydrolim_tpu.particles.lattice_gas_k import (
        run_lattice_gas_anchored as j_run,
    )

    kw = _kw(local_kernel_sigma=0.02, **ANCHORS)
    jcfg, cfg = _configs(kw)
    B, K, L = 2, cfg.K, cfg.L
    jp, pp = _params(jcfg, [0.8, 2.0], **BASE_RATES,
                     **dict(ANCHOR_RATES, k_exit=40.0))
    key = jax.random.PRNGKey(4)
    run = dict(RUN, T=1.0)                          # 10 frames × 12 steps
    jframes, jsl, jlog = j_run(jcfg, jp, key, **run)
    keys = jax.random.split(key, B)
    sl0 = jax.vmap(lambda k: j_init(jcfg, jax.random.fold_in(k, 0)))(keys)
    draws = JaxDraws(key, B, K, L, 108, tracers=False)
    pframes, psl, plog = run_lattice_gas_anchored(
        cfg, pp, device=CPU, _slots0=torch.tensor(np.asarray(sl0)),
        _draws=draws, **run)
    _assert_frames_equal(pframes, jframes)
    np.testing.assert_array_equal(psl.numpy(), np.asarray(jsl))
    ec, et, ep = (np.asarray(a) for a in jlog)
    np.testing.assert_array_equal(plog[0].numpy(), ec)
    np.testing.assert_allclose(plog[1].numpy(), et, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(plog[2].numpy(), ep)
    assert ec.max() > et.shape[1]                     # the log overflowed



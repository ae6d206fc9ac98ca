"""The port's lattice-sharded slot runs against the JAX package's sharded
runs, on the CPU.

``tests/test_spatial_sharding.py:45``, ``:64`` and ``:82`` run the JAX
package's ``run_lattice_gas`` and ``run_lattice_gas_k`` with the lattice
split 8-way over virtual CPU devices (and on a (2, 4) ('sweep', 'space')
grid).  Here the port runs the same configurations on
``space_mesh(devices=["cpu"] * 8)`` (and ``grid_mesh(2, 4, ...)``) from the
JAX run's initial field with its draws (``JaxDraws`` of
``tests/test_torch_slot_runs.py``, sliced to each segment's columns), and
must agree with the JAX sharded run: the final field and every frame
field exactly, ``var`` and ``fft_amp`` within the JAX test's own
tolerances for its sharded records (``test_spatial_sharding.py:28-42``).
"""
import jax
import numpy as np
import pytest
import torch

from hydrolim_tpu_torch import interop
from hydrolim_tpu_torch.core.config import ParticleConfig
from hydrolim_tpu_torch.parallel.spatial import (
    grid_mesh,
    grid_sharding,
    space_mesh,
    space_sharding,
)
from hydrolim_tpu_torch.particles.lattice_gas import run_lattice_gas
from hydrolim_tpu_torch.particles.lattice_gas_k import run_lattice_gas_k
from test_torch_slot_runs import JaxDraws

CPU = "cpu"
EIGHT = ["cpu"] * 8
KW = dict(T=1.0, obs_dt=0.25)

@pytest.fixture(autouse=True)
def _one_torch_thread():
    if len(jax.devices("cpu")) < 8:
        pytest.skip("needs 8 virtual CPU devices")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(**over):
    from hydrolim_tpu.core.config import ParticleConfig as JConfig

    kw = dict(L=256, N=128, init="fixed", scale_rates=False,
              local_kernel_sigma=0.0, periodic=True, site_capacity=1,
              active_model="plus_forward")
    kw.update(over)
    return JConfig(**kw), ParticleConfig(**kw)


def _params(jcfg, betas, n_runs=1, **rates):
    from hydrolim_tpu.sweeps.ensemble import broadcast_params

    jp = broadcast_params(jcfg, beta=betas, n_runs=n_runs, **rates)
    return jp, interop.particle_params(jp, device=CPU)


def _init(j_init, jcfg, key, B):
    keys = jax.random.split(key, B)
    return torch.tensor(np.asarray(jax.vmap(
        lambda k: j_init(jcfg, jax.random.fold_in(k, 0)))(keys)))


def _assert_close(pf, jf):
    """The JAX test's comparison of a sharded run with its unsharded one
    (``test_spatial_sharding.py:28-42``): every field equal but the
    spectrum and the variance, float lattice-axis reductions."""
    for name in pf._fields:
        p, j = getattr(pf, name).numpy(), np.asarray(getattr(jf, name))
        if name == "fft_amp":
            np.testing.assert_allclose(p, j, rtol=1e-5, atol=1e-4)
        elif name == "var":
            np.testing.assert_allclose(p, j, rtol=1e-5, atol=1e-7,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(p, j, err_msg=name)


def test_lattice_gas_space_sharded_equals_jax_sharded():
    """``test_spatial_sharding.py:45``: K=1, 8 tracers, 150 steps."""
    from hydrolim_tpu.parallel import spatial as js
    from hydrolim_tpu.particles.lattice_gas import lg_init, run_lattice_gas \
        as j_run

    jcfg, cfg = _configs()
    jp, pp = _params(jcfg, [1.0, 2.0], rate_diffusion=1.0, rate_active=2.0)
    key = jax.random.PRNGKey(0)
    jmesh = js.space_mesh(8, devices=jax.devices("cpu"))
    jf, jo = jax.device_get(j_run(jcfg, jp, key, **KW, dt=5e-3, n_tracers=8,
                                  occ_sharding=js.space_sharding(jmesh)))
    pf, po = run_lattice_gas(
        cfg, pp, **KW, dt=5e-3, n_tracers=8, device=CPU,
        occ_sharding=space_sharding(space_mesh(devices=EIGHT)),
        _occ0=_init(lg_init, jcfg, key, 2),
        _draws=JaxDraws(key, 2, 1, 256, 150, k1=True))
    _assert_close(pf, jf)
    np.testing.assert_array_equal(po.numpy(), np.asarray(jo))


def test_lattice_gas_k_space_sharded_equals_jax_sharded():
    """``test_spatial_sharding.py:64``: K=3, 375 steps."""
    from hydrolim_tpu.parallel import spatial as js
    from hydrolim_tpu.particles.lattice_gas_k import lgk_init
    from hydrolim_tpu.particles.lattice_gas_k import run_lattice_gas_k \
        as j_run

    jcfg, cfg = _configs(N=192, site_capacity=3)
    jp, pp = _params(jcfg, [1.5], 2, rate_diffusion=0.5, rate_active=3.0)
    key = jax.random.PRNGKey(1)
    jmesh = js.space_mesh(8, devices=jax.devices("cpu"))
    jf, js_ = jax.device_get(j_run(
        jcfg, jp, key, **KW, dt=2e-3,
        occ_sharding=js.space_sharding(jmesh, slots=True)))
    pf, ps = run_lattice_gas_k(
        cfg, pp, **KW, dt=2e-3, device=CPU,
        occ_sharding=space_sharding(space_mesh(devices=EIGHT), slots=True),
        _slots0=_init(lgk_init, jcfg, key, 2),
        _draws=JaxDraws(key, 2, 3, 256, 375))
    _assert_close(pf, jf)
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js_))


def test_grid_mesh_equals_jax_grid():
    """``test_spatial_sharding.py:82``: both engines on the (2, 4) grid,
    B = 4 over two rows, each row's block taking its rows of the draws."""
    from hydrolim_tpu.parallel import spatial as js
    from hydrolim_tpu.particles.lattice_gas import lg_init, run_lattice_gas \
        as j_lg
    from hydrolim_tpu.particles.lattice_gas_k import lgk_init
    from hydrolim_tpu.particles.lattice_gas_k import run_lattice_gas_k \
        as j_lgk

    jg = js.grid_mesh(2, 4, devices=jax.devices("cpu"))
    g = grid_mesh(2, 4, devices=EIGHT)
    kw = dict(KW, dt=5e-3)

    jcfg, cfg = _configs(active_model="bidirectional")
    jp, pp = _params(jcfg, [0.5, 2.0], 2, rate_diffusion=0.3,
                     rate_active=1.0)
    key = jax.random.PRNGKey(2)
    jf, jo = jax.device_get(j_lg(jcfg, jp, key, **kw, n_tracers=8,
                                 occ_sharding=js.grid_sharding(jg)))
    pf, po = run_lattice_gas(
        cfg, pp, **kw, n_tracers=8, device=CPU,
        occ_sharding=grid_sharding(g), _occ0=_init(lg_init, jcfg, key, 4),
        _draws=JaxDraws(key, 4, 1, 256, 150, k1=True))
    _assert_close(pf, jf)
    np.testing.assert_array_equal(po.numpy(), np.asarray(jo))

    jcfg, cfg = _configs(N=300, site_capacity=3,
                         active_model="bidirectional")
    jp, pp = _params(jcfg, [0.5, 2.0], 2, rate_diffusion=0.3,
                     rate_active=1.0)
    key = jax.random.PRNGKey(3)
    jf, js_ = jax.device_get(j_lgk(jcfg, jp, key, **kw,
                                   occ_sharding=js.grid_sharding(
                                       jg, slots=True)))
    pf, ps = run_lattice_gas_k(
        cfg, pp, **kw, device=CPU, occ_sharding=grid_sharding(g, slots=True),
        _slots0=_init(lgk_init, jcfg, key, 4),
        _draws=JaxDraws(key, 4, 3, 256, 150))
    _assert_close(pf, jf)
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js_))

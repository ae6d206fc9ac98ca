"""Kernel B1 of the PyTorch port against the JAX package, on the CPU.

The JAX fused mean-field kernel runs as ``test_kernel_logic_cpu.py`` runs
it (``interpret=True`` with injected bits); the port's ``meanfield_multi_step``
gets the same state and bits through ``interop`` and, on CPU tensors, runs
its plain version.  Integer state must be EQUAL.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hydrolim_tpu.core.config import ParticleConfig as JParticleConfig
from hydrolim_tpu.core.config import make_particle_params as j_make_params
from hydrolim_tpu_torch import interop
from hydrolim_tpu_torch.core.config import ParticleConfig
from hydrolim_tpu_torch.ops.stepper_kernel import (
    bits_to_uniform,
    meanfield_multi_step,
)
from hydrolim_tpu_torch.particles.stepper import (
    ParticleState,
    _step_meanfield_global,
)


def _jax_kernel(scal, pos, sig, wnd, bits, *, L, k_steps, dt, bidi, n):
    from hydrolim_tpu.ops.pallas_stepper import (
        meanfield_multi_step as j_step,
        pack_particles,
        unpack_particles,
    )

    p, s, w = pack_particles(pos, sig, wnd)
    out = j_step(jnp.asarray(scal), jnp.zeros((scal.shape[0],), jnp.int32),
                 p, s, w, L=L, k_steps=k_steps, dt=dt, bidirectional=bidi,
                 n_active=n, interpret=True, noise=jnp.asarray(bits))
    return unpack_particles(*out, n)


def _port_kernel(scal, pos, sig, wnd, bits, *, L, k_steps, dt, bidi, n):
    from hydrolim_tpu.ops.pallas_stepper import pack_particles

    lanes = pack_particles(pos, sig, wnd)
    p, s, w = (interop.lanes_to_rows(np.asarray(x), n, device="cpu")
               for x in lanes)
    out = meanfield_multi_step(
        torch.tensor(scal), torch.zeros(scal.shape[0], dtype=torch.int32),
        p, s, w, L=L, k_steps=k_steps, dt=dt, bidirectional=bidi,
        noise=interop.meanfield_noise(bits, n, device="cpu"))
    assert meanfield_multi_step.launches == 0     # CPU tensors: plain version
    return [t.numpy() for t in out]


@pytest.mark.parametrize("bidirectional", [True, False])
def test_b1_plain_matches_jax_kernel(bidirectional):
    """L=64, N=96, 48 steps, two replicas with distinct β: pos/σ/wind equal
    to the JAX fused kernel at matched bits."""
    L, N, k_steps, dt = 64, 96, 48, 2e-3
    rng = np.random.default_rng(7)
    pos = rng.integers(0, L, (2, N))
    sig = rng.choice([-1, 1], (2, N))
    wnd = np.zeros((2, N), np.int64)
    bits = rng.integers(0, 2 ** 32, size=(2, k_steps, 1, 128),
                        dtype=np.uint32)
    scal = np.array([[1.2, 0.5, 2.0], [0.4, 0.5, 2.0]], np.float32)
    kw = dict(L=L, k_steps=k_steps, dt=dt, bidi=bidirectional, n=N)
    want = _jax_kernel(scal, pos, sig, wnd, bits, **kw)
    got = _port_kernel(scal, pos, sig, wnd, bits, **kw)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g, w_)
    assert (got[0] != pos).any() and (got[1] != sig).any()


def test_b1_plain_matches_jax_kernel_with_padding():
    """N=100 is not a multiple of 128: the JAX kernel carries 28 σ=0
    padding lanes, the port none.  Equal state, m normalized by the true N."""
    L, N, k_steps, dt = 32, 100, 16, 2e-3
    rng = np.random.default_rng(3)
    pos = rng.integers(0, L, (1, N))
    sig = rng.choice([-1, 1], (1, N))
    wnd = np.zeros((1, N), int)
    bits = rng.integers(0, 2 ** 32, size=(1, k_steps, 1, 128),
                        dtype=np.uint32)
    scal = np.array([[1.0, 0.5, 2.0]], np.float32)
    kw = dict(L=L, k_steps=k_steps, dt=dt, bidi=True, n=N)
    want = _jax_kernel(scal, pos, sig, wnd, bits, **kw)
    got = _port_kernel(scal, pos, sig, wnd, bits, **kw)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g, w_)


@pytest.mark.parametrize("model", ["bidirectional", "plus_forward"])
def test_step_meanfield_global_matches_jax(model):
    """The plain version's building block, one step at a time against the
    JAX XLA engine at matched uniforms."""
    from hydrolim_tpu.particles.init import init_particles
    from hydrolim_tpu.particles.stepper import (
        _step_meanfield_global as j_step,
    )

    L, N, dt = 48, 64, 3e-3
    kw = dict(L=L, N=N, init="fixed", scale_rates=False,
              local_kernel_sigma=0.0, periodic=True, site_capacity=None,
              active_model=model)
    jcfg, cfg = JParticleConfig(**kw), ParticleConfig(**kw)
    jp = j_make_params(jcfg, beta=1.7, rate_diffusion=0.7, rate_active=3.0)
    tp = interop.particle_params(jp, device="cpu")
    st = init_particles(jcfg, jax.random.PRNGKey(4))
    ts = ParticleState(pos=torch.tensor(np.asarray(st.pos))[None],
                       sigma=torch.tensor(np.asarray(st.sigma))[None],
                       wind=torch.tensor(np.asarray(st.wind))[None])
    rng = np.random.default_rng(1)
    for _ in range(30):
        bits = rng.integers(0, 2 ** 32, (1, N), dtype=np.uint32)
        u = bits_to_uniform(interop.to_torch(bits, torch.int32, device="cpu"))
        st = j_step(jcfg, jp, st, dt, u_override=jnp.asarray(u[0].numpy()))
        ts = _step_meanfield_global(cfg, tp, ts, dt, u_override=u)
    np.testing.assert_array_equal(ts.pos[0].numpy(), np.asarray(st.pos))
    np.testing.assert_array_equal(ts.sigma[0].numpy(), np.asarray(st.sigma))
    np.testing.assert_array_equal(ts.wind[0].numpy(), np.asarray(st.wind))


def test_bits_to_uniform_matches_kernel_map():
    """(bits & 0xFFFFFF)·2⁻²⁴ on int32-held uint32 bits, incl. the top bit."""
    bits = np.array([0, 1, 0xFFFFFF, 0x1000000, 0xFFFFFFFF, 0x80000001],
                    np.uint32)
    want = (bits & np.uint32(0xFFFFFF)).astype(np.float32) * \
        np.float32(2.0 ** -24)
    got = bits_to_uniform(
        interop.to_torch(bits, torch.int32, device="cpu")).numpy()
    np.testing.assert_array_equal(got, want)


def test_masked_bincount_and_frame_obs_match_jax():
    """Per-site scatter-add with out-of-range indices dropped (never
    wrapped, never spilled into the next replica), and the sweep's frame
    observables built on it."""
    from hydrolim_tpu.ops.segment import masked_bincount as j_bincount
    from hydrolim_tpu.sweeps.fast_meanfield import _frame_obs as j_frame_obs

    from hydrolim_tpu_torch.ops.segment import masked_bincount
    from hydrolim_tpu_torch.sweeps.fast_meanfield import _frame_obs

    rng = np.random.default_rng(2)
    L = 16
    pos = rng.integers(-4, L + 4, (3, 50)).astype(np.int32)
    w = rng.random((3, 50)).astype(np.float32)
    got = masked_bincount(torch.tensor(pos), torch.tensor(w), L).numpy()
    np.testing.assert_allclose(got, np.asarray(j_bincount(
        jnp.asarray(pos), jnp.asarray(w), L)), rtol=1e-6)
    assert got.shape == (3, L)
    pos = rng.integers(0, 5 * L, (3, 50)).astype(np.int32)
    sig = rng.choice([-1, 1], (3, 50)).astype(np.int32)
    got = _frame_obs(torch.tensor(pos), torch.tensor(sig), L, 50, 1.0 / L)
    want = j_frame_obs(jnp.asarray(pos), jnp.asarray(sig), L, 50, 1.0 / L)
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), rtol=1e-6,
                                   atol=1e-7)

"""The port's profiling and debug utilities (``utils/profiling.py``,
``utils/debug.py``) on the CPU: the ``torch.profiler`` trace (the spans'
own tests are ``tests/test_torch_tracing.py``); the debug invariants
passing on the port's own initial state and failing in
``tests/test_aux.py``'s cases (a site over capacity, a position off the
lattice, a negative density), each also on the JAX package's checks for
the same arrays; ``nan_guard`` inert unless ``HYDROLIM_DEBUG`` is set."""
import json

import numpy as np
import pytest
import torch

from hydrolim_tpu.utils.debug import (
    check_density_invariants as j_check_density,
)
from hydrolim_tpu_torch.core.config import ParticleConfig
from hydrolim_tpu_torch.particles.init import init_particles
from hydrolim_tpu_torch.utils.debug import (
    check_density_invariants,
    check_particle_invariants,
    debug_enabled,
    nan_guard,
)
from hydrolim_tpu_torch.utils.profiling import trace


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path / "tr")) as logdir:
        (torch.arange(1000.0) ** 2).sum()
    events = json.loads((tmp_path / "tr" / "trace.json").read_text())
    assert logdir == str(tmp_path / "tr")
    assert any("aten::pow" in e.get("name", "")
               for e in events["traceEvents"])


def _state(config, seed=0):
    gen = torch.Generator()
    gen.manual_seed(seed)
    return init_particles(config, gen, B=2, device="cpu")


def test_particle_invariants_pass_and_fail():
    """The port's fixed init (two replicas, a dead buffer tail) passes;
    a position off the lattice and a site over capacity fail."""
    config = ParticleConfig(L=16, N=8, n_pad=16, init="fixed",
                            site_capacity=1)
    state = _state(config)
    assert not state.alive.all()            # the padded tail is dead
    check_particle_invariants(config, state)
    bad = state._replace(pos=state.pos.clone())
    bad.pos[0, 0] = 99
    with pytest.raises(AssertionError, match="out of range"):
        check_particle_invariants(config, bad)
    crowded = state._replace(pos=state.pos.clone())
    alive0 = torch.nonzero(state.alive[1])[:, 0]
    crowded.pos[1, alive0[1]] = crowded.pos[1, alive0[0]]
    with pytest.raises(AssertionError, match="exclusion violated"):
        check_particle_invariants(config, crowded)
    # K=3 admits the same doubled site; without exclusion anything goes
    for cap in (3, None):
        check_particle_invariants(
            ParticleConfig(L=16, N=8, n_pad=16, init="fixed",
                           site_capacity=cap),
            crowded)
    flipped = state._replace(sigma=state.sigma.clone())
    flipped.sigma[0, alive0[0]] = 0
    with pytest.raises(AssertionError, match="spin"):
        check_particle_invariants(config, flipped)


@pytest.mark.parametrize("rho_p,rho_m,ok", [
    (np.ones(4), np.zeros(4), True),
    (np.array([1.0, -0.1]), np.zeros(2), False),
    (np.ones(2), np.array([0.0, np.nan]), False),
])
def test_density_invariants_follow_jax(rho_p, rho_m, ok):
    for check in (check_density_invariants, j_check_density):
        if ok:
            check(rho_p, rho_m)
        else:
            with pytest.raises(AssertionError):
                check(rho_p, rho_m)
    if ok:                                  # tensors as well as arrays
        check_density_invariants(torch.tensor(rho_p), torch.tensor(rho_m))


def test_nan_guard_only_checks_under_the_debug_flag(monkeypatch):
    x = torch.tensor([1.0, float("nan")])
    monkeypatch.delenv("HYDROLIM_DEBUG", raising=False)
    assert not debug_enabled()
    assert nan_guard(x, "x") is x
    monkeypatch.setenv("HYDROLIM_DEBUG", "1")
    assert debug_enabled()
    ok = torch.ones(3)
    assert nan_guard(ok) is ok
    with pytest.raises(FloatingPointError, match="x"):
        nan_guard(x, "x")
    monkeypatch.setenv("HYDROLIM_DEBUG", "false")
    assert not debug_enabled()

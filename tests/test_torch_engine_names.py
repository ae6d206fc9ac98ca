"""C5: the JAX package's ``engine`` names on the entry points that lacked
them, on the CPU: ``run_exclusion_sweep(engine=)`` ('auto', 'pallas',
'pallas_rb' on B3's route; 'xla' on the plain-torch K-slot engine, as the
JAX package routes it), the particle phase diagram's ``run_grid`` (the
route taken in ``engines_used``) and the PDE CLIs' ``--engine`` (every
name is the one fused solve; the JSON records the name and the route)."""
import json

import numpy as np
import pytest
import torch

from hydrolim_tpu_torch.core.config import ParticleConfig
from hydrolim_tpu_torch.particles.lattice_gas_k import run_lattice_gas_k
from hydrolim_tpu_torch.sweeps.ensemble import broadcast_params
from hydrolim_tpu_torch.sweeps.fast_exclusion import (
    exclusion_route,
    run_exclusion_sweep,
)
from test_torch_checkpoint import assert_same

CPU = "cpu"
RUN = dict(T=0.6, obs_dt=0.1, dt=0.01, seed=4, device=CPU, n_tracers=60)


def _inputs():
    cfg = ParticleConfig(L=64, N=120, init="fixed", scale_rates=False,
                         periodic=False, site_capacity=3,
                         local_kernel_sigma=0.02)
    return cfg, broadcast_params(cfg, beta=[0.5, 2.5], rate_diffusion=0.5,
                                 rate_active=2.0, device=CPU)


def test_fused_engine_names_take_b3s_route():
    cfg, p = _inputs()
    want = run_exclusion_sweep(cfg, p, **RUN)
    for engine in ("auto", "pallas", "pallas_rb"):
        assert exclusion_route(engine) == "exclusion_multi_step"
        assert_same(want, run_exclusion_sweep(cfg, p, engine=engine, **RUN))


def test_xla_engine_runs_the_slot_engine(tmp_path):
    """'xla' is ``run_lattice_gas_k`` (its final slots as spins), and its
    checkpointed runner under ``ckpt_dir=``."""
    cfg, p = _inputs()
    assert exclusion_route("xla") == "lgk_step"
    frames, slots = run_lattice_gas_k(cfg, p, **RUN)
    got = run_exclusion_sweep(cfg, p, engine="xla", **RUN)
    assert_same((frames, torch.sign(slots).to(torch.int32)), got)
    assert_same(got, run_exclusion_sweep(cfg, p, engine="xla",
                                         ckpt_dir=tmp_path / "ck",
                                         chunk_frames=2, **RUN))
    with pytest.raises(ValueError, match="unknown engine"):
        run_exclusion_sweep(cfg, p, engine="fused", **RUN)


@pytest.mark.parametrize("engine,route", [("auto", "exclusion_multi_step"),
                                          ("xla", "lgk_step")])
def test_particle_phase_diagram_records_the_route(engine, route):
    from hydrolim_tpu_torch.experiments.particle_phase_diagram import run_grid

    data = run_grid(np.linspace(0, 3, 2), [0.05, 0.0], 1, L=64, N=48, K=3,
                    T=1.0, obs_dt=0.25, rate_diffusion=0.02,
                    rate_active=5.0, device=CPU, engine=engine)
    assert data["engine"] == engine
    assert data["engines_used"] == [route, route]
    assert np.isfinite(np.asarray(data["m"])).all()


def test_pde_cli_engine_names_record_the_route(tmp_path, monkeypatch):
    """``pde magn --engine pallas`` and ``pde-phase-diagram --engine xla``
    at tiny sizes: the JSON names the engine given and the fused solve."""
    from hydrolim_tpu_torch.experiments import pde_experiments
    from hydrolim_tpu_torch.experiments import pde_phase_diagram

    monkeypatch.setattr(pde_experiments, "pde_kernel_sigma_sweep",
                        lambda **kw: dict(m={0.05: np.zeros((2, 3))},
                                          v={}, D={}, var={}, T=1.0,
                                          gamma=0.0, beta=0.5, kw=kw))
    r = pde_experiments.main("magn", small=True, outdir=str(tmp_path),
                             device=CPU, engine="pallas")
    assert r["kw"]["engine"] == "pallas" and r["kw"]["n_devices"] is None
    rec = json.loads((tmp_path / "magn.json").read_text())
    assert (rec["engine"], rec["route"]) == ("pallas", "pde_multi_step")
    data = pde_phase_diagram.run_grid([0.5, 2.5], [9e4], 1, L=32, T=0.02,
                                      dt=1e-3, gamma=0.2, lam=0.6,
                                      n_tracers=4, device=CPU, engine="xla")
    assert (data["engine"], data["route"]) == ("xla", "pde_multi_step")

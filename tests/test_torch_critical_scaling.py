"""The critical-scaling driver at ``--small`` on the CPU, through the port's
launcher (``python -m hydrolim_tpu_torch critical-scaling``), as
``tests/test_critical_scaling_driver.py`` runs the JAX driver: the N
ladder {256, 1024, 4096} × 2 β × 16 runs on kernel B1's route (its plain
version on CPU tensors; about 18k steps of 32 replicas), the driver's own
asserts (RMS m ~ N^-1/2 at β = 0.5, ~ N^-1/4 at β = 1) and its JSON.

One test of about a minute on one CPU thread: the ladder is the JAX
driver's ``--small``, and N = 4096 alone is 1.4e9 particle-steps.
"""
import json
import sys

import torch

from hydrolim_tpu_torch import __main__ as launcher
from hydrolim_tpu_torch.ops.stepper_kernel import meanfield_multi_step


def test_critical_scaling_small_through_the_launcher(tmp_path, monkeypatch):
    monkeypatch.setattr(sys, "argv", list(sys.argv))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        rc = launcher.main(["critical-scaling", "--small", "--device", "cpu",
                            "--outdir", str(tmp_path)])
    finally:
        torch.set_num_threads(n)
    assert rc == 0
    assert meanfield_multi_step.launches == 0      # CPU tensors: plain B1
    rec = json.loads((tmp_path / "critical_scaling.json").read_text())
    assert rec["Ns"] == [256, 1024, 4096] and rec["n_runs"] == 16
    assert -0.62 < rec["slope_subcritical"] < -0.38
    assert -0.35 < rec["slope_critical"] < -0.15
    # the critical fluctuation is anomalously LARGE at every N
    for m_sub, m_cr in zip(rec["rms_mean"]["0.5"], rec["rms_mean"]["1.0"]):
        assert m_cr > 2 * m_sub
    assert len(rec["wall_s"]) == 3
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return
    assert (tmp_path / "critical_scaling.png").stat().st_size > 10_000

"""Unified command-line launcher: ``python -m hydrolim_tpu_torch <command> ...``.

Thin dispatch onto the port's experiment drivers
(``hydrolim_tpu_torch/experiments/``), with the JAX launcher's command
names (``python -m hydrolim_tpu``).  ``--help`` on any command shows that
driver's own flags (``--small``, ``--engine``, ``--device``,
``--ckpt-dir``, ...).  Every driver runs on the card unless given
``--device cpu``.
"""
from __future__ import annotations

import runpy
import sys

# command -> (driver module under hydrolim_tpu_torch.experiments, and the
# help line)
_COMMANDS = {
    "beta-sweep": ("particle_beta_sweep", "particle β-sweep (flagship)"),
    "sigma-sweep": ("particle_sigma_sweep", "(σ, β) double sweep"),
    "double-sweep": ("particle_double_sweep",
                     "(N, β) sweep + C0/C1/C2 meta-fit"),
    "local-structure": ("particle_local_structure",
                        "pattern-formation β-sweep"),
    "particle-single": ("particle_single", "single K=3 particle run"),
    "anchored-exits": ("anchored_exits", "bind/unbind/exit channels"),
    "pde": ("pde_experiments", "PDE single/beta/magn/magn2"),
    "cross-engine": ("cross_engine_validation",
                     "particle↔PDE comparison figure"),
    "real-data": ("real_data_fit", "kinesin-II χ² fit"),
    "convergence": ("convergence", "hydrodynamic-limit rate (N^-1/2)"),
    "critical-scaling": ("critical_scaling",
                         "critical fluctuation exponent"),
    "large-lattice": ("large_lattice", "L=65536 sharded lattice"),
    "pde-phase-diagram": ("pde_phase_diagram",
                          "(β, σ) PDE phase plane, 1024 replicas"),
    "particle-phase-diagram": ("particle_phase_diagram",
                               "(β, σ) particle phase plane + "
                               "micro↔macro boundary overlay"),
    "profile-kernels": ("profile_exclusion_kernel",
                        "exclusion-kernel profiler (CUDA)"),
    "ckpt-overhead": ("measure_ckpt_overhead",
                      "checkpointing wall-time overhead"),
}


def _usage() -> str:
    lines = ["usage: python -m hydrolim_tpu_torch <command> [driver args...]",
             "", "commands:"]
    for name, (_, desc) in _COMMANDS.items():
        lines.append(f"  {name:<23} {desc}")
    lines.append("")
    lines.append("e.g.: python -m hydrolim_tpu_torch beta-sweep --small "
                 "--engine lattice_gas")
    return "\n".join(lines)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(_usage())
        return 0
    cmd = argv[0]
    if cmd not in _COMMANDS:
        print(f"unknown command {cmd!r}\n\n{_usage()}", file=sys.stderr)
        return 2
    module, _ = _COMMANDS[cmd]
    # the drivers parse sys.argv under `if __name__ == "__main__"` — run
    # them exactly as ``python -m`` would
    sys.argv = [cmd] + argv[1:]
    runpy.run_module(f"hydrolim_tpu_torch.experiments.{module}",
                     run_name="__main__", alter_sys=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The port's launcher, ``python -m hydrolim_tpu_torch <command>``, against
the JAX package's (``python -m hydrolim_tpu``): the same command names in
the same order, every command's ``--help`` served by the port's driver
(exit 0), every flag of every JAX driver accepted by the port's
(read from the JAX driver's text, without importing it), ``large-lattice``
refusing what splits the lattice axis, an unknown command refused with 2.  The ``--help`` calls run in-process (the
drivers' imports are shared); the launcher's own ``--help`` runs as a
subprocess."""
import re
import subprocess
import sys
from pathlib import Path

import pytest

from hydrolim_tpu.__main__ import _COMMANDS as JAX_COMMANDS
from hydrolim_tpu_torch import __main__ as launcher

REPO = Path(__file__).resolve().parents[1]


def test_help_lists_the_jax_launchers_commands():
    run = subprocess.run([sys.executable, "-m", "hydrolim_tpu_torch",
                          "--help"], cwd=REPO, capture_output=True,
                         text=True, timeout=120, check=True)
    lines = run.stdout.splitlines()
    start = lines.index("commands:") + 1
    names = [ln.split()[0] for ln in lines[start:] if ln.startswith("  ")]
    assert names == list(JAX_COMMANDS)
    assert lines[0].startswith("usage: python -m hydrolim_tpu_torch")


@pytest.mark.parametrize("cmd", list(JAX_COMMANDS))
def test_every_command_help_exits_0(cmd, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", list(sys.argv))
    with pytest.raises(SystemExit) as e:
        launcher.main([cmd, "--help"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    module = launcher._COMMANDS[cmd][0]
    assert out.startswith(f"usage: {module}.py")
    if cmd not in ("real-data", "profile-kernels"):
        assert "--device" in out            # runs on the card by default


def test_large_lattice_names_the_parallelism_item(monkeypatch, tmp_path):
    """``large-lattice --n-devices 2`` and ``--grid`` split the lattice
    axis over devices the host must have: the CPU is one device, and the
    port fakes none, so both raise ``ValueError`` naming the counts
    before anything is written (the sharded halves on repeated devices:
    ``tests/test_torch_spatial.py``)."""
    monkeypatch.setattr(sys, "argv", list(sys.argv))
    for extra in (["--n-devices", "2"], ["--grid"]):
        with pytest.raises(ValueError, match="n_devices=2 but this host "
                                             "has 1 cpu device"):
            launcher.main(["large-lattice", "--small", "--device", "cpu",
                           "--outdir", str(tmp_path), *extra])
    assert not (tmp_path / "wall_time.json").exists()


def _jax_flags(module: str) -> list:
    """The ``--flags`` a JAX driver's parser declares, read as text."""
    text = (REPO / "experiments" / f"{module}.py").read_text()
    return re.findall(r'add_argument\(\s*"(--[\w-]+)"', text)


@pytest.mark.parametrize("cmd", list(JAX_COMMANDS))
def test_every_jax_flag_is_a_port_flag(cmd, monkeypatch, capsys):
    """C5: each flag of the JAX driver (``--engine``, ``--n-devices``,
    ``--grid``, ``--quick`` included) is in the port driver's ``--help``,
    so a JAX command line parses under ``python -m hydrolim_tpu_torch``."""
    flags = _jax_flags(JAX_COMMANDS[cmd][0])
    monkeypatch.setattr(sys, "argv", list(sys.argv))
    with pytest.raises(SystemExit):
        launcher.main([cmd, "--help"])
    out = capsys.readouterr().out
    missing = [f for f in flags if not re.search(re.escape(f) + r"\b", out)]
    assert not missing, (cmd, missing)


def test_unknown_command_returns_2(capsys):
    assert launcher.main(["no-such-command"]) == 2
    assert "unknown command" in capsys.readouterr().err
    assert launcher.main([]) == 0

"""The port's launcher, ``python -m hydrolim_tpu_torch <command>``, against
the JAX package's (``python -m hydrolim_tpu``): the same command names in
the same order, every command's ``--help`` served by the port's driver
(exit 0), ``large-lattice`` refused naming its ROADMAP.md item, an
unknown command refused with 2.  The ``--help`` calls run in-process (the
drivers' imports are shared); the launcher's own ``--help`` runs as a
subprocess."""
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


@pytest.mark.parametrize("cmd", [c for c in JAX_COMMANDS
                                 if c != "large-lattice"])
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


def test_large_lattice_names_the_parallelism_item(capsys):
    assert launcher.main(["large-lattice", "--help"]) != 0
    assert "ROADMAP.md §A item 1, parallelism" in capsys.readouterr().err


def test_unknown_command_returns_2(capsys):
    assert launcher.main(["no-such-command"]) == 2
    assert "unknown command" in capsys.readouterr().err
    assert launcher.main([]) == 0

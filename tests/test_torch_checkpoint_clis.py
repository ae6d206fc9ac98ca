"""``--ckpt-dir`` on the port's CLIs at ``--small``, on the CPU: each CLI,
run through its ``__main__`` with ``--ckpt-dir``, writes its results and a
checkpoint directory vouched for by a manifest (one per replica chunk or
per σ where the driver keeps subdirectories); a second run on the same
directory resumes and prints the same results."""
import runpy
import sys

import pytest
import torch

CLIS = {
    "particle_beta_sweep": (["--engine", "fused"],
                            ["manifest.json"]),
    "particle_double_sweep": (["--engine", "pallas"], ["manifest.json"]),
    "particle_local_structure": (["--engine", "lattice_gas"],
                                 ["manifest.json"]),
    "particle_sigma_sweep": (["--engine", "fused"],
                             ["sigma_0/manifest.json",
                              "sigma_0.005/manifest.json",
                              "sigma_0.05/manifest.json"]),
    "pde_experiments": (["single"], ["manifest.json"]),
}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cli", list(CLIS))
def test_cli_ckpt_dir_at_small(cli, tmp_path, monkeypatch, capsys):
    args, manifests = CLIS[cli]
    ck = tmp_path / "ck"
    argv = [cli, *args, "--small", "--device", "cpu", "--outdir",
            str(tmp_path / "out"), "--ckpt-dir", str(ck)]
    monkeypatch.setattr(sys, "argv", argv)
    name = f"hydrolim_tpu_torch.experiments.{cli}"
    monkeypatch.delitem(sys.modules, name, raising=False)   # run it fresh
    printed = []
    for _ in range(2):                  # the second run resumes
        runpy.run_module(name, run_name="__main__")
        printed.append(capsys.readouterr().out)
    assert printed[0] == printed[1] and printed[0]
    assert sorted(p.relative_to(ck).as_posix()
                  for p in ck.rglob("manifest.json")) == sorted(manifests)
    assert list(ck.rglob("chunk_*.npz"))
    assert any((tmp_path / "out").iterdir())

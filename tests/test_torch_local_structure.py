"""The port's local-structure β-sweep on the CPU.

- ``sweep_betas_for_structures`` at the CLI's ``--small`` configuration
  (L=200, N=180, K=1, torus, σ=0.005, T=4, obs_dt=0.2, 4 β × 2 runs) on
  each engine (``'particle'``: the τ-leap step, ``'lattice_gas'``: the K=1
  slot engine, ``'pallas'``: B3's plain version): the JAX package's result
  schema, and for the out dicts it keeps, the port's structure observables
  equal to the JAX package's ``extract_structure_observables_from_out``.
- The observables' golden (``tests/test_aux.py:193``) on the port's copy.
- The npz round trip, across both packages.
- ``particle_local_structure --small --device cpu`` writes its npz and
  prints one line per β where matplotlib is not installed.
"""
import sys

import numpy as np
import pytest
import torch

from hydrolim_tpu_torch.observables.structure import (
    extract_structure_observables_from_out,
)
from hydrolim_tpu_torch.sweeps.local_structure import (
    DEFAULT_STRUCTURE_PS_KWARGS,
    load_structure_results,
    save_structure_results,
    sweep_betas_for_structures,
)

SMALL_PS = dict(L=200, N=180, periodic=True)
SMALL_RUN = dict(T=4.0, obs_dt=0.2)
BETAS = np.linspace(0, 3, 4)
SUMMARY_KEYS = {"var_mean", "var_se", "low_k_power_mean", "low_k_power_se",
                "dominant_k_mode", "m_local_var_mean", "m_local_var_se",
                "fft_mean_mean", "fft_mean_se", "lowk_var_mean",
                "lowk_var_se", "raw"}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def small_results():
    return {}


def _run(engine, cache):
    if engine not in cache:
        cache[engine] = sweep_betas_for_structures(
            BETAS, 2, ps_kwargs=SMALL_PS, run_kwargs=SMALL_RUN, seed=5,
            engine=engine, device="cpu")
    return cache[engine]


@pytest.mark.parametrize("engine", ["particle", "lattice_gas", "pallas"])
def test_structure_sweep_small_equals_jax_observables(engine,
                                                      small_results):
    """Every β holds the JAX package's summary keys, finite values and two
    kept out dicts of 20 frames; each kept out's structure observables,
    recomputed by the JAX package's extractor, equal the port's."""
    from hydrolim_tpu.observables.structure import (
        extract_structure_observables_from_out as j_extract,
    )

    res = _run(engine, small_results)
    assert sorted(res) == list(BETAS)
    for beta, r in res.items():
        assert set(r) == SUMMARY_KEYS, beta
        for k in SUMMARY_KEYS - {"raw"}:
            assert np.all(np.isfinite(r[k])), (beta, k)
        assert len(r["raw"]) == 2
        for run in r["raw"]:
            out = run["out"]
            assert out["fft_amp_list"].shape == (20, 200)
            want = j_extract(out, start_fraction=0.5)
            for k, v in want.items():
                np.testing.assert_array_equal(run[k], v, err_msg=k)
    # K=1: every site holds 0 or 1 of the N=180 particles in every frame
    tot = np.stack([run["out"]["total_list"] for r in res.values()
                    for run in r["raw"]])
    counts = tot * 180 / 200                       # ρ·N·dx
    np.testing.assert_allclose(counts.sum(-1), 180, rtol=1e-5)
    assert np.abs(counts - np.rint(counts)).max() < 1e-4
    assert counts.max() < 1.0 + 1e-4


def test_structure_observables_golden_on_the_copy():
    """``tests/test_aux.py:193``'s frozen values on the port's copy of the
    observables, and equality with the JAX package's on the same arrays
    (with and without ``k_max``)."""
    from hydrolim_tpu.observables.structure import (
        extract_structure_observables_from_out as j_extract,
    )

    rng = np.random.default_rng(42)
    T, L = 40, 64
    out = {"times_obs": np.linspace(0, 10, T), "var_list": rng.random(T),
           "fft_amp_list": rng.random((T, L)),
           "m_local_list": rng.random((T, L)),
           "total_list": rng.random((T, L))}
    obs = extract_structure_observables_from_out(out)
    np.testing.assert_allclose(obs["var_mean"], 0.4933626085926138,
                               rtol=1e-13)
    np.testing.assert_allclose(obs["low_k_power"], 11.740632802594671,
                               rtol=1e-13)
    assert obs["dominant_k"] == 51
    for k_max in (None, 8):
        got = extract_structure_observables_from_out(out, k_max=k_max)
        want = j_extract(out, k_max=k_max)
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_structure_npz_round_trip_across_packages(tmp_path, small_results):
    """The port's npz reloads to the same table, in the port and in the JAX
    package; an npz the JAX package saves reloads in the port."""
    from hydrolim_tpu.sweeps.local_structure import (
        load_structure_results as j_load,
    )
    from hydrolim_tpu.sweeps.local_structure import (
        save_structure_results as j_save,
    )

    res = _run("lattice_gas", small_results)
    save_structure_results(res, str(tmp_path / "p.npz"))
    for loaded in (load_structure_results(str(tmp_path / "p.npz")),
                   j_load(str(tmp_path / "p.npz"))):
        assert sorted(loaded) == sorted(res)
        for b in res:
            assert set(loaded[b]) == SUMMARY_KEYS - {"raw"}
            for k in SUMMARY_KEYS - {"raw"}:
                np.testing.assert_array_equal(loaded[b][k], res[b][k])
    j_save(res, str(tmp_path / "j.npz"))
    again = load_structure_results(str(tmp_path / "j.npz"))
    for b in res:
        np.testing.assert_array_equal(again[b]["fft_mean_mean"],
                                      res[b]["fft_mean_mean"])


def test_structure_defaults_and_engines_are_the_jax_packages():
    """The reference configuration is the JAX package's, and an unknown
    engine is refused."""
    from hydrolim_tpu.sweeps import local_structure as j_ls

    assert DEFAULT_STRUCTURE_PS_KWARGS == j_ls.DEFAULT_STRUCTURE_PS_KWARGS
    from hydrolim_tpu_torch.sweeps import local_structure as p_ls

    assert p_ls.DEFAULT_STRUCTURE_RUN_KWARGS == \
        j_ls.DEFAULT_STRUCTURE_RUN_KWARGS
    with pytest.raises(ValueError, match="unknown engine"):
        sweep_betas_for_structures([1.0], 1, engine="fused", device="cpu")


def test_local_structure_cli_writes_its_npz_without_matplotlib(
        tmp_path, monkeypatch, capsys):
    """``particle_local_structure --small --device cpu`` (the τ-leap
    step) on a host without matplotlib: the npz is written and reloads
    with four β, one line is printed per β, and no figure is drawn."""
    from hydrolim_tpu_torch.experiments import particle_local_structure

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "matplotlib.pyplot", None)
    particle_local_structure.main(small=True, outdir=str(tmp_path),
                                  device="cpu")
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("beta=")]
    assert len(lines) == 4
    loaded = load_structure_results(str(tmp_path / particle_local_structure
                                        .NPZ))
    assert sorted(loaded) == list(BETAS)
    assert not list(tmp_path.glob("*.png"))
    again = particle_local_structure.main(small=True, outdir=str(tmp_path),
                                          run=False, device="cpu")
    assert sorted(again) == list(BETAS)

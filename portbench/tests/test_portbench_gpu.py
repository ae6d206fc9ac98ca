"""On the card: each cell at its tiny size through the kernels, checked
against the reference on the kernels' own Philox streams (B1's replicas
bit for bit), the control failing there too, and the faults of
``test_portbench_faults.py`` caught by the check the card runs.  Run on a
machine with a card:
python -m pytest -m gpu portbench/tests/test_portbench_gpu.py"""

import numpy as np
import pytest
import torch

from portbench_tiny import FAULTS, SHRINK, plant, tiny_run

SEED = 987654321012


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(SHRINK))
def test_tiny_cell_on_the_card(cuda, name):
    r = tiny_run(name, SEED, device=cuda)
    assert r["device"]["platform"] == "gpu"
    assert r["correct"] is True, r["checks"]


@pytest.mark.gpu
def test_b1_every_replica_bit_for_bit(cuda):
    """All of a tiny sweep's replicas followed through every frame on the
    kernel's stream."""
    from portbench import harness
    from portbench.spans import Spans

    d = harness.make_runner(harness.cell("xeng.particle"), cuda, Spans(),
                            False, dict(SHRINK["xeng.particle"],
                                        check_replicas=6))
    d.unit(31, keep=True)
    out = d.check()
    assert out["b1_elements_differing"] == 0.0


def _seed_whole_replica_kept(name):
    """A run seed whose kept sweep follows, through all its frames, a
    replica of the half that the 'half' fault steps: only the other
    replicas' first frames can see that fault."""
    from portbench import harness
    from portbench.runners.base import unit_seed

    c = harness.cell(name)
    cfg = dict(c["config_data"], **SHRINK[name])
    B = cfg["betas"]["num"] * cfg["n_runs"]
    for seed in range(SEED, SEED + 100):
        rng = np.random.default_rng([unit_seed(seed, 0), 7])
        drawn = rng.choice(B, size=cfg["check_replicas"], replace=False)
        if (drawn < B // 2).all():
            return seed
    raise AssertionError("no such seed")


@pytest.mark.gpu
@pytest.mark.parametrize("kind", FAULTS)
@pytest.mark.parametrize("name", sorted(SHRINK))
def test_a_broken_timed_path_is_not_correct_on_the_card(cuda, name, kind,
                                                       monkeypatch):
    seed = (_seed_whole_replica_kept(name) if name == "xeng.particle"
            else SEED)
    plant(monkeypatch, name, kind)
    r = tiny_run(name, seed, device=cuda)
    assert r["failed"] == 0
    assert r["correct"] is False, r["checks"]


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(SHRINK))
def test_tiny_control_fails_on_the_card(cuda, name):
    from portbench import harness
    from portbench.control import readings

    limits = harness.cell(name)["limits"]
    _, control = readings(name, [], [13], "bfloat16", device="cuda",
                          shrink=SHRINK[name])
    assert [k for k, v in control[0].items() if v > limits[k]]


def test_the_seed_search_finds_a_kept_half():
    assert _seed_whole_replica_kept("xeng.particle") >= SEED

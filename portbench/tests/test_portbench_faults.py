"""The check catches a broken timed path: each cell run at its tiny size
on the CPU with a fault planted under the program's entry, and ``correct``
comes out false.  The faults: a step that returns its state unchanged,
half of the batch left out, and an answer altered where it is produced.
(The cells run on one card, so no exchange between cards can be left
out.)  ``test_portbench_gpu.py`` plants the same faults on the card, where
the check follows the kernels' own streams."""
import pytest

from portbench_tiny import FAULTS, SHRINK, plant, tiny_run


@pytest.mark.parametrize("kind", FAULTS)
@pytest.mark.parametrize("name", sorted(SHRINK))
def test_a_broken_timed_path_is_not_correct(name, kind, monkeypatch):
    plant(monkeypatch, name, kind)
    r = tiny_run(name)
    assert r["failed"] == 0
    assert r["correct"] is False, r["checks"]

"""The control, the reference in bfloat16 put in the program's place, at
each cell's tiny size on the CPU: it fails the cell's limits, where the
program's plain version passes them."""
import pytest

from portbench_tiny import SHRINK


@pytest.mark.parametrize("name", sorted(SHRINK))
def test_the_control_fails_the_limits(name):
    from portbench import harness
    from portbench.control import readings

    limits = harness.cell(name)["limits"]
    sound, control = readings(name, [11], [12], "bfloat16", device="cpu",
                              shrink=SHRINK[name])
    assert all(v <= limits[k] for k, v in sound[0].items())
    failed = [k for k, v in control[0].items() if v > limits[k]]
    assert failed, control[0]

"""Each cell at a tiny size on the CPU: the program agrees with the plain
reference; the reference one precision lower, put in the program's place,
fails the comparison; and each fault planted underneath the timed path
makes ``correct`` come out false."""
import pytest

from portbench import harness
from portbench.lib import faults
from portbench.tests.sizes import TINY

CELLS = sorted(TINY)
# each fault that the cell's workload file says the cell can have
CASES = [(c, f) for c in CELLS for f in harness.load_json(
    harness.HERE / "workloads" / f"{c}.json")["faults"]]


def _run(cell, quiet, **kw):
    return harness.run(cell, 2 ** 32 + 17, 0.3, False, "cpu",
                       overrides=TINY[cell], log=quiet, **kw)


@pytest.mark.parametrize("cell", CELLS)
def test_program_agrees_with_the_reference(cell, quiet):
    out = _run(cell, quiet, control=True)
    assert out["correct"], out["checks"]
    # the control: the reference one precision lower fails a number
    assert any(v["value"] > v["limit"] for v in out["control"].values()), \
        out["control"]


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_underneath_is_caught(cell, fault, quiet):
    out = _run(cell, quiet, breaker=faults.FAULTS[fault]())
    assert not out["correct"], out["checks"]
    assert out["failed"] >= 1

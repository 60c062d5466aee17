"""Each cell at a tiny size on the card: the kernels' paths agree with the
plain reference (run with ``python -m pytest portbench -m card`` there)."""
import pytest

from portbench import harness
from portbench.tests.sizes import TINY


@pytest.mark.card
@pytest.mark.parametrize("cell", sorted(TINY))
def test_cell_on_the_card(cell, card, quiet):
    out = harness.run(cell, 2 ** 31 + 3, 0.5, False, card,
                      overrides=TINY[cell], log=quiet)
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu"

"""The float32 reference against storygen_tpu_torch on the CPU at tiny
widths, through a whole run of each cell: both sides compute in float32
there, so they agree to rounding."""
import pytest

from benchmark.tests.runs import CELLS, cpu_run


@pytest.mark.parametrize("cell", CELLS)
def test_the_reference_agrees_with_the_port(cell):
    line = cpu_run(cell).run()
    assert line["failed"] == 0 and line["attempted"] > 0
    for name, c in line["checks"].items():
        assert c["value"] < 1e-3, (name, c["value"])

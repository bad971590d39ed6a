"""On the card, at the cells' own sizes: the control (the reference in
float8 put in the program's place) fails the cell's limits, and a sound
run passes them. `python3 -m pytest benchmark/tests -m card` (minutes a
cell)."""
import pytest

from benchmark.core import Bench
from benchmark.reference.numerics import Numerics
from benchmark.run import Run

CELLS = [w["name"] for w in Bench().spec["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_and_the_program_passes(cell, card):
    run = Run(Bench(), cell, 2 ** 32 + 17, 0.0, False, card)
    line = run.run()
    assert line["correct"] is True, line["checks"]
    limits = run.bench.limits(cell)
    read = run.kind.readings(Numerics("fp8"))["control"]
    assert any(v > limits[n] for n, v in read.items()), read

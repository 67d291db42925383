"""The control of the comparison, on the card at a test's size: the
program with its own TF32 path switched on comes out not correct, on the
number of each cell that the control fails at the cell's own size
(``port_bench/proofs/<cell>.json``; the readings are in PERF.md,
section 6)."""

import time

import pytest

from port_bench import harness
from port_bench.faults import proofs
from port_bench.tests.conftest import CELLS


def run(tiny, cell, control):
    return harness.run_cell(cell, 2 ** 31 + 7, 0.3, 0,
                            t_start=time.perf_counter(), root=tiny,
                            files=tiny, device="cuda", control=control)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(card, tiny, cell):
    number = proofs(cell)["control"]
    _, _, sound, _ = run(tiny, cell, False)
    result, _, numbers, _ = run(tiny, cell, True)
    limit = result["checks"][number]["limit"]
    assert result["correct"] is False, (numbers, sound)
    assert numbers[number] > limit
    assert numbers[number] > 3 * sound[number]

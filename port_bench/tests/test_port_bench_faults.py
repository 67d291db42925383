"""The comparison catches a broken timed path: each cell runs at a CPU
test's size with the look for a card skipped, the program broken
underneath, and ``correct`` comes out false, with the number meant to
catch the fault over its limit and well above the sound run's reading.

Each cell's faults are listed in ``port_bench/proofs/<cell>.json``
(see :mod:`port_bench.faults`); a cell on one card has no exchange
between cards to leave out.
"""

import time

import pytest

from port_bench import harness
from port_bench.faults import hook, proofs
from port_bench.tests.conftest import CELLS

FAULTS = [(cell, name, spec) for cell in CELLS
          for name, spec in proofs(cell)["faults"].items()]


def run(tiny, cell, hook=None):
    return harness.run_cell(cell, 5, 0.3, 0, t_start=time.perf_counter(),
                            root=tiny, files=tiny, device="cpu",
                            require_card=False, entry_hook=hook)


@pytest.mark.parametrize("cell,fault,spec", FAULTS,
                         ids=["%s-%s" % f[:2] for f in FAULTS])
def test_fault_is_not_correct(tiny, cell, fault, spec):
    number = spec["catches"]
    _, _, sound, _ = run(tiny, cell)
    result, _, numbers, _ = run(tiny, cell, hook(spec))
    limit = result["checks"][number]["limit"]
    assert result["correct"] is False
    assert numbers[number] > limit
    assert numbers[number] > 10 * max(sound[number], 0.0)


def test_every_cell_has_faults_and_a_control():
    for cell in CELLS:
        p = proofs(cell)
        limits = harness.load_json(harness.HERE / "limits"
                                   / (cell + ".json"))
        assert p["control"] in limits
        assert p["faults"]
        for spec in p["faults"].values():
            assert spec["catches"] in limits
            assert spec["at"] in ("calls", "setup")

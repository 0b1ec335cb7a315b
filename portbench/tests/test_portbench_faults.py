"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card is skipped (the CPU, tiny sizes), the rest of
the run is driven as it is on the card, with the cell's own limits."""

from __future__ import annotations

import pytest

from portbench import calibrate, run
from portbench.tests.tiny import tiny_cell

FAULTS = [
    ("ml25m-sgd-sigmoid", "unchanged"),
    ("ml25m-sgd-sigmoid", "half"),
    ("ml25m-als-linear", "unchanged"),
    ("ml25m-als-linear", "half"),
    ("recipenlg-search-b256", "altered"),
    ("recipenlg-search-b256", "half"),
    ("recipenlg-search-b1", "altered"),
]


@pytest.mark.parametrize("name,fault", FAULTS)
def test_a_broken_program_is_not_correct(manifest, name, fault):
    cell = tiny_cell(manifest, name)
    with calibrate.fault(cell.mix["driver"], fault):
        out, checks = run.run_cell(manifest, name, cell.seed, 0.2, False,
                                   device="cpu", cell=cell)
    assert out["correct"] is False, checks.lines()
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("name", ["ml25m-sgd-sigmoid", "recipenlg-search-b1"])
def test_a_sound_program_is_correct(manifest, name):
    cell = tiny_cell(manifest, name)
    out, checks = run.run_cell(manifest, name, cell.seed, 0.2, True, device="cpu",
                               cell=cell)
    assert out["correct"] is True, checks.lines()
    assert set(out) >= {"correct", "attempted", "failed", "metrics", "device"}
    assert out["device"]["platform"] == "cpu"

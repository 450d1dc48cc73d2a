"""The comparison fails what it must: the control (the reference in the
program's place at TF32) and the faults a search cell can have, each
planted under a whole run of the harness at a tiny size on the CPU
(the look for a card skipped); a sound run passes. A search has no
state to leave unchanged and these cells no exchange between chips,
so the faults are half of each batch left out and an answer altered
where it is produced."""

import time

import pytest

from portbench.harness import cell as cell_mod
from portbench.harness import faults
from portbench.harness.control import control_numbers
from portbench.harness.judge import verdict

CELLS = ["s192.exact", "s192.routed"]


def _run(cell, seed=11):
    _, checks, ok = cell_mod.run(cell, seed, 0.4, False, "cpu",
                                 time.perf_counter(), log=lambda m: None)
    return ok, checks


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(tiny_cell, name):
    ok, checks = _run(tiny_cell(name))
    assert ok, checks


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(tiny_cell, name):
    cell = tiny_cell(name)
    numbers = control_numbers(cell, 11, 6, "cpu")
    ok, checks = verdict(numbers, cell.limits)
    assert not ok
    assert checks["dist_gap"]["value"] > checks["dist_gap"]["limit"]


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("name", CELLS)
def test_a_planted_fault_is_not_correct(tiny_cell, name, fault):
    remove = faults.plant(fault)
    try:
        ok, checks = _run(tiny_cell(name))
    finally:
        remove()
    assert not ok, checks


@pytest.mark.parametrize("fault", faults.FAULTS)
def test_a_fault_in_the_references_answers_is_not_correct(tiny_cell, fault):
    cell = tiny_cell("s192.routed")
    ok, _ = verdict(control_numbers(cell, 12, 6, "cpu", precision="fp64"),
                    cell.limits)
    assert ok                          # the reference in its own place
    ok, _ = verdict(control_numbers(cell, 12, 6, "cpu", precision="fp64",
                                    fault=fault), cell.limits)
    assert not ok

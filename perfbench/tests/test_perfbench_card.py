"""The control on the card: the reference put in the program's place and
computed in float32 with TF32 on fails each cell's check, and the
program passes it, at the cell's own size on one seed.

On the card: ``python3 -m pytest perfbench/tests -q -m card`` (about a
minute a cell with the kernels' first build)."""
from __future__ import annotations

import pytest

from perfbench import calibrate, core

CELLS = [w["name"] for w in core.manifest()["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_and_the_program_passes(card, name):
    cell = core.find_cell(name)
    limit = cell.workload["check"]["limit"]
    r = calibrate.readings(cell, 2 ** 31 + 777, card)
    assert r["program"] <= limit < r["tf32"], r
    for fault in ("fault_altered", "fault_unchanged", "fault_half"):
        assert r.get(fault, float("inf")) > limit, (fault, r)

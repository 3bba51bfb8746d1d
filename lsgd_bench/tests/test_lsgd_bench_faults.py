"""Whole runs at a CPU size with the timed path broken underneath (the
look for a card skipped): each fault a cell can have turns ``correct``
false under the cell's own limits."""
import time

import pytest

from conftest import CELLS, small_files
from lsgd_bench import faults
from lsgd_bench import run as R


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_is_not_correct(cell, fault):
    res = R.run(small_files(cell), cell, 2 ** 31 + 5, 0.2, False, device="cpu",
                t_start=time.perf_counter(), tamper=faults.FAULTS[fault])
    assert not res["correct"], res["checks"]
    assert res["failed"] >= 1

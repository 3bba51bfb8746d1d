"""The numbers compared, on hand-made readings: the worst leaf and the
median leaf, each against the larger of its reference norm and the
median leaf's, leaves that move by round-off left out of the change,
and a limits file that names the numbers it compares."""
import math

import pytest

from lsgd_bench import check

REF = {"loss": [2.0, 1.0], "grad": {"a": [1.0, 2.0], "b": [4.0, 4.0], "c": [1e-9, 1e-9]},
       "change": {"a": [1.0, 1.0], "b": [2.0, 2.0], "c": [3.0, 3.0]}}


def test_numbers():
    prog = {"loss": [2.002, 1.0], "grad": {"a": [1.0, 2.1], "b": [4.0, 4.0], "c": [0.0, 0.0]},
            "change": {"a": [1.0, 1.0], "b": [2.0, 2.0], "c": [0.0, 0.0]}}
    n = check.numbers(prog, REF)
    assert n["loss_gap"] == pytest.approx(1e-3) and n["loss1_gap"] == pytest.approx(1e-3)
    # the median leaf's gradient norm is worker 0's 1.0, worker 1's 2.0
    assert n["grad_gap"] == pytest.approx(0.1 / 2.0)
    # worker 1's leaves read 0.05, 0 and 1e-9 / 2: the median is the last
    assert n["grad_gap_median"] == pytest.approx(1e-9 / 2.0)
    # "c" moves by round-off alone, so its change is left out
    assert check.moving(REF["grad"]) == {"a", "b"}
    assert n["change_gap"] == 0.0 and n["change_gap_median"] == 0.0


def test_judge_compares_only_the_named_numbers():
    nums = dict.fromkeys(check.NUMBERS, 1.0)
    nums["grad_gap"] = 0.5
    assert check.judge(nums, {"grad_gap": 0.6}) == (True, 0)
    assert check.judge(nums, {"grad_gap": 0.6, "loss_gap": 0.9}) == (False, 1)
    assert check.judge(dict(nums, grad_gap=math.nan), {"grad_gap": 0.6}) == (False, 1)
    with pytest.raises(ValueError):
        check.compared({"readings": {}})

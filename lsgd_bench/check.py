"""The comparison that decides ``correct``: the program's readings of its
first steps against the reference's, as numbers, each against the
cell's limit (``limits/<cell>.json`` names the numbers a cell compares).

- ``loss_gap``: the largest |loss - reference| / |reference| over the
  checked steps (each step's loss the mean over the workers);
  ``loss1_gap`` the same of the first step alone.
- ``grad_gap``: the first step's gradient after the clip, as the
  optimizer got it, by the worst leaf and worker: |norm - reference
  norm| over the larger of the reference's norm of that leaf and of the
  median leaf.  ``grad_gap_median``: the median leaf's gap, by the worst
  worker.
- ``change_gap`` / ``change_gap_median``: the same of each worker's
  model minus the starting weights, after the checked steps and their
  sync; leaves whose reference gradient is under a thousandth of the
  median leaf's (moved by round-off alone) are left out.
"""
from __future__ import annotations

import math

import numpy as np

NUMBERS = ("loss_gap", "loss1_gap", "grad_gap", "grad_gap_median",
           "change_gap", "change_gap_median")
# a leaf moves by round-off alone when its first gradient is under this
# share of the median leaf's
STILL = 1e-3


def _np(d: dict) -> dict:
    return {k: np.asarray([float(x) for x in v], dtype=np.float64)
            for k, v in d.items()}


def leaf_gaps(prog: dict, ref: dict, keep=None) -> dict:
    """name -> (W,) |prog - ref| / max(ref, median leaf of ref), for the
    leaves in ``keep`` (all when None); dicts of name -> (W,) norms."""
    prog, ref = _np(prog), _np(ref)
    med = np.median(np.stack([ref[n] for n in ref]), axis=0)
    return {n: np.abs(prog[n] - ref[n]) / np.maximum(ref[n], med)
            for n in ref if keep is None or n in keep}


def _worst(gaps: dict) -> float:
    return float(np.max(np.stack(list(gaps.values()))))


def _median(gaps: dict) -> float:
    return float(np.max(np.median(np.stack(list(gaps.values())), axis=0)))


def worst_leaf(prog: dict, ref: dict) -> str:
    gaps = leaf_gaps(prog, ref)
    return max(gaps, key=lambda n: float(np.max(gaps[n])))


def moving(ref_grad: dict) -> set:
    """Leaves whose reference gradient is at least STILL x the median
    leaf's, for every worker."""
    g = _np(ref_grad)
    med = np.median(np.stack(list(g.values())), axis=0)
    return {n for n, v in g.items() if np.all(v >= STILL * med)}


def numbers(prog: dict, ref: dict) -> dict:
    """Every number from two readings (``loss``, ``grad``, ``change``, as
    ``reference.train.follow`` returns them)."""
    lp = np.asarray([float(x) for x in prog["loss"]])
    lr = np.asarray([float(x) for x in ref["loss"]])
    loss = np.abs(lp - lr) / np.abs(lr)
    grad = leaf_gaps(prog["grad"], ref["grad"])
    change = leaf_gaps(prog["change"], ref["change"], keep=moving(ref["grad"]))
    return {"loss_gap": float(np.max(loss)), "loss1_gap": float(loss[0]),
            "grad_gap": _worst(grad), "grad_gap_median": _median(grad),
            "change_gap": _worst(change), "change_gap_median": _median(change)}


def compared(limits: dict) -> list:
    """The numbers a cell's limits file compares, in NUMBERS' order."""
    names = [k for k in NUMBERS if k in limits]
    if not names:
        raise ValueError(f"the limits {sorted(limits)} compare no number")
    return names


def judge(nums: dict, limits: dict) -> tuple[bool, int]:
    """(correct, numbers beyond their limit): a number that is not finite
    is beyond it."""
    failed = sum(1 for k in compared(limits)
                 if not (math.isfinite(nums[k]) and nums[k] <= limits[k]))
    return failed == 0, failed

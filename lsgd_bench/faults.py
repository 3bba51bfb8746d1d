"""Faults planted in the timed path, each a ``tamper(bundle)`` for
``run.setup``: the comparison has to come out false under every one
that a cell can have (``tests/test_lsgd_bench_faults.py``, and their
readings at the cell's size by ``calibrate.py``)."""
from __future__ import annotations


def state_unchanged(bundle):
    """Every local step computes its loss and hands the state back as it
    got it."""
    step = bundle.local_step

    def tampered(state, batch):
        keep = [b.clone() for s in (state.params, state.momentum)
                for b in s.buckets]
        _, metrics = step(state, batch)
        for b, k in zip([b for s in (state.params, state.momentum)
                         for b in s.buckets], keep):
            b.copy_(k)
        return state, metrics

    bundle.local_step = tampered


def half_batch(bundle):
    """Each worker's step sees the first half of its batch only: the loss
    and the gradient are the mean over the rest."""
    step = bundle.local_step

    def tampered(state, batch):
        return step(state, {k: v[:, :v.shape[1] // 2] for k, v in batch.items()})

    bundle.local_step = tampered


def no_exchange(bundle):
    """The global sync returns the state without exchanging anything."""
    bundle.sync = lambda state, **kw: state


FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch,
          "no_exchange": no_exchange}

"""Backend seam: who the workers are, owned as a first-class object (the
port of ``repro.backend.base``).

Everything above this module (``fit``, the controllers, the SyncPlan)
talks about "the worker set" through two objects:

* :class:`WorkerSet` — an immutable census of the live workers: stable
  integer ids, who is demoted to the outer hierarchical scope, and how
  the set maps onto the stacked worker axis.  A resize returns a NEW set
  (shrink keeps the first ids, grow appends fresh ones), so a bundle, a
  plan or a ledger row can hold the exact set it was built for.
* :class:`Backend` — the execution substrate that owns a WorkerSet and
  (re)builds a :class:`~repro_torch.launch.steps.TrainBundle` for it.
  Concrete backends: ``local`` (the W workers stacked on one device, the
  default), ``simulated`` (local execution plus an injected per-worker
  latency, so the straggler telemetry has real values on one card) and
  ``distributed`` (``torch.distributed``: the workers over processes,
  one or more a rank, or split over shard ranks).

The seam is thin: a Backend does not wrap the train loop, it answers
"build me a bundle for THIS worker set" and "what did each worker's step
time look like this round".  Resizes and straggler demotion are plan
decisions (``PlanDelta.workers`` / ``demote`` / ``promote``) that ``fit``
actuates through these calls.
"""
from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class WorkerSet:
    """Immutable census of the live workers.

    ``ids`` are stable across resizes: the position in the tuple IS the
    row in the stacked worker axis, so ``ids[i]`` names the worker whose
    state lives at ``state.params.buckets[b][i]``.  ``demoted`` workers
    still hold a row (they keep training and syncing) but are scheduled
    on the outer hierarchical scope: the inner ring no longer waits on
    them every round.
    """
    ids: tuple
    demoted: tuple = ()

    @classmethod
    def of(cls, num_workers: int) -> "WorkerSet":
        return cls(ids=tuple(range(int(num_workers))))

    @property
    def num_workers(self) -> int:
        return len(self.ids)

    @property
    def active(self) -> tuple:
        """Workers on the inner (fast) scope: ids minus demoted."""
        return tuple(i for i in self.ids if i not in self.demoted)

    def resize(self, new_w: int) -> "WorkerSet":
        """Shrink keeps the first ``new_w`` ids (matching the
        consecutive-group fold of :mod:`repro_torch.core.elastic`); grow
        appends fresh ids past the current maximum.  Demotions carry over
        for surviving ids only."""
        new_w = int(new_w)
        if new_w <= 0:
            raise ValueError(f"worker set must be non-empty, got {new_w}")
        if new_w <= len(self.ids):
            ids = self.ids[:new_w]
        else:
            nxt = max(self.ids) + 1 if self.ids else 0
            ids = self.ids + tuple(range(nxt, nxt + new_w - len(self.ids)))
        return WorkerSet(ids=ids,
                         demoted=tuple(d for d in self.demoted if d in ids))

    def demote(self, worker_id: int) -> "WorkerSet":
        if worker_id not in self.ids:
            raise ValueError(f"unknown worker id {worker_id} (ids={self.ids})")
        if worker_id in self.demoted:
            return self
        return replace(self, demoted=self.demoted + (worker_id,))

    def promote(self, worker_id: int) -> "WorkerSet":
        """Return a demoted worker to the inner (fast) scope: the inverse
        of :meth:`demote`, for a straggler that recovered."""
        if worker_id not in self.ids:
            raise ValueError(f"unknown worker id {worker_id} (ids={self.ids})")
        if worker_id not in self.demoted:
            return self
        return replace(self, demoted=tuple(d for d in self.demoted
                                           if d != worker_id))

    def row_of(self, worker_id: int) -> int:
        """Stacked-axis row of a worker id."""
        return self.ids.index(worker_id)


class Backend:
    """Execution-substrate interface (see the module docstring).

    Subclasses set :attr:`kind` and implement :meth:`build`; the base
    class carries the WorkerSet bookkeeping, so resize / demote semantics
    are the same on every backend.
    """

    kind: str = "base"

    def __init__(self, num_workers: int | None = None):
        self._worker_set = (WorkerSet.of(num_workers)
                            if num_workers is not None else None)

    # -- worker census ----------------------------------------------------
    @property
    def worker_set(self) -> WorkerSet | None:
        return self._worker_set

    @property
    def num_workers(self) -> int | None:
        ws = self._worker_set
        return ws.num_workers if ws is not None else None

    def _census(self) -> WorkerSet:
        if self._worker_set is None:
            raise RuntimeError("backend has no worker set yet (call build)")
        return self._worker_set

    def demote(self, worker_id: int) -> WorkerSet:
        self._worker_set = self._census().demote(worker_id)
        return self._worker_set

    def promote(self, worker_id: int) -> WorkerSet:
        self._worker_set = self._census().promote(worker_id)
        return self._worker_set

    # -- bundle construction ----------------------------------------------
    def build(self, run, **kw):
        """Build a TrainBundle for the current worker set."""
        raise NotImplementedError

    def check_resize(self, new_w: int) -> None:
        """Raise ``ValueError`` when this backend cannot take ``new_w``
        workers; called before any state changes (every width the census
        and the fold accept, here)."""

    def resize(self, run, new_w: int, **kw):
        """Adopt a new worker-set width and rebuild the bundle.  The state
        surgery (``elastic.resize_state``) is the caller's: the backend
        only rebuilds local_step / sync / SyncPlan for the new W."""
        self._worker_set = self._census().resize(new_w)
        return self.build(run, **kw)

    # -- telemetry ---------------------------------------------------------
    def worker_step_times(self, *, h: int = 1,
                          measured_s: float | None = None):
        """Per-worker wall seconds of the last round's local phase, in
        stacked-axis order, or ``None`` when the workers run in lockstep
        (one device, one clock: skew cannot be observed, the gauge reads
        nothing)."""
        return None

    def worker_times_by_id(self, *, h: int = 1,
                           measured_s: float | None = None):
        """Per-worker wall seconds keyed by worker id, for ALL workers,
        demoted ones included: the sensor of the elastic policy's
        promotion-back path (:meth:`worker_step_times` covers the active
        set only).  ``None`` when the backend cannot attribute per-worker
        time."""
        return None

    def describe(self) -> dict:
        ws = self._worker_set
        return {"kind": self.kind,
                "num_workers": ws.num_workers if ws else None,
                "worker_ids": list(ws.ids) if ws else None,
                "demoted": list(ws.demoted) if ws else None}

"""Simulated heterogeneous backend: local execution plus injected latency.

Numerically the same as :class:`~repro_torch.backend.local.LocalBackend`
(same build path, same trajectories); what it adds is a per-worker
wall-clock MODEL, so the straggler telemetry has real values on one card.
``worker_step_times`` reports, for each active worker in stacked-axis
order,

    t_i = h * (base_step_s + latency_s.get(id_i, 0.0))

so the ``worker_step_skew`` gauge ((max - min) / mean over the ACTIVE
set) is nonzero exactly when the latency map is, and drops back to 0
once the controller demotes the slow worker (demoted workers leave the
inner scope and stop counting toward the skew the inner ring sees).
``round_seconds`` prices a round under the current census the same way:
the inner scope waits on the slowest active worker, the global scope on
the slowest worker overall.  These are the model's seconds, not the
card's.
"""
from __future__ import annotations

from repro_torch.backend.local import LocalBackend


class SimulatedBackend(LocalBackend):
    kind = "simulated"

    def __init__(self, num_workers: int | None = None, *,
                 latency_s: dict | None = None, base_step_s: float = 0.01,
                 **kw):
        super().__init__(num_workers, **kw)
        self.latency_s = dict(latency_s or {})
        self.base_step_s = float(base_step_s)

    def _time_of(self, worker_id: int, h: int) -> float:
        return h * (self.base_step_s + self.latency_s.get(worker_id, 0.0))

    def worker_step_times(self, *, h: int = 1,
                          measured_s: float | None = None):
        """Simulated seconds of one local phase of ``h`` steps per ACTIVE
        worker, in stacked-axis order: demoted workers run on the outer
        scope and no longer gate the inner ring."""
        ws = self._worker_set
        if ws is None:
            return None
        return [self._time_of(i, h) for i in (ws.active or ws.ids)]

    def worker_times_by_id(self, *, h: int = 1,
                           measured_s: float | None = None):
        """Every worker's simulated seconds keyed by id, demoted workers
        included, so the elastic policy can see a straggler recover
        (``latency_s`` cleared mid-run) and promote it back."""
        ws = self._worker_set
        if ws is None:
            return None
        return {int(i): self._time_of(i, h) for i in ws.ids}

    def round_seconds(self, *, h: int = 1, scope: str = "global") -> float:
        """Seconds one sync round waits on the local phase: the slowest
        active worker for the block scope, the slowest worker overall for
        the global scope (demoted workers still sync there)."""
        ws = self._worker_set
        if ws is None:
            return 0.0
        ids = ws.ids if scope == "global" else (ws.active or ws.ids)
        return max(self._time_of(i, h) for i in ids)

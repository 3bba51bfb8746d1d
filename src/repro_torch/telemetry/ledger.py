"""Host-side comms ledger: bytes and collectives per sync round (the port
of ``repro.telemetry.ledger``).

:func:`analytic_sync_cost` applies the ring formulas to the flat-bus
bucket layout: one all-reduce per dense bucket, or one uint8 payload
gather plus one scale gather per wire-packed bucket.  When the W workers
live on one card nothing crosses a wire: the bytes are the ring model's,
as if each worker had its own device, and the rows'
``cost_source`` is ``"analytic"``.  Across processes
(``backend.DistributedBackend``) ``fit`` also hands ``record_plan`` the
bytes all ranks handed to each stage's collectives, counted by
``backend.collectives.Collectives``: those rows carry
``cost_source: "measured"`` and ``measured_bytes`` beside the ring
model's ``bytes_on_wire`` (the reference's ``hlo_sync_cost`` parses XLA
HLO instead).  Seconds come from the tracer: ``fit`` passes each traced
sync's span duration to ``record_plan(seconds=)``.

:class:`CommsLedger` accumulates one row per collective stage of each
sync round (:meth:`CommsLedger.record_plan`) or one per round
(:meth:`CommsLedger.record`); ``launch.train.fit`` records every block
and global sync and returns :meth:`CommsLedger.summary`.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.flatbuf import LANE
from repro_torch.roofline.hlo import _ring_bytes


@dataclass(frozen=True)
class SyncCost:
    """Per-device cost of ONE sync round."""
    bytes_on_wire: float
    collectives: int
    source: str = "analytic"


def analytic_sync_cost(layout, *, group: int, modes=None,
                       wire_pack: bool = False) -> SyncCost:
    """Ring-cost model of one sync over a flat-bus bucket layout.

    ``layout`` is the per-worker ``flatbuf.FlatLayout`` of the synced
    state; ``group`` the number of workers averaged together; ``modes``
    an optional per-bucket compression tuple (``None``: all dense).  Per
    bucket: dense mean = one all-reduce of the bucket bytes; compressed
    with ``wire_pack`` = one uint8 payload all-gather (1 bit an element)
    plus one f32 scale all-gather (one scale per leaf); compressed
    without it moves the dense f32 sign * scale payload in one
    all-reduce.  ``SyncPlan`` stages price the same (tested to agree).
    """
    n = max(int(group), 1)
    if modes is None:
        modes = ("none",) * layout.num_buckets
    if isinstance(modes, str):
        modes = (modes,) * layout.num_buckets
    total = 0.0
    count = 0
    for b in range(layout.num_buckets):
        rows = layout.bucket_local_rows(b)
        if modes[b] != "none" and wire_pack:
            payload = n * rows * (LANE // 8)                 # uint8 gather
            scales = n * len(layout.bucket_slots(b)) * 4     # f32 gather
            total += _ring_bytes("all-gather", payload, n)
            total += _ring_bytes("all-gather", scales, n)
            count += 2
        else:
            itemsize = (4 if modes[b] != "none"
                        else np.dtype(layout.bucket_dtypes[b]).itemsize)
            total += _ring_bytes("all-reduce", rows * LANE * itemsize, n)
            count += 1
    return SyncCost(bytes_on_wire=total, collectives=count, source="analytic")


def _group_rounds(entries, key) -> dict:
    """Rounds, wire bytes and collectives of ``entries`` grouped by
    ``key(entry)``."""
    out: dict = {}
    for e in entries:
        d = out.setdefault(key(e), {"rounds": set(), "wire_bytes": 0.0,
                                    "collectives": 0})
        d["rounds"].add((e["step"], e["level"]))
        d["wire_bytes"] += e["bytes_on_wire"]
        d["collectives"] += e["collectives"]
    return {k: {"rounds": len(v["rounds"]),
                "wire_bytes": float(v["wire_bytes"]),
                "collectives": int(v["collectives"]),
                "bytes_per_round": float(v["wire_bytes"])
                / max(len(v["rounds"]), 1)}
            for k, v in out.items()}


@dataclass
class CommsLedger:
    """Cost rows per sync round (host-side, plain floats).

    :meth:`record` appends one row per ROUND; :meth:`record_plan` one row
    per COLLECTIVE STAGE of a :class:`~repro_torch.core.syncplan.SyncPlan`
    scope, carrying the stage's buckets, compressor and topology, so the
    Alg. 5 per-stage trade-off reads straight off the rows.  A "round" is
    a distinct (step, level) pair.
    """
    entries: list = field(default_factory=list)

    def record(self, *, step: int, level: int, h: int, cost: SyncCost,
               compression="none", batch_scale: int = 1,
               lr_scale: float = 1.0) -> dict:
        e = {"step": int(step), "level": int(level), "h": int(h),
             "bytes_on_wire": float(cost.bytes_on_wire),
             "collectives": int(cost.collectives),
             "cost_source": cost.source,
             "compression": (list(compression)
                             if isinstance(compression, (tuple, list))
                             else str(compression)),
             "batch_scale": int(batch_scale),
             "lr_scale": float(lr_scale)}
        self.entries.append(e)
        return e

    def record_plan(self, *, step: int, level: int, h: int, plan,
                    scope: str = "global", batch_scale: int = 1,
                    lr_scale: float = 1.0, seconds: float | None = None,
                    num_workers: int | None = None,
                    measured_bytes=None) -> dict:
        """Append one row per collective stage of ``plan.schedule(scope)``;
        returns the round totals (a ``record``-shaped dict).

        ``seconds`` is the round's measured sync wall time (the tracer's
        ``sync`` span): it is spread over the stage rows as ``stage_s`` by
        the stages' wire-byte weights, as ``trace.sync_stage_spans`` spreads
        it over the ``collective`` spans, and the totals carry it as
        ``sync_s``.  ``num_workers`` stamps the rows with the worker-set
        width the round priced (default: the plan's).  ``measured_bytes``
        (one number a collective stage: the bytes all ranks handed to
        it) marks the rows ``"measured"``; the totals then carry
        ``measured_bytes`` too."""
        nw = int(num_workers if num_workers is not None else plan.num_workers)
        stages = plan.collective_stages(scope)
        est = sum(s.wire_bytes for s in stages)
        shares = ([s.wire_bytes / est for s in stages] if est > 0
                  else [1.0 / max(len(stages), 1)] * len(stages))
        source = "analytic" if measured_bytes is None else "measured"
        if measured_bytes is not None and len(measured_bytes) != len(stages):
            raise ValueError(f"{len(measured_bytes)} measured byte counts "
                             f"for {len(stages)} collective stages")
        total_b, total_c = 0.0, 0
        for i, s in enumerate(stages):
            e = {"step": int(step), "level": int(level), "h": int(h),
                 "stage": i, "scope": scope, "kind": s.kind,
                 "topology": plan.topology.kind,
                 "buckets": list(s.buckets),
                 "group": int(s.group),
                 "coalesced": bool(s.coalesced),
                 "num_workers": nw,
                 "bytes_on_wire": float(s.wire_bytes),
                 "collectives": int(s.collectives),
                 "cost_source": source,
                 "compression": s.compression,
                 "batch_scale": int(batch_scale),
                 "lr_scale": float(lr_scale)}
            if measured_bytes is not None:
                e["measured_bytes"] = float(measured_bytes[i])
            if seconds is not None:
                e["stage_s"] = float(seconds * shares[i])
            self.entries.append(e)
            total_b += e["bytes_on_wire"]
            total_c += e["collectives"]
        out = {"step": int(step), "level": int(level), "h": int(h),
               "bytes_on_wire": total_b, "collectives": total_c,
               "cost_source": source,
               "compression": "|".join(plan.modes),
               "batch_scale": int(batch_scale),
               "lr_scale": float(lr_scale)}
        if measured_bytes is not None:
            out["measured_bytes"] = float(sum(measured_bytes))
        if seconds is not None:
            out["sync_s"] = float(seconds)
        return out

    def total_bytes(self, *, level: int | None = None) -> float:
        return float(sum(e["bytes_on_wire"] for e in self.entries
                         if level is None or e["level"] == level))

    def total_collectives(self) -> int:
        return int(sum(e["collectives"] for e in self.entries))

    def num_rounds(self) -> int:
        return len({(e["step"], e["level"]) for e in self.entries})

    def by_topology(self) -> dict:
        """Per-(topology, scope) round costs, the Alg. 5 trade-off view:
        a hierarchical run's intra-block and global stages are separate
        rows."""
        def key(e):
            scope = e.get("scope") or ("block" if e["level"] == 1
                                       else "global")
            return f"{e.get('topology', 'round')}/{scope}"
        return _group_rounds(self.entries, key)

    def by_workers(self) -> dict:
        """Per-worker-set round costs (one row per worker count W)."""
        rows = _group_rounds(self.entries,
                             lambda e: int(e.get("num_workers", 0) or 0))
        return {f"W={k}": rows[k] for k in sorted(rows)}

    def scaling(self) -> dict:
        """The batch / LR actuators over the recorded rounds, and the wire
        bytes per round per unit of batch scale."""
        rounds: dict = {}
        for e in self.entries:
            r = rounds.setdefault((e["step"], e["level"]),
                                  {"bytes": 0.0,
                                   "batch_scale": e.get("batch_scale", 1),
                                   "lr_scale": e.get("lr_scale", 1.0)})
            r["bytes"] += e["bytes_on_wire"]
        if not rounds:
            return {}
        bs = [r["batch_scale"] for r in rounds.values()]
        lr = [r["lr_scale"] for r in rounds.values()]
        return {"batch_scale_range": [int(min(bs)), int(max(bs))],
                "lr_scale_range": [float(min(lr)), float(max(lr))],
                "bytes_per_round_example": float(
                    sum(r["bytes"] for r in rounds.values())
                    / max(sum(bs), 1))}

    def summary(self) -> dict:
        out = {"sync_rounds": self.num_rounds(),
               "wire_bytes": self.total_bytes(),
               "collectives": self.total_collectives(),
               "cost_sources": sorted({e["cost_source"]
                                       for e in self.entries}),
               "scaling": self.scaling(),
               "topologies": self.by_topology(),
               "worker_sets": self.by_workers()}
        if any("measured_bytes" in e for e in self.entries):
            out["measured_bytes"] = float(sum(e.get("measured_bytes", 0.0)
                                              for e in self.entries))
        if any("stage_s" in e for e in self.entries):
            # measured sync seconds rode in through record_plan(seconds=)
            out["sync_seconds"] = float(sum(e.get("stage_s", 0.0)
                                            for e in self.entries))
        return out

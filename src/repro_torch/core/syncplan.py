"""SyncPlan: the staged sync pipeline (the port of ``repro.core.syncplan``,
flat topology only).

A plan compiles the per-bucket sync into ordered :class:`SyncStage` s —
``pack -> collective -> apply`` per bucket — with a per-bucket
compressor mode; ``local_sgd.sync(state, plan=, scope="global")``
executes it.  Hierarchical and overlap topologies, coalescing, the
1-bit wire pack and the controller's ``PlanDelta`` are not ported yet
and raise.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

_COMP_MODES = ("none", "sign", "ef_sign")


def resolve_comp_modes(compression, num_buckets: int, default: str):
    """Per-bucket modes: None (the default), one mode string, or a
    per-bucket tuple (a length-1 tuple broadcasts)."""
    if compression is None:
        modes = (default,) * num_buckets
    elif isinstance(compression, str):
        modes = (compression,) * num_buckets
    else:
        modes = tuple(compression)
        if len(modes) == 1:
            modes = modes * num_buckets
        if len(modes) != num_buckets:
            raise ValueError(f"compression tuple has {len(modes)} entries "
                             f"for {num_buckets} buckets")
    bad = set(modes) - set(_COMP_MODES)
    if bad:
        raise ValueError(f"unknown compression mode(s) {sorted(bad)}")
    return modes


@dataclass(frozen=True)
class Topology:
    kind: str = "flat"


def flat() -> Topology:
    """One global mean over all W workers (Alg. 1)."""
    return Topology("flat")


@dataclass(frozen=True)
class SyncStage:
    """One step of the sync pipeline: ``kind`` is ``pack`` (form and
    compress the per-worker delta), ``collective`` (the worker mean) or
    ``apply`` (anchor update and broadcast)."""
    kind: str
    scope: str
    buckets: tuple[int, ...]
    compression: str = "none"
    group: int = 0


@dataclass(frozen=True)
class SyncPlan:
    layout: Any
    topology: Topology
    modes: tuple[str, ...]
    num_workers: int
    anchored: bool = False
    stages: tuple[SyncStage, ...] = ()

    @property
    def num_buckets(self) -> int:
        return self.layout.num_buckets

    def schedule(self, scope: str = "global") -> tuple[SyncStage, ...]:
        out = tuple(s for s in self.stages if s.scope == scope)
        if not out:
            raise ValueError(f"plan has no {scope!r} stages "
                             f"(topology={self.topology.kind})")
        return out


def _compile_stages(layout, modes, *, num_workers: int, anchored: bool):
    stages: list[SyncStage] = []
    for b in range(layout.num_buckets):
        if anchored:
            stages.append(SyncStage("pack", "global", (b,), modes[b], num_workers))
        stages.append(SyncStage("collective", "global", (b,), modes[b], num_workers))
        stages.append(SyncStage("apply", "global", (b,), "none", num_workers))
    return tuple(stages)


def make_sync_plan(layout, *, num_workers: int, topology: Topology | None = None,
                   compression=None, anchored: bool | None = None,
                   wire_pack: bool = False, coalesce: bool = False) -> SyncPlan:
    """Compile a flat :class:`SyncPlan` for the bucket ``layout``."""
    topology = topology or flat()
    if topology.kind != "flat":
        raise NotImplementedError(f"sync topology {topology.kind!r} is not "
                                  "ported yet (flat only)")
    if wire_pack or coalesce:
        raise NotImplementedError("the 1-bit wire pack and coalesced "
                                  "collectives are not ported yet")
    modes = resolve_comp_modes(compression, layout.num_buckets, "none")
    if anchored is None:
        anchored = any(m != "none" for m in modes)
    return SyncPlan(layout=layout, topology=topology, modes=modes,
                    num_workers=int(num_workers), anchored=bool(anchored),
                    stages=_compile_stages(layout, modes,
                                           num_workers=int(num_workers),
                                           anchored=bool(anchored)))

"""SyncPlan: the staged, topology-aware sync pipeline (the port of
``repro.core.syncplan``).

A plan compiles the per-bucket sync into ordered :class:`SyncStage` s —
``pack -> collective -> apply`` per bucket — each carrying its bucket
ids, compressor mode, the workers it averages and its ring-model wire
bytes (the same formulas as ``telemetry.ledger.analytic_sync_cost``).
:class:`Topology` declares where the averages run:

* ``flat()`` — one global mean over all W workers (Alg. 1);
* ``hierarchical(block_size)`` — Alg. 5: block-mean stages (scope
  ``"block"``, dense, over blocks of consecutive workers) beside the
  global stages;
* ``overlap()`` — flat semantics with the global stages software-
  pipelined (bucket b's collective before bucket b-1's apply).  Every
  ordering is a topological order of the same per-bucket dataflow, so
  flat and overlap give the same bits.

``local_sgd.sync(state, plan=, scope=)`` executes ``plan.schedule(scope)``
and ``telemetry.ledger.CommsLedger.record_plan`` prices its collective
stages, and a controller's :class:`PlanDelta` rewrites the plan between
rounds.  With ``wire_pack`` a compressed bucket's collective is priced
as the 1-bit payload's all-gather plus its scales' (two collectives).
The port has no mesh, so every stage's ``reduce_axes`` is ``()``.  With
``coalesce`` the wire-packed sub-buckets of one dtype (one per sharding
class, ``flatbuf.shard_classes``) share one collective stage: one
payload gather and one scale gather for the group (``coalesced=True``);
dense buckets always ride alone.  A layout with one bucket per dtype
has nothing to coalesce.  Gathers are priced on shard-local rows: a
sharded sub-bucket's workers each hand one shard region.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any

import numpy as np

from repro_torch.core.flatbuf import LANE
from repro_torch.roofline.hlo import _ring_bytes

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


# ---------------------------------------------------------------------------
# Topology
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Topology:
    """Where the sync averages run: ``kind`` is ``"flat"``,
    ``"hierarchical"`` or ``"overlap"``; ``block_size`` the workers per
    block of the Alg. 5 inner mean (0 = no block level)."""
    kind: str = "flat"
    block_size: int = 0

    @property
    def has_block(self) -> bool:
        return self.block_size > 0 and self.kind in ("hierarchical", "overlap")

    def describe(self) -> str:
        if self.has_block:
            return f"{self.kind}(block_size={self.block_size})"
        return self.kind


def flat() -> Topology:
    """One global mean over all W workers (Alg. 1)."""
    return Topology("flat")


def hierarchical(block_size: int) -> Topology:
    """Alg. 5: block-mean stages (scope ``"block"``) + global stages."""
    if block_size < 1:
        raise ValueError(f"hierarchical block_size must be >= 1, "
                         f"got {block_size}")
    return Topology("hierarchical", int(block_size))


def overlap(block_size: int = 0) -> Topology:
    """Flat semantics, software-pipelined global ordering: bucket b's
    collective is issued before bucket b-1's apply."""
    return Topology("overlap", int(block_size))


def default_block_size(num_workers: int) -> int:
    """The trainer's default Alg. 5 blocking: two blocks of consecutive
    workers (the paper's two-pod Figure 17 mapping)."""
    blocks = 2 if num_workers >= 2 else 1
    return max(num_workers // blocks, 1)


# ---------------------------------------------------------------------------
# Stages
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class SyncStage:
    """One step of the sync pipeline.

    ``kind``        — ``"pack"`` (form and compress the per-worker delta),
                      ``"collective"`` (the worker mean) or ``"apply"``
                      (global momentum, anchor update, broadcast).
    ``scope``       — ``"block"`` (Alg. 5 inner mean) or ``"global"``.
    ``buckets``     — the flat-bus bucket ids this stage touches.
    ``compression`` — compressor mode of the payload.
    ``group``       — workers averaged together (block_size or W).
    ``reduce_axes`` — mesh axes of the collective (``()``: no mesh).
    ``wire_bytes``  — per-worker ring-model bytes of the collective.
    ``collectives`` — collectives this stage launches (0 for pack/apply).
    ``coalesced``   — several same-dtype sub-buckets share this stage's
                      payload gather.
    """
    kind: str
    scope: str
    buckets: tuple[int, ...]
    compression: str = "none"
    group: int = 0
    reduce_axes: tuple[str, ...] = ()
    wire_bytes: float = 0.0
    collectives: int = 0
    coalesced: bool = False


def _bucket_gather_bytes(layout, b: int, group: int) -> tuple[float, float]:
    """(payload, scales) result bytes of one wire-packed bucket's gathers:
    8 signs a byte of one shard region's rows, one f32 scale a leaf, from
    each of ``group`` workers."""
    rows = layout.bucket_local_rows(b)
    payload = group * rows * (LANE // 8)
    scales = group * len(layout.bucket_slots(b)) * 4
    return float(payload), float(scales)


def _collective_stage(layout, buckets: tuple[int, ...], *, scope: str,
                      group: int, mode: str, wire_pack: bool) -> SyncStage:
    """The collective stage of ``buckets``, priced like
    ``telemetry.ledger.analytic_sync_cost``: wire-packed, it gathers the
    buckets' payload and scales (two all-gathers, shared by a coalesced
    group); dense, it all-reduces one bucket's shard-local bytes (f32
    width once compressed, sign * scale unpacked)."""
    n = max(int(group), 1)
    if mode != "none" and wire_pack:
        payload = scales = 0.0
        for b in buckets:
            p, sc = _bucket_gather_bytes(layout, b, n)
            payload += p
            scales += sc
        total = (_ring_bytes("all-gather", payload, n)
                 + _ring_bytes("all-gather", scales, n))
        return SyncStage(kind="collective", scope=scope, buckets=buckets,
                         compression=mode, group=n, wire_bytes=total,
                         collectives=2, coalesced=len(buckets) > 1)
    assert len(buckets) == 1, "dense stages are never coalesced"
    b = buckets[0]
    itemsize = (4 if mode != "none"
                else np.dtype(layout.bucket_dtypes[b]).itemsize)
    bytes_ = _ring_bytes("all-reduce",
                         layout.bucket_local_rows(b) * LANE * itemsize, n)
    return SyncStage(kind="collective", scope=scope, buckets=buckets,
                     compression=mode, group=n, wire_bytes=bytes_,
                     collectives=1)


def _global_groups(layout, modes, wire_pack: bool, coalesce: bool):
    """Bucket ids in collective groups.  With ``coalesce`` the wire-packed
    buckets of one dtype share a group (one payload gather a dtype, not a
    sharding class); dense buckets always ride alone.  Groups keep the
    buckets' first-appearance order."""
    nb = layout.num_buckets
    if not coalesce:
        return [(b,) for b in range(nb)]
    groups: list[list[int]] = []
    by_dtype: dict[str, list[int]] = {}
    for b in range(nb):
        if modes[b] != "none" and wire_pack:
            key = layout.bucket_dtypes[b]
            if key in by_dtype:
                by_dtype[key].append(b)
                continue
            by_dtype[key] = grp = [b]
            groups.append(grp)
        else:
            groups.append([b])
    return [tuple(g) for g in groups]


def _compile_stages(layout, topology: Topology, modes, *, num_workers: int,
                    wire_pack: bool, coalesce: bool,
                    anchored: bool) -> tuple[SyncStage, ...]:
    stages: list[SyncStage] = []
    nb = layout.num_buckets
    if topology.has_block:
        # Alg. 5 inner mean: one dense block mean per bucket (the block
        # level never compresses: compression needs the global anchor),
        # then one trivial apply covering the whole state
        for b in range(nb):
            stages.append(_collective_stage(layout, (b,), scope="block",
                                            group=topology.block_size,
                                            mode="none", wire_pack=False))
        stages.append(SyncStage(kind="apply", scope="block",
                                buckets=tuple(range(nb)),
                                group=topology.block_size))

    def triple(grp):
        packs = ([SyncStage(kind="pack", scope="global", buckets=(b,),
                            compression=modes[b], group=num_workers)
                  for b in grp] if anchored else [])
        coll = _collective_stage(layout, grp, scope="global",
                                 group=num_workers, mode=modes[grp[0]],
                                 wire_pack=wire_pack)
        applies = [SyncStage(kind="apply", scope="global", buckets=(b,),
                             group=num_workers) for b in grp]
        return packs, coll, applies

    triples = [triple(g) for g in _global_groups(layout, modes, wire_pack,
                                                 coalesce)]
    if topology.kind == "overlap":
        # software pipeline: issue group i's collective, THEN apply
        # group i-1
        pending: list[SyncStage] = []
        for packs, coll, applies in triples:
            stages.extend(packs)
            stages.append(coll)
            stages.extend(pending)
            pending = applies
        stages.extend(pending)
    else:
        for packs, coll, applies in triples:
            stages.extend(packs)
            stages.append(coll)
            stages.extend(applies)
    return tuple(stages)


# ---------------------------------------------------------------------------
# The plan
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class SyncPlan:
    """A compiled, static sync schedule for BOTH scopes: ``layout`` is the
    per-worker ``flatbuf.FlatLayout`` of the synced state, ``modes`` the
    per-bucket compressor; executors run ``schedule(scope)`` in order."""
    layout: Any
    topology: Topology
    modes: tuple[str, ...]
    num_workers: int
    wire_pack: bool = False
    coalesce: bool = False
    anchored: bool = False
    stages: tuple[SyncStage, ...] = ()

    @property
    def num_buckets(self) -> int:
        return self.layout.num_buckets

    def schedule(self, scope: str = "global") -> tuple[SyncStage, ...]:
        out = tuple(s for s in self.stages if s.scope == scope)
        if not out:
            raise ValueError(f"plan has no {scope!r} stages "
                             f"(topology={self.topology.describe()})")
        return out

    def collective_stages(self, scope: str = "global") -> tuple[SyncStage, ...]:
        """The scope's collective stages in schedule order; a stage's id is
        its index here (``CommsLedger.record_plan`` rows carry it)."""
        return tuple(s for s in self.schedule(scope) if s.kind == "collective")

    def scope_cost(self, scope: str = "global"):
        """(per-worker wire bytes, collective count) of one ``scope`` round."""
        st = self.schedule(scope)
        return (sum(s.wire_bytes for s in st),
                sum(s.collectives for s in st))

    def with_modes(self, compression) -> "SyncPlan":
        """Recompile with new per-bucket compressor modes; ``None`` (or the
        same modes) returns ``self``."""
        if compression is None:
            return self
        modes = resolve_comp_modes(compression, self.num_buckets,
                                   self.modes[0] if self.modes else "none")
        if modes == self.modes:
            return self
        return _recompile(self, modes=modes)

    def with_topology(self, topology: Topology | None) -> "SyncPlan":
        if topology is None or topology == self.topology:
            return self
        return _recompile(self, topology=topology)

    def describe(self, scope: str | None = None) -> str:
        """Human-readable stage table."""
        rows = [f"SyncPlan topology={self.topology.describe()} "
                f"buckets={self.num_buckets} modes={'|'.join(self.modes)} "
                f"coalesce={self.coalesce} wire_pack={self.wire_pack}"]
        stages = self.stages if scope is None else self.schedule(scope)
        for i, s in enumerate(stages):
            extra = ""
            if s.kind == "collective":
                extra = (f" wire_bytes={s.wire_bytes:.0f} "
                         f"collectives={s.collectives}"
                         + (" coalesced" if s.coalesced else ""))
            rows.append(f"  [{i:2d}] {s.scope:6s} {s.kind:10s} "
                        f"buckets={list(s.buckets)} mode={s.compression} "
                        f"group={s.group}{extra}")
        return "\n".join(rows)


def _recompile(plan: SyncPlan, **changes) -> SyncPlan:
    plan = replace(plan, **changes)
    stages = _compile_stages(plan.layout, plan.topology, plan.modes,
                             num_workers=plan.num_workers,
                             wire_pack=plan.wire_pack, coalesce=plan.coalesce,
                             anchored=plan.anchored)
    return replace(plan, stages=stages)


def make_sync_plan(layout, *, num_workers: int, topology: Topology | None = None,
                   compression=None, anchored: bool | None = None,
                   wire_pack: bool = False, coalesce: bool = False) -> SyncPlan:
    """Compile a :class:`SyncPlan` for the bucket ``layout``.

    ``topology`` defaults to ``flat()`` (``resolve_topology`` maps a
    config to its own); ``compression`` follows
    :func:`resolve_comp_modes`; ``anchored`` marks a sync that consumes a
    delta against the global anchor (``local_sgd.needs_anchor``) and so
    has pack stages; ``wire_pack`` / ``coalesce`` are the config's
    ``wire_pack`` / ``sync_coalesce``.
    """
    topology = topology or flat()
    modes = resolve_comp_modes(compression, layout.num_buckets, "none")
    if anchored is None:
        anchored = any(m != "none" for m in modes)
    plan = SyncPlan(layout=layout, topology=topology, modes=modes,
                    num_workers=int(num_workers), wire_pack=bool(wire_pack),
                    coalesce=bool(coalesce), anchored=bool(anchored))
    return _recompile(plan)


def resolve_topology(ls, num_workers: int) -> Topology:
    """Map a ``LocalSGDConfig`` to its declared :class:`Topology`.

    ``sync_topology='auto'``: ``hierarchical(default_block_size)`` when
    ``block_steps > 1`` (Alg. 5 needs block stages), else ``flat``.  An
    explicit ``'flat'`` with ``block_steps > 1`` contradicts itself and
    raises.
    """
    kind = ls.sync_topology
    bs = default_block_size(num_workers)
    if kind == "auto":
        return hierarchical(bs) if ls.block_steps > 1 else flat()
    if kind == "flat":
        if ls.block_steps > 1:
            raise ValueError("sync_topology='flat' cannot serve "
                             "block_steps > 1 (Alg. 5 needs block stages); "
                             "use 'auto', 'hierarchical', or 'overlap'")
        return flat()
    if kind == "hierarchical":
        return hierarchical(bs)
    if kind == "overlap":
        return overlap(bs if ls.block_steps > 1 else 0)
    raise ValueError(f"unknown sync_topology {kind!r}")


# ---------------------------------------------------------------------------
# Controller actuator surface
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class PlanDelta:
    """One round's controller decision (``core/controller`` policies emit
    one per global sync round; ``launch/train.fit`` applies it).

    ``h``           — local steps H for the NEXT round (None = keep).
    ``compression`` — per-stage compressor rewrite for the plan
                      (None = keep; str broadcasts; tuple per bucket).
    ``topology``    — switch the plan's :class:`Topology` (None = keep).
    ``batch_scale`` — per-worker batch multiplier (None = keep).
    ``lr_scale``    — runtime LR multiplier that ``fit`` applies to the
                      scheduled lr (None = keep).
    ``workers``, ``demote``, ``promote`` — the elastic policy's worker-set
                      changes (a resize, a straggler's demotion to the
                      outer scope and its return), which ``fit``
                      actuates through the backend.
    ``block_steps`` — runtime Alg. 5 block-phase length for
                      ``DynamicSchedule`` (None = keep).

    Only ``compression`` and ``topology`` touch the plan: ``apply``
    ignores the rest, which ``fit`` consumes.
    """
    h: int | None = None
    compression: Any = None
    topology: Topology | None = None
    batch_scale: int | None = None
    lr_scale: float | None = None
    workers: int | None = None
    demote: int | None = None
    promote: int | None = None
    block_steps: int | None = None

    def apply(self, plan: SyncPlan) -> SyncPlan:
        """Derive the next round's plan.  An empty delta returns the SAME
        object: the static policy cannot perturb the schedule."""
        return plan.with_modes(self.compression).with_topology(self.topology)

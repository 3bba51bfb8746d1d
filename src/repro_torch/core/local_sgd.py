"""Local SGD / post-local SGD on resident flat-bus buckets — the paper's core
(the port of the resident path of ``repro.core.local_sgd``).

Representation: params, momentum and EF memory are ``flatbuf.BucketState``
s of stacked ``(W, rows, 128)`` buffers, one row block per worker on the
same card; the anchor (the last synced model) is a single-copy
``BucketState``.  The buckets are the single source of truth between
syncs — the tree view exists only at ``unpack_state`` / ``mean_params``.

* ``local_step`` differentiates each worker's loss with respect to its
  param BUCKET (the model reads views into it,
  ``flatbuf.unflatten_grad_into``), so each worker's gradient lands once
  in its row of the stacked grad bucket, with exact-zero padding;
  optional isotropic gradient noise (``noise_eta > 0``) is added there,
  masked off the padding; then ONE fused update launch per bucket
  updates all W workers in place: SGD (plus one ``sq_sum`` launch per
  bucket for the per-worker grad clip) or LARS (plus one
  ``lars_row_norms`` launch per bucket for the trust ratios; no clip).
  Workers run one after another in a Python loop where the reference
  uses ``vmap``.  ``lr_scale`` multiplies the scheduled lr (the
  controllers' LR actuator).
* ``sync`` executes one scope of a :class:`~repro_torch.core.syncplan.SyncPlan`
  (flat, hierarchical or overlap topology): the no-anchor mean sync
  averages the worker copies in place, over all W at global scope or over
  blocks of consecutive workers at the Alg. 5 block scope; the anchored
  sign / EF-sign sync (global scope only) forms the per-worker delta
  against the anchor, compresses it (two kernel launches per bucket),
  averages it and steps the anchor, then broadcasts the new anchor into
  every worker.  With the plan's ``wire_pack`` a compressed bucket's
  average goes through the 1-bit wire format: each worker's row is
  packed to ``uint8`` signs and per-leaf scales, unpacked and averaged
  (the reference's meshless ``_packed_mean_flat_local``; on one card
  there is no gather to make), and its padding is masked back to zero.
  A coalesced stage (``sync_coalesce``: the wire-packed sub-buckets of
  one dtype) packs every bucket of its group on its own; across
  processes their packed bytes and scales are concatenated into one
  payload gather and one scale gather.  Stages
  run in the plan's order, and every order a topology emits is a
  topological order of the same per-bucket dataflow: overlap gives
  flat's bits.

With telemetry (``make_local_sgd(..., telemetry=True)``) ``state.stats``
carries a ``telemetry.stats.StatsAccumulator``: the per-worker grad and
update norms come from the update launch's ``stats=True`` form, and each
global sync (block syncs record nothing) records its pre-/post-mean norm
pair and per-bucket compression error.  With ``speculate_compression``
(the compression-escalating controllers) a global sync also measures,
for every bucket it sends uncompressed, the error the sign compressor
WOULD make: the controller's turn-on signal.

The update is in place: ``local_step`` and ``sync`` return a state that
shares (and has mutated) the buffers of the one they were given.

Across processes (``make_local_sgd(..., dist=Collectives)``, built by
``backend.DistributedBackend``) each rank holds its ``W_local = W / P``
consecutive workers as the leading rows of its own buckets and takes
its rows of the global ``(W, B_loc, ...)`` batch.  A global mean sync
is ``Collectives.ordered_mean`` of the rank's rows (a chained reduce
through the ranks in order, the results passed back along the chain:
each element the workers' sum in worker order, scaled by 1 / W, as one
process's ``mean(dim=0)`` makes it);
an Alg. 5 block mean stays on the rank when the block lies inside it and
takes the block's sub-group when it spans ranks; sign / EF-sign compress each
worker's delta on its rank (the shared per-leaf scale from all W
workers' |x| totals, added rank after rank in worker order); the wire
pack gathers every worker's ``uint8`` payload and scales and unpacks and
averages them in worker order, as the one-process path does.
Per-worker values (losses, metrics, telemetry norms) are gathered and
any sum of them added in worker order, so every rank holds the same
numbers, the one process's.

Within-worker sharding (``make_local_sgd(..., shard_classes=)``, the
classes of ``flatbuf.shard_classes`` under an FSDP or tensor-parallel
``sharding.layout.MeshLayout``): leaves ride (dtype, class) sub-buckets,
a sharded one in shard-major rows.  In one process every bucket is
whole, as in the reference's meshless resident path, and every kernel
sees its S shard regions as extra leading rows
(``flatbuf.shard_regions``), each per-worker sum being the regions'
partials added in shard order.  Across ranks with ``within_worker_size``
S > 1 (``WorkerLayout``: rank = group * S + shard) a rank holds its
shard's region of each sharded sub-bucket (momentum, EF memory and
anchor too) and the replicated ones whole.  ``local_step`` all-gathers
each sharded bucket over the shard group into its whole rows and reads
the leaves from them; with ``batch_split`` = S (FSDP: the ``"batch"``
rule shards the worker's batch) the rank differentiates its 1/S of the
worker's batch and the mean gradient is reduce-scattered into its rows
(replicated buckets all-reduced), while with ``batch_split`` = 1 (tensor
parallel; Megatron-style split compute is not ported) every shard rank
differentiates the whole batch and keeps its own rows, with no
collective.  The kernels then run on the rank's rows and every sum that
crosses shards (the clip norm, LARS's layer norms, the compressor's and
the wire pack's per-leaf scales, telemetry) adds the shard group's
partials in shard order: the adds one process makes.  Syncs average
over each shard's worker group.

A checkpoint across ranks saves the whole state in the one-process layout
(:func:`gather_state`, rank 0); a restore on P ranks reads it whole and
keeps each rank's rows (:func:`state_template`, :func:`local_state`).

The tree path (``make_local_sgd(..., use_kernel=False)``, or
``resident=False`` / ``bucket_sync=False`` with the kernels on) is the
reference's non-resident path: the state holds per-leaf trees stacked
``(W, ...)`` (the anchor and global momentum single-copy trees), and
every step returns new tensors.  ``local_step`` takes each worker's
gradient on its own leaf slices (``torch.autograd.grad``), stacks them
and updates all W at once: per leaf in plain PyTorch (``use_kernel=
False``, the reference's jnp oracle) or packed into ``(W, rows, 128)``
buckets, updated by one fused launch a bucket (the per-worker clip norm
by ``sq_sum``) and unpacked (``use_kernel=True``: the tree-in/tree-out
kernel form, which pays the pack and unpack passes every step that the
resident path pays once a sync).  Its sync averages per dtype bucket
(``bucket_sync``, the default: :func:`bucket_group_mean`,
:func:`bucket_worker_mean`, :func:`bucket_packed_mean`) or per leaf, and
compresses with ``compression.sign_compress`` / ``ef_compress`` in the
same form as the step.  As in the reference, momentum and EF memory
start in the params' dtype and the EF memory and global momentum become
float32 at the first sync; a sync takes one compressor mode for the whole
state; gradient noise is drawn per leaf from the state's generator,
worker after worker; telemetry has one compression-error slot.  A
leaf's sign scale adds its workers' |x| sums in worker order, and
telemetry's compression error and reference add per-worker sums in
worker order too.

Across ranks (``dist`` of whole workers: within-worker size 1; a worker
split over shard ranks raises ``ValueError``) each rank holds its
``W_local`` workers' rows of every stacked leaf and the single-copy
anchor and global momentum whole.  A global or spanning block mean is
the ordered mean of the rank's rows (per dtype bucket, or per leaf
without ``bucket_sync``); the sign scales gather every worker's |x| sums
(one gather a sync) or, in the kernel form, chain the segmented totals
rank after rank; the wire pack gathers every worker's packed rows and
scales (per bucket, or per leaf).  Metrics and per-worker telemetry are
gathered: given equal inputs, every number is the one process's.

**A kept difference:** the reference defaults ``use_kernel`` to False
(the tree path); the port defaults it to True (the resident path), so
that no caller moves off the kernels unasked.

A change of W (``core/elastic.resize_state``) builds new functions for
the new width: ``local_step`` and ``sync`` are built for one W.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.configs.base import LocalSGDConfig, RunConfig
from repro_torch.core import compression as comp
from repro_torch.core import flatbuf
from repro_torch.core import syncplan as splan
from repro_torch.core.noise import isotropic_noise
from repro_torch.core.schedule import lr_at
from repro_torch.kernels import ops as kops
from repro_torch.models import base as mbase
from repro_torch.optim.lars import apply_lars, apply_lars_buckets
from repro_torch.optim.sgd import apply_sgd, apply_sgd_buckets, init_momentum
from repro_torch.telemetry import stats as tstats
from repro_torch.utils import (tree_flatten, tree_leaves, tree_map,
                               tree_unflatten)


@dataclass
class LocalSGDState:
    # resident: BucketStates; the tree path: trees of tensors
    params: Any          # stacked (W, rows, 128) / (W, ...)
    momentum: Any        # stacked
    anchor: Any          # single copy (last synced model) or None
    global_u: Any        # single copy, or None
    ef_memory: Any       # stacked, or None
    step: int = 0
    rng: Any = None      # torch.Generator on the training device (noise)
    stats: Any = None    # telemetry.stats.StatsAccumulator or None
    # (fields in the reference's order: checkpoints name them in it)


def needs_anchor(cfg: LocalSGDConfig) -> bool:
    return cfg.global_momentum > 0 or cfg.sync_compression != "none"


def stack_tree(tree, W: int):
    """Replicate a single-copy tree into W stacked copies
    (``models.base.stack``: no two workers share storage)."""
    return mbase.stack(tree, W)


def is_resident(state: LocalSGDState) -> bool:
    return flatbuf.is_bucket_state(state.params)


def resident_eligible(use_kernel: bool, bucket_sync: bool,
                      bucketable=None) -> bool:
    """The resident path's predicate (the reference's): the kernels on and
    the sync bucketized; ``bucketable`` is accepted and ignored, as
    there."""
    del bucketable
    return bool(use_kernel and bucket_sync)


def unpack_state(state: LocalSGDState) -> LocalSGDState:
    """The tree view of a resident state (tensors are views of replicated
    buckets, copies of sharded leaves); a tree state as it is."""
    up = lambda x: x.unpack() if flatbuf.is_bucket_state(x) else x
    return LocalSGDState(params=up(state.params), momentum=up(state.momentum),
                         anchor=up(state.anchor), global_u=up(state.global_u),
                         ef_memory=up(state.ef_memory), step=state.step,
                         stats=state.stats, rng=state.rng)


def pack_state(state: LocalSGDState, *, wd_mask=None,
               shard_classes=None) -> LocalSGDState:
    """Re-enter resident bucket form from a tree state (the inverse of
    :func:`unpack_state`).  ``wd_mask`` goes into the params layout;
    ``shard_classes`` re-enters the (dtype, sharding-class) sub-buckets of
    a sharded layout.  Every field takes the params layout's geometry,
    each bucket in its own leaves' dtype, but EF memory in float32: a
    tree state's memory is in the params' dtype until its first EF-sign
    sync writes the f32 residual there, so the cast is exact."""
    if flatbuf.is_bucket_state(state.params):
        return state
    layout = flatbuf.build_layout(state.params, wd_mask=wd_mask, leading=1,
                                  shard_classes=shard_classes)

    def pack(tree, leading, dtype=None):
        if tree is None:
            return None
        dts = [flatbuf.dtype_name(dtype or x.dtype) for x in tree_leaves(tree)]
        per_bucket = []
        for b in range(layout.num_buckets):
            bd = {dts[s.index] for s in layout.bucket_slots(b)}
            if len(bd) != 1:
                raise ValueError(f"cannot pack mixed dtypes {sorted(bd)} into "
                                 f"params bucket {b} ({layout.bucket_dtypes[b]})")
            per_bucket.append(bd.pop())
        bufs = flatbuf.flatten(layout, tree, leading=leading,
                               bucket_dtypes=tuple(per_bucket))
        return flatbuf.BucketState(layout, tuple(bufs), leading=leading)

    return LocalSGDState(params=pack(state.params, 1),
                         momentum=pack(state.momentum, 1),
                         anchor=pack(state.anchor, 0),
                         global_u=pack(state.global_u, 0),
                         ef_memory=pack(state.ef_memory, 1, torch.float32),
                         step=state.step, rng=state.rng, stats=state.stats)


def _is_region(layout, b: int, x) -> bool:
    """True when ``x`` holds one shard region of sharded bucket ``b``."""
    return (layout.bucket_shard_count(b) > 1
            and x.shape[-2] != layout.bucket_rows[b])


def mean_params(state: LocalSGDState, dist=None):
    """Single-copy tree of the worker-averaged model (eval boundary);
    across processes (``dist``, a ``backend.collectives.Collectives``)
    the mean over all W workers of every rank, a sharded bucket's shard
    regions gathered into its whole rows.  A tree state's is each leaf's
    mean over its worker dim; across processes its leaves ride dtype
    buckets through the same ordered mean (one collective a bucket; each
    element the one process's)."""
    if not is_resident(state):
        if dist is None:
            return mbase.unstack_mean(state.params)
        layout = flatbuf.build_layout(state.params, leading=1)
        return flatbuf.unflatten(layout, [
            dist.ordered_mean(x, scope="eval")
            for x in flatbuf.flatten(layout, state.params, leading=1)])
    layout = state.params.layout
    if dist is None:
        means = [b.mean(dim=0) for b in state.params.buckets]
    else:
        means = []
        for b, x in enumerate(state.params.buckets):
            m = dist.ordered_mean(x, scope="eval")
            if _is_region(layout, b, m):
                m = dist.gather_shards(m, scope="eval").reshape(
                    layout.bucket_rows[b], flatbuf.LANE)
            means.append(m)
    return flatbuf.unflatten(layout, means)


# the (W,) fields of a telemetry.stats.StatsAccumulator: one entry a worker
_STATS_PER_WORKER = ("acc_grad_sq", "acc_update_sq", "round_grad_sq",
                     "round_update_sq")
_STACKED = ("params", "momentum", "ef_memory")
_SINGLE = ("anchor", "global_u")


def _group_seed(seed: int, group: int) -> int:
    """The noise stream's seed of worker group ``group``: worker group 0
    draws from ``seed``, as one process does."""
    return seed + 1_000_003 * group


def gather_state(state: LocalSGDState, dist, *, device="cpu"):
    """The whole state in the one-process layout, from every rank's rows,
    on rank 0 (on ``device``, the host by default); None on every other
    rank.  A checkpoint of a run across ranks (``fit(checkpoint_fn=)``)
    saves it, so the file is the one-process snapshot's.

    Every bucket of every field is gathered onto rank 0 on its own
    (``Collectives.gather_ranks``, scope ``"checkpoint"``), then assembled
    in worker order, a sharded sub-bucket's shard regions in shard order
    (a replicated one taken from shard 0), the single-copy anchor and
    global momentum from worker group 0, and copied to ``device``.  Peak
    memory: on rank 0's card, P times one bucket's local rows (the
    gather's output) beside the state, on the other ranks nothing more;
    on rank 0's host, the whole state.  The (W,) telemetry fields are
    gathered too; the generator is worker group 0's, whose stream starts
    from the run's seed as one process's does (the other groups' draws
    are not saved: ``fit`` refuses to checkpoint a noisy run over several
    worker groups)."""
    if not is_resident(state):
        return _gather_tree_state(state, dist, device=device)
    lay, grid = state.params.layout, dist.layout
    S, G = grid.within_worker_size, grid.num_groups
    lead = dist.rank == 0

    def assemble(parts, b: int, stacked: bool):
        groups = []
        for g in range(G if stacked else 1):
            if S > 1 and lay.bucket_shard_count(b) > 1:
                groups.append(torch.cat([parts[g * S + s] for s in range(S)],
                                        dim=-2))
            else:
                groups.append(parts[g * S])
        return torch.cat(groups, dim=0) if stacked else groups[0]

    fields = {}
    for name in _STACKED + _SINGLE:
        bs = getattr(state, name)
        if bs is None:
            fields[name] = None
            continue
        out = []
        for b, x in enumerate(bs.buckets):
            parts = dist.gather_ranks(x, scope="checkpoint")
            if lead:
                out.append(assemble(parts, b, name in _STACKED).to(device))
            del parts
        fields[name] = bs.with_buckets(out) if lead else None
    stats = state.stats
    if stats is not None:
        per = {}
        for f in _STATS_PER_WORKER:
            parts = dist.gather_ranks(getattr(stats, f), scope="checkpoint")
            if lead:
                per[f] = torch.cat([parts[g * S] for g in range(G)]).to(device)
    if not lead:
        return None
    if stats is not None:
        stats = dataclasses.replace(
            stats, **per, **{f.name: getattr(stats, f.name).to(device)
                             for f in dataclasses.fields(stats)
                             if f.name not in _STATS_PER_WORKER})
    return LocalSGDState(step=state.step, rng=state.rng, stats=stats, **fields)


def _gather_stats(stats, dist, *, device):
    """A telemetry accumulator with its (W,) fields gathered from every
    worker group in worker order, on rank 0 (None elsewhere, or without
    stats)."""
    if stats is None:
        return None
    per = {f: dist.gather_workers(getattr(stats, f), scope="checkpoint")
           for f in _STATS_PER_WORKER}
    if dist.rank != 0:
        return None
    return dataclasses.replace(stats, **{
        f.name: (per[f.name] if f.name in per
                 else getattr(stats, f.name)).to(device)
        for f in dataclasses.fields(stats)})


def _gather_tree_state(state: LocalSGDState, dist, *, device):
    """:func:`gather_state` of a tree state (one worker group a rank): each
    stacked field's leaves packed into dtype buckets, every bucket
    gathered onto rank 0 on its own and unpacked there into ``(W, ...)``
    leaves; the single-copy anchor and global momentum are rank 0's own
    (every rank holds the same bits)."""
    lead = dist.rank == 0
    fields = {}
    for name in _STACKED + _SINGLE:
        tree = getattr(state, name)
        if tree is None or name in _SINGLE:
            fields[name] = (None if tree is None or not lead
                            else tree_map(lambda x: x.to(device, copy=True),
                                          tree))
            continue
        layout = flatbuf.build_layout(tree, leading=1)
        out = []
        for x in flatbuf.flatten(layout, tree, leading=1):
            parts = dist.gather_ranks(x, scope="checkpoint")
            if lead:
                out.append(parts.reshape((-1,) + tuple(x.shape[1:]))
                           .to(device))
            del parts
        fields[name] = (flatbuf.unflatten(layout, out, leading=1) if lead
                        else None)
    stats = _gather_stats(state.stats, dist, device=device)
    if not lead:
        return None
    return LocalSGDState(step=state.step, rng=state.rng, stats=stats, **fields)


def state_template(state: LocalSGDState, dist, num_workers: int | None = None):
    """A template of the whole state in the one-process layout (meta
    tensors: a restore puts them on the host) at ``num_workers`` workers
    (default the run's W), for ``checkpoint.restore_flat`` on a rank; the
    generator is this rank's.  A tree state's template is a tree of
    ``(W, ...)`` (stacked) and single-copy leaves."""
    grid = dist.layout
    W = grid.num_workers if num_workers is None else int(num_workers)
    meta = lambda shape, dt: torch.empty(shape, dtype=dt, device="meta")

    def field(name):
        bs = getattr(state, name)
        if bs is None:
            return None
        if not flatbuf.is_bucket_state(bs):
            return tree_map(lambda x: meta(
                ((W,) + tuple(x.shape[1:])) if name in _STACKED
                else tuple(x.shape), x.dtype), bs)
        lay = bs.layout
        bufs = [meta(((W,) if name in _STACKED else ())
                     + (lay.bucket_rows[b], x.shape[-1]), x.dtype)
                for b, x in enumerate(bs.buckets)]
        return bs.with_buckets(bufs)

    stats = state.stats
    if stats is not None:
        stats = dataclasses.replace(stats, **{
            f.name: meta(((W,) if f.name in _STATS_PER_WORKER else ())
                         + tuple(getattr(stats, f.name).shape[
                             1 if f.name in _STATS_PER_WORKER else 0:]),
                         getattr(stats, f.name).dtype)
            for f in dataclasses.fields(stats)})
    return LocalSGDState(step=state.step, rng=state.rng, stats=stats,
                         **{n: field(n) for n in _STACKED + _SINGLE})


def local_state(full: LocalSGDState, dist, device) -> LocalSGDState:
    """This rank's rows of a whole one-process state (a restored snapshot):
    its workers' rows, its shard's region of every sharded sub-bucket, on
    ``device``; the inverse of :func:`gather_state`.  Worker group 0 keeps
    the snapshot's generator (on its own device; elsewhere a generator
    seeded as the group's), the other groups a generator seeded as
    ``init`` seeds theirs.  A generator that has drawn (a run with gradient
    noise) is refused with ``ValueError`` where it cannot be kept as it
    is: a new stream would replay the draws.  A tree snapshot gives a
    tree state: its workers' rows of every stacked leaf."""
    grid = dist.layout
    S, si = grid.within_worker_size, grid.shard
    lo, wl = grid.worker_lo, grid.w_local

    def own(name):
        bs = getattr(full, name)
        if bs is None:
            return None
        if not flatbuf.is_bucket_state(bs):
            return tree_map(lambda x: (x[lo:lo + wl] if name in _STACKED
                                       else x).to(device=device, copy=True)
                            .contiguous(), bs)
        lay = bs.layout
        bufs = []
        for b, x in enumerate(bs.buckets):
            if name in _STACKED:
                x = x[lo:lo + wl]
            if S > 1 and lay.bucket_shard_count(b) > 1:
                lr = lay.bucket_local_rows(b)
                x = x[..., si * lr:(si + 1) * lr, :]
            bufs.append(x.to(device=device, copy=True).contiguous())
        return bs.with_buckets(bufs)

    stats = full.stats
    if stats is not None:
        stats = dataclasses.replace(stats, **{
            f.name: (getattr(stats, f.name)[lo:lo + wl]
                     if f.name in _STATS_PER_WORKER
                     else getattr(stats, f.name)).to(device=device, copy=True)
            for f in dataclasses.fields(stats)})
    rng = full.rng
    if rng is not None and (grid.group != 0
                            or rng.device != torch.device(device)):
        seed = int(rng.initial_seed())
        if not torch.equal(rng.get_state(), torch.Generator(
                device=rng.device).manual_seed(seed).get_state()):
            # the stream has drawn: a new one from the group's seed would
            # replay those draws (a snapshot holds group 0's stream only)
            raise ValueError(
                "the snapshot's noise stream has drawn and holds worker "
                f"group 0's draws only: worker group {grid.group} on "
                f"{device} cannot continue it")
        rng = torch.Generator(device=device).manual_seed(
            _group_seed(seed, grid.group))
    return LocalSGDState(step=full.step, rng=rng, stats=stats,
                         **{n: own(n) for n in _STACKED + _SINGLE})


def _sumsq(x, *, from_axis: int = 0):
    """f32 sum of squares over all dims from ``from_axis`` on (telemetry)."""
    xf = x.float()
    return (xf * xf).sum(dim=tuple(range(from_axis, x.dim())))


def _sumsq_w(layout, b: int, x, across=None):
    """Per-worker f32 sum of squares of bucket ``b``'s ``(W, rows, 128)``
    ``x`` (whole or one shard region), the shard regions' partials added
    in shard order."""
    return flatbuf.shard_sum(
        layout, b, _sumsq(flatbuf.shard_regions(layout, b, x), from_axis=2),
        across)


def _sumsq_all(layout, b: int, x, across=None):
    """f32 sum of squares of all of bucket ``b``'s ``x`` (any leading dims),
    over every shard region; a replicated bucket's in one reduction."""
    if layout.bucket_shard_count(b) == 1:
        return _sumsq(x)
    lead = x.dim() - 2
    part = _sumsq(flatbuf.shard_regions(layout, b, x), from_axis=lead + 1)
    return flatbuf.shard_sum(layout, b, part.reshape(-1, part.shape[-1])
                             .sum(dim=0), across)


def group_mean(x, group: int):
    """Mean over blocks of ``group`` consecutive workers, broadcast back."""
    W = x.shape[0]
    assert W % group == 0, (W, group)
    if group == 1:
        return x
    xg = x.reshape(W // group, group, *x.shape[1:])
    m = xg.mean(dim=1, keepdim=True)
    return m.expand(xg.shape).reshape(x.shape)


def _bucketed_map(tree, bucketable, bucket_fn, leaf_fn, leaf_args=None):
    """The scaffold of the tree path's bucketized sync: the stacked ``(W,
    ...)`` leaves flagged in ``bucketable`` (all, when None) packed into
    ``(W, rows, 128)`` dtype buckets, ``bucket_fn(buf, layout, j)`` applied
    to each (whether its result keeps the worker dim is read from its
    rank), unpacked; the others take ``leaf_fn(leaf, arg)`` one by one."""
    leaves, treedef = tree_flatten(tree)
    flags = (tree_leaves(bucketable) if bucketable is not None
             else [True] * len(leaves))
    args = (tree_leaves(leaf_args) if leaf_args is not None
            else [None] * len(leaves))
    assert len(flags) == len(leaves) and len(args) == len(leaves)
    out: list = [None] * len(leaves)
    on = [i for i, m in enumerate(flags) if m]
    for i, m in enumerate(flags):
        if not m:
            out[i] = leaf_fn(leaves[i], args[i])
    if on:
        sub = [leaves[i] for i in on]
        layout = flatbuf.build_layout(sub, leading=1)
        bufs = flatbuf.flatten(layout, sub, leading=1)
        res = [bucket_fn(b, layout, j) for j, b in enumerate(bufs)]
        vals = flatbuf.unflatten(layout, res,
                                 leading=res[0].dim() - bufs[0].dim() + 1)
        for i, v in zip(on, vals):
            out[i] = v
    return tree_unflatten(treedef, out)


def _block_mean(dist, x, group: int, *, scope: str = "global", stage=None):
    """Mean over blocks of ``group`` consecutive workers of this rank's rows
    ``x`` (all W at global scope), broadcast back to x's rows (a view): on
    the rank when its blocks lie inside it (always without ``dist``), else
    over the block's ranks by ``Collectives.ordered_mean``."""
    W = x.shape[0] if dist is None else dist.layout.num_workers
    if dist is None or (group < W and dist.layout.block_is_local(group)):
        return group_mean(x, group)
    sub = None
    if group < W:
        ranks = dist.layout.block_ranks(group)[dist.layout.worker_lo // group]
        sub = dist.block_groups(group)[ranks]
    m = dist.ordered_mean(x, scope=scope, stage=stage, group=sub, n=group)
    return m[None].expand_as(x)


def _group_mean_copy(x, group: int, dist=None, **kw):
    """:func:`_block_mean` as a tensor of its own: its broadcast is a view
    whose rows share one storage."""
    return _block_mean(dist, x, group, **kw).contiguous()


def _worker_mean(x, dist=None, **kw):
    """The mean over all W workers of a stacked ``x`` -> one copy: the one
    process's ``mean(dim=0)``, or across ranks the ordered mean of this
    rank's rows (``kw``: its scope and stage)."""
    return x.mean(dim=0) if dist is None else dist.ordered_mean(x, **kw)


def _stage_of(plan, scope: str):
    """bucket -> the id of the collective stage of ``plan``'s ``scope`` that
    carries it (stage 0 for a leaf off the flat bus): the stage a tree
    sync's measured bytes are booked under."""
    ids = {b: i for i, st in enumerate(plan.collective_stages(scope))
           for b in st.buckets}
    return lambda b: ids.get(b, 0)


def bucket_group_mean(params, group: int, bucketable=None, *, dist=None,
                      scope: str = "global", stage_of=None):
    """:func:`group_mean` per dtype bucket of a stacked tree: one mean per
    bucket instead of one per leaf.  ``dist``: the tree holds this rank's
    workers, and a block that spans ranks (all W at global scope) is
    averaged over them; ``stage_of(bucket)`` books its bytes."""
    stage_of = stage_of or (lambda b: 0)
    return _bucketed_map(
        params, bucketable,
        lambda b, lay, j: _group_mean_copy(b, group, dist, scope=scope,
                                           stage=stage_of(j)),
        lambda x, _: _group_mean_copy(x, group, dist, scope=scope,
                                      stage=stage_of(None)))


def bucket_worker_mean(delta, bucketable=None, *, dist=None, stage_of=None):
    """The mean over workers per dtype bucket of a stacked tree (the dense
    sync payload) -> a single-copy tree (``dist``, ``stage_of`` as in
    :func:`bucket_group_mean`)."""
    stage_of = stage_of or (lambda b: 0)
    return _bucketed_map(
        delta, bucketable,
        lambda b, lay, j: _worker_mean(b, dist, scope="global",
                                       stage=stage_of(j)),
        lambda x, _: _worker_mean(x, dist, scope="global",
                                  stage=stage_of(None)))


def _packed_mean_leaf(d, axis: int = -1, dist=None, stage=None):
    """One leaf's worker mean through the 1-bit wire format, packed along
    ``axis`` (a per-worker scale).  ``dist``: this rank's workers packed,
    the payload and the scales all-gathered into ``(W, ...)`` (one gather
    each), unpacked and averaged in worker order, as one process does."""
    packed, scale = comp.pack_signs(d, axis=axis)
    if dist is not None:
        packed = dist.gather_workers(packed, scope="global", stage=stage)
        scale = dist.gather_workers(scale, scope="global", stage=stage)
    return comp.unpack_signs(packed, scale, d.shape[1:], axis=axis).mean(dim=0)


def bucket_packed_mean(delta, bucketable=None, *, flat_fn=None, leaf_fn=None,
                       axes_tree=None):
    """The wire-packed worker mean of a stacked tree: the bucketable leaves
    through one pack a dtype bucket (``flat_fn``, by default the one
    process's :func:`_packed_mean_flat_local`), the others per leaf
    (``leaf_fn``, packed along their ``axes_tree`` axis, default the last).
    Returns the single-copy averaged tree (the padding the unpack fills is
    dropped with the rest of each bucket's padding)."""
    flat_fn = flat_fn or _packed_mean_flat_local
    leaf_fn = leaf_fn or _packed_mean_leaf
    if axes_tree is None:
        axes_tree = tree_map(lambda _: -1, delta)
    return _bucketed_map(
        delta, bucketable, lambda b, lay, j: flat_fn(b, lay, j),
        lambda d, axis: leaf_fn(d, -1 if axis is None else axis),
        leaf_args=axes_tree)


def pack_axes_tree(specs, layout):
    """Per-leaf pack axis of the per-leaf wire pack: the largest dim (at
    least 8) of a stacked leaf that the layout's EFFECTIVE rules
    (``MeshLayout.dim_shards``) leave unsharded, +1 for the worker dim;
    -1 (the last dim) when there is none."""
    def pick(ps):
        best, best_size = -1, -1
        eff = layout.dim_shards(ps.axes, ps.shape)
        for i, (r, n) in enumerate(zip(eff, ps.shape)):
            sharded = r is not None and layout.axis_size(r) > 1
            if not sharded and n >= 8 and n > best_size:
                best, best_size = i + 1, n
        return best if best >= 1 else -1

    return tree_map(pick, specs, is_leaf=mbase.is_spec)


def _tree_sumsq_w(tree):
    """(W,) per-worker f32 sum of squares over every leaf of a stacked
    tree, leaf after leaf."""
    return sum(_sumsq(x, from_axis=1) for x in tree_leaves(tree))


def _bucket_noise(layout, gbs, gen, *, step: int, eta: float, gamma: float):
    """Isotropic gradient noise straight on one worker's grad buckets, in
    place: g += sigma_t * N(0, 1), sigma_t = sqrt(eta / (1+t)^gamma), the
    schedule of :func:`repro_torch.core.noise.isotropic_noise`.  The draw
    comes from the explicit generator ``gen`` (one stream per state, so
    one seed gives the same bits) and is masked, so padding stays exactly
    zero.  Keyed per bucket, not per leaf: the same N(0, sigma_t^2) per
    element as the reference's bucket noise, but another stream, so noisy
    runs compare with it statistically, never bitwise."""
    if eta <= 0:
        return gbs
    sigma = math.sqrt(eta / (1.0 + step) ** gamma)
    for b, g in enumerate(gbs):
        n = torch.randn(g.shape, generator=gen, dtype=torch.float32,
                        device=g.device)
        g.add_(flatbuf.mask_padding(layout, b, n).mul_(sigma).to(g.dtype))
    return gbs


def _to_device(v, dev):
    """One batch field on ``dev``: integers as int64 (token ids, labels),
    floating values as float32 (features, +-1 targets), values intact."""
    t = torch.as_tensor(v)
    return t.to(dev, torch.float32 if t.is_floating_point() else torch.int64)


def _rank_rows(batch, W: int, lo: int, wl: int) -> dict:
    """This rank's rows ``lo .. lo + wl - 1`` of the global ``(W, B_loc,
    ...)`` batch every rank is handed."""
    bad = [k for k, v in batch.items() if len(v) != W]
    if bad:
        raise ValueError(f"batch fields {bad} do not have the W={W} rows of "
                         f"the global batch")
    return {k: v[lo:lo + wl] for k, v in batch.items()}


def _worker_grad(layout, loss_fn, pbs_w, batch_w, gw):
    """One worker's loss on its param buckets ``pbs_w``; the gradient lands
    in ``gw`` (zeroed grad buckets) once, through
    ``flatbuf.unflatten_grad_into``.  Returns (loss, metrics)."""
    src = [b.detach().requires_grad_(True) for b in pbs_w]
    loss, metrics = loss_fn(flatbuf.unflatten_grad_into(layout, src, gw),
                            batch_w)
    torch.autograd.grad(loss, src)
    return loss, metrics


def _packed_mean_flat_local(bucket, layout, b):
    """The worker mean of bucket ``b`` through the 1-bit wire format: each
    worker's ``(rows, 128)`` row of the stacked ``(W, rows, 128)`` buffer
    packed to signs and per-leaf scales, unpacked, averaged over W.  The
    unpack writes sign(+1) * scale into padding; the caller masks it."""
    packed, scales = comp.pack_bucket(layout, b, bucket.float())
    return comp.unpack_bucket(layout, b, packed, scales).mean(dim=0)


def _packed_mean_coalesced_local(bufs, layout, bids):
    """One process's coalesced wire mean: the same pack and unpack bucket
    by bucket (there is no wire to share), so the values are the
    across-ranks form's, which only concatenates the packed bytes."""
    return [_packed_mean_flat_local(x, layout, b)
            for x, b in zip(bufs, bids, strict=True)]


def _packed_mean_flat(dist, bucket, layout, b, *, stage=None):
    """The port of the reference's ``make_packed_mean_flat`` across
    processes: this rank's ``(W_local, rows, 128)`` rows (one shard region
    of a sharded sub-bucket) packed to ``uint8`` signs and per-leaf
    scales (their totals added across the shard group), the payload and
    the scales all-gathered over the worker group into ``(W, ...)``,
    unpacked and averaged in worker order: given equal inputs, the
    one-process path's bits."""
    return _packed_mean_coalesced(dist, [bucket], layout, (b,), stage=stage)[0]


def _packed_mean_coalesced(dist, bufs, layout, bids, *, stage=None):
    """The reference's ``make_packed_mean_coalesced`` across processes:
    every bucket of the group packed on its own (shard-local rows), the
    packed rows and the scales concatenated, ONE payload all-gather and
    ONE scale all-gather over the worker group, split back per bucket,
    unpacked and averaged: the per-bucket values, since concatenation and
    splitting move no value."""
    packs, scs = [], []
    for x, b in zip(bufs, bids, strict=True):
        pk, sc = comp.pack_bucket(layout, b, x.float(), across=dist)
        packs.append(pk)
        scs.append(sc)
    payload = packs[0] if len(packs) == 1 else torch.cat(packs, dim=1)
    scales = scs[0] if len(scs) == 1 else torch.cat(scs, dim=1)
    allp = dist.gather_workers(payload, scope="global", stage=stage)
    alls = dist.gather_workers(scales, scope="global", stage=stage)
    outs, ro, so = [], 0, 0
    for pk, sc, b in zip(packs, scs, bids):
        r, ns = pk.shape[1], sc.shape[1]
        outs.append(comp.unpack_bucket(layout, b, allp[:, ro:ro + r],
                                       alls[:, so:so + ns]).mean(dim=0))
        ro += r
        so += ns
    return outs


def _check_supported(run: RunConfig):
    opt = run.optim
    if opt.optimizer not in ("sgd", "lars"):
        raise NotImplementedError(f"optimizer {opt.optimizer!r} is not ported yet")


def _make_tree_local_sgd(run: RunConfig, loss_fn: Callable, *,
                         num_workers: int, wd_mask=None, use_kernel: bool,
                         bucket_sync: bool, bucketable=None,
                         packed_mean_fn=None, telemetry: bool = False,
                         speculate_compression: bool = False, dist=None):
    """(init, local_step, sync) of the tree path (see the module
    docstring), the port of the reference's non-resident branch of
    ``make_local_sgd``.  ``dist`` (one worker group a rank) keeps this
    rank's ``W / P`` workers' rows of every stacked leaf."""
    ls = run.local_sgd
    opt = run.optim
    W = num_workers
    global_batch = run.shape.global_batch
    wl = W if dist is None else dist.layout.w_local
    lo = 0 if dist is None else dist.layout.worker_lo
    if dist is not None and packed_mean_fn is not None \
            and packed_mean_fn[0] is not None:
        raise ValueError("a custom per-leaf wire pack sees one rank's rows: "
                         "across ranks the port gathers them itself "
                         "(packed_mean_fn=(None, axes_tree))")

    def gathered(x, scope: str):
        """Every worker's rows of a per-worker ``x`` (this rank's, in one
        process all of them), in worker order."""
        return x if dist is None else dist.gather_workers(x, scope=scope)

    def worker_total(per, scope: str):
        """Per-worker values ``(W_local, ...)`` -> their total over all W
        workers, added in worker order (the same adds on any ranks)."""
        return kops.lead_total(gathered(per, scope))

    def init(params_single, seed: int = 0) -> LocalSGDState:
        """Stack a single-copy param tree (tensors on the training device)
        into this rank's copies (all W in one process); ``seed`` seeds the
        state's generator (the gradient noise's stream; across ranks one
        stream a worker group, from ``(seed, group)``)."""
        params = stack_tree(params_single, wl)
        dev = tree_leaves(params)[0].device
        return LocalSGDState(
            params=params,
            momentum=init_momentum(params),
            anchor=(tree_map(torch.clone, params_single) if needs_anchor(ls)
                    else None),
            global_u=(tree_map(torch.zeros_like, params_single)
                      if ls.global_momentum > 0 else None),
            ef_memory=(init_momentum(params) if ls.sync_compression == "ef_sign"
                       else None),
            step=0,
            rng=torch.Generator(device=dev).manual_seed(
                seed if dist is None else _group_seed(seed, dist.layout.group)),
            stats=tstats.init_stats(wl, 1, dev) if telemetry else None)

    def local_step(state: LocalSGDState, batch, lr_scale=None):
        """One local step of every worker (``batch``: dict of (W, B_loc,
        ...) arrays or tensors, the global batch on every rank; ``lr_scale``
        as on the resident path)."""
        leaves, treedef = tree_flatten(state.params)
        dev = leaves[0].device
        lr = lr_at(opt, state.step, global_batch=global_batch)
        if lr_scale is not None:
            lr = lr * np.float32(lr_scale)
        if dist is not None:
            batch = _rank_rows(batch, W, lo, wl)
        batch = {k: _to_device(v, dev) for k, v in batch.items()}
        grads_w, losses, metrics_w = [], [], []
        for w in range(wl):
            src = [x[w].detach().requires_grad_(True) for x in leaves]
            loss, metrics = loss_fn(tree_unflatten(treedef, src),
                                    {k: v[w] for k, v in batch.items()})
            g = torch.autograd.grad(loss, src, allow_unused=True,
                                    materialize_grads=True)
            g = tree_unflatten(treedef, list(g))
            if opt.noise_eta > 0:
                g = isotropic_noise(g, state.rng, step=state.step,
                                    eta=opt.noise_eta, gamma=opt.noise_gamma)
            grads_w.append(tree_leaves(g))
            losses.append(loss.detach())
            metrics_w.append({k: v.detach() for k, v in metrics.items()})
        grads = tree_unflatten(treedef, [torch.stack(gs)
                                         for gs in zip(*grads_w)])
        del grads_w
        stats = state.stats
        if telemetry:
            # the APPLIED (post-clip) grad norm^2, from the raw norm: a
            # clip scales the whole vector, ||clip(g)||^2 = min(||g||, c)^2
            gsq = _tree_sumsq_w(grads)
            if opt.grad_clip and opt.optimizer != "lars":
                gsq = torch.clamp(gsq, max=float(np.float32(opt.grad_clip) ** 2))
        p0 = state.params
        if opt.optimizer == "lars":
            p, u = apply_lars(p0, grads, state.momentum, lr=lr,
                              trust=opt.lars_trust,
                              momentum_coef=ls.local_momentum,
                              weight_decay=opt.weight_decay,
                              nesterov=ls.nesterov, wd_mask=wd_mask,
                              use_kernel=use_kernel, leading=1)
        else:
            p, u = apply_sgd(p0, grads, state.momentum, lr=lr,
                             momentum_coef=ls.local_momentum,
                             weight_decay=opt.weight_decay,
                             nesterov=ls.nesterov, wd_mask=wd_mask,
                             grad_clip=opt.grad_clip, use_kernel=use_kernel,
                             leading=1)
        if telemetry:
            usq = sum(_sumsq(a.float() - b.float(), from_axis=1)
                      for a, b in zip(tree_leaves(p), tree_leaves(p0)))
            stats = tstats.accumulate_step(stats, gsq, usq)
        # every worker's values (gathered across ranks: one collective a
        # step), averaged over the same W numbers as one process averages
        keys = list(metrics_w[0])
        allv = gathered(torch.stack([
            torch.stack([m[k].float() for k in keys] + [losses[i].float()])
            for i, m in enumerate(metrics_w)]), "metrics")
        metrics = {k: allv[:, j].contiguous().mean()
                   for j, k in enumerate(keys)}
        metrics["loss"] = allv[:, -1].contiguous().mean()
        metrics["lr"] = float(lr)
        new = LocalSGDState(params=p, momentum=u, anchor=state.anchor,
                            global_u=state.global_u, ef_memory=state.ef_memory,
                            step=state.step + 1, stats=stats, rng=state.rng)
        return new, metrics

    def sync(state: LocalSGDState, *, plan=None,
             scope: str = "global") -> LocalSGDState:
        """Execute one scope of a ``SyncPlan`` (built from the config over
        the state's per-worker layout when none is given) on the trees: its
        group and, at global scope, its one compressor mode (a per-bucket
        mode tuple raises ``ValueError``, as in the reference).  Across
        ranks a block inside the rank averages there, a block that spans
        ranks and the global mean over their ordered mean."""
        if plan is None:
            plan = splan.make_sync_plan(
                flatbuf.build_layout(state.params, leading=1), num_workers=W,
                topology=splan.resolve_topology(ls, W),
                compression=ls.sync_compression, anchored=needs_anchor(ls),
                wire_pack=ls.wire_pack, coalesce=ls.sync_coalesce)
        stages = plan.schedule(scope)
        g = next(st.group for st in stages if st.kind == "collective")
        stage_of = _stage_of(plan, scope)
        if scope == "global":
            if len(set(plan.modes)) != 1:
                raise ValueError(
                    "the tree sync path supports a single compression mode "
                    "for the whole state (per-bucket tuples are a "
                    "resident-path feature)")
            mode = plan.modes[0]
        else:
            mode = "none"
        record = telemetry and scope == "global"
        if not needs_anchor(ls):
            if mode != "none":
                raise ValueError(
                    "compression needs an anchor: configure sync_compression/"
                    "global_momentum so the state allocates one (needs_anchor)")
            if bucket_sync:
                p = bucket_group_mean(state.params, g, bucketable, dist=dist,
                                      scope=scope, stage_of=stage_of)
            else:
                p = tree_map(lambda x: _group_mean_copy(
                    x, g, dist, scope=scope, stage=0), state.params)
            stats = state.stats
            if record:
                # the centred pair: x_k = p_k - pbar, so pre IS the
                # worker dispersion and post = 0 exactly
                cent = tree_map(lambda a, b: a.float() - b.float(),
                                state.params, p)
                stats = tstats.record_sync(
                    stats, pre_sync_sq=gathered(_tree_sumsq_w(cent),
                                                "telemetry").mean(),
                    post_sync_sq=0.0)
            return LocalSGDState(params=p, momentum=state.momentum,
                                 anchor=None, global_u=None, ef_memory=None,
                                 step=state.step, stats=stats, rng=state.rng)

        if g != W:
            raise ValueError("compression / global momentum require flat "
                             "local SGD: a block sync needs the mean sync")
        if mode == "ef_sign" and state.ef_memory is None:
            raise ValueError("ef_sign requires the config to allocate EF "
                             "memory (sync_compression='ef_sign')")
        delta = tree_map(lambda a, x: a[None] - x, state.anchor, state.params)
        ef = state.ef_memory
        err_w = ref_w = None      # per-worker compression error / reference
        diff = lambda xs, ys: tree_map(lambda x, y: x.float() - y, xs, ys)
        ckw = dict(use_kernel=use_kernel, bucketable=bucketable, across=dist)
        if mode == "sign":
            raw = delta
            delta = comp.sign_compress(delta, **ckw)
            if record:
                err_w = _tree_sumsq_w(diff(raw, delta))
                ref_w = _tree_sumsq_w(raw)
        elif mode == "ef_sign":
            delta, ef = comp.ef_compress(delta, ef, **ckw)
            if record:
                # the EF residual e' = input - output IS the error
                err_w = _tree_sumsq_w(ef)
                ref_w = _tree_sumsq_w(tree_map(lambda c, e: c + e, delta, ef))
        elif record and speculate_compression:
            cs = comp.sign_compress(delta, **ckw)
            err_w = _tree_sumsq_w(diff(delta, cs))
            ref_w = _tree_sumsq_w(delta)
        if mode != "none" and ls.wire_pack:
            pm, axes_tree = packed_mean_fn or (None, None)
            if dist is not None:
                pm = lambda d, axis: _packed_mean_leaf(d, axis, dist, stage=0)
            if bucket_sync:
                flat_fn = None if dist is None else (
                    lambda b, lay, j: _packed_mean_flat(dist, b, lay, j,
                                                        stage=stage_of(j)))
                dbar = bucket_packed_mean(delta, bucketable, flat_fn=flat_fn,
                                          leaf_fn=pm, axes_tree=axes_tree)
            else:
                pm = pm or _packed_mean_leaf
                dbar = (tree_map(lambda d: pm(d, -1), delta)
                        if axes_tree is None else tree_map(pm, delta, axes_tree))
        elif bucket_sync:
            dbar = bucket_worker_mean(delta, bucketable, dist=dist,
                                      stage_of=stage_of)
        else:
            dbar = tree_map(lambda x: _worker_mean(x, dist, scope="global",
                                                   stage=0), delta)

        stats = state.stats
        if record:
            kw = {}
            if err_w is not None:
                er = worker_total(torch.stack([err_w, ref_w], dim=1),
                                  "telemetry")
                kw = dict(comp_err_sq=er[0:1], comp_ref_sq=er[1:2])
            stats = tstats.record_sync(
                stats, pre_sync_sq=gathered(_tree_sumsq_w(delta),
                                            "telemetry").mean(),
                post_sync_sq=sum(_sumsq(d) for d in tree_leaves(dbar)), **kw)
        gu = state.global_u
        if ls.global_momentum > 0:
            gu = tree_map(lambda ug, d: ls.global_momentum * ug + d, gu, dbar)
            step_tree = gu
        else:
            step_tree = dbar
        anchor = tree_map(lambda a, d: (a.float() - d.float()).to(a.dtype),
                          state.anchor, step_tree)
        return LocalSGDState(params=stack_tree(anchor, wl),
                             momentum=state.momentum, anchor=anchor,
                             global_u=gu, ef_memory=ef, step=state.step,
                             stats=stats, rng=state.rng)

    return init, local_step, sync


def make_local_sgd(run: RunConfig, loss_fn: Callable, *, num_workers: int,
                   wd_mask=None, telemetry: bool = False,
                   speculate_compression: bool = False, dist=None,
                   shard_classes=None, batch_split: int = 1,
                   use_kernel: bool = True, bucket_sync: bool = True,
                   resident: bool | None = None, bucketable=None,
                   packed_mean_fn=None):
    """Build (init, local_step, sync) for a single-worker
    ``loss_fn(params, batch) -> (loss, metrics)``: on resident buckets
    when ``resident`` (default: :func:`resident_eligible` of ``use_kernel``
    and ``bucket_sync``), else the tree path of the module docstring, with
    ``bucketable`` (a bool tree: leaves kept off the flat bus) and
    ``packed_mean_fn`` (``(leaf_fn, axes_tree)`` of the per-leaf wire
    pack, as in the reference) for its sync.  ``use_kernel`` defaults to
    True where the reference's defaults to False: the port's callers stay
    on the kernels unless they ask for the tree path.
    ``telemetry`` carries a ``StatsAccumulator`` in ``state.stats``; it
    observes only, the trajectory is the same with it on or off.
    ``speculate_compression`` (with telemetry) records the would-be sign
    error of every bucket a global sync sends uncompressed.  ``dist`` (a
    ``backend.collectives.Collectives``) splits the W workers over its
    ranks (see the module docstring); ``None`` keeps them all here.
    ``shard_classes`` (``flatbuf.shard_classes``) buckets the leaves per
    (dtype, sharding class); ``batch_split`` is the number of shard ranks
    a worker's batch is split over (FSDP: the within-worker size; 1 keeps
    it whole on every shard rank; one process always computes it
    whole)."""
    _check_supported(run)
    if resident is None:
        resident = resident_eligible(use_kernel, bucket_sync)
    if not resident:
        if dist is not None:
            if dist.layout.within_worker_size > 1:
                raise ValueError(
                    "the tree path across ranks holds whole workers: a "
                    f"within-worker grid of {dist.layout.within_worker_size}"
                    " shard ranks (S > 1) would need per-leaf shard gathers,"
                    " which are not ported; use the resident path")
            if dist.layout.num_workers != num_workers:
                raise ValueError(f"num_workers={num_workers} disagrees with "
                                 f"the worker layout "
                                 f"({dist.layout.num_workers} workers)")
        if shard_classes is not None:
            raise ValueError("the tree path buckets on the fly and keeps no "
                             "sharding classes: mark leaves with bucketable=")
        return _make_tree_local_sgd(
            run, loss_fn, num_workers=num_workers, wd_mask=wd_mask,
            use_kernel=use_kernel, bucket_sync=bucket_sync,
            bucketable=bucketable, packed_mean_fn=packed_mean_fn,
            telemetry=telemetry, speculate_compression=speculate_compression,
            dist=dist)
    if not (use_kernel and bucket_sync):
        raise ValueError("the resident path runs the kernels on buckets: "
                         "resident=True needs use_kernel and bucket_sync")
    ls = run.local_sgd
    opt = run.optim
    W = num_workers
    global_batch = run.shape.global_batch
    if dist is not None and dist.layout.num_workers != W:
        raise ValueError(f"num_workers={W} disagrees with the worker layout "
                         f"({dist.layout.num_workers} workers)")
    # this rank's workers: rows lo .. lo + wl - 1 of the global worker axis
    wl = W if dist is None else dist.layout.w_local
    lo = 0 if dist is None else dist.layout.worker_lo
    # within-worker grid: S shard ranks a worker, this rank holds shard si
    S = 1 if dist is None else dist.layout.within_worker_size
    si = 0 if dist is None else dist.layout.shard
    if batch_split not in (1, S):
        raise ValueError(f"batch_split={batch_split}: a worker's batch splits "
                         f"over its S={S} shard ranks or not at all")
    gather = (None if dist is None else
              (lambda x, scope: dist.gather_workers(x, scope=scope)))

    def _own(layout, b, x):
        """This rank's rows of bucket ``b`` from its whole rows ``x``: its
        shard region of a sharded bucket on a within-worker grid."""
        if S == 1 or layout.bucket_shard_count(b) == 1:
            return x
        lr = layout.bucket_local_rows(b)
        return x[..., si * lr:(si + 1) * lr, :]

    def _whole(layout, b, x):
        """A stacked bucket's whole rows ``(wl, rows, 128)`` from this rank's
        ``x``: its shard group's regions gathered in shard order."""
        if S == 1 or layout.bucket_shard_count(b) == 1:
            return x
        g = dist.gather_shards(x)                      # (S, wl, lr, 128)
        return g.transpose(0, 1).reshape(wl, layout.bucket_rows[b], x.shape[-1])

    def _reduce_grad(layout, b, g):
        """A worker-stacked gradient over its whole rows -> this rank's rows
        of the worker's gradient: with a split batch the shard ranks' mean
        (reduce-scattered, or all-reduced for a replicated bucket), else
        this rank's region of it."""
        if S == 1:
            return g
        sharded = layout.bucket_shard_count(b) > 1
        if batch_split == 1:
            return _own(layout, b, g).contiguous() if sharded else g
        if not sharded:
            return dist.all_reduce_shards(g).div_(S)
        lr = layout.bucket_local_rows(b)
        regions = g.view(wl, S, lr, g.shape[-1]).transpose(0, 1)
        out = dist.reduce_scatter_shards(
            regions.reshape(S * wl, lr, g.shape[-1]))
        return out.view(wl, lr, g.shape[-1]).div_(S)

    def init(params_single, seed: int = 0) -> LocalSGDState:
        """Enter resident form from a single-copy param tree (tensors on
        the training device); ``seed`` seeds the state's generator (the
        gradient noise's stream)."""
        layout = flatbuf.build_layout(params_single, wd_mask=wd_mask,
                                      shard_classes=shard_classes)
        bad = [b for b in range(layout.num_buckets)
               if S > 1 and layout.bucket_shard_count(b) not in (1, S)]
        if bad:
            raise ValueError(
                f"buckets {bad} have {[layout.bucket_shard_count(b) for b in bad]}"
                f" shards; a within-worker grid of {S} shard ranks holds "
                f"sharded sub-buckets of {S} shards only")
        pb = [_own(layout, b, x)
              for b, x in enumerate(flatbuf.flatten(layout, params_single))]
        stacked = lambda: tuple(b[None].repeat(wl, 1, 1) for b in pb)
        zeros = lambda dtype=None: tuple(
            torch.zeros((wl,) + b.shape, dtype=dtype or b.dtype, device=b.device)
            for b in pb)
        return LocalSGDState(
            params=flatbuf.BucketState(layout, stacked(), leading=1),
            momentum=flatbuf.BucketState(layout, zeros(), leading=1),
            anchor=(flatbuf.BucketState(layout, tuple(b.clone() for b in pb))
                    if needs_anchor(ls) else None),
            global_u=(flatbuf.BucketState(layout, tuple(torch.zeros_like(b)
                                                        for b in pb))
                      if ls.global_momentum > 0 else None),
            # EF memory is float32 for every bucket: the reference's first
            # EF-sign sync replaces its param-dtype zeros with the f32
            # residual d + e - compressed, which a bf16 memory would round
            ef_memory=(flatbuf.BucketState(layout, zeros(torch.float32),
                                           leading=1)
                       if ls.sync_compression == "ef_sign" else None),
            step=0,
            stats=(tstats.init_stats(wl, layout.num_buckets, pb[0].device)
                   if telemetry else None),
            # one noise stream a worker group, from (seed, group): a
            # worker's shard ranks draw the same noise for its whole rows
            rng=torch.Generator(device=pb[0].device).manual_seed(
                seed if dist is None else _group_seed(seed, dist.layout.group)))

    def local_step(state: LocalSGDState, batch, lr_scale=None):
        """One local step of every worker.  ``batch``: dict of (W, B_loc,
        ...) arrays (numpy or tensors); integer fields reach ``loss_fn``
        as int64, floating ones as float32.  ``lr_scale`` multiplies
        the scheduled lr (in float32, as the reference does); ``None``
        keeps the two-argument call's trajectory bit for bit."""
        layout = state.params.layout
        pbs = list(state.params.buckets)
        dev = pbs[0].device
        lr = lr_at(opt, state.step, global_batch=global_batch)
        if lr_scale is not None:
            lr = lr * np.float32(lr_scale)
        if dist is not None:
            batch = _rank_rows(batch, W, lo, wl)
            if batch_split > 1:
                # FSDP: this shard rank's 1/S of every worker's batch
                n = len(next(iter(batch.values()))[0])
                if n % S:
                    raise ValueError(f"a worker's batch of {n} does not split "
                                     f"over its {S} shard ranks")
                batch = {k: v[:, si * (n // S):(si + 1) * (n // S)]
                         for k, v in batch.items()}
        batch = {k: _to_device(v, dev) for k, v in batch.items()}
        # a sharded bucket's whole rows, gathered over the shard group
        full = [_whole(layout, b, x) for b, x in enumerate(pbs)]
        # every worker's gradient lands in its row once; zeroed here once
        # for all W, so the padding is exact zero
        gbs = [torch.zeros_like(b) for b in full]
        losses, metrics_w = [], []
        for w in range(wl):
            gw = [g[w] for g in gbs]
            loss, metrics = _worker_grad(layout, loss_fn, [b[w] for b in full],
                                         {k: v[w] for k, v in batch.items()},
                                         gw)
            if opt.noise_eta > 0:
                _bucket_noise(layout, gw, state.rng, step=state.step,
                              eta=opt.noise_eta, gamma=opt.noise_gamma)
            losses.append(loss.detach())
            metrics_w.append({k: v.detach() for k, v in metrics.items()})
        del full
        gbs = [_reduce_grad(layout, b, g) for b, g in enumerate(gbs)]
        ubs = list(state.momentum.buckets)
        if opt.optimizer == "lars":
            # LARS takes no grad clip, as in the reference: no sq_sum launch
            out = apply_lars_buckets(
                layout, pbs, gbs, ubs, lr=lr, trust=opt.lars_trust,
                momentum_coef=ls.local_momentum, weight_decay=opt.weight_decay,
                nesterov=ls.nesterov, want_stats=telemetry, across=dist)
        else:
            out = apply_sgd_buckets(
                layout, pbs, gbs, ubs, lr=lr, momentum_coef=ls.local_momentum,
                weight_decay=opt.weight_decay, nesterov=ls.nesterov,
                grad_clip=opt.grad_clip, want_stats=telemetry, across=dist)
        stats = state.stats
        if telemetry:
            gsq_w, usq_w = out[2]
            stats = tstats.accumulate_step(stats, gsq_w, usq_w)
        if dist is None:
            metrics = {k: torch.stack([m[k].float() for m in metrics_w]).mean()
                       for k in metrics_w[0]}
            metrics["loss"] = torch.stack(losses).mean()
        else:
            # every worker's values gathered (one collective a step), then
            # averaged over the same W numbers as one process averages
            keys = list(metrics_w[0])
            local = torch.stack([torch.stack([m[k].float() for k in keys]
                                             + [losses[i].float()])
                                 for i, m in enumerate(metrics_w)])
            if batch_split > 1:
                # a worker's values: the mean over its shard ranks' slices
                local = dist.shard_total(local, scope="metrics") / S
            allv = gather(local, scope="metrics")
            metrics = {k: allv[:, j].contiguous().mean()
                       for j, k in enumerate(keys)}
            metrics["loss"] = allv[:, -1].contiguous().mean()
        metrics["lr"] = float(lr)
        new = LocalSGDState(params=state.params, momentum=state.momentum,
                            anchor=state.anchor, global_u=state.global_u,
                            ef_memory=state.ef_memory, step=state.step + 1,
                            stats=stats, rng=state.rng)
        return new, metrics

    def sync(state: LocalSGDState, *, plan=None,
             scope: str = "global") -> LocalSGDState:
        """Execute the ``scope`` stages of a ``SyncPlan`` (built from the
        config when none is given) on the resident buckets, in place:
        ``"global"`` averages over all W, ``"block"`` over the plan's
        blocks of consecutive workers (Alg. 5; mean sync only, as in the
        reference).  With telemetry a global sync returns a state whose
        ``stats`` has the round closed (``record_sync``)."""
        layout = state.params.layout
        if plan is None:
            plan = splan.make_sync_plan(layout, num_workers=W,
                                        topology=splan.resolve_topology(ls, W),
                                        compression=ls.sync_compression,
                                        anchored=needs_anchor(ls),
                                        wire_pack=ls.wire_pack,
                                        coalesce=ls.sync_coalesce)
        stages = plan.schedule(scope)
        record = telemetry and scope == "global"
        modes = plan.modes if scope == "global" else ("none",) * len(plan.modes)
        pb = list(state.params.buckets)
        ci = -1         # the collective stage's id: its index in the scope
        if not needs_anchor(ls):
            if any(m != "none" for m in modes):
                raise ValueError(
                    "compression needs an anchor: configure sync_compression/"
                    "global_momentum so the state allocates one (needs_anchor)")
            pre_w = 0
            for st in stages:
                if st.kind == "collective":
                    ci += 1
                    for b in st.buckets:
                        m = _block_mean(dist, pb[b], st.group, scope=scope,
                                        stage=ci)
                        if record:
                            # centred pair: x_k = p_k - pbar, taken before the
                            # in-place copy; pre IS the dispersion, post = 0
                            pre_w = pre_w + _sumsq_w(
                                layout, b, pb[b].float() - m.float(), dist)
                        pb[b].copy_(m)
            if not record:
                return state
            if dist is not None:
                pre_w = gather(pre_w, scope="telemetry")
            stats = tstats.record_sync(state.stats, pre_sync_sq=pre_w.mean(),
                                       post_sync_sq=0.0)
            return dataclasses.replace(state, stats=stats)

        if scope != "global":
            raise ValueError("compression / global momentum require flat "
                             "local SGD: a block sync needs the mean sync")
        if "ef_sign" in modes and state.ef_memory is None:
            raise ValueError("ef_sign requires the config to allocate EF "
                             "memory (sync_compression='ef_sign')")
        ab = list(state.anchor.buckets)
        efb = (list(state.ef_memory.buckets) if state.ef_memory is not None
               else None)
        nb = layout.num_buckets
        x: list = [None] * nb
        dbar: list = [None] * nb
        # telemetry per bucket: ||x_k||^2 per worker, ||dbar||^2, and the
        # compressor's ||input - output||^2 and ||input||^2
        x_sq: list = [None] * nb
        dbar_sq: list = [None] * nb
        zero = lambda: torch.zeros((), dtype=torch.float32, device=pb[0].device)
        # the compressor's error and reference norms per worker, added in
        # worker order after the stage loop: the same adds across ranks
        wzero = lambda: torch.zeros((wl,), dtype=torch.float32,
                                    device=pb[0].device)
        err = [wzero() for _ in range(nb)] if telemetry else None
        ref = [wzero() for _ in range(nb)] if telemetry else None
        for st in stages:
            if st.kind == "pack":
                b = st.buckets[0]
                delta = ab[b][None] - pb[b]
                if modes[b] != "none":
                    x[b], e_new, inp = comp.compress_stage(
                        layout, st, delta, efb[b] if efb is not None else None,
                        leading=1, across=dist)
                    if modes[b] == "ef_sign":
                        efb[b].copy_(e_new)
                    if telemetry:
                        err[b] = _sumsq_w(layout, b, inp.float() - x[b], dist)
                        ref[b] = _sumsq_w(layout, b, inp, dist)
                else:
                    x[b] = delta
                    if telemetry and speculate_compression:
                        # the WOULD-BE sign error of this uncompressed
                        # bucket: the escalating controllers' turn-on
                        # signal
                        cs = comp.sign_compress_bucket(
                            layout, b, delta, leading=1, across=dist)
                        err[b] = _sumsq_w(layout, b, delta.float() - cs, dist)
                        ref[b] = _sumsq_w(layout, b, delta, dist)
                if telemetry:
                    x_sq[b] = _sumsq_w(layout, b, x[b], dist)
            elif st.kind == "collective":
                ci += 1
                wire = [b for b in st.buckets
                        if modes[b] != "none" and plan.wire_pack]
                if st.coalesced and len(wire) == len(st.buckets) > 1:
                    outs = (_packed_mean_coalesced_local(
                                [x[b] for b in st.buckets], layout, st.buckets)
                            if dist is None else
                            _packed_mean_coalesced(
                                dist, [x[b] for b in st.buckets], layout,
                                st.buckets, stage=ci))
                else:
                    outs = []
                    for b in st.buckets:
                        if b in wire:
                            outs.append(
                                _packed_mean_flat_local(x[b], layout, b)
                                if dist is None else
                                _packed_mean_flat(dist, x[b], layout, b,
                                                  stage=ci))
                        else:
                            outs.append(_worker_mean(x[b], dist,
                                                     scope="global", stage=ci))
                for b, db in zip(st.buckets, outs, strict=True):
                    # the unpack emits sign(+1) * scale in padding slots:
                    # re-masked so that padding stays zero
                    dbar[b] = (flatbuf.mask_padding(layout, b, db)
                               if b in wire else db)
                    x[b] = None
                    if telemetry:
                        dbar_sq[b] = _sumsq_all(layout, b, dbar[b], dist)
            elif st.kind == "apply":
                for b in st.buckets:
                    step_b = dbar[b]
                    if ls.global_momentum > 0:
                        gu = state.global_u.buckets[b]
                        gu.copy_(ls.global_momentum * gu + dbar[b])
                        step_b = gu
                    ab[b].sub_(step_b)
                    pb[b].copy_(ab[b][None].expand_as(pb[b]))
                    dbar[b] = None
        if not telemetry:
            return state
        # summed in bucket order after the stage loop, as the reference does
        pre_w = torch.zeros((wl,), dtype=torch.float32, device=pb[0].device)
        for b in range(nb):
            pre_w = pre_w + x_sq[b]
        if dist is not None:
            pre_w = gather(pre_w, scope="telemetry")
        kw = {}
        if any(m != "none" for m in modes) or speculate_compression:
            # (wl, 2, nb): every worker's pair per bucket
            er = torch.stack([torch.stack(err), torch.stack(ref)]).permute(
                2, 0, 1).contiguous()
            if dist is not None:
                er = gather(er, scope="telemetry")
            er = kops.lead_total(er)
            err, ref = er[0], er[1]
            kw = dict(comp_err_sq=err, comp_ref_sq=ref)
        stats = tstats.record_sync(state.stats, pre_sync_sq=pre_w.mean(),
                                   post_sync_sq=sum(dbar_sq), **kw)
        return dataclasses.replace(state, stats=stats)

    return init, local_step, sync
